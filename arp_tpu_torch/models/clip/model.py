"""CLIP ViT image tower and text tower in PyTorch (port of arp_tpu/models/clip/model.py).

The module tree mirrors the Flax one, so a parameter's name is its Flax path
joined with dots (``visual.transformer.resblocks.0.attn.query.weight`` for
``params/visual/transformer/resblocks.0/attn/query/kernel``) and
:func:`arp_tpu_torch.models.clip.convert.flax_to_torch` is a rename plus a
transpose of the Dense kernels.  As in the Flax model:

  * attention has separate q/k/v/out Linears and goes through
    :func:`arp_tpu_torch.ops.attention.dot_product_attention` (kernel K1 on
    CUDA), with the causal mask and key padding evaluated lazily;
  * the patch embedding is a bias-free Linear over patch vectors in
    (p_row, p_col, channel) order, not a Conv2d;
  * LayerNorm eps is 1e-5 and the MLP uses quick-GELU;
  * a tower's dtype is its parameters' dtype: cast the module and the inputs
    to bfloat16 for a bf16 encode.

The ModifiedResNet towers are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.masks import MaskSpec

LayerNorm = functools.partial(nn.LayerNorm, eps=1e-5)

MAX_TEXT_LENGTH = 77

IMAGE_RESOLUTION = {
    "vit_b32": 224,
    "vit_b16": 224,
    "vit_l14": 224,
    "vit_b32_clip4clip": 224,
    "vit_b16_clip4clip": 224,
}

# The ViT entries of arp_tpu's table (openai/model.py:59-135).
CONFIGS = {
    "vit_b32": dict(embed_dim=512, vocab_size=49408, vision_num_layers=12, vision_features=768,
                    vision_patch_size=32, text_features=512, text_num_heads=8, text_num_layers=12),
    "vit_b16": dict(embed_dim=512, vocab_size=49408, vision_num_layers=12, vision_features=768,
                    vision_patch_size=16, text_features=512, text_num_heads=8, text_num_layers=12),
    "vit_l14": dict(embed_dim=768, vocab_size=49408, vision_num_layers=24, vision_features=1024,
                    vision_patch_size=14, text_features=768, text_num_heads=12, text_num_layers=12),
}


class CLIPMLP(nn.Module):
    """Transformer MLP with CLIP naming (c_fc / c_proj) and quick-GELU."""

    def __init__(self, features: int):
        super().__init__()
        self.c_fc = nn.Linear(features, 4 * features)
        self.c_proj = nn.Linear(4 * features, features)

    def forward(self, x):
        x = self.c_fc(x)
        x = x * torch.sigmoid(1.702 * x)
        return self.c_proj(x)


class CLIPAttention(nn.Module):
    """Self-attention with separate q/k/v/out Linears (the Flax layout)."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, x, mask_spec=MaskSpec("none"), kv_padding=None):
        b, n, d = x.shape
        split = lambda t: t.view(b, n, self.num_heads, d // self.num_heads)  # noqa: E731
        out = dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)),
            spec=mask_spec, kv_padding=kv_padding,
        )
        return self.out(out.reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(features)
        self.attn = CLIPAttention(features, num_heads)
        self.ln_2 = LayerNorm(features)
        self.mlp = CLIPMLP(features)

    def forward(self, x, mask_spec=MaskSpec("none"), kv_padding=None):
        x = x + self.attn(self.ln_1(x), mask_spec, kv_padding)
        return x + self.mlp(self.ln_2(x))


class CLIPTransformer(nn.Module):
    def __init__(self, features: int, num_layers: int, num_heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(features, num_heads) for _ in range(num_layers)
        )

    def forward(self, x, mask_spec=MaskSpec("none"), kv_padding=None):
        for block in self.resblocks:
            x = block(x, mask_spec, kv_padding)
        return x


class VisionTransformer(nn.Module):
    """ViT image tower over patch vectors (B, N, P*P*C) or images (B, H, W, C)."""

    def __init__(self, patch_size: int, features: int, num_layers: int, num_heads: int,
                 out_features: int, image_size: int, channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        num_patches = (image_size // patch_size) ** 2
        self.conv1 = nn.Linear(patch_size * patch_size * channels, features, bias=False)
        scale = features ** -0.5
        self.class_embedding = nn.Parameter(scale * torch.randn(features))
        self.positional_embedding = nn.Parameter(scale * torch.randn(num_patches + 1, features))
        self.ln_pre = LayerNorm(features)
        self.transformer = CLIPTransformer(features, num_layers, num_heads)
        self.ln_post = LayerNorm(features)
        self.proj = nn.Linear(features, out_features, bias=False)

    def forward(self, x):
        p = self.patch_size
        if x.ndim == 4:
            b, h, w, c = x.shape
            x = x.reshape(b, h // p, p, w // p, p, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)
        b = x.shape[0]
        x = self.conv1(x)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat((cls, x), dim=1)
        x = x + self.positional_embedding[None, : x.shape[1]]
        x = self.ln_pre(x)
        x = self.transformer(x)
        return self.proj(self.ln_post(x[:, 0]))


class TextEncoder(nn.Module):
    def __init__(self, vocab_size: int, features: int, num_layers: int, num_heads: int,
                 out_features: int, context_length: int = MAX_TEXT_LENGTH):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, features)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, features))
        self.transformer = CLIPTransformer(features, num_layers, num_heads)
        self.ln_final = LayerNorm(features)
        self.text_projection = nn.Linear(features, out_features, bias=False)

    def forward(self, text: torch.Tensor):
        x = self.token_embedding(text) + self.positional_embedding[None, : text.shape[1]]
        # causal + key padding (pad id 0), both lazy
        x = self.transformer(x, mask_spec=MaskSpec("causal"), kv_padding=text == 0)
        x = self.ln_final(x)
        # the EOT token (highest id) pools the sequence
        x = x[torch.arange(x.shape[0], device=x.device), text.argmax(-1)]
        return self.text_projection(x)


class CLIP(nn.Module):
    """CLIP with ``encode_image`` / ``encode_text`` (L2-normalized by default)."""

    def __init__(self, vocab_size: int, embed_dim: int, text_features: int, text_num_layers: int,
                 text_num_heads: int, vision_features: int, vision_num_layers: int,
                 vision_patch_size: int, image_size: int = 224):
        super().__init__()
        if not isinstance(vision_num_layers, int):
            raise NotImplementedError("the ModifiedResNet image towers are not ported yet")
        self.vision_patch_size = vision_patch_size
        self.vision_features = vision_features
        self.image_size = image_size
        self.visual = VisionTransformer(
            patch_size=vision_patch_size,
            features=vision_features,
            num_layers=vision_num_layers,
            num_heads=vision_features // 64,
            out_features=embed_dim,
            image_size=image_size,
        )
        self.text = TextEncoder(
            vocab_size=vocab_size,
            features=text_features,
            num_layers=text_num_layers,
            num_heads=text_num_heads,
            out_features=embed_dim,
        )
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def encode_image(self, image, normalize: bool = True):
        x = self.visual(image)
        if normalize:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x

    def encode_text(self, text, normalize: bool = True):
        x = self.text(text)
        if normalize:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x


def _model_fn(name):
    def fn(**overrides):
        return CLIP(**{**CONFIGS[name], "image_size": IMAGE_RESOLUTION[name], **overrides})

    return fn


MODELS = {
    "vit_b32": _model_fn("vit_b32"),
    "vit_b16": _model_fn("vit_b16"),
    "vit_l14": _model_fn("vit_l14"),
    "vit_b32_clip4clip": _model_fn("vit_b32"),
    "vit_b16_clip4clip": _model_fn("vit_b16"),
}
