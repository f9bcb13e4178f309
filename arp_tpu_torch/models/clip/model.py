"""CLIP image towers (ViT and ModifiedResNet) and text tower in PyTorch (port of arp_tpu/models/clip/model.py).

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
    to bfloat16 for a bf16 encode (the ResNet's BatchNorm statistics too, as
    the JAX engine's cast takes ``batch_stats`` with the params).

The ModifiedResNet towers (``vision_num_layers`` a tuple) take (B, H, W, C)
images like the Flax module and convolve channels-first inside: the 3-conv
stem, Bottleneck blocks with anti-aliased average-pool downsampling, BatchNorm
in eval mode (its running statistics are buffers, Flax's ``batch_stats``), and
the attention pool, whose one query (the mean token) attends in plain torch as
JAX computes it outside any Pallas kernel.  ``vision_return_map`` returns the
feature map instead of the pooled embedding.  A float32 tower convolves in
IEEE float32 whatever the process asked of cuDNN: PyTorch lets cuDNN's float32
convolutions take TF32 by default (``torch.backends.cudnn.allow_tf32``), a
lower precision than the tower's (:func:`_ieee_convolutions`).

:func:`load_model_vars` reads a local OpenAI checkpoint (a ``.npy`` of its
state dict or the ``.pt`` jit archive) into arp_tpu's Flax layout, as the JAX
package's does; fetching it is not ported.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.masks import MaskSpec

LayerNorm = functools.partial(nn.LayerNorm, eps=1e-5)

MAX_TEXT_LENGTH = 77

IMAGE_RESOLUTION = {
    "resnet_50": 224,
    "resnet_101": 224,
    "resnet_50x4": 288,
    "resnet_50x16": 384,
    "resnet_50x64": 448,
    "vit_b32": 224,
    "vit_b16": 224,
    "vit_l14": 224,
    "vit_b32_clip4clip": 224,
    "vit_b16_clip4clip": 224,
}

# arp_tpu's table (openai/model.py:59-135).
CONFIGS = {
    "vit_b32": dict(embed_dim=512, vocab_size=49408, vision_num_layers=12, vision_features=768,
                    vision_patch_size=32, text_features=512, text_num_heads=8, text_num_layers=12),
    "vit_b16": dict(embed_dim=512, vocab_size=49408, vision_num_layers=12, vision_features=768,
                    vision_patch_size=16, text_features=512, text_num_heads=8, text_num_layers=12),
    "vit_l14": dict(embed_dim=768, vocab_size=49408, vision_num_layers=24, vision_features=1024,
                    vision_patch_size=14, text_features=768, text_num_heads=12, text_num_layers=12),
    "resnet_50": dict(embed_dim=1024, vocab_size=49408, vision_num_layers=(3, 4, 6, 3), vision_features=64,
                      text_features=512, text_num_heads=8, text_num_layers=12),
    "resnet_101": dict(embed_dim=512, vocab_size=49408, vision_num_layers=(3, 4, 23, 3), vision_features=64,
                       text_features=512, text_num_heads=8, text_num_layers=12),
    "resnet_50x4": dict(embed_dim=640, vocab_size=49408, vision_num_layers=(4, 6, 10, 6), vision_features=80,
                        text_features=640, text_num_heads=10, text_num_layers=12),
    "resnet_50x16": dict(embed_dim=768, vocab_size=49408, vision_num_layers=(6, 8, 18, 8), vision_features=96,
                         text_features=768, text_num_heads=12, text_num_layers=12),
    "resnet_50x64": dict(embed_dim=1024, vocab_size=49408, vision_num_layers=(3, 15, 36, 10), vision_features=128,
                         text_features=1024, text_num_heads=16, text_num_layers=12),
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

    def __init__(self, features: int, num_heads: int, score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.score_dtype = score_dtype  # of the plain attention's scores and softmax (None: float32)
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, x, mask_spec=MaskSpec("none"), kv_padding=None):
        b, n, d = x.shape
        split = lambda t: t.view(b, n, self.num_heads, d // self.num_heads)  # noqa: E731
        out = dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)),
            spec=mask_spec, kv_padding=kv_padding, score_dtype=self.score_dtype or torch.float32,
        )
        return self.out(out.reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln_1 = LayerNorm(features)
        self.attn = CLIPAttention(features, num_heads, score_dtype)
        self.ln_2 = LayerNorm(features)
        self.mlp = CLIPMLP(features)

    def forward(self, x, mask_spec=MaskSpec("none"), kv_padding=None):
        x = x + self.attn(self.ln_1(x), mask_spec, kv_padding)
        return x + self.mlp(self.ln_2(x))


class CLIPTransformer(nn.Module):
    def __init__(self, features: int, num_layers: int, num_heads: int,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(features, num_heads, score_dtype) for _ in range(num_layers)
        )

    def forward(self, x, mask_spec=MaskSpec("none"), kv_padding=None, return_intermediates: bool = False):
        """``return_intermediates``: also every block's output, in layer order (what the Flax
        stack sows as ``intermediate_layer_{i}``)."""
        inter = []
        for block in self.resblocks:
            x = block(x, mask_spec, kv_padding)
            inter.append(x)
        return (x, inter) if return_intermediates else x


class VisionTransformer(nn.Module):
    """ViT image tower over patch vectors (B, N, P*P*C) or images (B, H, W, C)."""

    def __init__(self, patch_size: int, features: int, num_layers: int, num_heads: int,
                 out_features: Optional[int], image_size: int, channels: int = 3,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size = patch_size
        num_patches = (image_size // patch_size) ** 2
        self.conv1 = nn.Linear(patch_size * patch_size * channels, features, bias=False)
        scale = features ** -0.5
        self.class_embedding = nn.Parameter(scale * torch.randn(features))
        self.positional_embedding = nn.Parameter(scale * torch.randn(num_patches + 1, features))
        self.ln_pre = LayerNorm(features)
        self.transformer = CLIPTransformer(features, num_layers, num_heads, score_dtype)
        self.ln_post = LayerNorm(features)
        # None: every token's ln_post output, no projection (the Flax tower's vision_return_map)
        self.proj = None if out_features is None else nn.Linear(features, out_features, bias=False)

    def forward(self, x, return_intermediates: bool = False):
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
        x, inter = self.transformer(x, return_intermediates=True)
        out = self.ln_post(x) if self.proj is None else self.proj(self.ln_post(x[:, 0]))
        return (out, inter) if return_intermediates else out


# --- ModifiedResNet -------------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Flax's ``BatchNorm(use_running_average=True)`` on channels-first input: ``weight`` is its
    ``scale``, the running statistics are buffers (its ``batch_stats`` ``mean`` / ``var``), eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


_IEEE_LOCK = threading.RLock()


@contextlib.contextmanager
def _ieee_convolutions():
    """cuDNN's float32 convolutions in IEEE float32, not TF32, inside the block; the process's setting
    after it.  The setting is the process's (torch's ``fp32_precision`` of cuDNN's convolutions, which
    the legacy ``allow_tf32`` flag also writes): only the convolutions' own entry changes, so cuDNN's
    other flags and TF32 in matmuls stay as the caller set them.  One thread at a time holds the block
    (two towers' forwards in two threads would otherwise restore each other's setting partway); another
    thread that reads ``torch.backends.cudnn.allow_tf32`` meanwhile meets torch's error for the legacy
    flag read while the convolutions' entry differs from the RNNs'."""
    conv = torch.backends.cudnn.conv
    with _IEEE_LOCK:
        before = conv.fp32_precision
        conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision = before


def _avg_pool(x, stride: int):
    """Flax's ``avg_pool(x, (s, s), (s, s))`` (VALID): the identity at stride 1."""
    return F.avg_pool2d(x, stride) if stride > 1 else x


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * self.expansion, 1, bias=False)
        self.bn3 = BatchNorm(features * self.expansion)
        self.downsample = None
        if stride > 1 or in_features != features * self.expansion:
            # the Flax names downsample.0 / .1; the average pool before them has no parameters
            self.downsample = nn.Sequential(OrderedDict([
                ("0", nn.Conv2d(in_features, features * self.expansion, 1, bias=False)),
                ("1", BatchNorm(features * self.expansion))]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(_avg_pool(out, self.stride)))
        if self.downsample is not None:
            x = self.downsample(_avg_pool(x, self.stride))
        return F.relu(out + x)


class AttentionPool(nn.Module):
    """One query, the mean token, attending over the flattened feature map and itself."""

    def __init__(self, features: int, num_heads: int, out_features: int, tokens: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.randn(tokens, features) / features ** 0.5)
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, out_features)

    def forward(self, x):
        b, d = x.shape[0], x.shape[-1]
        x = x.reshape(b, -1, d)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None, : x.shape[1]]
        head_dim = d // self.num_heads
        q = self.query(x[:, :1]).view(b, 1, self.num_heads, head_dim)
        k = self.key(x).view(b, -1, self.num_heads, head_dim)
        v = self.value(x).view(b, -1, self.num_heads, head_dim)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, 1, d)
        return self.out(out)[:, 0]


class ModifiedResNet(nn.Module):
    """The ResNet image tower over (B, H, W, C) images: (pooled embedding or feature map, feature map),
    the map (B, H / 32, W / 32, 32 * features) channels-last, as the Flax tower returns them."""

    def __init__(self, features: int, out_features: Optional[int], num_layers: Sequence[int], num_heads: int,
                 image_size: int):
        super().__init__()
        half = features // 2
        self.conv1 = nn.Conv2d(3, half, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(half)
        self.conv2 = nn.Conv2d(half, half, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(half)
        self.conv3 = nn.Conv2d(half, features, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(features)
        in_features = features
        for stage, (n_blocks, stride) in enumerate(zip(num_layers, (1, 2, 2, 2)), start=1):
            feats = features * 2 ** (stage - 1)
            blocks = [Bottleneck(in_features, feats, stride)]
            in_features = feats * Bottleneck.expansion
            blocks += [Bottleneck(in_features, feats) for _ in range(1, n_blocks)]
            self.add_module(f"layer{stage}", nn.ModuleList(blocks))
        self.num_stages = len(num_layers)
        self.attnpool = None
        if out_features is not None:
            self.attnpool = AttentionPool(in_features, num_heads, out_features, (image_size // 32) ** 2 + 1)

    def forward(self, x):
        if self.conv1.weight.dtype == torch.float32:
            with _ieee_convolutions():
                return self._forward(x)
        return self._forward(x)

    def _forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(1, self.num_stages + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block(x)
        feature_map = x.permute(0, 2, 3, 1)
        out = feature_map if self.attnpool is None else self.attnpool(feature_map)
        return out, feature_map


class TextEncoder(nn.Module):
    def __init__(self, vocab_size: int, features: int, num_layers: int, num_heads: int,
                 out_features: int, context_length: int = MAX_TEXT_LENGTH,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, features)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, features))
        self.transformer = CLIPTransformer(features, num_layers, num_heads, score_dtype)
        self.ln_final = LayerNorm(features)
        self.text_projection = nn.Linear(features, out_features, bias=False)

    def forward(self, text: torch.Tensor, return_intermediates: bool = False):
        x = self.token_embedding(text) + self.positional_embedding[None, : text.shape[1]]
        # causal + key padding (pad id 0), both lazy
        x, inter = self.transformer(x, mask_spec=MaskSpec("causal"), kv_padding=text == 0, return_intermediates=True)
        x = self.ln_final(x)
        # the EOT token (highest id) pools the sequence
        x = x[torch.arange(x.shape[0], device=x.device), text.argmax(-1)]
        out = self.text_projection(x)
        return (out, inter) if return_intermediates else out


class CLIP(nn.Module):
    """CLIP with ``encode_image`` / ``encode_text`` (L2-normalized by default).

    ``vision_num_layers`` an int builds the ViT tower (``vision_patch_size`` needed), a sequence of
    four the ModifiedResNet with ``vision_features * 32 // 64`` attention-pool heads, as the Flax
    ``CLIP.setup`` dispatches.  ``image_size`` sizes the positional embedding of either tower."""

    def __init__(self, vocab_size: int, embed_dim: int, text_features: int, text_num_layers: int,
                 text_num_heads: int, vision_features: int, vision_num_layers: Union[int, Sequence[int]],
                 vision_patch_size: Optional[int] = None, image_size: int = 224,
                 score_dtype: Optional[torch.dtype] = None, vision_return_map: bool = False):
        super().__init__()
        resnet = not isinstance(vision_num_layers, int)
        if resnet:
            vision_num_layers = tuple(int(n) for n in vision_num_layers)
        # the constructor's widths, as an engine spec records them (ClipRewardEngine.save_npz)
        self.config = dict(vocab_size=vocab_size, embed_dim=embed_dim, text_features=text_features,
                           text_num_layers=text_num_layers, text_num_heads=text_num_heads,
                           vision_features=vision_features, vision_num_layers=vision_num_layers,
                           vision_patch_size=vision_patch_size)
        self.vision_patch_size = vision_patch_size
        self.vision_features = vision_features
        self.image_size = image_size
        out_features = None if vision_return_map else embed_dim
        if resnet:
            self.visual = ModifiedResNet(
                features=vision_features,
                out_features=out_features,
                num_layers=vision_num_layers,
                num_heads=vision_features * 32 // 64,
                image_size=image_size,
            )
        else:
            self.visual = VisionTransformer(
                patch_size=vision_patch_size,
                features=vision_features,
                num_layers=vision_num_layers,
                num_heads=vision_features // 64,
                out_features=out_features,
                image_size=image_size,
                score_dtype=score_dtype,
            )
        self.text = TextEncoder(
            vocab_size=vocab_size,
            features=text_features,
            num_layers=text_num_layers,
            num_heads=text_num_heads,
            out_features=embed_dim,
            score_dtype=score_dtype,
        )
        self.logit_scale = nn.Parameter(torch.zeros(()))

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.visual, ModifiedResNet)

    def encode_image(self, image, normalize: bool = True, return_intermediates: bool = False):
        """``return_intermediates``: (features, every vision block's (B, N, D) output in layer
        order), the blocks' outputs taken before ``ln_post``, as Flax captures them (ViT only)."""
        if self.is_resnet:
            if return_intermediates:
                raise ValueError("return_intermediates: the ModifiedResNet tower has no transformer blocks")
            x = self.visual(image)[0]
            return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True) if normalize else x
        x, inter = self.visual(image, return_intermediates=True)
        if normalize:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return (x, inter) if return_intermediates else x

    def encode_text(self, text, normalize: bool = True, return_intermediates: bool = False):
        """``return_intermediates``: as :meth:`encode_image`, the text blocks' outputs before ``ln_final``."""
        x, inter = self.text(text, return_intermediates=True)
        if normalize:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return (x, inter) if return_intermediates else x


def _model_fn(name):
    def fn(**overrides):
        return CLIP(**{**CONFIGS[name], "image_size": IMAGE_RESOLUTION[name], **overrides})

    return fn


MODELS = {
    "resnet_50": _model_fn("resnet_50"),
    "resnet_101": _model_fn("resnet_101"),
    "resnet_50x4": _model_fn("resnet_50x4"),
    "resnet_50x16": _model_fn("resnet_50x16"),
    "resnet_50x64": _model_fn("resnet_50x64"),
    "vit_b32": _model_fn("vit_b32"),
    "vit_b16": _model_fn("vit_b16"),
    "vit_l14": _model_fn("vit_l14"),
    "vit_b32_clip4clip": _model_fn("vit_b32"),
    "vit_b16_clip4clip": _model_fn("vit_b16"),
}


def load_model_vars(model_name: str, checkpoint_path: Optional[str] = None, download_dir: Optional[str] = None) -> dict:
    """CLIP variables in arp_tpu's Flax layout (numpy) from a local OpenAI checkpoint.

    ``checkpoint_path`` is a ``.npy`` of the torch state dict or the raw ``.pt`` jit
    archive; by default ``{download_dir}/{model_name}.npy``, ``download_dir`` defaulting to
    ``$ARP_TPU_CHECKPOINT_DIR`` or ``~/.cache/arp_tpu``, as in the JAX package.  Give the
    result to :func:`arp_tpu_torch.models.clip.flax_to_torch`.  A missing file raises:
    fetching the checkpoints is not ported.
    """
    from .convert import convert_torch_clip_vars

    if checkpoint_path is None:
        if download_dir is None:
            download_dir = os.environ.get("ARP_TPU_CHECKPOINT_DIR", os.path.expanduser("~/.cache/arp_tpu"))
        checkpoint_path = os.path.join(download_dir, model_name + ".npy")
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(
            f"CLIP checkpoint not found at {checkpoint_path}: save the OpenAI state dict there as .npy "
            "(the JAX package's models/clip/convert.py says how) or pass the .pt archive; fetching it is not ported")
    if checkpoint_path.endswith(".pt"):
        state = torch.jit.load(checkpoint_path, map_location="cpu").state_dict()
        np_params = {k: v.cpu().numpy() for k, v in state.items()}
    else:
        with open(checkpoint_path, "rb") as f:
            np_params = np.load(f, allow_pickle=True).tolist()
    return convert_torch_clip_vars(np_params)
