"""M3AE (masked multimodal autoencoder) and MAE encoders (port of arp_tpu/models/m3ae.py).

The encoder side only: ``forward_representation`` and
``forward_gc_representations`` drive the policy models, with the per-layer
block outputs on request (the InstructRL-style multi-layer feature concat).
The module tree mirrors the Flax one (``encoder.blocks_0.attn.qkv.kernel``).

Not ported yet: the decoder, random masking and the losses.
:func:`load_m3ae_model_vars` reads the reference's pickled params
(``m3ae_*_params.pkl``) as the JAX package does, through
:func:`convert_reference_m3ae_params` and the weight bridge; an explicit
``.pt`` path is the port's own format, a ``torch.save``d state dict of one of
the two modules here.  :func:`export_reference_m3ae_params` writes this tree
back under the reference's names.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import Config, update_config
from ..ops.masks import MaskSpec
from ..utils import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed
from .clip.convert import _flatten, _unflatten
from .layers import Transformer, dense, resolve_compute_dtype


def extract_patches(inputs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) images -> (B, N, P*P*C) patch vectors.

    Patch ordering is row-major over the patch grid, each vector laid out
    (p_row, p_col, channel), the layout converted checkpoints assume.
    """
    b, h, w, c = inputs.shape
    p = patch_size
    x = inputs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def get_transformer_by_config(model_type: str, config: Config) -> None:
    presets = {
        "small": dict(emb_dim=384, depth=12, num_heads=6),
        "base": dict(emb_dim=768, depth=12, num_heads=12),
        "large": dict(emb_dim=1024, depth=24, num_heads=16),
        "huge": dict(emb_dim=1280, depth=32, num_heads=16),
        "debug": dict(emb_dim=1024, depth=2, num_heads=16),
    }
    if model_type not in presets:
        return  # unknown/custom names keep the explicitly configured dims
    for k, v in presets[model_type].items():
        config[k] = v
    config.dec_emb_dim = 512
    config.dec_depth = 8 if model_type != "debug" else 2
    config.dec_num_heads = 16
    config.mlp_ratio = 4


def _default_config(updates, with_text: bool) -> Config:
    config = Config(
        model_type="base", emb_dim=1024, dec_emb_dim=512, depth=24, dec_depth=8, num_heads=16,
        dec_num_heads=16, mlp_ratio=4, output_head_depth=0, att_drop=0.0, drop=0.0, remat=False,
        compute_dtype="float32",
        # "bfloat16" runs the layernorm outputs and the residual stream in bf16
        # too: the frozen-tower inference recipe (models/layers.py::Block).
        ln_dtype="float32",
        # attention score/softmax dtype of the plain attention; kernel K1's
        # softmax is float32 whatever this says (ops/attention.py).
        score_dtype="float32",
        drop_path=0.0, image_mask_ratio=0.75,
    )
    if with_text:
        config.text_mask_ratio = 0.75
    config.use_type_embedding = True
    update_config(config, updates)
    if config.model_type is not None:
        get_transformer_by_config(config.model_type, config)
    return config


def _encoder(cfg: Config) -> Transformer:
    return Transformer(
        emb_dim=cfg.emb_dim, depth=cfg.depth, num_heads=cfg.num_heads, att_drop=cfg.att_drop, drop=cfg.drop,
        drop_path=cfg.drop_path, mlp_ratio=cfg.mlp_ratio, mlp_bias=True, remat=cfg.get("remat", False),
        compute_dtype=resolve_compute_dtype(cfg.get("compute_dtype", "float32")),
        ln_dtype=resolve_compute_dtype(cfg.get("ln_dtype", "float32")),
        score_dtype=resolve_compute_dtype(cfg.get("score_dtype", "float32")),
    )


class _ImageEncoder(nn.Module):
    """What the two modules share: image embedding, cls token, type embedding, encoder."""

    def _build(self, cfg: Config, image_output_dim: int) -> None:
        self.image_embedding = nn.Linear(image_output_dim, cfg.emb_dim)
        nn.init.xavier_uniform_(self.image_embedding.weight)
        nn.init.zeros_(self.image_embedding.bias)
        if cfg.use_type_embedding:
            self.encoder_image_type_embedding = nn.Parameter(0.02 * torch.randn(1, 1, cfg.emb_dim))
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, cfg.emb_dim))
        self.encoder = _encoder(cfg)

    def get_type_embedding(self, name: str):
        return getattr(self, name) if self.config.use_type_embedding else 0.0

    def _embed_image(self, image):
        return (
            dense(image, self.image_embedding)
            + get_2d_sincos_pos_embed(self.config.emb_dim, image.shape[1], image.device)
            + self.get_type_embedding("encoder_image_type_embedding")
        )

    def _cls(self, batch_size: int):
        return self.cls_token.expand(batch_size, 1, self.config.emb_dim)


def _cat(tensors):
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=1)


class MaskedMultimodalAutoencoder(_ImageEncoder):
    """M3AE encoder over image patches and (optionally) text tokens.

    ``image_output_dim`` is the width of a patch vector (P * P * C), the
    input width of ``image_embedding``.
    """

    def __init__(self, config_updates=None, text_vocab_size: int = -1, image_output_dim: int = 768):
        super().__init__()
        assert text_vocab_size > 0
        self.config = cfg = self.get_default_config(config_updates)
        self.text_embedding = nn.Embedding(text_vocab_size, cfg.emb_dim)
        if cfg.use_type_embedding:
            self.encoder_text_type_embedding = nn.Parameter(0.02 * torch.randn(1, 1, cfg.emb_dim))
        self._build(cfg, image_output_dim)

    @staticmethod
    def get_default_config(updates=None) -> Config:
        return _default_config(updates, with_text=True)

    def _embed_text(self, text):
        return (
            self.text_embedding(text)
            + get_1d_sincos_pos_embed(self.config.emb_dim, text.shape[1], text.device)
            + self.get_type_embedding("encoder_text_type_embedding")
        )

    def forward_representation(self, image, text, text_padding_mask, deterministic: bool = False,
                               return_intermediates: bool = False):
        """[cls, image, text] tokens through the encoder.  Key padding only with
        text: an image-only encode passes no mask, so the attention builds none."""
        batch_size = image.shape[0]
        tensors = [self._cls(batch_size)]
        paddings = [torch.zeros((batch_size, 1), dtype=torch.float32, device=image.device)]
        if image is not None:
            tensors.append(self._embed_image(image))
            paddings.append(torch.zeros((batch_size, image.shape[1]), dtype=torch.float32, device=image.device))
        if text is not None:
            tensors.append(self._embed_text(text))
            paddings.append(text_padding_mask.to(torch.float32))
        padding_mask = torch.cat(paddings, dim=1) if text is not None else None
        return self.encoder(_cat(tensors), deterministic, MaskSpec("none"), padding_mask,
                            return_intermediates=return_intermediates)

    def forward_gc_representations(self, image, goal_image, deterministic: bool = False):
        """Joint (obs, goal) encoding for GCBC: [cls, image, goal] tokens."""
        assert image.shape == goal_image.shape
        tensors = [self._cls(image.shape[0]), self._embed_image(image), self._embed_image(goal_image)]
        return self.encoder(_cat(tensors), deterministic, MaskSpec("none"), None)


class MaskedAutoencoder(_ImageEncoder):
    """Image-only MAE encoder."""

    def __init__(self, config_updates=None, image_output_dim: int = 768):
        super().__init__()
        self.config = cfg = self.get_default_config(config_updates)
        self._build(cfg, image_output_dim)

    @staticmethod
    def get_default_config(updates=None) -> Config:
        return _default_config(updates, with_text=False)

    def forward_representation(self, image, deterministic: bool = False, return_intermediates: bool = False):
        x = _cat([self._cls(image.shape[0]), self._embed_image(image)])
        return self.encoder(x, deterministic, MaskSpec("none"), return_intermediates=return_intermediates)


# --- Reference-checkpoint ingestion (numpy trees in the Flax layout) ------------------------------


def _params_tree(tree) -> dict:
    tree = dict(tree)
    return dict(tree["params"]) if "params" in tree else tree


def convert_reference_m3ae_params(ref_params) -> dict:
    """Map the reference's auto-named m3ae params onto this module tree, as numpy.

    Reference naming (its m3ae/model.py, @nn.compact auto names):
      encoder/Block_i/LayerNorm_0         -> encoder/blocks_i/norm1
      encoder/Block_i/Attention_0/Dense_0 -> encoder/blocks_i/attn/qkv
      encoder/Block_i/Attention_0/Dense_1 -> encoder/blocks_i/attn/attn_out
      encoder/Block_i/LayerNorm_1         -> encoder/blocks_i/norm2
      encoder/Block_i/TransformerMLP_0/*  -> encoder/blocks_i/mlp/*  (FeedForward_0 too)
      encoder/LayerNorm_0                 -> encoder/norm
    (the same for the decoder); every other name is kept.  Returns ``{"params": tree}``.
    """
    out = {}
    for path, value in _flatten(_params_tree(ref_params)).items():
        parts = list(path)
        new_parts = []
        for i, p in enumerate(parts):
            if p.startswith("Block_"):
                new_parts.append("blocks_" + p.split("_")[1])
            elif p == "Attention_0":
                new_parts.append("attn")
            elif p in ("TransformerMLP_0", "FeedForward_0"):
                new_parts.append("mlp")
            elif p == "LayerNorm_0" and i > 0 and parts[i - 1].startswith("Block_"):
                new_parts.append("norm1")
            elif p == "LayerNorm_1" and i > 0 and parts[i - 1].startswith("Block_"):
                new_parts.append("norm2")
            elif p == "LayerNorm_0" and (i == 0 or parts[i - 1] in ("encoder", "decoder")):
                new_parts.append("norm")  # the final norm of a Transformer stack (standalone or named)
            elif p == "Dense_0" and new_parts and new_parts[-1] == "attn":
                new_parts.append("qkv")
            elif p == "Dense_1" and new_parts and new_parts[-1] == "attn":
                new_parts.append("attn_out")
            else:
                new_parts.append(p)
        out[tuple(new_parts)] = np.asarray(value)
    return {"params": _unflatten(out)}


def export_reference_m3ae_params(params) -> dict:
    """Inverse of :func:`convert_reference_m3ae_params`: this module tree under the reference's
    auto-generated names, as numpy (``FeedForward_0`` for the MLP).  Returns ``{"params": tree}``."""
    out = {}
    for path, value in _flatten(_params_tree(params)).items():
        parts = list(path)
        new_parts = []
        for i, p in enumerate(parts):
            if p.startswith("blocks_"):
                new_parts.append("Block_" + p.split("_")[1])
            elif p == "attn":
                new_parts.append("Attention_0")
            elif p == "mlp" and new_parts and new_parts[-1].startswith("Block_"):
                new_parts.append("FeedForward_0")
            elif p == "norm1":
                new_parts.append("LayerNorm_0")
            elif p == "norm2":
                new_parts.append("LayerNorm_1")
            elif p == "norm" and (i == 0 or parts[i - 1] in ("encoder", "decoder")):
                new_parts.append("LayerNorm_0")
            elif p == "qkv":
                new_parts.append("Dense_0")
            elif p == "attn_out":
                new_parts.append("Dense_1")
            else:
                new_parts.append(p)
        out[tuple(new_parts)] = np.asarray(value)
    return {"params": _unflatten(out)}


_CHECKPOINT_FILES = {
    "vit_s16": "m3ae_small_params.pkl",
    "vit_b16": "m3ae_base_params.pkl",
    "vit_l16": "m3ae_large_params.pkl",
}


def load_m3ae_model_vars(model_name_or_path: str, checkpoint_dir: Optional[str] = None) -> dict:
    """An encoder's state dict for this module tree (float32).

    By model name, the reference's pickled params ``m3ae_{small,base,large}_params.pkl`` in
    ``checkpoint_dir`` / ``$ARP_TPU_CHECKPOINT_DIR``, as the JAX package reads them; a path to
    such a pickle likewise.  Both are read without flax or jax (checkpoint.py::load_pickle),
    renamed by :func:`convert_reference_m3ae_params` and carried over by the weight bridge.  A
    path ending in ``.pt`` is the port's own format, a ``torch.save``d state dict.
    """
    path = model_name_or_path
    if model_name_or_path in _CHECKPOINT_FILES:
        base = checkpoint_dir or os.environ.get("ARP_TPU_CHECKPOINT_DIR", os.path.expanduser("~/.cache/arp_tpu"))
        path = os.path.join(base, _CHECKPOINT_FILES[model_name_or_path])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"m3ae checkpoint not found at {path}; place the pickled params there "
            f"or pass an explicit path."
        )
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    from ..checkpoint import load_pickle
    from .policy.convert import flax_m3ae_to_torch

    return flax_m3ae_to_torch(convert_reference_m3ae_params(load_pickle(path)))


M3AE_MODEL_CONFIGS = {
    "vit_s16": "small",
    "vit_b16": "base",
    "vit_l16": "large",
}
