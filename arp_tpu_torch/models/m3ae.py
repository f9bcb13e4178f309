"""M3AE (masked multimodal autoencoder) and MAE (port of arp_tpu/models/m3ae.py).

``forward_representation`` and ``forward_gc_representations`` drive the
policy models, with the per-layer block outputs on request (the
InstructRL-style multi-layer feature concat).  ``forward_encoder`` +
``forward_decoder`` (``forward``, Flax's ``__call__``) give the masked
autoencoding objective of pretraining (train/pretrain_m3ae.py) with
:func:`random_masking`, :func:`patch_mse_loss` and
:func:`cross_entropy_loss_and_accuracy`.  The module tree mirrors the Flax one
(``encoder.blocks_0.attn.qkv.kernel``).

The decoder exists only where it is asked for: ``decoder=True`` at
construction adds the decoder stack, ``decoder_input_projection``, the mask
embeddings, the decoder's type embeddings and the two output heads
(``decoder_{image,text}_output``, :class:`~.layers.MLP`).  Flax creates those
params only when ``__call__`` is initialised, so an encoder built as the
policies build it (``decoder=False``, the default) keeps the tree and the
state dicts of the towers, and loads them strictly.

Random masking draws ONE uniform vector a call from a ``torch.Generator``
(:func:`random_masking`); :func:`random_masking_from_uniform` is the same
function of the draw itself, so JAX's ``jax.random.uniform(rng, (seq_len,))``
fed to it gives JAX's permutation bit for bit.

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
from .layers import MLP, Transformer, dense, resolve_compute_dtype


def extract_patches(inputs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) images -> (B, N, P*P*C) patch vectors.

    Patch ordering is row-major over the patch grid, each vector laid out
    (p_row, p_col, channel), the layout converted checkpoints assume.
    """
    b, h, w, c = inputs.shape
    p = patch_size
    x = inputs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def merge_patches(inputs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Inverse of :func:`extract_patches` for square patch grids: (B, N, P*P*C) -> (B, H, W, C)."""
    b, n, d = inputs.shape
    side, p = int(n ** 0.5), patch_size
    c = d // (p * p)
    x = inputs.reshape(b, side, side, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, side * p, side * p, c)


def random_masking_from_uniform(x: torch.Tensor, uniform: torch.Tensor, keep_len: int, padding_mask=None):
    """MAE-style random token drop with ONE permutation for the whole batch, from its uniform draw.

    ``uniform`` is a (seq_len,) draw: positions are ranked by its (stable) argsort and the
    ``keep_len`` best-ranked survive.  Returns ``(kept_tokens, drop_mask, unshuffle_ids[,
    kept_padding_mask])``: ``drop_mask[b, j] = 1.0`` iff position ``j`` was dropped, and
    ``unshuffle_ids`` puts the decoder's tokens back in their original order.
    """
    seq_len = x.shape[1]
    rank = torch.argsort(uniform.to(x.device), stable=True)
    unshuffle = torch.argsort(rank, stable=True)
    keep_ids = rank[:keep_len]
    kept = x[:, keep_ids]
    # position j survives iff its rank index is < keep_len
    drop_mask = (unshuffle >= keep_len).to(torch.float32).expand(x.shape[0], seq_len)
    if padding_mask is None:
        return kept, drop_mask, unshuffle
    return kept, drop_mask, unshuffle, padding_mask[:, keep_ids]


def random_masking(x: torch.Tensor, keep_len: int, padding_mask=None, generator: Optional[torch.Generator] = None):
    """:func:`random_masking_from_uniform` on a float32 uniform of length ``seq_len`` drawn from
    ``generator`` on its own device (torch's global generator on ``x``'s device without one)."""
    device = generator.device if generator is not None else x.device
    uniform = torch.rand(x.shape[1], generator=generator, device=device, dtype=torch.float32)
    return random_masking_from_uniform(x, uniform, keep_len, padding_mask)


def cross_entropy_loss_and_accuracy(logits: torch.Tensor, tokens: torch.Tensor, valid=None):
    """Per-sequence-normalized masked cross entropy and accuracy (M3AE's loss).

    Each sequence's token losses are summed and divided by its own valid count (at least
    1e-5) before the mean over the batch, so short sequences are not down-weighted.
    """
    if valid is None:
        valid = torch.ones(tokens.shape[:2], device=logits.device)
    live = valid > 0.0
    per_seq = valid.sum(dim=-1).clamp_min(1e-5)
    token_logp = torch.log_softmax(logits, dim=-1).gather(-1, tokens[..., None].long())[..., 0]
    loss = -torch.mean(torch.where(live, token_logp, 0.0).sum(dim=-1) / per_seq)
    hits = live & (logits.argmax(dim=-1) == tokens)
    accuracy = torch.mean(hits.sum(dim=-1) / per_seq)
    return loss, accuracy


def patch_mse_loss(patch_output: torch.Tensor, patch_target: torch.Tensor, valid=None) -> torch.Tensor:
    """Masked MSE over patches, normalized by each sequence's valid fraction."""
    if valid is None:
        valid = torch.ones(patch_target.shape[:2], device=patch_target.device)
    per_patch = (patch_target - patch_output).square().mean(dim=-1)
    masked = torch.where(valid > 0.0, per_patch, 0.0).mean(dim=-1)
    valid_frac = valid.sum(dim=-1) / valid.shape[-1]
    return torch.mean(masked / valid_frac)


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


def _transformer(cfg: Config, emb_dim: int, depth: int, num_heads: int) -> Transformer:
    return Transformer(
        emb_dim=emb_dim, depth=depth, num_heads=num_heads, att_drop=cfg.att_drop, drop=cfg.drop,
        drop_path=cfg.drop_path, mlp_ratio=cfg.mlp_ratio, mlp_bias=True, remat=cfg.get("remat", False),
        compute_dtype=resolve_compute_dtype(cfg.get("compute_dtype", "float32")),
        ln_dtype=resolve_compute_dtype(cfg.get("ln_dtype", "float32")),
        score_dtype=resolve_compute_dtype(cfg.get("score_dtype", "float32")),
    )


def _norm02(*shape) -> nn.Parameter:
    return nn.Parameter(0.02 * torch.randn(*shape))


def _xavier_linear(in_dim: int, out_dim: int) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    nn.init.xavier_uniform_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def _head(cfg: Config, output_dim: int) -> MLP:
    return MLP(cfg.dec_emb_dim, cfg.dec_emb_dim, output_dim, cfg.output_head_depth,
               input_norm=cfg.output_head_depth > 0)


class _ImageEncoder(nn.Module):
    """What the two modules share: image embedding, cls token, type embedding, encoder; with
    ``decoder`` the decoder stack, its input projection and the image side of its tokens and head."""

    def _build(self, cfg: Config, image_output_dim: int, decoder: bool) -> None:
        self.has_decoder = decoder
        self.image_embedding = _xavier_linear(image_output_dim, cfg.emb_dim)
        if cfg.use_type_embedding:
            self.encoder_image_type_embedding = _norm02(1, 1, cfg.emb_dim)
        self.cls_token = _norm02(1, 1, cfg.emb_dim)
        self.encoder = _transformer(cfg, cfg.emb_dim, cfg.depth, cfg.num_heads)
        if decoder:
            if cfg.use_type_embedding:
                self.decoder_image_type_embedding = _norm02(1, 1, cfg.dec_emb_dim)
            self.image_mask_embedding = _norm02(1, 1, cfg.dec_emb_dim)
            self.decoder = _transformer(cfg, cfg.dec_emb_dim, cfg.dec_depth, cfg.dec_num_heads)
            self.decoder_input_projection = _xavier_linear(cfg.emb_dim, cfg.dec_emb_dim)
            self.decoder_image_output = _head(cfg, image_output_dim)

    def _need_decoder(self) -> None:
        if not self.has_decoder:
            raise RuntimeError("the autoencoding forward needs the decoder: build the module with decoder=True")

    def trained_state_dict(self) -> dict:
        """Every parameter trains in pretraining: the state dict (checkpoint.py's interface)."""
        return self.state_dict()

    def load_trained_state_dict(self, state: dict) -> None:
        self.load_state_dict(state)

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

    def _decoder_tokens(self, x, ids_restore, mask_ratio: float, mask_embedding, type_name: str, pos_embed):
        """The kept tokens ``x`` (projected), the mask embedding in the dropped places, put back in
        order by ``ids_restore``, plus the decoder's position and type embeddings."""
        dim, b, n = self.config.dec_emb_dim, x.shape[0], ids_restore.shape[0]
        masked = mask_embedding.expand(b, n - int(n * (1.0 - mask_ratio)), dim)
        x = _cat([x, masked])[:, ids_restore]
        return x + pos_embed(dim, n, x.device) + self.get_type_embedding(type_name)


def _cat(tensors):
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=1)


class MaskedMultimodalAutoencoder(_ImageEncoder):
    """M3AE over image patches and (optionally) text tokens; with ``decoder`` the autoencoder.

    ``image_output_dim`` is the width of a patch vector (P * P * C): the input width of
    ``image_embedding`` and the output width of ``decoder_image_output``.
    """

    def __init__(self, config_updates=None, text_vocab_size: int = -1, image_output_dim: int = 768,
                 decoder: bool = False):
        super().__init__()
        assert text_vocab_size > 0
        self.config = cfg = self.get_default_config(config_updates)
        self.text_embedding = nn.Embedding(text_vocab_size, cfg.emb_dim)
        if cfg.use_type_embedding:
            self.encoder_text_type_embedding = _norm02(1, 1, cfg.emb_dim)
        self._build(cfg, image_output_dim, decoder)
        if decoder:
            if cfg.use_type_embedding:
                self.decoder_text_type_embedding = _norm02(1, 1, cfg.dec_emb_dim)
            self.text_mask_embedding = _norm02(1, 1, cfg.dec_emb_dim)
            self.decoder_text_output = _head(cfg, text_vocab_size)

    @staticmethod
    def get_default_config(updates=None) -> Config:
        return _default_config(updates, with_text=True)

    @staticmethod
    def no_decay_list() -> list:
        return ["cls_token", "encoder_image_type_embedding", "encoder_text_type_embedding", "image_mask_embedding",
                "text_mask_embedding", "text_embedding"]

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

    def forward_encoder(self, image, text, text_padding_mask, deterministic: bool = False,
                        generator: Optional[torch.Generator] = None,
                        dropout_generator: Optional[torch.Generator] = None):
        """[cls, kept image tokens, kept text tokens] through the encoder, key padding the kept text's.
        The image's masking draw comes first from ``generator``, then the text's; the encoder's dropout
        masks come from ``dropout_generator`` (``generator`` without one).  Returns
        ``(cls_x, image_x, text_x, image_mask, text_mask, image_ids_restore, text_ids_restore)``."""
        cfg = self.config
        first = image if image is not None else text
        batch_size, device = first.shape[0], first.device
        tensors = [self._cls(batch_size)]
        paddings = [torch.zeros((batch_size, 1), dtype=torch.float32, device=device)]
        image_mask = image_ids_restore = text_mask = text_ids_restore = None
        if image is not None:
            image_keep = int(image.shape[1] * (1.0 - cfg.image_mask_ratio))
            image_x, image_mask, image_ids_restore = random_masking(self._embed_image(image), image_keep,
                                                                    generator=generator)
            tensors.append(image_x)
            paddings.append(torch.zeros((batch_size, image_keep), dtype=torch.float32, device=device))
        if text is not None:
            text_keep = int(text.shape[1] * (1.0 - cfg.text_mask_ratio))
            text_x, text_mask, text_ids_restore, kept_padding = random_masking(
                self._embed_text(text), text_keep, text_padding_mask.to(torch.float32), generator=generator)
            tensors.append(text_x)
            paddings.append(kept_padding)
        x = self.encoder(_cat(tensors), deterministic, MaskSpec("none"), torch.cat(paddings, dim=1),
                         generator=generator if dropout_generator is None else dropout_generator)
        cls_x = x[:, :1]
        if image is None:
            image_x, text_x = None, x[:, 1:]
        elif text is None:
            image_x, text_x = x[:, 1:], None
        else:
            image_x, text_x = x[:, 1:image_keep + 1], x[:, image_keep + 1:]
        return cls_x, image_x, text_x, image_mask, text_mask, image_ids_restore, text_ids_restore

    def forward_decoder(self, cls_x, image_x, text_x, image_ids_restore, text_ids_restore, text_padding_mask,
                        deterministic: bool = False, generator: Optional[torch.Generator] = None):
        """The decoder over [cls, every image position, every text position], the dropped ones
        holding the mask embeddings, key padding the full-length ``text_padding_mask``; returns the
        two heads' outputs (None for a modality that is absent)."""
        self._need_decoder()
        cfg = self.config
        batch_size, device = cls_x.shape[0], cls_x.device
        tensors = [dense(cls_x, self.decoder_input_projection)]
        paddings = [torch.zeros((batch_size, 1), dtype=torch.float32, device=device)]
        if image_x is not None:
            tensors.append(self._decoder_tokens(
                dense(image_x, self.decoder_input_projection), image_ids_restore, cfg.image_mask_ratio,
                self.image_mask_embedding, "decoder_image_type_embedding", get_2d_sincos_pos_embed))
            paddings.append(torch.zeros((batch_size, image_ids_restore.shape[0]), dtype=torch.float32, device=device))
        if text_x is not None:
            tensors.append(self._decoder_tokens(
                dense(text_x, self.decoder_input_projection), text_ids_restore, cfg.text_mask_ratio,
                self.text_mask_embedding, "decoder_text_type_embedding", get_1d_sincos_pos_embed))
            paddings.append(text_padding_mask.to(torch.float32))
        x = self.decoder(_cat(tensors), deterministic, MaskSpec("none"), torch.cat(paddings, dim=1),
                         generator=generator)
        if image_x is None:
            return None, self.decoder_text_output(x[:, 1:])
        if text_x is None:
            return self.decoder_image_output(x[:, 1:]), None
        n_img = image_ids_restore.shape[0]
        return self.decoder_image_output(x[:, 1:n_img + 1]), self.decoder_text_output(x[:, n_img + 1:])

    def forward(self, image, text, text_padding_mask, deterministic: bool = False,
                generator: Optional[torch.Generator] = None, dropout_generator: Optional[torch.Generator] = None):
        """Flax's ``__call__``: ``(image_output, text_output, image_mask, text_mask)``.  The masking draws
        come from ``generator``, the dropout masks from ``dropout_generator`` (``generator`` without one)."""
        self._need_decoder()
        cls_x, image_x, text_x, image_mask, text_mask, image_ids_restore, text_ids_restore = self.forward_encoder(
            image, text, text_padding_mask, deterministic, generator, dropout_generator)
        image_output, text_output = self.forward_decoder(
            cls_x, image_x, text_x, image_ids_restore, text_ids_restore, text_padding_mask, deterministic,
            generator if dropout_generator is None else dropout_generator)
        return image_output, text_output, image_mask, text_mask


class MaskedAutoencoder(_ImageEncoder):
    """Image-only MAE; with ``decoder`` the autoencoder."""

    def __init__(self, config_updates=None, image_output_dim: int = 768, decoder: bool = False):
        super().__init__()
        self.config = cfg = self.get_default_config(config_updates)
        self._build(cfg, image_output_dim, decoder)

    @staticmethod
    def get_default_config(updates=None) -> Config:
        return _default_config(updates, with_text=False)

    @staticmethod
    def no_decay_list() -> list:
        return ["cls_token", "encoder_image_type_embedding", "image_mask_embedding"]

    def forward_representation(self, image, deterministic: bool = False, return_intermediates: bool = False):
        x = _cat([self._cls(image.shape[0]), self._embed_image(image)])
        return self.encoder(x, deterministic, MaskSpec("none"), return_intermediates=return_intermediates)

    def forward_encoder(self, image, deterministic: bool = False, generator: Optional[torch.Generator] = None):
        """[cls, kept image tokens] through the encoder: ``(x, image_mask, ids_restore)``."""
        keep = int(image.shape[1] * (1.0 - self.config.image_mask_ratio))
        image_x, image_mask, ids_restore = random_masking(self._embed_image(image), keep, generator=generator)
        x = _cat([self._cls(image.shape[0]), image_x])
        return self.encoder(x, deterministic, MaskSpec("none"), generator=generator), image_mask, ids_restore

    def forward_decoder(self, x, ids_restore, deterministic: bool = False,
                        generator: Optional[torch.Generator] = None):
        self._need_decoder()
        x = dense(x, self.decoder_input_projection)
        image_x = self._decoder_tokens(x[:, 1:], ids_restore, self.config.image_mask_ratio, self.image_mask_embedding,
                                       "decoder_image_type_embedding", get_2d_sincos_pos_embed)
        x = self.decoder(_cat([x[:, :1], image_x]), deterministic, MaskSpec("none"), generator=generator)
        return self.decoder_image_output(x[:, 1:])

    def forward(self, image, deterministic: bool = False, generator: Optional[torch.Generator] = None):
        """Flax's ``__call__``: ``(image_output, image_mask, encoded)``."""
        self._need_decoder()
        x, image_mask, ids_restore = self.forward_encoder(image, deterministic, generator)
        return self.forward_decoder(x, ids_restore, deterministic, generator), image_mask, x


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
