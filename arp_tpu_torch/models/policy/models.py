"""Policy models: ARPDT (reward-conditioned DT), BC / InstructRL, GCBC
(port of arp_tpu/models/policy/models.py).

One shared implementation; the three differ in the token layout and the
goal / return-to-go conditioning.  Token streams per timestep:

    ARPDT:  [obs_tokens..., (state), rtg, action]
    BC:     [obs_tokens..., (state), action]
    GCBC:   [obs_tokens..., (state), action]  with goal-joint obs encoding

As in the Flax models:
  * the causal + intra-step-obs mask is a lazy MaskSpec evaluated inside the
    attention (kernel K1 on CUDA);
  * the ensemble action/return heads run as ONE batched matmul over the
    leading ensemble axis;
  * the frozen encoders (CLIP / MAE / M3AE) run without gradients and can run
    in bf16 (``frozen_bf16``) or through the packed int8 forward
    (``frozen_int8``: ops/m3ae_infer.py, kernel K2 on CUDA).

What PyTorch changes: the configuration is a plain
:class:`arp_tpu_torch.config.Config`; layers whose input width Flax infers
at ``init`` are lazy modules, materialized by the first forward (run one
before ``load_trained_state_dict``); a frozen tower is a submodule with
``requires_grad`` off, cast once at construction, and its weights come from
``pt_variables`` (a state dict) or from the loader of its family; the batch
may hold numpy arrays or tensors and is moved to the module's device.
``pp_stages > 1`` pipelines the block stack over the pp axis of the ``mesh``
given at construction (models/layers.py::PipelinedTransformer), as JAX's
policies take their mesh.

Size presets: names in the preset table ("tiny", "base", ...) set the dims;
"vit*" names keep the explicit dims and select the DT block mask.
"""

from __future__ import annotations

import copy
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from ...config import Config, update_config
from ...ops.masks import MaskSpec
from ...profiling import span
from ...utils import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed, symexp, symlog
from .. import m3ae as m3ae_lib
from ..clip import model as clip_lib
from ..impala import ImpalaCNN
from ..layers import AdapterMLP, PipelinedTransformer, Transformer, resolve_compute_dtype

# text vocab of bert-base-uncased; constant to avoid a tokenizer download
BERT_VOCAB_SIZE = 30522

_SIZE_PRESETS = {
    "tiny": dict(emb_dim=128, depth=4, num_heads=8),
    "small": dict(emb_dim=512, depth=4, num_heads=8),
    "base": dict(emb_dim=768, depth=6, num_heads=12),
    "medium": dict(emb_dim=1280, depth=10, num_heads=20),
    "large": dict(emb_dim=1280, depth=14, num_heads=20),
    "huge": dict(emb_dim=1280, depth=18, num_heads=16),
    "debug": dict(emb_dim=16, depth=2, num_heads=2, mlp_ratio=2),
}
_WIDTH_SUFFIXES = {"l": 2560, "xl": 5120}


def apply_size_preset(model_type: str, config: Config) -> None:
    if model_type in _SIZE_PRESETS:
        config.update(_SIZE_PRESETS[model_type])
        return
    for base_name, preset in _SIZE_PRESETS.items():
        if model_type.startswith(base_name):
            suffix = model_type[len(base_name):]
            if suffix in _WIDTH_SUFFIXES:
                config.update(preset)
                config.emb_dim = _WIDTH_SUFFIXES[suffix]
                return
    # unknown names (e.g. "vit_base") keep explicit dims: see the module docstring


def _resolve_compute_dtype(cfg) -> Any:
    return resolve_compute_dtype(cfg.get("compute_dtype", "float32"))


def get_policy_default_config(updates=None) -> Config:
    """Shared policy config, with the JAX package's resolution rules."""
    config = Config()
    config.model_type = None
    config.transfer_type = "none"
    config.alibi_bias = False
    config.att_drop = 0.0
    config.drop = 0.0
    config.mlp_ratio = 4
    config.emb_dim = 128
    config.depth = 2
    config.num_heads = 8
    config.use_discrete_action = False
    config.use_text = False

    config.use_adapter = False
    config.use_from_scratch = False
    config.use_impala_backbone = False
    config.clip_checkpoint_path = "none"

    config.use_intermediate = False
    config.num_ensembles = 5

    # pipeline parallelism over the policy block stack: stages over the mesh's pp axis (the model takes the mesh)
    config.pp_stages = 1
    config.pp_microbatches = 4

    # recompute policy blocks on backward (torch.utils.checkpoint)
    config.remat = False
    # "float32" | "bfloat16": matmul dtype for the policy blocks (float32
    # layernorms/softmax/residuals; parameters stay float32)
    config.compute_dtype = "float32"

    # run every FROZEN pretrained tower (clip / mae / m3ae) with the reward
    # engine's full-bf16 inference recipe: the tower cast to bf16 once, bf16
    # layernorm outputs and residual stream.  The trained policy blocks stay at
    # full precision.  Incompatible with use_from_scratch (the encoder trains there).
    config.frozen_bf16 = False
    # attention score/softmax dtype of the plain attention on the frozen towers
    # under frozen_bf16.  On CUDA the attention is kernel K1, whose softmax is
    # float32 whatever this says.
    config.frozen_score_dtype = "bfloat16"
    # run the frozen m3ae/mae tower through the PACKED int8 forward
    # (ops/m3ae_infer.py): per-output-channel int8 weights, static activation
    # scales calibrated once on real frames.  Implies frozen_bf16.  Requires a
    # calibrated pack on the model (``frozen_qpack``, from build_frozen_qpack()).
    config.frozen_int8 = False
    # additionally run the frozen tower's two attention matmuls w8a8
    # (ops/vit_infer.py::_attention_int8).  "auto" (default) resolves to True
    # under frozen_int8 and False otherwise; "true" forces it (implies
    # frozen_int8), "false" keeps the bf16 attention in the int8 recipe.
    config.frozen_int8_attn = "auto"

    config.lambda_return_pred = 1.0
    config.use_symlog = False

    config.mae = m3ae_lib.MaskedAutoencoder.get_default_config()
    config.mae.use_type_embedding = False
    config.m3ae = m3ae_lib.MaskedMultimodalAutoencoder.get_default_config()

    update_config(config, updates)
    if config.model_type is not None:
        apply_size_preset(config.model_type, config)
    attn = str(config.frozen_int8_attn).lower()
    assert attn in ("auto", "true", "false", "1", "0"), config.frozen_int8_attn
    if attn in ("true", "1"):
        config.frozen_int8 = True  # explicit w8a8 rides on the int8 pack
    elif attn == "auto":
        attn = "true" if config.frozen_int8 else "false"
    config.frozen_int8_attn = "true" if attn in ("true", "1") else "false"
    if config.frozen_int8:
        config.frozen_bf16 = True  # the int8 matmuls ride on the frozen_bf16 recipe
    # remat / compute_dtype cover the whole model: propagate to the frozen-encoder
    # sub-configs unless the sub-config was set explicitly (a non-default sub value wins).
    for sub_name in ("mae", "m3ae"):
        sub = config[sub_name]
        if config.remat and not sub.get("remat", False):
            sub.remat = True
        if config.compute_dtype != "float32" and sub.get("compute_dtype", "float32") == "float32":
            sub.compute_dtype = config.compute_dtype
        if config.frozen_bf16:
            sub.compute_dtype = "bfloat16"
            sub.ln_dtype = "bfloat16"
            if sub.get("score_dtype", "float32") == "float32":
                sub.score_dtype = config.frozen_score_dtype
    if config.frozen_bf16:
        assert not config.use_from_scratch, (
            "frozen_bf16 is an inference recipe for FROZEN pretrained towers; "
            "with use_from_scratch the encoder trains and must keep the "
            "standard mixed-precision recipe (use compute_dtype)"
        )
    return config


def cross_entropy(logits, labels, num_classes):
    acc = (logits.argmax(-1) == labels).float().mean()
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    loss = (-onehot * F.log_softmax(logits, dim=-1)).mean()
    return loss, acc


def mse_loss(val, target):
    return torch.square(val - target).mean()


class _Heads(nn.Module):
    """The stacked parameters of ``num_ensembles`` two-layer heads (Flax: a vmapped ``_Head``)."""

    def __init__(self, num_ensembles: int, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.Dense_0 = nn.Module()
        self.Dense_0.kernel = nn.Parameter(in_dim ** -0.5 * torch.randn(num_ensembles, in_dim, hidden_dim))
        self.Dense_0.bias = nn.Parameter(torch.zeros(num_ensembles, hidden_dim))
        self.Dense_1 = nn.Module()
        self.Dense_1.kernel = nn.Parameter(hidden_dim ** -0.5 * torch.randn(num_ensembles, hidden_dim, out_dim))


class EnsembleHeads(nn.Module):
    """N independent MLP heads, averaged: one batched matmul a layer over the leading ensemble axis."""

    def __init__(self, num_ensembles: int, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.heads = _Heads(num_ensembles, in_dim, hidden_dim, out_dim)

    def forward(self, x):
        lead = x.shape[:-1]
        x = x.reshape(1, -1, x.shape[-1])  # (1, rows, in) against (E, in, hidden)
        h = F.relu(torch.matmul(x, self.heads.Dense_0.kernel) + self.heads.Dense_0.bias[:, None, :])
        out = torch.bmm(h, self.heads.Dense_1.kernel).mean(dim=0)
        return out.reshape(*lead, out.shape[-1])


def _as_tensor(x) -> torch.Tensor:
    """A batch leaf (numpy array, list or tensor) as a tensor, where it lies."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def tree_to(tree, device):
    """A tree of dicts with tensor leaves, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class BasePolicy(nn.Module):
    """Common skeleton; subclasses set ``use_rtg`` / ``use_goal`` / ``resize_clip_input``."""

    use_rtg: bool = False   # ARPDT
    use_goal: bool = False  # GCBC
    resize_clip_input: bool = False  # BC/GCBC resize CLIP input to 224 in the model

    def __init__(self, config_updates=None, num_actions: Optional[int] = None, patch_dim: Optional[int] = None,
                 normalize_quterion: bool = False, frozen_qpack: Any = None, pt_variables: Any = None, mesh=None):
        """``frozen_qpack``: the calibrated int8 pack of the frozen m3ae/mae tower
        (``frozen_int8``; from :func:`build_frozen_qpack`).  ``pt_variables``: the
        frozen tower's state dict; None asks the tower family's loader.  ``mesh``: the
        device mesh (parallel/mesh.py), which ``pp_stages > 1`` pipelines the blocks over."""
        super().__init__()
        self.num_actions, self.patch_dim, self.normalize_quterion = num_actions, patch_dim, normalize_quterion
        self.frozen_qpack = frozen_qpack
        self.config = cfg = self.get_default_config(config_updates)
        self.register_buffer("_anchor", torch.zeros(()), persistent=False)  # says where the module lives
        self.needs_first_forward = True  # the lazy layers and the adapter take their shapes at the first forward
        # frames the frozen tower encoded, and frames whose outputs a rollout's window cache gave back instead
        self.tower_frames_encoded = self.tower_frames_reused = 0
        if self.use_goal and not (cfg.transfer_type.startswith("m3ae") or cfg.transfer_type.endswith("_cached")):
            warnings.warn(
                f"GCBC with transfer_type={cfg.transfer_type!r} does NOT consume the goal frame "
                "(only the m3ae joint encode and the cached-embedding path condition on goals): "
                "this configuration trains as plain BC.",
                stacklevel=2,
            )
        # frozen_bf16 threads the score/softmax dtype into the frozen CLIP tower
        # too (the m3ae/mae towers get it through their sub-configs)
        clip_kwargs = (
            {"score_dtype": resolve_compute_dtype(cfg.frozen_score_dtype)} if cfg.get("frozen_bf16", False) else {}
        )
        if cfg.get("pp_stages", 1) > 1:
            if mesh is None:
                raise ValueError(f"pp_stages={cfg.pp_stages} pipelines the blocks over a mesh's pp axis: pass the mesh")
            self.policy = PipelinedTransformer(
                emb_dim=cfg.emb_dim, depth=cfg.depth, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                alibi_bias=cfg.alibi_bias, stages=cfg.pp_stages, microbatches=cfg.pp_microbatches, mesh=mesh,
                remat=cfg.get("remat", False), compute_dtype=_resolve_compute_dtype(cfg), att_drop=cfg.att_drop,
                drop=cfg.drop,
            )
        else:
            self.policy = Transformer(
                emb_dim=cfg.emb_dim, depth=cfg.depth, att_drop=cfg.att_drop, drop=cfg.drop, num_heads=cfg.num_heads,
                mlp_ratio=cfg.mlp_ratio, alibi_bias=cfg.alibi_bias, remat=cfg.get("remat", False),
                compute_dtype=_resolve_compute_dtype(cfg),
            )
        self.action_outputs = EnsembleHeads(cfg.num_ensembles, cfg.emb_dim, cfg.emb_dim, num_actions)
        if self.use_rtg:
            self.return_outputs = EnsembleHeads(cfg.num_ensembles, cfg.emb_dim, cfg.emb_dim, 1)

        if cfg.use_discrete_action:
            assert num_actions == 15, "15 discrete actions for Procgen benchmark."
            self.action_input = nn.Embedding(num_actions, cfg.emb_dim)
        else:
            self.action_input = nn.LazyLinear(cfg.emb_dim, bias=False)
        self.state_input = nn.LazyLinear(cfg.emb_dim, bias=False)
        if self.use_rtg:
            self.rtg_input = nn.LazyLinear(cfg.emb_dim, bias=False)

        transfer_type = cfg.transfer_type
        frozen = not cfg.use_from_scratch
        self.pt_model, self._pt_frozen = None, False
        if transfer_type.endswith("_cached"):
            # precomputed frozen-encoder embeddings: no encoder lives in the model; text
            # conditioning still loads the CLIP text tower when use_text is set
            assert not (cfg.use_text and not transfer_type.startswith("clip")), (
                f"use_text with {transfer_type}: cached mode has no live text tower for non-CLIP "
                "encoders; cache text embeddings or use the live encoder path"
            )
            if cfg.use_text and transfer_type.startswith("clip"):
                model_name = transfer_type[len("clip_"):-len("_cached")]
                self._set_tower(clip_lib.MODELS[model_name](**clip_kwargs), frozen, pt_variables,
                                lambda: _load_clip_model_vars(model_name), self._clip_dtype())
            self.image_text_input = nn.LazyLinear(cfg.emb_dim)
        elif transfer_type == "none":
            self.patch_emb = nn.LazyLinear(cfg.emb_dim)
        elif transfer_type.startswith("clip"):
            model_name = transfer_type.split("_", 1)[1]
            path = None if cfg.clip_checkpoint_path == "none" else cfg.clip_checkpoint_path
            self._set_tower(clip_lib.MODELS[model_name](**clip_kwargs), frozen, pt_variables,
                            lambda: _load_clip_model_vars(model_name, path), self._clip_dtype())
            if cfg.use_impala_backbone:
                self.impala = ImpalaCNN()
            self.image_text_input = nn.LazyLinear(cfg.emb_dim)
        elif transfer_type.startswith("mae"):
            model_name = transfer_type.split("_", 1)[1]
            self._set_tower(m3ae_lib.MaskedAutoencoder(cfg.mae, image_output_dim=patch_dim * patch_dim * 3),
                            frozen, pt_variables, lambda: m3ae_lib.load_m3ae_model_vars(model_name),
                            torch.bfloat16 if cfg.frozen_bf16 else None)
            self.image_text_input = nn.LazyLinear(cfg.emb_dim)
        elif transfer_type.startswith("m3ae"):
            model_name = transfer_type.split("_", 1)[1]
            self._set_tower(
                m3ae_lib.MaskedMultimodalAutoencoder(cfg.m3ae, text_vocab_size=BERT_VOCAB_SIZE,
                                                     image_output_dim=patch_dim * patch_dim * 3),
                frozen, pt_variables, lambda: m3ae_lib.load_m3ae_model_vars(model_name),
                torch.bfloat16 if cfg.frozen_bf16 else None)
            self.image_text_input = nn.LazyLinear(cfg.emb_dim)
        else:
            raise ValueError("Unsupported transfer type!")

        if cfg.use_adapter:
            self.residual_weight = nn.Parameter(torch.full((1,), 4.0))

    @staticmethod
    def get_default_config(updates=None) -> Config:
        return get_policy_default_config(updates)

    def no_decay_list(self) -> list:
        """Name parts whose parameters skip weight decay: none, so every parameter decays."""
        return []

    # -- construction and state -------------------------------------------------

    def _clip_dtype(self):
        return torch.bfloat16 if self.config.get("frozen_bf16", False) else _resolve_compute_dtype(self.config)

    def _set_tower(self, model: nn.Module, frozen: bool, pt_variables, loader, dtype) -> None:
        """A pretrained tower: trainable as built (``use_from_scratch``), or frozen with
        loaded weights, gradients off and the inference dtype, cast once."""
        if frozen:
            model.load_state_dict(pt_variables if pt_variables is not None else loader())
            model.requires_grad_(False)
            if dtype is not None:
                model.to(dtype)
        self.pt_model = model
        self._pt_frozen = frozen

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        if self.frozen_qpack is not None:  # the pack follows the module's device (never its dtype)
            self.frozen_qpack = tree_to(self.frozen_qpack, self._anchor.device)
        return out

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _skip_in_trained_state(self, name: str, value) -> bool:
        return (self._pt_frozen and name.startswith("pt_model.")) or isinstance(value, UninitializedParameter)

    def trained_state_dict(self) -> dict:
        """The policy's own state: everything but a frozen tower (and lazy layers never run)."""
        return {k: v for k, v in self.state_dict().items() if not self._skip_in_trained_state(k, v)}

    def load_trained_state_dict(self, state: dict) -> None:
        """Load what :meth:`trained_state_dict` gave; a name that does not fit raises."""
        result = self.load_state_dict(state, strict=False)
        own = dict(self.state_dict())
        missing = [k for k in result.missing_keys if not self._skip_in_trained_state(k, own[k])]
        if missing or result.unexpected_keys:
            raise RuntimeError(f"policy state does not fit: missing {missing}, unexpected {result.unexpected_keys}")

    def clone_sharing_frozen(self) -> "BasePolicy":
        """A copy with its own trained parameters that shares the frozen tower and the int8 pack."""
        memo = {}
        if self._pt_frozen:
            memo[id(self.pt_model)] = self.pt_model
        if self.frozen_qpack is not None:
            memo[id(self.frozen_qpack)] = self.frozen_qpack
        return copy.deepcopy(self, memo)

    # -- helpers --------------------------------------------------------------

    def _t(self, x, dtype=None) -> torch.Tensor:
        return _as_tensor(x).to(self.device, dtype)

    def _stack(self, tree, dtype=None) -> torch.Tensor:
        # views stack in the dict's insertion order
        return torch.stack([self._t(v, dtype) for v in tree.values()])

    def patchify(self, x):
        return m3ae_lib.extract_patches(x, self.patch_dim)

    def _apply_adapter(self, *embs):
        """Gated adapter on one or more same-width embeddings; several share ONE adapter module."""
        if not hasattr(self, "AdapterMLP_0"):
            width = embs[0].shape[-1]
            self.AdapterMLP_0 = AdapterMLP(width, hidden_dim=width, output_dim=width, num_layers=2).to(self.device)
        res = torch.sigmoid(self.residual_weight)
        out = tuple(res * self.AdapterMLP_0(e) + (1 - res) * e for e in embs)
        return out[0] if len(out) == 1 else out

    def _frozen_clip_apply(self, method, x):
        """Run the frozen CLIP tower in its dtype (cast at construction): float inputs are cast
        to it, float32 comes back out."""
        dt = self._clip_dtype()
        if dt is not None and x.is_floating_point():
            x = x.to(dt)
        with torch.no_grad():
            out = method(x)
        return out.float() if dt is not None else out

    @staticmethod
    def _frozen_out(emb):
        """Frozen-encoder outputs re-widen to float32 for the trained policy."""
        return emb.float()

    def _frozen_fast_int8(self) -> bool:
        """True when the frozen m3ae/mae tower runs the packed int8 path."""
        cfg = self.config
        return bool(cfg.get("frozen_int8", False) and not cfg.use_from_scratch
                    and cfg.transfer_type.startswith(("mae", "m3ae")))

    def _qpack(self):
        assert self.frozen_qpack is not None, (
            "config.frozen_int8 needs a calibrated pack: construct the policy "
            "with frozen_qpack=build_frozen_qpack(config, sample_batch, patch_dim)"
        )
        return self.frozen_qpack

    def _fast_score_dtype(self):
        sub = self.config.m3ae if self.config.transfer_type.startswith("m3ae") else self.config.mae
        return resolve_compute_dtype(sub.get("score_dtype", "float32")) or torch.float32

    def _int8_attn(self) -> bool:
        return str(self.config.get("frozen_int8_attn", "false")).lower() in ("true", "1")

    def _fast_encode(self, patch, num_heads, **kwargs):
        from ...ops import m3ae_infer

        with torch.no_grad():
            return m3ae_infer.m3ae_encode_int8(self._qpack(), patch, num_heads, score_dtype=self._fast_score_dtype(),
                                               int8_attn=self._int8_attn(), **kwargs)

    def _frozen_tower(self, method, *args, **kwargs):
        with torch.no_grad():
            return method(*args, deterministic=True, **kwargs)

    # -- the frozen tower, frame by frame ----------------------------------------------------

    def _window_rings(self, batch, views, text=None, text_padding_mask=None):
        """The rings of a rollout's window cache (``batch["tower_cache"]``, one a view: envs/rollout.py::TowerRing)
        for a frozen tower whose output for a frame depends on that frame alone, and on ``text`` where every
        row carries the same instruction; None, which sends every frame through the tower, otherwise.  A ring
        another policy filled, or filled with another instruction, starts empty."""
        cache = batch.get("tower_cache")
        if cache is None or set(cache) != set(views):
            return None
        fixed = None
        if text is not None:
            fixed = (text[:1], text_padding_mask[:1])
            if not bool(((text == fixed[0]).all() & (text_padding_mask == fixed[1]).all()).item()):
                return None
        rings = [cache[v] for v in views]
        for ring in rings:
            ring.keep_if(self, fixed)
        return rings

    def _frozen_frames(self, image, encode, rings=None):
        """The frozen tower's outputs for the frames ``image`` (V, B, T, H, W, C), as ``encode`` gives them for
        all V * B * T frames: ``encode`` takes (M, H, W, C) frames to (L * M, ...) rows, layer-major.  With
        ``rings`` (:meth:`_window_rings`) only the newest slots the rings lack go through ``encode``; the
        other slots' outputs come back from the rings."""
        num_image, batch_size, num_timestep = image.shape[:3]
        frames = num_image * batch_size
        k = num_timestep if rings is None else max(ring.missing(num_timestep) for ring in rings)
        encoded, reused = frames * k, frames * (num_timestep - k)
        with span("policy.tower") as s:
            if s:
                s.set(encoded=encoded, reused=reused)
            out = encode(image[:, :, num_timestep - k:].reshape(-1, *image.shape[-3:])) if k else None
            if rings is not None:
                if k:
                    out = out.reshape(-1, num_image, batch_size, k, *out.shape[1:])  # (L, V, B, k, ...)
                held = torch.stack([ring.fill(None if out is None else out[:, v].movedim(0, 2), num_timestep)
                                    for v, ring in enumerate(rings)])
                out = held.movedim(3, 0).reshape(-1, *held.shape[4:])  # (V, B, T, L, ...) back to layer-major rows
        self.tower_frames_encoded += encoded
        self.tower_frames_reused += reused
        return out

    def _clip_input(self, image):
        if self.resize_clip_input and image.shape[1] != 224:
            from ...ops.augment import resize_image

            image = resize_image(image, 224, 224, "bicubic")
        return image

    def _frozen_mae(self, frames):
        patch = self.patchify(frames)
        if self._frozen_fast_int8():
            return self._fast_encode(patch, self.config.mae.num_heads)
        return self._frozen_out(self._frozen_tower(self.pt_model.forward_representation, patch))

    @staticmethod
    def _tile_instruction(text, text_padding_mask, rows: int):
        """The batch's instruction rows repeated over ``rows`` frames (None without one)."""
        if text is None:
            return None, None
        reps = rows // text.shape[0]
        return text.repeat(reps, 1), text_padding_mask.repeat(reps, 1)

    def _frozen_m3ae(self, frames, text, text_padding_mask):
        """The frozen M3AE tower on frames (M, H, W, C) with the batch's instruction: (L * M, N, D) rows,
        layer-major, L the tower's depth with ``use_intermediate``, else 1."""
        cfg = self.config
        patch = self.patchify(frames)
        tokenized_caption, tiled_pad = self._tile_instruction(text, text_padding_mask, patch.shape[0])
        if self._frozen_fast_int8():
            kw = dict(text_ids=tokenized_caption, text_padding_mask=tiled_pad)
            if cfg.use_intermediate:
                out, inter = self._fast_encode(patch, cfg.m3ae.num_heads, return_intermediates=True, **kw)
                # (L-1, B', N, D) block outputs flatten along the batch: the layout
                # the module path's concat of intermediates builds
                inter = self._frozen_out(inter[:-1].reshape(-1, *inter.shape[2:]))
                return torch.cat([inter, out], dim=0)
            return self._fast_encode(patch, cfg.m3ae.num_heads, **kw)
        if cfg.use_intermediate:
            out, states = self._frozen_tower(self.pt_model.forward_representation, patch, tokenized_caption,
                                             tiled_pad, return_intermediates=True)
            intermediate_embs = [self._frozen_out(s) for s in states[: cfg.m3ae.depth - 1]]
            return torch.cat(intermediate_embs + [self._frozen_out(out)], dim=0)
        return self._frozen_out(self._frozen_tower(self.pt_model.forward_representation, patch, tokenized_caption,
                                                   tiled_pad))

    def _frozen_m3ae_joint(self, frames, goal_patch):
        """The frozen M3AE tower's joint (obs, goal) encode of GCBC: frame i with goal patches i."""
        patch = self.patchify(frames)
        if self._frozen_fast_int8():
            return self._fast_encode(patch, self.config.m3ae.num_heads, goal_patch=goal_patch)
        return self._frozen_out(self._frozen_tower(self.pt_model.forward_gc_representations, patch, goal_patch))

    # -- encode ---------------------------------------------------------------

    def encode(self, batch):
        cfg = self.config
        # ARPDT gates text on use_text; BC/GCBC read whatever instruct the batch carries
        text = batch.get("instruct", None) if (cfg.use_text or not self.use_rtg) else None
        if text is not None:
            text = self._t(text, torch.long)

        if cfg.transfer_type.endswith("_cached"):
            image_batch = batch["image_emb"]
            num_image, batch_size, num_timestep = self._stack(image_batch).shape[:3]
            image = None
        else:
            image_batch = batch["image"]
            image = self._stack(image_batch, torch.float32)
            num_image, batch_size, num_timestep = image.shape[:3]

        state_batch = batch.get("state", None)
        state_emb = self.state_input(self._t(state_batch, torch.float32)) if state_batch is not None else None

        if cfg.use_discrete_action:
            action_emb = self.action_input(self._t(batch["action"], torch.long))
        else:
            action_emb = self.action_input(self._t(batch["action"], torch.float32))

        rtg_emb = None
        if self.use_rtg:
            rtg = self._stack(batch["rtg"], torch.float32)
            if cfg.use_symlog:
                rtg = symlog(rtg)
            rtg_emb = self.rtg_input(rtg.mean(dim=0))  # average rewards over views

        text_padding_mask = batch.get("text_padding_mask", None)
        if text_padding_mask is not None:
            text_padding_mask = self._t(text_padding_mask, torch.float32)
        transfer_type = cfg.transfer_type

        def concat_multiple_image_emb(img_emb):
            img_emb = img_emb.reshape(batch_size * num_image, num_timestep, -1)
            return torch.cat(img_emb.chunk(num_image, dim=0), dim=-1)

        def project(image_text_emb):
            image_text_emb = torch.tanh(self.image_text_input(image_text_emb))
            return image_text_emb + get_1d_sincos_pos_embed(image_text_emb.shape[-1], num_timestep, self.device)

        if transfer_type.endswith("_cached"):
            # (num_image, B, T, D) precomputed embeddings -> the live clip path's downstream flow
            emb = self._stack(batch["image_emb"], torch.float32)
            img_emb = emb.reshape(-1, emb.shape[-1])
            goal_emb = None
            if self.use_goal:
                assert batch.get("goal_emb") is not None, (
                    f"GCBC with {transfer_type} needs cached goal embeddings (goal_emb in the batch)"
                )
                gemb = self._stack(batch["goal_emb"], torch.float32)
                goal_emb = gemb.reshape(-1, gemb.shape[-1])
            if cfg.use_adapter:
                # one shared adapter transforms obs AND goal embeddings: one embedding space
                if goal_emb is not None:
                    img_emb, goal_emb = self._apply_adapter(img_emb, goal_emb)
                else:
                    img_emb = self._apply_adapter(img_emb)
            img_emb = concat_multiple_image_emb(img_emb)
            if goal_emb is not None:
                img_emb = torch.cat([img_emb, concat_multiple_image_emb(goal_emb)], dim=-1)
            if cfg.use_text and transfer_type.startswith("clip") and text is not None:
                if cfg.use_from_scratch:
                    text_emb = self.pt_model.encode_text(text)
                else:
                    text_emb = self._frozen_clip_apply(self.pt_model.encode_text, text)
                text_emb = text_emb[:, None, :].repeat(1, img_emb.shape[1], 1)
                image_text_emb = torch.cat([img_emb, text_emb], dim=-1)
            else:
                image_text_emb = img_emb
            return 1, project(image_text_emb), action_emb, state_emb, rtg_emb

        if transfer_type == "none":
            image = torch.cat([self._t(v, torch.float32) for v in image_batch.values()], dim=-1)
            image = image.reshape(-1, *image.shape[-3:])
            patch = self.patch_emb(self.patchify(image))
            num_obs_token = patch.shape[1]
            patch = patch + get_2d_sincos_pos_embed(patch.shape[-1], num_obs_token, self.device)
            patch = patch.reshape(batch_size, num_timestep, -1)
            patch = patch + get_1d_sincos_pos_embed(patch.shape[-1], num_timestep, self.device)
            return num_obs_token, patch, action_emb, state_emb, rtg_emb

        if transfer_type.startswith("clip"):
            if cfg.use_impala_backbone:
                img_emb = self.impala(self._clip_input(image.reshape(-1, *image.shape[-3:])))
            elif cfg.use_from_scratch:
                img_emb = self.pt_model.encode_image(self._clip_input(image.reshape(-1, *image.shape[-3:])))
            else:
                img_emb = self._frozen_frames(
                    image, lambda frames: self._frozen_clip_apply(self.pt_model.encode_image, self._clip_input(frames)),
                    self._window_rings(batch, image_batch))

            if cfg.use_adapter:
                img_emb = self._apply_adapter(img_emb.detach())
            img_emb = concat_multiple_image_emb(img_emb)

            if text is not None:
                if cfg.use_from_scratch or cfg.use_impala_backbone:
                    text_emb = self.pt_model.encode_text(text)
                else:
                    text_emb = self._frozen_clip_apply(self.pt_model.encode_text, text)
                text_emb = text_emb[:, None, :].repeat(1, img_emb.shape[1], 1)
                if cfg.use_adapter:
                    text_emb = text_emb.detach()
                image_text_emb = torch.cat([img_emb, text_emb], dim=-1)
            else:
                image_text_emb = img_emb

            if not cfg.use_from_scratch and not cfg.use_impala_backbone and not cfg.use_adapter:
                image_text_emb = image_text_emb.detach()
            return 1, project(image_text_emb), action_emb, state_emb, rtg_emb

        if transfer_type.startswith("mae"):
            if cfg.use_from_scratch:
                patch = self.patchify(image.reshape(-1, *image.shape[-3:]))
                image_text_emb = self.pt_model.forward_representation(patch, deterministic=True)
            else:
                image_text_emb = self._frozen_frames(image, self._frozen_mae, self._window_rings(batch, image_batch))
            image_text_emb = image_text_emb.detach()
            if cfg.use_adapter:
                image_text_emb = self._apply_adapter(image_text_emb)
            image_text_emb = concat_multiple_image_emb(image_text_emb)
            return 1, project(image_text_emb), action_emb, state_emb, rtg_emb

        if transfer_type.startswith("m3ae"):
            num_layers = 1
            if self.use_goal:
                goal_image = self._stack(batch["goal"], torch.float32)
                goal_patch = self.patchify(goal_image.reshape(-1, *goal_image.shape[-3:]))
                if cfg.use_from_scratch:
                    image_text_emb = self.pt_model.forward_gc_representations(
                        self.patchify(image.reshape(-1, *image.shape[-3:])), goal_patch, deterministic=True)
                else:
                    # the joint (obs, goal) encode pairs each frame with its row's goal: never from a window cache
                    image_text_emb = self._frozen_frames(
                        image, lambda frames: self._frozen_m3ae_joint(frames, goal_patch)).detach()
            elif cfg.use_from_scratch:
                patch = self.patchify(image.reshape(-1, *image.shape[-3:]))
                tokenized_caption, tiled_pad = self._tile_instruction(text, text_padding_mask, patch.shape[0])
                image_text_emb = self.pt_model.forward_representation(
                    patch, tokenized_caption, tiled_pad, deterministic=True).detach()
            else:
                if cfg.use_intermediate:
                    num_layers = cfg.m3ae.depth
                image_text_emb = self._frozen_frames(
                    image, lambda frames: self._frozen_m3ae(frames, text, text_padding_mask),
                    self._window_rings(batch, image_batch, text, text_padding_mask)).detach()

            if cfg.use_adapter:
                image_text_emb = self._apply_adapter(image_text_emb)

            image_text_emb = image_text_emb.reshape(batch_size * num_image * num_layers, num_timestep, -1)
            image_text_emb = torch.cat(image_text_emb.chunk(num_layers, dim=0), dim=-1)
            image_text_emb = torch.tanh(self.image_text_input(image_text_emb))
            image_text_emb = torch.cat(image_text_emb.chunk(num_image, dim=0), dim=-1)
            return num_image, image_text_emb, action_emb, state_emb, rtg_emb

        raise ValueError("Unsupported transfer type!")

    # -- forward --------------------------------------------------------------

    def forward(self, batch, deterministic: bool = False, generator: Optional[torch.Generator] = None):
        """``generator``: where the policy blocks' dropout draws its masks when not ``deterministic``."""
        cfg = self.config
        batch_size, num_timestep = np.shape(batch["action"])[:2]

        num_obs_token, image_embed, action_emb, state_emb, rtg_emb = self.encode(batch)

        parts = [image_embed]
        extra = 1  # action
        if state_emb is not None:
            parts.append(state_emb)
            extra += 1
        if rtg_emb is not None:
            parts.append(rtg_emb)
            extra += 1
        parts.append(action_emb)
        token_embed = torch.cat(parts, dim=-1)
        num_token_per_step = num_obs_token + extra
        token_embed = token_embed.reshape(batch_size, num_token_per_step * num_timestep, cfg.emb_dim)

        if cfg.model_type is not None and cfg.model_type.startswith("vit"):
            mask_spec = MaskSpec("dt", num_obs_token=num_obs_token, num_token_per_step=num_token_per_step)
        else:
            mask_spec = MaskSpec("causal")

        output_embed = self.policy(token_embed, deterministic=deterministic, mask_spec=mask_spec, generator=generator)

        # the token whose output predicts the action: the last one *before* the action slot
        action_pos = num_obs_token + extra - 2
        action_pred = self.action_outputs(output_embed[:, action_pos::num_token_per_step, :])

        output = {"action_pred": action_pred}
        if self.use_rtg:
            return_pos = action_pos - 1
            return_pred = self.return_outputs(output_embed[:, return_pos::num_token_per_step, :])
            output["return_pred"] = return_pred
            loss, acc, info = self._compute_loss_rtg(action_pred, batch["action"], return_pred, batch["rtg"])
            output.update(loss=loss, acc=acc, trans_loss=info["trans_loss"], return_loss=info["return_loss"])
        else:
            loss, acc = self._compute_loss(action_pred, batch["action"])
            output.update(loss=loss, acc=acc)
        self.needs_first_forward = False
        return output

    def _compute_loss(self, action_pred, action):
        if not self.config.use_discrete_action:
            if self.normalize_quterion:
                # [:, 3:7] slices the TIME axis of a (B, T, A) tensor, as the reference does
                x = action_pred[:, 3:7]
                x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                action_pred = torch.cat([action_pred[:, :3], x, action_pred[:, 7:]], dim=1)
            return mse_loss(action_pred, self._t(action, torch.float32)), torch.zeros((), device=self.device)
        return cross_entropy(action_pred, self._t(action, torch.long), self.num_actions)

    def _compute_loss_rtg(self, action_pred, action, rtg_pred, rtg):
        loss, acc = self._compute_loss(action_pred, action)
        info = {"trans_loss": loss, "return_loss": torch.zeros((), device=self.device)}
        if rtg_pred is not None and rtg is not None:
            rtg = self._stack(rtg, torch.float32)
            if self.config.use_symlog:
                rtg = symlog(rtg)
            return_loss = mse_loss(rtg_pred, rtg.mean(dim=0))
            loss = loss + self.config.lambda_return_pred * return_loss
            info["return_loss"] = return_loss
        return loss, acc, info

    def greedy_action(self, batch):
        pred = self(batch, deterministic=True)["action_pred"][:, -1, :]
        if not self.config.use_discrete_action:
            return pred
        return pred.argmax(-1)

    def greedy_return(self, batch):
        # symexp applied unconditionally, as the reference does even when use_symlog is off
        return symexp(self(batch, deterministic=True)["return_pred"])

    def sample_action(self, batch, generator: torch.Generator, temperature: float = 1.0):
        """Seeded temperature sampling over the action logits.

        temperature -> 0 recovers greedy; the generator is the caller's (on the
        module's device), so evaluations stay reproducible.
        """
        pred = self(batch, deterministic=True)["action_pred"][:, -1, :]
        if not self.config.use_discrete_action:
            return pred
        probs = torch.softmax(pred / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


class ARPDT(BasePolicy):
    """Return-conditioned policy with CLIP rewards."""

    use_rtg = True
    use_goal = False
    resize_clip_input = False


class BC(BasePolicy):
    """Behavior cloning / InstructRL-with-text baseline."""

    use_rtg = False
    use_goal = False
    resize_clip_input = True


class GCBC(BasePolicy):
    """Goal-conditioned BC with joint (obs, goal) encoding."""

    use_rtg = False
    use_goal = True
    resize_clip_input = True


def _load_clip_model_vars(model_name: str, checkpoint_path: Optional[str] = None) -> dict:
    """A CLIP tower's state dict from a local OpenAI checkpoint, as the JAX package reads it.

    ``checkpoint_path`` is the OpenAI state dict as ``.npy`` or the ``.pt`` jit archive; without
    one, ``$ARP_TPU_CHECKPOINT_DIR/{model_name}.npy`` (models/clip/model.py::load_model_vars), then
    the weight bridge.  A ``.pt`` that ``torch.jit.load`` cannot open is read as the port's own
    ``torch.save``d state dict of :class:`arp_tpu_torch.models.clip.CLIP`.
    """
    from ..clip.convert import flax_to_torch

    try:
        variables = clip_lib.load_model_vars(model_name, checkpoint_path=checkpoint_path)
    except RuntimeError:  # torch.jit.load refused the .pt: the port's own state dict
        if not (checkpoint_path or "").endswith(".pt"):
            raise
        return torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    return flax_to_torch(variables)


def build_frozen_qpack(config_updates, sample_batch, patch_dim: int, image_size: int = 256, use_goal: bool = False,
                       m3ae_loader=None, amax=None, return_amax: bool = False, device="cuda"):
    """Calibrate the int8 pack for a frozen_int8 policy from REAL frames.

    ``sample_batch`` is one host batch in the trainer's layout (``image``:
    {key: (B, T, H, W, C)}, optional ``instruct`` / ``text_padding_mask`` /
    ``goal``).  Frames go through the deterministic eval transform (resize +
    the Procgen normalization), so the calibration sees the activation
    distribution the in-step encode sees.  Returns the pack to pass as the
    policy's ``frozen_qpack``, on ``device``: the loader's state dict is moved
    there, and packing, the eval transform and the calibration forward run
    there (the card unless the caller asks for the CPU).

    ``amax``: previously saved calibration scales; skips calibration, so a
    restored checkpoint sees the frozen-tower numbers it trained with.
    ``return_amax=True`` also returns the amax tree (on the CPU) for persisting.
    """
    from ...device import resolve_device
    from ...ops import m3ae_infer
    from ...ops.augment import make_eval_transform

    device = resolve_device(device)
    cfg = get_policy_default_config(config_updates)
    tt = cfg.transfer_type
    assert cfg.frozen_int8, "build_frozen_qpack is only for frozen_int8 configs"
    assert tt.startswith(("mae", "m3ae")) and not tt.endswith("_cached"), tt
    sub = cfg.m3ae if tt.startswith("m3ae") else cfg.mae
    loader = m3ae_loader or m3ae_lib.load_m3ae_model_vars
    variables = {k: v.to(device) for k, v in loader(tt.split("_", 1)[1]).items()}

    if amax is not None:
        packed = m3ae_infer.pack_m3ae_params(variables, sub.depth)
        qpack = m3ae_infer.quantize_m3ae_packed(packed, amax)
        return (qpack, amax) if return_amax else qpack

    transform = make_eval_transform(image_size=image_size, device=device)

    def to_patches(tree):
        frames = torch.cat([_as_tensor(v).reshape(-1, *np.shape(v)[-3:]) for v in tree.values()], dim=0)
        return m3ae_lib.extract_patches(transform(frames), patch_dim)

    patch = to_patches(sample_batch["image"])
    text_ids = pad = goal = None
    if use_goal and sample_batch.get("goal") is not None:
        goal = to_patches(sample_batch["goal"])
        n = min(patch.shape[0], goal.shape[0])  # the goal-joint encode pairs each obs frame with a goal frame
        patch, goal = patch[:n], goal[:n]
    elif cfg.use_text and tt.startswith("m3ae") and sample_batch.get("instruct") is not None:
        ids = _as_tensor(sample_batch["instruct"]).to(device, torch.long)
        pm = _as_tensor(sample_batch["text_padding_mask"]).to(device, torch.float32)
        reps = -(-patch.shape[0] // ids.shape[0])  # cover every patch row
        text_ids = ids.repeat(reps, 1)[: patch.shape[0]]
        pad = pm.repeat(reps, 1)[: patch.shape[0]]
    return m3ae_infer.build_m3ae_qpack(
        variables, sub.depth, sub.num_heads, patch, text_ids=text_ids, text_padding_mask=pad, goal_patch=goal,
        return_amax=return_amax,
    )
