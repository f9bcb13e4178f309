"""clip_ft reward engine: labeling with the fine-tuned adapter (port of arp_tpu/finetune/reward.py).

:class:`ClipFtRewardEngine` is a :class:`arp_tpu_torch.reward.engine.ClipRewardEngine`
whose image and text encoders are the multiscale adapter's; the base class's
batching, host stage and reward functions are its own.  As in the JAX engine:

  * frames are resized with the "fast" (antialiased float bicubic) resize,
    ``use_crop`` center-crops them first;
  * the image trunk is the CLIP module (float32, kernel K1 on CUDA), or with
    ``fast_encode`` the packed bf16 trunk of ops/vit_infer.py (K1), or with
    ``fast_int8`` its static-int8 trunk (kernel K2; calibrated on the first
    device batch; int8 attention in plain PyTorch unless ``fast_int8_attn`` is
    False); in each case the per-layer CLS tokens, cut to the text tower's
    depth, go into the one adapter head ``adapt_image_features``;
  * features come back L2-normalized whatever ``normalize`` asks;
  * text rewards are ``exp(CLIP logit_scale) * cos`` of the adapter features.

``mesh`` (parallel/mesh.py::mesh_from_count) is the base class's data parallelism
over local devices: each device holds its replica of the CLIP module, the packed
trunk and the adapter.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from ..checkpoint import (
    latest_step,
    load_best_state,
    load_orbax_item,
    load_pickle,
    load_policy_state,
    params_of,
)
from ..models.clip.model import CLIP, CONFIGS, load_model_vars
from ..reward.engine import ClipRewardEngine, _mesh_devices
from .adapter_model import ClipMultiscaleAdapter
from .convert import flax_adapter_to_torch


def load_adapter_params(path: str) -> dict:
    """The adapter's state dict from ``path``, through the bridge where the file is the JAX package's.

    A directory: the port's fine-tuning CLI's ``best.pt``, else its latest ``step_<n>.pt``; else the
    JAX package's orbax layouts in its order (arp_tpu/finetune/reward.py): ``best/CURRENT`` ->
    ``best/v<n>/state``, the older ``best/state``, the directory itself as a state item (read by
    ``checkpoint.load_orbax_item``, which needs tensorstore).  A file: a pickle the JAX package
    wrote (``{"state": TrainState}`` or ``{"params": <jax arrays>}``), read by
    ``checkpoint.load_pickle`` without jax, flax or cloudpickle."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "best.pt")):
            return load_best_state(path)[0]
        if latest_step(path) is not None:
            return load_policy_state(path)[0]
        best = os.path.join(path, "best")
        candidates = []
        if os.path.exists(os.path.join(best, "CURRENT")):
            with open(os.path.join(best, "CURRENT")) as f:
                candidates.append(os.path.join(best, f.read().strip(), "state"))
        candidates += [os.path.join(best, "state"), path]
        state, _ = load_orbax_item(next(c for c in candidates if os.path.isdir(c)))
        return flax_adapter_to_torch(params_of(state))
    data = load_pickle(path)
    if isinstance(data, dict) and "state" in data:
        data = data["state"]
    params = data.params if hasattr(data, "params") else data["params"]
    return flax_adapter_to_torch(params)


def _adapter_for(state: dict, cfg: dict) -> ClipMultiscaleAdapter:
    """An adapter whose widths fit ``state``: its inverse layer's hidden width and action count."""
    return ClipMultiscaleAdapter(clip_config=cfg, hidden_dim=state["inverse_layer.Dense_0.bias"].numel(),
                                 action_dim=state["inverse_layer.Dense_1.bias"].numel())


class ClipFtRewardEngine(ClipRewardEngine):
    """Reward engine whose encoders are the fine-tuned multiscale adapter.

    Args:
      adapter_params: the adapter's state dict (:func:`load_adapter_params`).
      clip_variables: the frozen CLIP in arp_tpu's Flax layout; None: the model's own weights
        when ``model`` is given, else ``load_model_vars(clip_model_name)``.
      clip_config: the CLIP widths (default ``CONFIGS[clip_model_name]``).
      adapter: a ``ClipMultiscaleAdapter`` to load ``adapter_params`` into (default: one of
        the widths the params have).
      The rest as :class:`ClipRewardEngine`'s; ``device`` the card unless the caller asks
      for the CPU.
    """

    def __init__(self, adapter_params: dict, clip_variables=None, clip_model_name: str = "vit_b16",
                 batch_size: int = 256, use_crop: bool = False, image_size: int = 224, tokenizer=None,
                 adapter: Optional[ClipMultiscaleAdapter] = None, fast_encode: bool = False, fast_int8: bool = False,
                 fast_score_bf16: Optional[bool] = None, fast_int8_attn: Optional[bool] = None,
                 clip_config: Optional[dict] = None, model: Optional[CLIP] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        if mesh is not None:
            device = _mesh_devices(mesh)[0]
        cfg = clip_config or CONFIGS[clip_model_name]
        if model is None:
            model = CLIP(**cfg, image_size=image_size)
            if clip_variables is None:
                clip_variables = load_model_vars(clip_model_name)
        super().__init__(model=model, variables=clip_variables, batch_size=batch_size, resize_mode="fast",
                         use_crop=use_crop, tokenizer=tokenizer, device=device, image_size=image_size)
        self.adapter = adapter or _adapter_for(adapter_params, cfg)
        self.adapter.load_state_dict(adapter_params)
        self.adapter.eval().to(self.device)
        if fast_encode or fast_int8:
            # the packed trunk, on the unpacked "fast" preprocessing (the JAX engine's bf16 pack)
            self._init_packed_trunk(torch.bfloat16, fast_int8, fast_score_bf16, fast_int8_attn)
        trunk = "module;float32" if self._fast is None else f"packed;{self._packed_recipe()}"
        self._recipe = f"torch;clip_ft;{trunk};resize=fast;crop={int(use_crop)}"
        self._init_mesh(mesh)  # after the adapter and the trunk: every replica copies them

    _replicated_modules = ("adapter",)

    @torch.inference_mode()
    def _encode_chunk(self, frames: torch.Tensor, normalize: bool) -> torch.Tensor:
        del normalize  # the adapter's features are normalized either way, as in the JAX engine
        x = self._patches(frames)
        with self._timed_tower():
            if self._fast is None:
                return self.adapter.encode_image(self.model, x)
            final, inter = self._packed_trunk(x, return_intermediates=True)
            inter = inter[: self.adapter.num_clip_layers]  # (L, B, D) in layer order -> (B, L * D)
            return self.adapter.adapt_image_features(inter.transpose(0, 1).reshape(inter.shape[1], -1), final)

    def _text_tower(self, tokens: torch.Tensor) -> torch.Tensor:
        """The adapter's normalized text features, (n_text, D)."""
        return self.adapter.encode_text(self.model, tokens)
