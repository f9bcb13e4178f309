"""Weights and inputs made on the device from ``--seed``, with a ``torch.Generator`` on the card and in a few
large calls: one normal draw for all of a module's parameters, sliced into each."""

from __future__ import annotations

import math

import torch

# the 1-d parameters that are scales (LayerNorm weights): 1 + N(0, 0.02); other 1-d ones are shifts: N(0, 0.02)
_SCALE_SUFFIXES = ("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight", "ln_final.weight",
                   "norm.weight", "norm1.weight", "norm2.weight", "scale")
_EMBEDDING_SUFFIXES = ("token_embedding.weight", "text_embedding.weight", "positional_embedding", "type_embedding",
                       "cls_token")


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one purpose of one seed (``stream`` keeps the purposes apart)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))


def _std(name: str, p: torch.Tensor) -> tuple[float, float]:
    """(std, mean) of a parameter's draw."""
    if p.ndim == 0:
        return 0.0, math.log(100.0)  # CLIP's trained logit scale: exp() = 100
    if name.endswith("residual_weight"):
        return 0.5, 4.0  # the adapter's gate, sigmoid() near its initial 0.98
    if name.endswith("bias"):
        return 0.02, 0.0
    if p.ndim == 1:
        if name.endswith(_SCALE_SUFFIXES):
            return 0.02, 1.0
        if "class_embedding" in name:
            return p.shape[0] ** -0.5, 0.0
        return 0.02, 0.0
    if name.endswith(_EMBEDDING_SUFFIXES):
        return 0.02, 0.0
    if name.endswith("kernel"):
        return p.shape[-2] ** -0.5, 0.0  # Flax's (in, out) layout: N(0, 1 / fan_in)
    return p.shape[-1] ** -0.5, 0.0  # a Linear's (out, in) weight: N(0, 1 / fan_in)


@torch.no_grad()
def fill(named_tensors, seed: int, device, stream: int = 0) -> dict:
    """Overwrite each (name, tensor) in place from one draw on ``device``; returns {name: a copy}, the
    tensors that the reference is handed."""
    named = [(n, t) for n, t in named_tensors]
    total = sum(t.numel() for _, t in named)
    flat = torch.randn(total, generator=generator(seed, device, stream), device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, t in named:
        std, mean = _std(name, t)
        t.copy_((flat[offset:offset + t.numel()].view(t.shape) * std + mean).to(t.dtype))
        offset += t.numel()
        out[name] = t.detach().clone()
    return out


def uint8_frames(shape, seed: int, device, stream: int) -> torch.Tensor:
    """Frames of uniform bytes, drawn on ``device``."""
    return torch.randint(0, 256, tuple(shape), generator=generator(seed, device, stream), device=device,
                         dtype=torch.uint8)
