"""Weights of a CLIP ModifiedResNet made on the device from ``--seed``: the parameters and the BatchNorm
statistics (buffers) of the whole CLIP model, from one normal draw sliced into each.

- convolution kernels (out, in, kh, kw): N(0, 1 / (in * kh * kw)), by fan-in;
- BatchNorm scales 1 + N(0, 0.02), shifts N(0, 0.02), running means N(0, 0.02), running variances
  1 + |N(0, 0.02)|, so that no BatchNorm is the identity;
- the attention pool's and the text tower's Linears, LayerNorms and embeddings, and ``logit_scale``, as
  ``weights.fill`` draws them.
"""

from __future__ import annotations

import torch

from .weights import _std, generator


def _draw(name: str, t: torch.Tensor, batch_norms: set, z: torch.Tensor) -> torch.Tensor:
    """The tensor ``name`` from its slice ``z`` of standard normals."""
    module, _, leaf = name.rpartition(".")
    if module in batch_norms:
        if leaf == "running_var":
            return 1.0 + 0.02 * z.abs()
        return 0.02 * z + (1.0 if leaf == "weight" else 0.0)
    if t.ndim == 4:
        return z * (t[0].numel() ** -0.5)
    std, mean = _std(name, t)
    return z * std + mean


@torch.no_grad()
def fill(model: torch.nn.Module, seed: int, device, stream: int = 1) -> dict:
    """Overwrite every parameter and buffer of ``model`` in place from one draw on ``device``; returns
    {name: a copy} of all of them, the state dict that the reference is handed."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    batch_norms = {n.rpartition(".")[0] for n, _ in named if n.endswith(".running_var")}
    total = sum(t.numel() for _, t in named)
    flat = torch.randn(total, generator=generator(seed, device, stream), device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, t in named:
        z = flat[offset:offset + t.numel()].view(t.shape)
        t.copy_(_draw(name, t, batch_norms, z).to(t.dtype))
        offset += t.numel()
        out[name] = t.detach().clone()
    return out
