"""Lazy attention-mask specifications (port of arp_tpu/ops/masks.py).

A mask is a tiny spec evaluated from index arithmetic: inside kernel K1 per
tile, or as a dense ``(n, n)`` boolean in the plain attention.  Nothing
batch-sized is materialized.

DT mask semantics: the token stream per timestep is
``[obs_0..obs_{K-1}, <non-obs tokens>]`` repeated; position ``i`` may attend
``j`` iff ``j <= i`` (causal) OR (same timestep AND both are obs tokens).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Static description of the attention mask.

    kind:
      * "none"   — full attention
      * "causal" — lower triangular
      * "dt"     — causal OR intra-timestep obs-block (needs num_obs_token /
                   num_token_per_step)
    """

    kind: str = "none"
    num_obs_token: int = 0
    num_token_per_step: int = 0

    def __post_init__(self):
        if self.kind not in ("none", "causal", "dt"):
            raise ValueError(f"unknown mask kind {self.kind!r}")
        if self.kind == "dt" and not (self.num_token_per_step > 0 and self.num_obs_token > 0):
            raise ValueError("the dt mask needs num_obs_token > 0 and num_token_per_step > 0")


def mask_allowed(spec: MaskSpec, q_idx: torch.Tensor, k_idx: torch.Tensor) -> torch.Tensor:
    """Evaluate the mask at integer index tensors (broadcastable). True = attend."""
    if spec.kind == "none":
        shape = torch.broadcast_shapes(q_idx.shape, k_idx.shape)
        return torch.ones(shape, dtype=torch.bool, device=q_idx.device)
    causal = k_idx <= q_idx
    if spec.kind == "causal":
        return causal
    t = spec.num_token_per_step
    same_step = (q_idx // t) == (k_idx // t)
    both_obs = ((q_idx % t) < spec.num_obs_token) & ((k_idx % t) < spec.num_obs_token)
    return causal | (same_step & both_obs)


def materialize_mask(spec: MaskSpec, seq_len: int, device=None) -> torch.Tensor:
    """(seq, seq) boolean mask for the plain attention path."""
    idx = torch.arange(seq_len, device=device)
    return mask_allowed(spec, idx[:, None], idx[None, :])


def combine_padding(mask: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """AND a (batch, kv_len) key-padding mask (nonzero = PAD) into a (.., q, k) mask."""
    if padding_mask is None:
        return mask
    keep = (padding_mask == 0)[:, None, None, :]
    return mask & keep
