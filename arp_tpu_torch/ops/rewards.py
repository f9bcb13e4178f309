"""Reward post-processing: discounted cumulative sums and frame re-stacking.

A copy of arp_tpu/ops/rewards.py (host numpy), so the port imports no JAX.

Vectorized replacements for the reference's python loops
(label_reward.py:232-254, data_procgen.py:132-174).
"""

from __future__ import annotations

import numpy as np


def discount_cumsum(x: np.ndarray, gamma: float = 1.0) -> np.ndarray:
    """Reverse discounted cumsum along axis 0 (vectorized for gamma == 1)."""
    x = np.asarray(x)
    if x.ndim == 0:
        x = x[None]
    if gamma == 1.0:
        return np.cumsum(x[::-1], axis=0)[::-1].astype(x.dtype)
    out = np.zeros_like(x)
    out[-1] = x[-1]
    for t in range(x.shape[0] - 2, -1, -1):
        out[t] = x[t] + gamma * out[t + 1]
    return out


def stack_frames(values: np.ndarray, num_frames: int) -> np.ndarray:
    """Frame-stack a per-step sequence: row t = [v_{t-F+1} .. v_t].

    The first row is back-filled with v_0 (reference semantics: the deque is
    pre-extended with F copies of the first value, label_reward.py:232-245).
    Output shape: (T, num_frames) (+ trailing dims of ``values``).
    """
    values = np.asarray(values)
    if values.ndim == 0:
        values = values[None]
    T = values.shape[0]
    # index matrix: row t, slot f -> clip(t - (F-1) + f, 0, ...)
    idx = np.arange(T)[:, None] - (num_frames - 1) + np.arange(num_frames)[None, :]
    idx = np.clip(idx, 0, T - 1)
    return values[idx]
