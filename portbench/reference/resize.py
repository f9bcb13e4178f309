"""Pillow's bicubic resize of uint8 frames, in its fixed-point arithmetic (precision 22 bits, support 2).

The two passes run as float64 matrix products: every value is an integer below 2**53, so
each product and sum is exact and the result is Pillow's byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISION_BITS = 22


def _cubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def pil_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point coefficients of one pass (Pillow's precompute_coeffs and
    normalize_coeffs_8bpc)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    m = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = np.array([_cubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax - xmin)])
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = np.where(w < 0, (-0.5 + w * (1 << PRECISION_BITS)).astype(np.int64),
                         (0.5 + w * (1 << PRECISION_BITS)).astype(np.int64))
        m[xx, xmin:xmax] = fixed
    return m


def resize(frames: torch.Tensor, out: int) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, out, out, C) uint8, as Pillow's ``Image.resize(..., BICUBIC)``: the
    horizontal pass first, each pass rounded and clipped to a byte."""
    b, h, w, c = frames.shape
    dev = frames.device
    mw = torch.from_numpy(pil_matrix(w, out).astype(np.float64)).to(dev)
    mh = torch.from_numpy(pil_matrix(h, out).astype(np.float64)).to(dev)
    half = float(1 << (PRECISION_BITS - 1))
    shift = float(1 << PRECISION_BITS)

    def rnd(acc):
        return torch.clamp(torch.floor((acc + half) / shift), 0, 255)

    x = frames.to(torch.float64)
    x = rnd(torch.einsum("ow,bhwc->bhoc", mw, x))  # (B, H, out, C)
    x = rnd(torch.einsum("oh,bhwc->bowc", mh, x))  # (B, out, out, C)
    return x.to(torch.uint8)
