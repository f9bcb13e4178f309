"""Image preprocessing for CLIP reward labeling (port of arp_tpu/ops/preprocess.py).

The packed path the engine runs: uint8 frames as (B, H, W*C) go through a
bit-exact re-implementation of Pillow's fixed-point bicubic resize (two
separable passes, each three dense matmuls), then /255 and the per-channel
CLIP normalization, then patchify into ViT patch vectors in
(p_row, p_col, channel) order.

:func:`resize_bicubic_pil_reference` is the plain version of the resize: the
same fixed-point arithmetic in numpy int64, needing no Pillow.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point precision for 8bpc
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bicubic_filter(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int):
    """Pillow precompute_coeffs + normalize_coeffs_8bpc (support=2 bicubic)."""
    support_base = 2.0
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support_base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1

    bounds = np.zeros(out_size, np.int32)
    sizes = np.zeros(out_size, np.int32)
    coeffs = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        # Pillow rounds the window edges: (int)(center - support + 0.5)
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        n = xmax - xmin
        total = 0.0
        for x in range(n):
            w = _bicubic_filter((x + xmin - center + 0.5) * ss)
            coeffs[xx, x] = w
            total += w
        if total != 0.0:
            coeffs[xx, :n] /= total
        bounds[xx] = xmin
        sizes[xx] = n

    # fixed-point conversion (normalize_coeffs_8bpc)
    kk = np.where(
        coeffs < 0,
        (-0.5 + coeffs * (1 << PRECISION_BITS)).astype(np.int64),
        (0.5 + coeffs * (1 << PRECISION_BITS)).astype(np.int64),
    ).astype(np.int32)
    # gather indices clamped into range (zero coeffs beyond `sizes` make the
    # clamped values irrelevant)
    idx = bounds[:, None] + np.arange(ksize)[None, :]
    idx = np.minimum(idx, in_size - 1).astype(np.int32)
    tap_live = np.arange(ksize)[None, :] < sizes[:, None]
    kk = np.where(tap_live, kk, 0)
    return idx, kk


@functools.lru_cache(maxsize=32)
def _pil_matmul_operands(in_size: int, out_size: int, channels: int):
    """Dense resample matrices (in*C, out*C), split into three 8-bit parts.

    The fixed-point coefficients kk (<= 23 bits signed) split exactly as
    ``kk = a * 2^16 + b * 2^8 + c`` with ``a = kk >> 16`` (signed, |a| <= 64)
    and b, c in [0, 255].  Against uint8 pixels every product (<= 255*255)
    and every partial sum of the <= 7 live taps (< 2^19) is an integer below
    2^24, so a float32 matmul of each part is exact in any summation order.
    With ``channels > 1`` the matrix is channel-interleaved, so the resample
    runs directly on packed (..., W*C) arrays.  Returns float32 numpy arrays.
    """
    idx, kk = _pil_coeffs(in_size, out_size)
    M = np.zeros((in_size, out_size), np.int64)
    for o in range(out_size):
        for k in range(idx.shape[1]):
            if kk[o, k] != 0:
                M[idx[o, k], o] += kk[o, k]
    if channels > 1:
        M2 = np.zeros((in_size * channels, out_size * channels), np.int64)
        for c in range(channels):
            M2[c::channels, c::channels] = M
        M = M2
    a = M >> 16  # arithmetic shift: signed high chunk
    b = (M >> 8) & 255
    c = M & 255
    assert (M == a * 65536 + b * 256 + c).all()
    return tuple(m.astype(np.float32) for m in (a, b, c))


@functools.lru_cache(maxsize=32)
def _pil_operands_on(in_size: int, out_size: int, channels: int, device: torch.device):
    """:func:`_pil_matmul_operands` as float32 tensors on ``device``, made once."""
    return tuple(
        torch.from_numpy(m).to(device) for m in _pil_matmul_operands(in_size, out_size, channels)
    )


def _pil_round(acc_a: torch.Tensor, acc_b: torch.Tensor, acc_c: torch.Tensor) -> torch.Tensor:
    """(A*2^16 + B*2^8 + C + 2^21) >> 22 in int32 without overflow.

    C >= 0, so by the floor-division identity the result equals
    ((A << 8) + B + ((C + 2^21) >> 8)) >> 14; every stage stays < 2^31
    (|A| <= 2^17, B <= 2^19, C <= 2^19).
    """
    A = acc_a.to(torch.int32)
    B = acc_b.to(torch.int32)
    C = acc_c.to(torch.int32) + (1 << (PRECISION_BITS - 1))
    out = ((A << 8) + B + (C >> 8)) >> (PRECISION_BITS - 8)
    return torch.clamp(out, 0, 255)


def resize_bicubic_pil_packed(x: torch.Tensor, channels: int, out_h: int, out_w: int) -> torch.Tensor:
    """Bit-exact Pillow bicubic resize on the channel-packed layout.

    x: (B, H, W*C) holding exact uint8 values (any integer or float dtype).
    Returns (B, out_h, out_w*C) float32 holding exact uint8 values.

    Each pass is three float32 matmuls, exact by the 8-bit operand split (see
    :func:`_pil_matmul_operands`).  JAX runs them in bf16 with float32
    accumulation; torch's bf16 matmul returns bf16, which would lose the
    integer partial sums, so they run in float32 here, where TF32 must be off.
    """
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the bit-exact resize needs torch.backends.cuda.matmul.allow_tf32 = False"
        )
    b, h, wc = x.shape
    w = wc // channels
    x = x.to(torch.float32)
    # horizontal: contract the packed W*C axis
    mats = _pil_operands_on(w, out_w, channels, x.device)
    x = _pil_round(*(torch.matmul(x, m) for m in mats)).to(torch.float32)
    # vertical: contract H (axis 1), keep the packed minor axis
    mats = _pil_operands_on(h, out_h, 1, x.device)
    x = _pil_round(*(torch.matmul(m.T, x) for m in mats))
    return x.to(torch.float32)


def clip_preprocess_packed_patches(
    frames_packed: torch.Tensor,
    channels: int = 3,
    image_size: int = 224,
    patch_size: int = 16,
    mean=CLIP_MEAN,
    std=CLIP_STD,
) -> torch.Tensor:
    """uint8 packed frames (B, H, W*C) -> normalized ViT patches (B, N, P*P*C) float32.

    Bit-exact PIL resize, /255 and per-channel normalize (the channel pattern
    tiled along the packed axis), then reassembly into patch vectors in the
    (p_row, p_col, channel) order of the patch-embedding Linear.
    """
    x = frames_packed.to(torch.float32)
    if frames_packed.shape[1] != image_size or frames_packed.shape[2] != image_size * channels:
        x = resize_bicubic_pil_packed(x, channels, image_size, image_size)
    mean_packed = torch.tensor(mean, dtype=torch.float32, device=x.device).repeat(image_size)
    std_packed = torch.tensor(std, dtype=torch.float32, device=x.device).repeat(image_size)
    x = (x / 255.0 - mean_packed) / std_packed
    b = x.shape[0]
    p = patch_size
    n_side = image_size // p
    # (B, n_h, p_row, n_w, p_col*C) -> (B, n_h, n_w, p_row, p_col*C) -> (B, N, P*P*C)
    x = x.reshape(b, n_side, p, n_side, p * channels)
    x = x.permute(0, 1, 3, 2, 4)
    return x.reshape(b, n_side * n_side, p * p * channels)


def resize_bicubic_pil_reference(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Plain version of the resize: Pillow's fixed-point passes in numpy int64.

    images: (B, H, W, C) uint8 -> (B, out_h, out_w, C) uint8.
    """
    images = np.ascontiguousarray(images, dtype=np.uint8)
    b, h, w, c = images.shape
    idx_w, kk_w = _pil_coeffs(w, out_w)
    idx_h, kk_h = _pil_coeffs(h, out_h)
    half = 1 << (PRECISION_BITS - 1)

    def _pass(x, idx, kk):  # x: (B, in, rest) int64 along axis 1
        acc = np.einsum("bokr,ok->bor", x[:, idx], kk.astype(np.int64))
        return np.clip((acc + half) >> PRECISION_BITS, 0, 255)

    x = images.astype(np.int64)
    x = np.swapaxes(x, 1, 2).reshape(b, w, h * c)
    x = _pass(x, idx_w, kk_w)  # (B, outW, H*C)
    x = np.swapaxes(x.reshape(b, out_w, h, c), 1, 2).reshape(b, h, out_w * c)
    x = _pass(x, idx_h, kk_h)  # (B, outH, outW*C)
    return x.reshape(b, out_h, out_w, c).astype(np.uint8)
