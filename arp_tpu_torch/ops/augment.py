"""Deterministic image transforms of the policy path (port of arp_tpu/ops/augment.py).

``normalize`` and ``make_eval_transform`` (resize + normalize), and the resize
both lean on: :func:`resize_image`, ``jax.image.resize`` for the "bilinear"
and "bicubic" methods, as two separable weight matrices.  Like JAX's, it
antialiases when it shrinks (the kernel is widened by the scale), its cubic
kernel is Keys' with a = -0.5, and every output sample's weights sum to 1.
(``torch.nn.functional.interpolate`` does neither by default and uses
a = -0.75; the labeler's Pillow-exact resize in ops/preprocess.py is a third
function.)  The weight matrices are computed in numpy float32 in JAX's
operation order, once for each (in, out, method), and kept on the device.

The random augmentations of the trainer are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device

PROCGEN_MEAN = (0.5762, 0.5503, 0.5213)
PROCGEN_STD = (0.3207, 0.3169, 0.3307)


def _triangle_kernel(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, np.float32(0), out)


_KERNELS = {"bilinear": _triangle_kernel, "bicubic": _keys_cubic_kernel}


@functools.lru_cache(maxsize=None)
def resize_weight_matrix(input_size: int, output_size: int, method: str) -> np.ndarray:
    """(input_size, output_size) float32 weights of one resized axis, antialiased when shrinking."""
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = np.maximum(np.float32(inv_scale), np.float32(1.0))
    sample_f = (np.arange(output_size, dtype=np.float32) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x.astype(np.float32)).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = np.logical_and(sample_f >= -0.5, sample_f <= input_size - 0.5)[None, :]
    return np.where(inside, weights, np.float32(0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights_on(input_size: int, output_size: int, method: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weight_matrix(input_size, output_size, method)).to(device)


def resize_image(x: torch.Tensor, height: int, width: int, method: str = "bilinear") -> torch.Tensor:
    """(..., H, W, C) float -> (..., height, width, C), as ``jax.image.resize`` with ``method``.

    An axis that keeps its size is left alone, as in JAX.
    """
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    h, w = x.shape[-3], x.shape[-2]
    if h != height:
        x = torch.einsum("...hwc,hH->...Hwc", x, _weights_on(h, height, method, x.device).to(x.dtype))
    if w != width:
        x = torch.einsum("...hwc,wW->...hWc", x, _weights_on(w, width, method, x.device).to(x.dtype))
    return x


def normalize(img: torch.Tensor, mean=PROCGEN_MEAN, std=PROCGEN_STD) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def make_eval_transform(image_size: int = 224, mean=PROCGEN_MEAN, std=PROCGEN_STD, device="cuda"):
    """Deterministic eval transform: bilinear resize + normalize.

    Returns ``transform(images)``: (H, W, C) or (B, H, W, C) uint8 or float,
    numpy or tensor -> float32 tensor on ``device`` (the card unless the caller
    asks for the CPU), where the resize and the normalization run.
    """
    device = resolve_device(device)

    def transform(images):
        x = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        x = resize_image(x, image_size, image_size, "bilinear")
        x = normalize(x / 255.0, mean, std)
        return x[0] if squeeze else x

    return transform
