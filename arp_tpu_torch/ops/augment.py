"""Image transforms of the policy path (port of arp_tpu/ops/augment.py).

Deterministic: ``normalize`` and ``make_eval_transform`` (resize + normalize),
and the resize both lean on: :func:`resize_image`, ``jax.image.resize`` for
the "bilinear" and "bicubic" methods, as two separable weight matrices.  Like
JAX's, it antialiases when it shrinks (the kernel is widened by the scale),
its cubic kernel is Keys' with a = -0.5, and every output sample's weights sum
to 1.  (``torch.nn.functional.interpolate`` does neither by default and uses
a = -0.75; the labeler's Pillow-exact resize in ops/preprocess.py is a third
function.)  The weight matrices are computed in numpy float32 in JAX's
operation order, once for each (in, out, method), and kept on the device.

Random: the trainer's augmentations (``random_crop``, ``color_jitter``,
``rotate``, composed by :func:`make_augment_fn`) and ``mixup_cutmix``.  JAX
draws inside each op from a folded key; torch's streams are other streams, so
each op here is split in two: ``draw_*`` takes its parameters (offsets,
factors, angles) from the caller's ``torch.Generator``, one set an image, and
``apply_*`` applies given parameters to the whole batch at once.  The parity
tests draw the parameters with JAX's own key splits and check the apply.
Batched: the crop-and-resize of every image is one product with per-image
bilinear matrices (the crop offset folded into the resize weights), the
rotation one gather, the color jitter per-image factors and 3 x 3 matrices.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from .quantization import true_divide

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


# -- random augmentations ---------------------------------------------------------------------------

_TO_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
_GRAY = (0.299, 0.587, 0.114)
JITTER = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.5)  # color_jitter's defaults, as in JAX
MAX_ANGLE_DEG = 30.0


def _uniform(n: int, low: float, high: float, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=generator.device) * (high - low) + low


def draw_crop(n: int, size: int, crop: int, generator: torch.Generator) -> dict:
    """Top-left corners of a ``crop``-sided square in a ``size``-sided image, one an image."""
    y0 = torch.randint(0, size - crop + 1, (n,), generator=generator, device=generator.device)
    x0 = torch.randint(0, size - crop + 1, (n,), generator=generator, device=generator.device)
    return {"y0": y0, "x0": x0}


def _crop_resize_weights(offsets: torch.Tensor, size: int, crop: int, device) -> torch.Tensor:
    """(n, size, size): per image, rows offset .. offset + crop - 1 hold the bilinear weights
    of resizing ``crop`` samples back to ``size``, every other row is 0."""
    base = _weights_on(crop, size, "bilinear", torch.device(device))  # (crop, size)
    rows = torch.arange(size, device=device)[None, :] - offsets.to(device)[:, None]
    inside = (rows >= 0) & (rows < crop)
    return base[rows.clamp(0, crop - 1)] * inside[..., None].to(base.dtype)


def apply_crop(x: torch.Tensor, params: dict, crop: int) -> torch.Tensor:
    """``random_crop`` of JAX on (n, H, W, C) float: each image's crop, resized back to (H, W)."""
    n, h, w, _ = x.shape
    wy = _crop_resize_weights(params["y0"], h, crop, x.device).to(x.dtype)
    wx = _crop_resize_weights(params["x0"], w, crop, x.device).to(x.dtype)
    x = torch.einsum("nhwc,nhH->nHwc", x, wy)
    return torch.einsum("nhwc,nwW->nhWc", x, wx)


def draw_color_jitter(n: int, generator: torch.Generator, brightness=0.4, contrast=0.4, saturation=0.4,
                      hue=0.5) -> dict:
    """Per image: the brightness, contrast and saturation factors and the hue value (turns of pi)."""
    out = {}
    for name, amount in (("brightness", brightness), ("contrast", contrast), ("saturation", saturation)):
        if amount > 0:
            out[name] = _uniform(n, max(0.0, 1 - amount), 1 + amount, generator)
    if hue > 0:
        out["hue"] = _uniform(n, -hue, hue, generator)
    return out


def _cos_sin(theta: torch.Tensor):
    """cos and sin of float32 angles, rounded from float64, so that the card and the CPU agree to
    the last bit (a rotation's sampling grid magnifies that bit by the image side)."""
    t = theta.double()
    return torch.cos(t).to(theta.dtype), torch.sin(t).to(theta.dtype)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * torch.tensor(_GRAY, dtype=x.dtype, device=x.device), dim=-1, keepdim=True)


def apply_color_jitter(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``color_jitter`` of JAX on (n, H, W, 3) float in [0, 1], each image with its own draws."""
    def per_image(v):
        return v.to(x.dtype)[:, None, None, None]

    if "brightness" in params:
        x = x * per_image(params["brightness"])
    if "contrast" in params:
        mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
        x = mean + (x - mean) * per_image(params["contrast"])
    if "saturation" in params:
        gray = _gray(x)
        x = gray + (x - gray) * per_image(params["saturation"])
    if "hue" in params:
        cos_t, sin_t = _cos_sin(params["hue"].to(x.dtype) * math.pi)
        one, zero = torch.ones_like(cos_t), torch.zeros_like(cos_t)
        rot = torch.stack([torch.stack([one, zero, zero], -1), torch.stack([zero, cos_t, -sin_t], -1),
                           torch.stack([zero, sin_t, cos_t], -1)], -2)  # (n, 3, 3)
        to_yiq = torch.tensor(_TO_YIQ, dtype=x.dtype, device=x.device)
        mix = torch.linalg.inv(to_yiq) @ rot @ to_yiq
        x = torch.einsum("nhwc,ndc->nhwd", x, mix)
    return torch.clamp(x, 0.0, 1.0)


def draw_rotate(n: int, generator: torch.Generator, max_angle_deg: float = MAX_ANGLE_DEG) -> dict:
    return {"angle": _uniform(n, -max_angle_deg, max_angle_deg, generator)}


def apply_rotate(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``random_rotate`` of JAX: each image turned by its angle (degrees) about its centre,
    inverse bilinear sampling, zeros outside."""
    n, h, w, c = x.shape
    # (angle * pi) / 180 with one IEEE division, as JAX: torch's CUDA kernel divides by a Python
    # scalar as a product with its reciprocal, and the grid magnifies the last bit by the image side
    theta = true_divide(params["angle"].to(torch.float32) * math.pi, 180.0)
    cos_t, sin_t = (t[:, None, None] for t in _cos_sin(theta))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    src_y = cos_t * (yy - cy) + sin_t * (xx - cx) + cy
    src_x = -sin_t * (yy - cy) + cos_t * (xx - cx) + cx
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[..., None], (src_x - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    flat = x.reshape(n, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, index).reshape(n, h, w, c) * valid[..., None].to(x.dtype)

    return (gather(y0, x0) * ((1 - wy) * (1 - wx)) + gather(y0, x0 + 1) * ((1 - wy) * wx)
            + gather(y0 + 1, x0) * (wy * (1 - wx)) + gather(y0 + 1, x0 + 1) * (wy * wx))


def crop_side(image_size: int, source_size: int) -> int:
    """The random crop's side at the resized resolution: 0.8 of the source side, scaled, as JAX takes it."""
    return int(image_size * (int(source_size * 0.8) / source_size))


class Augment:
    """The trainer's batched augmentation (``make_augment_fn``): (n, H, W, C) uint8 -> float32
    (n, image_size, image_size, C): resize, / 255, each named op, normalize.

    ``augment(images, generator)`` draws every image's parameters from ``generator`` (on the
    images' device) and applies them; :meth:`draw` and :meth:`apply` are the two halves.
    """

    def __init__(self, augmentations: str, image_size: int, source_size: int, mean=PROCGEN_MEAN, std=PROCGEN_STD):
        self.augs = [a.strip() for a in augmentations.split(",") if a.strip()]
        for aug in self.augs:
            if aug not in ("random_crop", "color_jitter", "rotate"):
                raise ValueError(f"unknown augmentation {aug!r}")
        self.image_size, self.source_size, self.mean, self.std = image_size, source_size, mean, std
        self.crop = crop_side(image_size, source_size)

    def draw(self, n: int, generator: torch.Generator) -> list:
        """One parameter dict per op, in the ops' order, each with one entry an image."""
        draws = {"random_crop": lambda: draw_crop(n, self.image_size, self.crop, generator),
                 "color_jitter": lambda: draw_color_jitter(n, generator, **JITTER),
                 "rotate": lambda: draw_rotate(n, generator)}
        return [draws[aug]() for aug in self.augs]

    def apply(self, images: torch.Tensor, params: list) -> torch.Tensor:
        x = true_divide(resize_image(images.to(torch.float32), self.image_size, self.image_size, "bilinear"), 255.0)
        for aug, p in zip(self.augs, params):
            if aug == "random_crop":
                x = apply_crop(x, p, self.crop)
            elif aug == "color_jitter":
                x = apply_color_jitter(x, p)
            else:
                x = apply_rotate(x, p)
        return normalize(x, self.mean, self.std)

    def __call__(self, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(images, self.draw(images.shape[0], generator))


def make_augment_fn(augmentations: str = "random_crop, color_jitter", image_size: int = 224,
                    source_size: int = 256, mean=PROCGEN_MEAN, std=PROCGEN_STD) -> Augment:
    """The batched augmentation of the train step; the crop is 0.8 of ``source_size``, as in JAX."""
    return Augment(augmentations, image_size, source_size, mean, std)


def _beta(a: float, b: float, generator: torch.Generator) -> float:
    """One Beta(a, b) draw from ``generator`` (Johnk's method: two uniforms a try)."""
    while True:
        u, v = torch.rand(2, generator=generator, dtype=torch.float64, device=generator.device).tolist()
        x, y = u ** (1.0 / a), v ** (1.0 / b)
        if 0.0 < x + y <= 1.0:
            return x / (x + y)


def draw_mixup_cutmix(b: int, h: int, w: int, generator: torch.Generator, mixup_alpha=0.8, cutmix_alpha=1.0,
                      switch_prob=0.5) -> dict:
    """The batch's partner permutation, the branch, both lambdas and the box centre."""
    dev = generator.device
    return {"perm": torch.randperm(b, generator=generator, device=dev),
            "use_cutmix": float(torch.rand((), generator=generator, device=dev)) < switch_prob,
            "lam_mix": _beta(mixup_alpha, mixup_alpha, generator),
            "lam_cut": _beta(cutmix_alpha, cutmix_alpha, generator),
            "cy": int(torch.randint(0, h, (), generator=generator, device=dev)),
            "cx": int(torch.randint(0, w, (), generator=generator, device=dev))}


def apply_mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, num_classes: int, params: dict):
    """``mixup_cutmix`` of JAX with given draws: (mixed images, soft labels (B, num_classes))."""
    _, h, w, _ = images.shape
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(images.dtype)
    perm = params["perm"].to(images.device)
    if not params["use_cutmix"]:
        lam = np.float32(params["lam_mix"])
        images_out = float(lam) * images + float(1 - lam) * images[perm]
    else:
        ratio = np.sqrt(np.float32(1.0) - np.float32(params["lam_cut"]))
        cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
        cy, cx = params["cy"], params["cx"]
        y0, y1 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
        x0, x1 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
        yy = torch.arange(h, device=images.device)[None, :, None, None]
        xx = torch.arange(w, device=images.device)[None, None, :, None]
        in_box = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)).to(images.dtype)
        images_out = images * (1 - in_box) + images[perm] * in_box
        lam = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) / np.float32(h * w)
    return images_out, float(lam) * onehot + float(1 - lam) * onehot[perm]
