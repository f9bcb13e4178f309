"""Int8 weight-only quantization (port of arp_tpu/ops/quantization.py).

Per-output-channel symmetric int8 quantization of dense kernels, and the
weight-only int8 matmul behind ``ClipRewardEngine(quantize_weights=True)``:

  quantize_array(w)            -> (int8 values, float32 per-column scales)
  dequantize_array(q, scales)  -> float32
  int8_matmul(x, q, scales)    -> x @ dequantize(q), computed in float32
  quantize_linears(module)     -> every large nn.Linear becomes a QuantLinear

:func:`int8_matmul` takes kernel K3 (``csrc/int8_matmul.cu``, the Hopper
counterpart of the Pallas ``_int8_matmul_kernel``) on CUDA tensors and its
plain version, :func:`int8_matmul_reference`, on CPU tensors.  Kernels stay in
the JAX package's (K, N) layout.

K3 multiplies on the tensor cores with bf16 operands that hold x and q
exactly: a float32 x is split into three bf16 pieces (:func:`split_bf16x3`),
q is exact in bf16, and the scale is applied to the float32 sums.
:func:`int8_matmul_split_reference` is the plain version of that arithmetic;
it differs from :func:`int8_matmul_reference` only in where the float32
roundings fall.
"""

from __future__ import annotations

import torch
from torch import nn

from . import _build, flop_count

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def true_divide(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as one IEEE division on every device, as JAX computes it.

    torch's CUDA kernel divides by a Python scalar as ``t * (1 / c)``, which
    can be one ulp off; a divisor tensor keeps the true division.
    """
    return t / torch.full_like(t, c)


def quantize_array(w: torch.Tensor, axis: int = 0):
    """Symmetric per-channel int8 quantization along ``axis`` (the contraction dim).

    For a (K, N) kernel the scales are per output column, shape (1, N).
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so q and the
    scales equal the JAX package's bit for bit.
    """
    w = w.float()
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, true_divide(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``x.f32 @ (q.f32 * scale)`` in float32, cast to x's dtype.

    These are the Pallas kernel's numbers (it dequantizes and multiplies in
    float32), not the JAX package's non-TPU fallback, which casts the
    dequantized weight to x's dtype first.
    """
    return (x.float() @ dequantize_array(q, scale)).to(x.dtype)


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A float32 tensor as three bfloat16 pieces with ``hi + mid + lo == x`` exactly.

    ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, each
    rounded to nearest even.  Both differences are exact in float32, and 3 x 8
    significant bits cover float32's 24, so nothing is left over, for every
    x that rounds to a finite bf16 (|x| < 3.39e38) and whose smallest piece is
    not subnormal (|x| >= 2^-102).  A piece times an int8 weight has at most
    15 significant bits: exact in float32.
    """
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def int8_matmul_split_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the arithmetic K3 runs on the card: ``(sum_k x q) * scale[n]``.

    A float32 x goes as its three bf16 pieces, smallest first, each times
    ``q.f32`` in float32; a bfloat16 x as it is.  The scale multiplies the
    float32 sum once per output, where :func:`int8_matmul_reference` (the TPU
    kernel's formula) multiplies every weight.  Every product is exact in
    both; they differ by the order and the rounding of the float32 sums.
    Tests use this; nothing on the labeling path does.
    """
    qf = q.float()
    if x.dtype == torch.float32:
        hi, mid, lo = split_bf16x3(x)
        acc = lo.float() @ qf + mid.float() @ qf + hi.float() @ qf
    else:
        acc = x.float() @ qf
    return (acc * scale).to(x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(q, scale); x: (M, K) float32 or bfloat16, q: (K, N) int8, scale: (1, N) float32.

    CPU tensors take :func:`int8_matmul_reference`; CUDA tensors take kernel
    K3, which counts its launches in ``int8_matmul.launches``; any other
    device raises.  Returns (M, N) in x's dtype.
    """
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8_matmul for device {x.device}")
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"int8_matmul takes x (M, K) and q (K, N), got {tuple(x.shape)}, {tuple(q.shape)}")
    m, k = x.shape
    n = q.shape[1]
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"K3 takes float32 or bfloat16 x, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 or tuple(scale.shape) != (1, n):
        raise ValueError(f"K3 takes int8 q and a float32 (1, {n}) scale, got {q.dtype}, {scale.dtype} {tuple(scale.shape)}")
    if q.device != x.device or scale.device != x.device:
        raise ValueError(f"K3 takes tensors on one device, got {x.device}, {q.device}, {scale.device}")
    if x.stride(1) != 1 or not q.is_contiguous() or not scale.is_contiguous():
        raise ValueError("K3 needs x contiguous in its last dim and q, scale contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        int8_matmul.launches += 1
        flop_count.note(2 * m * k * n)
        err = _build.load("int8_matmul").arp_int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _X_DTYPES[x.dtype], m, n, k, x.stride(0), stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed with cudaError_t {err}")
    return out


int8_matmul.launches = 0


class QuantLinear(nn.Module):
    """An ``nn.Linear`` stored as int8 q (K, N), a float32 (1, N) scale and the bias.

    ``forward`` is ``int8_matmul(x, q, scale) + bias``.  The scale stays
    float32 when the module is cast (``.to(torch.bfloat16)``): the kernel
    reads float32 scales, and the JAX engine dequantizes with float32 scales
    before it casts the kernel to the compute dtype.
    """

    def __init__(self, linear: nn.Linear):
        super().__init__()
        q, scale = quantize_array(linear.weight.detach().T, axis=0)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.register_buffer("q", q.contiguous())
        self.register_buffer("scale", scale)
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:  # a dtype cast: keep the float32 values, take the device
            self.scale = scale.to(self.scale.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        out = int8_matmul(x.reshape(-1, self.in_features), self.q, self.scale)
        out = out.reshape(*lead, self.out_features)
        return out if self.bias is None else out + self.bias

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


def quantize_linears(module: nn.Module, min_size: int = 1024) -> list[str]:
    """Replace, in place, every ``nn.Linear`` with at least ``min_size`` weights by a QuantLinear.

    The counterpart of ``quantize_tree``: the port's Linears are the Flax
    Dense kernels, so this quantizes exactly the leaves ``quantize_tree``
    quantizes (each 2-D ``kernel`` with >= min_size elements, both towers).
    Returns the qualified names of the replaced modules.
    """
    names = [name for name, m in module.named_modules()
             if isinstance(m, nn.Linear) and m.weight.numel() >= min_size]
    for name in names:
        parent, _, child = name.rpartition(".")
        owner = module.get_submodule(parent) if parent else module
        setattr(owner, child, QuantLinear(getattr(owner, child)))
    return names


def quantization_error(w: torch.Tensor) -> float:
    """Relative Frobenius-norm error of the int8 round trip (diagnostic)."""
    q, s = quantize_array(w)
    back = dequantize_array(q, s)
    return float(torch.linalg.vector_norm(back - w.float()) / torch.clamp(torch.linalg.vector_norm(w.float()), min=1e-12))
