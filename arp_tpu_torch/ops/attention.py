"""Multi-head attention (port of arp_tpu/ops/attention.py).

Two implementations behind one API, :func:`dot_product_attention`:

  * :func:`reference_attention` — the plain PyTorch version, equal to
    ``arp_tpu.ops.attention._xla_attention`` (the path the JAX package runs in
    production): scores in ``score_dtype``, scale ``D**-0.5``, masked scores
    filled with -1e30, then softmax.  Tensors on the CPU take it.
  * :func:`flash_attention_fwd` — kernel K1 (``csrc/flash_attn_fwd.cu``), the
    Hopper counterpart of the Pallas kernel ``_flash_kernel``.  CUDA tensors
    take it; what it does not support raises.  bfloat16 inputs run on the
    tensor cores (bf16 products, float32 sums and softmax, P rounded to bf16
    as the plain version rounds it); float32 inputs keep float32 products.

Both take q, k, v as (batch, seq, heads, head_dim).  A query row whose keys
are all masked gets the mean of V over all n keys in both.

Gradients: K1 is a forward kernel, as the Pallas kernel is (the JAX package
trains through ``_xla_attention``).  Where autograd needs the gradient of a
CUDA call, :class:`FlashAttention` runs K1 forward and recomputes the plain
attention from the saved q, k and v for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, flop_count
from .masks import MaskSpec, combine_padding, materialize_mask

_BIG_NEG = -1e30
_MASK_KINDS = {"none": 0, "causal": 1, "dt": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MaskSpec = MaskSpec("none"),
    kv_padding: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain attention.  q/k/v: (B, N, H, D); returns (B, N, H, D) in v's dtype.

    ``kv_padding``: optional (B, N), nonzero = PAD.  ``bias``: optional
    additive (1|B, H, N, N).  The scores are the float32 product of q and k
    cast to ``score_dtype`` (JAX's ``preferred_element_type``), and the
    softmax runs in ``score_dtype``, rounded where JAX's is: the scale is a
    ``score_dtype`` value, each elementwise step rounds to ``score_dtype``
    and the row sum accumulates in float32 (``jax.nn.softmax``).
    """
    n = q.shape[1]
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=score_dtype))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, N, D)
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)).to(score_dtype) * scale
    if bias is not None:
        s = s + bias.to(score_dtype)
    mask = materialize_mask(spec, n, device=q.device)[None, None]
    mask = combine_padding(mask, kv_padding)
    s = torch.where(mask, s, torch.tensor(_BIG_NEG, dtype=score_dtype, device=s.device))
    if score_dtype == torch.float32:
        p = torch.softmax(s, dim=-1)
    else:  # torch's low-precision softmax rounds only its output
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.float().sum(-1, keepdim=True).to(score_dtype)
    return torch.matmul(p.to(v.dtype), vt).transpose(1, 2)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MaskSpec = MaskSpec("none"),
    kv_padding: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel K1 on CUDA tensors.  q/k/v: (B, N, H, D) float32 or bfloat16.

    Reads q, k and v through their strides (only the last dim must be
    contiguous), so the head split of a (B, N, H*D) projection needs no copy.
    The softmax is always float32.  Returns a new contiguous (B, N, H, D)
    tensor in q's dtype.  Counts its launches in ``flash_attention_fwd.launches``.
    """
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got {q.shape}, {k.shape}, {v.shape}")
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError(f"K1 takes CUDA tensors on one device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K1 takes float32 or bfloat16 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, n, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"K1 takes head_dim in {_HEAD_DIMS}, got {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("K1 needs q, k, v contiguous in their last dim")
    pad = None
    if kv_padding is not None:
        if tuple(kv_padding.shape) != (b, n) or kv_padding.device != q.device:
            raise ValueError(f"kv_padding must be ({b}, {n}) on {q.device}, got {tuple(kv_padding.shape)} on {kv_padding.device}")
        pad = (kv_padding != 0).to(torch.uint8).contiguous()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        flash_attention_fwd.launches += 1
        flop_count.note(4 * b * h * n * n * d)
        err = _build.load("flash_attn_fwd").arp_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad is None else pad.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, n, h, d, *strides,
            _MASK_KINDS[spec.kind], spec.num_obs_token, spec.num_token_per_step,
            d ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with cudaError_t {err}")
    return out


flash_attention_fwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward with a plain PyTorch backward: the gradient of :func:`reference_attention`
    (float32 scores and softmax, as K1's), recomputed from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, spec, kv_padding):
        ctx.spec = spec
        ctx.save_for_backward(q, k, v, kv_padding)
        return flash_attention_fwd(q, k, v, spec, kv_padding)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_padding = ctx.saved_tensors
        inputs = [x.detach().requires_grad_(need) for x, need in zip((q, k, v), ctx.needs_input_grad[:3])]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = reference_attention(*inputs, ctx.spec, kv_padding)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if x.requires_grad else None for x in inputs), None, None)


def attention_route(device_type: str, needs_grad: bool, bias: bool = False) -> str:
    """Which implementation :func:`dot_product_attention` takes: "plain" on the CPU; on CUDA
    "k1", or "k1+plain_backward" (:class:`FlashAttention`) where autograd needs a gradient."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"no attention implementation for device {device_type}")
    if bias:
        raise NotImplementedError(
            "kernel K1 takes no dense bias (ALiBi); call reference_attention for it, as models/layers.py does"
        )
    return "k1+plain_backward" if needs_grad else "k1"


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MaskSpec = MaskSpec("none"),
    kv_padding: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Multi-head attention.  q/k/v: (batch, seq, heads, head_dim).

    CPU tensors take :func:`reference_attention`; CUDA tensors take kernel K1
    (:func:`flash_attention_fwd`), whose softmax is always float32 and so
    ignores ``score_dtype``, and which takes no dense ``bias`` (as the Pallas
    kernel takes none): a bias on CUDA raises.  A caller with a bias (ALiBi)
    calls :func:`reference_attention` itself, as the JAX package sends a bias
    to its XLA path (models/layers.py::Attention).  With grad enabled and q, k
    or v requiring it, a CUDA call goes through :class:`FlashAttention`
    (:func:`attention_route`).
    """
    if q.ndim != 4:
        raise ValueError(f"expected (b, n, h, d), got {tuple(q.shape)}")
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    route = attention_route(q.device.type, needs_grad, bias is not None)
    if route == "plain":
        return reference_attention(q, k, v, spec, kv_padding, bias=bias, score_dtype=score_dtype)
    if route == "k1":
        return flash_attention_fwd(q, k, v, spec, kv_padding)
    return FlashAttention.apply(q, k, v, spec, kv_padding)
