"""Multi-head attention (port of arp_tpu/ops/attention.py).

Two implementations behind one API, :func:`dot_product_attention`:

  * :func:`reference_attention` — the plain PyTorch version, equal to
    ``arp_tpu.ops.attention._xla_attention`` (the path the JAX package runs in
    production): scores in ``score_dtype``, scale ``D**-0.5``, masked scores
    filled with -1e30, then softmax.  Tensors on the CPU take it.
  * :func:`flash_attention_fwd` — kernel K1 (``csrc/flash_attn_fwd.cu``), the
    Hopper counterpart of the Pallas kernel ``_flash_kernel``.  CUDA tensors
    take it; what it does not support raises.

Both take q, k, v as (batch, seq, heads, head_dim).  A query row whose keys
are all masked gets the mean of V over all n keys in both.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .masks import MaskSpec, combine_padding, materialize_mask

_BIG_NEG = -1e30
_MASK_KINDS = {"none": 0, "causal": 1, "dt": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


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
    softmax runs in ``score_dtype``.
    """
    n = q.shape[1]
    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, N, D)
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)).to(score_dtype) * scale
    if bias is not None:
        s = s + bias.to(score_dtype)
    mask = materialize_mask(spec, n, device=q.device)[None, None]
    mask = combine_padding(mask, kv_padding)
    s = torch.where(mask, s, torch.tensor(_BIG_NEG, dtype=score_dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
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
        err = _build.flash_attn_lib().arp_flash_attn_fwd(
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
    kernel takes none): a bias on CUDA raises.
    """
    if q.ndim != 4:
        raise ValueError(f"expected (b, n, h, d), got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return reference_attention(q, k, v, spec, kv_padding, bias=bias, score_dtype=score_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no attention implementation for device {q.device}")
    if bias is not None:
        raise NotImplementedError(
            "kernel K1 takes no dense bias (ALiBi); it is added with the slice that needs it"
        )
    return flash_attention_fwd(q, k, v, spec, kv_padding)
