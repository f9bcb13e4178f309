"""Packed ViT encode path for frozen-CLIP inference (port of arp_tpu/ops/vit_infer.py).

The CLIP module (models/clip/model.py) is the readable reference; this module
is the serving path the reward engine takes under ``fast_encode`` and
``fast_int8``.  Its numbers follow the JAX package's module:

  * the weights are repacked once: per-layer tensors stacked into (L, ...)
    and the q/k/v projections fused into one (D, 3D) matmul, in (K, N)
    layout; LayerNorm parameters and biases stay float32;
  * ``compute_dtype`` float32 matches the CLIP module; bfloat16 keeps LN
    statistics in float32 and rounds each matmul output to bf16 before the
    float32 bias add, as JAX does;
  * the attention of the float paths goes through
    :func:`arp_tpu_torch.ops.attention.dot_product_attention`: the plain
    version on the CPU (softmax in ``score_dtype``), kernel K1 on CUDA
    (softmax always float32);
  * **int8 mode**: weights per output channel int8, activations quantized
    with static per-site scales calibrated once on real frames
    (:func:`calibrate_vit`, :func:`quantize_packed`).  Every int8 site runs
    :func:`fused_int8_matmul`: kernel K2 (``csrc/int8_gemm.cu``) on CUDA,
    its plain version on the CPU.

Left out: the layer-loop ``unroll``, the ``impl``/``interpret`` switches and
this tower's ``fuse_quant=True`` body (TPU scheduling A/Bs).  ``_ln_quant``
is here for the M3AE tower's ``fuse_quant`` body (ops/m3ae_infer.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, flop_count
from .attention import dot_product_attention
from .quantization import quantize_array, true_divide

LN_EPS = 1e-5  # torch CLIP LayerNorm epsilon
INT8_ATTN_MAX_TOKENS = 1040  # N * 127^2 < 2^24: the float32 P @ V sums stay exact
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "quickgelu": 1, "gelu_tanh": 2}
_SITES = (("qkv", "wqkv"), ("attn_out", "wout"), ("fc", "wfc"), ("proj", "wproj"))
# quick-GELU's 1.702 rounded to the compute dtype, as JAX's jnp.float32(1.702).astype(cd);
# a Python float, so that no call makes a tensor on the device
_GELU_C = {dt: float(torch.tensor(1.702, dtype=dt)) for dt in _X_DTYPES}


def _ln(x, scale, bias, out_dtype, eps=LN_EPS):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(out_dtype)


def _ln_quant(x, scale, bias, a_scale, eps=LN_EPS):
    """LayerNorm with the int8 activation quantization folded into its affine: int8 out.

    ``round((y * s + b) * inv)`` computed as ``y * (s * inv) + b * inv`` with
    ``inv = 127 / max(a_scale, 1e-12)``, in JAX's operation order, rounded
    half to even and clipped to +-127.
    """
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    inv = _inv_scale(a_scale)
    y = (xf - mu) * torch.rsqrt(var + eps)
    q = y * (scale.float() * inv) + bias.float() * inv
    return torch.clamp(torch.round(q), -127, 127).to(torch.int8)


def pack_vit_params(visual, dtype=torch.bfloat16) -> dict:
    """Repack the port's ``VisionTransformer`` into stacked, fused tensors.

    Returns JAX ``pack_vit_params``'s tree: weights cast to ``dtype`` in (K, N)
    layout, LN parameters and biases float32, on the module's device.  Pack
    from the float32 module: the values are its parameters, cast once.
    """
    blocks = list(visual.transformer.resblocks)

    def stack(fn, dt=torch.float32):
        return torch.stack([fn(b).detach() for b in blocks]).to(dt)

    def kernel(linear):
        return linear.weight.detach().T

    attn = lambda b: (b.attn.query, b.attn.key, b.attn.value)  # noqa: E731
    layers = {
        "ln1_s": stack(lambda b: b.ln_1.weight),
        "ln1_b": stack(lambda b: b.ln_1.bias),
        "wqkv": stack(lambda b: torch.cat([kernel(m) for m in attn(b)], dim=1), dtype),
        "bqkv": stack(lambda b: torch.cat([m.bias for m in attn(b)], dim=0)),
        "wout": stack(lambda b: kernel(b.attn.out), dtype),
        "bout": stack(lambda b: b.attn.out.bias),
        "ln2_s": stack(lambda b: b.ln_2.weight),
        "ln2_b": stack(lambda b: b.ln_2.bias),
        "wfc": stack(lambda b: kernel(b.mlp.c_fc), dtype),
        "bfc": stack(lambda b: b.mlp.c_fc.bias),
        "wproj": stack(lambda b: kernel(b.mlp.c_proj), dtype),
        "bproj": stack(lambda b: b.mlp.c_proj.bias),
    }
    f32 = lambda t: t.detach().float()  # noqa: E731
    return {
        "conv1": kernel(visual.conv1).to(dtype).contiguous(),
        "cls": visual.class_embedding.detach().to(dtype),
        "pos": visual.positional_embedding.detach().to(dtype),
        "ln_pre_s": f32(visual.ln_pre.weight),
        "ln_pre_b": f32(visual.ln_pre.bias),
        "ln_post_s": f32(visual.ln_post.weight),
        "ln_post_b": f32(visual.ln_post.bias),
        "proj": kernel(visual.proj).to(dtype).contiguous(),
        "layers": layers,
    }


def _layer(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


def _num_layers(layers: dict) -> int:
    return int(next(iter(layers.values())).shape[0])


def _attention(q, k, v, num_heads, score_dtype=torch.float32, kv_padding=None):
    """(B, N, D) q, k, v -> (B, N, D) attention.

    On the CPU the plain attention with scores and softmax in ``score_dtype``;
    on CUDA kernel K1, which reads the head split through strides (no copy)
    and keeps its softmax in float32 whatever ``score_dtype`` says.
    ``kv_padding``: optional (B, N), nonzero = PAD key.
    """
    b, n, d = q.shape
    split = lambda t: t.view(b, n, num_heads, d // num_heads)  # noqa: E731
    out = dot_product_attention(split(q), split(k), split(v), kv_padding=kv_padding, score_dtype=score_dtype)
    return out.reshape(b, n, d)


def _inv_scale(a: torch.Tensor) -> torch.Tensor:
    """127 / max(a, 1e-12) as one IEEE division, as JAX and kernel K2 compute it.

    (Python's ``127.0 / tensor`` is ``tensor.reciprocal() * 127`` in torch, two
    roundings, which moves some x * inv across an int8 rounding edge.)
    """
    a = torch.clamp(a.float(), min=1e-12)
    return torch.full_like(a, 127.0) / a


def _check_exact_f32_matmul(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact integer products in float32 need torch.backends.cuda.matmul.allow_tf32 = False")


def _attention_int8(q, k, v, num_heads, a_in, score_dtype=torch.bfloat16, kv_padding=None):
    """w8a8 attention: int8 QK^T and P @ V with static scales, plain PyTorch on every device.

    ``a_in`` is one calibrated amax covering q, k and v (site ``attn_in``);
    the probabilities quantize with the static scale 1/127.  Torch has no
    int8 batched matmul on CUDA, so both integer products run in float32,
    where they are exact: |q k| <= head_dim * 127^2 and |P V| <= N * 127^2
    stay below 2^24 for head_dim, N <= 1,040 (larger raises).  TF32 is
    refused.  Returns bf16 (B, N, D).
    """
    b, n, d = q.shape
    hd = d // num_heads
    if n > INT8_ATTN_MAX_TOKENS or hd * 127 * 127 >= 1 << 24:
        raise ValueError(f"int8 attention is exact in float32 only for N <= {INT8_ATTN_MAX_TOKENS} "
                         f"and head_dim <= 1040, got N={n}, head_dim={hd}")
    _check_exact_f32_matmul(q.device)
    a_in = a_in.float()
    inv = _inv_scale(a_in)

    def q8(t):  # integer values held in float32, (B, H, N, hd)
        t = torch.clamp(torch.round(t.float() * inv), -127, 127)
        return t.view(b, n, num_heads, hd).transpose(1, 2)

    qi, ki, vi = q8(q), q8(k), q8(v)
    s = torch.matmul(qi, ki.transpose(-1, -2))  # exact int32 values
    s_scale = true_divide(a_in, 127.0) ** 2 * hd ** -0.5
    s = (s * s_scale).to(score_dtype)
    if kv_padding is not None:
        pad = (kv_padding != 0)[:, None, None, :]  # (B, 1, 1, N) over keys
        s = s.masked_fill(pad, -1e30)
    p = torch.softmax(s, dim=-1)
    p8 = torch.round(p.float() * 127.0)  # probabilities in [0, 1]
    out = torch.matmul(p8, vi)  # exact int32 values
    out = out * true_divide(true_divide(a_in, 127.0), 127.0)
    return out.transpose(1, 2).reshape(b, n, d).to(torch.bfloat16)


def vit_encode(packed, patches, num_heads: int, compute_dtype=torch.bfloat16,
               score_dtype=torch.float32, return_intermediates: bool = False):
    """Forward pass over pre-patchified inputs (B, N, P*P*C) -> (B, embed_dim) float32.

    ``compute_dtype=torch.float32`` matches the CLIP module; bfloat16 is the
    production mode.  ``return_intermediates=True`` also returns the per-layer
    CLS tokens as (L, B, D) float32.
    """
    cd = compute_dtype
    L = packed["layers"]
    x = patches.to(cd) @ packed["conv1"].to(cd)
    b = x.shape[0]
    cls = packed["cls"].to(cd).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + packed["pos"][None, : x.shape[1]].to(cd)
    x = _ln(x, packed["ln_pre_s"], packed["ln_pre_b"], cd)

    inter = []
    for i in range(_num_layers(L)):
        Li = _layer(L, i)
        y = _ln(x, Li["ln1_s"], Li["ln1_b"], cd)
        qkv = (y @ Li["wqkv"].to(cd)).float() + Li["bqkv"]
        q, k, v = qkv.to(cd).chunk(3, dim=-1)
        a = _attention(q, k, v, num_heads, score_dtype)
        x = x + ((a @ Li["wout"].to(cd)).float() + Li["bout"]).to(cd)
        y = _ln(x, Li["ln2_s"], Li["ln2_b"], cd)
        h = ((y @ Li["wfc"].to(cd)).float() + Li["bfc"]).to(cd)
        h = h * torch.sigmoid(_GELU_C[cd] * h)
        x = x + ((h @ Li["wproj"].to(cd)).float() + Li["bproj"]).to(cd)
        inter.append(x[:, 0].float())
    feat = _ln(x[:, 0], packed["ln_post_s"], packed["ln_post_b"], cd)
    out = (feat @ packed["proj"].to(cd)).float()
    if return_intermediates:
        inter = torch.stack(inter) if inter else x.new_zeros((0, b, x.shape[-1]), dtype=torch.float32)
        return out, inter
    return out


# --- int8 static-scale mode ---------------------------------------------------


def _amax(t):
    return t.float().abs().amax()


def calibrate_vit(packed, patches, num_heads: int) -> dict:
    """Run the bf16 forward collecting per-site absolute maxima.

    Returns {"conv1": scalar, "final": scalar, "layers": {site: (L,)}} with
    sites qkv / attn_in / attn_out / fc / proj: the inputs of each int8
    matmul, and the q/k/v operands of int8 attention (``attn_in``).

    KEEP IN LOCKSTEP with :func:`vit_encode`'s layer body: the sites must see
    exactly the activations the int8 forward will quantize.
    """
    cd = torch.bfloat16
    L = packed["layers"]
    x = patches.to(cd)
    amax_conv = _amax(x)
    x = x @ packed["conv1"].to(cd)
    b = x.shape[0]
    cls = packed["cls"].to(cd).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + packed["pos"][None, : x.shape[1]].to(cd)
    x = _ln(x, packed["ln_pre_s"], packed["ln_pre_b"], cd)

    sites = {name: [] for name in ("qkv", "attn_in", "attn_out", "fc", "proj")}
    for i in range(_num_layers(L)):
        Li = _layer(L, i)
        y = _ln(x, Li["ln1_s"], Li["ln1_b"], cd)
        sites["qkv"].append(_amax(y))
        qkv = (y @ Li["wqkv"].to(cd)).float() + Li["bqkv"]
        sites["attn_in"].append(_amax(qkv))
        q, k, v = qkv.to(cd).chunk(3, dim=-1)
        a = _attention(q, k, v, num_heads)
        sites["attn_out"].append(_amax(a))
        x = x + ((a @ Li["wout"].to(cd)).float() + Li["bout"]).to(cd)
        y = _ln(x, Li["ln2_s"], Li["ln2_b"], cd)
        sites["fc"].append(_amax(y))
        h = ((y @ Li["wfc"].to(cd)).float() + Li["bfc"]).to(cd)
        h = h * torch.sigmoid(_GELU_C[cd] * h)
        sites["proj"].append(_amax(h))
        x = x + ((h @ Li["wproj"].to(cd)).float() + Li["bproj"]).to(cd)
    feat = _ln(x[:, 0], packed["ln_post_s"], packed["ln_post_b"], cd)
    return {"conv1": amax_conv, "final": _amax(feat),
            "layers": {name: torch.stack(v) for name, v in sites.items()}}


def _quant_w(w):
    """Per-output-channel symmetric int8: (..., K, N) -> int8 + (..., 1, N) float32 scales."""
    return quantize_array(w.float(), axis=-2)


def quantize_packed(packed, amax, margin: float = 1.05) -> dict:
    """Turn a bf16 pack + calibration amaxes into the int8 pack.

    Holds JAX ``quantize_packed``'s entries (``<w>_q`` (K, N) int8, ``<w>_ws``
    (1, N) float32, ``a_<site>`` = amax * margin) and, for kernel K2, each
    weight once more in (N, K) layout, K contiguous, as ``<w>_qt``.
    """
    def f32(a):  # a tensor, or a numpy amax from the JAX package
        a = a if isinstance(a, torch.Tensor) else torch.tensor(a)
        return a.to(device=packed["conv1"].device, dtype=torch.float32)

    def put(tree, name, w):
        q, ws = _quant_w(w)
        tree[name + "_q"], tree[name + "_ws"] = q, ws
        tree[name + "_qt"] = q.transpose(-1, -2).contiguous()

    layers = dict(packed["layers"])
    for site, wname in _SITES:
        put(layers, wname, layers.pop(wname))
        layers["a_" + site] = f32(amax["layers"][site]) * margin
    if "attn_in" in amax["layers"]:  # absent in packs calibrated without the int8-attention site
        layers["a_attn_in"] = f32(amax["layers"]["attn_in"]) * margin
    qpack = {k: v for k, v in packed.items() if k not in ("conv1", "proj", "layers")}
    qpack["layers"] = layers
    put(qpack, "conv1", packed["conv1"])
    qpack["a_conv1"] = f32(amax["conv1"]) * margin
    put(qpack, "proj", packed["proj"])
    qpack["a_final"] = f32(amax["final"]) * margin
    return qpack


def int8_dot(q: torch.Tensor, w: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Exact int32 ``q @ w`` for int8-valued q (M, K) and w (K, N), on any device.

    Torch has no int32 matmul on CUDA, so K is cut into chunks of at most
    1,024 and each chunk multiplies in float32: every partial sum is an
    integer of magnitude <= 1,024 * 127^2 < 2^24, so exact; the chunks add in
    int32.  TF32 is refused.
    """
    _check_exact_f32_matmul(q.device)
    qf, wf = q.float(), w.float()
    acc = None
    for k0 in range(0, q.shape[-1], chunk):
        part = (qf[..., k0 : k0 + chunk] @ wf[k0 : k0 + chunk]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _quantize_x(x, a_scale):
    """clip(round_half_even(x * 127/a), +-127) as float32 integer values."""
    return torch.clamp(torch.round(x.float() * _inv_scale(a_scale)), -127, 127)


def _qmatmul(y, a_scale, wq, w_scale, bias=None):
    """Static-scale int8 matmul, plain: y -> int8 -> exact int32 dot -> float32 epilogue.

    y: (..., K) any float; a_scale: scalar float32; wq: (K, N) int8;
    w_scale: (1, N) float32.  Returns float32 (..., N).
    """
    acc = int8_dot(_quantize_x(y, a_scale), wq)
    out = acc.float() * (w_scale * true_divide(a_scale.float(), 127.0))
    return out if bias is None else out + bias


def fused_int8_matmul_reference(x, a_scale, wq, w_scale, bias=None, act: str = "none"):
    """Plain version of K2: quantize x, exact int32 product, float32 epilogue, one bf16 rounding."""
    out = _qmatmul(x, a_scale, wq, w_scale, torch.zeros_like(w_scale) if bias is None else bias.reshape(1, -1))
    if act == "quickgelu":
        out = out * torch.sigmoid(1.702 * out)
    elif act == "gelu_tanh":  # jax.nn.gelu(approximate=True), in float32
        out = torch.nn.functional.gelu(out, approximate="tanh")
    return out.to(torch.bfloat16)


# Kernel K2's tiles (csrc/int8_gemm.cu): a block owns 128 rows, a column tile is
# 256 wide, a K tile 64 deep; up to 12 K tiles of quantized x stay in shared memory.
K2_BLOCK_M, K2_BLOCK_N, K2_BLOCK_K, K2_RESIDENT_K_TILES = 128, 256, 64, 12


def k2_plan(m: int, k: int, n: int, x_bytes: int, sms: int = 132) -> dict:
    """The route kernel K2 takes for an (m, k) x (k, n) call on a card of ``sms`` SMs, as ``make_plan`` in csrc/int8_gemm.cu.

    ``route`` "resident" (k <= 768): the quantized x tiles of a unit of work
    all stay in shared memory, so a block quantizes its 128 rows once and
    walks ``n_per_unit`` column tiles with only the weight streaming: all of
    them when there are more row panels than SMs, fewer when that is needed
    to give every SM a unit.  "streaming": a unit is one 128 x 256 tile and
    x is read and quantized again for each column tile.  ``groups`` is the
    number of units a row panel is cut into, ``units`` what the persistent
    blocks share, and ``l2_bytes`` what the route moves from L2 into shared
    memory (x once a unit, ``x_bytes`` a value; the int8 weight once a row
    panel), from the tile shapes; zero-filled edges are not counted.
    """
    panels = -(-m // K2_BLOCK_M)
    n_tiles = -(-n // K2_BLOCK_N)
    resident = -(-k // K2_BLOCK_K) <= K2_RESIDENT_K_TILES
    if resident:
        wanted = min(max(sms // panels, 1), n_tiles)
        n_per_unit = -(-n_tiles // wanted)
    else:
        n_per_unit = 1
    groups = -(-n_tiles // n_per_unit)
    return {"route": "resident" if resident else "streaming", "n_per_unit": n_per_unit, "groups": groups,
            "units": panels * groups, "l2_bytes": m * k * x_bytes * groups + n * k * panels}


def fused_int8_matmul(x, a_scale, wq, w_scale, bias=None, act: str = "none",
                      wq_t: Optional[torch.Tensor] = None):
    """Quantize-on-the-fly int8 matmul with a fused epilogue; (M, N) bf16.

    x: (M, K) float32 or bf16; a_scale: () float32 static activation scale;
    wq: (K, N) int8 with per-column scales w_scale (1, N) float32; bias (N,)
    or (1, N) float32 or None; act: "none" | "quickgelu" | "gelu_tanh" (the tanh
    approximation, the M3AE tower's).  ``wq_t``: the same
    weight in (N, K) layout, K contiguous, as kernel K2 reads it (made from
    ``wq`` when not given).

    CPU tensors take :func:`fused_int8_matmul_reference`; CUDA tensors take
    kernel K2, which counts its launches in ``fused_int8_matmul.launches``
    and needs K % 32 == 0 and N % 8 == 0; any other device raises.
    """
    if act not in _ACTS:
        raise ValueError(f"act must be one of {tuple(_ACTS)}, got {act!r}")
    if x.device.type == "cpu":
        return fused_int8_matmul_reference(x, a_scale, wq, w_scale, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_int8_matmul for device {x.device}")
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"K2 takes x (M, K) and wq (K, N), got {tuple(x.shape)}, {tuple(wq.shape)}")
    m, k = x.shape
    n = wq.shape[1]
    if k % 32 or n % 8:
        raise ValueError(f"K2 needs K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"K2 takes float32 or bfloat16 x, got {x.dtype}")
    if wq_t is None:
        wq_t = wq.t().contiguous()
    a = a_scale.reshape(1)
    ws = w_scale.reshape(-1)
    b = None if bias is None else bias.reshape(-1)
    tensors = [wq_t, a, ws] + ([] if b is None else [b])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"K2 takes tensors on one device, got x on {x.device}")
    if wq_t.dtype != torch.int8 or tuple(wq_t.shape) != (n, k) or not wq_t.is_contiguous():
        raise ValueError(f"K2 takes a contiguous int8 (N, K) = ({n}, {k}) weight, got {wq_t.dtype} {tuple(wq_t.shape)}")
    if any(t.dtype != torch.float32 for t in tensors[1:]) or ws.numel() != n or (b is not None and b.numel() != n):
        raise ValueError(f"K2 takes a float32 scalar a_scale and float32 ({n},) w_scale and bias")
    if x.stride(1) != 1 or (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError("K2 needs x contiguous in its last dim with 16-byte aligned rows")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    ws, b = ws.contiguous(), None if b is None else b.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fused_int8_matmul.launches += 1
        flop_count.note(2 * m * k * n)
        err = _build.load("int8_gemm").arp_int8_gemm(
            x.data_ptr(), a.data_ptr(), wq_t.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            _X_DTYPES[x.dtype], m, n, k, x.stride(0), _ACTS[act], stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_gemm launch failed with cudaError_t {err}")
    return out


fused_int8_matmul.launches = 0


def vit_encode_int8(qpacked, patches, num_heads: int, score_dtype=torch.float32,
                    return_intermediates: bool = False, int8_attn: bool = False):
    """int8 forward (static activation scales); attention and LN stay bf16/float32.

    Every int8 site runs :func:`fused_int8_matmul`'s semantics: the epilogue
    (scale, bias, quick-GELU) in float32 and one rounding to bf16, as JAX's
    ``impl="pallas"``.  JAX's default ``impl="xla"`` differs only in where the
    fc site's quick-GELU rounds: it rounds the matmul to bf16 first and runs
    the GELU in bf16.  ``int8_attn=True`` also runs the two attention matmuls
    w8a8 (:func:`_attention_int8`) and needs a pack calibrated with the
    ``attn_in`` site.
    """
    cd = torch.bfloat16
    L = qpacked["layers"]
    if int8_attn and "a_attn_in" not in L:
        raise ValueError(
            "int8_attn needs the 'attn_in' calibration site: recalibrate "
            "this pack with calibrate_vit before quantize_packed")

    def site(y, a, tree, wname, bias, act="none"):
        lead = y.shape[:-1]
        out = fused_int8_matmul(y.reshape(-1, y.shape[-1]), a, tree[wname + "_q"], tree[wname + "_ws"],
                                bias, act=act, wq_t=tree.get(wname + "_qt"))
        return out.reshape(*lead, out.shape[-1])

    x = site(patches, qpacked["a_conv1"], qpacked, "conv1", None)
    b = x.shape[0]
    cls = qpacked["cls"].to(cd).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + qpacked["pos"][None, : x.shape[1]].to(cd)
    x = _ln(x, qpacked["ln_pre_s"], qpacked["ln_pre_b"], cd)

    inter = []
    for i in range(_num_layers(L)):
        Li = _layer(L, i)
        y = _ln(x, Li["ln1_s"], Li["ln1_b"], cd)
        qkv = site(y, Li["a_qkv"], Li, "wqkv", Li["bqkv"])
        q, k, v = qkv.chunk(3, dim=-1)
        if int8_attn:
            a = _attention_int8(q, k, v, num_heads, Li["a_attn_in"], score_dtype)
        else:
            a = _attention(q, k, v, num_heads, score_dtype)
        x = x + site(a, Li["a_attn_out"], Li, "wout", Li["bout"])
        y = _ln(x, Li["ln2_s"], Li["ln2_b"], cd)
        h = site(y, Li["a_fc"], Li, "wfc", Li["bfc"], act="quickgelu")
        x = x + site(h, Li["a_proj"], Li, "wproj", Li["bproj"])
        inter.append(x[:, 0].float())
    feat = _ln(x[:, 0], qpacked["ln_post_s"], qpacked["ln_post_b"], cd)
    out = site(feat, qpacked["a_final"], qpacked, "proj", None).float()
    if return_intermediates:
        inter = torch.stack(inter) if inter else x.new_zeros((0, b, x.shape[-1]), dtype=torch.float32)
        return out, inter
    return out
