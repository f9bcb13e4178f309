"""Packed forward for the FROZEN m3ae/mae encoder (port of arp_tpu/ops/m3ae_infer.py).

The module in models/m3ae.py is the readable implementation; this is the
serving path for the frozen encoder tower inside the policy, the M3AE
counterpart of ops/vit_infer.py, whose machinery it shares:

  * the weights are repacked once into stacked (L, ...) tensors, with q/k/v
    as the one fused (D, 3D) matmul the module already holds;
  * bf16 everywhere except LN statistics (float32) and matmul epilogues
    (float32 bias add, one rounding);
  * the attention of the float paths goes through
    :func:`arp_tpu_torch.ops.attention.dot_product_attention`: kernel K1 on
    CUDA (float32 softmax), the plain version on the CPU (softmax in
    ``score_dtype``);
  * **int8 mode** with static per-site activation scales calibrated once on
    real frames: every int8 site runs
    :func:`arp_tpu_torch.ops.vit_infer.fused_int8_matmul`, kernel K2 on CUDA
    (the fc site with its tanh-GELU epilogue), the plain version on the CPU.

Encoder entry points (the token layouts of models/m3ae.py):

  * image-only  ``forward_representation(patch, None, None)``   [cls, img]
  * image+text  ``forward_representation(patch, ids, pad)``     [cls, img, txt]
  * goal-joint  ``forward_gc_representations(patch, goal)``     [cls, img, goal]

Left out: the layer-loop ``unroll`` (a TPU scheduling switch).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..utils import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed
from .quantization import true_divide
from .vit_infer import (
    _SITES,
    _amax,
    _attention,
    _attention_int8,
    _inv_scale,
    _layer,
    _ln,
    _ln_quant,
    _num_layers,
    _quant_w,
    fused_int8_matmul,
)

LN_EPS = 1e-6  # flax nn.LayerNorm default (models/layers.py uses it unchanged)


def pack_m3ae_params(variables: Mapping[str, torch.Tensor], depth: int, dtype=torch.bfloat16) -> dict:
    """Repack an encoder's state dict into stacked, fused tensors.

    ``variables`` is the state dict of ``MaskedMultimodalAutoencoder`` or
    ``MaskedAutoencoder`` (the latter simply lacks text and, as the policy
    configures it, type embeddings).  Weights cast to ``dtype`` in (K, N)
    layout; LN parameters and biases stay float32 (consumed inside float32
    epilogues).  The pack lives on the state dict's device.
    """
    p = variables

    def stack(name, dt=torch.float32, transpose=False):
        ws = [p[f"encoder.blocks_{i}.{name}"].detach() for i in range(depth)]
        return torch.stack([w.T if transpose else w for w in ws]).to(dt).contiguous()

    layers = {
        "ln1_s": stack("norm1.weight"), "ln1_b": stack("norm1.bias"),
        "wqkv": stack("attn.qkv.kernel", dtype), "bqkv": stack("attn.qkv.bias"),
        "wout": stack("attn.attn_out.weight", dtype, transpose=True), "bout": stack("attn.attn_out.bias"),
        "ln2_s": stack("norm2.weight"), "ln2_b": stack("norm2.bias"),
        "wfc": stack("mlp.fc1.weight", dtype, transpose=True), "bfc": stack("mlp.fc1.bias"),
        "wproj": stack("mlp.fc2.weight", dtype, transpose=True), "bproj": stack("mlp.fc2.bias"),
    }
    packed = {
        "img_w": p["image_embedding.weight"].detach().T.to(dtype).contiguous(),
        "img_b": p["image_embedding.bias"].detach().float(),
        "cls": p["cls_token"].detach().to(dtype),
        "ln_f_s": p["encoder.norm.weight"].detach().float(),
        "ln_f_b": p["encoder.norm.bias"].detach().float(),
        "layers": layers,
    }
    if "encoder_image_type_embedding" in p:
        packed["type_img"] = p["encoder_image_type_embedding"].detach().to(dtype)
    if "encoder_text_type_embedding" in p:
        packed["type_txt"] = p["encoder_text_type_embedding"].detach().to(dtype)
    if "text_embedding.weight" in p:
        packed["text_emb"] = p["text_embedding.weight"].detach().to(dtype)
    return packed


def _site(y, a_scale, tree, wname, bias, act="none", w_scale=None):
    """One int8 site over (..., K) activations: K2 on CUDA, its plain version on the CPU; bf16 out."""
    lead = y.shape[:-1]
    out = fused_int8_matmul(y.reshape(-1, y.shape[-1]), a_scale, tree[wname + "_q"],
                            tree[wname + "_ws"] if w_scale is None else w_scale, bias, act=act,
                            wq_t=tree.get(wname + "_qt"))
    return out.reshape(*lead, out.shape[-1])


def _embed_image_tokens(packed, patch, cd, quantized: bool = False):
    """patch (B, N, P*P*C) -> (B, N, D) image tokens (dense + 2d pos + type)."""
    if quantized:
        x = _site(patch, packed["a_img"], packed, "img_w", packed["img_b"]).to(cd)
    else:
        x = ((patch.to(cd) @ packed["img_w"].to(cd)).float() + packed["img_b"]).to(cd)
    x = x + get_2d_sincos_pos_embed(x.shape[-1], x.shape[1], x.device).to(cd)
    if "type_img" in packed:
        x = x + packed["type_img"].to(cd)
    return x


def _embed_text_tokens(packed, text_ids, cd):
    """text ids (B, T) -> (B, T, D) text tokens (lookup + 1d pos + type)."""
    x = packed["text_emb"][text_ids].to(cd)
    x = x + get_1d_sincos_pos_embed(x.shape[-1], x.shape[1], x.device).to(cd)
    if "type_txt" in packed:
        x = x + packed["type_txt"].to(cd)
    return x


def _token_stream(packed, patch, text_ids, text_padding_mask, goal_patch, cd, quantized: bool = False):
    """Build the encoder input exactly as models/m3ae.py does.

    Returns (x, kv_padding); kv_padding is None unless text is present
    (image-only and goal-joint encodes never pad).
    """
    b = patch.shape[0]
    emb = _embed_image_tokens(packed, patch, cd, quantized)
    cls = packed["cls"].to(cd).expand(b, 1, emb.shape[-1])
    parts = [cls, emb]
    pad = None
    if goal_patch is not None:
        assert text_ids is None, "goal-joint encode takes no text"
        parts.append(_embed_image_tokens(packed, goal_patch, cd, quantized))
    if text_ids is not None:
        parts.append(_embed_text_tokens(packed, text_ids, cd))
        zeros = torch.zeros((b, 1 + emb.shape[1]), dtype=torch.float32, device=patch.device)
        pad = torch.cat([zeros, text_padding_mask.to(torch.float32)], dim=1)
    return torch.cat(parts, dim=1), pad


def _stack_inter(inter, x):
    return torch.stack(inter) if inter else x.new_zeros((0, *x.shape))


def m3ae_encode(packed, patch, num_heads: int, text_ids=None, text_padding_mask=None, goal_patch=None,
                compute_dtype=torch.bfloat16, score_dtype=torch.float32, return_intermediates: bool = False):
    """Packed forward over pre-patchified inputs -> (B, N_total, D) float32 tokens.

    ``compute_dtype=torch.float32`` matches the module; bfloat16 is the
    production frozen-tower mode.  With ``return_intermediates`` also returns
    the per-layer block outputs (L, B, N, D) in the residual dtype, what
    ``use_intermediate`` consumes.
    """
    cd = compute_dtype
    x, pad = _token_stream(packed, patch, text_ids, text_padding_mask, goal_patch, cd)
    L = packed["layers"]
    inter = []
    for i in range(_num_layers(L)):
        Li = _layer(L, i)
        y = _ln(x, Li["ln1_s"], Li["ln1_b"], cd, eps=LN_EPS)
        qkv = ((y @ Li["wqkv"].to(cd)).float() + Li["bqkv"]).to(cd)
        q, k, v = qkv.chunk(3, dim=-1)
        a = _attention(q, k, v, num_heads, score_dtype, kv_padding=pad)
        x = x + ((a @ Li["wout"].to(cd)).float() + Li["bout"]).to(cd)
        y = _ln(x, Li["ln2_s"], Li["ln2_b"], cd, eps=LN_EPS)
        h = (y @ Li["wfc"].to(cd)).float() + Li["bfc"]
        h = F.gelu(h, approximate="tanh").to(cd)
        x = x + ((h @ Li["wproj"].to(cd)).float() + Li["bproj"]).to(cd)
        if return_intermediates:
            inter.append(x)
    out = _ln(x, packed["ln_f_s"], packed["ln_f_b"], torch.float32, eps=LN_EPS)
    return (out, _stack_inter(inter, x)) if return_intermediates else out


# --- int8 static-scale mode ---------------------------------------------------


def calibrate_m3ae(packed, patch, num_heads: int, text_ids=None, text_padding_mask=None, goal_patch=None) -> dict:
    """bf16 forward collecting per-site absolute maxima.

    Sites: img (patch input), per-layer qkv / attn_in / attn_out / fc / proj:
    the inputs of each int8 matmul, and the q/k/v operands of int8 attention.
    KEEP IN LOCKSTEP with :func:`m3ae_encode_int8`'s layer body.
    """
    cd = torch.bfloat16
    amax_img = _amax(patch)
    x, pad = _token_stream(packed, patch, text_ids, text_padding_mask, goal_patch, cd)
    L = packed["layers"]
    sites = {name: [] for name in ("qkv", "attn_in", "attn_out", "fc", "proj")}
    for i in range(_num_layers(L)):
        Li = _layer(L, i)
        y = _ln(x, Li["ln1_s"], Li["ln1_b"], cd, eps=LN_EPS)
        sites["qkv"].append(_amax(y))
        qkv = (y @ Li["wqkv"].to(cd)).float() + Li["bqkv"]
        sites["attn_in"].append(_amax(qkv))
        q, k, v = qkv.to(cd).chunk(3, dim=-1)
        a = _attention(q, k, v, num_heads, kv_padding=pad)
        sites["attn_out"].append(_amax(a))
        x = x + ((a @ Li["wout"].to(cd)).float() + Li["bout"]).to(cd)
        y = _ln(x, Li["ln2_s"], Li["ln2_b"], cd, eps=LN_EPS)
        sites["fc"].append(_amax(y))
        h = (y @ Li["wfc"].to(cd)).float() + Li["bfc"]
        h = F.gelu(h, approximate="tanh")
        sites["proj"].append(_amax(h))
        x = x + ((h.to(cd) @ Li["wproj"].to(cd)).float() + Li["bproj"]).to(cd)
    return {"img": amax_img, "layers": {name: torch.stack(v) for name, v in sites.items()}}


def quantize_m3ae_packed(packed, amax, margin: float = 1.05) -> dict:
    """bf16 pack + calibration amaxes -> int8 pack (weights per output channel).

    Holds the JAX pack's entries (``<w>_q`` (K, N) int8, ``<w>_ws`` (1, N)
    float32, ``a_<site>`` = amax * margin) and, for kernel K2, each weight once
    more in (N, K) layout, K contiguous, as ``<w>_qt``.
    """
    device = packed["img_w"].device

    def f32(a):  # a tensor, or a numpy amax from the JAX package
        a = a if isinstance(a, torch.Tensor) else torch.tensor(a)
        return a.to(device=device, dtype=torch.float32)

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
    qpack = {k: v for k, v in packed.items() if k not in ("img_w", "layers")}
    qpack["layers"] = layers
    put(qpack, "img_w", packed["img_w"])
    qpack["a_img"] = f32(amax["img"]) * margin
    return qpack


def m3ae_encode_int8(qpacked, patch, num_heads: int, text_ids=None, text_padding_mask=None, goal_patch=None,
                     score_dtype=torch.float32, return_intermediates: bool = False, fuse_quant: bool = False,
                     int8_attn: bool = False):
    """int8 forward with static activation scales.

    Attention and the residual stream stay bf16; LN statistics and matmul
    epilogues are float32.  Output float32 tokens, same layout as
    :func:`m3ae_encode`.

    ``fuse_quant=True`` folds the activation quantization into the LN and GELU
    epilogues (explicit int8 tensors between the matmuls,
    :func:`vit_infer._ln_quant`); the default quantizes inside each matmul.
    Under ``fuse_quant`` the int8 values reach K2 as bf16 with the unit scale
    127, which K2's own quantization maps to themselves.  K2 writes bf16, so on
    every device the fc site's GELU output is rounded to bf16 before it is
    quantized for proj (the JAX body quantizes the float32 value).

    ``int8_attn=True`` runs the two attention matmuls w8a8
    (:func:`vit_infer._attention_int8`); it needs a pack calibrated with the
    ``attn_in`` site.
    """
    cd = torch.bfloat16
    x, pad = _token_stream(qpacked, patch, text_ids, text_padding_mask, goal_patch, cd, quantized=True)
    L = qpacked["layers"]
    if int8_attn and "a_attn_in" not in L:
        raise ValueError(
            "int8_attn needs the 'attn_in' calibration site: recalibrate "
            "this pack with calibrate_m3ae before quantize_m3ae_packed")
    unit = torch.full((), 127.0, dtype=torch.float32, device=patch.device)

    def qmat(q8, a_scale, tree, wname, bias, act="none"):
        # int8 values in, so the epilogue's scale carries the activation's: ws * (a / 127)
        return _site(q8.to(cd), unit, tree, wname, bias, act,
                     w_scale=tree[wname + "_ws"] * true_divide(a_scale.float(), 127.0))

    def quant(t, a_scale):
        return torch.clamp(torch.round(t.float() * _inv_scale(a_scale)), -127, 127).to(torch.int8)

    def attn(q, k, v, Li):
        if int8_attn:
            return _attention_int8(q, k, v, num_heads, Li["a_attn_in"], score_dtype, kv_padding=pad)
        return _attention(q, k, v, num_heads, score_dtype, kv_padding=pad)

    inter = []
    for i in range(_num_layers(L)):
        Li = _layer(L, i)
        if not fuse_quant:
            y = _ln(x, Li["ln1_s"], Li["ln1_b"], cd, eps=LN_EPS)
            q, k, v = _site(y, Li["a_qkv"], Li, "wqkv", Li["bqkv"]).chunk(3, dim=-1)
            a = attn(q, k, v, Li)
            x = x + _site(a, Li["a_attn_out"], Li, "wout", Li["bout"])
            y = _ln(x, Li["ln2_s"], Li["ln2_b"], cd, eps=LN_EPS)
            h = _site(y, Li["a_fc"], Li, "wfc", Li["bfc"], act="gelu_tanh")  # float32 gelu, bf16 out
            x = x + _site(h, Li["a_proj"], Li, "wproj", Li["bproj"])
        else:
            q8 = _ln_quant(x, Li["ln1_s"], Li["ln1_b"], Li["a_qkv"], eps=LN_EPS)
            q, k, v = qmat(q8, Li["a_qkv"], Li, "wqkv", Li["bqkv"]).chunk(3, dim=-1)
            a = attn(q, k, v, Li)
            x = x + qmat(quant(a, Li["a_attn_out"]), Li["a_attn_out"], Li, "wout", Li["bout"])
            q8 = _ln_quant(x, Li["ln2_s"], Li["ln2_b"], Li["a_fc"], eps=LN_EPS)
            h = qmat(q8, Li["a_fc"], Li, "wfc", Li["bfc"], act="gelu_tanh")
            x = x + qmat(quant(h, Li["a_proj"]), Li["a_proj"], Li, "wproj", Li["bproj"])
        if return_intermediates:
            inter.append(x)
    out = _ln(x, qpacked["ln_f_s"], qpacked["ln_f_b"], torch.float32, eps=LN_EPS)
    return (out, _stack_inter(inter, x)) if return_intermediates else out


def build_m3ae_qpack(variables, depth: int, num_heads: int, sample_patch, text_ids=None, text_padding_mask=None,
                     goal_patch=None, margin: float = 1.05, return_amax: bool = False):
    """pack -> calibrate (on real frames) -> quantize, in one call.

    ``sample_patch`` should be a representative pre-patchified batch on the
    device of ``variables``; the 5% margin covers augmentation jitter, the
    reward engine's int8 recipe.  ``return_amax`` also returns the amaxes as
    tensors on the CPU, for persisting.
    """
    packed = pack_m3ae_params(variables, depth)
    with torch.no_grad():
        amax = calibrate_m3ae(packed, sample_patch, num_heads, text_ids, text_padding_mask, goal_patch)
    qpack = quantize_m3ae_packed(packed, amax, margin=margin)
    if not return_amax:
        return qpack
    host = {"img": amax["img"].cpu(), "layers": {k: v.cpu() for k, v in amax["layers"].items()}}
    return qpack, host
