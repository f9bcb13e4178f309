"""The port's packed M3AE forward (ops/m3ae_infer.py) against the Flax module and the JAX
package's packed path: same numpy-seeded inputs, same weights through the bridge.

float32: atol 2e-5 (the JAX package's bound between its two paths).  The int8 pack:
bit-equal given the same amaxes.  ``_ln_quant``: bit-equal.  bf16 and int8 forwards:
the JAX tests' cosine bounds (0.995 bf16, 0.98 int8, 0.97 int8 + int8 attention)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.ops import m3ae_infer as jinfer
from arp_tpu.ops import vit_infer as jvit
from arp_tpu_torch.ops import m3ae_infer as tinfer
from arp_tpu_torch.ops import vit_infer as tvit

from test_torch_m3ae import DEPTH, EMB, HEADS, NPATCH, _cos, close, inputs, make_pair

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


VARIANTS = ["image", "text", "goal"]


def _variant(variant):
    """(JAX kwargs, torch kwargs, Flax float32 reference) of one token stream."""
    jmodel, variables, tmodel = make_pair()
    patch, goal, ids, pad = inputs()
    jp, tp = jnp.asarray(patch), torch.from_numpy(patch)
    if variant == "text":
        jkw = dict(text_ids=jnp.asarray(ids), text_padding_mask=jnp.asarray(pad))
        tkw = dict(text_ids=torch.from_numpy(ids).long(), text_padding_mask=torch.from_numpy(pad))
        ref = jmodel.apply(variables, jp, jkw["text_ids"], jkw["text_padding_mask"],
                           method=jmodel.forward_representation, deterministic=True)
    elif variant == "goal":
        jkw, tkw = dict(goal_patch=jnp.asarray(goal)), dict(goal_patch=torch.from_numpy(goal))
        ref = jmodel.apply(variables, jp, jkw["goal_patch"], method=jmodel.forward_gc_representations,
                           deterministic=True)
    else:
        jkw, tkw = {}, {}
        ref = jmodel.apply(variables, jp, None, None, method=jmodel.forward_representation, deterministic=True)
    return variables, tmodel, jp, tp, jkw, tkw, ref


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("text", [True, False], ids=["m3ae", "mae"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_equals_the_jax_pack(text, dtype):
    jmodel, variables, tmodel = make_pair(text=text, use_type=text)
    want = dict(_leaves(jinfer.pack_m3ae_params(variables, DEPTH, dtype=jnp.dtype(dtype))))
    got = dict(_leaves(tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH, dtype=getattr(torch, dtype))))
    assert set(got) == set(want)
    for name, w in want.items():
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype), name
        np.testing.assert_array_equal(got[name].float().numpy(), np.asarray(w.astype(jnp.float32)), err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_f32_matches_flax_and_the_jax_packed_path(variant):
    variables, tmodel, jp, tp, jkw, tkw, ref = _variant(variant)
    packed = tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH, dtype=torch.float32)
    got = tinfer.m3ae_encode(packed, tp, HEADS, compute_dtype=torch.float32, **tkw)
    jpacked = jinfer.pack_m3ae_params(variables, DEPTH, dtype=jnp.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    close(got, ref)
    close(got, jinfer.m3ae_encode(jpacked, jp, HEADS, compute_dtype=jnp.float32, **jkw))


def test_encode_f32_mae_and_intermediates():
    jmodel, variables, tmodel = make_pair(text=False, use_type=False)
    patch = inputs()[0]
    want, states = jmodel.apply(variables, jnp.asarray(patch), method=jmodel.forward_representation,
                                deterministic=True, capture_intermediates=True, mutable=["intermediates"])
    packed = tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH, dtype=torch.float32)
    got, inter = tinfer.m3ae_encode(packed, torch.from_numpy(patch), HEADS, compute_dtype=torch.float32,
                                    return_intermediates=True)
    close(got, want)
    assert inter.shape == (DEPTH, 3, NPATCH + 1, EMB)
    for i in range(DEPTH):
        close(inter[i], states["intermediates"]["encoder"][f"intermediate_layer_{i}"][0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_bf16_cosine(variant):
    variables, tmodel, jp, tp, jkw, tkw, ref = _variant(variant)
    got = tinfer.m3ae_encode(tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH), tp, HEADS, **tkw)
    want = jinfer.m3ae_encode(jinfer.pack_m3ae_params(variables, DEPTH), jp, HEADS, **jkw)
    assert got.dtype == torch.float32
    assert _cos(got.numpy(), ref) > 0.995
    assert _cos(got.numpy(), want) > 0.999  # the same recipe in the two packages


@pytest.mark.parametrize("variant", VARIANTS)
def test_calibration_amaxes(variant):
    """The calibration runs in bf16, where the two packages round in other places: 2%."""
    variables, tmodel, jp, tp, jkw, tkw, _ = _variant(variant)
    want = jax.device_get(jinfer.calibrate_m3ae(jinfer.pack_m3ae_params(variables, DEPTH), jp, HEADS, **{
        k: jkw.get(k) for k in ("text_ids", "text_padding_mask", "goal_patch")}))
    got = tinfer.calibrate_m3ae(tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH), tp, HEADS, **tkw)
    assert float(got["img"]) == float(want["img"])  # the input's own maximum: exact
    assert set(got["layers"]) == set(want["layers"]) == {"qkv", "attn_in", "attn_out", "fc", "proj"}
    for site, w in want["layers"].items():
        assert got["layers"][site].shape == (DEPTH,)
        np.testing.assert_allclose(got["layers"][site].numpy(), np.asarray(w), rtol=2e-2, err_msg=site)


def test_int8_pack_is_bit_equal_given_the_jax_amaxes():
    variables, tmodel, jp, _, _, _, _ = _variant("image")
    jpacked = jinfer.pack_m3ae_params(variables, DEPTH)
    amax = jax.device_get(jinfer.calibrate_m3ae(jpacked, jp, HEADS))
    want = dict(_leaves(jinfer.quantize_m3ae_packed(jpacked, amax)))
    got = dict(_leaves(tinfer.quantize_m3ae_packed(tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH), amax)))
    extra = {n for n in got if n.endswith("_qt")}  # the (N, K) copies kernel K2 reads
    assert set(got) - extra == set(want) and len(extra) == 5
    for name, w in want.items():
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype), name
        np.testing.assert_array_equal(got[name].float().numpy(), np.asarray(w.astype(jnp.float32)), err_msg=name)
    for name in extra:
        assert torch.equal(got[name], got[name[:-1]].transpose(-1, -2)) and got[name].is_contiguous()


def test_ln_quant_is_bit_equal_with_values_on_rounding_edges():
    """Rows of +-c have mean 0 and variance c^2 exactly, so with scale 0 the output is
    round(bias * inv): biases of k + 0.5 under a = 127 (inv = 1) sit on every rounding
    edge (half to even) and beyond the clip.  Random rows check the statistics."""
    rng = np.random.default_rng(0)
    d = 64
    x_edge = np.tile(np.array([1.5, -1.5], np.float32), (8, d // 2))
    bias_edge = (np.arange(d, dtype=np.float32) * 5 - 160) + 0.5  # -159.5 ... 155.5: ties, some clipped
    cases = [(x_edge, np.zeros(d, np.float32), bias_edge, np.float32(127.0)),
             (x_edge, np.full(d, 3.0, np.float32), bias_edge, np.float32(127.0))]
    for a in (0.7, 3.1, 1e-13):
        cases.append((rng.normal(size=(16, d)).astype(np.float32) * 2, 1 + 0.1 * rng.normal(size=d).astype(np.float32),
                      0.1 * rng.normal(size=d).astype(np.float32), np.float32(a)))
    for i, (x, s, b, a) in enumerate(cases):
        want = np.asarray(jvit._ln_quant(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(a), eps=1e-6))
        got = tvit._ln_quant(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), torch.tensor(a), eps=1e-6)
        assert got.dtype == torch.int8 and want.dtype == np.int8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"case {i}")
    got = tvit._ln_quant(torch.from_numpy(x_edge), torch.zeros(d), torch.from_numpy(bias_edge), torch.tensor(127.0))
    assert got[0, 32].item() == 0 and got[0, 33].item() == 6 and got[0, 34].item() == 10  # 0.5, 5.5, 10.5
    assert got.min().item() == -127 and got.max().item() == 127


@pytest.mark.parametrize("variant", VARIANTS)
def test_int8_cosine(variant):
    variables, tmodel, jp, tp, jkw, tkw, ref = _variant(variant)
    qpack = tinfer.build_m3ae_qpack(tmodel.state_dict(), DEPTH, HEADS, tp, **tkw)
    got = tinfer.m3ae_encode_int8(qpack, tp, HEADS, **tkw)
    want = jinfer.m3ae_encode_int8(jinfer.build_m3ae_qpack(variables, DEPTH, HEADS, jp, **jkw), jp, HEADS, **jkw)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _cos(got.numpy(), ref) > 0.98
    assert _cos(got.numpy(), want) > 0.995  # the same recipe in the two packages


@pytest.mark.parametrize("variant", VARIANTS)
def test_int8_attn_cosine(variant):
    variables, tmodel, jp, tp, jkw, tkw, ref = _variant(variant)
    qpack = tinfer.build_m3ae_qpack(tmodel.state_dict(), DEPTH, HEADS, tp, **tkw)
    got = tinfer.m3ae_encode_int8(qpack, tp, HEADS, int8_attn=True, score_dtype=torch.bfloat16, **tkw)
    base = tinfer.m3ae_encode_int8(qpack, tp, HEADS, score_dtype=torch.bfloat16, **tkw)
    assert _cos(got.numpy(), ref) > 0.97
    assert _cos(got.numpy(), base.numpy()) > 0.98


@pytest.mark.parametrize("int8_attn", [False, True])
def test_fuse_quant_body(int8_attn):
    """The body with explicit int8 tensors between the matmuls: close to the default body
    and to the JAX package's fuse_quant body (> 0.995), and within the int8 bound of float32."""
    variables, tmodel, jp, tp, jkw, tkw, ref = _variant("text")
    qpack = tinfer.build_m3ae_qpack(tmodel.state_dict(), DEPTH, HEADS, tp, **tkw)
    fused = tinfer.m3ae_encode_int8(qpack, tp, HEADS, fuse_quant=True, int8_attn=int8_attn, **tkw)
    plain = tinfer.m3ae_encode_int8(qpack, tp, HEADS, fuse_quant=False, int8_attn=int8_attn, **tkw)
    jq = jinfer.build_m3ae_qpack(variables, DEPTH, HEADS, jp, **jkw)
    want = jinfer.m3ae_encode_int8(jq, jp, HEADS, fuse_quant=True, int8_attn=int8_attn, **jkw)
    assert torch.isfinite(fused).all() and not torch.equal(fused, plain)
    assert _cos(fused.numpy(), plain.numpy()) > 0.995
    assert _cos(fused.numpy(), want) > 0.995
    assert _cos(fused.numpy(), ref) > (0.97 if int8_attn else 0.98)


def test_int8_attn_needs_the_attn_in_site():
    _, tmodel, _, tp, _, _, _ = _variant("image")
    packed = tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH)
    amax = tinfer.calibrate_m3ae(packed, tp, HEADS)
    amax["layers"] = {k: v for k, v in amax["layers"].items() if k != "attn_in"}
    qpack = tinfer.quantize_m3ae_packed(packed, amax)
    with pytest.raises(ValueError, match="attn_in"):
        tinfer.m3ae_encode_int8(qpack, tp, HEADS, int8_attn=True)
    assert tinfer.m3ae_encode_int8(qpack, tp, HEADS).shape == (3, NPATCH + 1, EMB)


def test_int8_intermediates_and_return_amax():
    _, tmodel, _, tp, _, _, _ = _variant("image")
    qpack, amax = tinfer.build_m3ae_qpack(tmodel.state_dict(), DEPTH, HEADS, tp, return_amax=True)
    out, inter = tinfer.m3ae_encode_int8(qpack, tp, HEADS, return_intermediates=True)
    assert inter.shape == (DEPTH, 3, NPATCH + 1, EMB) and inter.dtype == torch.bfloat16
    again = tinfer.quantize_m3ae_packed(tinfer.pack_m3ae_params(tmodel.state_dict(), DEPTH), amax)
    for (name, a), (_, b) in zip(_leaves(qpack), _leaves(again)):
        assert torch.equal(a, b), name


def test_int8_sites_run_through_the_fused_matmul(monkeypatch):
    """Every int8 site of both bodies goes through fused_int8_matmul (K2 on CUDA): 1 + 4 a layer,
    the fc site with the tanh-GELU epilogue."""
    _, tmodel, _, tp, _, _, _ = _variant("image")
    qpack = tinfer.build_m3ae_qpack(tmodel.state_dict(), DEPTH, HEADS, tp)
    calls = []
    real = tinfer.fused_int8_matmul
    monkeypatch.setattr(tinfer, "fused_int8_matmul",
                        lambda x, *a, act="none", **k: calls.append(act) or real(x, *a, act=act, **k))
    for fuse in (False, True):
        calls.clear()
        tinfer.m3ae_encode_int8(qpack, tp, HEADS, fuse_quant=fuse)
        assert len(calls) == 1 + 4 * DEPTH and calls.count("gelu_tanh") == DEPTH


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matmul_reference_tanh_gelu_is_the_jax_fc_site(dtype):
    """act = "gelu_tanh": the fc site of the JAX int8 forward (_qmatmul, float32 tanh-GELU, one
    rounding to bf16), within one bf16 ulp where the result is above 1e-3 and within 4e-6 below it:
    there, for inputs under -4, 1 + tanh cancels and the result hangs on the last bit of each
    package's tanh.  An unknown act raises."""
    import chip_smoke
    from arp_tpu_torch.ops import quantization

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(37, 96)) * 2).astype(np.float32)
    w = (rng.normal(size=(96, 40)) * 96 ** -0.5).astype(np.float32)
    bias = np.linspace(-9, 9, 40).astype(np.float32)  # both tails of the GELU
    wq, ws = quantization.quantize_array(torch.from_numpy(w))
    a = np.float32(np.abs(x).max() * 1.05)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    h = jvit._qmatmul(jx, jnp.asarray(a), jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()), jnp.asarray(bias))
    want = np.asarray(jax.nn.gelu(h, approximate=True).astype(jnp.bfloat16).astype(jnp.float32))
    got = tvit.fused_int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), torch.tensor(a), wq, ws,
                                 torch.from_numpy(bias), act="gelu_tanh")
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(want)
    large = want.abs() > 1e-3
    assert large.sum() > 500 and (~large).sum() > 100
    assert chip_smoke.bf16_ulps(got[large], want[large]) <= 1.0
    assert (got.float() - want)[~large].abs().max() <= 4e-6  # one bf16 ulp of 1e-3
    with pytest.raises(ValueError, match="act must be one of"):
        tvit.fused_int8_matmul(torch.from_numpy(x), torch.tensor(a), wq, ws, None, act="gelu")
