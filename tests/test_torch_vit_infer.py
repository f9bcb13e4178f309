"""Port packed ViT encode (arp_tpu_torch/ops/vit_infer.py) against arp_tpu/ops/vit_infer.py.

Same Flax weights (TINY_CLIP_CFG) and numpy-seeded patches through both.
Bounds, each the JAX package's own where it has one:

  * the pack: bit-equal; ``quantize_packed`` fed JAX's amaxes: bit-equal q,
    ws and site scales;
  * ``vit_encode`` float32: atol/rtol 2e-5 (tests/test_vit_infer.py:41),
    intermediates included; bf16, and bf16 scores: cosine >= 0.999 to JAX bf16;
  * ``calibrate_vit``: amaxes within two bf16 ulps (rtol 2^-6).  An amax is
    an element of a bf16 tensor, and XLA's CPU backend keeps excess precision
    between bf16 ops where torch rounds each one, so the two forwards can
    land whole ulps apart (measured: the layer sites equal, ``final`` 2 ulps);
  * ``fused_int8_matmul`` plain vs JAX's Pallas kernel in interpret mode:
    one bf16 ulp (rtol 8e-3, atol 1e-6);
  * ``vit_encode_int8``: cosine >= 0.999 against JAX ``impl="pallas"`` and
    ``impl="xla"`` (the JAX package's pallas-vs-xla bound,
    tests/test_vit_infer.py:206).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arp_tpu.ops.vit_infer as jv
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE
from arp_tpu_torch.ops import vit_infer as tv
from tests.test_torch_clip import _flax_and_port

N_LAYERS = TINY_CLIP_CFG["vision_num_layers"]
HEADS = TINY_CLIP_CFG["vision_features"] // 64
PATCH = TINY_CLIP_CFG["vision_patch_size"]
N_PATCHES = (TINY_CLIP_IMG_SIZE // PATCH) ** 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def towers():
    """(Flax variables, port CLIP, patches as numpy) on the same weights."""
    _, variables, port, _, _ = _flax_and_port(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 1, seed=0)
    patches = np.random.default_rng(0).normal(size=(4, N_PATCHES, PATCH * PATCH * 3)).astype(np.float32)
    return variables, port.eval(), patches


def _np(x):
    """torch or jax array -> float32 numpy (bf16 widened exactly), ints as they are."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or str(x.dtype) == "bfloat16" else x


def _assert_trees_bit_equal(port_tree, jax_tree, skip=()):
    for key, want in jax_tree.items():
        if key in skip:
            continue
        got = port_tree[key]
        if isinstance(want, dict):
            _assert_trees_bit_equal(got, want, skip)
            continue
        assert got.dtype == {jnp.dtype("float32"): torch.float32, jnp.dtype("bfloat16"): torch.bfloat16,
                             jnp.dtype("int8"): torch.int8}[jnp.asarray(want).dtype], key
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=key)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pack_is_bit_equal_to_jax(towers, dtype):
    variables, port, _ = towers
    jd, td = DTYPES[dtype]
    want = jv.pack_vit_params(variables, N_LAYERS, dtype=jd)
    got = tv.pack_vit_params(port.visual, dtype=td)
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    _assert_trees_bit_equal(got, want)


def test_vit_encode_f32_matches_jax_with_intermediates(towers):
    variables, port, patches = towers
    want, want_inter = jv.vit_encode(jv.pack_vit_params(variables, N_LAYERS, dtype=jnp.float32),
                                     jnp.asarray(patches), HEADS, compute_dtype=jnp.float32,
                                     return_intermediates=True)
    got, inter = tv.vit_encode(tv.pack_vit_params(port.visual, torch.float32), torch.from_numpy(patches),
                               HEADS, compute_dtype=torch.float32, return_intermediates=True)
    assert got.dtype == inter.dtype == torch.float32 and inter.shape == (N_LAYERS, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(inter.numpy(), np.asarray(want_inter), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tv.vit_encode(tv.pack_vit_params(port.visual, torch.float32),
                                             torch.from_numpy(patches), HEADS, compute_dtype=torch.float32).numpy(),
                               got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("score", ["float32", "bfloat16"])
def test_vit_encode_bf16_close_to_jax_bf16(towers, score):
    variables, port, patches = towers
    want = jv.vit_encode(jv.pack_vit_params(variables, N_LAYERS), jnp.asarray(patches), HEADS,
                         score_dtype=DTYPES[score][0])
    got = tv.vit_encode(tv.pack_vit_params(port.visual), torch.from_numpy(patches), HEADS,
                        score_dtype=DTYPES[score][1])
    assert got.dtype == torch.float32
    assert _cos(got.numpy(), want) >= 0.999, _cos(got.numpy(), want)


@pytest.fixture(scope="module")
def calibrated(towers):
    """JAX's bf16 pack, amaxes and int8 pack, and the port's bf16 pack."""
    variables, port, patches = towers
    jpack = jv.pack_vit_params(variables, N_LAYERS)
    amax = jax.tree_util.tree_map(np.asarray, jv.calibrate_vit(jpack, jnp.asarray(patches), HEADS))
    return jpack, amax, jv.quantize_packed(jpack, amax), tv.pack_vit_params(port.visual)


def test_calibration_matches_jax(towers, calibrated):
    _, _, patches = towers
    _, want, _, tpack = calibrated
    got = tv.calibrate_vit(tpack, torch.from_numpy(patches), HEADS)
    assert set(got["layers"]) == set(want["layers"]) == {"qkv", "attn_in", "attn_out", "fc", "proj"}
    np.testing.assert_array_equal(got["conv1"].numpy(), want["conv1"])  # the same bf16 patches
    np.testing.assert_allclose(got["final"].numpy(), want["final"], rtol=2.0 ** -6)
    for site, v in want["layers"].items():
        assert got["layers"][site].shape == (N_LAYERS,)
        np.testing.assert_allclose(got["layers"][site].numpy(), v, rtol=2.0 ** -6, err_msg=site)


def test_quantize_packed_with_jax_amaxes_is_bit_equal(calibrated):
    _, amax, want, tpack = calibrated
    got = tv.quantize_packed(tpack, amax)
    assert set(got) - set(want) == {"conv1_qt", "proj_qt"}
    assert set(got["layers"]) - set(want["layers"]) == {"wqkv_qt", "wout_qt", "wfc_qt", "wproj_qt"}
    _assert_trees_bit_equal(got, want)
    for tree in (got, got["layers"]):
        for key in [k for k in tree if k.endswith("_qt")]:
            assert torch.equal(tree[key], tree[key[:-1]].transpose(-1, -2)) and tree[key].is_contiguous()


def _fused_inputs(m, k, n, x_dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, ws = jv._quant_w(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)))
    a = np.float32(np.abs(x).max() * 0.9)  # some entries clip at +-127
    bias = rng.normal(size=(1, n)).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[x_dtype][0])
    tx = torch.from_numpy(x).to(DTYPES[x_dtype][1])
    return (jx, jnp.asarray(a), wq, ws, jnp.asarray(bias)), (
        tx, torch.tensor(a), torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(ws)), torch.from_numpy(bias))


@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["none", "quickgelu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_int8_matmul_plain_matches_the_pallas_kernel(x_dtype, act, with_bias):
    jargs, targs = _fused_inputs(37, 64, 48, x_dtype, seed=1)  # M = 37: ragged against block_m 16
    if not with_bias:
        jargs, targs = jargs[:4] + (None,), targs[:4] + (None,)
    want = jv.fused_int8_matmul(*jargs, act=act, block_m=16, interpret=True)
    got = tv.fused_int8_matmul(*targs, act=act)
    assert got.dtype == torch.bfloat16 and got.shape == (37, 48)
    np.testing.assert_allclose(_np(got), _np(want), rtol=8e-3, atol=1e-6)


def test_fused_int8_matmul_rounds_ties_to_even():
    """a = 127 makes x * 127/a = x, so x = k + 0.5 is a tie; an identity weight reads q back."""
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, -125.5], dtype=torch.float32)
    x = ties.repeat(4).reshape(1, 32)
    wq = torch.eye(32, dtype=torch.int8)
    out = tv.fused_int8_matmul(x, torch.tensor(127.0), wq, torch.ones(1, 32))
    want = torch.round(x)  # half to even
    assert torch.equal(out.float(), want)
    assert out[0, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def test_activation_quantization_is_bit_equal_to_jax():
    """int8 values of x * 127/a, for many scales a: the division must be one IEEE division, as in JAX."""
    rng = np.random.default_rng(7)
    for a in rng.uniform(0.5, 12.0, size=40).astype(np.float32):
        # x right at the rounding edges k + 1/2, and its float32 neighbours: an
        # inv one ulp off moves these across
        edge = (np.arange(-127, 127) + 0.5).astype(np.float32) / (np.float32(127.0) / a)
        x = np.concatenate([edge, np.nextafter(edge, np.inf), np.nextafter(edge, -np.inf),
                            rng.normal(size=256).astype(np.float32) * a / 2])
        want = jnp.clip(jnp.round(jnp.asarray(x) * (127.0 / jnp.maximum(jnp.float32(a), 1e-12))), -127, 127)
        got = tv._quantize_x(torch.from_numpy(x), torch.tensor(a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(a))


@pytest.mark.parametrize("k", [64, 1000, 3072])
def test_chunked_f32_int8_dot_is_exact(k):
    """The float32 route the card takes equals the int32 matmul, also at the extremes (all +-127)."""
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.integers(-127, 128, size=(33, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, size=(k, 40)).astype(np.int8))
    q[0], w[:, 0] = 127, 127
    q[1], w[:, 1] = -127, 127
    want = torch.matmul(q.to(torch.int32), w.to(torch.int32))
    got = tv.int8_dot(q, w)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert got[0, 0] == k * 127 * 127


@pytest.mark.parametrize("score", ["float32", "bfloat16"])
def test_int8_attention_matches_jax(score):
    """Bound: the integer products are exact in both, but the two softmaxes round
    differently (XLA's bf16 elementwise chain vs torch's float32-internal
    softmax), so a probability sitting on a 1/127 rounding edge can quantize
    one step apart: each such flip moves an output by a_in/127^2 * |v8| <= a_in/127.
    Held to 2 such steps absolute and a mean error 20x smaller."""
    rng = np.random.default_rng(5)
    b, n, d = 2, 17, 128
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3))
    a_in = np.float32(max(np.abs(t).max() for t in (q, k, v)))
    jd, td = DTYPES[score]
    want = jv._attention_int8(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), 2, jnp.asarray(a_in), jd)
    got = tv._attention_int8(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)), 2, torch.tensor(a_in), td)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, d)
    err = np.abs(_np(got) - _np(want))
    step = a_in / 127.0
    assert err.max() <= 2 * step, (err.max(), step)
    assert err.mean() <= step / 10, (err.mean(), step)


def test_int8_attention_refuses_what_float32_cannot_hold_exactly():
    t = torch.zeros(1, tv.INT8_ATTN_MAX_TOKENS + 1, 64)
    with pytest.raises(ValueError, match="exact"):
        tv._attention_int8(t, t, t, 1, torch.tensor(1.0))


@pytest.mark.parametrize("int8_attn", [False, True], ids=["bf16_attn", "int8_attn"])
def test_vit_encode_int8_matches_jax(towers, calibrated, int8_attn):
    _, _, patches = towers
    _, amax, jq, tpack = calibrated
    tq = tv.quantize_packed(tpack, amax)
    x = torch.from_numpy(patches)
    got, inter = tv.vit_encode_int8(tq, x, HEADS, score_dtype=torch.bfloat16, int8_attn=int8_attn,
                                    return_intermediates=True)
    assert got.dtype == torch.float32 and got.shape == (4, TINY_CLIP_CFG["embed_dim"])
    assert inter.shape == (N_LAYERS, 4, 64)
    for impl, extra in (("pallas", dict(interpret=True, unroll=True)), ("xla", {})):
        want = jv.vit_encode_int8(jq, jnp.asarray(patches), HEADS, impl=impl, score_dtype=jnp.bfloat16,
                                  int8_attn=int8_attn, **extra)
        assert _cos(got.numpy(), want) >= 0.999, (impl, _cos(got.numpy(), want))


def test_int8_attention_needs_the_attn_in_site(towers, calibrated):
    _, _, patches = towers
    _, amax, _, tpack = calibrated
    amax = dict(amax, layers={k: v for k, v in amax["layers"].items() if k != "attn_in"})
    qpack = tv.quantize_packed(tpack, amax)
    assert "a_attn_in" not in qpack["layers"]
    with pytest.raises(ValueError, match="attn_in"):
        tv.vit_encode_int8(qpack, torch.from_numpy(patches), HEADS, int8_attn=True)
    tv.vit_encode_int8(qpack, torch.from_numpy(patches), HEADS)  # the bf16-attention int8 path still runs


def test_fused_int8_matmul_refuses_other_devices_and_acts():
    x = torch.zeros(2, 32)
    args = (torch.tensor(1.0), torch.zeros(32, 8, dtype=torch.int8), torch.ones(1, 8))
    with pytest.raises(ValueError, match="act"):
        tv.fused_int8_matmul(x, *args, act="gelu")
    with pytest.raises(ValueError, match="device"):
        tv.fused_int8_matmul(x.to("meta"), *args)


# --- the route kernel K2 takes, by shape (mirrors make_plan in csrc/int8_gemm.cu) -------------

@pytest.mark.parametrize("m,k,n,x_bytes,want", [
    # ViT-B/16 at batch 256: more row panels (394) than SMs, so a unit is a whole panel
    (50432, 768, 3072, 2, dict(route="resident", n_per_unit=12, groups=1, units=394)),
    (50432, 768, 2304, 2, dict(route="resident", n_per_unit=9, groups=1, units=394)),
    (50432, 768, 768, 2, dict(route="resident", n_per_unit=3, groups=1, units=394)),
    (50176, 768, 768, 4, dict(route="resident", n_per_unit=3, groups=1, units=392)),
    # K beyond twelve 64-deep tiles: one 128 x 256 tile a unit
    (50432, 3072, 768, 2, dict(route="streaming", n_per_unit=1, groups=3, units=1182)),
    (50432, 832, 768, 2, dict(route="streaming", n_per_unit=1, groups=3, units=1182)),
    # few panels: the column tiles are cut so that the SMs have work
    (256, 768, 512, 2, dict(route="resident", n_per_unit=1, groups=2, units=4)),
    (8192, 768, 3072, 2, dict(route="resident", n_per_unit=6, groups=2, units=128)),
    (5000, 768, 3072, 2, dict(route="resident", n_per_unit=4, groups=3, units=120)),
    # ragged shapes round up
    (1, 32, 8, 2, dict(route="resident", n_per_unit=1, groups=1, units=1)),
    (129, 96, 264, 4, dict(route="resident", n_per_unit=1, groups=2, units=4)),
    (129, 800, 520, 2, dict(route="streaming", n_per_unit=1, groups=3, units=6)),
])
def test_k2_plan_routes_by_shape(m, k, n, x_bytes, want):
    plan = tv.k2_plan(m, k, n, x_bytes, sms=132)
    assert {key: plan[key] for key in want} == want
    panels = -(-m // 128)
    assert plan["units"] == panels * plan["groups"]
    assert plan["groups"] * plan["n_per_unit"] >= -(-n // 256) > (plan["groups"] - 1) * plan["n_per_unit"]
    # x once a unit of a panel, the weight once a panel
    assert plan["l2_bytes"] == m * k * x_bytes * plan["groups"] + n * k * panels


def test_k2_plan_cuts_a_panel_only_to_give_idle_sms_work():
    for sms in (1, 8, 132, 1000):
        for m in (1, 128, 1000, 20000):
            plan = tv.k2_plan(m, 768, 3072, 2, sms=sms)
            panels = -(-m // 128)
            if panels >= sms:
                assert plan["groups"] == 1  # x is quantized once
            else:
                assert panels < plan["units"] <= sms
