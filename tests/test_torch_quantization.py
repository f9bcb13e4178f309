"""Port int8 weight quantization (arp_tpu_torch/ops/quantization.py) against arp_tpu's.

``quantize_array`` must give JAX's q and scales bit for bit, half-way ties
included (both round half to even).  ``int8_matmul``'s plain version is held
to JAX ``int8_matmul`` run through its Pallas kernel in interpret mode: atol
1e-4 in float32 (both sum 128 float32 products, in other orders) and rtol
8e-3 in bf16 (one bf16 ulp: both round the same float32 sum once).  The
port's ``quantize_linears`` must quantize exactly ``quantize_tree``'s leaves,
and the quantized port CLIP must give the Flax CLIP's features on the
dequantized tree at atol 1e-5.

Kernel K3 on the card computes ``(sum_k x q) * scale`` with x as three exact
bf16 pieces; ``split_bf16x3`` and ``int8_matmul_split_reference`` are that
arithmetic in plain PyTorch.  The split must be exact bit for bit and every
piece x weight product exact in float32; the split reference is held to
``int8_matmul_reference`` and to the Pallas kernel at 1e-5 of the largest
output: every product is exact in both, so they differ only by where the
float32 roundings of K sums fall (~sqrt(K) * 2^-24 of the largest, 2e-6 at
K = 768).  With bf16 x both round the float32 sum to bf16 once, and sums that
differ in their last float32 bits can round to neighbouring bf16 values: one
bf16 rounding of the largest output (2^-8) is added.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arp_tpu.ops.quantization as jq
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE
from arp_tpu_torch.ops import quantization as tq
from tests.test_torch_clip import _flax_and_port


def _bits(x):
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("shape,axis", [((256, 128), 0), ((3, 96, 40), -2), ((64, 48), 1)])
def test_quantize_array_is_bit_equal_to_jax(shape, axis):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jqv, js = jq.quantize_array(jnp.asarray(w), axis=axis)
    q, s = tq.quantize_array(torch.from_numpy(w), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))


def test_quantize_array_rounds_ties_to_even():
    """A column whose absmax is 127 has scale 1, so w / scale lands exactly on k + 0.5."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.0, 127.0], np.float32)
    w = np.stack([ties, ties[::-1]], axis=1)  # (10, 2), absmax 127 in both columns
    jqv, js = jq.quantize_array(jnp.asarray(w))
    q, s = tq.quantize_array(torch.from_numpy(w))
    np.testing.assert_array_equal(s.numpy(), np.ones((1, 2), np.float32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(q.numpy()[:, 0], [0, 2, 2, 0, -2, -2, 126, -126, 3, 127])


def test_zero_column_has_scale_one():
    w = np.zeros((8, 3), np.float32)
    w[:, 1] = np.linspace(-1, 1, 8)
    q, s = tq.quantize_array(torch.from_numpy(w))
    assert s[0, 0] == 1.0 and s[0, 2] == 1.0
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(jq.quantize_array(jnp.asarray(w))[1]))
    assert not q[:, 0].any()


def test_dequantize_and_error_match_jax():
    w = np.random.default_rng(1).normal(size=(96, 200)).astype(np.float32)
    q, s = tq.quantize_array(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.dequantize_array(q, s).numpy(),
                                  np.asarray(jq.dequantize_array(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))))
    assert tq.quantization_error(torch.from_numpy(w)) == pytest.approx(jq.quantization_error(jnp.asarray(w)), rel=1e-5)


@pytest.fixture
def pallas_int8_matmul(monkeypatch):
    """JAX int8_matmul forced through its Pallas kernel, in interpret mode (as tests/test_quantization.py)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    orig = jq.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jq.pl, "pallas_call", interp)
    return jq.int8_matmul


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_the_pallas_kernel(pallas_int8_matmul, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(70, 128)).astype(np.float32)  # ragged M
    w = rng.normal(size=(128, 130)).astype(np.float32)  # ragged N
    jqv, js = jq.quantize_array(jnp.asarray(w))
    want = np.asarray(pallas_int8_matmul(jnp.asarray(x, getattr(jnp, dtype)), jqv, js).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq.int8_matmul(tx, torch.from_numpy(np.asarray(jqv)), torch.from_numpy(np.asarray(js)))
    assert got.dtype == tx.dtype and got.shape == (70, 130)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=1e-6)


def test_int8_matmul_refuses_other_devices():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        tq.int8_matmul(x, torch.zeros(4, 3, dtype=torch.int8), torch.ones(1, 3))


def _quantized_paths(cfg, min_size):
    _, variables, _, _, _ = _flax_and_port(cfg, TINY_CLIP_IMG_SIZE, 1, seed=3)
    qtree, dequant = jq.quantize_tree(variables, min_size=min_size)
    flat = jax.tree_util.tree_flatten_with_path(
        qtree, is_leaf=lambda l: isinstance(l, dict) and set(l) == {"q", "scale"})[0]
    quantized = {".".join(str(k.key) for k in path[1:-1]): leaf for path, leaf in flat
                 if isinstance(leaf, dict) and set(leaf) == {"q", "scale"}}
    return variables, qtree, dequant, quantized


@pytest.mark.parametrize("min_size", [1024, 2048])
def test_quantize_linears_matches_quantize_tree(min_size):
    """The same leaves (both towers, conv1, proj and text_projection included), bit-equal q and scale."""
    from arp_tpu_torch.models.clip import CLIP, flax_to_torch

    variables, _, _, quantized = _quantized_paths(TINY_CLIP_CFG, min_size)
    port = CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE)
    port.load_state_dict(flax_to_torch(variables))
    names = tq.quantize_linears(port, min_size=min_size)
    assert set(names) == set(quantized)
    if min_size == 1024:
        assert {"visual.conv1", "visual.proj", "text.text_projection"} <= set(names)
    for name in names:
        mod = port.get_submodule(name)
        assert isinstance(mod, tq.QuantLinear)
        np.testing.assert_array_equal(mod.q.numpy(), np.asarray(quantized[name]["q"]))
        np.testing.assert_array_equal(_bits(mod.scale.numpy()), _bits(quantized[name]["scale"]))
    left = [n for n, m in port.named_modules() if isinstance(m, torch.nn.Linear)]
    assert all(port.get_submodule(n).weight.numel() < min_size for n in left)


def test_quantized_port_clip_matches_flax_on_the_dequantized_tree():
    from arp_tpu_torch.models.clip import CLIP, flax_to_torch

    model, variables, _, images, tokens = _flax_and_port(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 3, seed=4)
    qtree, dequant = jq.quantize_tree(variables)
    restored = dequant(qtree)
    port = CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE)
    port.load_state_dict(flax_to_torch(variables))
    tq.quantize_linears(port)
    with torch.no_grad():
        img = port.encode_image(torch.from_numpy(images), normalize=False).numpy()
        txt = port.encode_text(torch.from_numpy(tokens).long(), normalize=False).numpy()
    want_img = model.apply(restored, jnp.asarray(images), normalize=False, method=model.encode_image)
    want_txt = model.apply(restored, jnp.asarray(tokens), normalize=False, method=model.encode_text)
    np.testing.assert_allclose(img, np.asarray(want_img), atol=1e-5, rtol=0)
    np.testing.assert_allclose(txt, np.asarray(want_txt), atol=1e-5, rtol=0)


def test_quant_linear_keeps_float32_scales_when_cast():
    lin = torch.nn.Linear(64, 32)
    ql = tq.QuantLinear(lin)
    scale = ql.scale.clone()
    ql.to(torch.bfloat16)
    assert ql.scale.dtype == torch.float32 and torch.equal(ql.scale, scale)
    assert ql.q.dtype == torch.int8 and ql.bias.dtype == torch.bfloat16
    x = torch.randn(5, 7, 64, dtype=torch.bfloat16)
    out = ql(x)
    assert out.shape == (5, 7, 32) and out.dtype == torch.bfloat16


SPLIT_REL = 1e-5  # of the largest output: float32 rounding order only (module docstring)
BF16_ROUNDING = 2.0 ** -8  # one bf16 rounding of the largest output


def _split_inputs():
    rng = np.random.default_rng(5)
    ties = (np.arange(1, 257, dtype=np.float32) + 256.0) * np.float32(2.0 ** -8)  # 1 + j/256: odd j are bf16 ties
    return {
        "normal": rng.standard_normal(4096).astype(np.float32),
        "bf16_ties": np.concatenate([ties, -ties, ties * np.float32(2.0 ** 40), ties * np.float32(2.0 ** -40)]),
        "zero": np.array([0.0], np.float32),
        "large": (rng.standard_normal(1024) * 1e30).astype(np.float32),
        "small": (rng.standard_normal(1024) * 1e-25).astype(np.float32),  # above 2^-102: no subnormal piece
        "all_mantissa_bits": np.array([16777215.0, -16777215.0, 1.9999999, 1.0000001, 3.0e38], np.float32),
    }


@pytest.mark.parametrize("case", list(_split_inputs()))
def test_split_bf16x3_is_exact(case):
    x = torch.from_numpy(_split_inputs()[case])
    hi, mid, lo = tq.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.float() + mid.float() + lo.float()  # both partial sums are exact in float32
    np.testing.assert_array_equal(_bits(total.numpy()), _bits(x.numpy()))
    np.testing.assert_array_equal(hi.float().numpy(), x.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("case", ["normal", "bf16_ties", "large", "small", "all_mantissa_bits"])
def test_split_pieces_times_int8_are_exact_in_float32(case):
    """8 significant bits x 7 bits: the float32 product equals the float64 product."""
    x = torch.from_numpy(_split_inputs()[case])
    if case == "large":
        x = x / 256  # |x| * 127 must stay finite in float32
    if case == "all_mantissa_bits":
        x = x[:4]
    q = torch.arange(-127, 128, dtype=torch.int8)
    for piece in tq.split_bf16x3(x):
        prod32 = piece.float()[:, None] * q.float()[None, :]
        prod64 = piece.double()[:, None] * q.double()[None, :]
        assert torch.isfinite(prod32).all()
        assert torch.equal(prod32.double(), prod64)


def test_split_bf16x3_of_minus_zero_is_zero():
    """-0.0 comes back as +0.0 (hi = -0, the other pieces +0): equal in value, which is all a product needs."""
    pieces = tq.split_bf16x3(torch.tensor([-0.0]))
    assert all(float(p) == 0.0 for p in pieces)


def _split_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    q, s = tq.quantize_array(torch.from_numpy(w))
    return x, q, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 768, 3072), (64, 3072, 768), (70, 128, 130), (5, 33, 8)])
def test_split_reference_matches_plain_reference(m, k, n, dtype):
    x, q, s = _split_case(m, k, n, seed=m + k + n)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = tq.int8_matmul_reference(tx, q, s).float()
    got = tq.int8_matmul_split_reference(tx, q, s)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    rel = SPLIT_REL + (BF16_ROUNDING if dtype == "bfloat16" else 0.0)
    assert (got.float() - want).abs().max() <= rel * want.abs().max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_reference_matches_the_pallas_kernel(pallas_int8_matmul, dtype):
    x, q, s = _split_case(70, 128, 130, seed=6)  # ragged M and N
    want = np.asarray(pallas_int8_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(q.numpy()),
                                         jnp.asarray(s.numpy())).astype(jnp.float32))
    got = tq.int8_matmul_split_reference(torch.from_numpy(x).to(getattr(torch, dtype)), q, s).float().numpy()
    rel = SPLIT_REL + (BF16_ROUNDING if dtype == "bfloat16" else 0.0)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_split_reference_scales_the_sum_once():
    """One column with a scale that is no power of two: the scale multiplies the float32 sum, not each weight."""
    x = torch.tensor([[1.0, 2.0, 3.0]])
    q = torch.tensor([[3], [5], [7]], dtype=torch.int8)
    scale = torch.tensor([[0.1]])
    want = (torch.tensor(1.0 * 3 + 2.0 * 5 + 3.0 * 7) * scale[0, 0]).item()
    assert tq.int8_matmul_split_reference(x, q, scale).item() == want
