"""Cases of the PyTorch port that need an NVIDIA GPU: kernels K1, K2 and K3, the resize on the card, the CUDA engines.

Each is marked ``gpu`` and skips where ``torch.cuda.is_available()`` is
False.  This file imports no JAX, so it also runs on a GPU machine without
JAX; tests/conftest.py does import JAX, so there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 against the plain attention at 1e-4 in float32 (the two sum in
other orders) and 2e-2 in bfloat16 (K1 multiplies bf16 operands on the tensor
cores with float32 sums, rounds P to bf16 as the plain version does, and
rounds its output to bf16); K2 within
one bf16 ulp of its plain version (equal int8 values and int32 sums; only the
quick-GELU's exp and the tanh-GELU's tanh may differ; below -4, where the tanh-GELU's
1 + tanh cancels, in units of 2^-20) and ties rounded to even exactly; K3 within 1e-4
of the largest output in float32 (sums in other orders), and in bf16 that
plus one bf16 rounding of it (2^-7); K3 in float32 against the plain version
of its own arithmetic (``int8_matmul_split_reference``) at K / 4 units of
2^-23 of the largest output: every product is exact in both, each of K3's
3 K / 16 wgmma steps may drop up to one unit in the last place of the running
sum where a float32 add rounds, and the plain version's own roundings take
the rest (measured ~10x below); the resize byte-exact; engine rewards against the CPU engine at MAE 1e-4
in float32 and chip_smoke's bf16 / int8 bounds otherwise.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from arp_tpu_torch.models.clip import CLIP, Char97Tokenizer, flax_to_torch
from arp_tpu_torch.ops import attention as attn
from arp_tpu_torch.ops import preprocess, quantization, vit_infer
from arp_tpu_torch.ops.masks import MaskSpec
from arp_tpu_torch.reward.engine import ClipRewardEngine

pytestmark = pytest.mark.gpu

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TINY = dict(embed_dim=32, vocab_size=97, vision_num_layers=2, vision_features=64,
            vision_patch_size=8, text_features=64, text_num_heads=1, text_num_layers=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, shape, device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device, dtype) for _ in range(3)]


def _padding(b, n, device):
    lengths = torch.linspace(1, n, b).round().long()
    return (torch.arange(n)[None, :] >= lengths[:, None]).to(device)


def _check_k1(q, k, v, spec, pad):
    got = attn.dot_product_attention(q, k, v, spec, pad)
    want = attn.reference_attention(q.float(), k.float(), v.float(), spec, pad)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, atol=ATOL[q.dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["none", "causal", "dt"])
def test_kernel_matches_plain_attention(cuda, kind, dtype):
    q, k, v = _qkv(0, (3, 197, 4, 64), cuda, dtype)
    launches = attn.flash_attention_fwd.launches
    _check_k1(q, k, v, MaskSpec(kind, 2, 4), _padding(3, 197, cuda))
    assert attn.flash_attention_fwd.launches == launches + 1


@pytest.mark.parametrize("head_dim", [32, 128])
@pytest.mark.parametrize("n", [1, 65, 129, 257])
def test_kernel_head_dims_and_ragged_n(cuda, head_dim, n):
    q, k, v = _qkv(1, (2, n, 2, head_dim), cuda)
    _check_k1(q, k, v, MaskSpec("causal"), _padding(2, n, cuda))


@pytest.mark.parametrize("head_dim", [32, 128])
@pytest.mark.parametrize("n", [1, 65, 129, 257])
def test_kernel_bf16_head_dims_and_ragged_n(cuda, head_dim, n):
    q, k, v = _qkv(1, (2, n, 2, head_dim), cuda, torch.bfloat16)
    _check_k1(q, k, v, MaskSpec("causal"), _padding(2, n, cuda))
    _check_k1(q, k, v, MaskSpec("none"), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("kind", ["causal", "dt"])
def test_kernel_n_beyond_the_shared_memory_ring(cuda, kind, head_dim, dtype):
    """513 keys are nine key tiles: the ring of K/V stages wraps, and causal and dt exit early."""
    q, k, v = _qkv(5, (2, 513, 2, head_dim), cuda, dtype)
    _check_k1(q, k, v, MaskSpec(kind, 2, 4), None)
    _check_k1(q, k, v, MaskSpec(kind, 2, 4), _padding(2, 513, cuda))


def test_kernel_bf16_reads_rows_off_16_byte_boundaries(cuda):
    """A head slice that starts 4 bytes into a row: the copies go element by element."""
    qkv = torch.randn(2, 77, 3, 8, 68, device=cuda).to(torch.bfloat16)[..., 2:66]
    q, k, v = qkv.unbind(2)
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    _check_k1(q, k, v, MaskSpec("causal"), _padding(2, 77, cuda))


def test_kernel_reads_strided_heads(cuda):
    """q, k, v as views of one packed (B, N, 3, H, D) projection: no copy needed."""
    qkv = torch.randn(2, 77, 3, 8, 64, device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _check_k1(q, k, v, MaskSpec("causal"), _padding(2, 77, cuda))


def test_kernel_fully_masked_row_is_mean_of_v(cuda):
    q, k, v = _qkv(2, (2, 150, 2, 64), cuda)
    pad = torch.zeros(2, 150, dtype=torch.bool, device=cuda)
    pad[0] = True
    for kind in ("none", "causal", "dt"):
        out = attn.flash_attention_fwd(q, k, v, MaskSpec(kind, 2, 4), pad)
        torch.testing.assert_close(out[0], v[0].mean(0, keepdim=True).expand_as(out[0]), atol=1e-5, rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(3, (1, 16, 2, 48), cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_attention_fwd(q, k, v)
    q, k, v = _qkv(3, (1, 16, 2, 64), cuda, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn.flash_attention_fwd(q, k, v)
    q, k, v = (x.transpose(-1, -2) for x in _qkv(3, (1, 16, 64, 64), cuda))
    with pytest.raises(ValueError, match="last dim"):
        attn.flash_attention_fwd(q, k, v)
    q, k, v = _qkv(3, (1, 16, 2, 64), cuda)
    with pytest.raises(ValueError, match="kv_padding"):
        attn.flash_attention_fwd(q, k, v, kv_padding=torch.zeros(1, 15, device=cuda))
    with pytest.raises(NotImplementedError):
        attn.dot_product_attention(q, k, v, bias=torch.zeros(1, 2, 16, 16, device=cuda))


@pytest.mark.parametrize("size", [256, 64])
def test_resize_is_byte_exact_on_the_card(cuda, size):
    frames = np.random.default_rng(size).integers(0, 256, size=(4, size, size, 3), dtype=np.uint8)
    packed = torch.from_numpy(frames.reshape(4, size, size * 3)).to(cuda)
    got = preprocess.resize_bicubic_pil_packed(packed, 3, 224, 224).cpu().numpy()
    want = preprocess.resize_bicubic_pil_reference(frames, 224, 224).reshape(4, 224, 672)
    np.testing.assert_array_equal(got, want)


def test_resize_refuses_tf32(cuda):
    packed = torch.zeros(1, 64, 192, dtype=torch.uint8, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            preprocess.resize_bicubic_pil_packed(packed, 3, 32, 32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_cuda_engine_matches_cpu_engine(cuda):
    state = flax_to_torch(chip_smoke.random_clip_variables(TINY, 32, seed=3))

    def engine(device):
        model = CLIP(**TINY, image_size=32)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=8, tokenizer=Char97Tokenizer(), device=device)

    frames = np.random.default_rng(4).integers(0, 256, size=(13, 48, 48, 3), dtype=np.uint8)
    want = engine("cpu").text_rewards(frames, "collect the coin.")
    attn.flash_attention_fwd.launches = 0
    got = engine(cuda).text_rewards(frames, "collect the coin.")
    assert attn.flash_attention_fwd.launches > 0
    assert np.abs(got - want).mean() <= 1e-4


def test_chip_smoke_profile_sees_device_kernels(cuda):
    a = torch.randn(512, 512, device=cuda)
    report = chip_smoke.device_profile(lambda: [a @ a for _ in range(10)])
    assert report["kernel_ms"].get("gemm", 0) > 0
    assert 0 < sum(report["top_kernels_ms"].values()) <= sum(report["kernel_ms"].values()) + 1e-9
    assert 0 < report["device_busy_ms"] <= report["wall_ms"]


def _k2_inputs(cuda, m, k, n, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return chip_smoke.k2_inputs(m, k, n, dtype, gen, quantization)


@pytest.mark.parametrize("act", ["none", "quickgelu", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 512), (64, 8)])
def test_k2_matches_plain(cuda, k, n, dtype, act):
    x, a, wq, ws, bias, wq_t = _k2_inputs(cuda, 1003, k, n, dtype)  # M = 1003: ragged
    launches = vit_infer.fused_int8_matmul.launches
    got = vit_infer.fused_int8_matmul(x, a, wq, ws, bias, act, wq_t=wq_t)
    assert vit_infer.fused_int8_matmul.launches == launches + 1
    want = vit_infer.fused_int8_matmul_reference(x, a, wq, ws, bias, act)
    assert got.dtype == torch.bfloat16 and got.shape == (1003, n)
    assert chip_smoke.bf16_ulps(got, want, chip_smoke.TANH_GELU_TAIL_UNIT if act == "gelu_tanh" else 0.0) <= 1.0


@pytest.mark.parametrize("m", [1, 16, 127, 129, 50432])
def test_k2_ragged_m_and_no_bias(cuda, m):
    x, a, wq, ws, _, _ = _k2_inputs(cuda, m, 768, 2304, torch.bfloat16, seed=m)
    got = vit_infer.fused_int8_matmul(x, a, wq, ws)  # no bias, K-major copy made by the wrapper
    assert chip_smoke.bf16_ulps(got, vit_infer.fused_int8_matmul_reference(x, a, wq, ws)) <= 1.0


def _check_k2(cuda, m, k, n, dtype, act, layout="dense", margin=1.05, with_bias=True):
    gen = torch.Generator(device=cuda).manual_seed(m + 7 * k + 13 * n)
    x, a, wq, ws, bias, wq_t = chip_smoke.k2_inputs(m, k, n, dtype, gen, quantization, layout, margin)
    bias = bias if with_bias else None
    launches = vit_infer.fused_int8_matmul.launches
    got = vit_infer.fused_int8_matmul(x, a, wq, ws, bias, act, wq_t=wq_t)
    assert vit_infer.fused_int8_matmul.launches == launches + 1  # one launch a call
    want = vit_infer.fused_int8_matmul_reference(x, a, wq, ws, bias, act)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert chip_smoke.bf16_ulps(got, want) <= 1.0


# Shapes off the kernel's 128 x 256 x 64 tiles in every direction, on both routes (K <= 768 and beyond).
@pytest.mark.parametrize("dtype,act", [(torch.bfloat16, "quickgelu"), (torch.float32, "none")])
@pytest.mark.parametrize("k", [32, 96, 800])
@pytest.mark.parametrize("n", [8, 264, 520])
@pytest.mark.parametrize("m", [1, 63, 64, 127, 129])
def test_k2_ragged_m_n_k(cuda, m, n, k, dtype, act):
    _check_k2(cuda, m, k, n, dtype, act)


@pytest.mark.parametrize("dtype,act", [(torch.bfloat16, "none"), (torch.float32, "quickgelu")])
@pytest.mark.parametrize("k,n", [(96, 264), (800, 520)])
def test_k2_all_rows_of_a_batch_ragged_n_k(cuda, k, n, dtype, act):
    _check_k2(cuda, 50432, k, n, dtype, act)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["strided", "offset"])
@pytest.mark.parametrize("m,k,n", [(129, 96, 520), (1003, 768, 768), (300, 3072, 264)])
def test_k2_reads_strided_and_offset_x(cuda, m, k, n, layout, dtype, with_bias):
    """x as a column slice of a wider tensor (lda > K), and from a base 16 but not 128 bytes aligned."""
    _check_k2(cuda, m, k, n, dtype, "quickgelu", layout=layout, with_bias=with_bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(768, 2304), (3072, 768)])
def test_k2_clamps_values_beyond_the_scale(cuda, k, n, dtype):
    _check_k2(cuda, 1003, k, n, dtype, "none", margin=0.4)


@pytest.mark.parametrize("m,n", [(300, 3072), (8192, 3072), (20000, 768)])
def test_k2_units_of_work_when_panels_are_fewer_than_sms(cuda, m, n):
    """Fewer row panels than SMs: a panel's column tiles are cut into several units of work."""
    _check_k2(cuda, m, 768, n, torch.bfloat16, "quickgelu")


def test_k2_quick_gelu_far_from_zero(cuda):
    """Pre-activations from -120 to 120: exp(-1.702 v) overflows, the result must not."""
    n = 256
    v = torch.linspace(-120.0, 120.0, 4 * n, device=cuda).reshape(4, n)
    x = torch.ones(64, 32, device=cuda)
    a = torch.tensor(127.0, device=cuda)
    wq = torch.ones(32, n, dtype=torch.int8, device=cuda)
    zero = torch.zeros(1, n, device=cuda)  # a zero weight scale: the bias alone is the pre-activation
    for bias in v:
        got = vit_infer.fused_int8_matmul(x, a, wq, zero, bias.contiguous(), "quickgelu")
        want = vit_infer.fused_int8_matmul_reference(x, a, wq, zero, bias.contiguous(), "quickgelu")
        assert torch.isfinite(got.float()).all()
        assert chip_smoke.bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_rounds_ties_to_even(cuda, dtype):
    ties = torch.arange(-127, 127, device=cuda, dtype=torch.float32) + 0.5
    x = torch.cat([ties, torch.tensor([3.0, 127.0], device=cuda)]).repeat(3, 1)
    eye = torch.eye(256, dtype=torch.int8, device=cuda)
    got = vit_infer.fused_int8_matmul(x.to(dtype), torch.tensor(127.0, device=cuda), eye,
                                      torch.ones(1, 256, device=cuda))
    assert torch.equal(got.float(), torch.round(x))
    assert got[0, 126:130].tolist() == [0.0, 0.0, 2.0, 2.0]  # -0.5, 0.5, 1.5, 2.5


def test_k2_refuses_what_it_does_not_take(cuda):
    x, a, wq, ws, bias, _ = _k2_inputs(cuda, 64, 768, 768, torch.bfloat16)
    with pytest.raises(ValueError, match="K % 32"):
        vit_infer.fused_int8_matmul(x[:, :760].contiguous(), a, wq[:760], ws, bias)
    with pytest.raises(ValueError, match="N % 8"):
        vit_infer.fused_int8_matmul(x, a, wq[:, :764].contiguous(), ws[:, :764].contiguous(), bias[:764])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        vit_infer.fused_int8_matmul(x.half(), a, wq, ws, bias)
    with pytest.raises(ValueError, match="one device"):
        vit_infer.fused_int8_matmul(x, a, wq, ws.cpu(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        vit_infer.fused_int8_matmul(x.t().contiguous().t(), a, wq, ws, bias)
    with pytest.raises(ValueError, match="act"):
        vit_infer.fused_int8_matmul(x, a, wq, ws, bias, act="gelu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1003, 768, 3072), (517, 3072, 768), (1003, 200, 130), (1, 64, 1)])
def test_k3_matches_plain(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    q, s = quantization.quantize_array(torch.randn(k, n, generator=gen, device=cuda) * k ** -0.5)
    x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    launches = quantization.int8_matmul.launches
    got = quantization.int8_matmul(x, q, s)
    assert quantization.int8_matmul.launches == launches + 1
    want = quantization.int8_matmul_reference(x, q, s)
    assert got.dtype == dtype and got.shape == (m, n)
    rel = chip_smoke.K3_F32_REL if dtype == torch.float32 else chip_smoke.K3_BF16_REL
    assert (got.float() - want.float()).abs().max() <= rel * want.float().abs().max()


def _k3_inputs(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    q, s = quantization.quantize_array(torch.randn(k, n, generator=gen, device=cuda) * k ** -0.5)
    return torch.randn(m, k, generator=gen, device=cuda).to(dtype), q, s


@pytest.mark.parametrize("m,k,n", [(1003, 768, 3072), (517, 3072, 768), (300, 100, 264), (1003, 200, 130)])
def test_k3_f32_matches_the_plain_version_of_its_arithmetic(cuda, m, k, n):
    x, q, s = _k3_inputs(cuda, m, k, n, torch.float32)
    want = quantization.int8_matmul_split_reference(x, q, s)
    got = quantization.int8_matmul(x, q, s)
    assert (got - want).abs().max() <= k / 4 * 2.0 ** -23 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 100, 256), (300, 33, 8), (129, 200, 520), (70, 1, 16), (5, 2049, 40)])
def test_k3_k_is_no_multiple_of_the_k_tile(cuda, m, k, n, dtype):
    """K tiles are 32 (float32 x) or 64 (bf16 x) deep: the last one is zero-filled past K."""
    x, q, s = _k3_inputs(cuda, m, k, n, dtype)
    want = quantization.int8_matmul_reference(x, q, s)
    got = quantization.int8_matmul(x, q, s)
    rel = chip_smoke.K3_F32_REL if dtype == torch.float32 else chip_smoke.K3_BF16_REL
    assert (got.float() - want.float()).abs().max() <= rel * want.float().abs().max()


def test_k3_reads_rows_off_16_byte_boundaries(cuda):
    """x rows 4 bytes off and an N that is no multiple of 16: element-wise loads and stores."""
    x = torch.randn(70, 131, device=cuda)[:, 1:129]
    q, s = quantization.quantize_array(torch.randn(128, 50, device=cuda))
    assert x.data_ptr() % 16 != 0
    for xx in (x, x.to(torch.bfloat16)[:, 1:]):
        qq = q[: xx.shape[1]].contiguous()
        want = quantization.int8_matmul_reference(xx, qq, s)
        got = quantization.int8_matmul(xx, qq, s)
        rel = chip_smoke.K3_F32_REL if xx.dtype == torch.float32 else chip_smoke.K3_BF16_REL
        assert (got.float() - want.float()).abs().max() <= rel * want.float().abs().max()


def test_k3_reads_strided_rows(cuda):
    x = torch.randn(64, 2, 256, device=cuda)[:, 0]  # row stride 512
    q, s = quantization.quantize_array(torch.randn(256, 96, device=cuda))
    want = quantization.int8_matmul_reference(x, q, s)
    assert (quantization.int8_matmul(x, q, s) - want).abs().max() <= chip_smoke.K3_F32_REL * want.abs().max()


def test_k3_refuses_what_it_does_not_take(cuda):
    q, s = quantization.quantize_array(torch.randn(64, 32, device=cuda))
    x = torch.randn(8, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quantization.int8_matmul(x.half(), q, s)
    with pytest.raises(ValueError, match="int8"):
        quantization.int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="one device"):
        quantization.int8_matmul(x, q.cpu(), s)
    with pytest.raises(ValueError, match="contiguous"):
        quantization.int8_matmul(x.t().contiguous().t(), q, s)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        quantization.int8_matmul(x[:, :60], q, s)


@pytest.mark.parametrize("mode", list(chip_smoke.FAST_MODES))
def test_cuda_fast_engines_match_cpu_engine(cuda, mode):
    knobs = chip_smoke.FAST_MODES[mode]
    state = flax_to_torch(chip_smoke.random_clip_variables(TINY, 32, seed=3))

    def engine(device):
        model = CLIP(**TINY, image_size=32)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=8, tokenizer=Char97Tokenizer(), device=device, **knobs)

    frames = np.random.default_rng(4).integers(0, 256, size=(13, 48, 48, 3), dtype=np.uint8)
    want = engine("cpu").text_rewards(frames, "collect the coin.")
    counters = (attn.flash_attention_fwd, vit_infer.fused_int8_matmul, quantization.int8_matmul)
    for fn in counters:
        fn.launches = 0
    eng = engine(cuda)
    got = eng.text_rewards(frames, "collect the coin.")
    k1, k2, k3 = (fn.launches for fn in counters)
    assert k1 > 0
    assert (k2 > 0) == ("int8" in mode) and (k3 > 0) == mode.startswith("quantize_weights")
    mae = np.abs(got - want).mean()
    if mode.endswith("f32"):
        assert mae <= chip_smoke.F32_REWARD_MAE, mae
    else:
        cos_mae = chip_smoke.INT8_COS_MAE if "int8" in mode else chip_smoke.BF16_COS_MAE
        assert mae <= cos_mae * eng.logit_scale, mae


# --- the policy path: K1 at head_dim 16 and under the dt mask, K2's tanh-GELU, tower and policy on the card ---


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", [MaskSpec("dt", 1, 3), MaskSpec("dt", 2, 4), MaskSpec("causal"), MaskSpec("none")],
                         ids=["dt_1_3", "dt_2_4", "causal", "none"])
@pytest.mark.parametrize("n", [3, 6, 9, 12, 65, 257])
def test_kernel_head_dim_16(cuda, n, spec, dtype):
    """The policy blocks (128 wide, 8 heads) while a session's window grows, and beyond one tile."""
    q, k, v = _qkv(7, (5, n, 8, 16), cuda, dtype)
    _check_k1(q, k, v, spec, _padding(5, n, cuda) if n > 12 else None)


def test_kernel_head_dim_16_reads_the_fused_projection_through_strides(cuda):
    x = torch.randn(4, 12, 3 * 128, generator=torch.Generator().manual_seed(8)).to(cuda)
    q, k, v = (t.view(4, 12, 8, 16) for t in x.chunk(3, dim=-1))
    _check_k1(q, k, v, MaskSpec("dt", 1, 3), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,padded", [(257, False), (273, True), (513, False)])
def test_kernel_m3ae_token_streams(cuda, n, padded, dtype):
    q, k, v = _qkv(9, (4, n, 12, 64), cuda, dtype)
    pad = None
    if padded:  # the text keys of row 0 are padding throughout
        pad = torch.zeros(4, n, dtype=torch.bool, device=cuda)
        pad[0, 257:] = True
        pad[2, 260:] = True
    _check_k1(q, k, v, MaskSpec("none"), pad)


@pytest.mark.parametrize("m", [1, 129, 4099])
def test_k2_tanh_gelu_ragged_m_and_far_from_zero(cuda, m):
    x, a, wq, ws, bias, wq_t = _k2_inputs(cuda, m, 768, 3072, torch.bfloat16)
    bias = bias + torch.linspace(-12, 12, 3072, device=cuda)  # both tails: 0 and the identity
    got = vit_infer.fused_int8_matmul(x, a, wq, ws, bias, "gelu_tanh", wq_t=wq_t)
    want = vit_infer.fused_int8_matmul_reference(x, a, wq, ws, bias, "gelu_tanh")
    assert torch.isfinite(got.float()).all()
    assert chip_smoke.bf16_ulps(got, want, chip_smoke.TANH_GELU_TAIL_UNIT) <= 1.0
    assert (got[:, :8].float() == 0).all() and torch.equal(got[:, -8:], want[:, -8:])  # v < -11: 0; v > 11: v


def _tiny_tower(cuda):
    from arp_tpu_torch.models import m3ae as m3ae_lib
    from arp_tpu_torch.models.policy import flax_m3ae_to_torch

    dims = dict(emb_dim=64, depth=2, num_heads=4, mlp_ratio=2)
    state = flax_m3ae_to_torch(chip_smoke.random_m3ae_variables(dims, 16, 211, seed=3))
    return dims, state, m3ae_lib


@pytest.mark.parametrize("stream", ["image", "text", "goal"])
def test_m3ae_tower_on_the_card_matches_the_cpu(cuda, stream):
    """Module and packed float32 forwards within 1e-4 of the CPU run; the int8 forward (K2 at every
    site, K1 attention) by cosine > 0.98 against its CPU run; K1 and K2 launched once a layer and site."""
    from arp_tpu_torch.ops import m3ae_infer

    dims, state, m3ae_lib = _tiny_tower(cuda)
    rng = np.random.default_rng(4)
    patch = torch.from_numpy(rng.standard_normal((6, 16, 768), dtype=np.float32))
    kw = {}
    if stream == "text":
        pad = torch.zeros(6, 8)
        pad[0] = 1.0
        pad[3, 5:] = 1.0
        kw = dict(text_ids=torch.from_numpy(rng.integers(0, 211, size=(6, 8))), text_padding_mask=pad)
    if stream == "goal":
        kw = dict(goal_patch=torch.from_numpy(rng.standard_normal((6, 16, 768), dtype=np.float32)))
    on = lambda tree, dev: {k: v.to(dev) for k, v in tree.items()}  # noqa: E731
    cfg = dict(model_type=None, **dims)

    def module_run(dev):
        m = m3ae_lib.MaskedMultimodalAutoencoder(cfg, text_vocab_size=211)
        m.load_state_dict(state)
        m = m.to(dev).eval()
        with torch.no_grad():
            if stream == "goal":
                return m.forward_gc_representations(patch.to(dev), kw["goal_patch"].to(dev), deterministic=True)
            return m.forward_representation(patch.to(dev), *(on(kw, dev).get(k) for k in ("text_ids", "text_padding_mask")),
                                            deterministic=True)

    torch.testing.assert_close(module_run(cuda).cpu(), module_run("cpu"), atol=1e-4, rtol=0)
    outs = {}
    for dev in ("cpu", cuda):
        packed = m3ae_infer.pack_m3ae_params(on(state, dev), dims["depth"], dtype=torch.float32)
        qpack = m3ae_infer.build_m3ae_qpack(on(state, dev), dims["depth"], dims["num_heads"], patch.to(dev), **on(kw, dev))
        k1, k2 = attn.flash_attention_fwd.launches, vit_infer.fused_int8_matmul.launches
        with torch.no_grad():
            outs[dev] = (m3ae_infer.m3ae_encode(packed, patch.to(dev), dims["num_heads"], compute_dtype=torch.float32, **on(kw, dev)),
                         m3ae_infer.m3ae_encode_int8(qpack, patch.to(dev), dims["num_heads"], **on(kw, dev)))
        if dev != "cpu":
            assert attn.flash_attention_fwd.launches - k1 == 2 * dims["depth"]
            assert vit_infer.fused_int8_matmul.launches - k2 == 4 * dims["depth"] + (2 if stream == "goal" else 1)
    torch.testing.assert_close(outs[cuda][0].cpu(), outs["cpu"][0], atol=1e-4, rtol=0)
    assert chip_smoke.cosine(outs[cuda][1], outs["cpu"][1]) > 0.98


@pytest.mark.parametrize("mode", ["float32", "frozen_bf16", "frozen_int8"])
def test_policy_on_the_card_matches_the_cpu(cuda, mode):
    """ARPDT with a tiny M3AE tower, 128-wide blocks with 8 heads (K1 at head_dim 16 under the dt mask)."""
    from arp_tpu_torch.models import policy as policy_lib

    dims = dict(emb_dim=64, depth=2, num_heads=4, mlp_ratio=2)
    state = policy_lib.flax_m3ae_to_torch(chip_smoke.random_m3ae_variables(dims, 16, chip_smoke.BERT_VOCAB, seed=3))
    cfg = dict(chip_smoke.POLICY_CFG, m3ae=dict(model_type=None, **dims), **chip_smoke.POLICY_MODES[mode])
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, size=(3, 4, 64, 64, 3), dtype=np.uint8)
    raw = {"image": {"ob": frames}, "rtg": {"ob": rng.uniform(0, 1, size=(3, 4, 1)).astype(np.float32)},
           "action": rng.integers(0, 15, size=(3, 4)).astype(np.int32), "instruct": None, "text_padding_mask": None}
    batch = dict(raw, image={"ob": (frames.astype(np.float32) / 255.0 - 0.5) / 0.3})
    outs, trained = {}, None
    for dev in ("cpu", cuda):
        qpack = None
        if mode == "frozen_int8":
            qpack = policy_lib.build_frozen_qpack(cfg, raw, 16, image_size=64, m3ae_loader=lambda name: state, device=dev)
        torch.manual_seed(0)
        model = policy_lib.ARPDT(cfg, num_actions=15, patch_dim=16, pt_variables=state, frozen_qpack=qpack).to(dev).eval()
        with torch.no_grad():
            model(batch, deterministic=True)
            if trained is None:
                trained = model.trained_state_dict()
            model.load_trained_state_dict(trained)
            k1, k2 = attn.flash_attention_fwd.launches, vit_infer.fused_int8_matmul.launches
            outs[dev] = model(batch, deterministic=True)["action_pred"]
        if dev != "cpu":
            tower_k1 = 0 if mode == "frozen_int8" else dims["depth"]
            assert attn.flash_attention_fwd.launches - k1 == tower_k1 + 2
            assert vit_infer.fused_int8_matmul.launches - k2 == (1 + 4 * dims["depth"] if mode == "frozen_int8" else 0)
    if mode == "float32":
        torch.testing.assert_close(outs[cuda].cpu(), outs["cpu"], atol=1e-4, rtol=0)
    else:
        assert chip_smoke.cosine(outs[cuda], outs["cpu"]) > chip_smoke.POLICY_MIN_COSINE[mode]


def test_attention_with_alibi_bias_takes_the_plain_attention_on_the_card(cuda):
    from arp_tpu_torch.models import layers

    torch.manual_seed(0)
    block = layers.Attention(32, 4, use_bias=True, alibi_bias=True).eval()
    x = torch.randn(2, 12, 32)
    k1 = attn.flash_attention_fwd.launches
    with torch.no_grad():
        want = block(x, True, MaskSpec("dt", 1, 3))
        got = block.to(cuda)(x.to(cuda), True, MaskSpec("dt", 1, 3))
    assert attn.flash_attention_fwd.launches == k1  # the bias branch is the plain attention, by design
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


# -- training: K1's gradient, the augmentation on the card, a flagship-width step ------------------

def _block_grads(block, x, spec, dev):
    """The gradients of sum(out * w) for a fixed w, on ``dev``: input first, then every parameter."""
    block = block.to(dev)
    x = x.to(dev).requires_grad_(True)
    out = block(x, False, spec)
    w = torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)
    grads = torch.autograd.grad((out * w).sum(), [x, *block.parameters()])
    return [g.cpu() for g in grads]


@pytest.mark.parametrize("case", ["policy_dt_d16", "tower_n257_d64"])
def test_k1_gradient_on_the_card_matches_the_cpu(cuda, case):
    """A Block's gradients through K1 (its plain backward) equal the CPU's within 1e-5 of the
    largest entry, and K1 ran the forward once."""
    from arp_tpu_torch.models import layers

    torch.manual_seed(0)
    if case == "policy_dt_d16":
        block, spec, x = layers.Block(128, 8, mlp_ratio=4), MaskSpec("dt", 1, 3), torch.randn(16, 12, 128)
    else:
        block, spec, x = layers.Block(768, 12, mlp_ratio=4, mlp_bias=True), MaskSpec("none"), torch.randn(2, 257, 768)
    want = _block_grads(block, x, spec, "cpu")
    k1 = attn.flash_attention_fwd.launches
    got = _block_grads(block, x, spec, cuda)
    assert attn.flash_attention_fwd.launches == k1 + 1
    scale = max(float(g.abs().max()) for g in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_flash_attention_gradient_of_masked_rows_on_the_card(cuda):
    """A row whose keys are all padded takes the mean of V forward, and the plain version's gradient back."""
    q, k, v = _qkv(11, (3, 12, 8, 16), cuda)
    pad = torch.zeros(3, 12, dtype=torch.bool, device=cuda)
    pad[1] = True
    for x in (q, k, v):
        x.requires_grad_(True)
    out = attn.dot_product_attention(q, k, v, MaskSpec("dt", 1, 3), pad)
    ref = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
    want = attn.reference_attention(*ref, MaskSpec("dt", 1, 3), pad.cpu())
    g = torch.randn(want.shape)
    got_grads = torch.autograd.grad(out, (q, k, v), g.to(cuda))
    want_grads = torch.autograd.grad(want, ref, g)
    torch.testing.assert_close(out.detach().cpu(), want.detach(), atol=1e-4, rtol=0)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("augs", ["random_crop", "color_jitter", "rotate", "random_crop,color_jitter,rotate"])
def test_augmentation_on_the_card_matches_the_cpu(cuda, augs):
    from arp_tpu_torch.ops.augment import make_augment_fn

    aug = make_augment_fn(augs, image_size=64, source_size=64)
    images = torch.from_numpy(np.random.default_rng(6).integers(0, 256, size=(12, 64, 64, 3), dtype=np.uint8))
    params = aug.draw(12, torch.Generator().manual_seed(6))
    want = aug.apply(images, params)
    got = aug.apply(images.to(cuda), [{k: v.to(cuda) for k, v in p.items()} for p in params])
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    drawn = aug(images.to(cuda), torch.Generator(device=cuda).manual_seed(6))  # draws on the card
    assert drawn.shape == (12, 64, 64, 3) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("mode", ["float32", "frozen_bf16", "frozen_int8"])
def test_flagship_width_train_step_on_the_card(cuda, mode):
    """One train step at the flagship widths (M3AE base tower, 128-wide policy) on 2 x 4 frames:
    finite loss, the frozen tower untouched and without gradients, every trained parameter moved."""
    from arp_tpu_torch.models import policy as policy_lib
    from arp_tpu_torch.ops.augment import make_augment_fn
    from arp_tpu_torch.parallel.step import TrainState, make_train_step
    from arp_tpu_torch.train import common

    pt = policy_lib.flax_m3ae_to_torch(chip_smoke.random_m3ae_variables(chip_smoke.M3AE_DIMS, 16, chip_smoke.BERT_VOCAB, 0))
    flags = chip_smoke.train_flags(dict(chip_smoke.POLICY_CFG, m3ae=chip_smoke.M3AE_CFG, **chip_smoke.POLICY_MODES[mode]))
    raw, _ = chip_smoke.policy_batch(2, 4, 0)
    batch = {k: ({kk: torch.from_numpy(vv).to(cuda) for kk, vv in v.items()} if isinstance(v, dict)
                 else None if v is None else torch.from_numpy(v).to(cuda)) for k, v in raw.items()}
    qpack = common.maybe_build_frozen_qpack(flags, raw, False, device=cuda, m3ae_loader=lambda name: pt)
    model = common.build_model(flags, 15, frozen_qpack=qpack, pt_variables=pt).to(cuda)
    with torch.no_grad():
        model(batch, deterministic=True)
    state = TrainState.create(model, common.build_optimizer(flags, lambda count: 5e-4, model))
    tower = {k: v.clone() for k, v in model.pt_model.state_dict().items()}
    before = {n: p.detach().clone() for n, p in state.params}
    step = make_train_step(common.make_loss_fn(model, make_augment_fn(flags.data.augmentations, 256, 256), 256, False))
    _, aux = step(state, batch, torch.Generator(device=cuda).manual_seed(0))
    assert np.isfinite(float(aux["loss"]))
    assert all(torch.equal(v, model.pt_model.state_dict()[k]) for k, v in tower.items())
    assert all(p.grad is None for p in model.pt_model.parameters())
    assert not [n for n, p in state.params if torch.equal(before[n], p.detach())]


# --- ARP-DT+ -------------------------------------------------------------------------------------

FT_TINY = dict(embed_dim=16, vocab_size=600, vision_num_layers=3, vision_features=64, vision_patch_size=16,
               text_features=64, text_num_heads=4, text_num_layers=2)  # head_dim 64 and 16: widths K1 takes


def _ft_weights():
    from arp_tpu_torch.finetune.convert import flax_adapter_to_torch

    return (flax_to_torch(chip_smoke.random_clip_variables(FT_TINY, 224, 0)),
            flax_adapter_to_torch(chip_smoke.random_adapter_variables(FT_TINY, 0, 15, 1)))


@pytest.mark.parametrize("mode", list(chip_smoke.FT_MODES))
def test_clip_ft_engine_on_the_card_matches_the_cpu(cuda, mode):
    """The clip_ft engine on the card against the CPU engine of the same mode, both calibrated on the same frames."""
    from arp_tpu_torch.finetune.reward import ClipFtRewardEngine

    clip_state, adapter_state = _ft_weights()
    frames = np.random.default_rng(3).integers(0, 256, size=(6, 64, 64, 3), dtype=np.uint8)

    def rewards(device):
        model = CLIP(**FT_TINY, image_size=224)
        model.load_state_dict(clip_state)
        engine = ClipFtRewardEngine(adapter_state, model=model, clip_config=FT_TINY, batch_size=8, device=device,
                                    **chip_smoke.FT_MODES[mode])
        return engine.text_rewards(frames, chip_smoke.FT_TEXT), engine.logit_scale

    (got, scale), (want, _) = rewards(cuda), rewards("cpu")
    bound = 1e-4 if mode == "module_f32" else (
        chip_smoke.INT8_COS_MAE if "int8" in mode else chip_smoke.BF16_COS_MAE) * scale
    assert np.isfinite(got).all() and np.abs(got - want).mean() <= bound


def test_finetune_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """chip_smoke's card-against-CPU fine-tuning step at a tiny width (it checks its own bounds)."""
    monkeypatch.setattr(chip_smoke, "FT_FRAME", 64)
    clip_state, adapter_state = _ft_weights()
    result = chip_smoke.compare_ft_step_with_cpu(FT_TINY, clip_state, adapter_state, chip_smoke.ft_tokens())
    assert result["loss_rel_err"] <= chip_smoke.FT_LOSS_REL


@pytest.mark.parametrize("kind", ["batch", "parallel"])
def test_rollout_on_the_card_matches_the_cpu(cuda, kind):
    """A rollout with a tiny-tower ARPDT (float32, K1 in the tower and under the dt mask) and a tiny float32 CLIP
    engine (K1) on FakeProcgen: the windows stay on the card; the CPU's run first, then the card's with the CPU's
    actions fed back, so both see one trajectory.  Greedy actions equal wherever the CPU's top-2 logits are more
    than chip_smoke.ROLLOUT_MARGIN apart, every reward within chip_smoke.F32_REWARD_MAE, rtg windows within
    chip_smoke.rollout_rtg_atol, K1 launched."""
    from arp_tpu_torch.envs import rollout
    from arp_tpu_torch.envs.fake import FakeProcgen
    from arp_tpu_torch.models import policy as policy_lib
    from arp_tpu_torch.ops.augment import make_eval_transform

    dims = dict(emb_dim=64, depth=2, num_heads=4, mlp_ratio=2)
    state = policy_lib.flax_m3ae_to_torch(chip_smoke.random_m3ae_variables(dims, 16, chip_smoke.BERT_VOCAB, seed=3))
    cfg = dict(chip_smoke.POLICY_CFG, m3ae=dict(model_type=None, **dims))
    clip_vars = chip_smoke.random_clip_variables(TINY, 32, seed=4)
    conf = {"episode_length": 5, "image_size": 64, "grid": 4, "record_video": False}
    runs, trained = {}, None
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        torch.manual_seed(0)
        model = policy_lib.ARPDT(cfg, num_actions=15, patch_dim=16, pt_variables=state).to(dev).eval()
        small = {"image": {"ob": np.zeros((1, 1, 64, 64, 3), np.float32)}, "rtg": {"ob": np.ones((1, 1, 1), np.float32)},
                 "action": np.zeros((1, 1), np.int32), "instruct": None, "text_padding_mask": None}
        with torch.no_grad():
            model(small, deterministic=True)
            trained = trained or model.trained_state_dict()
            model.load_trained_state_dict(trained)
        engine = ClipRewardEngine(model=CLIP(**TINY, image_size=32), variables=clip_vars, tokenizer=Char97Tokenizer(),
                                  batch_size=4, device=dev, image_size=32)
        notes, cpu_notes, rewards = [], runs.get("cpu"), []

        def scored(frames, txt_feat, real=engine.text_rewards_with_features, rewards=rewards):
            rewards.append(np.array(real(frames, txt_feat), copy=True))  # both rollouts score through it
            return rewards[-1]

        engine.text_rewards_with_features = scored

        def policy_fn(inputs, rngs):
            assert inputs["image"]["ob"].device.type == torch.device(dev).type
            action, logits = chip_smoke.greedy_with_logits(model, inputs)
            notes.append(dict(rtg=inputs["rtg"]["ob"].cpu().numpy().copy(), logits=logits.cpu().numpy(),
                              action=action.cpu().numpy()))
            return action if cpu_notes is None else torch.from_numpy(cpu_notes[len(notes) - 1]["action"])

        k1 = attn.flash_attention_fwd.launches
        kw = dict(transform_obs_fn=make_eval_transform(64, device=dev), episode_length=5, window_size=3,
                  return_to_go=30.0, scale=10.0, reward_engine=engine, text="collect the coin.", use_crop=True,
                  device=dev)
        if kind == "batch":
            rollout.batch_rollout(rng=0, data_aug_rng=0, env=FakeProcgen("coinrun", dict(conf)), policy_fn=policy_fn,
                                  num_episodes=1, **kw)
        else:
            rollout.parallel_rollout(rng=0, envs=[FakeProcgen("coinrun", dict(conf)) for _ in range(3)],
                                     policy_fn=policy_fn, **kw)
        runs[side], runs[f"{side}_rewards"] = notes, rewards
        if side == "card":
            assert attn.flash_attention_fwd.launches > k1
    assert len(runs["cpu"]) == len(runs["card"]) > 1
    assert len(runs["cpu_rewards"]) == len(runs["card_rewards"]) == len(runs["cpu"])
    for c, g in zip(runs["cpu_rewards"], runs["card_rewards"]):
        np.testing.assert_allclose(g, c, atol=chip_smoke.F32_REWARD_MAE, rtol=0)
    rtg_atol = chip_smoke.rollout_rtg_atol(10.0, len(runs["cpu"]), 30.0 / 10.0)
    for c, g in zip(runs["cpu"], runs["card"]):
        top2 = np.sort(c["logits"], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > chip_smoke.ROLLOUT_MARGIN
        np.testing.assert_array_equal(g["action"][sure], c["action"][sure])
        np.testing.assert_allclose(g["rtg"], c["rtg"], atol=rtg_atol, rtol=0)
    assert np.abs(runs["cpu"][-1]["rtg"][:, -1] - runs["cpu"][0]["rtg"][:, -1]).max() > 0  # the rewards moved it


# --- the reward server and the host resize -------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(chip_smoke.SERVE_MODES))
def test_reward_server_on_the_card_matches_the_cpu(cuda, mode):
    """The server's routes in every wire format on the card against the same server on the CPU (float32 within
    1e-4, fast_int8 within 0.05 x exp(logit_scale), both warmed, so calibrated, on the same frames)."""
    from arp_tpu_torch.reward.serve import RewardServer

    knobs = chip_smoke.SERVE_MODES[mode]
    state = flax_to_torch(chip_smoke.random_clip_variables(TINY, 32, seed=3))

    def server(device):
        model = CLIP(**TINY, image_size=32)
        model.load_state_dict(state)
        return RewardServer(ClipRewardEngine(model=model, batch_size=8, tokenizer=Char97Tokenizer(), device=device,
                                             **knobs))

    warm = chip_smoke.serve_frames(8, 0)
    frames = chip_smoke.serve_frames(5, 1)
    cpu, card = server("cpu"), server(cuda)
    cpu.warmup(warm)
    counters = (attn.flash_attention_fwd, vit_infer.fused_int8_matmul)
    for fn in counters:
        fn.launches = 0
    card.warmup(warm)
    bound = chip_smoke.INT8_COS_MAE * card.engine.logit_scale if "int8" in mode else chip_smoke.F32_REWARD_MAE
    for kind, goal in (("text", None), ("goal", frames[0]), ("goal", None)):
        for fmt in chip_smoke.SERVE_FORMATS:
            path, body, headers = chip_smoke.reward_request(kind, fmt, frames, "collect the coin.", goal)
            if fmt == "raw":
                call = (card.text_rewards_raw if kind == "text" else card.goal_rewards_raw), \
                       (cpu.text_rewards_raw if kind == "text" else cpu.goal_rewards_raw)
                got, want = (fn(headers, body)["rewards"] for fn in call)
            else:
                import json

                payload = json.loads(body)
                call = (card.text_rewards, cpu.text_rewards) if kind == "text" else (card.goal_rewards, cpu.goal_rewards)
                got, want = (fn(payload)["rewards"] for fn in call)
            assert np.abs(np.asarray(got) - np.asarray(want)).mean() <= bound, (kind, fmt, goal is None)
    k1, k2 = (fn.launches for fn in counters)
    assert k1 > 0 and (k2 > 0) == ("int8" in mode)


def test_host_resize_and_host_engine_on_the_card(cuda):
    """The host's resize is the card's byte for byte, and the host engine's rewards on the card are the pil
    engine's (the same bytes reach the tower)."""
    frames = np.random.default_rng(9).integers(0, 256, size=(6, 64, 64, 3), dtype=np.uint8)
    host = preprocess.resize_bicubic_pil_host(frames, 32, 32)
    card = preprocess.resize_bicubic_pil_packed(torch.from_numpy(frames.reshape(6, 64, 192)).to(cuda), 3, 32, 32)
    assert np.array_equal(host.reshape(6, 32, 96).astype(np.float32), card.cpu().numpy())
    state = flax_to_torch(chip_smoke.random_clip_variables(TINY, 32, seed=3))

    def engine(mode):
        model = CLIP(**TINY, image_size=32)
        model.load_state_dict(state)
        return ClipRewardEngine(model=model, batch_size=4, tokenizer=Char97Tokenizer(), device=cuda, resize_mode=mode)

    attn.flash_attention_fwd.launches = 0
    got = engine("host").text_rewards(frames, "collect the coin.")
    assert attn.flash_attention_fwd.launches > 0
    np.testing.assert_array_equal(got, engine("pil").text_rewards(frames, "collect the coin."))
