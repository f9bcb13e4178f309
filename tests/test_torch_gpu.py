"""Cases of the PyTorch port that need an NVIDIA GPU: kernel K1, the resize on the card, the CUDA engine.

Each is marked ``gpu`` and skips where ``torch.cuda.is_available()`` is
False.  This file imports no JAX, so it also runs on a GPU machine without
JAX; tests/conftest.py does import JAX, so there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 against the plain attention at 1e-4 in float32 (the two sum in
other orders) and 2e-2 in bfloat16 (K1 rounds its output to bf16); the resize
byte-exact; engine rewards against the CPU engine at MAE 1e-4.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from arp_tpu_torch.models.clip import CLIP, Char97Tokenizer, flax_to_torch
from arp_tpu_torch.ops import attention as attn
from arp_tpu_torch.ops import preprocess
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
    assert 0 < report["device_busy_ms"] <= report["wall_ms"]
