"""Port attention (arp_tpu_torch/ops/attention.py) against arp_tpu's attention.

The plain version is held to ``_xla_attention`` (the path the JAX package
runs) at atol 1e-5 in float32, and to the Pallas kernel run in interpret
mode, as tests/test_attention.py runs it, at that file's atol 2e-4.  Kernel
K1 itself runs only on a GPU: tests/test_torch_gpu.py holds its cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arp_tpu.ops.attention as jattn
from arp_tpu.ops.masks import MaskSpec as JMaskSpec
from arp_tpu.ops.masks import materialize_mask as j_materialize_mask
from arp_tpu_torch.ops import _build
from arp_tpu_torch.ops import attention as tattn
from arp_tpu_torch.ops.masks import MaskSpec, materialize_mask

OBS, PER_STEP = 2, 4


def _inputs(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3)]


def _padding(b, n, seed):
    rng = np.random.default_rng(seed)
    pad = np.zeros((b, n), np.int32)
    for i in range(b):
        pad[i, rng.integers(1, n) :] = 1  # at least one live key per row
    return pad


def _jax_bhnd(x):
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


def _xla(q, k, v, kind, pad=None, bias=None, score_dtype=jnp.float32):
    out = jattn._xla_attention(
        _jax_bhnd(q), _jax_bhnd(k), _jax_bhnd(v), JMaskSpec(kind, OBS, PER_STEP),
        None if pad is None else jnp.asarray(pad), q.shape[-1] ** -0.5,
        bias=None if bias is None else jnp.asarray(bias), score_dtype=score_dtype,
    )
    return np.asarray(jnp.swapaxes(out, 1, 2).astype(jnp.float32))


def _port(q, k, v, kind, pad=None, **kw):
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    out = tattn.dot_product_attention(t(q), t(k), t(v), MaskSpec(kind, OBS, PER_STEP), t(pad), **kw)
    return out.float().numpy()


@pytest.mark.parametrize("kind", ["none", "causal", "dt"])
def test_materialize_mask_matches_jax(kind):
    spec_args = (kind, OBS, PER_STEP)
    got = materialize_mask(MaskSpec(*spec_args), 13).numpy()
    want = np.asarray(j_materialize_mask(JMaskSpec(*spec_args), 13))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("n", [77, 128, 200])
@pytest.mark.parametrize("kind", ["none", "causal", "dt"])
def test_reference_matches_xla_attention(kind, n, padded):
    q, k, v = _inputs(0, 2, n, 3, 64)
    pad = _padding(2, n, 1) if padded else None
    np.testing.assert_allclose(_port(q, k, v, kind, pad), _xla(q, k, v, kind, pad), atol=1e-5)


@pytest.mark.parametrize("n", [77, 128, 200])
@pytest.mark.parametrize("kind", ["none", "causal", "dt"])
def test_reference_matches_pallas_interpret(kind, n, monkeypatch):
    orig = jattn.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jattn.pl, "pallas_call", interp)
    q, k, v = _inputs(2, 1, n, 2, 16)
    pad = _padding(1, n, 3)
    spec = JMaskSpec(kind, OBS, PER_STEP)
    want = jattn._pallas_attention(
        _jax_bhnd(q), _jax_bhnd(k), _jax_bhnd(v), spec, jnp.asarray(pad), 16 ** -0.5
    )
    want = np.asarray(jnp.swapaxes(want, 1, 2))
    np.testing.assert_allclose(_port(q, k, v, kind, pad), want, atol=2e-4)


@pytest.mark.parametrize("kind", ["none", "causal", "dt"])
def test_fully_masked_row_is_mean_of_v_over_all_keys(kind):
    """A row whose keys are all padding: _xla_attention's answer, the mean of V over n."""
    q, k, v = _inputs(4, 2, 70, 2, 32)
    pad = np.zeros((2, 70), np.int32)
    pad[0] = 1
    got = _port(q, k, v, kind, pad)
    np.testing.assert_allclose(got, _xla(q, k, v, kind, pad), atol=1e-5)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(axis=0), got[0].shape), atol=1e-5)


def test_reference_bias_matches_xla():
    q, k, v = _inputs(5, 2, 40, 3, 32)
    bias = np.random.default_rng(6).normal(size=(1, 3, 40, 40)).astype(np.float32)
    got = _port(q, k, v, "causal", bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got, _xla(q, k, v, "causal", bias=bias), atol=1e-5)


def test_reference_bf16_inputs_and_scores_match_xla():
    """bf16 inputs with bf16 scores: both round at other places, so bf16's 2^-8."""
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(7, 2, 50, 2, 64))
    got = tattn.dot_product_attention(
        *(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) for x in (q, k, v)),
        MaskSpec("causal"), score_dtype=torch.bfloat16,
    )
    want = jattn._xla_attention(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)), JMaskSpec("causal"), None,
        64 ** -0.5, score_dtype=jnp.bfloat16,
    )
    want = np.asarray(jnp.swapaxes(want, 1, 2).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_cpu_dispatch_never_touches_the_kernel(monkeypatch):
    def no_kernel():
        raise AssertionError("the CPU path loaded the CUDA kernel")

    monkeypatch.setattr(_build, "flash_attn_lib", no_kernel)
    monkeypatch.setattr(tattn.flash_attention_fwd, "launches", 0)
    q, k, v = _inputs(8, 2, 77, 8, 64)
    _port(q, k, v, "causal", _padding(2, 77, 9))
    _port(q, k, v, "none")
    assert tattn.flash_attention_fwd.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(10, 1, 8, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_fwd(q, k, v)


def test_build_module_imports_without_nvcc_and_raises_when_building(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_attn_fwd")
    assert not (tmp_path / "build").exists()
