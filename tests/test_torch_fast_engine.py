"""Port reward engine's packed and int8 paths against arp_tpu's engine with the same knobs.

The frames and sizes of tests/test_vit_infer.py:127-172 (10 frames of 48 px,
batch 4, so the int8 engines of both packages calibrate on the same first
batch).  Bounds:

  * fast float32 (float32 scores) and ``quantize_weights`` float32: reward
    MAE <= 1e-4, BASELINE.json's target;
  * fast bf16, and float32 with bf16 scores: MAE < 0.05, the JAX package's
    bf16 engine bound (tests/test_quantization.py:140);
  * the int8 modes: the JAX package's int8 engine bound, rtol = atol = 0.12
    (tests/test_vit_infer.py:158).

Also the recipe strings, the fast / ``quantize_weights`` exclusion, the
labeler's new flags, and that the CPU path never builds a kernel.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.testing import make_tiny_clip_engine
from arp_tpu_torch.ops import _build
from arp_tpu_torch.reward import labeler as tlabeler
from tests.test_torch_reward_engine import _make_demo_hdf5, _port_engine

TEXT = "a coin"
# id: (knobs, bound kind); compute_dtype "bf16" means each package's bfloat16
MODES = {
    "fast_f32": (dict(fast_encode=True, fast_score_bf16=False), "f32"),
    "fast_f32_bf16_scores": (dict(fast_encode=True), "bf16"),
    "fast_bf16": (dict(fast_encode=True, compute_dtype="bf16"), "bf16"),
    "fast_int8": (dict(fast_int8=True), "int8"),
    "fast_int8_bf16_attn": (dict(fast_int8=True, fast_int8_attn=False), "int8"),
    "fast_int8_f32_scores": (dict(fast_int8=True, fast_score_bf16=False), "int8"),
    "quantize_weights_f32": (dict(quantize_weights=True), "f32"),
    "quantize_weights_bf16": (dict(quantize_weights=True, compute_dtype="bf16"), "bf16"),
}


def _knobs(knobs, bf16):
    return {k: (bf16 if v == "bf16" else v) for k, v in knobs.items()}


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, size=(10, 48, 48, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_base():
    return make_tiny_clip_engine(batch_size=4)


def _pair(jax_base, mode):
    knobs, _ = MODES[mode]
    jeng = make_tiny_clip_engine(batch_size=4, **_knobs(knobs, jnp.bfloat16))
    teng = _port_engine(jax_base, batch_size=4, **_knobs(knobs, torch.bfloat16))
    return jeng, teng


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_mode_matches_jax(jax_base, frames, mode):
    jeng, teng = _pair(jax_base, mode)
    got, want = teng.text_rewards(frames, TEXT), jeng.text_rewards(frames, TEXT)
    assert got.shape == want.shape == (10,) and np.isfinite(got).all()
    mae = np.abs(got - want).mean()
    bound = MODES[mode][1]
    if bound == "f32":
        assert mae <= 1e-4, mae
    elif bound == "bf16":
        assert mae < 0.05, mae
    else:
        np.testing.assert_allclose(got, want, rtol=0.12, atol=0.12)
    # "torch;" takes the place of the standard path's "flax;" and leads the packed paths
    jrecipe = jeng.encode_recipe
    assert teng.encode_recipe == "torch;" + (jrecipe.split(";", 1)[1] if jrecipe.startswith("flax;") else jrecipe)


@pytest.mark.parametrize("mode", ["fast_f32", "quantize_weights_f32"])
def test_float32_modes_match_jax_features_and_goal_rewards(jax_base, frames, mode):
    jeng, teng = _pair(jax_base, mode)
    np.testing.assert_allclose(teng.encode_image_features(frames, normalize=False),
                               jeng.encode_image_features(frames, normalize=False), atol=1e-4, rtol=0)
    np.testing.assert_allclose(teng.encode_text_features(TEXT), jeng.encode_text_features(TEXT), atol=1e-5)
    assert np.abs(teng.goal_rewards(frames) - jeng.goal_rewards(frames)).mean() <= 1e-4


def test_int8_calibrates_once_on_the_first_batch(jax_base, frames):
    teng = _port_engine(jax_base, batch_size=4, fast_int8=True)
    assert teng._fast_q is None
    first = teng.encode_image_features(frames[:4])
    qpack = teng._fast_q
    assert qpack is not None and "a_attn_in" in qpack["layers"]
    teng.encode_image_features(frames)
    assert teng._fast_q is qpack
    np.testing.assert_array_equal(teng.encode_image_features(frames[:4]), first)


@pytest.mark.parametrize("fast", [dict(fast_encode=True), dict(fast_int8=True)], ids=["fast_encode", "fast_int8"])
def test_fast_paths_exclude_quantize_weights(jax_base, fast):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port_engine(jax_base, quantize_weights=True, **fast)


def test_cpu_path_never_builds_a_kernel(jax_base, frames, monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path built kernel {name}")

    monkeypatch.setattr(_build, "build", no_build)
    for knobs in (dict(fast_encode=True), dict(fast_int8=True), dict(fast_int8=True, fast_int8_attn=False),
                  dict(quantize_weights=True)):
        assert np.isfinite(_port_engine(jax_base, batch_size=4, **knobs).text_rewards(frames, TEXT)).all()


@pytest.mark.parametrize("flags,recipe", [
    # arp_tpu's labeler builds the --vl_checkpoint engine without --int8: so does the port's
    (["--int8"], "torch;float32;score=float32;resize=pil;crop=0;wq=0"),
    (["--fast", "--no-fast_score_bf16"], "torch;packed;float32;score=float32;int8_attn=0;resize=pil;crop=0"),
    (["--fast", "--bf16"], "torch;packed;bfloat16;score=bfloat16;int8_attn=0;resize=pil;crop=0"),
    (["--fast_int8"], "torch;packed;int8;score=bfloat16;int8_attn=1;resize=pil;crop=0"),
    (["--fast_int8", "--no-fast_int8_attn", "--no-fast_score_bf16"],
     "torch;packed;int8;score=float32;int8_attn=0;resize=pil;crop=0"),
], ids=["int8", "fast_f32", "fast_bf16", "fast_int8", "fast_int8_plain_attn"])
def test_cli_flags_reach_the_engine(jax_base, tmp_path, flags, recipe):
    spec = str(tmp_path / "tower.npz")
    jax_base.save_npz(spec)
    path = str(tmp_path / "demo.hdf5")
    _make_demo_hdf5(path)
    tlabeler.main(["--data_path", path, "--vl_checkpoint", spec, "--batch_size", "8", "--device", "cpu", *flags])
    with h5py.File(path, "r") as g:
        for key in ("ob_clip_reward", "ob_clip_pos_rtg"):
            assert g[key].attrs["encode_recipe"] == recipe
            assert np.isfinite(g[key][:]).all()


def test_cli_refuses_int8_with_a_fast_path(jax_base, tmp_path):
    spec = str(tmp_path / "tower.npz")
    jax_base.save_npz(spec)
    path = str(tmp_path / "demo.hdf5")
    _make_demo_hdf5(path)
    # --int8 acts where the engine is built from its name (no --vl_checkpoint), as in arp_tpu
    with pytest.raises(ValueError, match="mutually exclusive"):
        tlabeler.main(["--data_path", path, "--device", "cpu", "--int8", "--fast"])
