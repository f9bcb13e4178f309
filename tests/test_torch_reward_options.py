"""The reward engine's ``score_bf16`` and ``image_size`` and the labeler's ``--int8`` on the
``--vl_checkpoint`` branch, against arp_tpu's engine and CLI on the same weights.

``score_bf16``: bf16 attention scores and softmax on the standard path of both
towers, the recipe ``;score=bfloat16``; rewards within ``SCORE_BF16_MAE`` of the
JAX engine's, a bound the float32 engine misses by two orders of magnitude; under a
fast path it is inert for the image tower and warns, as in JAX.  The JAX engine runs
op by op (``jax.disable_jit``), where each bf16 op rounds as written: jitted, XLA's
CPU compiler drops some float32 -> bf16 -> float32 round trips of the softmax, which
moves the rewards as far as the bf16 scores themselves do.  ``image_size``: the model's own
resolution by default, the spec's for ``from_npz``.  ``--int8`` with
``--vl_checkpoint``: the engine takes no int8 weights, as arp_tpu's labeler
builds it.
"""

import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from arp_tpu.reward import labeler as jlabeler
from arp_tpu.testing import TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.models.clip import model as tclip_mod
from arp_tpu_torch.reward import labeler as tlabeler
from arp_tpu_torch.reward.engine import ClipRewardEngine
from test_torch_reward_engine import _make_demo_hdf5, _port_engine

TEXT = "collect the coin."
# mean |reward difference| over exp(logit_scale): measured 5e-8 against JAX op by op,
# 2e-4 for the float32 engine
SCORE_BF16_MAE = 1e-6


def _frames(seed, n, size=48):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def engines():
    jeng = make_tiny_clip_engine(batch_size=8, score_bf16=True)
    return jeng, _port_engine(jeng, score_bf16=True)


def test_score_bf16_matches_jax(engines):
    jeng, teng = engines
    assert teng.encode_recipe == jeng.encode_recipe.replace("flax;", "torch;")
    assert teng.encode_recipe == "torch;float32;score=bfloat16;resize=pil;crop=0;wq=0"
    frames = _frames(1, 13)
    with jax.disable_jit():
        want = jeng.text_rewards(frames, TEXT)
    got, plain = teng.text_rewards(frames, TEXT), _port_engine(jeng).text_rewards(frames, TEXT)
    assert np.abs(got - want).mean() <= SCORE_BF16_MAE * teng.logit_scale
    assert np.abs(plain - want).mean() > 10 * SCORE_BF16_MAE * teng.logit_scale  # the bound tells bf16 from float32


def test_score_bf16_under_a_fast_path_warns_and_matches_jax(engines):
    """Inert for the packed image path, as in JAX (which says so); the text tower keeps the bf16 scores."""
    jeng, _ = engines
    knobs = dict(score_bf16=True, fast_encode=True, fast_score_bf16=False)
    with pytest.warns(UserWarning, match="inert"):
        want = make_tiny_clip_engine(batch_size=8, **knobs)
    with pytest.warns(UserWarning, match="inert"):
        got = _port_engine(jeng, **knobs)
    assert got.encode_recipe == "torch;" + want.encode_recipe  # the packed recipe has no "flax;" in JAX
    assert got.encode_recipe == _port_engine(jeng, fast_encode=True, fast_score_bf16=False).encode_recipe
    frames = _frames(2, 9)
    with jax.disable_jit():
        rewards = want.text_rewards(frames, TEXT)
    assert np.abs(got.text_rewards(frames, TEXT) - rewards).mean() <= SCORE_BF16_MAE * got.logit_scale
    plain_text = _port_engine(jeng, fast_encode=True, fast_score_bf16=False).text_rewards(frames, TEXT)
    assert np.abs(plain_text - rewards).mean() > 10 * SCORE_BF16_MAE * got.logit_scale
    np.testing.assert_allclose(got.encode_image_features(frames), want.encode_image_features(frames), atol=1e-5)


def test_image_size(engines, monkeypatch, tmp_path):
    jeng, teng = engines
    assert teng.image_size == jeng.image_size == TINY_CLIP_IMG_SIZE
    # a tower built from its name takes its IMAGE_RESOLUTION entry, as in JAX
    from arp_tpu.models.clip import model as jclip_mod
    from arp_tpu.testing import TINY_CLIP_CFG

    monkeypatch.setitem(tclip_mod.MODELS, "tiny_test", lambda **kw: tclip_mod.CLIP(**TINY_CLIP_CFG, image_size=32))
    monkeypatch.setitem(tclip_mod.IMAGE_RESOLUTION, "tiny_test", 32)
    monkeypatch.setitem(jclip_mod.IMAGE_RESOLUTION, "tiny_test", 32)
    named = ClipRewardEngine("tiny_test", variables=jax.tree_util.tree_map(np.asarray, jeng.variables), device="cpu",
                             tokenizer=teng._tokenizer)
    assert named.image_size == jclip_mod.IMAGE_RESOLUTION["tiny_test"] == 32
    spec = str(tmp_path / "tower.npz")
    jeng.save_npz(spec)
    assert ClipRewardEngine.from_npz(spec, device="cpu").image_size == TINY_CLIP_IMG_SIZE
    assert _port_engine(jeng, image_size=TINY_CLIP_IMG_SIZE).image_size == TINY_CLIP_IMG_SIZE


def test_int8_with_vl_checkpoint_acts_as_in_the_jax_labeler(engines, tmp_path, monkeypatch):
    jeng, _ = engines
    spec = str(tmp_path / "tower.npz")
    jeng.save_npz(spec)
    recipes = {}
    for name in ("jax", "torch"):
        path = str(tmp_path / f"{name}.hdf5")
        _make_demo_hdf5(path)
        args = ["--data_path", path, "--vl_checkpoint", spec, "--batch_size", "8", "--int8"]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["labeler", *args])
            jlabeler.main()
        else:
            tlabeler.main([*args, "--device", "cpu"])
        with h5py.File(path, "r") as g:
            recipes[name] = g["ob_clip_reward"].attrs["encode_recipe"]
            rewards = g["ob_clip_reward"][:]
        recipes[name + "_rewards"] = rewards
    assert recipes["jax"].endswith(";wq=0") and recipes["torch"] == recipes["jax"].replace("flax;", "torch;")
    assert np.abs(recipes["jax_rewards"] - recipes["torch_rewards"]).mean() <= 1e-4
