"""Port reward engine and labeler against arp_tpu's on the same weights.

The port's ``ClipRewardEngine`` (on the CPU, where attention takes its plain
version) must give the JAX engine's text and goal rewards within MAE 1e-4,
BASELINE.json's reward target, and its labeler must write the JAX labeler's
datasets (keys, shapes, attrs) with the same rewards, the recipe stamped
``torch;``.  The synthetic HDF5 follows tests/test_reward_engine.py.
"""

import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

from arp_tpu.reward.labeler import label_rewards as j_label_rewards
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.models.clip import CLIP
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward import labeler as tlabeler
from arp_tpu_torch.reward.engine import ClipRewardEngine

MAE = 1e-4


@pytest.fixture(scope="module")
def jax_engine():
    return make_tiny_clip_engine(batch_size=8)


def _port_engine(jax_engine, **kwargs):
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    kwargs.setdefault("batch_size", 8)
    kwargs.setdefault("device", "cpu")
    return ClipRewardEngine(
        model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), variables=variables,
        tokenizer=Char97Tokenizer(), **kwargs,
    )


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    return _port_engine(jax_engine)


def _frames(seed, n, size=48):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("text", ["collect the coin.", ["collect the coin.", "reach the saw."]],
                         ids=["one_text", "two_texts"])
def test_text_rewards_match_jax(jax_engine, port_engine, text):
    frames = _frames(1, 13)  # odd N: the padded last batch
    got, want = port_engine.text_rewards(frames, text), jax_engine.text_rewards(frames, text)
    assert got.shape == want.shape == (13,)
    assert np.abs(got - want).mean() <= MAE
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_goal_rewards_match_jax(jax_engine, port_engine):
    frames = _frames(2, 11, TINY_CLIP_IMG_SIZE)
    for got, want in (
        (port_engine.goal_rewards(frames), jax_engine.goal_rewards(frames)),
        (port_engine.goal_rewards_vs(frames, frames[3]), jax_engine.goal_rewards_vs(frames, frames[3])),
    ):
        assert np.abs(got - want).mean() <= MAE
    assert port_engine.goal_rewards(frames)[-1] == 0.0


def test_features_match_jax(jax_engine, port_engine):
    frames = _frames(3, 9, 64)
    for normalize in (True, False):
        np.testing.assert_allclose(
            port_engine.encode_image_features(frames, normalize=normalize),
            jax_engine.encode_image_features(frames, normalize=normalize), atol=1e-5,
        )
    np.testing.assert_allclose(
        port_engine.encode_text_features("get the coin"), jax_engine.encode_text_features("get the coin"),
        atol=1e-5,
    )


def test_bf16_engine_within_the_jax_bf16_bound(jax_engine, port_engine):
    """tests/test_quantization.py's bf16 bound (MAE < 0.05 at this logit_scale)."""
    bf16 = _port_engine(jax_engine, compute_dtype=torch.bfloat16)
    frames = _frames(6, 6, TINY_CLIP_IMG_SIZE)
    text = "collect the coin."
    assert np.abs(bf16.text_rewards(frames, text) - port_engine.text_rewards(frames, text)).mean() < 0.05
    assert bf16.encode_recipe.startswith("torch;bfloat16;")
    assert next(bf16.model.text.parameters()).dtype == torch.float32  # text tower stays f32, as in JAX


def test_provenance(jax_engine, port_engine):
    assert port_engine.tokenizer_identity == jax_engine.tokenizer_identity == "char97"
    assert port_engine.encode_recipe.startswith("torch;")
    assert port_engine.encode_recipe.split(";", 1)[1] == jax_engine.encode_recipe.split(";", 1)[1]


@pytest.mark.parametrize("option", [
    dict(resize_mode="host"), dict(resize_mode="fast"), dict(use_crop=True),
    dict(quantize_weights=True), dict(fast_encode=True), dict(fast_int8=True), dict(mesh=object()),
], ids=lambda o: next(iter(o)) + ("_" + o["resize_mode"] if "resize_mode" in o else ""))
def test_unported_options_raise(jax_engine, option):
    with pytest.raises(NotImplementedError):
        _port_engine(jax_engine, **option)


def test_openai_checkpoint_loading_is_not_ported():
    with pytest.raises(NotImplementedError):
        ClipRewardEngine(device="cpu")


def test_cuda_without_a_gpu_raises(jax_engine):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _port_engine(jax_engine, device="cuda")


def _make_demo_hdf5(path, n=30, num_frames=4, img=48, time_keyed=False):
    rng = np.random.default_rng(4)
    with h5py.File(path, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(n, num_frames, img, img, 3), dtype=np.uint8))
        g.create_dataset("act", data=rng.integers(0, 15, size=(n, num_frames)).astype(np.int64))
        if time_keyed:
            time = np.zeros((n, num_frames, 1), np.float32)
            time[0, -1, 0] = time[n // 2, -1, 0] = 1.0
            g.create_dataset("time", data=time)
        else:
            done = np.zeros((n, num_frames), bool)
            done[9, -1] = done[19, -1] = done[n - 1, -1] = True  # 3 trajectories
            g.create_dataset("done", data=done)


def _assert_same_labels(port_path, jax_path, keys=("ob_clip_reward", "ob_clip_pos_rtg")):
    with h5py.File(port_path, "r") as got, h5py.File(jax_path, "r") as want:
        assert set(got.keys()) == set(want.keys())
        for key in keys:
            assert got[key].shape == want[key].shape
            assert got[key].compression == want[key].compression == "gzip"
            assert got[key].attrs["tokenizer_identity"] == want[key].attrs["tokenizer_identity"]
            assert got[key].attrs["encode_recipe"].startswith("torch;")
            assert np.abs(got[key][:] - want[key][:]).mean() <= MAE
            np.testing.assert_allclose(got[key][:], want[key][:], atol=1e-4)


@pytest.mark.parametrize("model_type,time_keyed", [("clip", False), ("clip", True), ("goal_conditioned", False)])
def test_labeler_matches_jax_labeler(jax_engine, port_engine, tmp_path, model_type, time_keyed):
    port_path, jax_path = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    _make_demo_hdf5(port_path, time_keyed=time_keyed)
    shutil.copy(port_path, jax_path)
    stats = tlabeler.label_rewards(port_path, "collect the coin.", model_type=model_type,
                                   engine=port_engine, progress=False)
    j_label_rewards(jax_path, "collect the coin.", model_type=model_type, engine=jax_engine, progress=False)
    assert stats["frames"] == 30
    _assert_same_labels(port_path, jax_path, (f"ob_{model_type}_reward", f"ob_{model_type}_pos_rtg"))


def test_labeler_overwrites_in_place(port_engine, tmp_path):
    path = str(tmp_path / "data.hdf5")
    _make_demo_hdf5(path)
    tlabeler.label_rewards(path, "collect the coin.", engine=port_engine, progress=False)
    with h5py.File(path, "r") as g:
        first = g["ob_clip_reward"][:]
    tlabeler.label_rewards(path, "collect the coin.", engine=port_engine, inst_type="none", progress=False)
    with h5py.File(path, "r") as g:
        np.testing.assert_array_equal(g["ob_clip_reward"][:], first)


def test_cli_labels_with_a_jax_engine_spec(jax_engine, tmp_path, capsys):
    """arp_tpu's save_npz spec -> python -m arp_tpu_torch.reward.labeler --vl_checkpoint."""
    spec = str(tmp_path / "tower.npz")
    jax_engine.save_npz(spec)
    port_path, jax_path = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    _make_demo_hdf5(port_path)
    shutil.copy(port_path, jax_path)
    tlabeler.main(["--data_path", port_path, "--vl_checkpoint", spec, "--batch_size", "8",
                   "--device", "cpu", "--env_name", "maze"])
    assert "[DONE] 30 frames" in capsys.readouterr().out
    j_label_rewards(jax_path, "navigate a maze to collect the yellow cheese.", engine=jax_engine,
                    progress=False)
    _assert_same_labels(port_path, jax_path)


def test_cli_without_a_spec_needs_the_unported_openai_loader(tmp_path):
    path = str(tmp_path / "data.hdf5")
    _make_demo_hdf5(path)
    with pytest.raises(NotImplementedError):
        tlabeler.main(["--data_path", path, "--device", "cpu"])


def test_last_frame_window():
    ds = np.arange(5 * 2 * 3).reshape(5, 2, 3)
    w = tlabeler.LastFrameWindow(ds, 1, 4)
    assert w.shape == (3, 3) and len(w) == 3
    np.testing.assert_array_equal(w[0:2], ds[1:3, -1])
    np.testing.assert_array_equal(w[-1], ds[3, -1])
    with pytest.raises(IndexError):
        w[3]
