"""Stage 1's host half in the port (arp_tpu_torch/collect/) against arp_tpu/collect/: the cases of
tests/test_collect.py that touch the recorder, fuse, downsize and the reward normalizer.

Everything here is integer or float64 host arithmetic, so the bar is equality: the HDF5 datasets
(values, dtype, shape, chunks, compression) and the saved engine states equal arp_tpu's on the
same FakeProcgen seeds and actions, and the normalizer's outputs equal arp_tpu's bit for bit.
"""

import os

import h5py
import numpy as np
import pytest

from arp_tpu.collect import downsize as jdownsize
from arp_tpu.collect import fuse as jfuse
from arp_tpu.collect import recorder as jrec
from arp_tpu.collect import reward_normalizer as jnorm
from arp_tpu.envs.fake import FakeProcgen as JFake
from arp_tpu.testing import scripted_coin_expert as jexpert
from arp_tpu_torch.collect import downsize as tdownsize
from arp_tpu_torch.collect import fuse as tfuse
from arp_tpu_torch.collect import recorder as trec
from arp_tpu_torch.collect import reward_normalizer as tnorm
from arp_tpu_torch.envs.fake import FakeProcgen as TFake
from arp_tpu_torch.testing import scripted_coin_expert as texpert


def assert_files_equal(got_path, want_path):
    with h5py.File(got_path, "r") as got, h5py.File(want_path, "r") as want:
        assert list(got.keys()) == list(want.keys())
        for key in want:
            a, b = got[key], want[key]
            assert (a.shape, a.dtype, a.chunks, a.compression, a.maxshape) == (
                b.shape, b.dtype, b.chunks, b.compression, b.maxshape), key
            assert a[...].tobytes() == b[...].tobytes(), key


@pytest.mark.parametrize("game,reward", [("coinrun", 10.0), ("coinrun", 9.0), ("coinrun_aisc", 10.0),
                                         ("starpilot", 30.0), ("starpilot", 29.0), ("bigfish", 1.0),
                                         ("maze", 9.99), ("heist", 0.0), ("heist", 0.5)])
def test_filter_condition_thresholds(game, reward):
    assert trec.filter_condition(game, reward) == jrec.filter_condition(game, reward)


@pytest.mark.parametrize("num_frames", [1, 3, 8])
def test_stack_episode_frames(num_frames):
    frames = np.random.default_rng(0).integers(0, 255, size=(5, 4, 4, 3), dtype=np.uint8)
    got = trec.stack_episode_frames(frames, num_frames)
    np.testing.assert_array_equal(got, jrec.stack_episode_frames(frames, num_frames))
    assert got.shape == (5, num_frames, 4, 4, 3)
    np.testing.assert_array_equal(got[0], np.repeat(frames[:1], num_frames, axis=0))  # back-filled with frame 0


def _collect(rec, fake, policy, path, **kw):
    env = fake("coinrun", {"episode_length": 30, "image_size": 16, "grid": 3})
    return rec.collect_demonstrations(env, policy, str(path), num_episodes=3, game_name="coinrun", num_frames=4,
                                      **kw)


@pytest.mark.parametrize("expert", ["random", "scripted", "scripted_corrupted"])
def test_collect_demonstrations_matches_jax(tmp_path, expert):
    def policy_for(package):
        if expert == "random":
            rng = np.random.default_rng(0)
            return lambda obs: int(rng.integers(0, 4))
        return texpert if package == "port" else jexpert

    kw = dict(seed=5, random_action_prob=0.3) if expert == "scripted_corrupted" else dict(seed=0)
    got = _collect(trec, TFake, policy_for("port"), tmp_path / "port" / "data_train.hdf5", **kw)
    want = _collect(jrec, JFake, policy_for("jax"), tmp_path / "jax" / "data_train.hdf5", **kw)
    assert (got.num_recorded, got.num_filtered) == (want.num_recorded, want.num_filtered) and got.num_recorded == 3
    assert_files_equal(tmp_path / "port" / "data_train.hdf5", tmp_path / "jax" / "data_train.hdf5")
    with h5py.File(tmp_path / "port" / "data_train.hdf5", "r") as g:
        T = g["ob"].shape[0]
        assert g["ob"].shape[1:] == (4, 16, 16, 3) and g["act"].shape == g["done"].shape == g["reward"].shape == (T, 4)
        assert int(g["done"][:, -1].sum()) == 3
        idx = [0] + list(np.nonzero(g["done"][:, -1])[0] + 1)
        assert all(g["reward"][idx[i]:idx[i + 1], -1].sum() >= 10.0 for i in range(3))  # the coinrun filter
    for i in range(3):
        mine = np.load(tmp_path / "port" / f"traj_state_{i}.npy", allow_pickle=True)
        theirs = np.load(tmp_path / "jax" / f"traj_state_{i}.npy", allow_pickle=True)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_recorder_drops_filtered_and_overlong_episodes(tmp_path):
    for rec in (trec, jrec):
        r = rec.TrajectoryRecorder(str(tmp_path / rec.__name__ / "d.hdf5"), max_episode_length=3, save_states=False)
        obs = {"image": {"ob": np.zeros((4, 4, 3), np.uint8)}}
        for length, reward, kept in ((2, 10.0, True), (2, 0.0, False), (3, 10.0, False)):
            r.begin_episode(obs)
            for _ in range(length):
                r.record_step(obs, 1, reward / length, False)
            assert r.end_episode() is kept
        assert (r.num_recorded, r.num_filtered) == (1, 2)


def _make_fuse_input(path, base):
    rng = np.random.default_rng(base)
    with h5py.File(path, "w") as g:
        n, f = 12, 2
        g.create_dataset("ob", data=rng.integers(0, 255, size=(n, f, 4, 4, 3), dtype=np.uint8))
        g.create_dataset("act", data=rng.integers(0, 15, size=(n, f)))
        done = np.zeros((n, f), bool)
        done[3, -1] = done[7, -1] = done[11, -1] = True
        g.create_dataset("done", data=done)


@pytest.mark.parametrize("ratio,seed", [(0.5, 0), (2 / 3, 0), (1 / 3, 7)])
def test_fuse_matches_jax(tmp_path, ratio, seed):
    a, b = str(tmp_path / "a.hdf5"), str(tmp_path / "b.hdf5")
    _make_fuse_input(a, 0)
    _make_fuse_input(b, 1)
    tfuse.fuse(a, b, str(tmp_path / "port.hdf5"), ratio=ratio, seed=seed)
    jfuse.fuse(a, b, str(tmp_path / "jax.hdf5"), ratio=ratio, seed=seed)
    assert_files_equal(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    if ratio == 2 / 3:  # 2/3 of A's 3 trajectories + 1/3 of B's 3 = exactly 3
        with h5py.File(tmp_path / "port.hdf5", "r") as g:
            assert int(g["done"][:, -1].sum()) == 3


def test_fuse_cli(tmp_path):
    a, b, out = str(tmp_path / "a.hdf5"), str(tmp_path / "b.hdf5"), str(tmp_path / "out.hdf5")
    _make_fuse_input(a, 2)
    _make_fuse_input(b, 3)
    tfuse.main(["--path_a", a, "--path_b", b, "--out", out, "--ratio", "0.5", "--seed", "4"])
    jfuse.fuse(a, b, str(tmp_path / "jax.hdf5"), ratio=0.5, seed=4)
    assert_files_equal(out, tmp_path / "jax.hdf5")


def test_reward_normalizer_matches_jax():
    rng = np.random.default_rng(0)
    got, want = tnorm.RewardNormalizer(num_envs=2, gamma=0.99), jnorm.RewardNormalizer(num_envs=2, gamma=0.99)
    for _ in range(50):
        r = rng.normal(size=2) * 5
        d = rng.uniform(size=2) < 0.1
        out = got(r, d)
        assert out.tobytes() == want(r, d).tobytes()
    assert np.all(np.abs(out) <= 10.0) and got.rms.var > 0
    restored = tnorm.RewardNormalizer(num_envs=2, gamma=0.99)
    restored.load_state_dict(got.state_dict())
    r, d = rng.normal(size=2), np.array([False, True])
    assert restored(r, d).tobytes() == want(r, d).tobytes()


def test_reward_normalizer_segment_matches_reference_form():
    """normalize_segment is the reference's backward-discounted whole-segment form (its oracle from
    tests/test_collect.py), and equals arp_tpu's over two segments."""
    rng = np.random.default_rng(0)
    T, N = 6, 3
    rewards = rng.normal(size=(T, N)).astype(np.float32) * 5
    dones = np.zeros((T, N), np.float32)
    dones[2, 1] = 1.0
    norm, jax_norm = tnorm.RewardNormalizer(N, gamma=0.9, cliprew=10.0), jnorm.RewardNormalizer(N, gamma=0.9, cliprew=10.0)
    got = norm.normalize_segment(rewards, dones)
    assert got.tobytes() == jax_norm.normalize_segment(rewards, dones).tobytes()

    rets = np.zeros((T, N))
    prev = np.zeros(N)
    for t in range(T):
        prev = rets[t] = rewards[t] + 0.9 * prev
        prev = np.where(dones[t] > 0, 0.0, prev)
    n_el, eps0 = rets.size, 1e-4
    mixed_var = (1.0 * eps0 + rets.reshape(-1).var() * n_el
                 + (rets.reshape(-1).mean() - 0.0) ** 2 * eps0 * n_el / (eps0 + n_el)) / (eps0 + n_el)
    np.testing.assert_allclose(got, np.clip(rewards / np.sqrt(mixed_var + 1e-8), -10.0, 10.0), rtol=1e-5)
    np.testing.assert_allclose(norm._ret, prev)
    again = rng.normal(size=(T, N)).astype(np.float32)  # the running return carries into the next segment
    assert norm.normalize_segment(again, dones).tobytes() == jax_norm.normalize_segment(again, dones).tobytes()


@pytest.mark.parametrize("src,out", [(32, 16), (64, 16), (48, 20)])
def test_downsize_by_resize_matches_jax(tmp_path, src, out):
    rng = np.random.default_rng(src)
    path = str(tmp_path / "d.hdf5")
    with h5py.File(path, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(70, 2, src, src, 3), dtype=np.uint8))
        g.create_dataset("act", data=np.arange(140).reshape(70, 2))
    tdownsize.downsize_by_resize(path, str(tmp_path / "port.hdf5"), out_size=out, device="cpu")
    jdownsize.downsize_by_resize(path, str(tmp_path / "jax.hdf5"), out_size=out)
    assert_files_equal(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    with h5py.File(tmp_path / "port.hdf5", "r") as g:
        assert g["ob"].shape == (70, 2, out, out, 3) and "act" in g


def test_downsize_by_replay_matches_jax(tmp_path):
    demo = tmp_path / "demo"
    _collect(jrec, JFake, jexpert, demo / "data_train.hdf5", seed=0)
    low = {"episode_length": 30, "image_size": 8, "grid": 3}
    tdownsize.downsize_by_replay(str(demo), str(tmp_path / "port.hdf5"), TFake("coinrun", low), num_frames=4)
    jdownsize.downsize_by_replay(str(demo), str(tmp_path / "jax.hdf5"), JFake("coinrun", low), num_frames=4)
    assert_files_equal(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    with h5py.File(tmp_path / "port.hdf5", "r") as g, h5py.File(demo / "data_train.hdf5", "r") as src:
        assert g["ob"].shape == src["ob"].shape[:2] + (8, 8, 3)  # one low-res frame stack per recorded step


def test_downsize_cli(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "d.hdf5")
    with h5py.File(path, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(3, 2, 32, 32, 3), dtype=np.uint8))
    tdownsize.main(["--data_path", path, "--out_path", str(tmp_path / "port.hdf5"), "--out_size", "16",
                    "--device", "cpu"])
    jdownsize.downsize_by_resize(path, str(tmp_path / "jax.hdf5"), out_size=16)
    assert_files_equal(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    # replay on the real engine raises where it is absent, as arp_tpu's wrapper does
    monkeypatch.delenv("ARP_TPU_FAKE_ENGINE", raising=False)
    with pytest.raises(ImportError, match="procgen"):
        tdownsize.main(["--data_path", path, "--out_path", str(tmp_path / "r.hdf5"), "--mode", "replay"])
    with pytest.raises(RuntimeError, match="cuda"):  # the card by default: never the CPU in silence
        tdownsize.main(["--data_path", path, "--out_path", str(tmp_path / "c.hdf5")])


def test_scripted_expert_matches_jax():
    env = TFake("coinrun", {"episode_length": 30, "image_size": 32, "grid": 4})
    obs = env.reset(3)
    for _ in range(12):
        action = texpert(obs)
        assert action == jexpert(obs)
        obs, _, done, _ = env.step(action)
        if done:
            obs = env.reset(4)
