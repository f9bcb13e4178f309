"""The port's labeler on several hosts, its full CLI and the engine's save_npz, against arp_tpu's.

``shard_trajectory_range`` gives JAX's shares; two-host sidecars merged with
``--merge`` give the single-host datasets and JAX's two-host ones (rewards
within 1e-5, the float32 engines' parity bound of
tests/test_torch_reward_engine.py).  The engine runs a call's last batch at its
own size, and the CPU's float32 GEMMs round a row apart in batches of other
sizes: where a host's share cuts a device batch of the single-host run, the
merge matches one host within SHARD_F32_REL of the largest value; where the
shares start on batch boundaries, bit for bit.  The merge refuses missing, truncated,
wrong-shape, foreign and overlapping shards as JAX's does; ``default_data_path``
is JAX's.  ``save_npz`` writes a spec that JAX's ``from_npz`` scores within
1e-5, and ``torch_to_flax`` inverts ``flax_to_torch`` exactly.
"""

import argparse
import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

from arp_tpu.reward import labeler as jlabeler
from arp_tpu.reward.engine import ClipRewardEngine as JEngine
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.models.clip import CLIP, flax_to_torch
from arp_tpu_torch.models.clip.convert import _flatten, torch_to_flax
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward import labeler as tlabeler
from arp_tpu_torch.reward.engine import ClipRewardEngine

TEXT = "collect the coin."
KEYS = ("ob_clip_reward", "ob_clip_pos_rtg")
# Rows that a host's share cuts out of a device batch of the single-host run are encoded in a batch of another
# size: float32 rounding, a few ulps of the largest reward or rtg (measured: 4.5e-8 of ~0.15, 3e-7 relative).
SHARD_F32_REL = 1e-6


def assert_within_shard_rounding(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARD_F32_REL * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_engine():
    return make_tiny_clip_engine(batch_size=8)


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    return ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE),
                            variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                            tokenizer=Char97Tokenizer(), batch_size=8, device="cpu")


def _demo(path, n=30, ends=(9, 19, 29), num_frames=3, img=24):
    rng = np.random.default_rng(7)
    with h5py.File(path, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(n, num_frames, img, img, 3), dtype=np.uint8))
        g.create_dataset("act", data=rng.integers(0, 15, size=(n, num_frames)).astype(np.int64))
        done = np.zeros((n, num_frames), bool)
        done[list(ends), -1] = True
        g.create_dataset("done", data=done)


def _read(path, keys=KEYS):
    with h5py.File(path, "r") as g:
        return {k: (g[k][:], dict(g[k].attrs)) for k in keys}


@pytest.mark.parametrize("traj_idx,len_data,num_hosts", [
    ([0, 10, 20, 30], 30, 2), ([0, 10, 20, 30], 30, 3), ([0, 10, 20, 30], 30, 5), ([0, 3, 4, 17, 30], 30, 4),
    ([0, 30], 30, 3), ([0, 1, 2, 3, 4, 5], 5, 2), ([0, 12, 25], 27, 2),
], ids=["even2", "even3", "more_hosts", "ragged4", "one_traj", "unit_trajs", "trailing_rows"])
def test_shard_trajectory_range_matches_jax(traj_idx, len_data, num_hosts):
    covered = []
    for h in range(num_hosts):
        got = tlabeler.shard_trajectory_range(traj_idx, len_data, num_hosts, h)
        assert got == jlabeler.shard_trajectory_range(traj_idx, len_data, num_hosts, h)
        covered += list(range(got[2], got[3]))
    assert covered == sorted(set(covered))  # disjoint, in host order
    with pytest.raises(ValueError, match="host_index"):
        tlabeler.shard_trajectory_range(traj_idx, len_data, num_hosts, num_hosts)


@pytest.mark.parametrize("model_type", ["clip", "goal_conditioned"])
def test_two_hosts_and_merge_equal_one_host_and_jax(tmp_path, jax_engine, port_engine, model_type):
    one, two, jax_two = (str(tmp_path / f"{n}.hdf5") for n in ("one", "two", "jax_two"))
    _demo(one)
    shutil.copy(one, two)
    shutil.copy(one, jax_two)
    keys = (f"ob_{model_type}_reward", f"ob_{model_type}_pos_rtg")
    tlabeler.label_rewards(one, TEXT, model_type=model_type, engine=port_engine, progress=False)
    rows = []
    for h in range(2):
        stats = tlabeler.label_rewards(two, TEXT, model_type=model_type, engine=port_engine, progress=False,
                                       num_hosts=2, host_index=h)
        jlabeler.label_rewards(jax_two, TEXT, model_type=model_type, engine=jax_engine, progress=False,
                               num_hosts=2, host_index=h)
        rows.append(stats["rows"])
        with np.load(tlabeler._shard_path(two, f"{model_type}_reward", h)) as ours, \
                np.load(jlabeler._shard_path(jax_two, f"{model_type}_reward", h)) as theirs:
            assert sorted(ours.files) == sorted(theirs.files)
            for name in ours.files:
                if ours[name].dtype.kind == "f":
                    np.testing.assert_allclose(ours[name], theirs[name], atol=1e-5)
                elif name != "encode_recipe":
                    np.testing.assert_array_equal(ours[name], theirs[name])
    assert rows == [(0, 20), (20, 30)]  # trajectory starts 0, 10 fall in [0, 15), 20 in [15, 30)
    with h5py.File(two, "r") as g:
        assert keys[0] not in g  # the shards leave the file alone until the merge
    assert tlabeler.merge_reward_shards(two, model_type=model_type) == {"num_hosts": 2, "rows": 30}
    jlabeler.merge_reward_shards(jax_two, model_type=model_type)
    single, merged, theirs = _read(one, keys), _read(two, keys), _read(jax_two, keys)
    for k in keys:
        if model_type == "goal_conditioned":  # each trajectory its own calls, the same on one host and on two
            np.testing.assert_array_equal(merged[k][0], single[k][0])
        else:  # the hosts' split at row 20 cuts the single host's batch of rows 16-23 into 16-19 and 20-23
            assert_within_shard_rounding(merged[k][0], single[k][0])
        assert merged[k][1] == single[k][1]
        np.testing.assert_allclose(merged[k][0], theirs[k][0], atol=1e-5)
        assert merged[k][1]["tokenizer_identity"] == theirs[k][1]["tokenizer_identity"]
    assert not list(tmp_path.glob("two.hdf5.*.rshard*"))  # cleaned up


def test_two_hosts_on_batch_boundaries_equal_one_host_bit_for_bit(tmp_path, jax_engine):
    """At batch 10 the hosts' split (row 20 of 30) falls on a device-batch boundary: every row is encoded in a
    batch of the same rows on one host and on two, and the merge is the single-host dataset bit for bit."""
    engine = ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE),
                              variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                              tokenizer=Char97Tokenizer(), batch_size=10, device="cpu")
    one, two = str(tmp_path / "one.hdf5"), str(tmp_path / "two.hdf5")
    _demo(one)
    shutil.copy(one, two)
    tlabeler.label_rewards(one, TEXT, engine=engine, progress=False)
    for h in range(2):
        tlabeler.label_rewards(two, TEXT, engine=engine, progress=False, num_hosts=2, host_index=h)
    tlabeler.merge_reward_shards(two)
    single, merged = _read(one), _read(two)
    for k in KEYS:
        np.testing.assert_array_equal(merged[k][0], single[k][0])
        assert merged[k][1] == single[k][1]


def test_more_hosts_than_trajectories_leave_an_empty_share(tmp_path, port_engine):
    path = str(tmp_path / "d.hdf5")
    _demo(path, n=12, ends=(5, 11))
    for h in range(4):
        tlabeler.label_rewards(path, TEXT, engine=port_engine, progress=False, num_hosts=4, host_index=h)
    with np.load(tlabeler._shard_path(path, "clip_reward", 1)) as empty:
        assert (int(empty["row_lo"]), int(empty["row_hi"])) == (0, 0) and empty["ob__reward"].shape == (0, 3)
    tlabeler.merge_reward_shards(path)
    assert _read(path)["ob_clip_reward"][0].shape == (12, 3)


def _two_shards(tmp_path, port_engine):
    path = str(tmp_path / "d.hdf5")
    _demo(path)
    for h in range(2):
        tlabeler.label_rewards(path, TEXT, engine=port_engine, progress=False, num_hosts=2, host_index=h)
    return path, [tlabeler._shard_path(path, "clip_reward", h) for h in range(2)]


def _rewrite(shard, **changes):
    with np.load(shard) as z:
        fields = {k: z[k] for k in z.files}
    fields.update(changes)
    for k in [k for k, v in changes.items() if v is None]:
        del fields[k]
    np.savez_compressed(shard, **fields)


@pytest.mark.parametrize("fault,error,match", [
    ("missing", FileNotFoundError, "missing reward shard"),
    ("truncated", ValueError, "corrupted reward shard"),
    ("wrong_shape", ValueError, "has shape"),
    ("missing_array", ValueError, "missing array ob__rtg"),
    ("foreign_geometry", ValueError, "inconsistent shard"),
    ("overlap", ValueError, "overlapping shard rows"),
    ("uncovered", ValueError, "first uncovered row"),
])
def test_merge_refusals_hold_as_in_jax(tmp_path, port_engine, fault, error, match):
    path, shards = _two_shards(tmp_path, port_engine)
    if fault == "missing":
        import os

        os.remove(shards[1])
    elif fault == "truncated":
        data = open(shards[1], "rb").read()
        open(shards[1], "wb").write(data[: len(data) // 2])
    elif fault == "wrong_shape":
        _rewrite(shards[1], ob__reward=np.zeros((3, 3), np.float32))
    elif fault == "missing_array":
        _rewrite(shards[1], ob__rtg=None)
    elif fault == "foreign_geometry":
        _rewrite(shards[1], num_frames=np.asarray(5))
    elif fault == "overlap":
        _rewrite(shards[1], row_lo=np.asarray(15), ob__reward=np.zeros((15, 3), np.float32),
                 ob__rtg=np.zeros((15, 3), np.float32))
    elif fault == "uncovered":
        _rewrite(shards[1], row_lo=np.asarray(25), ob__reward=np.zeros((5, 3), np.float32),
                 ob__rtg=np.zeros((5, 3), np.float32))
    jax_copy = str(tmp_path / "jax.hdf5")
    shutil.copy(path, jax_copy)
    for h, shard in enumerate(shards):
        if fault != "missing" or h == 0:
            shutil.copy(shard, jlabeler._shard_path(jax_copy, "clip_reward", h))
    with pytest.raises(error, match=match):
        tlabeler.merge_reward_shards(path)
    with pytest.raises(error, match=match):
        jlabeler.merge_reward_shards(jax_copy)
    with h5py.File(path, "r") as g:
        assert "ob_clip_reward" not in g  # nothing written


def _args(**over):
    base = dict(env_name="maze", env_type="none", distribution_mode="easy", start_level=5, num_levels=50,
                num_demonstrations=20, num_frames=4, enable_filter=True, base_path="/data/demos", split="val")
    return argparse.Namespace(**dict(base, **over))


@pytest.mark.parametrize("over", [{}, dict(enable_filter=False, env_type="aisc", split="train")],
                         ids=["filtered", "unfiltered_aisc"])
def test_default_data_path_matches_jax(over):
    assert tlabeler.default_data_path(_args(**over)) == jlabeler.default_data_path(_args(**over))


def test_cli_shards_merges_and_takes_the_collect_flags(tmp_path, jax_engine, capsys):
    """--base_path and the collect flags find the file; --num_hosts / --host_index then --merge equal one
    host; --resize_mode host reaches the engine; --mesh_dp beyond the devices raises (tests/test_torch_mesh_engine.py
    labels with --mesh_dp 2)."""
    spec = str(tmp_path / "tower.npz")
    jax_engine.save_npz(spec)
    args = _args(base_path=str(tmp_path), env_name="coinrun", split="train")
    path = tlabeler.default_data_path(args)
    import os

    os.makedirs(os.path.dirname(path))
    _demo(path)
    single = str(tmp_path / "single.hdf5")
    shutil.copy(path, single)
    flags = ["--base_path", str(tmp_path), "--env_name", "coinrun", "--distribution_mode", "easy",
             "--start_level", "5", "--num_levels", "50", "--num_demonstrations", "20", "--num_frames", "4",
             "--split", "train", "--enable_filter", "true", "--vl_checkpoint", spec, "--batch_size", "8",
             "--device", "cpu", "--resize_mode", "host"]
    for h in range(2):
        tlabeler.main(flags + ["--num_hosts", "2", "--host_index", str(h)])
    assert "run --merge after all hosts finish" in capsys.readouterr().out
    tlabeler.main(flags + ["--merge"])
    assert "[DONE] merged 2 host shards covering 30 rows" in capsys.readouterr().out
    tlabeler.main(["--data_path", single, "--vl_checkpoint", spec, "--batch_size", "8", "--device", "cpu"])
    got, want = _read(path), _read(single)
    for k in KEYS:
        # host and pil give the same bytes (tests/test_torch_arps.py); the hosts' split cuts a batch of 8
        assert_within_shard_rounding(got[k][0], want[k][0])
        assert got[k][1]["encode_recipe"] == want[k][1]["encode_recipe"].replace("resize=pil", "resize=host")
    with pytest.raises(ValueError, match="requested 100000 devices"):
        tlabeler.main(flags + ["--mesh_dp", "100000"])


def test_torch_to_flax_inverts_flax_to_torch(jax_engine):
    want = _flatten(jax.tree_util.tree_map(np.asarray, jax_engine.variables))
    got = _flatten(torch_to_flax(flax_to_torch(jax_engine.variables)))
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == np.float32 and got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_save_npz_is_read_by_both_packages(tmp_path, jax_engine, dtype):
    """A spec the port writes (from a bf16 engine too: the float32 weights) gives JAX's engine the rewards
    of the weights it came from, and the port's from_npz rebuilds the engine."""
    port = ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE),
                            variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                            tokenizer=Char97Tokenizer(), batch_size=8, device="cpu", compute_dtype=dtype)
    spec = str(tmp_path / "spec.npz")
    port.save_npz(spec)
    with np.load(spec) as ours:
        jax_spec = str(tmp_path / "jax.npz")
        jax_engine.save_npz(jax_spec)
        with np.load(jax_spec) as theirs:
            assert sorted(ours.files) == sorted(theirs.files)
            assert bytes(ours["__meta__"]) == bytes(theirs["__meta__"])
            for name in theirs.files:
                np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    frames = np.random.default_rng(8).integers(0, 256, size=(9, 40, 40, 3), dtype=np.uint8)
    reread = JEngine.from_npz(spec, batch_size=8)
    np.testing.assert_allclose(reread.text_rewards(frames, TEXT), jax_engine.text_rewards(frames, TEXT), atol=1e-5)
    again = ClipRewardEngine.from_npz(spec, batch_size=8, device="cpu")
    assert again.tokenizer_identity == "char97" and again.image_size == TINY_CLIP_IMG_SIZE
    np.testing.assert_allclose(again.text_rewards(frames, TEXT), jax_engine.text_rewards(frames, TEXT), atol=1e-5)


def test_save_npz_refuses_int8_weights(tmp_path, jax_engine):
    port = ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE),
                            variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                            tokenizer=Char97Tokenizer(), batch_size=8, device="cpu", quantize_weights=True)
    with pytest.raises(ValueError, match="quantize_weights"):
        port.save_npz(str(tmp_path / "q.npz"))
