"""The reward engines' single-process local-device mesh (ROADMAP 12b) against the JAX package's.

JAX shards each encode batch over its 8-device CPU mesh (GSPMD); the port splits each chunk's rows into
contiguous shares, share i on device i of a ``LocalMesh``.  Here the port's mesh is 8 CPU entries (the
stand-in for JAX's 8 CPU devices), or ``cpu`` and ``cpu:0`` alternating, which compare unequal, so the
engine copies its weights to a replica as it does for a second card.  Held, as in
tests/test_reward_engine.py:340-405 and tests/test_finetune.py:347:

  * float32 text and goal rewards on 19 frames (not a multiple of the batch): within 1e-4 of JAX's meshed
    engine (BASELINE's bound), bit-equal to the port's engine without a mesh at the share's batch (1 row:
    every share is encoded alone, the rows come back in order) and within JAX's sharded-engine bound
    (rtol 1e-5, atol 1e-6) of it at the whole batch (the CPU's matmuls round a 1-row and an 8-row batch
    apart: 4.5e-8 read here);
  * fast_int8: the calibration on the whole first chunk gives the unmeshed engine's scales bit for bit,
    rewards within JAX's 0.15 bound;
  * a batch the mesh does not divide raises ("divisible"); ``mesh_from_count``'s contract;
  * the clip_ft engine under the mesh within 1e-4 of JAX's meshed clip_ft engine and within rtol 1e-5 /
    atol 1e-6 of itself without a mesh;
  * the labeler CLI with ``--mesh_dp 2`` writes the rewards it writes without.
"""

import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

from arp_tpu.parallel import MeshConfig as JMeshConfig
from arp_tpu.parallel import create_mesh as jcreate_mesh
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.finetune.convert import flax_adapter_to_torch
from arp_tpu_torch.finetune.reward import ClipFtRewardEngine
from arp_tpu_torch.models.clip import CLIP
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.parallel import mesh as tmesh
from arp_tpu_torch.reward import labeler as tlabeler
from arp_tpu_torch.reward.engine import ClipRewardEngine
from test_finetune import TINY_CFG, tiny_tokens
from test_torch_finetune_engine import ft_setup  # noqa: F401  (the fixture)

MAE, INT8_BOUND = 1e-4, 0.15
EIGHT = ["cpu"] * 8
COPIES = ["cpu", "cpu:0"] * 4  # unequal devices: the second replica holds copies of the weights
TEXT = "collect the coin."


@pytest.fixture(scope="module")
def jax_engines():
    mesh = jcreate_mesh(JMeshConfig(dp=-1))
    return make_tiny_clip_engine(batch_size=8), make_tiny_clip_engine(batch_size=8, mesh=mesh)


def _port(jax_engine, **kw):
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    kw.setdefault("device", "cpu")
    kw.setdefault("batch_size", 8)
    return ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), variables=variables,
                            tokenizer=Char97Tokenizer(), **kw)


def _frames(seed, n, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), np.uint8)


@pytest.mark.parametrize("devices", [EIGHT, COPIES], ids=["eight_cpu", "replica_copies"])
def test_meshed_engine_matches_jax_s_mesh_and_the_unmeshed_engine(jax_engines, devices):
    single, jmeshed = jax_engines
    meshed = _port(single, mesh=tmesh.mesh_from_count(-1, devices=devices))
    plain, row = _port(single), _port(single, batch_size=1)
    assert meshed.mesh.shape == {"dp": 8, "fsdp": 1, "tp": 1, "pp": 1} and len(meshed._replicas) == 8
    assert len({id(r) for r in meshed._replicas}) == len(set(devices))
    frames = _frames(11, 19)
    for rewards in (lambda e: e.text_rewards(frames, TEXT), lambda e: e.goal_rewards(frames)):
        got, want = rewards(meshed), rewards(jmeshed)
        assert got.shape == (19,) and np.abs(got - want).mean() <= MAE
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(got, rewards(row))
        np.testing.assert_allclose(got, rewards(plain), rtol=1e-5, atol=1e-6)


def test_meshed_fast_int8_calibrates_on_the_whole_first_chunk(jax_engines):
    single, jmeshed = jax_engines
    meshed = _port(single, fast_int8=True, mesh=tmesh.LocalMesh(COPIES))
    plain, row = _port(single, fast_int8=True), _port(single, fast_int8=True, batch_size=1)
    frames = _frames(12, 16)
    got, own = meshed.text_rewards(frames, TEXT), plain.text_rewards(frames, TEXT)
    assert meshed._fast_q is not None and plain._fast_q is not None
    for a, b in zip(_leaves(meshed._fast_q), _leaves(plain._fast_q)):
        assert torch.equal(a, b)
    copy = meshed._replicas[1]
    assert copy is not meshed and all(torch.equal(a, b) for a, b in zip(_leaves(copy._fast_q), _leaves(plain._fast_q)))
    want = single.text_rewards(frames, TEXT)
    assert np.max(np.abs(got - want)) < INT8_BOUND * max(1.0, np.max(np.abs(want)))
    np.testing.assert_allclose(got, own, rtol=1e-5, atol=1e-6)
    row._fast_q = plain._fast_q  # the whole first chunk's scales: a 1-row engine would calibrate on 1 row
    np.testing.assert_array_equal(got, row.text_rewards(frames, TEXT))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_meshed_engine_rejects_an_indivisible_batch(jax_engines):
    with pytest.raises(ValueError, match="divisible"):
        ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), batch_size=12,
                         tokenizer=Char97Tokenizer(), mesh=tmesh.LocalMesh(EIGHT))


def test_mesh_from_count_contract(monkeypatch):
    """--mesh_dp: 0 -> no mesh, -1 -> all devices, n -> the first n; more than there are raises, and so does a
    world of several processes (tests/test_parallel.py:165).  Without a card, -1 over the cards raises."""
    devices = [f"cpu:{i}" for i in range(8)]
    assert tmesh.mesh_from_count(0, devices=devices) is None
    assert tmesh.mesh_from_count(-1, devices=devices).size == 8
    m4 = tmesh.mesh_from_count(4, devices=devices)
    assert m4.size == 4 and m4.shape["dp"] == 4 and m4.devices == [torch.device(d) for d in devices[:4]]
    with pytest.raises(ValueError, match="have 8"):
        tmesh.mesh_from_count(9, devices=devices)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 0 devices, have 0"):
            tmesh.mesh_from_count(-1)
    # the CPU is one device, as JAX's local_devices() on the CPU
    assert tmesh.local_devices("cpu") == [torch.device("cpu")]
    assert tmesh.mesh_from_count(-1, device_type="cpu").devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tmesh.mesh_from_count(2, device_type="cpu")
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    with pytest.raises(RuntimeError, match="--num_hosts/--host_index"):
        tmesh.mesh_from_count(2, devices=devices)


def test_clip_ft_engine_under_the_mesh(ft_setup):  # noqa: F811
    """The adapter engine inherits the mesh, its adapter replicated too (tests/test_finetune.py:347): on 8
    frames (one batch, a frame a share) within 1e-4 of JAX's engine on its 8-device mesh, and within JAX's
    sharded-engine bound of the port's engine without one."""
    from arp_tpu.finetune.reward import ClipFtRewardEngine as JClipFtRewardEngine

    model, clip_vars, params = ft_setup
    common = dict(batch_size=8, image_size=224, tokenizer=lambda text: tiny_tokens(1), clip_config=TINY_CFG)
    jmeshed = JClipFtRewardEngine(adapter_params=params, clip_variables=clip_vars, adapter=model,
                                  mesh=jcreate_mesh(JMeshConfig(dp=-1)), **common)
    kw = dict(adapter_params=flax_adapter_to_torch(jax.tree_util.tree_map(np.asarray, params)),
              clip_variables=jax.tree_util.tree_map(np.asarray, clip_vars), device="cpu", **common)
    base, meshed = ClipFtRewardEngine(**kw), ClipFtRewardEngine(**kw, mesh=tmesh.LocalMesh(COPIES))
    assert meshed._replicas[1].adapter is not meshed.adapter
    frames = _frames(23, 8, 32)
    for rewards in (lambda e: e.text_rewards(frames, "get the coin"), lambda e: e.goal_rewards(frames)):
        got, want = rewards(meshed), rewards(jmeshed)
        assert got.shape == (8,) and np.abs(got - want).mean() <= MAE
        np.testing.assert_allclose(got, rewards(base), rtol=1e-5, atol=1e-6)


def test_labeler_with_mesh_dp_writes_the_rewards_it_writes_without(jax_engines, tmp_path, capsys, monkeypatch):
    """The CPU is one device: the test lists it twice for --mesh_dp 2."""
    single, _ = jax_engines
    monkeypatch.setattr(tmesh, "local_devices", lambda device_type: [torch.device("cpu")] * 2)
    spec = str(tmp_path / "tower.npz")
    single.save_npz(spec)
    path = str(tmp_path / "demo.hdf5")
    rng = np.random.default_rng(7)
    with h5py.File(path, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, (6, 4, 48, 48, 3), np.uint8))
        g.create_dataset("done", data=np.eye(6, 4, 3, dtype=bool) | (np.arange(4) == 3)[None])
    meshed = str(tmp_path / "meshed.hdf5")
    shutil.copy(path, meshed)
    flags = ["--vl_checkpoint", spec, "--batch_size", "8", "--device", "cpu"]
    tlabeler.main(["--data_path", path] + flags)
    tlabeler.main(["--data_path", meshed, "--mesh_dp", "2"] + flags)
    assert "[INFO] labeling data-parallel over 2 devices" in capsys.readouterr().out
    with h5py.File(path, "r") as a, h5py.File(meshed, "r") as b:
        for key in ("ob_clip_reward", "ob_clip_pos_rtg"):
            np.testing.assert_array_equal(a[key][:], b[key][:])
