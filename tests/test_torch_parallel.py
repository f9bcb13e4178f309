"""The port's data mesh over processes (arp_tpu_torch/parallel/) against the JAX package's mesh.

``MeshConfig.resolve`` is JAX's, assertion for assertion.  Two gloo ranks on the
CPU, spawned once for the module (tests/torch_parallel_workers.py, joined through a
file store), train the vit_debug ARPDT of tests/test_mesh_equivalence.py on weights
carried from Flax: three clipped-SGD steps at dp=2, fsdp=2 and dcn_dp=2 x dp=1 are
held against JAX's ``MeshConfig(dp=-1)`` run on the 8-device CPU mesh within JAX's
own bounds (loss 1e-4, params 2e-4), and against the port's one-process run
within 1e-5.  The same spawn holds gradient accumulation under dp, AdamW on
fsdp-sharded parameters, checkpoints crossing world sizes and the frozen_int8
calibration.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from arp_tpu.parallel.mesh import MeshConfig as JMeshConfig
from arp_tpu_torch.models.policy import convert
from arp_tpu_torch.parallel import distributed as tdist
from arp_tpu_torch.parallel import mesh as tmesh
from test_mesh_equivalence import _setup, _train

JAX_LOSS, JAX_PARAMS, PORT = 1e-4, 2e-4, 1e-5  # JAX's mesh-equivalence bounds; the port's own


@pytest.mark.parametrize("n,cfg", [
    (1, {}), (8, {}), (8, dict(dp=2, fsdp=2, tp=2)), (8, dict(fsdp=2)), (8, dict(dp=4, fsdp=2)),
    (8, dict(dcn_dp=2)), (8, dict(dp=2, dcn_dp=2, fsdp=2)), (4, dict(dp=4, pp=1)), (8, dict(dp=4, pp=2)),
    (2, dict(dp=1, dcn_dp=2)), (2, dict(dp=1, fsdp=2)),
    # JAX's assertions, message for message
    (8, dict(fsdp=3)), (6, dict(dp=4)), (8, dict(pp=2, tp=2)), (1, dict(dp=2)), (1, dict(fsdp=4)),
])
def test_mesh_config_resolves_as_jax(n, cfg):
    def resolve(cls):
        try:
            return cls(**cfg).resolve(n), None
        except AssertionError as e:
            return None, str(e)

    assert resolve(tmesh.MeshConfig) == resolve(JMeshConfig)


def test_a_single_process_without_a_launcher_is_one_process(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert tdist.initialize(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized() and tmesh.create_mesh(tmesh.MeshConfig(), "cpu") is None
    assert tmesh.data_share(None) == (0, 1) and tmesh.batch_share({"a": np.arange(4)}, None)["a"].shape == (4,)


def test_an_explicit_coordinator_that_cannot_be_reached_raises():
    with pytest.raises(Exception, match="(?i)timed out|connect|refused"):
        tdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1, device="cpu", timeout_s=2)
    assert not torch.distributed.is_initialized()


def test_a_cuda_process_group_without_a_card_raises_and_does_not_fall_back(tmp_path):
    with pytest.raises(RuntimeError, match="is_available"):
        tdist.initialize(init_method=f"file://{tmp_path}/store", num_processes=1, process_id=0, device="cuda")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cfg", [dict(tp=2), dict(pp=2)])
def test_tensor_and_pipeline_axes_raise_citing_12c(cfg, monkeypatch):
    """Item 12c is ported (tests/test_torch_tp_pp.py): the tp and pp axes resolve as JAX's do, outside a
    process group there is no mesh, and a world they do not fit raises JAX's assertion."""
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    assert tmesh.create_mesh(tmesh.MeshConfig(dp=1, **cfg), "cpu") is None
    monkeypatch.setattr(tmesh, "process_count", lambda: 3)
    with pytest.raises(AssertionError, match="not divisible"):
        tmesh.create_mesh(tmesh.MeshConfig(**cfg), "cpu")


@pytest.mark.parametrize("flag", ["--mesh_tp=2", "--mesh_pp=2"])
def test_the_trainer_refuses_tp_and_pp_citing_12c(flag):
    """In one process --mesh_tp=2 / --mesh_pp=2 fail JAX's mesh assertion, as --mesh_dp=2 does (item 12c
    runs them under torchrun: tests/test_torch_parallel_trainers.py)."""
    from arp_tpu_torch.train import main as tmain

    with pytest.raises(AssertionError, match="not divisible"):
        tmain.main([flag, "--device=cpu"])


def test_a_pipelined_policy_raises_citing_12c():
    """A pipelined policy needs the mesh whose pp axis it runs over (item 12c: models/layers.py)."""
    from arp_tpu_torch.models.policy import ARPDT

    with pytest.raises(ValueError, match="pass the mesh"):
        ARPDT(dict(W.ARPDT_CFG, pp_stages=2), num_actions=15, patch_dim=16)


def test_dcn_dp_that_is_not_the_node_count_raises(monkeypatch):
    monkeypatch.setattr(tmesh, "process_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")  # four nodes of one process
    with pytest.raises(ValueError, match="dcn_dp=2 but the world spans 4 nodes"):
        tmesh.create_mesh(tmesh.MeshConfig(dcn_dp=2), "cpu")


class _Axis:
    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


@pytest.mark.parametrize("dp,fsdp,accum", [(2, 1, 1), (1, 2, 1), (2, 2, 1), (2, 1, 2)])
def test_batch_share_takes_each_rank_s_rows(dp, fsdp, accum):
    """Every rank's rows together are the batch once; with accumulation each microbatch's rows split too."""
    batch = {"x": np.arange(16 * 3).reshape(16, 3), "d": {"y": np.arange(16)}, "none": None}
    shares = []
    for r in range(dp * fsdp):
        mesh = {"dp": _Axis(dp, r // fsdp), "fsdp": _Axis(fsdp, r % fsdp)}
        share = tmesh.batch_share(batch, mesh, accum)
        assert share["none"] is None and np.array_equal(share["x"][:, 0] // 3, share["d"]["y"])
        shares.append(share["d"]["y"])
    assert sorted(np.concatenate(shares).tolist()) == list(range(16))
    micro = [np.concatenate([s.reshape(accum, -1)[i] for s in shares]) for i in range(accum)]
    assert [sorted(m.tolist()) for m in micro] == [list(range(i * 16 // accum, (i + 1) * 16 // accum))
                                                    for i in range(accum)]


# -- two gloo ranks ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's run on its 8-device CPU mesh, and the weights and batch it starts from."""
    _, state, batch, _ = _setup()
    params, loss = _train(JMeshConfig(dp=-1))
    return {"init": convert.flax_policy_to_torch(jax.device_get(state.params)), "batch": batch,
            "params": convert.flax_policy_to_torch(params), "loss": loss}


@pytest.fixture(scope="module")
def ranks(jax_reference, tmp_path_factory):
    rng = np.random.default_rng(5)
    calibration = {"image": {"ob": rng.integers(0, 256, size=(4, 2, 32, 32, 3), dtype=np.uint8)},
                   "rtg": {"ob": rng.normal(size=(4, 2, 1)).astype(np.float32)},
                   "action": rng.integers(0, 15, size=(4, 2)).astype(np.int32), "goal": None, "instruct": None,
                   "text_padding_mask": None}
    payload = {"init": {k: v.numpy() for k, v in jax_reference["init"].items()}, "batch": jax_reference["batch"],
               "calibration_batch": calibration}
    return W.spawn(["case_meshes", "case_accum", "case_adamw_sharded", "case_checkpoint", "case_calibration"],
                   payload, tmp_path_factory.mktemp("ranks"))


def _max_abs(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want)


@pytest.mark.parametrize("layout", ["dp", "fsdp", "dcn_dp"])
def test_two_ranks_train_as_jax_s_mesh_and_as_one_process(ranks, jax_reference, layout):
    got, one = ranks[0]["case_meshes"][layout], ranks[0]["case_meshes"]["one"]
    assert abs(got["loss"] - jax_reference["loss"]) < JAX_LOSS
    assert _max_abs(got["params"], {k: v.numpy() for k, v in jax_reference["params"].items()}) < JAX_PARAMS
    assert abs(got["loss"] - one["loss"]) <= PORT * abs(one["loss"])
    assert _max_abs(got["params"], one["params"]) < PORT
    # every rank holds the same (gathered) parameters
    assert _max_abs(ranks[1]["case_meshes"][layout]["params"], got["params"]) == 0.0


def test_one_process_trains_as_jax_s_mesh(ranks, jax_reference):
    one = ranks[0]["case_meshes"]["one"]
    assert abs(one["loss"] - jax_reference["loss"]) < JAX_LOSS
    assert _max_abs(one["params"], {k: v.numpy() for k, v in jax_reference["params"].items()}) < JAX_PARAMS


def test_fsdp_shards_block_by_block(ranks):
    """Under fsdp each transformer block is an FSDP2 unit of its own and the root holds the rest, so a
    block's parameters are gathered only around its forward and backward; dp wraps no unit."""
    for rank in ranks:
        fsdp, dp = rank["case_meshes"]["fsdp"], rank["case_meshes"]["dp"]
        assert len(fsdp["blocks"]) == 2 and fsdp["fsdp_units"] == [""] + fsdp["blocks"]
        assert dp["fsdp_units"] == [] and len(dp["blocks"]) == 2


def test_accumulation_under_dp_is_the_full_batch_s_step(ranks):
    got = ranks[0]["case_accum"]
    assert abs(got["loss"] - got["want_loss"]) <= PORT * abs(got["want_loss"])
    assert _max_abs(got["params"], got["want"]) < PORT


def test_adamw_on_sharded_parameters_is_the_unsharded_update(ranks):
    """Bit for bit: every step is elementwise on the shards; the norm is the whole gradient's, and the
    clip engages (norms above 0.5)."""
    got = ranks[0]["case_adamw_sharded"]
    assert min(got["norms"]) > 0.5 and got["sharded_mu_is_dtensor"] == "DTensor"
    for a, b in [(got["whole"], got["sharded"]), got["mu"], got["nu"]]:
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_a_checkpoint_resumes_at_another_world_size(ranks, direction):
    """The file is the full state: restored bit for bit at the other world size, and its next step is
    the uninterrupted run's within the port's bound (AdamW, lr 1e-3)."""
    for rank in ranks:
        got = rank["case_checkpoint"][direction]
        assert got["files"] == ["step_2.pt"] and got["meta_step"] == 2
        saved, restored = got["saved"], got["restored"]
        assert restored["count"] == saved["count"] == 2 and restored["step"] == saved["step"] == 2
        assert all(np.array_equal(saved["params"][k], restored["params"][k]) for k in saved["params"])
        assert all(np.array_equal(x, y) for x, y in zip(saved["mu"] + saved["nu"], restored["mu"] + restored["nu"]))
        assert _max_abs(got["resumed"]["params"], got["uninterrupted"]["params"]) < PORT


def test_frozen_int8_scales_are_the_global_batch_s(ranks):
    """Each rank calibrates on its half of the first batch; the maximum over the ranks is the scale one
    process finds on the whole batch, bit for bit, and rank 0 wrote it."""
    for rank in ranks:
        two, one = rank["case_calibration"]["two"], rank["case_calibration"]["one"]
        assert np.array_equal(two["img"], one["img"]) and set(two["layers"]) == set(one["layers"])
        assert all(np.array_equal(two["layers"][k], one["layers"][k]) for k in one["layers"])
