"""The port's trainer CLI end to end on the CPU, after tests/test_trainer_e2e.py.

``python -m arp_tpu_torch.train.main`` (its ``main``, in-process) on a
synthetic labeled demo file: a run stopped after one epoch and resumed for
the second ends with the parameters and optimizer state of an uninterrupted
two-epoch run, bit for bit; the policy server serves the checkpoint the
trainer wrote; a NaN batch is detected and rolled back (or halts); the
profiler writes a trace; the flags whose paths are not ported raise.  (The rollout eval,
``--eval_env=fake``, is tests/test_torch_eval.py's.)
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from arp_tpu_torch import serve as S
from arp_tpu_torch.train import main as tmain
from test_torch_serve import _post, _start_main
from test_trainer_e2e import DATASET, make_labeled_dataset


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    root = tmp_path_factory.mktemp("demos")
    make_labeled_dataset(str(root))
    return str(root)


def argv(demos, out, *extra):
    return ["--device=cpu", "--warmup_epochs=0", "--batch_size=8", "--dataloader_n_workers=0", "--log_freq=2",
            "--lr=1e-3", "--lr_schedule=fixed", "--window_size=4", "--use_vl=True", "--vl_type=clip", "--use_crop=False",
            "--game_name=coinrun", "--val_every_epochs=1", "--test_every_epochs=0", "--eval_env=none",
            "--model.model_type=vit_debug", "--model.transfer_type=none", "--model.emb_dim=32", "--model.depth=2",
            "--model.num_heads=4", f"--data.path={demos}", "--data.image_size=32", "--data.num_frames=8",
            "--data.window_size=4", "--data.num_demonstrations=20", "--data.use_vl=True",
            f"--logging.output_dir={out}", *extra]


def records(out):
    run = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return run, [json.loads(line) for line in f]


def test_resume_ends_where_an_uninterrupted_run_ends_and_the_server_serves_it(demos, tmp_path):
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    tmain.main(argv(demos, str(tmp_path / "o1"), "--epochs=2", f"--checkpoint_dir={whole}", "--save_model_freq=4"))
    tmain.main(argv(demos, str(tmp_path / "o2"), "--epochs=1", f"--checkpoint_dir={split}", "--save_model_freq=4"))
    assert S.latest_step(split) == 6  # the batches consumed: one epoch of 6
    tmain.main(argv(demos, str(tmp_path / "o3"), "--epochs=2", f"--checkpoint_dir={split}", "--save_model_freq=4"))
    a = torch.load(os.path.join(whole, "step_12.pt"), weights_only=True)
    b = torch.load(os.path.join(split, "step_12.pt"), weights_only=True)
    assert a["step"] == b["step"] == 12 and a["metadata"] == b["metadata"] == {"step": 12, "epoch": 1}
    for key in a["state"]:
        assert torch.equal(a["state"][key], b["state"][key]), key
    for moment in ("mu", "nu"):
        for key in a["optimizer"][moment]:
            assert torch.equal(a["optimizer"][moment][key], b["optimizer"][moment][key]), key
    _, recs = records(str(tmp_path / "o3"))
    assert recs[-1]["final_step"] == 12 and any("val_loss" in r for r in recs)

    # the policy server serves what the trainer wrote
    started = _start_main(["serve", "--checkpoint_dir", split, "--port", "0", "--window_size", "4", "--image_size",
                           "32", "--emb_dim", "32", "--depth", "2", "--num_heads", "4", "--model_type", "vit_debug",
                           "--device", "cpu"])
    url = f"http://127.0.0.1:{started['port']}"
    try:
        obs = np.random.default_rng(0).integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        sid = _post(url + "/v1/session", {"return_to_go": 10.0, "scale": 10.0})["session_id"]
        served = _post(url + "/v1/act", {"session_id": sid, "observation": obs.tolist()})["action"]
        assert _post(url + "/v1/reload", {}) == {"status": "reloaded", "step": 12}
    finally:
        started["server"].shutdown()
    from arp_tpu_torch.models.policy import ARPDT
    from arp_tpu_torch.ops.augment import make_eval_transform

    model = ARPDT(dict(model_type="vit_debug", transfer_type="none", emb_dim=32, depth=2, num_heads=4,
                       use_discrete_action=True), num_actions=15, patch_dim=16)
    inputs = {"image": {"ob": make_eval_transform(32, device="cpu")(obs).numpy()[None, None]},
              "rtg": {"ob": np.ones((1, 1, 1), np.float32)}, "action": np.zeros((1, 1), np.int32),
              "instruct": None, "text_padding_mask": None}
    with torch.no_grad():
        model(inputs, deterministic=True)
        model.load_trained_state_dict(b["state"])
        assert served == int(model.greedy_action(inputs)[0])


def test_fault_rollback_heartbeat_and_halt(demos, tmp_path):
    common = ["--epochs=4", "--save_model_freq=2", "--fault_inject_step=5", "--heartbeat_interval=0.0",
              "--val_every_epochs=0"]
    out = str(tmp_path / "out")
    tmain.main(argv(demos, out, *common, "--fault_policy=rollback", f"--checkpoint_dir={tmp_path / 'ckpt'}"))
    run, recs = records(out)
    faulted = [r for r in recs if r.get("fault") == "nan"]
    assert faulted and faulted[0]["rolled_back_to"] >= 0
    later = [r for r in recs if "train_loss" in r and r.get("step", 0) > faulted[0]["step"]]
    assert later and all(np.isfinite(r["train_loss"]) for r in later)
    assert any("final_step" in r for r in recs)
    with open(os.path.join(run, "heartbeat")) as f:
        assert int(f.read().split()[1]) > 0  # the heartbeat advanced
    with pytest.raises(SystemExit, match="fault detector"):
        tmain.main(argv(demos, str(tmp_path / "out2"), *common, "--fault_policy=halt",
                        f"--checkpoint_dir={tmp_path / 'ckpt2'}"))


def test_profile_dir_writes_a_trace(demos, tmp_path):
    trace = tmp_path / "trace"
    tmain.main(argv(demos, str(tmp_path / "out"), "--epochs=1", f"--profile_dir={trace}", "--profile_start_step=1",
                    "--profile_steps=2", "--vl_type=BC", "--use_vl=False"))
    assert (trace / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flag,error,match", [
    # several processes are ported (tp and pp too): in one process --mesh_dp=2 / --mesh_tp=2 fail JAX's mesh
    # assertion (one device)
    ("--mesh_dp=2", AssertionError, "mesh 2x1x1x1 != 1 devices"),
    ("--mesh_tp=2", AssertionError, r"1 devices not divisible by dcn_dp\*fsdp\*tp\*pp=2"),
    # item 10 is ported: the flag reads a reference pickle, and a missing one raises
    pytest.param("--load_checkpoint=x.pkl", FileNotFoundError, "x.pkl", id="--load_checkpoint=x.pkl-item 10")],
    ids=["--mesh_dp=2-item 12", "--mesh_tp=2-item 12", None])
def test_unported_flags_raise(demos, tmp_path, flag, error, match):
    with pytest.raises(error, match=match):
        tmain.main(argv(demos, str(tmp_path / "out"), "--epochs=1", flag))


def test_flags_parse_like_absl(tmp_path):
    flags = tmain.parse_flags(["--use_vl=False", "--lr", "5e-4", "--model.m3ae.emb_dim=64", "--explicit_l2_penalty",
                               "--logging.output_dir=/x", "--data.image_size=256"])
    assert flags.use_vl is False and flags.lr == 5e-4 and flags.model.m3ae.emb_dim == 64
    assert flags.explicit_l2_penalty is True and flags.logging.output_dir == "/x" and flags.data.image_size == 256
    assert flags.device == "cuda" and flags.epochs == 100  # the JAX trainer's defaults
    with pytest.raises(SystemExit):
        tmain.parse_flags(["--model.no_such_field=1"])


def test_invalid_demo_file_is_refused_before_training(tmp_path):
    import h5py

    root = tmp_path / "demos"
    make_labeled_dataset(str(root))
    with h5py.File(root / DATASET / "data_train.hdf5", "a") as g:
        del g["act"]
    with pytest.raises(ValueError, match="invalid demo file"):
        tmain.main(argv(str(root), str(tmp_path / "out"), "--epochs=1"))


def test_frozen_int8_tower_keeps_its_calibration_with_the_checkpoints(demos, tmp_path, monkeypatch):
    """--model.frozen_int8 on a frozen M3AE tower (its state dict in $ARP_TPU_CHECKPOINT_DIR): the
    calibration scales land beside the checkpoints (frozen_int8_amax.npz, as in the JAX package), and
    a resume rebuilds the pack from them instead of calibrating again."""
    import chip_smoke
    from arp_tpu_torch.models import policy
    from arp_tpu_torch.models.m3ae import export_reference_m3ae_params

    built = []  # whether each pack came from saved scales
    real_build = policy.build_frozen_qpack
    monkeypatch.setattr(policy, "build_frozen_qpack",
                        lambda *a, **kw: built.append(kw.get("amax") is not None) or real_build(*a, **kw))

    dims = dict(emb_dim=32, depth=2, num_heads=4, mlp_ratio=2)
    towers = tmp_path / "towers"
    towers.mkdir()
    with open(towers / "m3ae_base_params.pkl", "wb") as f:  # the reference's pickle, as the JAX package reads it
        pickle.dump(export_reference_m3ae_params(chip_smoke.random_m3ae_variables(dims, 8, 30522, seed=1)), f)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(towers))
    ckpt = tmp_path / "ckpt"
    extra = ["--model.transfer_type=m3ae_vit_b16", "--model.frozen_int8=True", "--model.use_adapter=True",
             "--patch_dim=8", "--encode_image_size=32", "--val_every_epochs=0", f"--checkpoint_dir={ckpt}",
             *(f"--model.m3ae.{k}={v}" for k, v in dict(model_type="custom", **dims).items())]
    tmain.main(argv(demos, str(tmp_path / "o1"), "--epochs=1", *extra))
    saved = torch.load(ckpt / "step_6.pt", weights_only=True)
    scales = (ckpt / "frozen_int8_amax.npz").read_bytes()
    assert set(saved) == {"step", "state", "optimizer", "metadata", "best_score"}
    assert not any(k.startswith("pt_model.") for k in saved["state"])  # the frozen tower is not checkpointed
    tmain.main(argv(demos, str(tmp_path / "o2"), "--epochs=2", *extra))
    assert built == [False, True] and (ckpt / "frozen_int8_amax.npz").read_bytes() == scales
    _, recs = records(str(tmp_path / "o2"))
    assert recs[-1]["final_step"] == 12 and all(np.isfinite(r["train_loss"]) for r in recs if "train_loss" in r)
