"""The full ARP pipeline through the port alone: collect -> label -> train -> eval (the counterpart of
tests/test_full_pipeline.py, at its sizes, on the CPU).

Demonstrations are collected from FakeProcgen by the scripted expert with the port's recorder,
labeled with CLIP rewards by the port's labeler over a tiny CLIP engine of random weights, used to
train an ARPDT through the port's trainer CLI (in-process, with the rollout eval every epoch), and
evaluated twice by the port's eval CLI: from the trainer's ``--checkpoint_dir``, and from the trained
state exported with ``save_reference_checkpoint`` and read back with ``--load_checkpoint``.  A second
case starts stage 1 from the port's own expert instead: a PPG policy trained by ``train_ppg`` collects
the demos through the ``collect`` CLI (unfiltered, as tests/test_collect.py collects with it).  The
CLIs run in-process, as tests/test_torch_trainer_e2e.py runs them.  The check is the stages'
outputs: the recorded and labeled keys, the losses, the eval metrics finite.
"""

import ast
import json
import os

import h5py
import numpy as np
import pytest
import torch

from arp_tpu_torch.checkpoint import latest_step, load_policy_state, save_reference_checkpoint
from arp_tpu_torch.collect.recorder import collect_demonstrations
from arp_tpu_torch.envs.fake import FakeProcgen
from arp_tpu_torch.reward.labeler import label_rewards
from arp_tpu_torch.testing import make_tiny_clip_engine, scripted_coin_expert
from arp_tpu_torch.train import eval as teval
from arp_tpu_torch.train import main as tmain

DATASET = "coinrun_hard_level0to500_num4_frame8"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def common_flags(tmp_path, spec, ensembles=2, dataset_flags=("--data.image_size=32",)):
    return ["--device=cpu", "--window_size=4", "--use_vl=True", "--vl_type=clip", "--use_crop=False",
            "--game_name=coinrun", "--num_test_episodes=1", "--episode_length=6", "--eval_env=fake",
            f"--vl_checkpoint={spec}", "--model.model_type=vit_debug", "--model.transfer_type=none",
            "--model.emb_dim=32", "--model.depth=2", "--model.num_heads=4", "--model.mlp_ratio=2",
            f"--model.num_ensembles={ensembles}", f"--data.path={tmp_path / 'demos'}", *dataset_flags,
            "--data.num_frames=8", "--data.window_size=4", "--data.num_demonstrations=4", "--data.use_vl=True"]


def last_metrics(capsys) -> dict:
    metrics = ast.literal_eval([line for line in capsys.readouterr().out.strip().splitlines()
                                if line.startswith("{")][-1])
    assert {"return", "episode_length"} <= set(metrics), metrics
    assert np.isfinite(metrics["return"]) and metrics["episode_length"] > 0, metrics
    return metrics


def test_five_stage_pipeline(tmp_path, capsys):
    data_root = tmp_path / "demos" / DATASET
    data_root.mkdir(parents=True)

    # stage 1: expert demos, train and val
    for split, n_eps in (("train", 4), ("val", 2)):
        env = FakeProcgen("coinrun", {"episode_length": 30, "image_size": 32, "grid": 4})
        rec = collect_demonstrations(env, scripted_coin_expert, str(data_root / f"data_{split}.hdf5"),
                                     num_episodes=n_eps, game_name="coinrun", num_frames=8,
                                     seed=0 if split == "train" else 100)
        assert rec.num_recorded == n_eps

    stages_2_to_5(tmp_path, capsys, data_root)


def stages_2_to_5(tmp_path, capsys, data_root, dataset_flags=("--data.image_size=32",)):
    """Label the demos in ``data_root``, train on them with the rollout eval, and evaluate twice."""
    # stage 2: CLIP rewards from a tiny engine through the labeler; the same engine's spec rewards the rollouts
    engine = make_tiny_clip_engine(batch_size=8, device="cpu")
    spec = str(tmp_path / "tower.npz")
    engine.save_npz(spec)
    for split in ("train", "val"):
        stats = label_rewards(str(data_root / f"data_{split}.hdf5"), "the goal is to collect the coin.",
                              engine=engine, progress=False)
        assert stats["frames"] > 0
    with h5py.File(data_root / "data_train.hdf5", "r") as g:
        assert {"ob", "act", "done", "reward", "ob_clip_reward", "ob_clip_pos_rtg"} <= set(g)
        assert np.isfinite(g["ob_clip_reward"][...]).all()

    # stage 4: ARPDT through the trainer CLI, with the rollout eval (stage 5) every epoch
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    tmain.main(common_flags(tmp_path, spec, dataset_flags=dataset_flags) + [
        "--epochs=2", "--warmup_epochs=0", "--batch_size=8", "--dataloader_n_workers=0", "--log_freq=2",
        "--lr=1e-3", "--val_every_epochs=0", "--test_every_epochs=1", f"--checkpoint_dir={ckpt}",
        f"--logging.output_dir={out}"])
    with open(os.path.join(out, os.listdir(out)[0], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert any("test/return" in r for r in records) and any("train_loss" in r for r in records)
    assert all(np.isfinite(r["train_loss"]) for r in records if "train_loss" in r)

    # stage 5 on its own: the eval CLI on the trainer's checkpoint, with seeded temperature sampling
    teval.main(common_flags(tmp_path, spec, dataset_flags=dataset_flags) + [f"--checkpoint_dir={ckpt}", "--eval_temperature=0.7",
                                               f"--logging.output_dir={tmp_path / 'eval1'}"])
    last_metrics(capsys)

    # and on the same policy written in the reference's format: the reference holds one head, so the
    # first member is exported and the loader broadcasts it to 5
    state, meta = load_policy_state(str(ckpt))
    path = str(tmp_path / "model_best.pkl")
    save_reference_checkpoint(path, state, step=meta["step"], epoch=1, ensemble_mode="first")
    assert latest_step(str(ckpt)) == meta["step"]
    teval.main(common_flags(tmp_path, spec, ensembles=5, dataset_flags=dataset_flags) + [f"--load_checkpoint={path}",
                                                            f"--logging.output_dir={tmp_path / 'eval2'}"])
    last_metrics(capsys)


def test_five_stage_pipeline_from_a_trained_ppg_expert(tmp_path, capsys):
    """Stage 1 through the port's PPG CLIs (in-process): train an expert, collect with it at 64 x 64."""
    from arp_tpu_torch.collect import collect, train_ppg

    ckpt = str(tmp_path / "ppg.pkl")
    _, history = train_ppg.main(["--device=cpu", "--fake_env=True", "--num_envs=2", "--segment_length=8",
                                 "--total_iterations=2", "--n_pi=2", "--n_aux_epochs=1", "--episode_length=10",
                                 f"--checkpoint_path={ckpt}", f"--logging.output_dir={tmp_path / 'ppg_log'}"])
    assert len(history) == 2 and all(np.isfinite(v) for r in history for v in r.values())
    for split, n_eps in (("train", 4), ("val", 2)):
        rec = collect.main(["--device=cpu", "--fake_env=True", "--game_name=coinrun", f"--num_episodes={n_eps}",
                            "--num_demonstrations=4", "--num_frames=8", "--episode_length=12", "--enable_filter=False",
                            f"--split={split}", f"--model_path={ckpt}", f"--out_dir={tmp_path / 'demos'}",
                            f"--seed={0 if split == 'train' else 100}"])
        assert rec.num_recorded == n_eps
    data_root = tmp_path / "demos" / (DATASET + "_unfiltered")
    stages_2_to_5(tmp_path, capsys, data_root, dataset_flags=("--data.image_size=64", "--data.enable_filter=False"))
