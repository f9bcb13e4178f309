"""The four training CLIs of the port over two gloo ranks on the CPU, as ``torchrun --nproc_per_node=2``
starts them (``--device=cpu``), spawned once for the module (tests/torch_parallel_workers.py).

  * the trainer at --mesh_dp=2 and --mesh_fsdp=2: each rank's batches are the JAX per-process
    loader's for its process index; the ranks end with the same parameters; only rank 0 logs and
    writes checkpoints; the first step is the one-process step on both ranks' rows within 1e-5;
    at --mesh_tp=2 and --mesh_pp=2 both ranks read the one data share's batches (JAX's process 0 of
    1), and the first step is the one-process step on them;
  * M3AE pretraining: one step at dp=2 and fsdp=2 on given masking draws equal to one process's
    and to JAX's (the bounds of tests/test_torch_m3ae_pretrain.py); the CLI at both layouts ends
    where the one-process CLI ends, within 1e-5, with one masking permutation on every rank;
  * fine-tuning: the VIP loss at dp=2 is the global batch's (and the mean of the ranks' own VIP
    losses is not); one step and the CLI at --mesh_dp=2 end where one process ends;
  * PPG: one iteration of train_ppg at --mesh_dp=2: env seeds offset by 100003 a rank, the update's
    gradient the average over the ranks (one process's on both ranks' rows), the params alike.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as W
from arp_tpu.data import loader as jloader
from arp_tpu.data import procgen_dataset as jds
from arp_tpu_torch.checkpoint import latest_step, load_policy_state
from arp_tpu_torch.finetune import train as tft
from arp_tpu_torch.finetune.adapter_model import ClipMultiscaleAdapter
from arp_tpu_torch.models.policy.convert import torch_policy_to_flax
from arp_tpu_torch.models.clip.convert import _flatten
from arp_tpu_torch.train import pretrain_m3ae as tpre
from test_torch_finetune_engine import _demo_file
from test_torch_m3ae_pretrain import (CFG, FRAME, IMG, NPATCH, PATCH, PATCH_DIM, TEXT, VOCAB, close, draws, feed_draws,
                                      host_tree, jax_decay_mask, jax_loss_fn, m3ae_pair)
from test_trainer_e2e import DATASET, make_labeled_dataset

PORT = 1e-5
SEED = 42
TRAINER_DATA = dict(image_size=32, num_frames=8, window_size=4, num_demonstrations=20, use_vl=True)


def trainer_argv(demos):
    return ["--device=cpu", "--warmup_epochs=0", "--batch_size=8", "--dataloader_n_workers=0", "--log_freq=2",
            "--lr=1e-3", "--lr_schedule=fixed", "--window_size=4", "--use_vl=True", "--vl_type=clip",
            "--use_crop=False", "--game_name=coinrun", "--val_every_epochs=1", "--test_every_epochs=1",
            "--eval_env=fake", "--num_test_episodes=1", "--episode_length=4", "--model.model_type=vit_debug", "--model.transfer_type=none", "--model.emb_dim=32",
            "--model.depth=2", "--model.num_heads=4", f"--data.path={demos}", "--epochs=1", "--save_model_freq=2",
            *[f"--data.{k}={v}" for k, v in TRAINER_DATA.items()]]


def pretrain_argv(root):
    return ["--device=cpu", "--epochs=1", "--batch_size=8", "--log_freq=1", "--lr=1e-3", f"--dataset_name={DATASET}",
            "--patch_size=8", "--image_size=32", "--text_length=16", "--model.model_type=custom", "--model.emb_dim=32",
            "--model.dec_emb_dim=16", "--model.depth=2", "--model.dec_depth=1", "--model.num_heads=4",
            "--model.dec_num_heads=4", "--model.mlp_ratio=2", f"--data.path={root}", "--data.image_size=32",
            "--data.num_frames=8", "--data.window_size=4"]


def finetune_argv(root):
    return ["--device=cpu", "--epochs=1", "--batch_size=4", "--log_freq=1", "--dataset_name=coinrun_tiny",
            "--clip_model=tiny_test", "--clip_checkpoint=random", f"--data.path={root}", "--data.image_key=ob"]


PPG_ARGV = ["--device=cpu", "--fake_env=True", "--num_envs=2", "--segment_length=8", "--total_iterations=1",
            "--n_pi=1", "--n_aux_epochs=1", "--episode_length=10"]


@pytest.fixture(scope="module")
def pretrain_pair():
    """The Flax M3AE and the port's on its weights, a batch of 4 and the masking draws of one step."""
    jmodel, variables, tmodel = m3ae_pair(seed=3)
    rng = np.random.default_rng(11)
    batch = {"image": rng.integers(0, 256, size=(4, FRAME, FRAME, 3), dtype=np.uint8),
             "text": np.tile(rng.integers(1, VOCAB, size=(1, TEXT)).astype(np.int32), (4, 1)),
             "text_padding_mask": np.tile((np.arange(TEXT) >= 6).astype(np.float32), (4, 1))}
    return jmodel, variables, tmodel, batch, draws(4, NPATCH, TEXT)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    demos = root / "demos"
    make_labeled_dataset(str(demos))
    small = root / "small"
    make_labeled_dataset(str(small), n=16)
    ft = root / "ft" / "coinrun_tiny"
    ft.mkdir(parents=True)
    for seed, split in enumerate(("train", "val")):
        _demo_file(ft / f"data_{split}.hdf5", n=16, f=2, size=32, seed=seed)
    return {"demos": str(demos), "small": str(small), "ft": str(root / "ft")}


def finetune_payload():
    torch.manual_seed(3)
    adapter = ClipMultiscaleAdapter(clip_config=tft.TINY_CLIP, action_dim=15)
    rng = np.random.default_rng(9)
    batch = {f"image{i}": {"ob": rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)} for i in range(4)}
    instruct = rng.integers(1, 400, size=(8, 77)).astype(np.int64)
    instruct[:, 12] = 49407  # the end-of-text token: the argmax the adapter reads
    batch.update(instruct=instruct, action=rng.integers(0, 15, size=(8,)).astype(np.int64),
                 r=np.repeat(np.array([0.0, 3.0], np.float32), 4))  # the two ranks' shares far apart
    return {"clip_cfg": tft.TINY_CLIP, "adapter": {k: v.detach().numpy() for k, v in adapter.state_dict().items()},
            "batch": batch}


@pytest.fixture(scope="module")
def ranks(data, pretrain_pair, tmp_path_factory):
    _, _, tmodel, batch, masks = pretrain_pair
    payload = {
        "trainer_argv": trainer_argv(data["demos"]), "trainer_seed": SEED,
        "pretrain": {"cfg": CFG, "vocab": VOCAB, "patch_dim": PATCH_DIM, "img": IMG, "patch": PATCH, "lr": 1.5e-4,
                     "wd": 0.05, "total": 10, "batch": batch, "draws": masks,
                     "state": {k: v.numpy() for k, v in tmodel.state_dict().items()},
                     "cli_argv": pretrain_argv(data["small"])},
        "finetune": dict(finetune_payload(), cli_argv=finetune_argv(data["ft"])),
        "ppg_argv": PPG_ARGV,
    }
    tmp = tmp_path_factory.mktemp("ranks")
    return tmp, W.spawn(["case_trainer_cli", "case_pretrain", "case_finetune", "case_ppg"], payload, tmp)


def _max_abs(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max()) for k in want)


def _state(directory, step=None) -> dict:
    return {k: v.numpy() for k, v in load_policy_state(str(directory), step)[0].items()}


# -- the trainer -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["mesh_dp", "mesh_fsdp"])
def test_trainer_ranks_read_the_jax_per_process_batches(ranks, data, layout):
    """Rank r loads batch_size / 2 rows a step from the dataset offset by r / 2, as JAX's process r."""
    _, results = ranks
    for r, result in enumerate(results):
        got = result["case_trainer_cli"][layout]
        assert got["share"] == (r, 2)
        loader = jloader.DataLoader(
            jds.ProcgenDataset(dict(TRAINER_DATA, path=data["demos"]), dataset_name=DATASET,
                               start_offset_ratio=r / 2, split="train"),
            batch_size=4, shuffle=True, num_workers=0, seed=SEED)
        next(iter(loader))  # the cost/flops batch, as the trainer draws it
        want = [b["action"] for _, b in zip(range(len(got["actions"])), loader.epochs(skip_batches=0))]
        assert len(got["actions"]) == 48 // 8
        for a, b in zip(got["actions"], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["mesh_tp", "mesh_pp"])
def test_trainer_tp_and_pp_ranks_read_one_data_share(ranks, data, layout):
    """Under tp and pp the two ranks are one data share: each loads the whole batch of 8 rows from offset
    0, as JAX's process 0 of 1."""
    _, results = ranks
    loader = jloader.DataLoader(
        jds.ProcgenDataset(dict(TRAINER_DATA, path=data["demos"]), dataset_name=DATASET, start_offset_ratio=0.0,
                           split="train"),
        batch_size=8, shuffle=True, num_workers=0, seed=SEED)
    next(iter(loader))  # the cost/flops batch, as the trainer draws it
    want = [b["action"] for _, b in zip(range(48 // 8), loader.epochs(skip_batches=0))]
    for result in results:
        got = result["case_trainer_cli"][layout]
        assert got["share"] == (0, 1)
        assert len(got["actions"]) == 48 // 8
        for a, b in zip(got["actions"], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["mesh_dp", "mesh_fsdp", "mesh_tp", "mesh_pp"])
def test_trainer_ranks_agree_and_only_rank_0_writes(ranks, layout):
    tmp, (r0, r1) = ranks
    a, b = r0["case_trainer_cli"][layout], r1["case_trainer_cli"][layout]
    assert _max_abs(a["final"], b["final"]) == 0.0 and a["losses"] == b["losses"]
    # the rollout eval at the last step (rank 0, on the gathered params) keeps best.pt
    assert a["writes"] == ["step_3.pt", "step_5.pt", "best.pt", "step_6.pt"] and b["writes"] == []
    name = layout.split("_")[1]
    assert sorted(os.listdir(tmp / f"trainer_{name}")) == ["best.json", "best.pt", "step_3.pt", "step_5.pt",
                                                           "step_6.pt"]
    assert _max_abs(_state(tmp / f"trainer_{name}"), a["final"]) == 0.0
    runs = os.listdir(tmp / f"trainer_log_{name}")
    with open(tmp / f"trainer_log_{name}" / runs[0] / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(runs) == 1 and sum("cost/num_params" in r for r in records) == 1
    assert [r for r in records if "cost/flops" in r][0]["cost/flops"] > 0
    tested = [r for r in records if "test/return" in r]
    assert len(tested) == 1 and tested[0]["step"] == 5 and np.isfinite(tested[0]["test/return"])
    best = torch.load(tmp / f"trainer_{name}" / "best.pt", weights_only=True)
    assert _max_abs({k: v.numpy() for k, v in best["state"].items()}, a["final"]) == 0.0
    variant = json.load(open(tmp / f"trainer_log_{name}" / runs[0] / "variant.json"))
    rows = 8 if layout in ("mesh_tp", "mesh_pp") else 4  # a data share's rows
    assert (variant["process_index"], variant["process_count"], variant["process_batch_size"]) == (0, 2, rows)


def test_trainer_first_step_is_the_one_process_step_on_both_ranks_rows(ranks):
    """The augmentation drawn for the global batch, each rank applying its rows, and the gradients
    averaged: the one-process step on the 8 rows, from the same state and (seed, step) generator.
    The gradients and the loss within 1e-5; the parameters too where the gradient is above 1e-6 of
    its largest (Adam's first step is g / (|g| + 1e-8) * lr: below that a rounding of g moves it)."""
    _, results = ranks
    for result in results:
        got = result["case_trainer_cli"]["mesh_dp"]
        assert abs(got["losses"][0] - got["one_process_loss"]) <= PORT * abs(got["one_process_loss"])
        grads = got["one_process_grads"]
        gmax = max(float(np.abs(g).max()) for g in grads.values())
        assert _max_abs(got["first_grads"], grads) < PORT * gmax
        for name, g in grads.items():
            settled = np.abs(g) > 1e-6 * gmax
            assert float(np.abs((got["after_first"][name] - got["one_process_first"][name]) * settled).max()) < PORT


@pytest.mark.parametrize("layout", ["mesh_tp", "mesh_pp"])
def test_trainer_tp_and_pp_first_step_is_the_one_process_step(ranks, layout):
    """The first step at --mesh_tp=2 / --mesh_pp=2 is the one-process step on the same 8 rows from the same
    state and generator (on a flat model): the loss and the gradients within 1e-5, the parameters too
    where the gradient is above 1e-6 of its largest, as for dp."""
    _, results = ranks
    for result in results:
        got = result["case_trainer_cli"][layout]
        assert abs(got["losses"][0] - got["one_process_loss"]) <= PORT * abs(got["one_process_loss"])
        grads = got["one_process_grads"]
        gmax = max(float(np.abs(g).max()) for g in grads.values())
        assert _max_abs(got["first_grads"], grads) < PORT * gmax
        for name, g in grads.items():
            settled = np.abs(g) > 1e-6 * gmax
            assert float(np.abs((got["after_first"][name] - got["one_process_first"][name]) * settled).max()) < PORT


def test_trainer_fsdp_ends_where_dp_ends(ranks):
    _, (r0, _) = ranks
    dp, fsdp = r0["case_trainer_cli"]["mesh_dp"], r0["case_trainer_cli"]["mesh_fsdp"]
    assert _max_abs(fsdp["after_first"], dp["after_first"]) < PORT
    assert _max_abs(fsdp["final"], dp["final"]) < PORT


# -- M3AE pretraining --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pretrain_step(pretrain_pair):
    """JAX's one pretraining step on the same weights, batch and masking draws
    (tests/test_torch_m3ae_pretrain.py::test_one_pretraining_step_matches_jax)."""
    jmodel, variables, _, batch, masks = pretrain_pair
    mp = pytest.MonkeyPatch()
    try:
        feed_draws(mp, masks * 2)
        schedule = optax.warmup_cosine_decay_schedule(0.0, 1.5e-4, 0, 10)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adamw(schedule, weight_decay=0.05, mask=lambda p: jax_decay_mask(jmodel, p)))
        (loss, aux), grads = jax.jit(jax.value_and_grad(jax_loss_fn(jmodel, IMG, PATCH), has_aux=True))(
            params, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
        updates, _ = tx.update(grads, tx.init(params), params)
    finally:
        mp.undo()
    return float(loss), {k: float(v) for k, v in aux.items()}, _flatten(host_tree(optax.apply_updates(params, updates)))


@pytest.mark.parametrize("layout", ["dp", "fsdp"])
def test_pretraining_step_at_two_ranks_is_one_process_s_and_jax_s(ranks, jax_pretrain_step, layout):
    _, results = ranks
    loss, aux, want = jax_pretrain_step
    pmax = max(float(np.abs(p).max()) for p in want.values())
    for result in results:
        got, one = result["case_pretrain"][layout], result["case_pretrain"]["one"]
        assert _max_abs(got["params"], one["params"]) < PORT
        assert all(abs(got["aux"][k] - one["aux"][k]) <= PORT * max(abs(one["aux"][k]), 1e-3) for k in one["aux"])
        close(got["aux"]["loss"], loss)
        for key in ("image_loss", "text_loss", "text_acc"):
            close(got["aux"][key], aux[key])
        after = _flatten(torch_policy_to_flax({k: torch.from_numpy(v) for k, v in got["params"].items()}))
        for path, p in want.items():
            close(after[path], p, scale=pmax)


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_pretraining_ranks_share_the_masking_draw_and_draw_their_own_dropout(monkeypatch, drop):
    """The pretraining loss on the same rows as rank 0 and rank 1 of two, and as one rank, from generators
    seeded alike: the masking draws are the shared stream's on all three; the dropout masks are each rank's."""
    from arp_tpu_torch.models import m3ae as tm3ae

    torch.manual_seed(0)
    model = tm3ae.MaskedMultimodalAutoencoder(dict(CFG, drop=drop), text_vocab_size=VOCAB, image_output_dim=PATCH_DIM,
                                              decoder=True)
    rng = np.random.default_rng(1)
    batch = tpre.batch_on({"image": rng.integers(0, 256, size=(2, IMG, IMG, 3), dtype=np.uint8),
                           "text": rng.integers(1, VOCAB, size=(2, TEXT)).astype(np.int32),
                           "text_padding_mask": np.zeros((2, TEXT), np.float32)}, "cpu")
    from_uniform, seen = tm3ae.random_masking_from_uniform, []
    monkeypatch.setattr(tm3ae, "random_masking_from_uniform",
                        lambda x, uniform, *a, **k: (seen.append(uniform.clone()), from_uniform(x, uniform, *a, **k))[1])
    losses = {}
    for share in ((0, 1), (0, 2), (1, 2)):
        with torch.no_grad():
            losses[share] = float(tpre.make_loss_fn(IMG, PATCH, share)(model, batch, torch.Generator().manual_seed(7))[0])
    assert len(seen) == 6 and all(torch.equal(a, b) for a, b in zip(seen[:2] * 2, seen[2:]))
    if drop == 0.0:
        assert losses[(0, 1)] == losses[(0, 2)] == losses[(1, 2)]
    else:
        assert losses[(0, 2)] != losses[(1, 2)]


def _settled_max_abs(got_dir, want_dir) -> float:
    """The largest parameter difference between two step files, over the entries whose gradient is
    above 1e-6 of the largest (from the saved second moment): Adam's first step is g / (|g| + 1e-8) * lr,
    which a rounding of a smaller g moves."""
    got, want = (torch.load(os.path.join(d, f"step_{latest_step(str(d))}.pt"), weights_only=True)
                 for d in (got_dir, want_dir))
    rms = {k: v.sqrt() for k, v in want["optimizer"]["nu"].items()}
    top = max(float(v.max()) for v in rms.values())
    assert set(got["state"]) == set(want["state"])
    return max(float(((got["state"][k] - want["state"][k]).abs() * (rms[k] > 1e-6 * top)).max()) for k in rms)


@pytest.mark.parametrize("layout", ["mesh_dp", "mesh_fsdp"])
def test_pretraining_cli_at_two_ranks_ends_where_one_process_ends(ranks, data, tmp_path, layout):
    tmp, results = ranks
    tpre.main(pretrain_argv(data["small"]) + [f"--checkpoint_dir={tmp_path}/one", f"--logging.output_dir={tmp_path}/log"])
    got_dir = tmp / f"pretrain_{layout.split('_')[1]}"
    assert latest_step(str(got_dir)) == latest_step(str(tmp_path / "one")) == 2
    assert _settled_max_abs(got_dir, tmp_path / "one") < PORT
    d0, d1 = (r["case_pretrain"]["first_draws"] for r in results)
    assert len(d0) == 2 and all(np.array_equal(a, b) for a, b in zip(d0, d1))  # one permutation a batch, everywhere


# -- fine-tuning -------------------------------------------------------------------------------------------


def test_vip_loss_at_two_ranks_is_the_global_batch_s(ranks):
    """Each rank's loss holds the global inner mean: the ranks' losses average to the global batch's."""
    _, results = ranks
    got = results[0]["case_finetune"]
    mean = float(np.mean([r["case_finetune"]["vip_rank"] for r in results]))
    assert abs(mean - got["vip_global"]) <= PORT * abs(got["vip_global"])
    # log(eps + mean(exp(.))) is not a mean of per-example terms: the ranks' own losses average elsewhere
    assert abs(got["vip_mean_of_ranks"] - got["vip_global"]) > 1e3 * PORT * abs(got["vip_global"])


def test_finetuning_step_at_two_ranks_is_the_global_batch_s(ranks):
    _, results = ranks
    for result in results:
        dp, one = result["case_finetune"]["dp"], result["case_finetune"]["one"]
        assert abs(dp["loss"] - one["loss"]) <= PORT * abs(one["loss"])
        assert _max_abs(dp["params"], one["params"]) < PORT


def test_finetuning_cli_at_two_ranks_ends_where_one_process_ends(ranks, data, tmp_path, monkeypatch):
    tmp, _ = ranks
    monkeypatch.setenv("ARP_TPU_TINY_CLIP", "1")
    tft.main(finetune_argv(data["ft"]) + [f"--checkpoint_dir={tmp_path}/one", f"--logging.output_dir={tmp_path}/log"])
    assert sorted(os.listdir(tmp / "finetune_ckpt")) == sorted(os.listdir(tmp_path / "one"))
    assert _max_abs(_state(tmp / "finetune_ckpt"), _state(tmp_path / "one")) < PORT
    best = torch.load(tmp / "finetune_ckpt" / "best.pt", weights_only=True)
    want = torch.load(tmp_path / "one" / "best.pt", weights_only=True)
    assert abs(best["score"] - want["score"]) <= PORT * abs(want["score"])  # the val loss, averaged over the ranks


# -- PPG ---------------------------------------------------------------------------------------------------


def test_ppg_iteration_at_two_ranks(ranks):
    tmp, (r0, r1) = ranks
    a, b = r0["case_ppg"], r1["case_ppg"]
    assert (a["env_seed"], b["env_seed"]) == (SEED, SEED + 100003)
    gmax = max(float(np.abs(g).max()) for g in a["one_process"])
    for got in (a, b):
        assert max(float(np.abs(x - y).max()) for x, y in zip(got["averaged"], got["one_process"])) < PORT * gmax
    assert _max_abs(a["params"], b["params"]) == 0.0
    assert a["history"] == b["history"] and "aux_loss" in a["history"][0] and a["pickle_written"]
