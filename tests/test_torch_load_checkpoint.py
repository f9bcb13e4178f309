"""``--load_checkpoint`` in the port's trainer and eval CLI on a file the JAX package wrote, and the
trainer's ``cost/flops`` (train/common.py::flops_analysis), on the CPU.

The trainer does what arp_tpu's does with the file: the params from it, the state's step from its
``state.step``, the first step from its ``step``, and a fresh AdamW (count 0, zero moments), so
the applied learning rate restarts from the schedule's start (AdamW asks the schedule at its
count) while the logged ``learning_rate`` reads the state's step.

``flops_analysis`` against a matmul count made by hand for a tiny ARPDT (exact: every term is an
integer), with arp_tpu's XLA count logged beside it (XLA counts more than matmuls: not asserted);
the kernels' formulas (ops/flop_count.py) against FlopCounterMode's count of their plain versions.
"""

import logging

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState
from torch.utils.flop_counter import FlopCounterMode

from arp_tpu import checkpoint as jckpt
from arp_tpu.models.policy import models as jpol
from arp_tpu.train import common as jcommon
from arp_tpu_torch.checkpoint import load_reference_checkpoint, reference_policy_state
from arp_tpu_torch.models.policy import ARPDT
from arp_tpu_torch.ops import attention, quantization, vit_infer
from arp_tpu_torch.ops.masks import MaskSpec
from arp_tpu_torch.parallel.step import make_train_step
from arp_tpu_torch.train import common as tcommon
from arp_tpu_torch.train import eval as teval
from arp_tpu_torch.train import main as tmain
from test_trainer_e2e import make_labeled_dataset

log = logging.getLogger(__name__)

MODEL = dict(model_type="vit_debug", transfer_type="none", emb_dim=32, depth=2, num_heads=4,
             use_discrete_action=True)


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


def model_flags():
    return [f"--model.{k}={v}" for k, v in MODEL.items() if k != "use_discrete_action"]


def data_flags(demos):
    return [f"--data.path={demos}", "--data.image_size=32", "--data.num_frames=8", "--data.window_size=4",
            "--data.num_demonstrations=20", "--data.use_vl=True"]


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A reference pickle written by arp_tpu (save_pickle of a flax TrainState, as its trainer and the
    reference save them) with ``state.step`` 3 and ``step`` 4, and the params it holds."""
    model = jpol.ARPDT(config_updates=MODEL, num_actions=15, patch_dim=16)
    rng = np.random.default_rng(0)
    batch = {"image": {"ob": jnp.ones((1, 4, 32, 32, 3))}, "rtg": {"ob": jnp.ones((1, 4, 1))},
             "action": jnp.ones((1, 4), jnp.int32), "instruct": None, "text_padding_mask": None}
    params = model.init({"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2),
                         "dropout": jax.random.PRNGKey(3)}, batch, deterministic=True)["params"]
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                    flax.core.unfreeze(params))
    flat = flax.traverse_util.flatten_dict(params)
    for path, v in flat.items():
        if "heads" in path:  # the reference holds one head
            flat[path] = np.broadcast_to(v[:1], v.shape)
    from arp_tpu.models.policy.convert import export_reference_policy_params

    exported = flax.core.unfreeze(export_reference_policy_params(flax.traverse_util.unflatten_dict(flat)))
    state = JTrainState.create(apply_fn=None, params=exported, tx=jcommon.build_optimizer(
        type("F", (), {"weight_decay": 1e-4, "clip_gradient": 1e9})(), lambda c: 1e-3, model)).replace(step=3)
    path = str(tmp_path_factory.mktemp("ref") / "model.pkl")
    jckpt.save_pickle({"step": 4, "epoch": 0, "variant": {}, "state": state}, path)
    return path


def test_trainer_starts_from_a_jax_written_checkpoint(demos, jax_file, tmp_path, monkeypatch):
    seen, asked = [], []
    real_make, real_schedule = tmain.make_train_step, tmain.build_lr_schedule

    def make(loss_fn, **kw):
        inner = real_make(loss_fn, **kw)

        def step(state, batch, generator):
            if not seen:  # the state the first step starts from
                opt = state.opt_state
                seen.append(dict(step=state.step, count=opt.count, moments=[float(m.abs().sum()) for m in opt.mu + opt.nu],
                                 params={n: p.detach().clone() for n, p in state.params}))
            return inner(state, batch, generator)

        step.gradients = inner.gradients
        return step

    def schedule(*args, **kw):
        fn = real_schedule(*args, **kw)
        return lambda count: asked.append(int(count)) or fn(count)

    monkeypatch.setattr(tmain, "make_train_step", make)
    monkeypatch.setattr(tmain, "build_lr_schedule", schedule)
    out = tmp_path / "out"
    tmain.main(["--device=cpu", "--epochs=1", "--batch_size=8", "--dataloader_n_workers=0", "--log_freq=1",
                "--lr=1e-3", "--warmup_epochs=0", "--window_size=4", "--use_vl=True", "--vl_type=clip",
                "--use_crop=False", "--val_every_epochs=0", "--test_every_epochs=0", "--eval_env=none",
                f"--load_checkpoint={jax_file}", f"--logging.output_dir={out}", *model_flags(), *data_flags(demos)])
    first = seen[0]
    assert first["step"] == 3 and first["count"] == 0 and not any(first["moments"])
    want = reference_policy_state(load_reference_checkpoint(jax_file))
    assert set(first["params"]) == set(want)
    for name, value in want.items():
        torch.testing.assert_close(first["params"][name], value, atol=0, rtol=0)
    # each step asks the schedule at AdamW's count (from 0), then for the log at the state's step (from 3)
    n = len(asked) // 2
    assert n >= 1 and asked == [x for i in range(n) for x in (i, 3 + i)]
    import json, os

    run = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r["step"] for r in records if "train_loss" in r]
    assert steps and steps[0] == 4  # the first step is the file's ``step``
    assert [r["train_train_state_step"] for r in records if "train_loss" in r][0] == 3
    flops = [r["cost/flops"] for r in records if "cost/flops" in r]
    assert len(flops) == 1 and flops[0] > 0


def test_eval_cli_evaluates_a_jax_written_checkpoint(demos, jax_file, tmp_path, capsys, caplog):
    with caplog.at_level(logging.INFO):
        teval.main(["--device=cpu", "--window_size=4", "--use_vl=True", "--vl_type=clip", "--use_crop=False",
                    "--eval_env=fake", "--episode_length=3", "--num_test_episodes=2", f"--load_checkpoint={jax_file}",
                    f"--logging.output_dir={tmp_path / 'out'}", *model_flags(), *data_flags(demos)])
    import ast

    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == {"return", "episode_length", "success_rate"}
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["episode_length"] > 0
    assert f"restored step 4 from {jax_file}" in caplog.text
    with pytest.raises(ValueError, match="--load_checkpoint"):
        teval.main(["--device=cpu", *model_flags(), *data_flags(demos)])


# --- cost/flops ------------------------------------------------------------------------------------

B, T, IMG, PATCH, D, DEPTH, HEADS, E = 2, 3, 32, 16, 32, 2, 4, 5


def hand_count() -> int:
    """One train step of the tiny ARPDT (transfer none, no augmentation) by hand: matmuls only.

    Forward: the patch embedding (B*T*P rows, 768 -> D), the rtg input (B*T rows, 1 -> D), per
    block the qkv, q k^T and p v (4 B N^2 D), the output projection and the two MLP layers (width
    4 D: mlp_ratio 4) over N = (P + 2) T tokens, and the two ensemble heads (E members, D -> D ->
    15 and D -> D -> 1) over B*T rows.  Backward: twice the forward of every matmul whose input
    needs a gradient; the patch embedding and the rtg input see data, so only their weight's
    gradient (once the forward)."""
    P = (IMG // PATCH) ** 2
    N = (P + 2) * T
    patch = 2 * B * T * P * (PATCH * PATCH * 3) * D
    rtg = 2 * B * T * 1 * D
    block = 2 * B * N * D * 3 * D + 4 * B * N * N * D + 2 * B * N * D * D + 2 * (2 * B * N * D * 4 * D)
    heads = 2 * E * B * T * D * D * 2 + 2 * E * B * T * D * 15 + 2 * E * B * T * D * 1
    return 2 * (patch + rtg) + 3 * (DEPTH * block + heads)


def tiny_step():
    cfg = dict(MODEL, depth=DEPTH, num_heads=HEADS, emb_dim=D, mlp_ratio=4, num_ensembles=E)
    rng = np.random.default_rng(0)
    batch = {"image": {"ob": rng.normal(size=(B, T, IMG, IMG, 3)).astype(np.float32)},
             "rtg": {"ob": rng.normal(size=(B, T, 1)).astype(np.float32)},
             "action": rng.integers(0, 15, size=(B, T)).astype(np.int32), "instruct": None, "text_padding_mask": None}
    torch.manual_seed(0)
    model = ARPDT(cfg, num_actions=15, patch_dim=PATCH)
    with torch.no_grad():
        model(batch, deterministic=True)
    from arp_tpu_torch.config import Config
    from arp_tpu_torch.parallel.step import TrainState

    state = TrainState.create(model, tcommon.build_optimizer(Config(weight_decay=1e-4, clip_gradient=10.0),
                                                             lambda c: 1e-3, model))
    step = make_train_step(tcommon.make_loss_fn(model, None, IMG, False))
    return cfg, state, step, batch


def test_flops_analysis_is_the_hand_count_for_a_tiny_arpdt():
    cfg, state, step, batch = tiny_step()
    before = {n: p.detach().clone() for n, p in state.params}
    got = tcommon.flops_analysis(step.gradients, state, batch, torch.Generator().manual_seed(0))
    assert got == float(hand_count())
    assert state.step == 0 and state.opt_state.count == 0  # counting leaves the state as it was
    assert all(torch.equal(before[n], p) and p.grad is None for n, p in state.params)

    jmodel = jpol.ARPDT(config_updates=cfg, num_actions=15, patch_dim=PATCH)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
                          "dropout": jax.random.PRNGKey(2)}, jbatch, deterministic=True)["params"]

    def loss(p):
        return jmodel.apply({"params": p}, jbatch, deterministic=True)["loss"]

    xla = jcommon.flops_analysis(jax.jit(jax.grad(loss)), params)
    log.info("cost/flops of the tiny ARPDT's step: port %d (matmuls), JAX %s (XLA's cost analysis)", got, xla)


def test_flops_analysis_returns_minus_one_when_counting_fails():
    def broken():
        raise RuntimeError("no step")

    assert tcommon.flops_analysis(broken) == -1.0


def test_kernel_formulas_are_the_plain_versions_counts():
    """What each wrapper notes where it launches equals FlopCounterMode's count of its plain version."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 8, 16, generator=g) for _ in range(3))
    with FlopCounterMode(display=False) as counter:
        attention.reference_attention(q, k, v, MaskSpec("dt", 1, 3))
    assert counter.get_total_flops() == 4 * 2 * 8 * 12 * 12 * 16
    m, kk, n = 40, 96, 64
    x = torch.randn(m, kk, generator=g)
    wq = torch.randint(-127, 128, (kk, n), dtype=torch.int8, generator=g)
    with FlopCounterMode(display=False) as counter:
        vit_infer.fused_int8_matmul_reference(x, torch.tensor(3.0), wq, torch.rand(1, n, generator=g), act="gelu_tanh")
    assert counter.get_total_flops() == 2 * m * kk * n
    with FlopCounterMode(display=False) as counter:
        quantization.int8_matmul_reference(x, wq, torch.rand(1, n, generator=g))
    assert counter.get_total_flops() == 2 * m * kk * n
