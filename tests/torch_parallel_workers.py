"""Spawned ranks for the port's several-process tests (tests/test_torch_parallel*.py).

Imports torch, numpy and arp_tpu_torch only: never jax (the tests compute the
JAX package's side in their own process and pass numpy in).  ``spawn(cases,
payload, tmp)`` starts ``world`` processes over gloo on the CPU, joined through a
file store under ``tmp`` (so that test workers running side by side never race
for a port), runs every named case in each rank, and returns each rank's results;
ranks still running after its timeout are killed and the spawn fails.
A case is ``fn(rank, payload, tmp) -> dict``; an exception in any rank fails the
spawn.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

# the vit_debug ARPDT of tests/test_mesh_equivalence.py
ARPDT_CFG = dict(model_type="vit_debug", transfer_type="none", emb_dim=64, depth=2, num_heads=4, mlp_ratio=2,
                 use_discrete_action=True, num_ensembles=2)
TP_DROPOUT = 0.1  # the dropout and attention dropout rate of the tp run with dropout
# a 2-layer, 64-wide M3AE tower for the frozen_int8 calibration
TOWER = dict(model_type=None, emb_dim=64, dec_emb_dim=16, depth=2, dec_depth=1, num_heads=4, dec_num_heads=4,
             mlp_ratio=2)


def spawn(cases, payload, tmp, world: int = 2, timeout_s: float = 600.0) -> list:
    """Run ``cases`` (names of this module's case functions) in ``world`` spawned gloo ranks; ranks that have
    not finished after ``timeout_s`` (a collective that one rank never joins) are killed and the spawn fails."""
    import time

    tmp = str(tmp)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    context = torch.multiprocessing.start_processes(_entry, args=(world, tmp, list(cases)), nprocs=world, join=False,
                                                    start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not context.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the spawned ranks did not finish {list(cases)} in {timeout_s} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank: int, world: int, tmp: str, cases: list) -> None:
    torch.set_num_threads(1)
    from arp_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(init_method=f"file://{tmp}/store", num_processes=world, process_id=rank, device="cpu")
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    results = {}
    try:
        for case in cases:
            results[case] = globals()[case](rank, payload, tmp)
    finally:
        shutdown()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# -- the vit_debug ARPDT --------------------------------------------------------------------------------


class ClippedSGD:
    """``optax.chain(clip_by_global_norm(clip), sgd(lr))`` of the JAX mesh test, on the port's state:
    the norm over whole tensors (``global_sum_of_squares``, tp shares and pp stages included), the step
    shard by shard."""

    def __init__(self, lr: float, clip: float):
        self.lr, self.clip = lr, clip

    def init(self, params):
        from arp_tpu_torch.train.common import AdamWState

        return AdamWState(0, [], [])

    @torch.no_grad()
    def update(self, params, grads, state):
        from arp_tpu_torch.parallel.mesh import split_of
        from arp_tpu_torch.parallel.step import local_part
        from arp_tpu_torch.train.common import AdamWState, global_sum_of_squares

        local = [local_part(g) for g in grads]
        norm = torch.sqrt(global_sum_of_squares(local, list(grads), [split_of(p) for p in params]))
        clipped = torch._foreach_mul(torch._foreach_div(local, norm), self.clip)
        keep = norm < self.clip
        steps = [torch.where(keep, g, c) for g, c in zip(local, clipped)]
        torch._foreach_add_([local_part(p) for p in params], torch._foreach_mul(steps, -self.lr))
        return AdamWState(state.count + 1, [], [])


def arpdt(init: dict, batch: dict, mesh=None, pp: int = 1, **overrides):
    """The port's vit_debug ARPDT with the weights ``init`` (its first forward run); ``pp`` above 1: its
    blocks pipelined in that many stages over ``mesh``'s pp axis (two microbatches, as JAX's test);
    ``overrides`` of its config (dropout rates)."""
    from arp_tpu_torch.models.policy import ARPDT
    from arp_tpu_torch.parallel.mesh import load_full_state

    cfg = dict(ARPDT_CFG, pp_stages=pp, pp_microbatches=2) if pp > 1 else ARPDT_CFG
    cfg = dict(cfg, **overrides)
    model = ARPDT(cfg, num_actions=15, patch_dim=16, mesh=mesh)
    with torch.no_grad():
        model({k: (v if v is None else {kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1])
               for k, v in batch.items()}, deterministic=True)
        load_full_state(model, {k: torch.as_tensor(v) for k, v in init.items()})
    return model


def deterministic_loss(model, batch, generator):
    out = model(batch, deterministic=True)
    return out["loss"], {"acc": out["acc"]}


def _rows(batch, index: int, shares: int):
    """Data share ``index`` of ``shares`` of a batch tree: contiguous rows, as parallel/mesh.py::batch_share."""
    if isinstance(batch, dict):
        return {k: _rows(v, index, shares) for k, v in batch.items()}
    if batch is None or np.ndim(batch) == 0:
        return batch
    n = batch.shape[0] // shares
    return batch[index * n:(index + 1) * n]


def dropout_loss(shares: int):
    """The trainer's loss (train/common.py::make_loss_fn: each data share's dropout masks from its own
    stream) spelled out in one process over ``shares`` data shares of the batch, each share's loss and
    masks as that share's rank draws them, averaged as the data ranks average their gradients."""
    from arp_tpu_torch.train.common import rank_generator

    def loss_fn(model, batch, generator):
        state, losses = generator.get_state(), []
        for i in range(shares):
            stream = rank_generator(torch.Generator().set_state(state), i)
            losses.append(model(_rows(batch, i, shares), deterministic=False, generator=stream)["loss"])
        return torch.stack(losses).mean(), {}

    return loss_fn


def train_arpdt(payload, mesh_config=None, steps=3, accum_steps=1, drop=0.0, shares=1):
    """``steps`` steps of the JAX mesh test's step (explicit 1e-4 l2 penalty), on ``mesh_config``'s mesh
    (None: one process, the whole batch).  ``drop`` above 0: that dropout and attention dropout, the
    trainer's loss (one process: over ``shares`` data shares, :func:`dropout_loss`).  Returns (full
    params, last loss, state)."""
    from arp_tpu_torch.parallel.mesh import batch_share, create_mesh, data_share, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state
    from arp_tpu_torch.train.common import make_loss_fn

    mesh = create_mesh(mesh_config, "cpu") if mesh_config is not None else None
    pp = mesh_config.pp if mesh_config is not None else 1
    rates = dict(drop=drop, att_drop=drop) if drop else {}
    state = TrainState.create(arpdt(payload["init"], payload["batch"], mesh, pp, **rates), ClippedSGD(0.1, 10.0))
    state = shard_train_state(state, mesh)
    loss_fn = deterministic_loss
    if drop:
        loss_fn = dropout_loss(shares) if mesh is None else make_loss_fn(None, None, 0, False, share=data_share(mesh))
    step = make_train_step(loss_fn, mesh=mesh, weight_decay=1e-4, accum_steps=accum_steps)
    batch = batch_share(payload["batch"], mesh, accum_steps)
    aux = None
    for i in range(steps):
        state, aux = step(state, batch, torch.Generator().manual_seed(i))
    return _numpy(gather_to_host(state.model)), float(aux["loss"]), state


def case_meshes(rank, payload, tmp):
    """dp=2, fsdp=2 and dcn_dp=2 x dp=1 over the 2 ranks, and the one-process run."""
    from arp_tpu_torch.parallel.mesh import MeshConfig

    from torch.distributed.fsdp import FSDPModule

    from arp_tpu_torch.models.layers import Block

    out = {}
    for name, cfg in (("dp", MeshConfig(dp=-1)), ("fsdp", MeshConfig(dp=1, fsdp=2)),
                      ("dcn_dp", MeshConfig(dp=1, dcn_dp=2)), ("one", None)):
        params, loss, state = train_arpdt(payload, cfg)
        out[name] = {"params": params, "loss": loss,
                     "fsdp_units": [n for n, m in state.model.named_modules() if isinstance(m, FSDPModule)],
                     "blocks": [n for n, m in state.model.named_modules() if isinstance(m, Block)]}
    return out


def case_accum(rank, payload, tmp):
    """accum_steps=2 under dp=2 against the one-process step on the whole batch without accumulation."""
    from arp_tpu_torch.parallel.mesh import MeshConfig

    params, loss, _ = train_arpdt(payload, MeshConfig(dp=-1), steps=2, accum_steps=2)
    want, want_loss, _ = train_arpdt(payload, None, steps=2)
    return {"params": params, "loss": loss, "want": want, "want_loss": want_loss}


def case_adamw_sharded(rank, payload, tmp):
    """The port's AdamW (clip engaged, decay mask) on fsdp-sharded parameters against the same update
    unsharded, from the same full gradients; a 0-dim parameter stays whole, as FSDP2 leaves it."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, gather_to_host
    from arp_tpu_torch.train.common import AdamW

    mesh = create_mesh(MeshConfig(dp=1, fsdp=2), "cpu")
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (3,), (), (4, 3, 2)]
    full = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes] for _ in range(3)]

    def shard(t):
        return t.clone() if t.ndim == 0 else distribute_tensor(t.clone(), mesh["dp", "fsdp"], [Replicate(), Shard(0)])

    tx = AdamW(lambda count: 1e-2 * (count + 1), 1e-3, [True, False, True, True], clip=0.5)
    whole, sharded = [t.clone() for t in full], [shard(t) for t in full]
    s_whole, s_sharded = tx.init(whole), tx.init(sharded)
    norms = []
    for g in grads:
        norms.append(float(torch.sqrt(sum(torch.sum(x * x) for x in g))))
        s_whole = tx.update(whole, g, s_whole)
        s_sharded = tx.update(sharded, [shard(x) for x in g], s_sharded)
    return {"norms": norms, "whole": _numpy(whole), "sharded": _numpy(gather_to_host(sharded)),
            "mu": (_numpy(s_whole.mu), _numpy(gather_to_host(list(s_sharded.mu)))),
            "nu": (_numpy(s_whole.nu), _numpy(gather_to_host(list(s_sharded.nu)))),
            "sharded_mu_is_dtensor": type(s_sharded.mu[0]).__name__}


def _state_with_adamw(payload, mesh, pp: int = 1):
    from arp_tpu_torch.parallel.step import TrainState, shard_train_state, trainable_parameters
    from arp_tpu_torch.train.common import AdamW

    model = arpdt(payload["init"], payload["batch"], mesh, pp)
    tx = AdamW(lambda count: 1e-3, 1e-4, [True] * len(trainable_parameters(model)), clip=1.0)
    return shard_train_state(TrainState.create(model, tx), mesh)


def _full_state(state) -> dict:
    from arp_tpu_torch.parallel.mesh import gather_named, gather_to_host, split_of

    names, splits = [n for n, _ in state.params], {n: split_of(p) for n, p in state.params if split_of(p)}
    return {"params": _numpy(gather_to_host(state.model)),
            "mu": _numpy([v for _, v in sorted(gather_named(dict(zip(names, state.opt_state.mu)), splits).items())]),
            "nu": _numpy([v for _, v in sorted(gather_named(dict(zip(names, state.opt_state.nu)), splits).items())]),
            "count": state.opt_state.count, "step": state.step}


def case_checkpoint(rank, payload, tmp):
    """A checkpoint saved at 2 ranks under fsdp resumed at 1 rank, and one saved at 1 rank resumed
    at 2 ranks under fsdp: the restored state equals the saved one bit for bit, and the next step
    equals the uninterrupted run's."""
    from arp_tpu_torch.checkpoint import CheckpointManager
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh
    from arp_tpu_torch.parallel.step import make_train_step

    mesh = create_mesh(MeshConfig(dp=1, fsdp=2), "cpu")
    out = {}
    for direction, (save_mesh, load_mesh) in {"2to1": (mesh, None), "1to2": (None, mesh)}.items():
        directory = os.path.join(tmp, f"ckpt_{direction}")
        ckpt = CheckpointManager(directory)
        state = _state_with_adamw(payload, save_mesh)
        step = make_train_step(deterministic_loss, mesh=save_mesh)
        batch = batch_share(payload["batch"], save_mesh)
        for i in range(2):
            state, _ = step(state, batch, torch.Generator().manual_seed(i))
        ckpt.save(2, state, metadata={"step": 2})
        saved = _full_state(state)
        state, _ = step(state, batch, torch.Generator().manual_seed(2))
        uninterrupted = _full_state(state)

        resumed = _state_with_adamw(payload, load_mesh)
        resumed, meta = CheckpointManager(directory).restore(resumed)
        restored = _full_state(resumed)
        step = make_train_step(deterministic_loss, mesh=load_mesh)
        resumed, _ = step(resumed, batch_share(payload["batch"], load_mesh), torch.Generator().manual_seed(2))
        out[direction] = {"saved": saved, "restored": restored, "resumed": _full_state(resumed),
                          "uninterrupted": uninterrupted, "meta_step": meta["step"],
                          "files": sorted(os.listdir(directory))}
    return out


def case_calibration(rank, payload, tmp):
    """frozen_int8's calibration scales at 2 ranks (each on its share of the first batch) against one
    process on the whole batch; only rank 0 writes the scales file."""
    from arp_tpu_torch.config import Config
    from arp_tpu_torch.models.m3ae import MaskedMultimodalAutoencoder
    from arp_tpu_torch.models.policy import get_policy_default_config
    from arp_tpu_torch.parallel.distributed import barrier
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh
    from arp_tpu_torch.train.common import load_frozen_amax, maybe_build_frozen_qpack

    torch.manual_seed(0)
    tower = MaskedMultimodalAutoencoder(TOWER, text_vocab_size=30522).state_dict()
    cfg = dict(model_type="vit_debug", transfer_type="m3ae_vit_b16", use_adapter=True, emb_dim=32, depth=2,
               num_heads=4, mlp_ratio=2, use_discrete_action=True, num_ensembles=2, m3ae=dict(TOWER), frozen_int8=True)
    flags = Config(model=get_policy_default_config(cfg), patch_dim=16, encode_image_size=32)
    raw = payload["calibration_batch"]
    mesh = create_mesh(MeshConfig(dp=-1), "cpu")
    dirs = {"two": os.path.join(tmp, "amax_two"), "one": os.path.join(tmp, "amax_one")}
    for name, (batch, on) in {"two": (batch_share(raw, mesh), mesh), "one": (raw, None)}.items():
        maybe_build_frozen_qpack(flags, batch, False, checkpoint_dir=dirs[name], save=True, device="cpu",
                                 m3ae_loader=lambda name: tower, mesh=on)
    barrier()  # rank 0 wrote the one-process file too
    return {"two": load_frozen_amax(dirs["two"]), "one": load_frozen_amax(dirs["one"])}


# -- the four CLIs ----------------------------------------------------------------------------------------


def _gather_objects(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _concat(trees: list):
    if isinstance(trees[0], dict):
        return {k: _concat([t[k] for t in trees]) for k in trees[0]}
    if trees[0] is None:
        return None
    return np.concatenate(trees)


def _host_batch(tree):
    if isinstance(tree, dict):
        return {k: _host_batch(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def case_trainer_cli(rank, payload, tmp):
    """The trainer CLI in each rank at --mesh_dp=2, --mesh_fsdp=2, --mesh_tp=2 and --mesh_pp=2: each rank's
    batches, its writes, the first step against the one-process step on the global batch (both ranks'
    rows under dp and fsdp; the one data share's under tp and pp) on a flat model built as the trainer
    builds it."""
    import copy

    import arp_tpu_torch.checkpoint as ckpt_lib
    from arp_tpu_torch.parallel.mesh import gather_named, gather_to_host, split_of
    from arp_tpu_torch.parallel.step import TrainState, make_train_step
    from arp_tpu_torch.train import main as tmain
    from arp_tpu_torch.train.common import AdamW, build_optimizer

    out = {}
    orig_step, orig_loss, orig_save = tmain.make_train_step, tmain.make_loss_fn, ckpt_lib._atomic_save
    orig_update, orig_build = AdamW.update, tmain.build_model
    for flag in ("--mesh_dp=2", "--mesh_fsdp=2", "--mesh_tp=2", "--mesh_pp=2"):
        rec = {"actions": [], "losses": [], "writes": []}

        def build_model(flags_obj, num_actions, rec=rec, **kw):
            rec.setdefault("build", (copy.deepcopy(flags_obj), num_actions, kw.get("frozen_qpack")))
            return orig_build(flags_obj, num_actions, **kw)

        def make_loss_fn(model, augment_fn, image_size, use_goal, share=(0, 1), rec=rec):
            rec["loss_args"] = (augment_fn, image_size, use_goal, share)
            return orig_loss(model, augment_fn, image_size, use_goal, share=share)

        def make_train_step(loss_fn, rec=rec, **kw):
            step = orig_step(loss_fn, **kw)

            def wrapped(state, batch, generator):
                if not rec["actions"]:
                    rec["init"] = gather_to_host(state.model)
                    rec["tx"], rec["first"] = state.tx, _host_batch(batch)
                    rec["names"] = [n for n, _ in state.params]
                rec["actions"].append(batch["action"].cpu().numpy().copy())
                state, aux = step(state, batch, generator)
                rec["losses"].append(float(aux["loss"]))
                if len(rec["actions"]) == 1:
                    rec["after_first"] = gather_to_host(state.model)
                rec["state"] = state
                return state, aux

            wrapped.gradients = step.gradients
            return wrapped

        def atomic_save(obj, path, rec=rec):
            rec["writes"].append(os.path.basename(path))
            return orig_save(obj, path)

        def update(self, params, grads, state, rec=rec):
            if "grads" not in rec:  # the first step's gradients, as the update sees them
                rec["grads"] = [g.detach().clone() for g in grads]
            return orig_update(self, params, grads, state)

        tmain.make_train_step, tmain.make_loss_fn, ckpt_lib._atomic_save = make_train_step, make_loss_fn, atomic_save
        tmain.build_model, AdamW.update = build_model, update
        key, name = flag.split("=")[0][2:], flag.split("=")[0].split("_")[1]
        try:
            tmain.main(payload["trainer_argv"] + [flag, f"--checkpoint_dir={tmp}/trainer_{name}",
                                                  f"--logging.output_dir={tmp}/trainer_log_{name}"])
        finally:
            tmain.make_train_step, tmain.make_loss_fn, ckpt_lib._atomic_save = orig_step, orig_loss, orig_save
            tmain.build_model, AdamW.update = orig_build, orig_update
        final = _numpy(gather_to_host(rec["state"].model))
        splits = {n: split_of(p) for n, p in rec["state"].params if split_of(p) is not None}
        result = {"actions": rec["actions"], "losses": rec["losses"], "writes": rec["writes"], "final": final,
                  "after_first": _numpy(rec["after_first"]), "share": rec["loss_args"][3],
                  "first_grads": _numpy(gather_named(dict(zip(rec["names"], rec["grads"])), splits))}
        # the one-process step on the global batch of the first step, from the same state and draws, on a
        # flat model built as the trainer builds it
        shares = _gather_objects(rec["first"])
        global_batch = _concat(shares) if result["share"][1] > 1 else rec["first"]
        flags_obj, num_actions, qpack = rec["build"]
        flags_obj.model.pp_stages = 1
        model = orig_build(flags_obj, num_actions, frozen_qpack=qpack)
        global_batch = {k: (v if v is None else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                            if isinstance(v, dict) else torch.from_numpy(v)) for k, v in global_batch.items()}
        with torch.no_grad():
            model({k: (v if v is None else {kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1])
                   for k, v in global_batch.items()}, deterministic=True)
            model.load_trained_state_dict({k: torch.as_tensor(v) for k, v in rec["init"].items()})
        augment_fn, image_size, use_goal, _ = rec["loss_args"]
        state = TrainState.create(model, build_optimizer(flags_obj, rec["tx"].learning_rate, model))
        step = orig_step(orig_loss(model, augment_fn, image_size, use_goal))
        del rec["grads"]
        AdamW.update = update
        try:
            state, aux = step(state, global_batch, tmain.step_generator(payload["trainer_seed"], 0, "cpu"))
        finally:
            AdamW.update = orig_update
        result["one_process_first"] = _numpy(gather_to_host(state.model))
        result["one_process_loss"] = float(aux["loss"])
        result["one_process_grads"] = dict(zip([n for n, _ in state.params], _numpy(rec["grads"])))
        out[key] = result
    return out


def case_pretrain(rank, payload, tmp):
    """One pretraining step at dp=2 and fsdp=2 on the masking draws given, and the same step in one
    process; then the CLI at --mesh_dp=2 and --mesh_fsdp=2, the masking draw of each rank noted."""
    from arp_tpu_torch.models import m3ae as tm3ae
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh, data_share, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state
    from arp_tpu_torch.train import pretrain_m3ae as tpre
    from arp_tpu_torch.train.common import warmup_cosine_decay_schedule

    p = payload["pretrain"]
    from_uniform = tm3ae.random_masking_from_uniform
    orig_masking = tm3ae.random_masking
    out = {}
    for name, cfg in (("dp", MeshConfig(dp=-1)), ("fsdp", MeshConfig(dp=1, fsdp=2)), ("one", None)):
        draws = iter(list(p["draws"]))
        tm3ae.random_masking = lambda x, keep_len, padding_mask=None, generator=None: from_uniform(
            x, torch.from_numpy(next(draws)), keep_len, padding_mask)
        try:
            mesh = create_mesh(cfg, "cpu") if cfg is not None else None
            model = tm3ae.MaskedMultimodalAutoencoder(p["cfg"], text_vocab_size=p["vocab"],
                                                      image_output_dim=p["patch_dim"], decoder=True)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()})
            schedule = warmup_cosine_decay_schedule(0.0, p["lr"], 0, p["total"])
            state = shard_train_state(TrainState.create(model, tpre.build_optimizer(model, schedule, p["wd"])), mesh)
            step = make_train_step(tpre.make_loss_fn(p["img"], p["patch"], data_share(mesh)), mesh=mesh,
                                   learning_rate_fn=schedule)
            state, aux = step(state, tpre.batch_on(batch_share(p["batch"], mesh), "cpu"), torch.Generator().manual_seed(0))
            out[name] = {"params": _numpy(gather_to_host(state.model)),
                         "aux": {k: float(aux[k]) for k in ("loss", "image_loss", "text_loss", "text_acc")}}
        finally:
            tm3ae.random_masking = orig_masking
    seen = []
    tm3ae.random_masking_from_uniform = lambda x, uniform, *a, **k: (seen.append(uniform.numpy().copy()),
                                                                     from_uniform(x, uniform, *a, **k))[1]
    try:
        for flag in ("--mesh_dp=2", "--mesh_fsdp=2"):
            name = flag.split("=")[0].split("_")[1]
            tpre.main(p["cli_argv"] + [flag, f"--checkpoint_dir={tmp}/pretrain_{name}",
                                       f"--logging.output_dir={tmp}/pretrain_log_{name}"])
    finally:
        tm3ae.random_masking_from_uniform = from_uniform
    out["first_draws"] = seen[:2]
    return out


def case_finetune(rank, payload, tmp):
    """The VIP loss and one fine-tuning step at dp=2 against the global batch's, the mean of the ranks'
    own VIP losses beside it; then the fine-tuning CLI at --mesh_dp=2."""
    from arp_tpu_torch.finetune import train as tft
    from arp_tpu_torch.finetune.adapter_model import ClipMultiscaleAdapter
    from arp_tpu_torch.models.clip.model import CLIP
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state

    f = payload["finetune"]
    torch.manual_seed(0)
    clip = CLIP(**f["clip_cfg"], image_size=224).eval().requires_grad_(False)
    mesh = create_mesh(MeshConfig(dp=-1), "cpu")
    out = {}
    draws = ClipMultiscaleAdapter.draw_preprocess(torch.Generator().manual_seed(5))

    def adapter():
        model = ClipMultiscaleAdapter(clip_config=f["clip_cfg"], action_dim=15)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in f["adapter"].items()})
        return model

    def vip(model, batch):
        return model(clip, batch, train=True, draws=draws)[1]["ob_vip_loss"]

    def loss_fn(model, batch, generator):
        loss, metrics = model(clip, batch, train=True, draws=draws)
        return loss, dict(metrics, loss=loss)

    whole = adapter()
    out["vip_global"] = float(vip(whole, f["batch"]))
    mine = batch_share(f["batch"], mesh)
    own = adapter()
    local = float(vip(own, mine))  # batch_group unset: this rank's rows alone
    out["vip_mean_of_ranks"] = float(np.mean(_gather_objects(local)))
    own.batch_group = mesh["dp"].get_group()
    out["vip_rank"] = float(vip(own, mine))
    # one step: DDP over the adapter with the global inner mean, against one process on the batch
    for name, on in (("dp", mesh), ("one", None)):
        model = adapter()
        if on is not None:
            model.batch_group = on["dp"].get_group()
        state = shard_train_state(TrainState.create(model, tft.build_optimizer(model, 1e-3, 1e-4)), on)
        step = make_train_step(loss_fn, mesh=on)
        state, aux = step(state, batch_share(f["batch"], on), None)
        out[name] = {"params": _numpy(gather_to_host(state.model)), "loss": float(aux["loss"])}
    os.environ["ARP_TPU_TINY_CLIP"] = "1"
    tft.main(f["cli_argv"] + ["--mesh_dp=2", f"--checkpoint_dir={tmp}/finetune_ckpt",
                              f"--logging.output_dir={tmp}/finetune_log"])
    return out


def case_ppg(rank, payload, tmp):
    """One PPG iteration through train_ppg's CLI at --mesh_dp=2: each rank's env seed, the averaged
    gradient of the first minibatch against one process's gradient on both ranks' rows, the params."""
    from arp_tpu_torch.collect import ppg as tppg
    from arp_tpu_torch.collect import train_ppg

    rec = {}
    orig_steps, orig_roller, orig_average = tppg.make_ppg_steps, tppg.Roller, tppg.average_over_ranks

    class Roller(orig_roller):
        def __init__(self, envs, act_fn, seed=0):
            rec.setdefault("env_seed", seed)
            super().__init__(envs, act_fn, seed=seed)

    def average(grads):
        averaged = orig_average(grads)
        rec.setdefault("averaged", [g.clone() for g in averaged])
        return averaged

    def make_ppg_steps(model, config, sync=None):
        steps = list(orig_steps(model, config, sync=average if sync is not None else None))
        ppo_step = steps[0]

        def recording(state, batch):
            if "batch" not in rec:
                rec["batch"] = {k: v.clone() for k, v in batch.items()}
                rec["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
                rec["model"], rec["config"] = model, config
            return ppo_step(state, batch)

        steps[0] = recording
        return tuple(steps)

    tppg.make_ppg_steps, tppg.Roller, tppg.average_over_ranks = make_ppg_steps, Roller, average
    try:
        state, history = train_ppg.main(payload["ppg_argv"] + ["--mesh_dp=2", f"--logging.output_dir={tmp}/ppg_log",
                                                               f"--checkpoint_path={tmp}/ppg.pkl"])
    finally:
        tppg.make_ppg_steps, tppg.Roller, tppg.average_over_ranks = orig_steps, orig_roller, orig_average
    # one process's gradient on both ranks' first minibatch, from the same params
    import copy

    model = copy.deepcopy(rec["model"])
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(rec["params"][n])
    both = {k: torch.cat([torch.as_tensor(v) for v in vs]) for k, vs in
            _concat_lists(_gather_objects({k: v.numpy() for k, v in rec["batch"].items()})).items()}
    captured = {}

    def capture(grads):
        captured["grads"] = grads
        return grads

    from arp_tpu_torch.parallel.step import TrainState

    one = TrainState.create(model, tppg.make_adam(rec["config"], len(list(model.parameters()))))
    orig_steps(model, rec["config"], sync=capture)[0](one, both)
    return {"env_seed": rec["env_seed"], "averaged": _numpy(rec["averaged"]), "one_process": _numpy(captured["grads"]),
            "params": _numpy(state.model.state_dict()), "history": history,
            "pickle_written": os.path.exists(f"{tmp}/ppg.pkl")}


def _concat_lists(trees: list) -> dict:
    return {k: [t[k] for t in trees] for k in trees[0]}


# -- tensor and pipeline parallelism (tests/test_torch_tp_pp.py, 4 ranks) ----------------------------------


def case_tp_pp_train(rank, payload, tmp):
    """Three clipped-SGD steps of the vit_debug ARPDT at (dp 2, tp 2), (fsdp 2, tp 2) and (dp 2, pp 2), and in
    one process; each rank's qkv share at the start of the tp run; the (dp 2, tp 2) run's head count a rank;
    the trained model's action_pred on its data share against a flat model loaded with the gathered params
    (what the rollout eval on rank 0 runs)."""
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh
    from arp_tpu_torch.parallel.step import unwrap

    out = {}
    for name, cfg in (("dp_tp", MeshConfig(dp=2, tp=2)), ("fsdp_tp", MeshConfig(dp=1, fsdp=2, tp=2)),
                      ("dp_pp", MeshConfig(dp=2, pp=2)), ("fsdp_pp", MeshConfig(dp=1, fsdp=2, pp=2)), ("one", None)):
        params, loss, state = train_arpdt(payload, cfg)
        out[name] = {"params": params, "loss": loss}
        module = unwrap(state.model)
        if cfg is not None:
            rows = batch_share(payload["batch"], create_mesh(cfg, "cpu"))
            with torch.no_grad():
                laid = state.model(rows, deterministic=True)["action_pred"]
                flat = arpdt(params, payload["batch"])(rows, deterministic=True)["action_pred"]
            out[name]["action_pred"] = (_numpy(laid), _numpy(flat))
        if name == "dp_tp":
            attn = module.policy.blocks_0.attn
            out[name].update(tp_rank=attn.tp.rank, local_heads=attn.num_heads // attn.tp.size,
                             qkv_rows=tuple(attn.qkv.kernel.shape), attn_out=tuple(attn.attn_out.weight.shape),
                             fc1=tuple(module.policy.blocks_0.mlp.fc1.weight.shape))
        if name == "dp_pp":
            out[name]["own_blocks"] = sorted(n.split(".")[1] for n, _ in module.named_parameters()
                                             if n.startswith("policy.blocks_"))
    # dropout and attention dropout at (dp 2, tp 2): each tp rank drops its share of the mask one process draws
    for name, cfg in (("dp_tp_dropout", MeshConfig(dp=2, tp=2)), ("one_dropout", None)):
        params, loss, _ = train_arpdt(payload, cfg, drop=TP_DROPOUT, shares=2)
        out[name] = {"params": params, "loss": loss}
    return out


def case_tp_qkv_share(rank, payload, tmp):
    """The qkv kernel and bias each tp rank holds after the split (dp 2 x tp 2), untrained."""
    from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from arp_tpu_torch.parallel.step import TrainState, shard_train_state, unwrap

    mesh = create_mesh(MeshConfig(dp=2, tp=2), "cpu")
    state = shard_train_state(TrainState.create(arpdt(payload["init"], payload["batch"]), ClippedSGD(0.1, 10.0)), mesh)
    attn = unwrap(state.model).policy.blocks_1.attn
    return {"tp_rank": mesh["tp"].get_local_rank(), "kernel": _numpy(attn.qkv.kernel), "bias": _numpy(attn.qkv.bias),
            "attn_out": _numpy(attn.attn_out.weight)}


def case_tp_pp_checkpoint(rank, payload, tmp):
    """AdamW states saved at (dp 2, tp 2) and at (dp 2, pp 2), each restored in one process (no mesh) and at
    the other layout: bit for bit the saved state; the next step of each the uninterrupted run's."""
    from arp_tpu_torch.checkpoint import CheckpointManager
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh
    from arp_tpu_torch.parallel.step import make_train_step

    meshes = {"tp": (create_mesh(MeshConfig(dp=2, tp=2), "cpu"), 1), "pp": (create_mesh(MeshConfig(dp=2, pp=2), "cpu"), 2)}
    out = {}
    for name, (mesh, pp) in meshes.items():
        directory = os.path.join(tmp, f"ckpt_{name}")
        state = _state_with_adamw(payload, mesh, pp)
        step = make_train_step(deterministic_loss, mesh=mesh, weight_decay=1e-4)
        batch = batch_share(payload["batch"], mesh)
        for i in range(2):
            state, _ = step(state, batch, torch.Generator().manual_seed(i))
        CheckpointManager(directory).save(2, state, metadata={"step": 2})
        saved = _full_state(state)
        state, _ = step(state, batch, torch.Generator().manual_seed(2))
        uninterrupted = _full_state(state)
        result = {"saved": saved, "uninterrupted": uninterrupted}
        other = "pp" if name == "tp" else "tp"
        for where, (on, on_pp) in (("one", (None, 1)), (other, meshes[other])):
            resumed, meta = CheckpointManager(directory).restore(_state_with_adamw(payload, on, on_pp))
            restored = _full_state(resumed)
            step = make_train_step(deterministic_loss, mesh=on, weight_decay=1e-4)
            resumed, _ = step(resumed, batch_share(payload["batch"], on), torch.Generator().manual_seed(2))
            result[where] = {"restored": restored, "resumed": _full_state(resumed), "meta_step": meta["step"]}
        out[name] = result
    return out


def _gelu_stage(params, x):
    return torch.nn.functional.gelu(x @ params[0] + params[1], approximate="tanh")


def case_pipeline(rank, payload, tmp):
    """pipeline_apply of a dense + gelu stage at (S, M) in (2, 4), (4, 4), (4, 8), each data share of the
    4 ranks pipelining its rows; with its gradients against sequential_apply's."""
    from arp_tpu_torch.parallel.mesh import MeshConfig, batch_share, create_mesh
    from arp_tpu_torch.parallel.pipeline import pipeline_apply, sequential_apply

    out = {}
    for S, M in ((2, 4), (4, 4), (4, 8)):
        p = payload["pipeline"][S]
        mesh = create_mesh(MeshConfig(dp=4 // S, pp=S), "cpu")
        s = mesh["pp"].get_local_rank()
        x = torch.from_numpy(batch_share(payload["pipeline"]["x"], mesh))
        stages = [[torch.tensor(p["w"][i], requires_grad=True), torch.tensor(p["b"][i], requires_grad=True)]
                  for i in range(S)]
        own = stages[s]
        xg = x.clone().requires_grad_(True)
        got = pipeline_apply(lambda act: _gelu_stage(own, act), own, xg, mesh, M)
        (got ** 2).sum().backward()
        xw = x.clone().requires_grad_(True)
        seq = [[t.detach().clone().requires_grad_(True) for t in stage] for stage in stages]
        want = sequential_apply(_gelu_stage, seq, xw)
        (want ** 2).sum().backward()
        out[(S, M)] = {"got": _numpy(got), "want": _numpy(want), "index": mesh["dp"].get_local_rank(),
                       "grad_w": (_numpy(own[0].grad), _numpy(seq[s][0].grad)),
                       "grad_b": (_numpy(own[1].grad), _numpy(seq[s][1].grad)),
                       "grad_x": (_numpy(xg.grad), _numpy(xw.grad))}
    return out


def case_pipelined_blocks(rank, payload, tmp):
    """A depth-4 stack of real transformer blocks pipelined in 4 stages (4 microbatches), from the flat
    weights: its output, and its gradients against the flat Transformer's; with remat too."""
    from arp_tpu_torch.models.layers import PipelinedTransformer, Transformer
    from arp_tpu_torch.ops.masks import MaskSpec
    from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, gather_named, load_full_state, split_of

    b = payload["blocks"]
    mesh = create_mesh(MeshConfig(dp=1, pp=4), "cpu")
    state = {k: torch.from_numpy(v) for k, v in b["state"].items()}
    x = torch.from_numpy(b["x"])
    flat = Transformer(emb_dim=32, depth=4, num_heads=4, mlp_ratio=2)
    flat.load_state_dict(state)
    xf = x.clone().requires_grad_(True)
    want = flat(xf, mask_spec=MaskSpec("causal"))
    (want ** 2).sum().backward()
    out = {"want": _numpy(want)}
    for remat in (False, True):
        pipe = PipelinedTransformer(emb_dim=32, depth=4, num_heads=4, mlp_ratio=2, stages=4, microbatches=4,
                                    mesh=mesh, remat=remat)
        load_full_state(pipe, state)
        xp = x.clone().requires_grad_(True)
        got = pipe(xp, mask_spec=MaskSpec("causal"))
        (got ** 2).sum().backward()
        grads = gather_named({n: p.grad for n, p in pipe.named_parameters()},
                             {n: split_of(p) for n, p in pipe.named_parameters() if split_of(p)})
        out[remat] = {"got": _numpy(got), "grads": _numpy(grads), "grad_x": _numpy(xp.grad)}
    out["flat_grads"] = {n: p.grad.numpy() for n, p in flat.named_parameters()}
    out["flat_grad_x"] = _numpy(xf.grad)
    return out
