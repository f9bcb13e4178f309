"""Spawned ranks for the port's several-process tests (tests/test_torch_parallel*.py).

Imports torch, numpy and arp_tpu_torch only: never jax (the tests compute the
JAX package's side in their own process and pass numpy in).  ``spawn(cases,
payload, tmp)`` starts ``world`` processes over gloo on the CPU, joined through a
file store under ``tmp`` (so that test workers running side by side never race
for a port), runs every named case in each rank, and returns each rank's results.
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
# a 2-layer, 64-wide M3AE tower for the frozen_int8 calibration
TOWER = dict(model_type=None, emb_dim=64, dec_emb_dim=16, depth=2, dec_depth=1, num_heads=4, dec_num_heads=4,
             mlp_ratio=2)


def spawn(cases, payload, tmp, world: int = 2) -> list:
    """Run ``cases`` (names of this module's case functions) in ``world`` spawned gloo ranks."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    torch.multiprocessing.start_processes(_entry, args=(world, tmp, list(cases)), nprocs=world, join=True,
                                          start_method="spawn")
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
    the norm over whole tensors (``global_sum_of_squares``), the step shard by shard."""

    def __init__(self, lr: float, clip: float):
        self.lr, self.clip = lr, clip

    def init(self, params):
        from arp_tpu_torch.train.common import AdamWState

        return AdamWState(0, [], [])

    @torch.no_grad()
    def update(self, params, grads, state):
        from arp_tpu_torch.parallel.step import local_part
        from arp_tpu_torch.train.common import AdamWState, global_sum_of_squares

        local = [local_part(g) for g in grads]
        norm = torch.sqrt(global_sum_of_squares(local, list(grads)))
        clipped = torch._foreach_mul(torch._foreach_div(local, norm), self.clip)
        keep = norm < self.clip
        steps = [torch.where(keep, g, c) for g, c in zip(local, clipped)]
        torch._foreach_add_([local_part(p) for p in params], torch._foreach_mul(steps, -self.lr))
        return AdamWState(state.count + 1, [], [])


def arpdt(init: dict, batch: dict):
    """The port's vit_debug ARPDT with the weights ``init`` (its first forward run)."""
    from arp_tpu_torch.models.policy import ARPDT

    model = ARPDT(ARPDT_CFG, num_actions=15, patch_dim=16)
    with torch.no_grad():
        model({k: (v if v is None else {kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1])
               for k, v in batch.items()}, deterministic=True)
        model.load_trained_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    return model


def deterministic_loss(model, batch, generator):
    out = model(batch, deterministic=True)
    return out["loss"], {"acc": out["acc"]}


def train_arpdt(payload, mesh_config=None, steps=3, accum_steps=1):
    """``steps`` steps of the JAX mesh test's step (explicit 1e-4 l2 penalty), on ``mesh_config``'s mesh
    (None: one process, the whole batch).  Returns (full params, last loss, state)."""
    from arp_tpu_torch.parallel.mesh import batch_share, create_mesh, gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state

    mesh = create_mesh(mesh_config, "cpu") if mesh_config is not None else None
    state = TrainState.create(arpdt(payload["init"], payload["batch"]), ClippedSGD(0.1, 10.0))
    state = shard_train_state(state, mesh)
    step = make_train_step(deterministic_loss, mesh=mesh, weight_decay=1e-4, accum_steps=accum_steps)
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
        return t.clone() if t.ndim == 0 else distribute_tensor(t.clone(), mesh, [Replicate(), Shard(0)])

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


def _state_with_adamw(payload, mesh):
    from arp_tpu_torch.parallel.step import TrainState, shard_train_state, trainable_parameters
    from arp_tpu_torch.train.common import AdamW

    model = arpdt(payload["init"], payload["batch"])
    tx = AdamW(lambda count: 1e-3, 1e-4, [True] * len(trainable_parameters(model)), clip=1.0)
    return shard_train_state(TrainState.create(model, tx), mesh)


def _full_state(state) -> dict:
    from arp_tpu_torch.parallel.mesh import gather_to_host

    return {"params": _numpy(gather_to_host(state.model)), "mu": _numpy(gather_to_host(list(state.opt_state.mu))),
            "nu": _numpy(gather_to_host(list(state.opt_state.nu))), "count": state.opt_state.count,
            "step": state.step}


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
    """The trainer CLI in each rank at --mesh_dp=2 and --mesh_fsdp=2: each rank's batches, its writes,
    the first step against the one-process step on the global batch (both ranks' rows)."""
    import copy

    import arp_tpu_torch.checkpoint as ckpt_lib
    from arp_tpu_torch.parallel.mesh import gather_to_host
    from arp_tpu_torch.parallel.step import TrainState, make_train_step, unwrap
    from arp_tpu_torch.train import main as tmain
    from arp_tpu_torch.train.common import AdamW

    out = {}
    orig_step, orig_loss, orig_save = tmain.make_train_step, tmain.make_loss_fn, ckpt_lib._atomic_save
    orig_update = AdamW.update
    for flag in ("--mesh_dp=2", "--mesh_fsdp=2"):
        rec = {"actions": [], "losses": [], "writes": []}

        def make_loss_fn(model, augment_fn, image_size, use_goal, share=(0, 1), rec=rec):
            rec["loss_args"] = (augment_fn, image_size, use_goal, share)
            return orig_loss(model, augment_fn, image_size, use_goal, share=share)

        def make_train_step(loss_fn, rec=rec, **kw):
            step = orig_step(loss_fn, **kw)

            def wrapped(state, batch, generator):
                if not rec["actions"]:
                    rec["init"] = gather_to_host(state.model)
                    rec["module"] = copy.deepcopy(unwrap(state.model)) if flag == "--mesh_dp=2" else None
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
        AdamW.update = update
        key, name = flag.split("=")[0][2:], flag.split("=")[0].split("_")[1]
        try:
            tmain.main(payload["trainer_argv"] + [flag, f"--checkpoint_dir={tmp}/trainer_{name}",
                                                  f"--logging.output_dir={tmp}/trainer_log_{name}"])
        finally:
            tmain.make_train_step, tmain.make_loss_fn, ckpt_lib._atomic_save = orig_step, orig_loss, orig_save
            AdamW.update = orig_update
        final = _numpy(gather_to_host(rec["state"].model))
        result = {"actions": rec["actions"], "losses": rec["losses"], "writes": rec["writes"], "final": final,
                  "after_first": _numpy(rec["after_first"]), "share": rec["loss_args"][3],
                  "first_grads": dict(zip(rec["names"], _numpy(gather_to_host(rec["grads"]))))}
        # the one-process step on the global batch of the first step, from the same state and draws
        global_batch = _concat(_gather_objects(rec["first"]))
        if rec["module"] is not None:
            model = rec["module"]
            with torch.no_grad():
                model.load_trained_state_dict(rec["init"])
            augment_fn, image_size, use_goal, _ = rec["loss_args"]
            state = TrainState.create(model, rec["tx"])
            step = orig_step(orig_loss(model, augment_fn, image_size, use_goal))
            global_batch = {k: (v if v is None else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                                if isinstance(v, dict) else torch.from_numpy(v)) for k, v in global_batch.items()}
            del rec["grads"]
            AdamW.update = update
            try:
                state, aux = step(state, global_batch, tmain.step_generator(payload["trainer_seed"], 0, "cpu"))
            finally:
                AdamW.update = orig_update
            result["one_process_first"] = _numpy(gather_to_host(state.model))
            result["one_process_loss"] = float(aux["loss"])
            result["one_process_grads"] = dict(zip(rec["names"], _numpy(rec["grads"])))
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
