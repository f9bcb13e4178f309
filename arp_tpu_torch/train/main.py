"""Policy trainer on GPUs — ``python -m arp_tpu_torch.train.main`` (port of arp_tpu/train/main.py).

The flags are the JAX trainer's, under argparse, with the same dotted names
for the nested configs (``--model.transfer_type=m3ae_vit_b16``,
``--data.path=...``, ``--logging.output_dir=...``) and ``name=value`` or
``name value`` spelling; ``--device`` (cuda unless ``cpu`` is asked for) is
the port's.  The batch goes through a thread that reads, collates and pins it,
then to the card by a ``non_blocking`` copy; the augmentation runs on the card
inside the step.

What differs from the JAX trainer, on purpose:
  * checkpoints are ``step_<n>.pt`` files (arp_tpu_torch/checkpoint.py), ``n``
    the number of batches consumed, and the step's random draws come from a
    generator seeded by (seed, step): a resumed run continues exactly as an
    uninterrupted one would (the JAX trainer resumes at the saved step, so it
    trains on that step's batch twice, and restarts its key chain);
  * ``cost/flops`` is the first batch's gradient computation counted by
    ``FlopCounterMode`` with the kernels' operations by formula
    (train/common.py::flops_analysis), not XLA's cost analysis;
  * the rollout eval's temperature draws (``--eval_temperature`` > 0) come from
    a torch generator seeded by (seed + step, policy call), not JAX's keys.

Rollout eval (``--eval_env fake|procgen``) runs every ``test_every_epochs``
and at the last step (train/common.py::build_test_step, envs/rollout.py), on
the card with the policy; its return is the score ``best.pt`` keeps
(``--checkpoint_dir``).

``--load_checkpoint`` starts from a reference-format pickle (the JAX
package's ``save_reference_checkpoint``, the reference's own), as the JAX
trainer does: the params from the file, the state's step from its
``state.step``, the first step from its ``step``, and a fresh AdamW (count 0,
zero moments), so the applied learning rate restarts from the schedule's
start while the logged ``learning_rate`` reads the state's step.

Several GPUs: ``torchrun --nproc_per_node=N -m arp_tpu_torch.train.main
--mesh_dp=N ...`` (or ``--mesh_fsdp``, ``--mesh_dcn_dp``; parallel/mesh.py), one
process a GPU.  Rank r of N is the JAX trainer's process r of N: it loads
``batch_size / N`` rows a step from the dataset offset by ``r / N``, seeds its
host draws with ``seed * (r + 1)`` (under tp or pp, r and N are the data share's
index and count: the ranks of one share load the same rows), and logs (heartbeat and profiler too) only
on rank 0 unless ``--log_all_worker``.  The model is built alike on every rank
(torch's seed is ``seed``), the step is wrapped by parallel/step.py's
``shard_train_state``, and the step's draws come from the (seed, step)
generator, the same on every rank: the augmentation is drawn for the global
batch and each rank applies its rows (train/common.py::make_loss_fn).  Rank 0
writes the checkpoints (the full state, whatever the world size) and runs the
rollout eval on the gathered parameters; the score is broadcast.
``--mesh_tp=T`` splits the policy's attention heads and MLP units over T ranks
(parallel/tensor_parallel.py); ``--mesh_pp=S`` pipelines its blocks in S stages
with ``--mesh_pp_microbatches`` microbatches (``model.pp_stages`` /
``model.pp_microbatches``, as the JAX trainer sets them; parallel/pipeline.py).
The rollout eval on rank 0 runs a flat model loaded with the gathered state.
"""

from __future__ import annotations

import copy
import logging
import os
import random
import sys

import numpy as np
import torch

from ..checkpoint import CheckpointManager, load_reference_checkpoint, reference_policy_state, refuse_jax_run
from ..config import Config, flag_leaves, parse_flag_tree
from ..data.instructions import get_m3ae_instruct
from ..data.loader import DataLoader
from ..data.procgen_dataset import ProcgenDataset, dataset_dirname
from ..device import resolve_device
from ..logging_utils import MetricsLogger
from ..models.policy import get_policy_default_config
from ..ops.augment import make_augment_fn, make_eval_transform
from ..parallel.distributed import initialize
from ..parallel.mesh import MeshConfig, create_mesh, data_share
from ..parallel.prefetch import ThreadedPrefetch, batch_to_device, pin_batch
from ..parallel.step import TrainState, make_eval_step, make_train_step, shard_train_state, tree_finite
from ..profiling import StepTimer, Trace
from ..resilience import FaultDetector, Heartbeat, PreemptionHandler
from .common import (
    _host_batch_to_arrays,
    _mean_metrics,
    build_lr_schedule,
    build_model,
    build_optimizer,
    build_test_step,
    flops_analysis,
    get_dummy_input,
    make_eval_loss_fn,
    make_loss_fn,
    maybe_build_frozen_qpack,
    model_image_size,
)

log = logging.getLogger("arp_tpu_torch.train")


def flag_defaults() -> dict:
    """The JAX trainer's flags and defaults, and ``device``."""
    return dict(
        seed=42, epochs=100, warmup_epochs=5.0, weight_decay=1e-4, batch_size=2, dataloader_n_workers=4,
        dataloader_shuffle=True, log_freq=100, save_model_freq=0, load_checkpoint="", lr=0.1, lr_schedule="cos",
        momentum=0.9, clip_gradient=1e9, auto_scale_lr=False, logging=MetricsLogger.get_default_config(),
        log_all_worker=False, model=get_policy_default_config(), data=ProcgenDataset.get_default_config(),
        window_size=4, use_text=False, val_every_epochs=10, test_every_epochs=10, num_test_episodes=5,
        eval_parallel_envs=0, eval_temperature=0.0, return_to_go=0.0, scale=10.0, game_name="coinrun",
        use_vl=True, vl_type="clip", vl_checkpoint="", use_crop=True, eval_data_path="", eval_data_name="",
        eval_with_goal=False, eval_instruct="",
        mesh_dp=-1, mesh_fsdp=1, mesh_tp=1, mesh_pp=1, mesh_dcn_dp=1, mesh_pp_microbatches=4,
        accum_steps=1, checkpoint_dir="", episode_length=500, eval_env="fake", env_eval_env_type="none",
        env_distribution_mode="hard", env_num_levels=500, env_start_level=0, env_hidden_goal=False,
        reward_bf16=False, patch_dim=16, encode_image_size=0, explicit_l2_penalty=False,
        # on a detected nan/spike: "log", "halt" (exit non-zero) or "rollback" (restore the latest
        # checkpoint and go on forward through the data)
        fault_policy="log",
        heartbeat_path="",  # "" -> <output_dir>/heartbeat; "off" disables
        heartbeat_interval=60.0,
        fault_inject_step=-1,  # poison the batch with NaNs at this step (-1: never)
        validate_data=True,
        profile_dir="", profile_start_step=5, profile_steps=3,
        device="cuda",
    )


def parse_flags(argv=None) -> Config:
    """The flags as a Config tree: the defaults, with every ``--name[.sub]=value`` of ``argv`` applied."""
    return parse_flag_tree(flag_defaults(), argv, "Train an ARP-DT / BC / GCBC policy (PyTorch, GPUs).")


def start_from_reference_checkpoint(state, path: str) -> int:
    """``--load_checkpoint``: ``state`` (its model's first forward run, its optimizer fresh) takes the
    params of the reference pickle at ``path`` and its ``state.step``, as the JAX trainer's
    ``state.replace(params=..., step=...)``; the optimizer keeps count 0 and zero moments.  Returns
    the first step of the run, the file's ``step``."""
    data = load_reference_checkpoint(path)
    with torch.no_grad():
        state.model.load_trained_state_dict(reference_policy_state(data))
    state.step = int(data["state"].step)
    return int(data["step"])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's random stream: a function of (seed, step) alone, so a resumed run draws as an
    uninterrupted one."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def _poison(tree):
    if isinstance(tree, dict):
        return {k: _poison(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree * float("nan")
    return tree


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    flags = parse_flags(argv)
    refuse_jax_run(flags.checkpoint_dir)  # before any work: a JAX run's directory does not resume here
    process_index, process_count = initialize(device=flags.device)
    device = resolve_device(flags.device)
    mesh = create_mesh(MeshConfig(dp=flags.mesh_dp, fsdp=flags.mesh_fsdp, tp=flags.mesh_tp, pp=flags.mesh_pp,
                                  dcn_dp=flags.mesh_dcn_dp), device)
    if flags.mesh_pp > 1:
        # the policy's blocks pipelined over the pp axis; the model takes the mesh at construction
        flags.model.pp_stages = flags.mesh_pp
        flags.model.pp_microbatches = flags.mesh_pp_microbatches
    # the batch splits over the data axes: the tp and pp ranks of one data share load the same rows
    share_index, share_count = data_share(mesh) if mesh is not None else (process_index, process_count)
    if flags.batch_size % share_count:
        raise ValueError(f"--batch_size={flags.batch_size} does not split over {share_count} data shares")
    process_batch_size = flags.batch_size // share_count
    variant = dict(flag_leaves(flags))
    variant.update(process_index=process_index, process_count=process_count, process_batch_size=process_batch_size)
    lr_scale = flags.batch_size / 256 if flags.auto_scale_lr else 1.0
    main_process = process_index == 0

    flags.model.use_discrete_action = True
    use_text = flags.use_text
    if not flags.use_vl and flags.vl_type == "BC":
        use_text = True  # InstructRL baseline

    logger = MetricsLogger(config=flags.logging, variant=variant, enable=flags.log_all_worker or main_process)
    np.random.seed(flags.seed * (share_index + 1))
    random.seed(flags.seed * (share_index + 1))
    torch.manual_seed(flags.seed)  # the model's initialization, the same on every rank

    dataset_name = dataset_dirname(flags.game_name, flags.env_distribution_mode, flags.env_start_level,
                                   flags.env_num_levels, flags.data.num_demonstrations, flags.data.num_frames,
                                   flags.data.enable_filter, flags.data.train_env_type)
    if flags.validate_data:
        # before the dataset opens the files: a schema fault reports instead of a traceback
        from ..data.validate import validate_file

        img_key = (flags.data.image_key or "ob").split(", ")[0]
        for split in ("train", "val"):
            path = f"{flags.data.path}/{dataset_name}/data_{split}.hdf5"
            rep = validate_file(path, image_key=img_key, strict_stacking=False)
            for w in rep.warnings:
                log.warning("data validation: %s: %s", path, w)
            if rep.errors:
                raise ValueError(f"invalid demo file {path}: " + "; ".join(rep.errors)
                                 + " (rerun with --validate_data=False to override)")

    offset = share_index / share_count
    train_dataset = ProcgenDataset(update=flags.data, dataset_name=dataset_name, start_offset_ratio=offset,
                                   split="train")
    val_dataset = ProcgenDataset(update=flags.data, dataset_name=dataset_name, start_offset_ratio=offset, split="val")
    train_loader = DataLoader(train_dataset, batch_size=process_batch_size, shuffle=flags.dataloader_shuffle,
                              num_workers=flags.dataloader_n_workers, seed=flags.seed)
    val_batch_size = max(1, min(process_batch_size, len(val_dataset) // share_count))
    # as JAX's: a multiple of the device count (here one device a data share)
    val_batch_size = max(share_count, (val_batch_size // share_count) * share_count)
    val_loader = DataLoader(val_dataset, batch_size=val_batch_size, shuffle=flags.dataloader_shuffle,
                            num_workers=flags.dataloader_n_workers, seed=flags.seed + 1)

    steps_per_epoch = max(1, len(train_dataset) // flags.batch_size)
    total_steps = steps_per_epoch * flags.epochs
    val_steps = max(1, len(val_dataset) // val_batch_size)
    save_model_freq = flags.save_model_freq or steps_per_epoch * flags.test_every_epochs
    use_goal = "GCBC" in flags.vl_type

    frozen_qpack = None
    if flags.model.get("frozen_int8", False):
        sample = _host_batch_to_arrays(next(iter(train_loader)), use_text, use_goal)
        # the calibration scales are kept beside the checkpoints: a restore rebuilds this pack
        frozen_qpack = maybe_build_frozen_qpack(flags, sample, use_goal, checkpoint_dir=flags.checkpoint_dir,
                                                save=True, device=device, mesh=mesh)
    dummy_input = get_dummy_input(flags, train_dataset)
    if use_text:
        ids, pad = train_dataset.tokenizer(get_m3ae_instruct(flags.game_name) or "")
        dummy_input["instruct"], dummy_input["text_padding_mask"] = ids[None], pad[None]

    def new_model(flat: bool = False):
        """The policy on this rank's layout, or ``flat``: unpipelined, whole (the rollout eval's on rank 0)."""
        built_flags = flags
        if flat and flags.model.pp_stages > 1:
            built_flags = copy.deepcopy(flags)
            built_flags.model.pp_stages = 1
        built = build_model(built_flags, train_dataset.num_actions, frozen_qpack=frozen_qpack,
                            mesh=None if flat else mesh).to(device)
        with torch.no_grad():
            built(dummy_input, deterministic=True)  # the lazy layers take their shapes, as at Flax's init
        return built

    model = new_model()
    learning_rate = build_lr_schedule(flags, steps_per_epoch, total_steps, lr_scale)
    state = TrainState.create(model, build_optimizer(flags, learning_rate, model))

    ckpt = CheckpointManager(flags.checkpoint_dir) if flags.checkpoint_dir else None
    start_step = 0
    if flags.load_checkpoint:
        start_step = start_from_reference_checkpoint(state, flags.load_checkpoint)
        log.info("loaded %s (step %d)", flags.load_checkpoint, start_step)
    elif ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        start_step = int(meta["step"])
        log.info("resumed from step %d", start_step)
    num_params = sum(p.numel() for _, p in state.params)
    logger.log({"cost/num_params": num_params})
    log.info("num_params: %d", num_params)
    # the rollout eval's model on rank 0: the trained one itself unless fsdp shards it, tp splits it or pp
    # stages it in place
    laid_out = mesh is not None and any(mesh[axis].size() > 1 for axis in ("fsdp", "tp", "pp"))
    eval_model = new_model(flat=True) if laid_out and main_process and flags.eval_env != "none" else model
    state = shard_train_state(state, mesh)

    # the augmentation runs on the device inside the step
    image_size = model_image_size(flags)
    transfer = flags.model.transfer_type
    augment_fn = None if transfer.endswith("_cached") else make_augment_fn(
        flags.data.augmentations, image_size=image_size, source_size=flags.data.image_size)
    eval_transform = make_eval_transform(image_size=image_size, device=device)
    loss_fn = make_loss_fn(model, augment_fn, image_size, use_goal, share=data_share(mesh))
    train_step = make_train_step(
        loss_fn,
        mesh=mesh,
        # AdamW decays already; the reference adds an explicit 0.5 * wd * ||W||^2 on top
        weight_decay=flags.weight_decay if flags.explicit_l2_penalty else 0.0,
        learning_rate_fn=learning_rate,
        accum_steps=flags.accum_steps,
    )
    eval_step = make_eval_step(make_eval_loss_fn(model, eval_transform, use_goal), mesh=mesh)
    pin = device.type == "cuda"
    first = batch_to_device(pin_batch(_host_batch_to_arrays(next(iter(train_loader)), use_text, use_goal), pin), device)
    # one step's gradient computation on the first batch (every rank's share: the global step's
    # count, as XLA's cost analysis of the global jit); the state is left as it was
    flops = flops_analysis(train_step.gradients, state, first, step_generator(flags.seed, 0, device))
    logger.log({"cost/flops": flops * data_share(mesh)[1] if flops >= 0 else flops})
    del first
    # rollout eval (None for cached-embedding policies, which cannot encode env frames)
    test_step_fn = None
    if flags.eval_env != "none":
        test_step_fn = build_test_step(flags, eval_model, train_dataset, eval_transform, use_text, mesh=mesh,
                                       device=device)
    best_eval_score = -np.inf

    # exact resume: the loader fast-forwards past the batches already consumed
    train_iter = ThreadedPrefetch(
        (pin_batch(_host_batch_to_arrays(b, use_text, use_goal), pin) for b in train_loader.epochs(skip_batches=start_step)),
        capacity=2,
    )
    preemption = PreemptionHandler()
    faults = FaultDetector()
    step_timer = StepTimer()
    heartbeat = None
    if flags.heartbeat_path != "off" and main_process:
        heartbeat = Heartbeat(flags.heartbeat_path or os.path.join(logger.config.output_dir, "heartbeat"),
                              interval_s=flags.heartbeat_interval)

    def save(step, epoch):
        ckpt.save(step + 1, state, metadata={"step": step + 1, "epoch": epoch})

    train_metrics = []
    last_rollback_step = None  # livelock guard for fault_policy=rollback
    profile_start = start_step + flags.profile_start_step
    profile_stop = profile_start + max(flags.profile_steps, 1)
    tracer = None
    try:
        for step in range(start_step, total_steps):
            if flags.profile_dir and main_process:
                if step == profile_start:
                    log.info("profiler: tracing %d steps to %s", profile_stop - profile_start, flags.profile_dir)
                    tracer = Trace(flags.profile_dir)
                    tracer.start()
                elif tracer is not None and step == profile_stop:
                    tracer.stop()
                    tracer = None
            batch = batch_to_device(next(train_iter), device)
            if step == flags.fault_inject_step:
                log.warning("chaos: injecting NaN batch at step %d", step)
                batch = _poison(batch)
            epoch = step // steps_per_epoch
            state, aux = train_step(state, batch, step_generator(flags.seed, step, device))
            train_metrics.append(aux)
            step_timer.tick()
            if heartbeat is not None:
                heartbeat.beat(step)

            if preemption.should_stop:
                log.warning("preemption signal: checkpointing and exiting at step %d", step)
                if ckpt is not None:
                    save(step, epoch)
                break

            if step and step % flags.log_freq == 0:
                logged = _mean_metrics(train_metrics, prefix="train_")
                status = faults.check(logged["train_loss"])
                if status != "ok":
                    log.error("fault detector: %s at step %d (loss=%s)", status, step, logged["train_loss"])
                    logged["fault"] = status
                    if flags.fault_policy == "halt":
                        logged.update(step=step, epoch=epoch)
                        logger.log(logged)
                        raise SystemExit(f"fault detector: {status} at step {step} (fault_policy=halt)")
                    if flags.fault_policy == "rollback":
                        if ckpt is None or ckpt.latest_step() is None:
                            raise SystemExit(f"fault detector: {status} at step {step}; rollback requested but no "
                                             "checkpoint exists (--checkpoint_dir)")
                        state, meta = ckpt.restore(state)
                        restored_step = int(meta["step"])
                        if not tree_finite([p for _, p in state.params]):
                            raise SystemExit(f"fault detector: {status} at step {step}; latest checkpoint (step "
                                             f"{restored_step}) is itself non-finite — halting instead of looping")
                        if restored_step == last_rollback_step:
                            raise SystemExit(f"fault detector: {status} recurred immediately after restoring step "
                                             f"{restored_step} — data or model divergence, not a transient; halting")
                        last_rollback_step = restored_step
                        faults.reset()
                        logged["rolled_back_to"] = restored_step
                        log.warning("fault rollback: restored step %s, continuing forward at step %d", restored_step, step)
                logged.update(step=step, epoch=epoch, **step_timer.metrics(flags.batch_size))
                logger.log(logged)
                train_metrics = []

            if flags.val_every_epochs > 0 and step > 0 and step % (flags.val_every_epochs * steps_per_epoch) == 0:
                val_metrics = [eval_step(state, batch_to_device(pin_batch(_host_batch_to_arrays(vb, use_text, use_goal),
                                                                          pin), device), None)
                               for _, vb in zip(range(val_steps), val_loader)]
                if val_metrics:
                    logged = _mean_metrics(val_metrics, prefix="val_")
                    logged.update(step=step, epoch=epoch)
                    logger.log(logged)

            if (test_step_fn is not None and flags.test_every_epochs > 0 and step > 0
                    and (step % (flags.test_every_epochs * steps_per_epoch) == 0 or step == total_steps - 1)):
                metric, _, videos = test_step_fn(state, flags.seed + step)
                logged = {f"test/{k}": float(v) for k, v in metric.items()}
                logged.update(step=step, epoch=epoch)
                logger.log(logged)
                if videos:
                    logger.log_video(f"media/test_step{step}", videos[0])
                score = float(metric["return"])
                if ckpt is not None:
                    if np.isfinite(score) and tree_finite([p for _, p in state.params]):
                        ckpt.save_best(step + 1, state, score, metadata={"step": step + 1})
                    else:
                        log.error("skipping best-save at step %d: non-finite score/params", step)
                best_eval_score = max(best_eval_score, score)

            if ckpt is not None and step and ((save_model_freq > 0 and step % save_model_freq == 0)
                                              or step == total_steps - 1):
                # a NaN checkpoint would defeat fault_policy=rollback
                if tree_finite([p for _, p in state.params]):
                    save(step, epoch)
                else:
                    log.error("skipping checkpoint at step %d: non-finite params", step)

        if tracer is not None:  # the loop ended inside the profile window
            tracer.stop()
        if train_metrics:  # what the log cadence left over
            logged = _mean_metrics(train_metrics, prefix="train_")
            logged.update(step=total_steps - 1, **step_timer.metrics(flags.batch_size))
            logger.log(logged)
    finally:
        train_iter.close()
        preemption.restore()
    logger.log({"final_step": total_steps, "best_eval_score": float(best_eval_score)})
    logger.close()


if __name__ == "__main__":
    sys.exit(main())
