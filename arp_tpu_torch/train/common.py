"""Shared trainer building blocks (port of arp_tpu/train/common.py; flag-free, see main.py).

The optimizer is optax's ``chain(clip_by_global_norm(clip), adamw(lr, b1=0.9,
b2=0.999, eps=1e-8, weight_decay, mask))`` written out (:class:`AdamW`), not
``torch.optim.AdamW``: that one decays the parameter before the Adam step, has
no mask, and ``clip_grad_norm_`` adds 1e-6 to the norm.  Here, as in optax:

  * the gradients are scaled by ``clip / ||g||`` only when ``||g|| >= clip``
    (``||g||`` over every trained tensor, no epsilon);
  * ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, both bias-corrected
    with the incremented count, and the direction is ``mu_hat / (sqrt(nu_hat) + eps)``;
  * ``weight_decay * p`` is added to it where the mask allows (the policies'
    ``no_decay_list`` is empty: every trained parameter decays);
  * the sum is multiplied by ``-lr(count)``, the schedule at the count of updates
    made *before* this one, and added to the parameter.

:func:`build_test_step` is the rollout eval (envs/rollout.py) with the reward
engine the flags ask for.  Greedy actions (``eval_temperature`` 0, the
default) are the JAX package's; with a temperature the actions are drawn by
``BasePolicy.sample_action`` from a ``torch.Generator`` seeded by (the eval's
seed, the policy call's index), reproducible under one seed but not the JAX
key stream's draws.

:func:`flops_analysis` counts one step with ``FlopCounterMode``, the kernels'
operations added by formula.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..data.instructions import get_clip_special_instruct, get_eval_instruct, get_m3ae_instruct
from ..device import resolve_device
from ..models.policy import ARPDT, BC, GCBC

log = logging.getLogger(__name__)


def build_model(flags_obj, num_actions: int, frozen_qpack=None, pt_variables=None, mesh=None):
    """ARPDT with VL rewards or task rewards, else GCBC or BC, from the flags' model config.
    ``pt_variables``: the frozen tower's state dict (None: its family's loader); ``mesh``: the device
    mesh, which ``model.pp_stages > 1`` pipelines the policy's blocks over."""
    if flags_obj.use_vl or flags_obj.data.use_task_reward:
        cls = ARPDT
    elif "GCBC" in flags_obj.vl_type:
        cls = GCBC
    else:
        cls = BC
    return cls(config_updates=flags_obj.model, num_actions=num_actions, patch_dim=flags_obj.patch_dim,
               normalize_quterion=False, frozen_qpack=frozen_qpack, pt_variables=pt_variables, mesh=mesh)


def _frozen_amax_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "frozen_int8_amax.npz")


def save_frozen_amax(checkpoint_dir: str, amax) -> str:
    """Keep the frozen_int8 calibration scales beside the checkpoint, so that a restore rebuilds
    the int8 pack it trained with instead of calibrating again on another batch."""
    path = _frozen_amax_path(checkpoint_dir)
    os.makedirs(checkpoint_dir, exist_ok=True)

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    np.savez(path, img=host(amax["img"]), **{f"layers/{k}": host(v) for k, v in amax["layers"].items()})
    return path


def load_frozen_amax(checkpoint_dir: str):
    """The saved calibration scales (numpy), or None when there are none."""
    path = _frozen_amax_path(checkpoint_dir)
    if not checkpoint_dir or not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {"img": z["img"], "layers": {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("layers/")}}


def _max_over_ranks(amax: dict, device) -> dict:
    """The calibration scales' elementwise maximum over every rank (one collective)."""
    import torch.distributed as dist

    values = [torch.as_tensor(v) for v in [amax["img"], *amax["layers"].values()]]
    flat = torch.cat([v.reshape(-1).to(device, torch.float32) for v in values])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX)
    pieces = [p.reshape(v.shape).to(v.dtype).cpu() for p, v in zip(flat.split([v.numel() for v in values]), values)]
    return {"img": pieces[0], "layers": dict(zip(amax["layers"], pieces[1:]))}


def maybe_build_frozen_qpack(flags_obj, sample_batch, use_goal: bool, checkpoint_dir: str = "", save: bool = False,
                             device="cuda", m3ae_loader=None, mesh=None):
    """The calibrated int8 pack for ``--model.frozen_int8`` (None otherwise).

    ``sample_batch`` is a real host batch: the int8 activation scales calibrate on it.  Saved
    scales in ``checkpoint_dir`` win over a fresh calibration; with ``save`` fresh ones are kept
    there.  The pack is built on ``device`` (the card unless the caller asks for the CPU).
    ``mesh``: ``sample_batch`` is this rank's share of the first batch; each scale is the maximum
    over the ranks (the global batch's, the same on every rank, as JAX's replicated step needs),
    and rank 0 alone writes the file.
    """
    if not flags_obj.model.get("frozen_int8", False) or flags_obj.model.use_from_scratch:
        return None
    from ..models.policy import build_frozen_qpack

    image_size = 256
    if getattr(flags_obj, "encode_image_size", 0) > 0:
        image_size = flags_obj.encode_image_size
    kw = dict(image_size=image_size, use_goal=use_goal, device=device, m3ae_loader=m3ae_loader)
    from ..parallel.distributed import barrier, process_index

    amax = load_frozen_amax(checkpoint_dir)
    if mesh is not None:
        barrier()  # every rank has looked for the file before rank 0 may write it
    if amax is not None:
        log.info("frozen_int8: rebuilding the pack from saved calibration scales (%s)", _frozen_amax_path(checkpoint_dir))
        return build_frozen_qpack(flags_obj.model, sample_batch, flags_obj.patch_dim, amax=amax, **kw)
    log.info("frozen_int8: calibrating the packed encoder on a real batch")
    qpack, amax = build_frozen_qpack(flags_obj.model, sample_batch, flags_obj.patch_dim, return_amax=True, **kw)
    if mesh is not None:
        amax = _max_over_ranks(amax, resolve_device(device))
        qpack = build_frozen_qpack(flags_obj.model, sample_batch, flags_obj.patch_dim, amax=amax, **kw)
    if save and checkpoint_dir and process_index() == 0:
        save_frozen_amax(checkpoint_dir, amax)
    return qpack


# -- schedule and optimizer (optax's, written out) ---------------------------------------------------

def _f32(x) -> np.float32:
    return np.float32(x)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax.linear_schedule, in float32 as optax computes it."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count):
        frac = _f32(1) - _f32(min(max(count, 0), transition_steps)) / _f32(transition_steps)
        return float((_f32(init_value) - _f32(end_value)) * frac + _f32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable:
    """optax.cosine_decay_schedule, in float32."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = _f32(min(count, decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return float(_f32(init_value) * ((_f32(1) - _f32(alpha)) * cosine + _f32(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable:
    """optax.warmup_cosine_decay_schedule: linear warmup, then cosine decay to ``end_value``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


def build_lr_schedule(flags_obj, steps_per_epoch: int, total_steps: int, lr_scale: float = 1.0) -> Callable:
    """count -> learning rate, as the JAX trainer's optax schedules."""
    if flags_obj.lr_schedule == "fixed":
        return linear_schedule(flags_obj.lr, flags_obj.lr, total_steps)
    if flags_obj.lr_schedule == "cos":
        return warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=flags_obj.lr * lr_scale,
            # warmup never takes all of total_steps (the cosine needs positive decay steps)
            warmup_steps=min(int(flags_obj.warmup_epochs * steps_per_epoch), max(total_steps - 1, 0)),
            decay_steps=total_steps,
            end_value=0.0,
        )
    if flags_obj.lr_schedule == "cos_decay":
        return cosine_decay_schedule(flags_obj.lr, total_steps)
    raise ValueError(f"Unsupported lr schedule {flags_obj.lr_schedule!r}")


class AdamWState:
    """optax's (count, mu, nu): the number of updates made, and the two moments of every parameter."""

    def __init__(self, count: int, mu: list, nu: list):
        self.count, self.mu, self.nu = count, mu, nu


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(learning_rate, b1, b2, eps, weight_decay, mask))``
    on a list of parameters; ``decay[i]`` is the mask's entry of parameter i.  ``clip=None`` is
    ``optax.adamw`` alone, without the clipping (the adapter fine-tuning's optimizer)."""

    def __init__(self, learning_rate: Callable, weight_decay: float, decay: list, clip: Optional[float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate, self.weight_decay, self.decay, self.clip = learning_rate, weight_decay, decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list) -> AdamWState:
        if len(params) != len(self.decay):
            raise ValueError(f"{len(params)} parameters against a decay mask of {len(self.decay)}")
        return AdamWState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: list, grads: list, state: AdamWState) -> AdamWState:
        """Updates ``params`` in place from ``grads``; returns the new state.

        Sharded parameters (``DTensor`` s of FSDP2, their gradients and moments alike) are updated
        shard by shard, and so are tp shares and pp stages: every step but the norm is elementwise,
        and the norm is the whole model's, the squares of shards added over the ranks that hold the
        others."""
        from ..parallel.mesh import split_of
        from ..parallel.step import local_part

        b1, b2 = self.b1, self.b2
        like = list(state.mu)
        splits = [split_of(p) for p in params]
        params, grads = [local_part(p) for p in params], [local_part(g) for g in grads]
        mu_prev, nu_prev = [local_part(m) for m in state.mu], [local_part(v) for v in state.nu]
        if self.clip is not None:
            # clip_by_global_norm: a select on the device, no host round trip
            g_norm = torch.sqrt(global_sum_of_squares(grads, like, splits))
            clipped = torch._foreach_mul(torch._foreach_div(grads, g_norm), self.clip)
            keep = g_norm < self.clip
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        # scale_by_adam
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu_prev, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                torch._foreach_mul(nu_prev, b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, float(_f32(1) - _f32(b1) ** _f32(count)))
        nu_hat = torch._foreach_div(nu, float(_f32(1) - _f32(b2) ** _f32(count)))
        updates = list(torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)))
        # add_decayed_weights under the mask
        if self.weight_decay:
            decayed = [i for i, d in enumerate(self.decay) if d]
            added = torch._foreach_add([updates[i] for i in decayed], torch._foreach_mul(
                [params[i] for i in decayed], self.weight_decay))
            for i, u in zip(decayed, added):
                updates[i] = u
        # scale_by_learning_rate at the count before this update, then apply_updates
        torch._foreach_add_(params, torch._foreach_mul(updates, -self.learning_rate(state.count)))
        return AdamWState(count, _laid_out_as(mu, like), _laid_out_as(nu, like))


def _laid_out_as(local: list, like: list) -> list:
    """Local shards back into ``DTensor`` s where ``like`` holds them."""
    from torch.distributed.tensor import DTensor

    return [DTensor.from_local(t, r.device_mesh, r.placements, shape=r.shape, stride=r.stride())
            if isinstance(r, DTensor) else t for t, r in zip(local, like)]


def global_sum_of_squares(local: list, like: list, splits: Optional[list] = None) -> torch.Tensor:
    """sum g^2 over whole tensors, given their local parts ``local``: where ``like[i]`` is a sharded
    ``DTensor`` the shards' sums are added over the ranks that hold its other shards (one
    collective for all of them); where ``splits[i]`` (parallel/mesh.py::Split) is a tp share or a pp
    stage, those sums are then added over its axis (one collective an axis); the rest is summed as it
    is, in order."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    squares = [torch.sum(g * g) for g in local]
    groups = {}
    for i, split in enumerate(splits or [None] * len(local)):
        groups.setdefault(None if split is None else split.group, []).append(i)
    total = None
    for group, idx in groups.items():
        sharded = [squares[i] for i in idx if isinstance(like[i], DTensor)]
        rest = [squares[i] for i in idx if not isinstance(like[i], DTensor)]
        part = None
        if sharded:
            ref = next(like[i] for i in idx if isinstance(like[i], DTensor))
            part = DTensor.from_local(torch.stack(sharded).sum(), ref.device_mesh,
                                      [_partial_where_sharded(p) for p in ref.placements]).full_tensor()
        if rest:
            part = torch.stack(rest).sum() if part is None else part + torch.stack(rest).sum()
        if group is not None:
            dist.all_reduce(part, group=group)
        total = part if total is None else total + part
    return total


def _partial_where_sharded(placement):
    from torch.distributed.tensor import Partial, Replicate

    return Partial() if placement.is_shard() else Replicate()


def build_optimizer(flags_obj, learning_rate: Callable, model, params: Optional[list] = None) -> AdamW:
    """clip_by_global_norm + adamw with the model's no-decay mask (the reference's main_procgen.py:490-507).

    ``params``: the (name, parameter) pairs the optimizer will update; by default the model's
    trained parameters, which exist only after its first forward."""
    from ..parallel.step import trainable_parameters, unwrap

    model = unwrap(model)  # the names are the model's own, never a wrapper's "module." ones
    params = trainable_parameters(model) if params is None else params
    no_decay = model.no_decay_list()
    decay = [not any(nd in part for nd in no_decay for part in name.split(".")) for name, _ in params]
    return AdamW(learning_rate, flags_obj.weight_decay, decay, flags_obj.clip_gradient)


# -- inputs and losses -----------------------------------------------------------------------------

def model_image_size(flags_obj) -> int:
    """The side the frames are resized to for the encoder (CLIP 224, the MAE / M3AE towers 256)."""
    transfer = flags_obj.model.transfer_type
    image_size = 224 if transfer.startswith("clip") else 256
    if transfer == "none":
        image_size = flags_obj.data.image_size
    if getattr(flags_obj, "encode_image_size", 0) > 0:
        image_size = flags_obj.encode_image_size
    return image_size


def get_dummy_input(flags_obj, dataset) -> dict:
    """The one-sample batch whose forward gives the lazy layers their shapes (Flax's init input)."""
    window = flags_obj.window_size
    transfer = flags_obj.model.transfer_type
    if transfer.endswith("_cached"):
        emb_dim = dataset[0]["image_emb"][dataset.config.image_key.split(", ")[0]].shape[-1]
        keys = dataset.obs_shape["image"]
        return {
            "action": np.ones((1, window), np.int32),
            "image_emb": {k: np.ones((1, window, emb_dim), np.float32) for k in keys},
            "goal_emb": {k: np.ones((1, window, emb_dim), np.float32) for k in keys},
            "rtg": {k: np.ones((1, window, 1), np.float32) for k in dataset.obs_shape["rtg"]},
            "goal": None,
            "instruct": None,
            "text_padding_mask": None,
        }
    image_size = model_image_size(flags_obj)
    dummy = {"action": np.ones((1, window), np.int32), "image": {}, "goal": {}, "rtg": {}, "instruct": None,
             "text_padding_mask": None}
    for k in dataset.obs_shape["image"]:
        dummy["image"][k] = np.ones((1, window, image_size, image_size, 3), np.float32)
        dummy["goal"][k] = np.ones((1, window, image_size, image_size, 3), np.float32)
        dummy["rtg"][k] = np.ones((1, window, 1), np.float32)
    if dataset.config.state_key != "":
        dummy["state"] = np.ones((1, window, dataset.config.state_dim), np.float32)
    if flags_obj.use_text:
        dummy["instruct"] = np.zeros((1, flags_obj.data.tokenizer_max_length), np.int32)
        dummy["text_padding_mask"] = np.ones((1, flags_obj.data.tokenizer_max_length), np.float32)
    return dummy


def _on(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def _frames(tree: dict, fn, device) -> dict:
    """Each view's (B, T, H, W, C) frames through ``fn`` as one (B * T, ...) batch, in sorted key order."""
    out = {}
    for k, v in sorted(tree.items()):
        v = _on(v, device)
        b, w = v.shape[:2]
        y = fn(v.reshape(b * w, *v.shape[2:]))
        out[k] = y.reshape(b, w, *y.shape[1:])
    return out


def _aux(output) -> dict:
    return {"loss": output["loss"], "acc": output["acc"] * 100, "trans_loss": output.get("trans_loss", 0.0),
            "return_loss": output.get("return_loss", 0.0)}


def flops_analysis(fn, *args) -> float:
    """The floating-point operations of one call ``fn(*args)``: the ``cost/flops`` log entry.

    ``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls, convolutions and attention
    products PyTorch dispatches; the kernels launched through ctypes add theirs by formula
    (ops/flop_count.py), so the count is the same whether a kernel or its plain version runs.
    Elementwise work is not counted (XLA's cost analysis, which the JAX package logs, counts it).
    -1.0 when counting fails, as the JAX package returns.
    """
    try:
        from torch.utils.flop_counter import FlopCounterMode

        from ..ops.flop_count import kernel_flops

        with FlopCounterMode(display=False) as counter, kernel_flops() as kernels:
            fn(*args)
        return float(counter.get_total_flops() + kernels[0])
    except Exception:
        return -1.0


def augment_share(augment_fn, images: torch.Tensor, generator: torch.Generator, share=(0, 1)) -> torch.Tensor:
    """``augment_fn(images, generator)`` on this rank's ``share`` (index, count) of a global batch:
    the parameters are drawn for the ``count`` shares' frames, and these frames take the index-th
    share's, so they are augmented as the one-rank run augments the same rows."""
    index, count = share
    if count == 1:
        return augment_fn(images, generator)
    n = images.shape[0]
    draws = augment_fn.draw(n * count, generator)
    mine = [{k: v[index * n:(index + 1) * n] for k, v in params.items()} for params in draws]
    return augment_fn.apply(images, mine)


def rank_generator(generator: torch.Generator, index: int) -> torch.Generator:
    """A stream for this rank's own draws (dropout masks) after the shared ones: a function of the
    shared stream's state and the rank, so of (seed, step, rank)."""
    base = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(base + index)


def make_loss_fn(model, augment_fn, image_size: int, use_goal: bool, share=(0, 1)):
    """``loss_fn(model, batch, generator)``: the augmentation on the model's device inside the step
    (each view's frames, then the goals' under ``use_goal``), then the training forward, every draw
    from ``generator``.  ``model`` and ``image_size`` are the JAX signature's; the step passes the model.

    ``share`` (index, count; parallel/mesh.py::data_share): the batch is this rank's share of the
    global batch; the augmentation is drawn for the global batch (:func:`augment_share`), and the
    forward's dropout masks from :func:`rank_generator`."""
    del image_size

    def loss_fn(model, batch, generator):
        batch = dict(batch)
        if augment_fn is not None and batch.get("image") is not None:
            batch["image"] = _frames(batch["image"], lambda x: augment_share(augment_fn, x, generator, share),
                                     model.device)
            if use_goal and batch.get("goal") is not None:
                batch["goal"] = _frames(batch["goal"], lambda x: augment_share(augment_fn, x, generator, share),
                                        model.device)
        forward = generator if share[1] == 1 else rank_generator(generator, share[0])
        output = model(batch, deterministic=False, generator=forward)
        return output["loss"], _aux(output)

    return loss_fn


def make_eval_loss_fn(model, eval_transform, use_goal: bool):
    """``loss_fn(model, batch, generator)`` with the eval transform and the deterministic forward."""

    def loss_fn(model, batch, generator):
        del generator
        batch = dict(batch)
        if eval_transform is not None and batch.get("image") is not None:
            batch["image"] = _frames(batch["image"], eval_transform, model.device)
            if use_goal and batch.get("goal") is not None:
                batch["goal"] = _frames(batch["goal"], eval_transform, model.device)
        output = model(batch, deterministic=True)
        return output["loss"], _aux(output)

    return loss_fn


def _host_batch_to_arrays(batch, use_text: bool, use_goal: bool = False) -> dict:
    """Drop the entries the step does not use, so no dead bytes cross to the device."""
    out = dict(batch)
    if not use_text:
        out["instruct"] = None
        out["text_padding_mask"] = None
    if not use_goal:
        out["goal"] = None
        out.pop("goal_emb", None)
    if "image_emb" in out:
        # cached-embedding training: the frames never leave the host
        out["image"] = None
        if use_goal:
            out["goal"] = None
    return out


def _mean_metrics(metric_list, prefix: str = "") -> dict:
    """The mean of each metric over the steps, as floats (one host copy a value)."""
    def value(v):
        return float(v.detach().float().mean()) if isinstance(v, torch.Tensor) else float(np.mean(v))

    return {f"{prefix}{k}": float(np.mean([value(m[k]) for m in metric_list])) for k in metric_list[0]}


# -- rollout eval -----------------------------------------------------------------------------------

def resolve_goal_eval_data(flags_obj):
    """(eval_data_path | None, filename) for goal-conditioned eval.

    An explicit --eval_data_path wins; with --eval_with_goal the reference
    derives the eval-level dataset dir (start_level+num_levels ..
    num_levels*2, num_test_episodes*10 demos) and reads its eval file
    (main_procgen.py:342-350, :614-632).  The collect stage writes
    data_{split}.hdf5, so the filename default is data_train.hdf5,
    overridable via --eval_data_name.
    """
    eval_data_path = flags_obj.eval_data_path or None
    eval_data_name = getattr(flags_obj, "eval_data_name", "") or "data_train.hdf5"
    if (
        eval_data_path is not None
        and not getattr(flags_obj, "eval_data_name", "")
        and not os.path.exists(os.path.join(eval_data_path, eval_data_name))
        and os.path.exists(os.path.join(eval_data_path, "data.hdf5"))
    ):
        # pre-existing eval dirs may carry a plain data.hdf5
        eval_data_name = "data.hdf5"
    if eval_data_path is None and getattr(flags_obj, "eval_with_goal", False):
        from ..data.procgen_dataset import dataset_dirname

        name = dataset_dirname(
            flags_obj.game_name,
            distribution_mode=flags_obj.env_distribution_mode,
            start_level=flags_obj.env_start_level + flags_obj.env_num_levels,
            num_levels=flags_obj.env_num_levels * 2,
            num_demonstrations=flags_obj.num_test_episodes * 10,
            num_frames=flags_obj.data.num_frames,
            enable_filter=True,
            env_type=flags_obj.env_eval_env_type,
        )
        eval_data_path = os.path.join(flags_obj.data.path, name)
    return eval_data_path, eval_data_name


def build_reward_engine(flags_obj, device="cuda"):
    """(engine | None, instruction text | None) of the eval's on-the-fly rewards, as the JAX
    package's build_test_step chooses them: ``clip_ft*`` with ``--vl_checkpoint`` the fine-tuned
    adapter's engine; a ``.npz`` spec; else CLIP (``clip_ft*`` without a checkpoint falls back to
    it, with a warning).  Every engine is built with ``use_crop=False``: the rollout crops on the
    host once.  No CLIP checkpoint: a warning and no engine (the rtg stays constant)."""
    if not flags_obj.use_vl:
        return None, None
    game = (
        flags_obj.game_name
        if flags_obj.env_eval_env_type == "none"
        else f"{flags_obj.game_name}_{flags_obj.env_eval_env_type}"
    )
    if getattr(flags_obj, "eval_instruct", ""):
        # an explicit override (task-specific text for eval splits the instruction assets miss)
        text = flags_obj.eval_instruct
    elif flags_obj.data.inst_type != "none":
        text = get_clip_special_instruct(game, flags_obj.data.inst_type)
    else:
        text = get_eval_instruct(game)
    compute_dtype = torch.bfloat16 if flags_obj.reward_bf16 else torch.float32
    vl_ckpt = getattr(flags_obj, "vl_checkpoint", "") or ""
    try:
        if flags_obj.vl_type.startswith("clip_ft") and vl_ckpt:
            from ..finetune.reward import ClipFtRewardEngine, load_adapter_params

            engine = ClipFtRewardEngine(load_adapter_params(vl_ckpt), batch_size=64, use_crop=False, device=device)
        elif vl_ckpt.endswith(".npz"):
            # a self-contained engine spec (the JAX package's ClipRewardEngine.save_npz): online
            # rewards from the same tower that labeled the training data
            from ..reward.engine import ClipRewardEngine

            engine = ClipRewardEngine.from_npz(vl_ckpt, batch_size=64, resize_mode="pil", use_crop=False,
                                               compute_dtype=compute_dtype, device=device)
        else:
            from ..reward.engine import ClipRewardEngine

            if flags_obj.vl_type.startswith("clip_ft"):
                log.warning("vl_type=%s but no --vl_checkpoint given: eval rewards fall back to base CLIP and will "
                            "NOT match clip_ft training labels", flags_obj.vl_type)
            engine = ClipRewardEngine(batch_size=64, resize_mode="pil", use_crop=False, compute_dtype=compute_dtype,
                                      device=device)
    except FileNotFoundError:
        log.warning("no CLIP checkpoint for eval rewards; rtg stays constant")
        engine = None
    if engine is not None and text is None and flags_obj.vl_type in ("clip", "clip_ft"):
        # fail here with guidance instead of deep inside the rollout's tokenizer
        raise ValueError(f"no eval instruction for {game!r} (inst_type={flags_obj.data.inst_type!r}); "
                         "pass --eval_instruct")
    return engine, text


def eval_generator(seed: int, call: int, device) -> torch.Generator:
    """The temperature draws of the eval's ``call``-th policy call: a function of (seed, call) alone."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + call)


def _rank_zero_test_step(build, model):
    """The rollout eval of a train state on the mesh, as JAX's ``parallel_test_step_fn`` evaluates the
    gathered parameters: rank 0 runs the rollouts of ``build()``'s step on an unsharded model (the
    trained one under DDP; ``model``, a flat unpipelined model loaded with the gathered state, when
    fsdp shards the state, tp splits it or pp stages it) and
    broadcasts (metric, info); the other ranks take part in the gather and wait for the score."""
    import torch.distributed as dist

    from ..parallel.mesh import gather_to_host
    from ..parallel.step import is_laid_out, unwrap

    main_process = dist.get_rank() == 0
    inner = build() if main_process else None

    def test_step_fn(state, seed):
        params = [p for _, p in state.params]
        if is_laid_out(params):  # sharded, split or pipelined: gather the whole state first
            full = gather_to_host(state.model)
            target = model
            if main_process:
                with torch.no_grad():
                    model.load_trained_state_dict(full)
        else:
            target = unwrap(state.model)
        result = inner(target, seed) if main_process else None
        shared = [result[:2] if main_process else None]
        dist.broadcast_object_list(shared, src=0)
        metric, info = shared[0]
        return metric, info, result[2] if main_process else []

    return test_step_fn


def build_test_step(flags_obj, model, train_dataset, eval_transform, use_text, mesh=None, device="cuda"):
    """Rollout-eval step factory (reference create_test_step, main_procgen.py:171-229).

    Returns ``test_step_fn(state, seed) -> (metric, info, videos)``: ``state`` is a TrainState, a
    policy, or None for ``model`` (the weights evaluated are its), ``seed`` seeds the temperature
    draws.
    ``eval_transform`` gives float32 frames on ``device``, where the policy's windows and the
    reward engine (:func:`build_reward_engine`) live.  Returns None (with a loud warning) for cached-embedding
    policies: rollout eval needs live image encoding, and a ``*_cached`` model has no encoder to
    run on env frames; every caller must handle the None.  ``mesh`` (parallel/mesh.py): ``state``
    is a TrainState on it, every rank calls the step, rank 0 runs the rollouts
    (:func:`_rank_zero_test_step`; ``model`` is rank 0's unsharded model).
    """
    if mesh is not None and not flags_obj.model.transfer_type.endswith("_cached"):
        return _rank_zero_test_step(lambda: build_test_step(flags_obj, model, train_dataset, eval_transform, use_text,
                                                            device=device), model)
    if flags_obj.model.transfer_type.endswith("_cached"):
        log.warning("rollout eval disabled: transfer_type=%s consumes precomputed embeddings and cannot encode env "
                    "frames — evaluate the converted live-encoder model instead", flags_obj.model.transfer_type)
        return None
    from ..envs.fake import FakeProcgen
    from ..envs.rollout import batch_rollout, load_goal_and_state, open_goal_eval, parallel_rollout

    device = resolve_device(device)
    env_conf = {
        "episode_length": flags_obj.episode_length,
        "eval_env_type": flags_obj.env_eval_env_type,
        "distribution_mode": flags_obj.env_distribution_mode,
        "num_levels": flags_obj.env_num_levels,
        "start_level": flags_obj.env_start_level,
    }
    fake_conf = {
        "episode_length": flags_obj.episode_length,
        "hidden_goal": bool(getattr(flags_obj, "env_hidden_goal", False)),
    }

    def make_envs(k, **extra):
        if flags_obj.eval_env == "fake":
            return [FakeProcgen(flags_obj.game_name, dict(fake_conf, **extra)) for _ in range(k)]
        from ..envs.procgen import Procgen

        return [Procgen(flags_obj.game_name, dict(env_conf, **extra)) for _ in range(k)]

    instruct_info = {"instruct": None, "text_padding_mask": None}
    if use_text:
        ids, pad = train_dataset.tokenizer(get_m3ae_instruct(flags_obj.game_name) or "")
        instruct_info = {"instruct": torch.as_tensor(np.asarray(ids)[None]).to(device),
                         "text_padding_mask": torch.as_tensor(np.asarray(pad)[None]).to(device)}

    reward_engine, text = build_reward_engine(flags_obj, device)

    # 0.0 = greedy (reference parity, ARPDT.py:488-492); > 0 = seeded temperature sampling
    temperature = float(getattr(flags_obj, "eval_temperature", 0.0) or 0.0)

    def make_policy(state, seed):
        policy = model if state is None else getattr(state, "model", state)
        calls = {"n": 0}

        @torch.no_grad()
        def policy_fn(inputs, rngs):
            del rngs  # the draws come from (seed, call)
            merged = dict(inputs)
            b = merged["action"].shape[0]
            # instruct only where the caller left it unset, tiled to the env batch
            for k, v in instruct_info.items():
                if merged.get(k) is None and v is not None:
                    merged[k] = v.expand(b, *v.shape[1:])
            if temperature > 0.0:
                gen = eval_generator(seed, calls["n"], policy.device)
                calls["n"] += 1
                return policy.sample_action(merged, gen, temperature)
            return policy.greedy_action(merged)

        return policy_fn

    return_to_go = (
        getattr(train_dataset, "return_to_go", 1000.0)
        if flags_obj.return_to_go == 0
        else flags_obj.return_to_go
    )
    scale = getattr(train_dataset, "scale", 100.0)
    eval_data_path, eval_data_name = resolve_goal_eval_data(flags_obj)
    common = dict(transform_obs_fn=eval_transform, episode_length=flags_obj.episode_length,
                  window_size=flags_obj.window_size, return_to_go=return_to_go, scale=scale,
                  reward_engine=reward_engine, vl_type=flags_obj.vl_type, text=text,
                  reward_min=getattr(train_dataset, "reward_min", 0.0), use_normalize=flags_obj.data.use_normalize,
                  use_crop=flags_obj.use_crop, device=device)

    n_parallel = int(getattr(flags_obj, "eval_parallel_envs", 0) or 0)
    if n_parallel > 1:
        # N env copies step in lockstep so the policy and reward model run real batches; episodes
        # run in waves of n_parallel, and the metrics are episode-weighted means over the waves
        def parallel_test_step_fn(state, seed):
            policy = make_policy(state, seed)
            total = flags_obj.num_test_episodes
            eval_hdf5 = traj_idx = None
            if eval_data_path is not None:
                eval_hdf5, traj_idx = open_goal_eval(eval_data_path, eval_data_name, total)
            metrics, weights = [], []
            try:
                for wave_start in range(0, total, n_parallel):
                    eps = list(range(wave_start, min(wave_start + n_parallel, total)))
                    goals = states = None
                    if eval_hdf5 is not None:
                        pairs = [load_goal_and_state(eval_data_path, eval_hdf5, traj_idx, ep) for ep in eps]
                        states = [s for _, s in pairs]
                        # goal-swap sensitivity probe: episode ep's initial state with episode
                        # (ep + shift)'s goal frame
                        shift = int(getattr(flags_obj, "eval_goal_shift", 0) or 0)
                        if shift:
                            goals = np.stack([
                                load_goal_and_state(eval_data_path, eval_hdf5, traj_idx, (ep + shift) % total)[0]
                                for ep in eps
                            ])
                        else:
                            goals = np.stack([g for g, _ in pairs])
                    # record_video off: parallel_rollout returns no videos
                    m = parallel_rollout(rng=seed, envs=make_envs(len(eps), record_video=False), policy_fn=policy,
                                         goal_images=goals, initial_states=states,
                                         feed_goal_to_policy=eval_hdf5 is not None, seed_offset=wave_start, **common)
                    metrics.append(m)
                    weights.append(len(eps))
            finally:
                if eval_hdf5 is not None:
                    eval_hdf5.close()
            if not metrics:  # num_test_episodes == 0: degrade like a skipped eval
                nan = np.float32("nan")
                return {"return": nan, "episode_length": nan, "success_rate": nan}, {"episode_len": 0.0}, []
            wsum = sum(weights)
            metric = {k: np.float32(sum(float(m[k]) * w for m, w in zip(metrics, weights)) / wsum) for k in metrics[0]}
            return metric, {"episode_len": float(metric["episode_length"])}, []

        return parallel_test_step_fn

    (environment,) = make_envs(1)

    def test_step_fn(state, seed):
        return batch_rollout(rng=seed, data_aug_rng=seed, env=environment, policy_fn=make_policy(state, seed),
                             num_episodes=flags_obj.num_test_episodes, eval_data_path=eval_data_path,
                             data_name=eval_data_name, **common)

    return test_step_fn
