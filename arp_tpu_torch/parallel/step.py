"""Train and eval steps, on one device or over the data mesh (port of arp_tpu/parallel/step.py).

``loss_fn(model, batch, generator) -> (loss, aux)`` stands in for JAX's pure
``loss_fn(params, batch, rng)``: the model holds the parameters, and every
random draw of the step (augmentation parameters, dropout masks) comes from
the ``torch.Generator`` the caller passes.  :class:`TrainState` is Flax's
``TrainState``: the model, the optimizer's state and the step count; the
step updates it in place (JAX donates it) and returns it.

Gradient accumulation follows JAX's ``lax.scan``: microbatch ``i`` is the
contiguous chunk ``x.reshape(accum_steps, -1, ...)[i]`` of every batch leaf,
draws from a generator of its own, and the gradients and aux values are
summed over the microbatches, then multiplied by ``1 / accum_steps``.

Over several processes (parallel/mesh.py) :func:`shard_train_state` lays the
state out, as JAX's ``shard_train_state`` commits it to the mesh: first the tp
split of the attention and MLP layers (parallel/tensor_parallel.py; a pipelined
model holds its pp stage from construction), then over the data axes: with fsdp
1 in ``DistributedDataParallel`` over dp (the gradients averaged over the data
ranks), with fsdp above 1 in FSDP2's ``fully_shard`` over the (dp, fsdp) mesh,
block by block (the trained parameters and the AdamW moments sharded over fsdp,
replicated over dp).  Each rank's loss is the mean over its share of the global
batch, so the averaged gradient is the global batch's, as JAX's GSPMD step
computes it; the step averages the aux values over the data ranks too, so the
logged ``loss`` and ``acc`` are the global batch's.  The tp and pp ranks of one
data share compute the same loss, and their gradients are never averaged with
each other.  Under ``accum_steps > 1`` the gradients are exchanged once, after
the last microbatch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from torch.nn.parameter import UninitializedParameter

from ..profiling import span


def trainable_parameters(model: torch.nn.Module) -> list:
    """(name, parameter) of every parameter the optimizer updates: those with ``requires_grad``
    whose lazy shape is known.  A lazy layer that never ran has no parameters, as a Flax module
    that ``init`` never called has none; so the model must have run one forward first."""
    if getattr(model, "needs_first_forward", False):
        raise RuntimeError(
            "the model has not run a forward yet: its lazy input layers and adapter take their shapes at the "
            "first forward (get_dummy_input), as Flax's init does; an optimizer built before would not train them"
        )
    return [(n, p) for n, p in model.named_parameters()
            if p.requires_grad and not isinstance(p, UninitializedParameter)]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _whole_sum(terms: list) -> torch.Tensor:
    """The sum of 0-dim terms, fsdp-sharded ones (``DTensor`` s) added over their ranks (differentiably)."""
    sharded = [t for t in terms if _is_dtensor(t)]
    if not sharded:
        return torch.stack(terms).sum()
    total = torch.stack(sharded).sum().full_tensor()
    plain = [t for t in terms if not _is_dtensor(t)]
    return total + torch.stack(plain).sum() if plain else total


def l2_weight_penalty(params) -> torch.Tensor:
    """sum ||W||^2 over the parameters of rank > 1 (the reference's main_procgen.py:114-117);
    ``params``: (name, tensor) pairs.  A parameter counts whole in every layout, as the flat model's:
    fsdp shards' sums are added over the data ranks, tp shares' and pp stages' over their axis
    (forward only: each rank's share takes its own gradient)."""
    from .mesh import split_of
    from .tensor_parallel import ReduceFromTP

    groups = {}
    for _, p in params:
        if p.ndim > 1:
            split = split_of(p)
            groups.setdefault(None if split is None else split.group, []).append(torch.sum(p.float() ** 2))
    if not groups:
        return torch.zeros(())
    total = None
    for group, terms in groups.items():
        part = _whole_sum(terms)
        if group is not None:
            part = ReduceFromTP.apply(part, group)
        total = part if total is None else total + part
    return total


class TrainState:
    """The model, its trained parameters, the optimizer's state and the step (Flax's TrainState).

    After :func:`shard_train_state`, ``model`` is the wrapped model the step calls and ``synced``
    the indices of the trained parameters FSDP2 leaves out (scalars), whose gradients the step
    averages itself."""

    def __init__(self, model, tx, params, opt_state, step: int = 0):
        self.model, self.tx, self.params, self.opt_state, self.step = model, tx, params, opt_state, step
        self.synced = []

    @classmethod
    def create(cls, model, tx) -> "TrainState":
        params = trainable_parameters(model)
        return cls(model, tx, params, tx.init([p for _, p in params]))

    def apply_gradients(self, grads) -> "TrainState":
        self.opt_state = self.tx.update([p for _, p in self.params], grads, self.opt_state)
        self.step += 1
        return self


def _microbatch(tree, i: int, n: int):
    if isinstance(tree, dict):
        return {k: _microbatch(v, i, n) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.reshape(n, -1, *tree.shape[1:])[i]


def _scalar(v) -> torch.Tensor:
    return v.detach().float() if isinstance(v, torch.Tensor) else torch.tensor(float(v))


class DistributedModel(DistributedDataParallel):
    """``DistributedDataParallel`` whose other attributes are the wrapped model's (``device``,
    ``trained_state_dict``, ``greedy_action``...), so the code around the step sees the model."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.module, name)


def unwrap(model):
    """The model inside a ``DistributedModel``; any other model as it is."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def shard_train_state(state: "TrainState", mesh, *, find_unused_parameters: bool = False) -> "TrainState":
    """Put ``state`` on the mesh (parallel/mesh.py); None leaves it as it is.

    tp above 1: :func:`split_tensor_parallel` first.  Then fsdp 1: :func:`replicate_train_state`
    (DistributedDataParallel over dp), or under pp :func:`average_train_state` (the pipeline's own autograd
    function carries a stage's gradients, past DDP's hooks); fsdp above 1: :func:`fully_shard_train_state`
    (FSDP2 over the (dp, fsdp) mesh).  ``find_unused_parameters``: a loss that does not reach every trained parameter
    (the fine-tuning adapter without text) needs it under the DDP wrapper.  The model must have run its
    first forward: its lazy layers take their shapes there.
    """
    if mesh is None:
        return state
    if mesh["tp"].size() > 1:
        state = split_tensor_parallel(state, mesh)
    if mesh["fsdp"].size() > 1:
        return fully_shard_train_state(state, mesh)
    if mesh["pp"].size() > 1:
        return average_train_state(state, mesh)
    return replicate_train_state(state, mesh, find_unused_parameters=find_unused_parameters)


def _trained_names(state: "TrainState", module) -> list:
    names = [n for n, _ in trainable_parameters(module)]
    if names != [n for n, _ in state.params]:
        raise RuntimeError("the state's parameters are not the model's trained parameters")
    return names


def split_tensor_parallel(state: "TrainState", mesh) -> "TrainState":
    """The tp split of the state's model in place (parallel/tensor_parallel.py): every rank starts from
    rank 0's full parameters, keeps its share of each split one, and its share of their moments."""
    from .mesh import distribute_like
    from .tensor_parallel import apply_tensor_parallel

    module = unwrap(state.model)
    names = _trained_names(state, module)
    with torch.no_grad():
        for _, p in state.params:
            dist.broadcast(p, src=0)
    apply_tensor_parallel(module, mesh)
    params = trainable_parameters(module)
    if [n for n, _ in params] != names:
        raise RuntimeError("the tp split changed the order of the trained parameters")
    opt = state.opt_state
    if hasattr(opt, "mu") and opt.mu:
        state.opt_state = type(opt)(opt.count, [distribute_like(m, p).clone() for m, (_, p) in zip(opt.mu, params)],
                                    [distribute_like(v, p).clone() for v, (_, p) in zip(opt.nu, params)])
    state.params = params
    return state


def average_train_state(state: "TrainState", mesh) -> "TrainState":
    """The state left unwrapped, every rank of a data group starting from its first rank's parameters; the
    step averages every gradient over the data ranks itself (``state.synced``)."""
    from .mesh import broadcast_over_data

    _trained_names(state, unwrap(state.model))
    with torch.no_grad():
        for _, p in state.params:
            broadcast_over_data(p, mesh)
    state.synced = list(range(len(state.params)))
    return state


def replicate_train_state(state: "TrainState", mesh, *, find_unused_parameters: bool = False) -> "TrainState":
    """The model wrapped in :class:`DistributedModel` over the mesh's dp group: parameters and
    moments replicated, the wrapper broadcasting rank 0's parameters once and averaging the
    gradients in the backward."""
    module = unwrap(state.model)
    _trained_names(state, module)
    # the wrapper syncs and reduces the trained parameters only: lazy layers that never ran, the
    # frozen tower and the buffers are alike on every rank by construction
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        module, [n for n, p in module.named_parameters()
                 if isinstance(p, UninitializedParameter) or not p.requires_grad]
        + [n for n, _ in module.named_buffers()])
    dev = next(p for _, p in state.params).device
    state.model = DistributedModel(module, device_ids=[dev.index] if dev.type == "cuda" else None,
                                   process_group=mesh["dp"].get_group(), broadcast_buffers=False,
                                   find_unused_parameters=find_unused_parameters)
    return state


def fully_shard_train_state(state: "TrainState", mesh) -> "TrainState":
    """FSDP2's ``fully_shard`` over the (dp, fsdp) mesh, which replicates over dp and shards over
    fsdp: each transformer block (layers.Block) that holds trained parameters is a unit of its own,
    gathered for its forward and backward and sharded again after them, and the root holds the rest.
    The trained parameters become ``DTensor`` s and the AdamW moments are cut the same way.  The
    frozen parameters and the scalars (which ``fully_shard`` refuses) stay whole on every rank; the
    step averages the scalars' gradients itself.  Every rank starts from rank 0's parameters."""
    from torch.distributed.fsdp import fully_shard

    from ..models.layers import Block
    from .mesh import broadcast_over_data, data_mesh, distribute_like, split_of

    module = unwrap(state.model)
    names = _trained_names(state, module)
    # a pp stage's blocks stay whole over the data ranks, as JAX shards stacked_blocks over pp only
    ignored = {p for p in module.parameters()
               if isinstance(p, UninitializedParameter) or not p.requires_grad or p.ndim == 0
               or (split_of(p) is not None and split_of(p).axis == "pp")}
    with torch.no_grad():
        for _, p in state.params:
            broadcast_over_data(p, mesh)
    splits = {n: split_of(p) for n, p in state.params}
    for block in module.modules():
        if isinstance(block, Block) and any(p not in ignored for p in block.parameters()):
            fully_shard(block, mesh=data_mesh(mesh), ignored_params=ignored)
    fully_shard(module, mesh=data_mesh(mesh), ignored_params=ignored)
    params = trainable_parameters(module)
    if [n for n, _ in params] != names:
        raise RuntimeError("fully_shard changed the order of the trained parameters")
    for n, p in params:  # FSDP2's parameters are new tensors: they carry the tp / pp layout on
        if splits[n] is not None:
            p.mesh_split = splits[n]
    opt = state.opt_state
    if hasattr(opt, "mu"):
        state.opt_state = type(opt)(opt.count, [distribute_like(m, p) for m, (_, p) in zip(opt.mu, params)],
                                    [distribute_like(v, p) for v, (_, p) in zip(opt.nu, params)])
    state.params = params
    state.synced = [i for i, (_, p) in enumerate(params) if not _is_dtensor(p)]
    state.model = module
    return state


def mean_over_ranks(values: dict, mesh) -> dict:
    """Each 0-dim tensor of ``values`` averaged over the data ranks of ``mesh`` (the tp and pp ranks of
    a data share hold the same values)."""
    from .mesh import data_size, sum_over_data

    if mesh is None or not values:
        return values
    keys = list(values)
    device = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    packed = torch.stack([values[k].to(device, torch.float32) for k in keys])
    packed = sum_over_data(packed, mesh) / data_size(mesh)
    return dict(zip(keys, packed.unbind(0)))


def _average_plain_gradients(grads: list, indices: list, mesh) -> None:
    """The gradients at ``indices`` (parameters FSDP2 left whole) averaged over the data ranks, in place."""
    from .mesh import data_size, sum_over_data

    if not indices:
        return
    flat = torch.cat([grads[i].reshape(-1) for i in indices])
    flat = sum_over_data(flat, mesh) / data_size(mesh)
    for i, piece in zip(indices, flat.split([grads[i].numel() for i in indices])):
        grads[i] = piece.view_as(grads[i])


def _gradient_sync(model, on: bool):
    """A context in which ``model``'s backward exchanges gradients only when ``on``."""
    if isinstance(model, DistributedDataParallel):
        return contextlib.nullcontext() if on else model.no_sync()
    if hasattr(model, "set_requires_gradient_sync"):  # FSDP2
        model.set_requires_gradient_sync(on)
    return contextlib.nullcontext()


def make_train_step(loss_fn: Callable, *, mesh=None, weight_decay: float = 0.0,
                    learning_rate_fn: Optional[Callable] = None, accum_steps: int = 1):
    """``step(state, batch, generator) -> (state, aux)``: one optimizer step.

    ``weight_decay > 0`` adds ``weight_decay * 0.5 * l2_weight_penalty`` to the loss (the
    reference's explicit penalty, on top of AdamW's decoupled decay).  ``aux`` holds the loss
    function's values (``loss`` with the penalty), ``weight_penalty`` and ``weight_l2`` with a
    penalty, ``train_state_step`` (the step before the update) and, given the schedule,
    ``learning_rate`` at it: 0-dim tensors left on the device, and two numbers.  ``mesh`` (the
    state's, :func:`shard_train_state`): the tensors are averaged over the ranks.  Every rank
    passes a generator seeded alike: the draws of the step are the same on every rank.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_with_penalty(state, batch, generator):
        loss, aux = loss_fn(state.model, batch, generator)
        aux = dict(aux)
        if weight_decay > 0.0:
            weight_l2 = l2_weight_penalty(state.params)
            penalty = weight_decay * 0.5 * weight_l2
            loss = loss + penalty
            aux.update(weight_penalty=penalty, weight_l2=weight_l2)
        aux["loss"] = loss
        return loss, aux

    def accumulate(state, batch, generator):
        for _, p in state.params:
            p.grad = None
        if accum_steps == 1:
            with span("train.forward"):
                loss, aux = loss_with_penalty(state, batch, generator)
            with span("train.backward"):
                loss.backward()
                aux = {k: _scalar(v) for k, v in aux.items()}
        else:
            base = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
            aux = None
            for i in range(accum_steps):
                own = torch.Generator(device=generator.device).manual_seed(base + i)
                with _gradient_sync(state.model, i == accum_steps - 1):
                    with span("train.forward"):
                        loss, mb_aux = loss_with_penalty(state, _microbatch(batch, i, accum_steps), own)
                    with span("train.backward"):
                        loss.backward()
                mb_aux = {k: _scalar(v) for k, v in mb_aux.items()}
                aux = mb_aux if aux is None else {k: aux[k] + mb_aux[k] for k in aux}
            aux = {k: v * (1.0 / accum_steps) for k, v in aux.items()}
        grads = []
        for _, p in state.params:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads.append(g if accum_steps == 1 else g * (1.0 / accum_steps))
            p.grad = None
        if mesh is not None:
            _average_plain_gradients(grads, state.synced, mesh)
            aux = mean_over_ranks(aux, mesh)
        return grads, aux

    def train_step(state, batch, generator):
        step = state.step
        with span("train.step"):
            grads, aux = accumulate(state, batch, generator)
            with span("train.update"):
                state.apply_gradients(grads)
        aux["train_state_step"] = step
        if learning_rate_fn is not None:
            aux["learning_rate"] = float(learning_rate_fn(step))
        return state, aux

    # (grads, aux) of the step without the update: the state is left as it was (flops_analysis counts this)
    train_step.gradients = accumulate
    return train_step


def make_eval_step(loss_fn: Callable, mesh=None):
    """``step(state, batch, generator) -> aux``, without gradients; ``mesh``: the values averaged
    over the ranks."""

    def eval_step(state, batch, generator):
        with torch.no_grad():
            _, aux = loss_fn(state.model, batch, generator)
        return mean_over_ranks({k: _scalar(v) for k, v in aux.items()}, mesh)

    return eval_step


def local_part(t):
    """A ``DTensor``'s shard on this rank (sharing its storage); any other tensor as it is."""
    return t.to_local() if _is_dtensor(t) else t


def is_laid_out(tensors) -> bool:
    """True when some tensor is not whole on this rank: an fsdp shard, a tp share or a pp stage."""
    from .mesh import split_of

    return any(_is_dtensor(t) or split_of(t) is not None for t in tensors)


def tree_finite(tensors) -> bool:
    """True when every floating tensor is finite (one reduction; a NaN or inf propagates into it).
    Laid-out tensors are judged whole: the sums are added over the ranks, so every rank answers alike."""
    tensors = [t for t in tensors if t.is_floating_point()]
    if not tensors:
        return True
    total = torch.stack([local_part(t).detach().float().abs().sum() for t in tensors]).sum()
    if is_laid_out(tensors):
        dist.all_reduce(total)
    return bool(np.isfinite(float(total)))
