"""Train and eval steps on one device (port of the one-device half of arp_tpu/parallel/step.py).

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

Not ported: ``state_shardings`` and ``shard_train_state`` (several devices).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter


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


def l2_weight_penalty(params) -> torch.Tensor:
    """sum ||W||^2 over the parameters of rank > 1 (the reference's main_procgen.py:114-117);
    ``params``: (name, tensor) pairs."""
    terms = [torch.sum(p.float() ** 2) for _, p in params if p.ndim > 1]
    return torch.stack(terms).sum() if terms else torch.zeros(())


class TrainState:
    """The model, its trained parameters, the optimizer's state and the step (Flax's TrainState)."""

    def __init__(self, model, tx, params, opt_state, step: int = 0):
        self.model, self.tx, self.params, self.opt_state, self.step = model, tx, params, opt_state, step

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


def make_train_step(loss_fn: Callable, *, weight_decay: float = 0.0, learning_rate_fn: Optional[Callable] = None,
                    accum_steps: int = 1):
    """``step(state, batch, generator) -> (state, aux)``: one optimizer step.

    ``weight_decay > 0`` adds ``weight_decay * 0.5 * l2_weight_penalty`` to the loss (the
    reference's explicit penalty, on top of AdamW's decoupled decay).  ``aux`` holds the loss
    function's values (``loss`` with the penalty), ``weight_penalty`` and ``weight_l2`` with a
    penalty, ``train_state_step`` (the step before the update) and, given the schedule,
    ``learning_rate`` at it: 0-dim tensors left on the device, and two numbers.
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
            loss, aux = loss_with_penalty(state, batch, generator)
            loss.backward()
            aux = {k: _scalar(v) for k, v in aux.items()}
        else:
            base = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
            aux = None
            for i in range(accum_steps):
                own = torch.Generator(device=generator.device).manual_seed(base + i)
                loss, mb_aux = loss_with_penalty(state, _microbatch(batch, i, accum_steps), own)
                loss.backward()
                mb_aux = {k: _scalar(v) for k, v in mb_aux.items()}
                aux = mb_aux if aux is None else {k: aux[k] + mb_aux[k] for k in aux}
            aux = {k: v * (1.0 / accum_steps) for k, v in aux.items()}
        grads = []
        for _, p in state.params:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads.append(g if accum_steps == 1 else g * (1.0 / accum_steps))
            p.grad = None
        return grads, aux

    def train_step(state, batch, generator):
        grads, aux = accumulate(state, batch, generator)
        step = state.step
        state.apply_gradients(grads)
        aux["train_state_step"] = step
        if learning_rate_fn is not None:
            aux["learning_rate"] = float(learning_rate_fn(step))
        return state, aux

    # (grads, aux) of the step without the update: the state is left as it was (flops_analysis counts this)
    train_step.gradients = accumulate
    return train_step


def make_eval_step(loss_fn: Callable):
    """``step(state, batch, generator) -> aux``, without gradients."""

    def eval_step(state, batch, generator):
        with torch.no_grad():
            _, aux = loss_fn(state.model, batch, generator)
        return {k: _scalar(v) for k, v in aux.items()}

    return eval_step


def tree_finite(tensors) -> bool:
    """True when every floating tensor is finite (one reduction; a NaN or inf propagates into it)."""
    sums = [t.detach().float().abs().sum() for t in tensors if t.is_floating_point()]
    return bool(np.isfinite(float(torch.stack(sums).sum()))) if sums else True
