"""Pipeline parallelism: GPipe microbatching over the mesh's pp axis (port of arp_tpu/parallel/pipeline.py).

JAX runs the stages inside ``shard_map`` and moves the activations with
``lax.ppermute`` in a ``lax.scan`` of M + S - 1 ticks.  The port runs one
process a stage and moves them with point-to-point sends over the pp group:

  * forward: stage 0 feeds microbatch m at tick m; stage s receives microbatch
    m from stage s - 1, runs its blocks on it and sends the result to stage
    s + 1, so M microbatches cross S stages in M + S - 1 ticks; the last
    stage's outputs are then broadcast over the pp group, as JAX's ``psum`` of
    the masked outputs gives them to every pp rank;
  * backward (:class:`_Pipeline`, a ``torch.autograd.Function``): the ticks in
    reverse.  Every pp rank computes the same heads and loss on the same
    outputs, so the outputs' cotangent is taken once, the last stage's
    (:func:`_output_cotangent`), never summed over pp; the input's gradient
    from stage 0 is broadcast over pp, so a parameter that every pp rank holds
    (the embeddings, the heads, the final norm) gets the same gradient
    everywhere and stays equal;
  * a stage's parameters accumulate their gradients in ``.grad`` over the
    microbatches, inside the function's backward; the train step averages them
    over the data ranks itself (parallel/step.py::average_train_state), as no
    data-parallel wrapper sees them.

Under gloo the transport copies through host memory: gloo's ``send`` of a
CUDA tensor fails ("writev ... Bad address"; chip_smoke's ``mesh_tp_pp``
phase asks it on every run), and the broadcast goes the same way.  NCCL moves
device tensors.  The compute stays on the device either way.

With dp or fsdp above 1 every rank pipelines its own data share's rows.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import host_backend


def create_pp_mesh(num_stages: int, device="cuda"):
    """A 1-D pp ``DeviceMesh`` over the first ``num_stages`` ranks of the world (tests, demos); the trainer
    composes pp with dp / fsdp through parallel/mesh.py::create_mesh instead."""
    from torch.distributed.device_mesh import DeviceMesh

    if dist.get_world_size() < num_stages:
        raise ValueError(f"{num_stages} stages need {num_stages} ranks, the world has {dist.get_world_size()}")
    device_type = "cuda" if torch.device(device).type == "cuda" else "cpu"
    return DeviceMesh(device_type, torch.arange(num_stages), mesh_dim_names=("pp",))


class _Transport:
    """Point-to-point sends and receives and the broadcast over the pp group (gloo: through host memory)."""

    def __init__(self, group):
        self.group, self.host = group, host_backend(group)
        self.ranks = dist.get_process_group_ranks(group)
        self.pending = []

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous()
        return t.cpu() if self.host else t

    def send(self, t: torch.Tensor, stage: int) -> None:
        buf = self._wire(t)
        self.pending.append((dist.isend(buf, self.ranks[stage], group=self.group), buf))

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if self.host else like.device)
        dist.recv(buf, self.ranks[stage], group=self.group)
        return buf.to(like.device)

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        buf = t.detach().contiguous().clone()
        buf = buf.cpu() if self.host else buf
        dist.broadcast(buf, self.ranks[stage], group=self.group)
        return buf.to(t.device)

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()


def _output_cotangent(grad: torch.Tensor, group) -> torch.Tensor:
    """The outputs' cotangent the last stage pipelines back: its own.  Every pp rank holds the same one
    (same heads, same loss), so a sum over pp would count it once a stage."""
    del group
    return grad


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, num_microbatches, remat, x, *params):
        transport = _Transport(group)
        s, S = dist.get_rank(group), dist.get_world_size(group)
        xs = x.reshape(num_microbatches, -1, *x.shape[1:]).unbind(0)
        grads_needed = any(ctx.needs_input_grad[4:])
        saved, outputs = [], []
        for m in range(num_microbatches):
            inp = xs[m] if s == 0 else transport.recv(xs[m], s - 1)
            if grads_needed and not remat:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = stage_fn(inp)
                saved.append((inp, out))
            else:
                out = stage_fn(inp)
                saved.append((inp.detach(), None))
            if s < S - 1:
                transport.send(out, s + 1)
            else:
                outputs.append(out.detach())
        transport.wait()
        y = torch.cat(outputs) if s == S - 1 else torch.empty_like(x)
        y = transport.broadcast(y, S - 1)
        ctx.stage_fn, ctx.group, ctx.remat, ctx.saved = stage_fn, group, remat, saved
        ctx.stage_params, ctx.x_like = params, x.detach()
        return y

    @staticmethod
    def backward(ctx, grad_y):
        transport = _Transport(ctx.group)
        s, S = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        wanted = [p for p, n in zip(ctx.stage_params, ctx.needs_input_grad[5:]) if n]
        M = len(ctx.saved)
        cotangent = _output_cotangent(grad_y, ctx.group).reshape(M, -1, *grad_y.shape[1:]).unbind(0)
        grad_x = [None] * M
        for m in reversed(range(M)):
            inp, out = ctx.saved[m]
            g = cotangent[m] if s == S - 1 else transport.recv(cotangent[m], s + 1)
            if out is None:  # remat: the stage again, this time recorded
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = ctx.stage_fn(inp)
            # the stage's parameters accumulate their gradient over the microbatches in .grad
            torch.autograd.backward(out, g, inputs=[inp] + wanted)
            gi = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if s > 0:
                transport.send(gi, s - 1)
            else:
                grad_x[m] = gi
        transport.wait()
        ctx.saved = None
        gx = torch.cat(grad_x) if s == 0 else torch.zeros_like(ctx.x_like)
        gx = transport.broadcast(gx.reshape(ctx.x_like.shape), 0)
        return (None, None, None, None, gx) + (None,) * len(ctx.stage_params)


def pipeline_apply(stage_fn: Callable, stage_params: list, x: torch.Tensor, mesh, num_microbatches: int,
                   remat: bool = False) -> torch.Tensor:
    """Run ``x`` through the S stages of ``mesh``'s pp axis; returns what applying them one after another
    gives, on every pp rank.

    ``stage_fn(activation) -> activation`` runs this rank's stage; ``stage_params`` are the trained
    tensors it reads (their gradients come out of the pipeline); ``x`` (batch, ...) splits into
    ``num_microbatches`` contiguous microbatches, which the batch must divide.  ``remat`` keeps only
    each microbatch's input and runs the stage again on the backward pass.
    """
    pp = mesh["pp"]
    if x.shape[0] % num_microbatches:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {num_microbatches} microbatches")
    if pp.size() == 1:
        return stage_fn(x)
    return _Pipeline.apply(stage_fn, pp.get_group(), num_microbatches, remat, x, *stage_params)


def sequential_apply(stage_fn: Callable, stage_params: list, x: torch.Tensor) -> torch.Tensor:
    """Reference semantics: ``stage_fn(stage_params[s], x)`` for s = 0 .. S - 1, one after another."""
    for params in stage_params:
        x = stage_fn(params, x)
    return x
