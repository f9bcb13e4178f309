"""Tensor parallelism over the mesh's ``tp`` axis (the tp half of arp_tpu/parallel/mesh.py).

JAX places the attention and MLP kernels by name (``partition_params``) and
GSPMD inserts the collectives.  The port runs Megatron's layout by hand:

  * column-parallel ``qkv`` and ``fc1``: each tp rank holds the output columns
    of its share: ``fc1``'s hidden units, and the q, k and v columns of *its
    own heads* (the fused ``(in, 3 * dim)`` kernel cut on the heads of its
    ``(in, 3, dim)`` view, not contiguously), with their biases;
  * row-parallel ``attn_out`` and ``fc2``: each rank holds the input rows of
    its share; the partial products are summed over the ranks, and the bias,
    replicated, is added once after the sum;
  * the two conjugate functions around them (:class:`CopyToTP`: identity
    forward, all-reduce backward, before a column-parallel layer;
    :class:`ReduceFromTP`: all-reduce forward, identity backward, after a
    row-parallel one), so every parameter outside the split layers gets the
    same gradient on every tp rank.

``Attention`` then runs ``num_heads / tp`` heads a rank (kernel K1 at that
shape on CUDA), ``FeedForward`` ``hidden / tp`` units.  A module the rules do
not split (a dim tp does not divide, heads tp does not divide, a CLIP tower's
separate q / k / v) stays replicated: every tp rank computes it whole, as
GSPMD keeps such a leaf whole.  Frozen towers are never split.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Split, partition_params


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward; the gradient summed over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the partial results summed over the tp group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: Optional[Split]) -> torch.Tensor:
    return x if tp is None else CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: Optional[Split]) -> torch.Tensor:
    return x if tp is None else ReduceFromTP.apply(x, tp.group)


def row_parallel(x: torch.Tensor, linear: torch.nn.Linear, dtype: Optional[torch.dtype], tp: Split) -> torch.Tensor:
    """Flax ``Dense(dtype)`` of a row-parallel layer: this rank's input rows times its weight share,
    summed over the tp group, then the bias once."""
    dt = dtype or torch.promote_types(x.dtype, linear.weight.dtype)
    y = reduce_from_tp(F.linear(x.to(dt), linear.weight.to(dt)), tp)
    return y if linear.bias is None else y + linear.bias.to(dt)


def _replace(owner: torch.nn.Module, leaf: str, split: Split) -> None:
    old = getattr(owner, leaf)
    new = torch.nn.Parameter(split.cut(old.detach()).clone(), requires_grad=old.requires_grad)
    new.mesh_split = split
    setattr(owner, leaf, new)


def apply_tensor_parallel(module: torch.nn.Module, mesh) -> list:
    """Split ``module``'s trained attention and MLP layers over ``mesh``'s tp axis in place, where
    :func:`partition_params` puts their kernels on tp; returns the names of the split modules.
    Every rank must hold the same full parameters before (each keeps its share)."""
    from ..models.layers import Attention, FeedForward

    tp = mesh["tp"]
    size = tp.size()
    if size == 1:
        return []
    group, rank = tp.get_group(), tp.get_local_rank()
    specs = partition_params(module, mesh)

    def on_tp(name: str) -> bool:
        return "tp" in specs.get(name, ())

    done = []
    for name, sub in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(sub, Attention) and sub.tp is None:
            if not (on_tp(prefix + "qkv.kernel") and on_tp(prefix + "attn_out.weight") and sub.num_heads % size == 0):
                continue
            col = Split("tp", group, size, rank, qkv=True)
            _replace(sub.qkv, "kernel", col)
            if sub.qkv.bias is not None:
                _replace(sub.qkv, "bias", col)
            _replace(sub.attn_out, "weight", Split("tp", group, size, rank, dim=1))
        elif isinstance(sub, FeedForward) and sub.tp is None:
            if not (on_tp(prefix + "fc1.weight") and on_tp(prefix + "fc2.weight")):
                continue
            col = Split("tp", group, size, rank, dim=0)
            _replace(sub.fc1, "weight", col)
            if sub.fc1.bias is not None:
                _replace(sub.fc1, "bias", col)
            _replace(sub.fc2, "weight", Split("tp", group, size, rank, dim=1))
        else:
            continue
        sub.tp = col  # the module's tp share: its group, size and rank
        done.append(name)
    return done
