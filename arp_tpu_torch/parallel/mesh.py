"""The data mesh over processes (port of the data axes of arp_tpu/parallel/mesh.py).

JAX's mesh names four axes over devices; the port runs one process a GPU
(parallel/distributed.py) and builds the data axes ``dp`` and ``fsdp`` as a
``torch.distributed`` ``DeviceMesh`` of shape (dp, fsdp) over the ranks:

  * ``dp``   — data parallelism: the state replicated, the gradients averaged
               (``DistributedDataParallel``, or FSDP2's replicated dimension);
  * ``fsdp`` — fully sharded data parallelism: the trained parameters and the
               AdamW moments sharded (FSDP2's ``fully_shard``), replicated over dp;
  * ``dcn_dp`` folds into dp as its outermost factor, as in JAX: torchrun's
    ranks are node-major, so contiguous rank groups are nodes and only the
    outermost dp stride crosses nodes.

Rank r of N is JAX's process r of N with one device.  The batch's rows are
split over both axes: rank ``dp_index * fsdp + fsdp_index`` holds share r of N.

``tp`` and ``pp`` above 1 raise (ROADMAP Queue 1, item 12c); so does
``mesh_from_count``'s single-process local-device mesh (item 12b), which is not
here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import process_count

DATA_AXES = ("dp", "fsdp")

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: use all remaining devices
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    # data parallelism across nodes: dp becomes dcn_dp x (per-node dp), the node factor outermost
    dcn_dp: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> tuple[int, int, int, int]:
        n = n_devices if n_devices is not None else process_count()
        dp, fsdp, tp, pp = self.dp, self.fsdp, self.tp, self.pp
        if pp > 1:
            assert tp == 1, "pp composes with dp/fsdp; tp inside pp stages is unsupported"
        if dp == -1:
            rest = fsdp * tp * pp * self.dcn_dp
            assert n % rest == 0, f"{n} devices not divisible by dcn_dp*fsdp*tp*pp={rest}"
            dp = n // rest
        dp = dp * self.dcn_dp
        assert dp * fsdp * tp * pp == n, f"mesh {dp}x{fsdp}x{tp}x{pp} != {n} devices"
        return dp, fsdp, tp, pp


def node_count() -> int:
    """The number of nodes in the world: ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (torchrun's), else 1."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return max(1, process_count() // local) if local else 1


def create_mesh(config: MeshConfig = MeshConfig(), device="cuda"):
    """The (dp, fsdp) ``DeviceMesh`` over the world, or None for one process outside a process group
    (the trainers then run their step unwrapped)."""
    dp, fsdp, tp, pp = config.resolve()
    if tp > 1 or pp > 1:
        raise NotImplementedError(f"mesh tp={tp} pp={pp}: tensor and pipeline parallelism are not ported yet "
                                  "(ROADMAP Queue 1, item 12c)")
    if config.dcn_dp > 1:
        nodes = node_count()
        if nodes == 1:
            log.warning("mesh: one node; emulating dcn_dp=%d with contiguous rank groups. On several nodes "
                        "this layout puts the outermost dp stride between nodes — do not ignore this warning there.",
                        config.dcn_dp)
        elif nodes != config.dcn_dp:
            raise ValueError(f"dcn_dp={config.dcn_dp} but the world spans {nodes} nodes "
                             f"(WORLD_SIZE / LOCAL_WORLD_SIZE): the dp strides would cross nodes")
        else:
            log.info("mesh: dcn_dp=%d nodes x per-node dp %d, fsdp %d", config.dcn_dp, dp // config.dcn_dp, fsdp)
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if torch.device(device).type == "cuda" else "cpu"
    return init_device_mesh(device_type, (dp, fsdp), mesh_dim_names=DATA_AXES)


def data_share(mesh) -> tuple[int, int]:
    """(this rank's share, the number of shares) of a batch on ``mesh``; (0, 1) without one."""
    if mesh is None:
        return 0, 1
    fsdp = mesh["fsdp"].size()
    return mesh["dp"].get_local_rank() * fsdp + mesh["fsdp"].get_local_rank(), mesh["dp"].size() * fsdp


def batch_share(batch, mesh, accum_steps: int = 1):
    """This rank's rows of a global batch (a dict tree of arrays or tensors, leading dim the batch).

    With ``accum_steps`` the rows are those of this rank's share of every microbatch, in order, so
    that the step's ``reshape(accum_steps, -1)`` chunks are the global microbatches' shares.
    """
    index, count = data_share(mesh)
    if count == 1:
        return batch

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if x is None or np.ndim(x) == 0:
            return x
        b = x.shape[0]
        if b % (count * accum_steps):
            raise ValueError(f"a batch of {b} rows does not split into {count} shares x {accum_steps} microbatches")
        rows = x.reshape(accum_steps, count, b // (count * accum_steps), *x.shape[1:])[:, index]
        return rows.reshape(b // count, *x.shape[1:])

    return take(batch)


def gather_to_host(tree):
    """The full, unsharded values of a module's trained state (or of a dict / list tree of tensors),
    copied to the CPU, on every rank.  Every rank must call it: a sharded tensor's gather is a collective."""
    if hasattr(tree, "trained_state_dict"):
        tree = tree.trained_state_dict()
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        from torch.distributed.tensor import DTensor

        whole = tree.full_tensor() if isinstance(tree, DTensor) else tree
        return whole.detach().to("cpu", copy=True)  # a copy: later steps do not move it
    return tree


def distribute_like(full: torch.Tensor, like):
    """``full`` laid out as ``like``: a ``DTensor`` of its mesh and placements, cut from ``full``
    locally (every rank holds the whole value), or ``full`` on ``like``'s device."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full.to(like.device, like.dtype)


@torch.no_grad()
def load_full_state(module, state: dict) -> None:
    """Load a full (unsharded) trained state dict into ``module``, sharded or not: each sharded
    tensor takes its own rows of the full value."""
    from torch.distributed.tensor import DTensor

    own = module.state_dict()
    if not any(isinstance(v, DTensor) for v in own.values()):
        module.load_trained_state_dict(state)
        return
    unexpected = sorted(set(state) - set(own))
    if unexpected:
        raise RuntimeError(f"state does not fit: unexpected {unexpected}")
    for name, value in state.items():
        target = own[name]
        if isinstance(target, DTensor):
            target.to_local().copy_(distribute_like(value, target).to_local())
        else:
            target.copy_(value.to(target.device, target.dtype))

