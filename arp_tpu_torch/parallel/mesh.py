"""The meshes of the port (port of arp_tpu/parallel/mesh.py).

JAX names four axes over devices; the port runs one process a GPU
(parallel/distributed.py) and builds them as a ``torch.distributed``
``DeviceMesh`` of shape (dp, fsdp, tp, pp) over the ranks, in JAX's axis order
(pp varies fastest):

  * ``dp``   — data parallelism: the state replicated, the gradients averaged
               (``DistributedDataParallel``, or FSDP2's replicated dimension);
  * ``fsdp`` — fully sharded data parallelism: the trained parameters and the
               AdamW moments sharded (FSDP2's ``fully_shard``), replicated over dp;
  * ``tp``   — tensor parallelism: attention heads and the MLP's hidden units
               split over the ranks (Megatron's layout, parallel/tensor_parallel.py),
               placed by JAX's name rules (:func:`partition_params`);
  * ``pp``   — pipeline parallelism: the policy's block stack cut into stages, one
               a rank (parallel/pipeline.py, models/layers.py::PipelinedTransformer);
  * ``dcn_dp`` folds into dp as its outermost factor, as in JAX: torchrun's
    ranks are node-major, so contiguous rank groups are nodes and only the
    outermost dp stride crosses nodes.

Rank r of N is JAX's process r of N with one device.  The batch's rows are
split over the data axes only: rank ``dp_index * fsdp + fsdp_index`` holds share
``dp_index * fsdp + fsdp_index`` of ``dp * fsdp``, and the tp and pp ranks of one
data share see the same rows.

A parameter split beyond the data axes carries a :class:`Split` (attribute
``mesh_split``): its tp share or its pp stage.  :func:`gather_to_host` and
:func:`load_full_state` read it to assemble and cut the full (flat, unpipelined)
state, so a checkpoint written at one layout restores at any other.

:func:`mesh_from_count` is JAX's single-process local-device mesh for the
reward engines (``--mesh_dp``): a :class:`LocalMesh`, an ordered device list.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import process_count

AXES = ("dp", "fsdp", "tp", "pp")
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
    """The (dp, fsdp, tp, pp) ``DeviceMesh`` over the world, or None for one process outside a process
    group (the trainers then run their step unwrapped)."""
    dp, fsdp, tp, pp = config.resolve()
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
    return init_device_mesh(device_type, (dp, fsdp, tp, pp), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh[axis].size()


def data_mesh(mesh):
    """The (dp, fsdp) part of ``mesh``: the ranks that hold other rows of the batch and the same tp / pp
    coordinates (FSDP2's mesh)."""
    return mesh["dp", "fsdp"]


def data_size(mesh) -> int:
    return axis_size(mesh, "dp") * axis_size(mesh, "fsdp")


def sum_over_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed in place over the data axes of ``mesh`` (dp, then fsdp); the tp and pp ranks stay apart."""
    for axis in DATA_AXES:
        if mesh[axis].size() > 1:
            dist.all_reduce(t, group=mesh[axis].get_group())
    return t


def broadcast_over_data(t: torch.Tensor, mesh) -> None:
    """``t`` of the first rank of this rank's data group, on every rank of it (dp, then fsdp)."""
    for axis in DATA_AXES:
        group = mesh[axis]
        if group.size() > 1:
            dist.broadcast(t, src=dist.get_global_rank(group.get_group(), 0), group=group.get_group())


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


# -- the reward engines' local-device mesh -----------------------------------------------------------


class LocalMesh:
    """:func:`mesh_from_count`'s mesh: an ordered list of this process's devices, JAX's 1-D data mesh
    over addressable devices.  A device may appear more than once (shares that run on one card)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"dp": len(self.devices), "fsdp": 1, "tp": 1, "pp": 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"LocalMesh({[str(d) for d in self.devices]})"


def local_devices(device_type: str = "cuda") -> list:
    """This process's devices of ``device_type``: every card, or the CPU, which is one device (as JAX's
    ``local_devices()`` on the CPU)."""
    if torch.device(device_type).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def mesh_from_count(n: int, devices=None, device_type: str = "cuda") -> Optional[LocalMesh]:
    """Data-parallel mesh over the first ``n`` local devices (CLI ``--mesh_dp``).

    ``n == 0`` -> None (single device, no mesh); ``n == -1`` -> all local devices; otherwise the first
    ``n``; more than there are raises.  ``devices``: an explicit list (default :func:`local_devices`
    of ``device_type``).  Single-process scope only, as in JAX: inside a process group of several ranks
    it raises (shard *files* per process instead).
    """
    if not n:
        return None
    if process_count() > 1:
        raise RuntimeError(
            "mesh_from_count shards host batches over this process's devices only; under several processes "
            f"(world {process_count()}) shard the work per process instead (labeler: --num_hosts/--host_index "
            "+ --merge)")
    devices = list(devices if devices is not None else local_devices(device_type))
    if n == -1:
        n = len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return LocalMesh(devices[:n])


# -- parameter placement rules (JAX's partition_params) --------------------------------------------
#
# Matched on the parameter's Flax path.  qkv and fc1 shard their output dim, the projections attn_out / fc2
# their input dim, so each block needs one all-reduce pair under tp.
_TP_COL_RULES = (r".*qkv/kernel$", r".*fc1/kernel$", r".*/query/kernel$", r".*/key/kernel$", r".*/value/kernel$")
_TP_ROW_RULES = (r".*attn_out/kernel$", r".*fc2/kernel$", r".*/out/kernel$")

# ZeRO-3 floor: leaves below this many elements are replicated instead of fsdp-sharded
_FSDP_MIN_ELEMENTS = 4096


def spec_for(path: str, shape: tuple, dp: int, fsdp: int, tp: int) -> tuple:
    """JAX's ``_spec_for``: the axis each dim of the Flax leaf ``path`` of ``shape`` is sharded over
    (None: replicated there), as a tuple; ``()`` replicates the whole leaf."""
    del dp
    shape = tuple(shape)
    if "stacked_blocks" in path:
        return ("pp",)
    if tp > 1:
        for pat in _TP_COL_RULES:
            if re.match(pat, path) and len(shape) >= 2 and shape[-1] % tp == 0:
                spec = [None] * len(shape)
                spec[-1] = "tp"
                if fsdp > 1 and shape[0] % fsdp == 0:
                    spec[0] = "fsdp"
                return tuple(spec)
        for pat in _TP_ROW_RULES:
            if re.match(pat, path) and len(shape) >= 2 and shape[0] % tp == 0:
                spec = [None] * len(shape)
                spec[0] = "tp"
                if fsdp > 1 and shape[-1] % fsdp == 0:
                    spec[-1] = "fsdp"
                return tuple(spec)
    if fsdp > 1 and len(shape) >= 1 and int(np.prod(shape)) >= _FSDP_MIN_ELEMENTS:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] >= fsdp and shape[i] % fsdp == 0:
                spec = [None] * len(shape)
                spec[i] = "fsdp"
                return tuple(spec)
    return ()


def flax_leaf(name: str, shape: tuple) -> tuple[str, tuple]:
    """(Flax path joined by "/", Flax shape) of the port's parameter ``name`` of ``shape``: a Dense
    kernel's dims are the torch weight's reversed (models/policy/convert.py)."""
    from ..models.policy.convert import flax_path

    path = flax_path(name, len(shape))
    if path[-1] == "kernel" and not name.endswith("kernel"):
        shape = tuple(reversed(shape)) if len(shape) == 2 else (shape[2], shape[3], shape[1], shape[0])
    return "/".join(path), tuple(shape)


def partition_params(params, mesh) -> dict:
    """JAX's ``partition_params``: each trained parameter's spec (:func:`spec_for`, over its Flax path
    and shape), keyed by the port's name.  ``params``: a module (its trained parameters) or (name,
    tensor) pairs; ``mesh``: a mesh, or a mapping of axis sizes."""
    if isinstance(params, torch.nn.Module):
        from .step import trainable_parameters

        params = trainable_parameters(params)
    sizes = {a: (mesh[a] if isinstance(mesh, dict) else axis_size(mesh, a)) for a in ("dp", "fsdp", "tp")}
    out = {}
    for name, p in params:
        path, shape = flax_leaf(name, tuple(p.shape))
        out[name] = spec_for(path, shape, sizes["dp"], sizes["fsdp"], sizes["tp"])
    return out


class Split:
    """How a trained parameter is laid out beyond the data axes.

    ``axis`` "tp": this rank holds share ``rank`` of ``size`` of the full tensor, cut in contiguous
    shares along torch dim ``dim``, or with ``qkv`` along the last dim of the (..., 3, width) view of
    a fused q/k/v tensor (each rank its own heads' q, k and v).  ``axis`` "pp": the tensor lives whole,
    on the pp rank of its stage only.  ``group`` is the axis's process group."""

    def __init__(self, axis: str, group, size: int, rank: int, dim: int = 0, qkv: bool = False):
        self.axis, self.group, self.size, self.rank, self.dim, self.qkv = axis, group, size, rank, dim, qkv

    def __deepcopy__(self, memo):  # a process group is a handle, never copied
        return self

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's share of ``full`` (the whole tensor for a pp stage)."""
        if self.axis == "pp":
            return full
        if self.qkv:
            view = full.reshape(*full.shape[:-1], 3, -1)
            return view.chunk(self.size, dim=-1)[self.rank].reshape(*full.shape[:-1], -1)
        return full.chunk(self.size, dim=self.dim)[self.rank]

    def join(self, shares: list) -> torch.Tensor:
        """The full tensor from every rank's share, in rank order (tp)."""
        if self.qkv:
            lead = shares[0].shape[:-1]
            return torch.cat([s.reshape(*lead, 3, -1) for s in shares], dim=-1).reshape(*lead, -1)
        return torch.cat(shares, dim=self.dim)


def split_of(t) -> Optional[Split]:
    """The :class:`Split` a parameter carries, or None."""
    return getattr(t, "mesh_split", None)


def host_backend(group) -> bool:
    """True when ``group``'s backend is gloo: its point-to-point and gather calls take host tensors."""
    return dist.get_backend(group) == "gloo"


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` of ``group`` in rank order (gloo: through host memory)."""
    src = t.detach().contiguous()
    if host_backend(group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return out


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def gather_named(named: dict, splits: dict) -> dict:
    """The full values of a dict of (possibly sharded) tensors on every rank, copied to the CPU:
    fsdp shards gathered, tp shares joined (``splits[name]``) and the pp stages' entries collected from
    every stage.  Every rank of the mesh calls it."""
    out, staged, pp_group = {}, {}, None
    for name, value in named.items():
        split = splits.get(name)
        whole = _whole(value).detach()
        if split is None:
            out[name] = whole.to("cpu", copy=True)
        elif split.axis == "tp":
            out[name] = split.join([s.cpu() for s in _all_gather(whole, split.group)])
        else:
            staged[name], pp_group = whole.to("cpu", copy=True), split.group
    if pp_group is not None:
        stages = [None] * dist.get_world_size(pp_group)
        dist.all_gather_object(stages, staged, group=pp_group)
        for stage in stages:
            out.update(stage)
    return out


def gather_to_host(tree):
    """The full, unsharded values of a module's trained state (or of a dict / list tree of tensors),
    copied to the CPU, on every rank.  A module's fsdp shards, tp shares and pp stages are assembled
    into the flat model's state.  Every rank must call it: a sharded tensor's gather is a collective."""
    if hasattr(tree, "trained_state_dict"):
        from .step import unwrap

        module = unwrap(tree)
        return gather_named(module.trained_state_dict(),
                            {n: split_of(p) for n, p in module.named_parameters() if split_of(p) is not None})
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _whole(tree).detach().to("cpu", copy=True)  # a copy: later steps do not move it
    return tree


def distribute_like(full: torch.Tensor, like):
    """``full`` laid out as ``like``: its tp share where ``like`` carries one, then a ``DTensor`` of
    ``like``'s mesh and placements cut locally (every rank holds the whole value), or the share on
    ``like``'s device."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    split = split_of(like)
    if split is not None:
        full = split.cut(full)
    if isinstance(like, DTensor):
        return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh, like.placements,
                                 src_data_rank=None)
    return full.to(like.device, like.dtype)


@torch.no_grad()
def load_full_state(module, state: dict) -> None:
    """Load a full (unsharded, flat) trained state dict into ``module``, laid out or not: each sharded
    tensor takes its own rows of the full value, each tp share its share, and a pp stage its own
    blocks (the other stages' entries of ``state`` are theirs)."""
    from torch.distributed.tensor import DTensor

    params = dict(module.named_parameters())
    splits = {n: split_of(p) for n, p in params.items() if split_of(p) is not None}
    own = module.state_dict()
    if not splits and not any(isinstance(v, DTensor) for v in own.values()):
        module.load_trained_state_dict(state)
        return
    staged = any(s.axis == "pp" for s in splits.values())
    unexpected = sorted(set(state) - set(own))
    if unexpected and not staged:
        raise RuntimeError(f"state does not fit: unexpected {unexpected}")
    for name, value in state.items():
        if name not in own:
            continue  # another pp stage's block
        target = own[name]
        value = distribute_like(value, params.get(name, target))
        if isinstance(target, DTensor):
            target.to_local().copy_(value.to_local())
        else:
            target.copy_(value)
