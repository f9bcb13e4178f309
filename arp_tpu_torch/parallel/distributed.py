"""Start-up of several processes, one a GPU (port of arp_tpu/parallel/distributed.py).

JAX runs one controller over many devices; the port runs one process a GPU,
started by ``torchrun --nproc_per_node=N`` (or any launcher that sets torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``).
:func:`initialize` joins the process group: NCCL for a CUDA device, gloo for
the CPU.  On CUDA it first makes ``cuda:LOCAL_RANK`` the current device, so an
entry point's ``cuda`` means that card (``device.py::resolve_device``).

As in JAX, a single process without a launcher's environment is a no-op
returning ``(0, 1)``; an explicit coordinator that cannot be reached raises, and
so does a failed NCCL start: nothing falls back to gloo, to the CPU or to one
process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# longer than a rollout eval, which rank 0 runs while the others wait in a broadcast
DEFAULT_TIMEOUT_S = 4 * 3600.0


def local_rank() -> int:
    """This process's index on its node (torchrun's ``LOCAL_RANK``; 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda", init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join the process group when running several processes; no-op otherwise.

    ``coordinator_address`` (``host:port``) with ``num_processes`` and ``process_id`` names the
    group explicitly, as JAX's arguments do; ``init_method`` (``file://...``, ``tcp://...``) is
    torch's own spelling of the same.  Without either, torchrun's environment is read; without
    that, one process.  Returns (process_index, process_count).
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return 0, 1
    dev = torch.device(device)
    kwargs = dict(timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        kwargs.update(init_method=init_method, world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs.update(init_method="env://")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for but torch.cuda.is_available() is False")
        index = dev.index if dev.index is not None else local_rank()
        torch.cuda.set_device(index)
        # device_id makes NCCL build its communicator now: a failed start raises here, not at the first step
        dist.init_process_group("nccl", device_id=torch.device("cuda", index), **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process (nothing to wait for in one)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
