"""train.nccl_pct: The NCCL kernels' device time on rank 0's card (the data-parallel all-reduces of the
gradients and of the step's reported values) over rank 0's training window (%).  The kernels are those named
``ncclDevKernel_*`` (``ncclKernel_*`` in older NCCL); the ``nccl:all_reduce`` range that c10d puts on the
device's timeline beside each is no work and is left out.  The all-reduces overlap the backward's compute, and a
kernel also spins while it waits for the other ranks, so this is their time on the card, not what they add to a
step."""

import re

NCCL_KERNEL = re.compile(r"^nccl(Dev)?Kernel")


def read(record: dict):
    spent = sum(seconds for name, (seconds, _) in record["kernels"].items() if NCCL_KERNEL.match(name))
    return 100.0 * spent / record["window_s"] if spent > 0 else None
