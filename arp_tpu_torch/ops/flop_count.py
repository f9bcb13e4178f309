"""The kernels' floating-point operations, for counting a step (train/common.py::flops_analysis).

``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls that PyTorch
dispatches, and cannot see inside a kernel launched through ctypes.  So each
kernel's wrapper, where it launches the kernel, notes the operations of its
call by formula into every tally :func:`kernel_flops` holds open: K1
``4 * B * H * N^2 * D`` (q k^T and p v, dense, whatever the mask), K2 and K3
``2 * M * K * N``.  These are what FlopCounterMode counts for the kernels'
plain versions, so a step counts the same on either route.
"""

from __future__ import annotations

import contextlib

_tallies: list = []


@contextlib.contextmanager
def kernel_flops():
    """While open, a one-element list whose item adds up the operations the kernels launched."""
    tally = [0]
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


def note(flops: int) -> None:
    """A launch of ``flops`` operations (called by the kernels' wrappers)."""
    for tally in _tallies:
        tally[0] += flops
