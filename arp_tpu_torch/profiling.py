"""Profiling and tracing (port of arp_tpu/profiling.py): the step timer, and :func:`trace`,
which records ``torch.profiler`` over a block and writes a Chrome trace (the JAX package's
XLA trace is a TensorBoard one).  Not ported: ``ProfileAccumulator`` (no caller).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class Trace:
    """``torch.profiler`` over the steps between :meth:`start` and :meth:`stop`; the trace goes to
    ``<log_dir>/trace.json`` (Chrome's trace format), the device's activity included on CUDA."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self):
        self._prof.__enter__()

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``.

    with arp_tpu_torch.profiling.trace("/tmp/trace"):
        train_step(...)
    """
    t = Trace(log_dir)
    t.start()
    try:
        yield
    finally:
        t.stop()


class StepTimer:
    """Throughput meter for the train loop (examples/sec, steps/sec)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def metrics(self, batch_size: int) -> Dict[str, float]:
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {
            "perf/step_time_s": mean,
            "perf/steps_per_sec": 1.0 / mean,
            "perf/examples_per_sec": batch_size / mean,
        }
