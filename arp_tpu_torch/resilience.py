"""Failure detection & preemption handling (copy of arp_tpu/resilience.py).

This module provides:

  * a SIGTERM/SIGINT preemption handler that requests a final checkpoint and
    clean exit at the next step boundary;
  * a NaN/loss-spike detector that can halt or rollback training;
  * a heartbeat file for external watchdogs.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np


class PreemptionHandler:
    """Flag-based graceful shutdown on SIGTERM/SIGINT.

    The train loop checks ``should_stop`` each step and saves + exits cleanly
    instead of dying mid-write.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._original = {}
        for sig in signals:
            self._original[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        self.should_stop = True

    def restore(self):
        for sig, handler in self._original.items():
            signal.signal(sig, handler)


class FaultDetector:
    """Detect NaN/inf losses and sudden loss spikes.

    ``check(loss)`` returns "ok" | "nan" | "spike".  A spike is a loss more
    than ``spike_factor`` times the trailing median (after warmup).
    """

    def __init__(self, spike_factor: float = 20.0, window: int = 100, warmup: int = 20):
        self.spike_factor = spike_factor
        self.window = window
        self.warmup = warmup
        self._history: list = []

    def reset(self):
        """Clear history (e.g. after a rollback, so the trailing median does
        not keep comparing against the faulted region)."""
        self._history.clear()

    def check(self, loss: float) -> str:
        loss = float(loss)
        if not np.isfinite(loss):
            return "nan"
        self._history.append(loss)
        if len(self._history) > self.window:
            self._history.pop(0)
        if len(self._history) >= self.warmup:
            med = float(np.median(self._history))
            # deviation-based so zero/negative-median objectives (log-lik
            # style losses) still trip: for positive medians this reduces to
            # (1 + factor) * med ~ the old factor * med rule
            if loss - med > self.spike_factor * max(abs(med), 1e-2):
                return "spike"
        return "ok"


class Heartbeat:
    """Touch a file periodically so external watchdogs can detect hangs."""

    def __init__(self, path: str, interval_s: float = 60.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self, step: Optional[int] = None):
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as f:
                f.write(f"{now} {step if step is not None else ''}\n")
            self._last = now
