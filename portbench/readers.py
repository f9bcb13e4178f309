"""What the per-layer metrics read from a traced run's record (trace.py): the device's idle share, the
window's share of the chip's peak, and a kernel's share of its roofline."""

from __future__ import annotations

import re
from typing import Optional

from . import roofline

_K1 = re.compile(r"flash_fwd_\w*kernel<(\d+)")


def idle_pct(record: dict) -> Optional[float]:
    """The share of the window in which nothing ran on the device."""
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def mfu_pct(record: dict) -> Optional[float]:
    """The model's operations in the window (the traffic's count, by formula) over the window's time and
    the peak of the configuration's dtype."""
    work = record["work"]
    if not work.get("model_flops"):
        return None
    return 100.0 * work["model_flops"] / record["window_s"] / roofline.PEAK_FLOPS[work["dtype"]]


def k1_roofline_pct(record: dict) -> Optional[float]:
    """K1's least time over its launches in the trace (each launch's shape from its head dim, as the
    traffic names them) over K1's device time."""
    shapes = record["work"].get("k1", {})
    bound = spent = 0.0
    for name, (seconds, launches) in record["kernels"].items():
        m = _K1.search(name)
        if not m or m.group(1) not in shapes:
            continue
        b, n, h, d, dtype = shapes[m.group(1)]
        bound += launches * roofline.bound_s(*roofline.attention_cost(b, n, h, d, dtype), dtype)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None


def engine_busy_pct(record: dict) -> Optional[float]:
    """The reward server's own busy seconds (its ``/v1/health`` counter) over the window."""
    busy = record["work"].get("engine_busy_s")
    return None if busy is None else 100.0 * busy / record["window_s"]


def span_ms(record: dict, name: str) -> Optional[float]:
    """A layer's synchronised time a lockstep step, as the traffic's wrappers noted it."""
    value = record["work"].get(name)
    return None if value is None else float(value)
