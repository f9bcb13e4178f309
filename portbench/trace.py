"""The traced run's record, from ``torch.profiler`` over the measured window.

``record`` keys: ``window_s`` (the window's length on the profiler's clock), ``busy_s`` (the union of the
intervals in which a kernel, copy or set ran on the device, inside the window), ``kernels`` ({name:
[seconds, launches]}), ``breakdown`` (the ten device operations that took most time, and the ten longest
idle gaps' time by the innermost host operation that covered each), and what the traffic adds under
``work``.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

WINDOW = "portbench.window"
# the benchmark's own ranges: the profiler also puts them on the device's timeline, where they are no work
OWN_RANGES = "portbench."


@contextlib.contextmanager
def traced(on: bool):
    """A profiler over CPU and CUDA activity while ``on``; yields it (None when off)."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def window_marker(prof):
    """The range that marks the window in the trace (a no-op when not tracing)."""
    if prof is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(WINDOW)


def reduce(prof, top: int = 10) -> dict:
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no window range")
    lo, hi = win[0].time_range.start, win[0].time_range.end
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(OWN_RANGES):
                continue
            start, end = max(start, lo), min(end, hi)
            if end > start:
                device.append((start, end, e.name))
        elif e.name != WINDOW and end > lo and start < hi:
            host.append((start, end, e.name))
    device.sort()
    kernels = defaultdict(lambda: [0.0, 0])
    busy, gaps = 0.0, []
    cur_lo = cur_hi = None
    for start, end, name in device:
        k = kernels[name]
        k[0] += (end - start) / 1e6
        k[1] += 1
        if cur_hi is None or start > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
                gaps.append((cur_hi, start))
            cur_lo, cur_hi = start, end
        else:
            cur_hi = max(cur_hi, end)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    window_us = hi - lo
    device_ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda kv: -kv[1])[:top]
    return {"window_s": window_us / 1e6, "busy_s": busy / 1e6, "kernels": {n: v for n, v in kernels.items()},
            "breakdown": {"device_ops": device_ops, "idle_gaps": _idle_gaps(gaps, host, top)}}


def _idle_gaps(gaps, host, top: int) -> list:
    """The 500 longest idle gaps' time, summed by the innermost host operation that covered most of each."""
    host.sort()
    starts = [h[0] for h in host]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:500]
    by_name = defaultdict(float)
    for g_lo, g_hi in longest:
        best = None
        end = bisect.bisect_left(starts, g_hi)
        # the innermost covering operation starts shortly before the gap: look back a bounded stretch
        for h_lo, h_hi, name in host[max(0, end - 2000):end]:
            overlap = min(h_hi, g_hi) - max(h_lo, g_lo)
            if overlap <= 0:
                continue
            key = (overlap, -(h_hi - h_lo))
            if best is None or key > best[0]:
                best = (key, name)
        by_name["host: " + (best[1] if best else "(none)")] += (g_hi - g_lo) / 1e6
    return sorted(([n, s] for n, s in by_name.items()), key=lambda kv: -kv[1])[:top]
