"""Profiling and tracing (port of arp_tpu/profiling.py): the step timer, :class:`Trace` (``torch.profiler``
over a stretch of steps, written as a Chrome trace; the JAX package's XLA trace is a TensorBoard one), and the
program's host spans.  Not ported: ``ProfileAccumulator`` (no caller).

Spans.  ``with span("engine.encode"):`` marks a stretch of host work at a layer boundary.  A span is recorded
only while a ``torch.profiler`` records (in any thread of the process); otherwise ``span`` checks one flag and
returns a shared no-op, which is false.  A recorded span is ``(name, start_ns, end_ns, span_id, parent_id,
trace_id, thread_id, attrs)``, stamped with ``time.perf_counter_ns``.  Its parent is the span open in the calling
context, or the one passed as ``parent`` (across threads); ``trace_id`` is the root's ``span_id``, so every span of
one engine call, lockstep step, train step or request shares it.  Spans that do counted work carry the counts as
``attrs``, set only while recording (``if s: s.set(frames=n)``), so that a span off builds nothing.

Spans live in one bounded ring in memory (:data:`RING_SPANS`), never on the device's timeline: a
``record_function`` or NVTX range would show there as device work.  :func:`spans` copies the ring;
:func:`spans_on_profiler_clock` puts them on a profiler trace's timeline; :meth:`Trace.start` clears the ring
and :meth:`Trace.stop` writes the stretch's spans into ``trace.json`` on a "host spans" track per thread.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SPANS = 1_000_000
# a host spans track's Chrome trace thread id: the thread's own id plus this (Linux thread ids stay below 2**22)
_TRACK_TID = 1_000_000_000


class Span(NamedTuple):
    """A recorded span, stamped in ns on ``time.perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    thread_id: int
    attrs: dict


_ring: deque = deque(maxlen=RING_SPANS)
_ring_lock = threading.Lock()
_thread = threading.local()  # .tid: the thread's native id, read once (a system call)
_ids = itertools.count(1)
_open: contextvars.ContextVar = contextvars.ContextVar("arp_tpu_torch_open_span", default=None)
_anchor: Optional[tuple] = None  # (perf_counter_ns, time_ns) read together when recording starts


def _take_anchor() -> tuple:
    """A ``(perf_counter_ns, time_ns)`` pair read at one instant (the wall clock between two reads of the
    counter, against their midpoint)."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, wall


class _Recording:
    __slots__ = ("name", "span_id", "parent_id", "trace_id", "attrs", "start", "_token")

    def __init__(self, name: str, parent):
        global _anchor
        if _anchor is None:
            _anchor = _take_anchor()
        if parent is None:
            parent = _open.get()
        self.name, self.attrs = name, {}
        self.span_id = next(_ids)
        if isinstance(parent, _Recording):
            self.parent_id, self.trace_id = parent.span_id, parent.trace_id
        else:
            self.parent_id, self.trace_id = None, self.span_id

    def set(self, **attrs) -> None:
        """More attributes, known once the span's work has begun."""
        self.attrs.update(attrs)

    def __enter__(self):
        self._token = _open.set(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.reset(self._token)
        tid = getattr(_thread, "tid", None)
        if tid is None:
            tid = _thread.tid = threading.get_native_id()
        record = Span(self.name, self.start, end, self.span_id, self.parent_id, self.trace_id, tid, self.attrs)
        with _ring_lock:
            _ring.append(record)
        return False


class _Off:
    """What :func:`span` returns while nothing records: false; enters and exits doing nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, parent=None):
    """A context manager that records the stretch it covers as span ``name`` while a ``torch.profiler``
    records; ``parent``: the parent span (the object a ``with span(...) as s`` gave) when it is open in
    another thread.  What it gives is true only while recording."""
    # torch.profiler's process-wide flag: the C++ check record_function makes is per thread
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, parent)


def spans() -> list:
    """A copy of the recorded spans, oldest first (the ring is not drained: several readers read it)."""
    with _ring_lock:
        return list(_ring)


def clear_spans() -> None:
    """Empty the ring; the next recorded span takes a new clock anchor."""
    global _anchor
    with _ring_lock:
        _ring.clear()
        _anchor = None


def spans_on_profiler_clock(trace_start_ns: int) -> list:
    """``(span, start_us, end_us)`` for every recorded span: its ends in µs from a ``torch.profiler`` trace's
    start (``prof.profiler.kineto_results.trace_start_ns()``), the unit and origin of its events'
    ``time_range``.  The one place where the spans' clock meets the profiler's (``time.time_ns``'s)."""
    recorded = spans()
    if not recorded:
        return []
    counter, wall = _anchor
    shift = wall - counter - trace_start_ns
    return [(s, (s.start_ns + shift) / 1e3, (s.end_ns + shift) / 1e3) for s in recorded]


class Trace:
    """``torch.profiler`` over the steps between :meth:`start` and :meth:`stop`; the trace goes to
    ``<log_dir>/trace.json`` (Chrome's trace format), the device's activity and the program's host spans
    included."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self):
        clear_spans()
        self._prof.__enter__()

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        _merge_host_spans(path, self._prof.profiler.kineto_results.trace_start_ns())
        return path


def _merge_host_spans(path: str, trace_start_ns: int) -> None:
    """The recorded spans into the Chrome trace at ``path`` as complete ("X") events, one "host spans" track
    per thread beside the process's own."""
    with open(path) as f:
        doc = json.load(f)
    # the file's timestamps are µs from its baseTimeNanoseconds
    offset_us = (trace_start_ns - int(doc.get("baseTimeNanoseconds", 0))) / 1e3
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    threads = set()
    for s, start_us, end_us in spans_on_profiler_clock(trace_start_ns):
        tid = _TRACK_TID + s.thread_id
        threads.add(tid)
        args = {"span_id": s.span_id, "parent_id": s.parent_id, "trace_id": s.trace_id, **s.attrs}
        events.append({"ph": "X", "cat": "host_span", "name": s.name, "pid": pid, "tid": tid,
                       "ts": start_us + offset_us, "dur": end_us - start_us, "args": args})
    for tid in sorted(threads):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"host spans (thread {tid - _TRACK_TID})"}})
    with open(path, "w") as f:
        json.dump(doc, f)


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
