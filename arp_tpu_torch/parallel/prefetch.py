"""Host-to-device prefetch (port of arp_tpu/parallel/prefetch.py).

:class:`ThreadedPrefetch` runs the host pipeline (HDF5 reads, collation) in a
daemon thread behind a bounded queue; :func:`pin_batch` pins a batch's arrays
there, and :func:`batch_to_device` copies them with ``non_blocking`` copies,
as the labeling engine's producer thread and its copies do: the copy of the
next batch is queued behind the device's work on this one.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ..profiling import span


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def pin_batch(batch, pin: bool = True):
    """A host batch as tensors, pinned when ``pin`` (needs CUDA)."""
    def one(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        return t.pin_memory() if pin else t

    return _map(batch, one)


def batch_to_device(batch, device):
    """Every tensor of ``batch`` on ``device``: ``non_blocking`` copies from pinned memory."""
    device = torch.device(device)
    return _map(batch, lambda t: torch.as_tensor(t).to(device, non_blocking=device.type == "cuda"))


class ThreadedPrefetch:
    """Run an iterator in a daemon thread with a bounded queue.

    Keeps host batch assembly (HDF5 reads, collation, pinning) overlapped with
    the device's steps.
    """

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, capacity: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._err = None
        self._closed = False

        def worker():
            try:
                for item in iterator:
                    if self._closed:
                        return
                    self._queue.put(item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with span("prefetch.wait"):
            item = self._queue.get()
        if item is self._SENTINEL:
            # re-arm so calling __next__ again keeps raising StopIteration
            # instead of blocking forever on an empty queue
            self._queue.put(self._SENTINEL)
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and release queued batches (safe to call early,
        e.g. on the trainer's preemption exit path)."""
        self._closed = True

        def drain():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass

        # Drain/join cycles: each drain unblocks a producer stuck in
        # queue.put on a full queue (at capacity=1 it can block twice — on an
        # item and then on the finally-put of the sentinel).
        deadline = time.monotonic() + 5.0
        while True:
            drain()
            self._thread.join(timeout=0.1)
            if not self._thread.is_alive() or time.monotonic() > deadline:
                break
        # A producer that finished between the last drain and join can have
        # left [item..., sentinel] queued; drain once more so post-close
        # next() cannot return stale data ahead of the sentinel.
        drain()
        # The drains consumed the sentinel; re-arm it so post-close iteration
        # raises StopIteration instead of blocking forever.
        try:
            self._queue.put_nowait(self._SENTINEL)
        except queue.Full:
            pass
