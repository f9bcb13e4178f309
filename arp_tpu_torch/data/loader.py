"""Batching data loader with background prefetch (copy of arp_tpu/data/loader.py).

Batches are assembled by a thread pool reading HDF5 (h5py releases the GIL
during reads) and handed on through a bounded queue, so host IO overlaps the
device's steps.  numpy and threads only: the same batches as the JAX
package's loader for the same dataset and seed.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator

import numpy as np


def _collate(items):
    """Stack a list of sample dicts into one batch dict (nested)."""
    first = items[0]

    def rec(vals):
        v0 = vals[0]
        if isinstance(v0, dict):
            return {k: rec([v[k] for v in vals]) for k in v0}
        return np.stack(vals, axis=0)

    return {k: rec([it[k] for it in items]) if first[k] is not None else None for k in first}


class DataLoader:
    """Shuffled, drop-last batching over an indexable dataset.

    Args:
      dataset: indexable with __len__/__getitem__ returning (nested) dict
        of numpy arrays.
      batch_size: per-host batch size.
      shuffle: reshuffle each epoch with a per-epoch seed.
      num_workers: thread pool size for sample fetch (0 = synchronous).
      prefetch: batches buffered ahead.
      seed: base shuffle seed (epoch index is folded in).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self):
        n = len(self.dataset)
        assert n >= self.batch_size or not self.drop_last, (
            f"dataset of {n} items < batch_size {self.batch_size} with drop_last: "
            "every epoch would be empty"
        )
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        if self.drop_last:
            idx = idx[: (n // self.batch_size) * self.batch_size]
        # deterministic per-epoch stream for the dataset's own sampling
        # (hindsight goals): same (seed, epoch) -> identical draws on resume
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(self.seed * 100003 + self._epoch)
        return idx

    def _iter_batches(self, batches) -> Iterator[dict]:
        """Collate index batches through the worker pool (prefetch in flight)."""
        if self.num_workers <= 0:
            for b in batches:
                yield _collate([self.dataset[int(i)] for i in b])
            return

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=self.num_workers)
        try:

            def fetch(b):
                return _collate([self.dataset[int(i)] for i in b])

            # keep `prefetch + 1` batch futures in flight
            pending = []
            it = iter(batches)
            for _ in range(self.prefetch + 1):
                b = next(it, None)
                if b is not None:
                    pending.append(pool.submit(fetch, b))
            while pending:
                fut = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append(pool.submit(fetch, b))
                yield fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _iter_epoch(self) -> Iterator[dict]:
        idx = self._epoch_indices()
        self._epoch += 1
        batches = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        yield from self._iter_batches(batches)

    def __iter__(self):
        return self._iter_epoch()

    def epochs(self, skip_batches: int = 0) -> Iterator[dict]:
        """Endless stream over epochs (reference generate_batch semantics).

        ``skip_batches`` fast-forwards without loading data (index-only), so a
        resumed run continues with exactly the batches it would have seen.
        """
        per_epoch = len(self)
        assert per_epoch > 0, (
            f"dataset of {len(self.dataset)} items yields 0 batches at "
            f"batch_size {self.batch_size} (drop_last={self.drop_last})"
        )
        if skip_batches:
            self._epoch += skip_batches // per_epoch
            skip_batches = skip_batches % per_epoch
        first = True
        while True:
            if first and skip_batches:
                idx = self._epoch_indices()
                self._epoch += 1
                batches = [
                    idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)
                ][skip_batches:]
                # same pooled prefetch as a normal epoch — the remainder of a
                # resumed epoch must not run single-threaded
                yield from self._iter_batches(batches)
                first = False
                continue
            first = False
            yield from self._iter_epoch()

    def state(self) -> dict:
        return {"epoch": self._epoch}

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
