"""Stage 4 under data parallelism: the trainer's DDP step over ``ranks`` cards, one process a card, as
``train/main.py`` builds it under torchrun with ``--mesh_dp=ranks``.

The benchmark's own process is rank 0; set-up starts ranks 1 .. ranks - 1 as child processes (``python -m
portbench.traffic.train_dp``), and every rank joins one process group through ``parallel/distributed.py::
initialize`` (NCCL on the cards, gloo on the CPU), so the groups' start is part of set-up.  Each rank builds
the policy with the weights drawn from the seed, the state wrapped by ``shard_train_state`` (DDP over dp), the
loss on its share of the global batch (``make_loss_fn(share=data_share(mesh))``: the step's augmentation drawn
for the global batch from the (seed, step) stream, each rank applying its rows' draws) and the step over the
mesh, and feeds ``batch`` rows a step through ``ThreadedPrefetch`` + ``pin_batch`` from its pool: its rows of
``pool_batches`` global batches drawn from the seed.  The window is a number of steps that every rank takes
with no signal between them, as the trainer's ranks do: rank 0 works it out from the time of its last checked
step (the second and third together read 2-9% slower than the window's on four H100s) and broadcasts it once,
before the window starts.

One run a process: NCCL's communicators are not started a second time in a process that destroyed its
group (the second seed of one ``calibrate.py`` call crashed on the card), so calibrate one seed a call.

Everything else is ``train.py``'s: the first ``checked_steps`` steps run in set-up and are followed by the
reference on rank 0's card, here as the mean over the ranks' shards (``reference/arpdt_dp.py``); the window's
``train_step_ms`` and its work are rank 0's.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import arpdt_dp
from ..trace import window_marker
from . import train

ROOT = Path(__file__).resolve().parents[2]
START_TIMEOUT_S = 900.0  # the process group's: a rank that never joins fails the run, it does not hang it


class Traffic(train.Traffic):
    def __init__(self, config: dict, params: dict, seed: int, device, fault: str | None = None, rank: int = 0,
                 store: str | None = None):
        from arp_tpu_torch.ops.augment import make_augment_fn
        from arp_tpu_torch.parallel.distributed import initialize
        from arp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, data_share
        from arp_tpu_torch.parallel.prefetch import ThreadedPrefetch, pin_batch
        from arp_tpu_torch.parallel.step import TrainState, make_train_step, shard_train_state
        from arp_tpu_torch.train import common

        ranks = params["ranks"]
        # one intra-op thread a process, as torchrun sets OMP_NUM_THREADS=1 for several processes on one host
        torch.set_num_threads(1)
        self.rank, self.workers, self.store_dir = rank, [], None
        if rank == 0:
            self.store_dir = tempfile.mkdtemp(prefix="portbench_dp_")
            store = os.path.join(self.store_dir, "store")
            self.workers = [_start_rank(r, config, params, seed, device, fault, store) for r in range(1, ranks)]
            threading.Thread(target=_watch_ranks, args=(self.workers,), daemon=True).start()
        if device.type == "cuda":
            device = torch.device("cuda", rank)
        initialize(init_method=f"file://{store}", num_processes=ranks, process_id=rank, device=device,
                   timeout_s=START_TIMEOUT_S)
        mesh = create_mesh(MeshConfig(dp=ranks), device)

        self.config, self.params, self.seed, self.device = config, params, seed, device
        fl = train.flags(config, params)
        self.steps_per_epoch = params["steps_per_epoch"]
        self.total = self.steps_per_epoch * fl.epochs
        self.warmup = min(int(fl.warmup_epochs * self.steps_per_epoch), self.total - 1)
        schedule = common.build_lr_schedule(fl, self.steps_per_epoch, self.total)
        b, checked = params["batch"], params["checked_steps"]
        pool = train.host_pool(config, {**params, "batch": b * ranks}, seed, device)
        self.pool = {k: np.ascontiguousarray(v[:, rank * b:(rank + 1) * b]) for k, v in pool.items()}
        self.global_pool = {k: v[:checked] for k, v in pool.items()} if rank == 0 else None
        del pool
        model, self.trained, frozen, trained = train.build_policy(fl, config, params, seed, device,
                                                                  train.host_batch(self.pool, 0))
        self.initial = {**frozen, **trained} if rank == 0 else None
        del frozen, trained
        state = TrainState.create(model, common.build_optimizer(fl, schedule, model))
        self.first_step = params["first_step"]
        state.step = state.opt_state.count = self.first_step
        state = shard_train_state(state, mesh)
        augment = make_augment_fn(fl.data.augmentations, image_size=config["image_size"],
                                  source_size=config["image_size"])
        loss_fn = common.make_loss_fn(model, augment, config["image_size"], False, share=data_share(mesh))
        if fault == "half_batch":
            loss_fn = train._half_batch(loss_fn)
        self.model, self.state = model, state
        self.step = make_train_step(loss_fn, mesh=mesh, weight_decay=0.0, learning_rate_fn=schedule)
        k = params["pool_batches"]
        self.feed = ThreadedPrefetch((pin_batch(train.host_batch(self.pool, i % k), device.type == "cuda")
                                      for i in itertools.count()), capacity=2)
        self.losses = []
        self.first_mu = self.after = None
        for i in range(checked):
            if i == checked - 1:  # the last checked step, timed: the window's steps are worked out from it
                self._sync()
                start = time.perf_counter()
            self._one()
            if i == 0:
                self.first_mu = {n: m.detach().clone() for n, m in zip(self.trained, state.opt_state.mu)}
        self._sync()
        self.step_s = time.perf_counter() - start
        self.after = {n: p.detach().clone() for n, p in state.params}
        if fault == "unchanged" and rank == 0:
            for n, v in self.after.items():
                v.copy_(self.initial[n])
        self.checked = [float(v) for v in self.losses]
        self.losses = []
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _steps(self, seconds: float | None = None) -> int:
        """The window's number of steps, the same on every rank: rank 0's ``seconds`` over its last checked
        step's time, broadcast once (the only collective besides the step's own)."""
        import torch.distributed as dist

        n = torch.tensor([max(1, round(seconds / self.step_s)) if self.rank == 0 else 0], device=self.device)
        dist.broadcast(n, src=0)
        return int(n.item())

    def window(self, seconds: float, prof=None) -> dict:
        n = self._steps(seconds)
        with window_marker(prof):
            start = time.perf_counter()
            for _ in range(n):
                self._one()
            self._sync()
            elapsed = time.perf_counter() - start
        out = super().window(0.0)  # takes no step: the record and work of the ``n`` steps taken above
        out["metrics"]["train_step_ms"] = 1e3 * elapsed / n
        return out

    def follow(self) -> None:
        """A rank above 0: the window's steps, alongside rank 0's."""
        for _ in range(self._steps()):
            self._one()
        self._sync()

    def close(self) -> None:
        """Leave the process group; rank 0 then waits for the other ranks' exit."""
        import torch.distributed as dist

        self.feed.close()
        dist.destroy_process_group()
        for w in self.workers:
            w.wait(timeout=120)
            w.finished = True
        if self.store_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)

    def release(self) -> None:
        self.close()
        super().release()

    def _reference(self, tf32: bool = False) -> dict:
        c = dict(self.config, warmup_steps=self.warmup, total_steps=self.total)
        n = self.params["checked_steps"]
        batches = [{k: self.global_pool[k][i] for k in ("image", "rtg", "action")} for i in range(n)]
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return arpdt_dp.train_steps(self.initial, self.trained, batches, c, self.seed, self.first_step,
                                        self.device, self.params["ranks"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before


def _start_rank(rank: int, config: dict, params: dict, seed: int, device, fault, store: str) -> subprocess.Popen:
    """Rank ``rank`` as a child process of this one, its output on this one's standard error."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    cmd = [sys.executable, "-m", "portbench.traffic.train_dp", "--rank", str(rank), "--store", store,
           "--seed", str(seed), "--device", device.type, "--fault", fault or "",
           "--config", json.dumps(config), "--params", json.dumps(params)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=sys.stderr.fileno(), stderr=sys.stderr.fileno())
    proc.rank, proc.finished = rank, False
    return proc


def _watch_ranks(workers: list) -> None:
    """Rank 0's watch: a rank that exits before ``close`` has waited for it ends this process too, at once,
    rather than leave it waiting in a collective the rank will never join."""
    while not all(w.finished for w in workers):
        for w in workers:
            code = w.poll()
            if code is not None and not w.finished and code != 0:
                print(f"portbench.train_dp: rank {w.rank} exited with {code}", file=sys.stderr, flush=True)
                os._exit(1)
        time.sleep(0.5)


def _watch_parent() -> None:
    """A rank above 0 ends when the process that started it has gone."""
    parent = os.getppid()
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one rank above 0 of the data-parallel train cell")
    for name in ("--rank", "--seed"):
        parser.add_argument(name, type=int, required=True)
    for name in ("--store", "--device", "--fault", "--config", "--params"):
        parser.add_argument(name, required=True)
    args = parser.parse_args(argv)
    from .. import run

    run.set_cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threading.Thread(target=_watch_parent, daemon=True).start()
    traffic = Traffic(json.loads(args.config), json.loads(args.params), args.seed, torch.device(args.device),
                      fault=args.fault or None, rank=args.rank, store=args.store)
    traffic.follow()
    traffic.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
