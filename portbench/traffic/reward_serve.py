"""The reward server: ``RewardServer`` over loopback HTTP in the run's process, the raw binary wire.

Set-up builds the engine (the server's defaults: batch 64, Pillow resize on the card) on weights drawn from
the seed, starts the server on a free port of 127.0.0.1 and the clients' process (portbench/clients.py),
and warms up: the towers once, and one request with the cell's instruction, whose text features the server
then keeps.  The window is the clients' open loop at the cell's fixed rate; every request due in it is
waited for.  ``reward_p95_ms`` is the 95th percentile of all their latencies, each from when it was due; a
request that fails counts with the time until the last one came back.  Every served reward is compared
with the reference's for its frames.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np

from .. import clients
from ..trace import window_marker
from .label import alter_one_answer, build_clip, instruction, reference_rewards


class Traffic:
    def __init__(self, config: dict, params: dict, seed: int, device, fault: str | None = None):
        from arp_tpu_torch.reward.engine import ClipRewardEngine
        from arp_tpu_torch.reward.serve import RewardServer

        self.config, self.params, self.seed, self.device = config, params, seed, device
        self.model, self.state = build_clip(config, seed, device)
        self.engine = ClipRewardEngine(model=self.model, batch_size=params["batch_size"],
                                       resize_mode=params["resize_mode"], device=device)
        if fault == "answer_altered":
            alter_one_answer(self.engine)
        self.server = RewardServer(self.engine)
        self.httpd = self.server.make_http_server("127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.text = instruction(params, seed)
        self.pool = clients.request_pool(seed, params["requests"], params["frames"], params["size"])
        self.server.warmup(self.pool[0])
        status, _ = clients.post(self.url, self.pool[0], self.text)
        if status != 200:
            raise RuntimeError(f"the warm-up request failed with HTTP {status}")
        self.rate = params["rate"]
        self.results = []

    def _clients(self, seconds: float) -> subprocess.Popen:
        p = self.params
        args = {"url": self.url, "seed": self.seed, "requests": p["requests"], "frames": p["frames"],
                "size": p["size"], "clients": p["clients"], "rate": self.rate, "seconds": seconds, "text": self.text}
        proc = subprocess.Popen([sys.executable, "-m", "portbench.clients", json.dumps(args)], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        if proc.stdout.readline().strip() != "ready":
            proc.kill()
            proc.wait()
            raise RuntimeError("the clients' process did not start")
        return proc

    def window(self, seconds: float, prof=None) -> dict:
        proc = self._clients(seconds)
        try:
            busy0 = self.server.busy_seconds
            with window_marker(prof):
                start = time.perf_counter()
                proc.stdin.write("go\n")
                proc.stdin.flush()
                out, _ = proc.communicate(timeout=seconds + 120)
                elapsed = time.perf_counter() - start
            busy = self.server.busy_seconds - busy0
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        self.results = json.loads(out.strip().splitlines()[-1])
        last = max(r["done"] for r in self.results)
        ok = [r["status"] == 200 and len(r["rewards"]) == self.params["frames"] for r in self.results]
        latencies = [r["done"] - r["due"] if good else last - r["due"] for r, good in zip(self.results, ok)]
        lateness = [r["sent"] - r["due"] for r in self.results]
        work = {"engine_busy_s": busy, "elapsed_s": elapsed, "requests": len(self.results),
                "median_ms": 1e3 * float(np.median(latencies)), "late_p95_ms": 1e3 * float(np.percentile(lateness, 95))}
        return {"metrics": {"reward_p95_ms": 1e3 * float(np.percentile(latencies, 95))},
                "attempted": len(self.results), "failed": len(self.results) - sum(ok), "work": work}

    def release(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        del self.engine, self.model, self.server, self.httpd
        gc.collect()

    def _reference(self, tf32: bool = False) -> np.ndarray:
        shape = self.pool.shape
        flat = reference_rewards(self.state, self.config, self.pool.reshape(-1, *shape[2:]), self.text, self.device,
                                 tf32)
        return flat.reshape(shape[:2])

    def compare(self) -> dict:
        want = self._reference()
        gaps = [float(np.max(np.abs(np.asarray(r["rewards"], np.float64) - want[r["index"]])))
                for r in self.results if r["status"] == 200 and len(r["rewards"]) == self.params["frames"]]
        return {"reward_gap": (max(gaps) if gaps else float("inf"), self.params["limits"]["reward_gap"])}

    def control(self) -> dict:
        want, low = self._reference(), self._reference(tf32=True)
        return {"reward_gap": float(np.max(np.abs(low - want)))}

