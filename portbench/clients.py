"""Rollout workers of the reward server's cell, in a process of their own (so that they do not share the
server's interpreter lock): ``python3 -m portbench.clients <json>`` with {"url", "seed", "requests",
"frames", "size", "clients", "rate", "seconds", "text"}.

It makes the request pool from the seed (:func:`request_pool`), prints ``ready``, waits for a line on
standard input, then offers load in an open loop: ``clients`` workers, each sending on a fixed schedule
(``rate`` requests a second in all, evenly spaced and interleaved), for ``seconds``.  A worker whose
previous request has not come back sends when it does, late.  Each request is timed from when it was due.
It prints one JSON line: every request's pool index, due, sent and done times (seconds from the start),
HTTP status and rewards.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np


def request_pool(seed: int, requests: int, frames: int, size: int) -> np.ndarray:
    """(requests, frames, size, size, 3) uint8 frames, from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    return rng.integers(0, 256, size=(requests, frames, size, size, 3), dtype=np.uint8)


def order(seed: int, n: int, requests: int) -> np.ndarray:
    """Which pool entry the n scheduled requests send: each entry in turn, in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed), 8])
    return np.concatenate([rng.permutation(requests) for _ in range(-(-n // requests))])[:n]


def post(url: str, frames: np.ndarray, text: str) -> tuple[int, list]:
    req = urllib.request.Request(url + "/v1/reward/text_raw", data=frames.tobytes(), method="POST", headers={
        "X-Frames-Shape": ",".join(str(d) for d in frames.shape), "X-Text": urllib.parse.quote(text),
        "Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())["rewards"]
    except urllib.error.HTTPError as e:
        return e.code, []
    except OSError:
        return 0, []


def main() -> int:
    a = json.loads(sys.argv[1])
    pool = request_pool(a["seed"], a["requests"], a["frames"], a["size"])
    n = int(a["rate"] * a["seconds"])
    which = order(a["seed"], n, a["requests"])
    out = [None] * n
    print("ready", flush=True)
    sys.stdin.readline()
    start = time.perf_counter()

    def worker(c: int) -> None:
        for i in range(c, n, a["clients"]):
            due = i / a["rate"]
            wait = start + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent = time.perf_counter() - start
            status, rewards = post(a["url"], pool[which[i]], a["text"])
            out[i] = {"index": int(which[i]), "due": due, "sent": sent, "done": time.perf_counter() - start,
                      "status": status, "rewards": rewards}

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(a["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
