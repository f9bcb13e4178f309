"""Policy inference server: ``python -m arp_tpu_torch.serve`` (port of arp_tpu/serve.py).

Loads a trained policy checkpoint, keeps a per-session sliding window
(observations, actions, return-to-go), and serves greedy actions over HTTP.
Observation preprocessing and the policy forward run batched on the device
(``--device``, CUDA unless the caller asks for the CPU); the HTTP layer is a
thin stdlib server.

API (JSON over HTTP):
  POST /v1/session            {"return_to_go": float, "scale": float} -> {"session_id"}
  POST /v1/act                {"session_id", "observation": [[...]] uint8 HWC,
                               "reward": float (optional, decrements rtg)}
                              -> {"action": int, "rtg": float}
  POST /v1/session/close      {"session_id"} -> {}
  POST /v1/reload             {} -> {"status": "reloaded", "step": n}
  GET  /v1/health             -> {"status": "ok", "sessions": N}

Checkpoints are the port's own: ``step_<n>.pt`` files in ``--checkpoint_dir``,
each the policy's trained state dict and its step (``checkpoint.py`` owns the format;
:func:`save_policy_state` and :func:`load_policy_state` are its).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from .checkpoint import latest_step, load_policy_state, save_policy_state  # noqa: F401 (the server's API)


class UnknownSession(Exception):
    """Raised for an expired/invalid session_id (-> HTTP 410, not 400)."""

    def __init__(self, sid):
        super().__init__(f"unknown or expired session {sid!r}")


class PolicySession:
    """Sliding-window state for one rollout episode."""

    def __init__(self, window_size: int, return_to_go: float, scale: float):
        self.window_size = window_size
        self.scale = scale
        self.rtg = return_to_go / scale
        self.obs_window: list = []
        self.act_window: list = []
        self.rtg_window: list = []
        self.lock = threading.Lock()

    def push(self, obs: np.ndarray, reward: Optional[float]):
        if reward is not None:
            self.rtg -= reward / self.scale
        self.obs_window.append(obs)
        self.rtg_window.append(self.rtg)
        if len(self.obs_window) > self.window_size:
            self.obs_window.pop(0)
            self.rtg_window.pop(0)
            if self.act_window:
                self.act_window.pop(0)

    def record_action(self, action: int):
        self.act_window.append(action)

    def inputs(self):
        w = len(self.obs_window)
        acts = (self.act_window + [0] * w)[:w]
        return {
            "image": {"ob": np.stack(self.obs_window)[None]},
            "rtg": {"ob": np.asarray(self.rtg_window, np.float32)[None, :, None]},
            "action": np.asarray(acts, np.int32)[None],
            "instruct": None,
            "text_padding_mask": None,
        }


def tree_leaves(tree) -> list:
    """The array leaves of nested dicts, in key-insertion order; ``None`` nodes hold none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in tree_leaves(value)]
    return [tree]


def tree_map(fn: Callable, *trees):
    """``fn`` over the matching leaves of same-shaped trees of nested dicts; ``None`` nodes pass through."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {key: tree_map(fn, *[t[key] for t in trees]) for key in first}
    return fn(*trees)


def to_host(out) -> np.ndarray:
    """A policy_fn's or transform's result (tensor or array) as a numpy array on the host."""
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


class _MicroBatcher:
    """Groups concurrent /act requests into one device forward.

    The device wants batches, HTTP delivers singles.  Handler threads submit
    their ``(1, w, ...)`` inputs and block; a dispatcher thread collects
    whatever arrived within ``max_wait_ms`` (up to ``max_batch``), groups by
    window length w, stacks along the batch dim, pads to the next
    power-of-two bucket (a bounded set of shapes: |w| x |buckets|, all of
    which ``warmup`` touches), and scatters the greedy actions back.
    Per-sample attention makes the batched forward equal the individual
    forwards.
    """

    def __init__(self, policy_fn: Callable, max_batch: int = 8, max_wait_ms: float = 2.0):
        self.policy_fn = policy_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.dispatches = 0  # observability: forwards issued (vs requests served)
        self.batched_requests = 0  # requests served through those forwards
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        threading.Thread(target=self._loop, daemon=True).start()

    def stats(self) -> dict:
        d = max(self.dispatches, 1)
        return {
            "dispatches": self.dispatches,
            "batched_requests": self.batched_requests,
            "mean_batch_occupancy": round(self.batched_requests / d, 2),
        }

    @staticmethod
    def _signature(inputs: dict):
        """Full leaf-shape signature: only identically-shaped requests batch
        together, so one client's mismatched observation cannot poison a
        group of well-formed ones (it fails alone in its own dispatch)."""
        return tuple(np.shape(leaf) for leaf in tree_leaves(inputs))

    def submit(self, inputs: dict) -> int:
        item = {
            "inputs": inputs,
            "sig": self._signature(inputs),
            "done": threading.Event(),
            "result": None,
            "error": None,
        }
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                # collection window: wait out max_wait, but dispatch as soon
                # as a full group of the head request's signature is queued
                sig0 = self._queue[0]["sig"]
                deadline = time.monotonic() + self.max_wait
                while (
                    sum(it["sig"] == sig0 for it in self._queue) < self.max_batch
                    and (remaining := deadline - time.monotonic()) > 0
                ):
                    self._cv.wait(timeout=remaining)
                take, rest = [], []
                for it in self._queue:
                    if it["sig"] == sig0 and len(take) < self.max_batch:
                        take.append(it)
                    else:
                        rest.append(it)
                self._queue = rest
            try:
                actions = self._run(take)
                for it, a in zip(take, actions):
                    it["result"] = int(a)
            except Exception as e:  # propagate to every waiting handler
                for it in take:
                    it["error"] = e
            for it in take:
                it["done"].set()

    def _run(self, items: list) -> np.ndarray:
        n = len(items)
        bucket = 1 << (n - 1).bit_length()

        def stack(*leaves):
            # pad rows (repeats of the last request) are discarded below
            return np.concatenate(list(leaves) + [leaves[-1]] * (bucket - n), axis=0)

        batched = tree_map(stack, *[it["inputs"] for it in items])
        self.dispatches += 1
        self.batched_requests += n
        return to_host(self.policy_fn(batched))[:n]


class PolicyServer:
    def __init__(
        self,
        policy_fn: Callable,
        transform_obs_fn: Optional[Callable] = None,
        window_size: int = 4,
        default_return_to_go: float = 100.0,
        default_scale: float = 100.0,
        max_batch: int = 1,
        batch_wait_ms: float = 2.0,
        reload_fn: Optional[Callable] = None,
    ):
        self.policy_fn = policy_fn
        self.transform_obs_fn = transform_obs_fn
        self.window_size = window_size
        self.default_return_to_go = default_return_to_go
        self.default_scale = default_scale
        self.sessions: dict[str, PolicySession] = {}
        self._lock = threading.Lock()
        # hot reload: () -> meta dict; swaps the weights policy_fn reads
        # (one reference assignment: in-flight forwards use old or new, both valid)
        self.reload_fn = reload_fn
        self.reload_meta: dict = {}
        # max_batch > 1: concurrent sessions' forwards coalesce on the device
        self._batcher = _MicroBatcher(policy_fn, max_batch, batch_wait_ms) if max_batch > 1 else None

    # -- handlers --------------------------------------------------------------

    def create_session(self, body: dict) -> dict:
        sid = uuid.uuid4().hex[:16]
        with self._lock:
            self.sessions[sid] = PolicySession(
                self.window_size,
                float(body.get("return_to_go", self.default_return_to_go)),
                float(body.get("scale", self.default_scale)),
            )
        return {"session_id": sid}

    def act(self, body: dict) -> dict:
        sid = body["session_id"]
        session = self.sessions.get(sid)
        if session is None:
            raise UnknownSession(sid)
        obs = np.asarray(body["observation"], np.uint8)
        if self.transform_obs_fn is not None:
            obs = to_host(self.transform_obs_fn(obs))
        with session.lock:
            session.push(obs, body.get("reward"))
            inputs = session.inputs()
            if self._batcher is not None:
                action = self._batcher.submit(inputs)
            else:
                action = int(to_host(self.policy_fn(inputs))[0])
            session.record_action(action)
            return {"action": action, "rtg": float(session.rtg * session.scale)}

    def close_session(self, body: dict) -> dict:
        with self._lock:
            self.sessions.pop(body["session_id"], None)
        return {}

    def warmup(self, obs: np.ndarray) -> list:
        """Run every (window length, batch bucket) shape a live session can hit,
        so no request pays for a first use: on CUDA the first forward builds the
        kernels with nvcc, and each new shape sets up its own library plans.

        ``obs`` must be one POST-transform observation, exactly what
        ``PolicySession.push`` stores.  Returns the list of warmed (window,
        bucket) pairs.  Sessions ramp w = 1..window_size as the window fills,
        and the micro-batcher pads groups to power-of-two buckets: the product
        is the complete signature set.
        """
        obs = to_host(obs)
        buckets = [1]
        if self._batcher is not None:
            while buckets[-1] < self._batcher.max_batch:
                buckets.append(buckets[-1] * 2)
        warmed = []
        for w in range(1, self.window_size + 1):
            for b in buckets:
                inputs = {
                    "image": {"ob": np.broadcast_to(obs, (b, w) + obs.shape).copy()},
                    "rtg": {"ob": np.zeros((b, w, 1), np.float32)},
                    "action": np.zeros((b, w), np.int32),
                    "instruct": None,
                    "text_padding_mask": None,
                }
                to_host(self.policy_fn(inputs))
                warmed.append((w, b))
        return warmed

    def reload(self, body: dict) -> dict:
        """POST /v1/reload: pick up newer weights (the latest checkpoint)
        without restarting or dropping sessions."""
        if self.reload_fn is None:
            raise ValueError("server was started without a reload_fn")
        meta = self.reload_fn() or {}
        self.reload_meta = meta
        return {"status": "reloaded", **meta}

    def health(self) -> dict:
        out = {"status": "ok", "sessions": len(self.sessions)}
        if self.reload_meta:
            out["checkpoint"] = self.reload_meta
        if self._batcher is not None:
            out["batching"] = self._batcher.stats()
        return out

    # -- http --------------------------------------------------------------

    def make_http_server(self, host: str = "127.0.0.1", port: int = 8787) -> ThreadingHTTPServer:
        return make_json_http_server(
            get_routes={"/v1/health": self.health},
            post_routes={
                "/v1/session": self.create_session,
                "/v1/act": self.act,
                "/v1/session/close": self.close_session,
                "/v1/reload": self.reload,
            },
            host=host,
            port=port,
        )


def make_json_http_server(
    get_routes: dict,
    post_routes: dict,
    host: str = "127.0.0.1",
    port: int = 8787,
    raw_post_routes: Optional[dict] = None,
) -> ThreadingHTTPServer:
    """Thin stdlib JSON-over-HTTP front: path -> handler(body) dicts, uniform
    error mapping (UnknownSession -> 410, missing field -> 400, anything else
    -> 500).

    ``raw_post_routes`` handlers receive ``(headers, body_bytes)`` with the
    request body unparsed, for large binary payloads.  They still reply JSON.
    """
    raw_routes = raw_post_routes or {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, payload: dict):
            raw = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            fn = get_routes.get(self.path)
            if fn is None:
                self._reply(404, {"error": "not found"})
            else:
                self._reply(200, fn())

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            raw_fn = raw_routes.get(self.path)
            fn = post_routes.get(self.path)
            try:
                data = self.rfile.read(length)
                if raw_fn is not None:
                    self._reply(200, raw_fn(self.headers, data))
                elif fn is None:
                    self._reply(404, {"error": "not found"})
                else:
                    self._reply(200, fn(json.loads(data or b"{}")))
            except UnknownSession as e:
                self._reply(410, {"error": str(e)})
            except KeyError as e:
                self._reply(400, {"error": f"missing field {e}"})
            except ValueError as e:  # malformed payload (bad shapes/bytes/json)
                self._reply(400, {"error": str(e)})
            except Exception as e:  # surface errors to the client
                self._reply(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


# -- checkpoints: checkpoint.py owns the step_<n>.pt format ---------------------------------


def reloadable_policy(model, checkpoint_dir: str) -> tuple[Callable, Callable]:
    """(policy_fn, load_latest) over ``model``: ``policy_fn(inputs)`` gives the greedy
    actions under ``torch.inference_mode()``; ``load_latest()`` swaps in the weights of the
    newest ``step_<n>.pt`` of ``checkpoint_dir`` and returns ``{"step": n}``.

    The swap is one reference assignment of a new module that shares the frozen tower
    (``clone_sharing_frozen``): in-flight forwards see old or new weights, both valid.
    A failed restore is LOUD (it raises): serving random weights behind HTTP 200 is a
    production incident.  The directory is listed anew on every call: the point of
    /v1/reload is steps written AFTER the server came up.
    """
    holder = {"model": model}

    def policy_fn(inputs):
        with torch.inference_mode():
            return holder["model"].greedy_action(inputs)

    def load_latest() -> dict:
        state, meta = load_policy_state(checkpoint_dir)
        new = holder["model"].clone_sharing_frozen()
        new.load_trained_state_dict(state)
        holder["model"] = new
        print(f"restored checkpoint step={meta.get('step')} from {checkpoint_dir}")
        return {"step": meta.get("step")}

    return policy_fn, load_latest


def main():
    import argparse

    from .device import resolve_device
    from .models.policy import ARPDT
    from .ops.augment import make_eval_transform

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--allow_random_init", action="store_true",
                        help="serve a random-init policy when no checkpoint exists (tests/demos)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--window_size", type=int, default=4)
    parser.add_argument("--max_batch", type=int, default=1,
                        help=">1 coalesces concurrent sessions' /act forwards into "
                             "one device batch (adds the collection window's latency)")
    parser.add_argument("--warmup", action="store_true",
                        help="run all (window, batch-bucket) shapes before accepting requests: "
                             "no /act pays for a kernel build or a first use")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--emb_dim", type=int, default=128)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--num_heads", type=int, default=8)
    parser.add_argument("--transfer_type", default="none")
    parser.add_argument("--model_type", default="vit_base")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    device = resolve_device(args.device)

    model = ARPDT(
        config_updates=dict(
            model_type=args.model_type,
            transfer_type=args.transfer_type,
            emb_dim=args.emb_dim,
            depth=args.depth,
            num_heads=args.num_heads,
            use_discrete_action=True,
        ),
        num_actions=15,
        patch_dim=16,
    ).to(device)
    # one forward gives the lazy layers their shapes, as a template for the restore
    dummy = {
        "image": {"ob": np.zeros((1, args.window_size, args.image_size, args.image_size, 3), np.float32)},
        "rtg": {"ob": np.zeros((1, args.window_size, 1), np.float32)},
        "action": np.zeros((1, args.window_size), np.int32),
        "instruct": None,
        "text_padding_mask": None,
    }
    with torch.no_grad():
        model(dummy, deterministic=True)
    policy_fn, load_latest = reloadable_policy(model, args.checkpoint_dir)
    del model  # after a restore, only the policy_fn's holder names the served weights

    initial_meta = {}
    if args.allow_random_init and latest_step(args.checkpoint_dir) is None:
        print("[WARN] no checkpoint found; serving random-init policy (--allow_random_init)")
    else:
        initial_meta = load_latest()

    transform = make_eval_transform(image_size=args.image_size, device=device)
    server = PolicyServer(
        policy_fn=policy_fn,
        transform_obs_fn=transform,
        window_size=args.window_size,
        max_batch=args.max_batch,
        reload_fn=load_latest,
    )
    server.reload_meta = initial_meta
    if args.warmup:
        t0 = time.time()
        warmed = server.warmup(transform(np.zeros((args.image_size, args.image_size, 3), np.uint8)))
        print(f"warmed {len(warmed)} (window, bucket) shapes in {time.time()-t0:.1f}s")
    httpd = server.make_http_server(args.host, args.port)
    print(f"serving policy on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
