"""Reward inference server — ``python -m arp_tpu_torch.reward.serve`` (port of arp_tpu/reward/serve.py).

Serves the batched CLIP reward engine over HTTP, so that CPU rollout fleets
get multimodal rewards from one card: the serving counterpart of the offline
labeler.  The engine runs on ``--device`` (the card unless the caller asks for
the CPU) behind the port's stdlib JSON front (``serve.make_json_http_server``).

API (JSON over HTTP):
  POST /v1/reward/text  {"frames": [[...]] uint8 (N,H,W,C), "text": str | [str]}
                        -> {"rewards": [N floats]}
                        logit_scale * cos(f_img, f_text), averaged over texts;
                        text features are cached per distinct text (and its
                        type: "a" and ["a"] are two entries) in a 256-entry LRU.
  POST /v1/reward/goal  {"frames": ..., "goal": [[...]] uint8 (H,W,C) optional}
                        -> {"rewards": [N floats]}
                        -||f_img - f_goal||_2 on unnormalized features; the
                        goal defaults to the last frame.
  GET  /v1/health       -> {"status": "ok", "engine": ..., "batch_size": N,
                            "cached_texts", "frames_served", "busy_seconds", "mean_fps",
                            "requests", "text_cache_hits", "text_cache_misses",
                            "lock_wait_seconds", "frames_real", "frames_padded", "batches",
                            "text_encodes", "tower_seconds"}
                        counts since the start: requests that reached the engine, text features
                        found in or missing from the cache, seconds requests
                        waited for the engine's lock; and the engine's own: frames
                        it encoded, frames it added as padding (0: every device batch
                        runs at its own size), device batches it ran, text encodes
                        (the warm-up's included), and the image tower's seconds (on
                        the card its device time, from CUDA events).

Under a ``torch.profiler`` each request records host spans
(``arp_tpu_torch.profiling``): ``serve.request`` (route, frames) over
``serve.decode``, ``serve.lock_wait`` and ``serve.engine`` (everything under
the lock), and the engine's own spans below that.

Frame wire formats, cheapest first:
  * raw binary: POST ``/v1/reward/text_raw`` / ``/v1/reward/goal_raw`` with
    the uint8 frame bytes as the body and headers ``X-Frames-Shape:
    "N,H,W,C"``, ``X-Text: <percent-encoded UTF-8 instruction>`` (text) or
    an optional ``X-Goal-Shape`` with the goal's bytes after the frames
    (goal); a body whose length the shapes do not give is a 400;
  * base64 JSON: ``{"frames_b64": base64(arr.tobytes()), "frames_shape":
    [N,H,W,C]}`` (the same for ``goal_b64`` / ``goal_shape``);
  * nested JSON lists.
"""

from __future__ import annotations

import base64
import contextlib
import json
import threading
import time
from collections import OrderedDict
from urllib.parse import unquote

import numpy as np

from ..profiling import span
from ..serve import make_json_http_server


def _decode_frames(body: dict, key: str):
    """uint8 array from JSON lists (``key``) or base64 raw bytes (``key_b64`` + ``key_shape``);
    None if neither field is present."""
    b64 = body.get(f"{key}_b64")
    if b64 is not None:
        arr = np.frombuffer(base64.b64decode(b64), np.uint8)
        return arr.reshape(body[f"{key}_shape"])
    if body.get(key) is not None:
        return np.asarray(body[key], np.uint8)
    return None


class RewardServer:
    """HTTP front over a ``ClipRewardEngine`` (or the ``ClipFtRewardEngine`` subclass).

    One engine serves every request; a lock serializes the encodes (concurrent batches would
    contend for the same card anyway).
    """

    MAX_CACHED_TEXTS = 256  # LRU bound: a long-lived server fed per-episode instructions must not grow

    def __init__(self, engine):
        self.engine = engine
        self._text_feats: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.frames_served = 0
        self.busy_seconds = 0.0
        # counted under the lock, as the two above
        self.requests = self.text_cache_hits = self.text_cache_misses = 0
        self.lock_wait_seconds = 0.0

    @contextlib.contextmanager
    def _engine_locked(self):
        """The engine's lock for one request, the wait for it counted."""
        with span("serve.lock_wait"):
            t0 = time.perf_counter()
            self._lock.acquire()
            waited = time.perf_counter() - t0
        try:
            self.lock_wait_seconds += waited
            self.requests += 1
            with span("serve.engine"):
                yield
        finally:
            self._lock.release()

    def _text_rewards(self, frames: np.ndarray, text) -> dict:
        # a type-prefixed key: the string '["go"]' and the list ["go"] are different texts
        key = "list:" + json.dumps(list(text)) if isinstance(text, (list, tuple)) else "str:" + str(text)
        with self._engine_locked():
            feat = self._text_feats.get(key)
            if feat is None:
                self.text_cache_misses += 1
                feat = self.engine.encode_text_features(text)
                self._text_feats[key] = feat
                if len(self._text_feats) > self.MAX_CACHED_TEXTS:
                    self._text_feats.popitem(last=False)
            else:
                self.text_cache_hits += 1
                self._text_feats.move_to_end(key)
            t0 = time.monotonic()
            rewards = self.engine.text_rewards_with_features(frames, feat)
            self.busy_seconds += time.monotonic() - t0
            self.frames_served += len(frames)
        return {"rewards": np.asarray(rewards, np.float32).tolist()}

    def warmup(self, frames: np.ndarray) -> None:
        """Run the image and text towers once before serving; under ``fast_int8`` this is the batch
        that calibrates the static activation scales for every later request, so ``frames`` must be
        real observations there."""
        self.engine.encode_image_features(np.asarray(frames))
        self.engine.encode_text_features("warmup")

    def _goal_rewards(self, frames: np.ndarray, goal) -> dict:
        with self._engine_locked():
            t0 = time.monotonic()
            if goal is not None:
                rewards = self.engine.goal_rewards_vs(frames, goal)
            else:
                rewards = self.engine.goal_rewards(frames, goal_index=-1)
            self.busy_seconds += time.monotonic() - t0
            self.frames_served += len(frames)
        return {"rewards": np.asarray(rewards, np.float32).tolist()}

    def text_rewards(self, body: dict) -> dict:
        with span("serve.request") as request:
            with span("serve.decode"):
                frames = _decode_frames(body, "frames")
            if frames is None:
                raise KeyError("frames")
            if request:
                request.set(route="text", frames=len(frames))
            return self._text_rewards(frames, body["text"])

    def goal_rewards(self, body: dict) -> dict:
        with span("serve.request") as request:
            with span("serve.decode"):
                frames = _decode_frames(body, "frames")
                if frames is None:
                    raise KeyError("frames")
                goal = _decode_frames(body, "goal")
            if request:
                request.set(route="goal", frames=len(frames))
            return self._goal_rewards(frames, goal)

    # -- raw binary wire format ------------------------------------------------

    @staticmethod
    def _header_shape(headers, name: str):
        val = headers.get(name)
        if val is None:
            return None
        shape = [int(s) for s in val.split(",")]
        if any(d <= 0 for d in shape):
            # no -1 inference: the byte offsets depend on the exact element count
            raise ValueError(f"{name} must be positive dims, got {val!r}")
        return shape

    def text_rewards_raw(self, headers, data: bytes) -> dict:
        with span("serve.request") as request:
            with span("serve.decode"):
                shape = self._header_shape(headers, "X-Frames-Shape")
                text = headers.get("X-Text")
                if shape is None:
                    raise KeyError("X-Frames-Shape")
                if text is None:
                    raise KeyError("X-Text")
                # HTTP headers are latin-1 on the wire: clients percent-encode the UTF-8 text
                # (urllib.parse.quote); plain ASCII without '%' passes through unchanged
                text = unquote(text, encoding="utf-8")
                frames = np.frombuffer(data, np.uint8).reshape(shape)
            if request:
                request.set(route="text_raw", frames=len(frames))
            return self._text_rewards(frames, text)

    def goal_rewards_raw(self, headers, data: bytes) -> dict:
        with span("serve.request") as request:
            with span("serve.decode"):
                shape = self._header_shape(headers, "X-Frames-Shape")
                if shape is None:
                    raise KeyError("X-Frames-Shape")
                goal_shape = self._header_shape(headers, "X-Goal-Shape")
                n = int(np.prod(shape))
                expected = n + (int(np.prod(goal_shape)) if goal_shape is not None else 0)
                if len(data) != expected:
                    # scoring truncated or shifted frames with a 200 would hide the client's fault
                    raise ValueError(f"body is {len(data)} bytes but the shape headers imply {expected}")
                frames = np.frombuffer(data[:n], np.uint8).reshape(shape)
                goal = None
                if goal_shape is not None:
                    goal = np.frombuffer(data[n:], np.uint8).reshape(goal_shape)
            if request:
                request.set(route="goal_raw", frames=len(frames))
            return self._goal_rewards(frames, goal)

    def health(self) -> dict:
        return {
            "status": "ok",
            "engine": type(self.engine).__name__,
            "batch_size": self.engine.batch_size,
            "cached_texts": len(self._text_feats),
            "frames_served": self.frames_served,
            "busy_seconds": round(self.busy_seconds, 3),
            "mean_fps": round(self.frames_served / max(self.busy_seconds, 1e-9), 1),
            "requests": self.requests,
            "text_cache_hits": self.text_cache_hits,
            "text_cache_misses": self.text_cache_misses,
            "lock_wait_seconds": round(self.lock_wait_seconds, 3),
            "frames_real": self.engine.frames_real,
            "frames_padded": self.engine.frames_padded,
            "batches": self.engine.batches,
            "text_encodes": self.engine.text_encodes,
            "tower_seconds": round(self.engine.tower_seconds, 6),
        }

    def make_http_server(self, host: str = "127.0.0.1", port: int = 8788):
        return make_json_http_server(
            get_routes={"/v1/health": self.health},
            post_routes={"/v1/reward/text": self.text_rewards, "/v1/reward/goal": self.goal_rewards},
            raw_post_routes={"/v1/reward/text_raw": self.text_rewards_raw,
                             "/v1/reward/goal_raw": self.goal_rewards_raw},
            host=host,
            port=port,
        )


def warmup_frames(spec: str, batch_size: int) -> np.ndarray:
    """Up to ``batch_size`` frames of the HDF5 dataset ``path[:dataset]`` (default ``ob``), read
    lazily: of a stacked-window dataset (N, F, H, W, C) only the windows that hold them."""
    import h5py

    path, _, key = spec.partition(":")
    with h5py.File(path, "r") as g:
        ds = g[key or "ob"]
        rows = -(-batch_size // ds.shape[1]) if ds.ndim == 5 else batch_size
        frames = np.asarray(ds[:rows])
    return frames.reshape((-1,) + frames.shape[-3:])[:batch_size]


def main(argv=None):
    import argparse

    import torch

    from .engine import ClipRewardEngine

    parser = argparse.ArgumentParser(description="Serve CLIP rewards over HTTP (PyTorch, one GPU).")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8788)
    parser.add_argument("--model_type", default="clip", help="clip | clip_ft (requires --model_ckpt_dir)")
    parser.add_argument("--model_ckpt_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=64,
                        help="largest device batch; a request's frames run in batches of at most this many")
    parser.add_argument("--resize_mode", default="pil", choices=["pil", "host", "fast"])
    parser.add_argument("--use_crop", type=lambda s: s.lower() in ("1", "true"), default=False)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--fast_int8", action="store_true")
    parser.add_argument("--fast_int8_attn", action=argparse.BooleanOptionalAction, default=None,
                        help="w8a8 attention on the int8 fast path (needs --fast_int8). Unset = the "
                             "engine's default (True under --fast_int8, as in arp_tpu)")
    parser.add_argument("--mesh_dp", type=int, default=0,
                        help="shard encode batches data-parallel over this many local devices of --device "
                             "(-1 = all; 0 = one device, no mesh)")
    parser.add_argument("--warmup", action="store_true",
                        help="run the image and text towers before accepting requests")
    parser.add_argument("--warmup_frames", default=None,
                        help="hdf5 'path[:dataset]' of real frames for --warmup (required with --fast_int8: "
                             "the int8 activation scales calibrate on them)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.warmup and args.fast_int8 and not args.warmup_frames:
        parser.error("--warmup with --fast_int8 needs --warmup_frames (real frames calibrate the int8 "
                     "activation scales; synthetic ones would mis-scale every later request)")
    from ..parallel.mesh import mesh_from_count

    mesh = mesh_from_count(args.mesh_dp, device_type=torch.device(args.device).type)

    fast_kwargs = dict(fast_encode=args.fast, fast_int8=args.fast_int8, fast_int8_attn=args.fast_int8_attn)
    if args.model_type.startswith("clip_ft"):
        if args.model_ckpt_dir is None:
            raise ValueError("clip_ft needs --model_ckpt_dir")
        from ..finetune.reward import ClipFtRewardEngine, load_adapter_params

        engine = ClipFtRewardEngine(adapter_params=load_adapter_params(args.model_ckpt_dir),
                                    batch_size=args.batch_size, use_crop=args.use_crop, device=args.device,
                                    mesh=mesh, **fast_kwargs)
    else:
        engine = ClipRewardEngine(batch_size=args.batch_size, resize_mode=args.resize_mode, use_crop=args.use_crop,
                                  compute_dtype=torch.bfloat16 if args.bf16 else torch.float32, device=args.device,
                                  mesh=mesh, **fast_kwargs)
    server = RewardServer(engine)
    if args.warmup:
        if args.warmup_frames:
            frames = warmup_frames(args.warmup_frames, args.batch_size)
        else:
            frames = np.random.default_rng(0).integers(0, 256, (args.batch_size, 64, 64, 3), np.uint8)
        t0 = time.time()
        server.warmup(frames)
        print(f"warmed the image and text towers on {len(frames)} frames in {time.time() - t0:.1f}s")
    httpd = server.make_http_server(args.host, args.port)
    print(f"serving {type(engine).__name__} rewards on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
