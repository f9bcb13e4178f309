"""The port's host spans and counters (arp_tpu_torch/profiling.py and the layers that record them): nothing is
recorded without a profiler; under one, spans nest, cross the engine's producer thread with their parent and
share their root's trace id; they land on the profiler's clock; the engine counts its padding (none without a
mesh); a lockstep step's
four children cover it; ``Trace`` writes the spans into its Chrome trace; the reward server counts its requests,
its text cache and its lock."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from arp_tpu_torch.envs.fake import FakeProcgen
from arp_tpu_torch.envs.rollout import parallel_rollout
from arp_tpu_torch.models.clip.model import CLIP
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.profiling import Trace, clear_spans, span, spans, spans_on_profiler_clock
from arp_tpu_torch.reward.engine import ClipRewardEngine
from arp_tpu_torch.reward.serve import RewardServer

TINY_CLIP = dict(vocab_size=100, embed_dim=16, text_features=32, text_num_layers=1, text_num_heads=2,
                 vision_features=64, vision_num_layers=1, vision_patch_size=8, image_size=16)


@pytest.fixture(autouse=True)
def _empty_ring():
    clear_spans()
    yield
    clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tiny_engine(batch_size: int) -> ClipRewardEngine:
    torch.manual_seed(0)
    return ClipRewardEngine(model=CLIP(**TINY_CLIP), batch_size=batch_size, tokenizer=Char97Tokenizer(),
                            device="cpu")


def frames(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 24, 24, 3), np.uint8)


def by_name(recorded) -> dict:
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_is_recorded_without_a_profiler():
    engine = tiny_engine(8)
    with span("outer") as outer:
        assert not outer  # so a caller sets no attributes
        engine.text_rewards_with_features(frames(3), np.ones((1, 16), np.float32) / 4)
    assert spans() == [] and span("x") is span("y")
    assert (engine.frames_real, engine.frames_padded, engine.batches) == (3, 0, 1)  # counters are always on


def test_spans_nest_cross_the_producer_thread_and_share_the_trace_id():
    """10 frames at batch 64, one device batch of 10 rows: one ``engine.images`` span with its counts (nothing
    padded); the producer thread's host stage is
    its child, as are the wait, the encode and the fetch; the engine call nests under the caller's span."""
    engine = tiny_engine(64)
    txt = engine.encode_text_features("collect the coin")
    with cpu_profile():
        with span("caller") as caller:
            caller.set(kind="test")
            rewards = engine.text_rewards_with_features(frames(10), txt)
    assert rewards.shape == (10,)
    got = by_name(spans())
    (images,) = got["engine.images"]
    assert images.attrs == {"frames": 10, "padded": 0}
    assert (engine.frames_real, engine.frames_padded, engine.batches, engine.text_encodes) == (10, 0, 1, 1)
    (root,) = got["caller"]
    assert root.parent_id is None and root.trace_id == root.span_id and root.attrs == {"kind": "test"}
    assert images.parent_id == caller.span_id
    (stage,) = got["engine.host_stage"]
    assert stage.thread_id != images.thread_id
    for name in ("engine.host_stage", "engine.host_wait", "engine.encode", "engine.fetch", "engine.score"):
        (s,) = got[name]
        assert s.parent_id == (root.span_id if name == "engine.score" else images.span_id), name
        assert images.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, name
    assert {s.trace_id for s in spans()} == {root.span_id}


def test_spans_land_on_the_profiler_clock():
    with cpu_profile() as prof:
        with span("around"):
            with record_function("probe"):
                torch.ones(64).sum()
    probe = next(e for e in prof.events() if e.name == "probe")
    ((around, start_us, end_us),) = spans_on_profiler_clock(prof.profiler.kineto_results.trace_start_ns())
    assert around.name == "around"
    assert abs(start_us - probe.time_range.start) < 2000
    assert abs(end_us - probe.time_range.end) < 2000
    # the span holds the probe, within what the two clocks' conversion may blur (kineto's stamps are whole µs)
    assert start_us <= probe.time_range.start + 50 and probe.time_range.end <= end_us + 50


def test_a_lockstep_step_is_covered_by_its_four_children():
    engine = tiny_engine(8)
    envs = [FakeProcgen("coinrun", {"episode_length": 4, "image_size": 32, "grid": 4}) for _ in range(3)]
    with cpu_profile():
        parallel_rollout(0, envs, lambda inputs, rngs: torch.zeros(3, dtype=torch.int64), episode_length=4,
                         window_size=2, reward_engine=engine, text="collect the coin", device="cpu")
    recorded = spans()
    got = by_name(recorded)
    steps = got["rollout.step"]
    assert len(steps) == 4 and all(s.parent_id is None for s in steps)
    children = [s for s in recorded if s.parent_id in {st.span_id for st in steps}]
    assert {c.name for c in children} == {"rollout.policy", "rollout.reward", "rollout.env", "rollout.push"}
    assert len(children) == 4 * len(steps)
    step_ns = sum(s.end_ns - s.start_ns for s in steps)
    assert sum(c.end_ns - c.start_ns for c in children) >= 0.95 * step_ns
    rewards = {s.span_id for s in got["rollout.reward"]}
    images = [s for s in got["engine.images"] if s.parent_id in rewards]
    assert len(images) == 4 and all(s.attrs == {"frames": 3, "padded": 0} for s in images)


def test_trace_writes_the_host_spans_into_its_chrome_trace(tmp_path):
    tracer = Trace(str(tmp_path))
    with span("before"):  # no profiler yet: not recorded
        pass
    tracer.start()
    with span("train.step") as step_span:
        step_span.set(step=3)
        with span("train.forward"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    path = tracer.stop()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("cat") == "host_span"]
    assert sorted(e["name"] for e in host) == ["train.forward", "train.step"]
    assert all(e["ph"] == "X" and e["pid"] == os.getpid() for e in host)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "host_span"]
    lo, hi = min(e["ts"] for e in ops), max(e["ts"] + e["dur"] for e in ops)
    step = next(e for e in host if e["name"] == "train.step")
    assert lo <= step["ts"] and step["ts"] + step["dur"] <= hi and step["args"]["step"] == 3
    matmul = [e for e in ops if e["name"] == "aten::mm"]
    assert matmul and step["ts"] <= matmul[0]["ts"] <= step["ts"] + step["dur"]
    names = [e for e in events if e.get("ph") == "M" and e["tid"] == host[0]["tid"]]
    assert names and names[0]["args"]["name"].startswith("host spans")


def test_reward_server_counts_requests_cache_and_lock():
    engine = tiny_engine(8)
    server = RewardServer(engine)
    raw = frames(5).tobytes()
    headers = {"X-Frames-Shape": "5,24,24,3", "X-Text": "collect the coin"}
    with cpu_profile():
        first = server.text_rewards_raw(headers, raw)
        second = server.text_rewards_raw(headers, raw)
        server.goal_rewards({"frames": frames(3).tolist()})
    assert first == second
    health = server.health()
    assert health["frames_served"] == 13 and health["busy_seconds"] >= 0 and health["mean_fps"] > 0
    counters = {"requests": 3, "text_cache_hits": 1, "text_cache_misses": 1, "frames_real": 5 + 5 + 3,
                "frames_padded": 0, "batches": 3, "text_encodes": 1}
    assert {k: health[k] for k in counters} == counters
    assert health["lock_wait_seconds"] >= 0
    got = by_name(spans())
    requests = got["serve.request"]
    assert [r.attrs for r in requests] == [{"route": "text_raw", "frames": 5}, {"route": "text_raw", "frames": 5},
                                           {"route": "goal", "frames": 3}]
    ids = {r.span_id for r in requests}
    for name in ("serve.decode", "serve.lock_wait", "serve.engine"):
        assert len(got[name]) == 3 and {s.parent_id for s in got[name]} <= ids, name
    engine_spans = {s.span_id for s in got["serve.engine"]}
    assert {s.parent_id for s in got["engine.images"]} <= engine_spans and len(got["engine.images"]) == 3
    assert len(got["engine.text"]) == 1  # the second request found the text cached
