"""The span metrics' readers on a synthetic span list: each one's value, ``None`` when the program recorded none
of its spans or records no spans at all; and a traced tiny rollout, whose lines carry them."""

from __future__ import annotations

import pytest

import arp_tpu_torch.profiling as profiling
from arp_tpu_torch.profiling import Span
from portbench import run
from portbench.tests.test_portbench_runs import tiny_run

MS = 1_000_000  # ns


def _spans() -> list:
    """Two lockstep steps of 100 ms, one labeling call, two train steps; times in ns."""
    out, ids = [], iter(range(1, 100))

    def add(name, start, end, parent=None, **attrs):
        sid = next(ids)
        out.append(Span(name, start, end, sid, parent, sid if parent is None else parent, 1, attrs))
        return sid

    for k in range(2):
        t0 = 1000 * MS + k * 100 * MS
        step = add("rollout.step", t0, t0 + 100 * MS)
        add("rollout.policy", t0, t0 + 40 * MS, step)
        reward = add("rollout.reward", t0 + 40 * MS, t0 + 95 * MS, step)
        add("engine.images", t0 + 41 * MS, t0 + 94 * MS, reward, frames=10, padded=54)
        add("rollout.env", t0 + 95 * MS, t0 + 97 * MS, step)
        add("rollout.push", t0 + 97 * MS, t0 + 100 * MS, step)
    add("engine.images", 0, 9 * MS, None, frames=1000, padded=24)  # not under a rollout step
    for k in range(4):
        add("engine.host_wait", k * MS, k * MS + MS // 2)
    for k in range(2):
        add("prefetch.wait", 3000 * MS + k * 700 * MS, 3000 * MS + k * 700 * MS + 3 * MS)
        add("train.step", 3003 * MS + k * 700 * MS, 3600 * MS + k * 700 * MS)
    return out


READS = {"label.host_wait_pct": 100 * 2e-3 / 4.0, "rollout.policy_span_ms": 40.0, "rollout.reward_span_ms": 55.0,
         "rollout.env_ms": 2.0, "rollout.push_ms": 3.0, "rollout.engine_pad_pct": 84.375, "train.feed_wait_ms": 3.0}


def _read(name: str):
    return run.load_module(run.HERE / "metrics" / f"{name}.py").read({"window_s": 4.0, "work": {}})


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_value_on_synthetic_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", _spans)
    assert _read(name) == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_none_without_its_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", list)
    assert _read(name) is None
    monkeypatch.delattr(profiling, "spans")  # a program that records no spans: the parent commit's
    assert _read(name) is None


def test_traced_tiny_rollout_reads_its_span_metrics(monkeypatch):
    """3 envs padded to the engine's batch of 8: 5 of 8 frames are padding."""
    result = tiny_run("rollout.arpdt.f32.e10", monkeypatch, trace=True)
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert metrics["rollout.engine_pad_pct"] == 62.5
    for name in ("rollout.policy_span_ms", "rollout.reward_span_ms", "rollout.env_ms", "rollout.push_ms"):
        assert metrics[name] > 0, name


def test_traced_tiny_train_reads_its_feed_wait(monkeypatch):
    result = tiny_run("train.arpdt.f32", monkeypatch, trace=True)
    assert result["correct"] and result["metrics"]["train.feed_wait_ms"]["value"] >= 0
