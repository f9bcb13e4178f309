"""``rollout.tower_reuse_pct``'s reader on synthetic spans, ``None`` when the program recorded none of its spans
or records no spans at all, and a traced tiny rollout, whose line carries it at the share the windows give."""

from __future__ import annotations

import json

import pytest

import arp_tpu_torch.profiling as profiling
from arp_tpu_torch.profiling import Span
from portbench import run
from portbench.tests.test_portbench_runs import tiny_run
from portbench.tests.tiny import TINY_ARPDT

MS = 1_000_000  # ns


def _read():
    return run.load_module(run.HERE / "metrics" / "rollout.tower_reuse_pct.py").read({"window_s": 1.0, "work": {}})


def _spans() -> list:
    """Two lockstep steps of 10 envs (a first at window 1, one at window 4) and a train step's tower call, which
    is not under ``rollout.policy``."""
    out, ids = [], iter(range(1, 100))

    def add(name, start, end, parent=None, **attrs):
        sid = next(ids)
        out.append(Span(name, start, end, sid, parent, sid if parent is None else parent, 1, attrs))
        return sid

    for k, reused in enumerate((0, 30)):
        t0 = k * 100 * MS
        policy = add("rollout.policy", t0, t0 + 40 * MS, add("rollout.step", t0, t0 + 100 * MS))
        add("policy.tower", t0, t0 + 30 * MS, policy, encoded=10, reused=reused)
    add("policy.tower", 300 * MS, 400 * MS, add("train.step", 300 * MS, 500 * MS), encoded=512, reused=0)
    return out


def test_reader_value_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _spans)
    assert _read() == pytest.approx(100 * 30 / 50)


def test_reader_gives_none_without_its_spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", list)
    assert _read() is None
    monkeypatch.delattr(profiling, "spans")  # a program that records no spans
    assert _read() is None


def test_traced_tiny_rollout_reads_the_tower_reuse_share(monkeypatch):
    """Each lockstep call encodes one new frame an env and reads the window's older slots back: over T steps at
    window W, the share of the window frames reused is sum(w - 1) / sum(w) of the calls' windows w."""
    result = tiny_run("rollout.arpdt.f32.e10", monkeypatch, trace=True)
    assert result["correct"]
    config = json.loads((run.HERE / "configs" / "arpdt_m3ae_b16.json").read_text())
    sizes = [min(t + 1, config["window"]) for t in range(TINY_ARPDT["env"]["episode_length"])]
    want = 100 * sum(w - 1 for w in sizes) / sum(sizes)
    assert result["metrics"]["rollout.tower_reuse_pct"]["value"] == pytest.approx(want)
