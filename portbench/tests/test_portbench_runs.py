"""Each cell's run at tiny widths on the CPU: sound runs come out correct, with the contract's fields, and a
run whose timed path is broken underneath comes out not correct (the harness's look for a chip skipped)."""

from __future__ import annotations

import json
import math

import pytest

from portbench import run
from portbench.tests.tiny import CELLS, tiny_reward_config

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
# each cell's faults: a state left unchanged and half of the batch left out (training), an answer altered
# where it is produced (the cells that answer)
FAULTS = {"train.arpdt.f32": ("unchanged", "half_batch"), "label.vitb16.f32": ("answer_altered",),
          "rollout.arpdt.f32.e10": ("answer_altered",), "reward_serve.vitb16.c4": ("answer_altered",)}


def tiny_run(cell, monkeypatch, seed=2 ** 31 + 11, trace=False, fault=None):
    if cell.startswith("rollout"):
        tiny_reward_config(monkeypatch)
    over, params = CELLS[cell]
    return run.run_cell(cell, seed, 1.0, trace, device="cpu", config_over=over, params_over=params, fault=fault)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_run_is_correct_with_the_contract_fields(cell, monkeypatch):
    """Every traffic kind with a workload file, the reward server's too (its cell waits for a later PR,
    PERF.md §7)."""
    result = tiny_run(cell, monkeypatch)
    assert result["correct"], result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == e2e
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    result = tiny_run(cell, monkeypatch, fault=fault)
    assert not result["correct"], result["checks"]


def test_traced_run_reads_its_metrics(monkeypatch):
    """A traced tiny run carries the per-layer metrics its reader finds, the window and a breakdown; on the CPU
    the device's readers find no kernel and leave their metrics out."""
    result = tiny_run("label.vitb16.f32", monkeypatch, trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    assert "label.k1_roofline_pct" not in result["metrics"]
