"""The benchmark's files resolve, its counts match hand counts, and nothing it runs imports JAX."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import roofline

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "arp_tpu")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    data = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert {k: data[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    config = next(c for c in BENCH["configs"] if c["name"] == data["config"])
    assert (ROOT / config["file"]).exists() and json.loads((ROOT / config["file"]).read_text())["reduced"] == \
        config["reduced"]
    assert (HERE / "traffic" / f"{data['traffic']}.py").exists()
    reported = [m for m in BENCH["per_layer"] + BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert any(m["name"] == "setup_s" for m in reported)
    assert any(m["name"] != "setup_s" for m in reported if m in BENCH["end_to_end"])
    for m in reported:
        if m in BENCH["per_layer"]:
            assert (HERE / "metrics" / f"{m['name']}.py").exists()
    assert set(data["params"]["limits"]) and all(v > 0 for v in data["params"]["limits"].values())


def test_every_metric_moves_a_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", m["workloads"]))


def test_roofline_hand_counts():
    flops, nbytes = roofline.attention_cost(256, 197, 12, 64, "float32")
    assert nbytes == 4 * 256 * 197 * 12 * 64 * 4  # q, k, v read and out written once: 620 MB
    assert round(nbytes / 1e6) == 620
    assert flops == 4 * 256 * 12 * 197 ** 2 * 64
    # ViT-B/16 at 224: patch embedding 0.231, blocks 33.48 + attention 1.43, projection 0.0008 GFLOP
    assert round(roofline.vit_flops_per_frame(768, 12, 16, 224, 512) / 1e9, 1) == 35.1
    assert roofline.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert not _imports(path) & {"arp_tpu_torch", *FORBIDDEN}, path


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = names
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block(%r))
"""


def _run_blocked(names, body: str) -> subprocess.CompletedProcess:
    code = BLOCKER % (tuple(names),) + body
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_module():
    """A tiny run of the label cell under a finder that refuses every forbidden top-level name, compared
    whole (arp_tpu_torch is another name), and the harness's own look at sys.modules afterwards."""
    body = """
from portbench import run
from portbench.tests.tiny import CELLS
for cell in ("label.vitb16.f32", "train.arpdt.f32"):
    over, params = CELLS[cell]
    result = run.run_cell(cell, 7, 0.5, False, device="cpu", config_over=over, params_over=params)
    assert result["correct"], result
import portbench.calibrate, portbench.clients, portbench.readers
from portbench.traffic import rollout, reward_serve
assert run.forbidden_modules() == [], run.forbidden_modules()
print("clean")
"""
    proc = _run_blocked(FORBIDDEN, body)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


def test_the_reference_runs_without_the_program():
    body = """
import numpy as np, torch
from portbench.reference import arpdt, clip, resize, tokenizer
frames = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8)
assert resize.resize(frames, 32).shape == (2, 32, 32, 3)
assert tokenizer.tokenize("collect the coin")[0, 0] == 512
assert "arp_tpu_torch" not in {m.split(".")[0] for m in sys.modules}
print("clean")
"""
    proc = _run_blocked(("arp_tpu_torch", *FORBIDDEN), body)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Without CUDA the run exits non-zero and prints no result; so it does in a directory that holds only
    BENCHMARK.json and the benchmark's files (the program is missing)."""
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "label.vitb16.f32", "--seed", "1",
                           "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    import shutil

    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "label.vitb16.f32", "--seed", "1",
                           "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
