"""arp_tpu_torch.drivers.reproduce_paper: the paper-table driver on the port's CLIs (the counterpart of
tests/test_reproduce_paper.py).

* Every flag that the FULL and SMOKE matrices pass is declared by the port's CLI it goes to.
* The port's command lists equal the JAX script's for every task, ``arp_tpu`` -> ``arp_tpu_torch`` and
  the ``--device`` flag aside.
* One ``--smoke --device cpu`` run on coinrun writes results.json with a success rate in [0, 1] and the
  markdown row; the CLIs run in-process (``run`` calls each CLI's ``main``), as the other port tests run
  them.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import sys

import pytest
import torch

from arp_tpu_torch.config import flag_leaves
from arp_tpu_torch.drivers import reproduce_paper as rp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_reproduce_paper", os.path.join(REPO, "scripts",
                                                                                      "reproduce_paper.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _commands(mod, cfg, extra, **device):
    out = []
    for name, task in mod.PAPER_TASKS.items():
        out.append((name, "train", mod.train_cmd(task, 42, cfg, "/d", "/c", "/o", list(extra), **device)))
        out.append((name, "eval", mod.eval_cmd(task, 42, cfg, "/d", "/c", "/o", 100, **device)))
    return out


@pytest.mark.parametrize("matrix", ["FULL_TRAIN", "SMOKE_TRAIN"])
def test_matrix_flags_are_declared(matrix):
    """Every flag of the matrix exists on its target CLI: the full run needs the card and real weights and
    never runs here, so a misspelt flag would otherwise show only there."""
    from arp_tpu_torch.train import eval as teval
    from arp_tpu_torch.train import main as tmain

    declared = {mod.__name__: {name for name, _ in flag_leaves(mod.flag_defaults())} for mod in (tmain, teval)}
    checked = 0
    for _, _, cmd in _commands(rp, getattr(rp, matrix), ["--mesh_fsdp=4", "--accum_steps=2"], device="cuda"):
        module = cmd[cmd.index("-m") + 1]
        for arg in cmd[cmd.index("-m") + 2:]:
            assert arg.startswith("--"), arg
            name = arg[2:].split("=", 1)[0]
            assert name in declared[module], f"{module} has no flag --{name}"
            checked += 1
    assert checked > 200, checked


@pytest.mark.parametrize("matrix", ["FULL_TRAIN", "SMOKE_TRAIN"])
def test_commands_equal_the_jax_script_s(matrix):
    jax_mod = _jax_script()
    assert rp.PAPER_TASKS == jax_mod.PAPER_TASKS and getattr(rp, matrix) == getattr(jax_mod, matrix)
    extra = ["--mesh_fsdp=4"]
    want = _commands(jax_mod, getattr(jax_mod, matrix), extra)
    got = _commands(rp, getattr(rp, matrix), extra, device="cpu")
    assert len(got) == len(want) == 10
    for (name, kind, cmd), (_, _, jcmd) in zip(got, want):
        assert cmd.count("--device=cpu") == 1, (name, kind)
        cmd = [a for a in cmd if a != "--device=cpu"]
        assert cmd == [a.replace("arp_tpu.", "arp_tpu_torch.", 1) if a.startswith("arp_tpu.") else a for a in jcmd], \
            (name, kind)
    # the trainer's extras come after every flag of the JAX matrix, the device flag before them
    train = got[0][2]
    assert train[-2:] == ["--device=cpu", "--mesh_fsdp=4"]


def test_child_env_drops_the_jax_variables(monkeypatch):
    for name in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS"):
        monkeypatch.setenv(name, "x")
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    smoke, full = rp.child_env(True), rp.child_env(False)
    for env in (smoke, full):
        assert not [k for k in env if k.startswith(("JAX_", "XLA_"))]
    assert smoke["PYTHONPATH"] == REPO and smoke["ARP_TPU_TINY_CLIP"] == "1"
    assert full["PYTHONPATH"] == os.pathsep.join([REPO, "/elsewhere"])


def test_dry_run_prints_every_command(capsys, tmp_path):
    rp.main(["--dry_run", "--seeds", "42,43", "--device", "cpu", "--output", str(tmp_path / "out"), "--",
             "--mesh_fsdp=4"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith(sys.executable)]
    # 4 training splits (coinrun's two tasks share one) x 2 seeds, 5 tasks x 2 seeds evaluated
    assert sum("arp_tpu_torch.train.main" in line for line in lines) == 8
    assert sum("arp_tpu_torch.train.eval" in line for line in lines) == 10
    assert all("--device=cpu" in line for line in lines)
    assert all(line.endswith("--mesh_fsdp=4") for line in lines if "train.main" in line)


def in_process_run(cmd, env, log_path, dry_run=False):
    """``run`` without a subprocess: each CLI's ``main`` on the command's flags, its stdout into the log."""
    del env, dry_run
    module = cmd[cmd.index("-m") + 1]
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        importlib.import_module(module).main(cmd[cmd.index("-m") + 2:])


def test_smoke_run_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(rp, "run", in_process_run)
    out = tmp_path / "paper"
    rp.main(["--smoke", "--device", "cpu", "--tasks", "coinrun", "--seeds", "0", "--output", str(out)])
    results = json.loads((out / "results.json").read_text())
    res = results["coinrun"]
    assert res["train"] == "coinrun/none" and res["test"] == "coinrun/aisc"
    metrics = res["seeds"]["0"]
    assert "return" in metrics and "success_rate" in metrics, metrics
    assert 0.0 <= res["success_rate_mean"] <= 1.0
    assert "| coinrun | coinrun/none | coinrun/aisc |" in capsys.readouterr().out
    assert (out / "ckpt_coinrun_none_0").is_dir() and (out / "prep_coinrun_none.log").exists()
