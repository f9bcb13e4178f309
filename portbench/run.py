"""The benchmark of arp_tpu_torch, one run of one cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's GPUs.  Set-up (imports, weights and inputs
made on the card from the seed, the kernels' builds and a warm-up of every shape the cell uses) is
``setup_s``; then the cell's traffic runs for ``--seconds``; then the program's state is freed and what
the window produced is compared with the plain reference (``reference/``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics read from a ``torch.profiler`` trace of the window,
and a ``breakdown``), ``device`` and, last, ``checks``: each number compared, beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here: the imports are part of it

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold: JAX, its libraries and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "arp_tpu")


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that only a checkout's first run
    builds; and no library that loads JAX by itself may do so."""
    build = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    """(the cell's workload file, its configuration file)."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    return cell, load_json(HERE / "configs" / f"{cell['config']}.json")


def metric_specs(name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics of BENCHMARK.json that this cell reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    mine = lambda m: "workloads" not in m or name in m["workloads"]  # noqa: E731
    return [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


def load_module(path: Path):
    """A module from a file whose name may hold dots (a metric's reader)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config_over: dict | None = None, params_over: dict | None = None, fault: str | None = None) -> dict:
    """One run of cell ``name``: set-up, the window, the comparison; returns the result's fields.

    ``config_over`` / ``params_over`` replace entries of the configuration and the traffic's parameters (the
    tests' tiny CPU runs); ``fault`` breaks the program as the traffic's ``fault`` argument says (the tests'
    and calibrate.py's broken runs)."""
    import torch

    from . import trace as trace_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config = load_cell(name)
    config = {**config, **(config_over or {})}
    params = {**cell["params"], **(params_over or {})}
    module = importlib.import_module(f"portbench.traffic.{cell['traffic']}")
    traffic = module.Traffic(config, params, seed, torch.device(device), fault=fault)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    with trace_lib.traced(trace) as prof:
        out = traffic.window(seconds, prof)
    record = None
    if trace:
        record = trace_lib.reduce(prof)
        record["work"] = out.get("work", {})
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    traffic.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = traffic.compare()
    correct = (out["failed"] == 0 and out["attempted"] > 0
               and all(math.isfinite(v) and v <= lim for v, lim in checks.values()))
    e2e, per_layer = metric_specs(name)
    metrics = {}
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    else:
        for m in per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_cache_dirs()
    cell, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: nothing it runs may import JAX or the JAX package",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
