"""The readings that a cell's limits are set from (not part of a benchmark run):

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 5 [--control] [--fault <name>]
        [--params '{"first_step": 10000}']
    python3 -m portbench.calibrate --workload <cell> --seeds 1 --seconds 10 --rates 4,8,12

For each seed, in one process: the cell's set-up, a window of ``--seconds`` at the cell's own sizes and
load, and the numbers compared (the program's readings); with ``--control`` also the same numbers with the
reference computed in TF32 put in the program's place; with ``--fault`` the program broken as the traffic's
``fault`` argument breaks it; ``--params`` replaces entries of the cell's parameters.  One JSON line a seed.
``--rates`` (a served cell) instead runs one window at each offered rate after one set-up and prints what each
gave: the sweep that finds the knee.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--rates", default=None)
    parser.add_argument("--params", default="{}")
    args = parser.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config = run.load_cell(args.workload)
    params = {**cell["params"], **json.loads(args.params)}
    module = importlib.import_module(f"portbench.traffic.{cell['traffic']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        traffic = module.Traffic(config, params, seed, torch.device("cuda"), fault=args.fault)
        if args.rates:
            for rate in (float(r) for r in args.rates.split(",")):
                traffic.rate = rate
                out = traffic.window(args.seconds)
                print(json.dumps({"seed": seed, "rate": rate, "failed": out["failed"], **out["metrics"],
                                  **out["work"], "completed_per_s": out["attempted"] / out["work"]["elapsed_s"]}),
                      flush=True)
            traffic.release()
            continue
        out = traffic.window(args.seconds)
        traffic.release()
        torch.cuda.empty_cache()
        line = {"seed": seed, "fault": args.fault, "attempted": out["attempted"], "failed": out["failed"],
                "program": {k: v for k, (v, _) in traffic.compare().items()}}
        if hasattr(traffic, "detail"):
            line["program"] = traffic.detail()
        if args.control:
            line["control"] = traffic.control()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del traffic
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
