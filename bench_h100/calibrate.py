"""Readings of the compared numbers that a cell's limits are set from: the
program on many seeds and the control (the reference one precision below
the configuration's, in the program's place) on a few, in one process.

    python3 bench_h100/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 --groups 8 \
        [--fault-seeds 7,8 --faults one_unadapted,altered_answer]

Prints one JSON line a seed: ``{"seed", "side": "program" | "control" |
"fault:<name>", "numbers"}``; a fault (``faults.py``) is planted in the
program for its seeds.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT, "rlcf_torch", "_build", "bench_cache", "pycache")
sys.path[0] = ROOT

from bench_h100 import faults, harness  # noqa: E402

harness.set_environment()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--groups", type=int, default=8, help="groups a program's seed runs after its warm-up")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="", help="faults.py's names, each planted on every fault seed")
    p.add_argument("--equal-weights", action="store_true",
                   help="a witness: the reference weighs an ensemble's members equally, not by their confidences")
    args = p.parse_args(argv)
    import importlib

    import torch

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic, _ = harness.find_cell(bench, args.workload)
    harness.require_cuda(cell["chips"])
    driver = importlib.import_module(f"bench_h100.drivers.{traffic['kind']}")
    if args.equal_weights:
        from bench_h100.reference import prompt_tta

        prompt_tta.confidence_weights = lambda members: [round(1 / len(members), 2)] * len(members)
    device = torch.device("cuda")
    parse = lambda s: [int(x) for x in s.split(",") if x]
    sides = [("program", parse(args.seeds)), ("control", parse(args.control_seeds))]
    sides += [("fault:" + f, parse(args.fault_seeds)) for f in args.faults.split(",") if f]
    for side, seeds in sides:
        for seed in seeds:
            t0 = time.perf_counter()
            if side == "control":
                numbers = driver.control_readings(config, traffic, seed, device)
            else:
                with faults.plant(side[6:]) if side != "program" else contextlib.nullcontext():
                    numbers = driver.program_readings(config, traffic, seed, args.groups, device)
            side_name = side + ("+equal_weights" if args.equal_weights else "")
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side_name, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
