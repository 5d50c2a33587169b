"""Run one cell of the benchmark of ``rlcf_torch`` on the card, once.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
``BENCHMARK.json``, its configuration file, ``traffic/<traffic>.json`` (whose
``kind`` names the driver, ``drivers/<kind>.py``), ``limits/<cell>.json``,
and each per-layer metric's reader, ``metrics/<name>.py``. The last line of
standard output is the result (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer ones).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bytecode goes to a fixed directory in the checkout (harness.CACHE), set
# before anything else is imported
sys.pycache_prefix = os.path.join(ROOT, "rlcf_torch", "_build", "bench_cache", "pycache")
sys.path[0] = ROOT

from bench_h100 import harness  # noqa: E402

harness.set_environment()


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic, limits = harness.find_cell(bench, args.workload)
    harness.require_cuda(cell["chips"])
    metrics = harness.cell_metrics(bench, args.workload, bool(args.trace))
    readers = {m["name"]: importlib.import_module(f"bench_h100.metrics.{m['name']}").read for m in metrics} \
        if args.trace else {}
    driver = importlib.import_module(f"bench_h100.drivers.{traffic['kind']}")
    result, checks = driver.run({"args": args, "config": config, "traffic": traffic, "limits": limits,
                                 "metrics": metrics, "readers": readers, "t_start": T_START})
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"refused: the run loaded {found}; nothing the benchmark runs may load JAX or the JAX package",
              file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = harness.power_limit_w()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
