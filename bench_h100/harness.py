"""What every cell's run shares: the checkout's paths and caches, the files
found by name, the guard against the JAX package, the card, and the result
line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache a run writes, at fixed paths inside the checkout (git-ignored
# with the port's kernel builds, ``rlcf_torch/_build/``)
CACHE = os.path.join(ROOT, "rlcf_torch", "_build", "bench_cache")
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}
# top-level module names a run may not load: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "rlcf_tpu")


def set_environment():
    """Point the interpreter's bytecode and every compile cache into the
    checkout (``CACHE``), so that only a checkout's first run compiles; keep
    the host's thread pools to one thread, so that no pool spins on the cores
    that launch the device's work (the loop is bound by that host thread);
    and tell a library that could load JAX by itself not to."""
    sys.pycache_prefix = os.path.join(CACHE, "pycache")   # run.py sets it first, before any import
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``rlcf_torch`` passes, ``rlcf_tpu`` does not."""
    return sorted(name for name in modules if name.split(".", 1)[0] in FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def find_cell(bench: dict, workload: str):
    """(cell, config file, traffic file, limits) of ``workload``, each found by
    its name in ``BENCHMARK.json``: ``configs/``, ``traffic/`` and ``limits/``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load_json(ROOT, config["file"]), load_json(HERE, "traffic", cell["traffic"] + ".json"),
            load_json(HERE, "limits", workload + ".json"))


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics of ``BENCHMARK.json``: its end-to-end metrics, or with
    ``trace`` its per-layer ones; a metric without ``workloads`` is every
    cell's (a per-layer one: every cell that reports the metric it moves)."""
    mine = lambda m: workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if mine(m) and m["moves"] in reported]


def require_cuda(chips: int):
    """Refuse a measurement where the card is missing: no fallback to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card and does not run on the CPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} CUDA devices; {torch.cuda.device_count()} found")


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it (None where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _read(path: str) -> str:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return ""


def _cpu_mhz(cpu: int):
    khz = _read(f"/sys/devices/system/cpu/cpu{cpu}/cpufreq/scaling_cur_freq").strip()
    if khz:
        return int(khz) / 1e3
    for block in _read("/proc/cpuinfo").split("\n\n"):
        fields = dict(line.split(":", 1) for line in block.splitlines() if ":" in line)
        if fields.get("processor\t", "").strip() == str(cpu) and "cpu MHz\t\t" in fields:
            return float(fields["cpu MHz\t\t"])
    return None


class HostState:
    """What the host gave the process's main thread between its making and
    ``delta()``: seconds on a core, seconds runnable but waiting for one,
    context switches, the core it ran on last and that core's clock, the
    garbage collector's passes and seconds, the load average. Read from
    ``/proc`` and ``/sys``; nothing is changed."""

    def __init__(self):
        import gc

        self.gc = [0, 0, 0, 0.0]   # collections of generations 0, 1, 2, and their seconds
        self._t = None

        def timer(phase, info):
            if phase == "start":
                self._t = time.perf_counter()
            elif self._t is not None:
                self.gc[info["generation"]] += 1
                self.gc[3] += time.perf_counter() - self._t

        self._timer = timer
        gc.callbacks.append(timer)
        self.start = self._snapshot()

    def _snapshot(self):
        sched = [int(x) for x in _read("/proc/self/schedstat").split()[:2]] or [0, 0]
        status = dict(line.split(":", 1) for line in _read("/proc/self/status").splitlines() if ":" in line)
        ctx = [int(status.get(k, "0").strip() or 0) for k in ("voluntary_ctxt_switches", "nonvoluntary_ctxt_switches")]
        return {"wall": time.perf_counter(), "thread": time.thread_time(), "run_ns": sched[0], "wait_ns": sched[1],
                "ctx": ctx}

    def delta(self) -> dict:
        import gc

        if self._timer in gc.callbacks:
            gc.callbacks.remove(self._timer)
        end, start = self._snapshot(), self.start
        wall = end["wall"] - start["wall"]
        stat = _read("/proc/self/stat")
        cpu = int(stat.rsplit(")", 1)[1].split()[36]) if stat else -1
        return {"wall_s": round(wall, 3), "thread_cpu_share": round((end["thread"] - start["thread"]) / wall, 4),
                "runqueue_wait_share": round((end["wait_ns"] - start["wait_ns"]) / 1e9 / wall, 4),
                "voluntary_switches": end["ctx"][0] - start["ctx"][0],
                "involuntary_switches": end["ctx"][1] - start["ctx"][1],
                "cpu": cpu, "cpu_mhz": _cpu_mhz(cpu) if cpu >= 0 else None,
                "affinity": len(os.sched_getaffinity(0)), "loadavg": os.getloadavg()[0],
                "gc_collections": self.gc[:3], "gc_s": round(self.gc[3], 4)}


def emit(result: dict, checks: dict):
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output, the
    numbers under ``check``, its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result = dict(result, check=checks)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
