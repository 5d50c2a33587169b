"""One ``--trace 1`` run of a cell, and the program's spans of its traced
stretch by name: calls, host ms, self ms, the device-idle ms each owns and
host syncs, each a group (``rlcf_torch/utils/profiling.py::summary``), with
the idle seconds no span owns and the stretch's total, as one ``SPANS`` JSON
line on standard error after the run's own output.

    python3 bench_h100/span_table.py --workload <name> --seed <n> --seconds <s> --trace 1
"""

import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from bench_h100 import run  # noqa: E402
from bench_h100.metrics import engine_idle_ms  # noqa: E402


def main(argv=None):
    seen = {}
    read = engine_idle_ms.read

    def keep(trace, facts):
        seen.update(trace=trace, groups=facts["groups"])
        return read(trace, facts)

    engine_idle_ms.read = keep
    rc = run.main(argv)
    if "trace" not in seen:
        return rc
    from rlcf_torch.utils.profiling import NO_SPAN, recorded, summary

    trace, n = seen["trace"], seen["groups"]
    gaps = trace.idle_gaps()
    table = summary(recorded(), trace.window, gaps)
    per_group = {name: {k: v / n for k, v in row.items()} for name, row in table.items()}
    idle_ms = sum(row["idle_ms"] for row in table.values())
    print("SPANS " + json.dumps({"groups": n, "per_group": per_group, "idle_ms_total": sum(e - s for s, e in gaps) / 1e6,
                                 "idle_ms_attributed": idle_ms, "idle_ms_no_span": table.get(NO_SPAN, {}).get(
                                     "idle_ms", 0.0)}), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
