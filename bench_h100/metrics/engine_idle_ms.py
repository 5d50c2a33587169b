"""Device-idle ms a group that the episode engine owns: the traced stretch's idle
gaps (``Trace.idle_gaps``) whose midpoint the innermost open program span is
``prepare``, ``episodes`` or a span under them, summed, over the stretch's
groups. The device waits there for the host's dispatch of the engine. Read in
the traced stretch, which runs 8-43% slower than the untraced one on an H100
(CUPTI's records; hosts differ), as much with the program's spans recorded as
without them."""

from ..program_spans import ENGINE, summary


def read(trace, run):
    s = summary(trace, ENGINE, gaps=True)
    return None if s is None else sum(v["idle_ms"] for v in s.values()) / run["groups"]
