"""Host ms a group in the episode engine: the duration of the program's
``prepare`` span (the policy over the group's views, the selection, the reward
tower) plus its ``episodes`` span (each TTA step's text forward, loss, text
backward and AdamW, and the final prediction), summed over the traced
stretch's groups, over their number. The host dispatches the engine's
launches, and waits at its syncs, in that time. Read in the traced stretch,
which runs 8-43% slower than the untraced one on an H100 (CUPTI's records;
hosts differ), as much with the program's spans recorded as without them."""

from ..program_spans import ENGINE, summary


def read(trace, run):
    s = summary(trace, ENGINE)
    return None if s is None else sum(s[n]["host_ms"] for n in ENGINE if n in s) / run["groups"]
