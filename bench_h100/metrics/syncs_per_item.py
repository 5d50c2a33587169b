"""Host syncs an item: the program's ``host_syncs`` counter (each synchronizing
CUDA operation ATen reports under the sync debug mode ``"warn"``, counted
against the innermost open span) summed over its ``group`` spans and all under
them in the traced stretch, over the items there. Each sync drains the stream:
the host waits for the device, then the device for the host. Read in the
traced stretch, which runs 8-43% slower than the untraced one on an H100
(CUPTI's records; hosts differ), as much with the program's spans recorded as
without them."""

from ..program_spans import summary


def read(trace, run):
    s = summary(trace, ("group",))
    return None if s is None else sum(v["host_syncs"] for v in s.values()) / run["items"]
