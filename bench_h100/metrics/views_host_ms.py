"""Host ms a group in the program's ``views`` span: the sources copied to the
card, the AugMix parameters drawn, the resize matrix built and the fused
AugMix kernel launched, over the traced stretch's groups. Read in the traced
stretch, which runs 8-43% slower than the untraced one on an H100 (CUPTI's
records; hosts differ), as much with the program's spans recorded as without
them."""

from ..program_spans import summary


def read(trace, run):
    s = summary(trace, ("views",))
    return None if s is None or "views" not in s else s["views"]["host_ms"] / run["groups"]
