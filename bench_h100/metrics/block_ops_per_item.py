"""Fused block-kernel launches an item: the program's ``block_ops`` counter
(each launch of ``rlcf_torch/ops/block_ops.py``'s LayerNorm, bias-QuickGELU,
bias-residual and weight-gradient kernels, counted against the innermost open
span) summed over its ``group`` spans and all under them in the traced
stretch, over the items there. None where the program counts no such launch
(a program without those kernels): 0 would mean the path bypasses them.
Lower is better, as for ``kernels_per_item``: above 0, fewer launches for the
same work (two kernels fused, a reduction pass dropped) read as a gain."""

from ..program_spans import summary


def read(trace, run):
    s = summary(trace, ("group",))
    if s is None or not any("block_ops" in v for v in s.values()):
        return None
    return sum(v.get("block_ops", 0) for v in s.values()) / run["items"]
