"""Per cent of the card's bf16 peak that the untraced stretch's items need:
items times the benchmark's FLOP count an item (``arith``), over the
stretch's seconds, over 989 TFLOP/s."""

from .. import arith


def read(trace, run):
    return 100.0 * run["untraced_items"] * run["flops_per_item"] / run["untraced_s"] / arith.PEAK["bf16"]
