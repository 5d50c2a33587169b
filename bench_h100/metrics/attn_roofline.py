"""Per cent of the attention kernels' device time that their launches need
at the least: for every launch of ``rlcf::fused_attention`` and
``rlcf::fused_attention_bwd`` in the traced stretch (the program's counts by
shape), the least time of its shape (``arith``: operations at the peak of
its type, bytes at the memory's bandwidth), summed, over the device time of
the attention kernels in the trace, summed."""

from .. import arith

KERNELS = ("mha_fwd_", "mha_bwd_", "mask_tile_classes")   # the attention kernels' names in the trace


def read(trace, run):
    secs = trace.kernel_seconds(KERNELS)
    if not secs or not run["attention"]:
        return None
    least = 0.0
    for (direction, B, T, H, dtype), count in run["attention"].items():
        elem = 2 if "bfloat16" in dtype else 4
        ops, nbytes = arith.attention_cost(direction, B, T, H, elem)
        least += count * arith.least_seconds(ops, nbytes, arith.PEAK_ATTENTION["bf16" if elem == 2 else "fp32"])
    return 100.0 * least / secs
