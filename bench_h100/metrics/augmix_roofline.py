"""Per cent of the AugMix kernel's device time that its launches need at the
least: each traced group's operations and bytes (``arith.augmix_cost`` on the
group's view parameters, drawn again from its seed) at the fp32 peak and the
memory's bandwidth, summed, over the kernel's device time."""

from .. import arith
from ..reference import views

KERNELS = ("augmix_kernel",)


def read(trace, run):
    secs = trace.kernel_seconds(KERNELS)
    if not secs:
        return None
    ep, S = run["ep"], run["source_size"]
    least = 0.0
    for seed in run["traced_seeds"]:
        params = views.group_view_params(seed, run["group"], ep["n_views"], S, ep["resolution"], run["device"])
        ops, nbytes = arith.augmix_cost(params, ep["n_views"], ep["resolution"], S, views.resize_weights,
                                        views.bicubic_matrix)
        least += arith.least_seconds(ops, nbytes, arith.PEAK["fp32"])
    return 100.0 * least / secs
