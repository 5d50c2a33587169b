"""Device milliseconds of the AugMix kernel a group, from the trace."""

KERNELS = ("augmix_kernel",)


def read(trace, run):
    secs = trace.kernel_seconds(KERNELS)
    return secs / run["groups"] * 1e3 if secs else None
