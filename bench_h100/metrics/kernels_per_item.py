"""Device kernels in the traced window per item finished there."""


def read(trace, run):
    return len(trace.kernels()) / run["items"] if run["items"] else None
