"""GiB the allocator held at most in the window (``max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start)."""


def read(trace, run):
    return run["peak_bytes"] / 2**30
