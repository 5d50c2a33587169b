"""Milliseconds a group of the device view generator's call, from CUDA
events recorded before and after it in the untraced stretch (the device's
time from the generator's first operation's start to its last one's end,
the gaps in which it waits on the host included)."""


def read(trace, run):
    ms = run["view_ms"]
    return sum(ms) / len(ms) if ms else None
