"""The program's own spans and counters in a traced stretch, for the
per-layer metrics that read them: ``rlcf_torch/utils/profiling.py``'s
recorder is on while the stretch's ``torch.profiler`` session runs, and
stamps its spans with the clock of the profiler's events, the clock of
``Trace.window`` and of the device's operations.

A program without the recorder, or a stretch in which it recorded no span,
gives None: the metric is then left out of the result line."""

ENGINE = ("prepare", "episodes")   # the episode engine's spans in a group


def summary(trace, under, gaps: bool = False):
    """``profiling.summary`` of the program's spans in the trace's window that
    are or lie under a span named in ``under`` (with the device's idle gaps
    that they own where ``gaps``), or None."""
    try:
        from rlcf_torch.utils.profiling import recorded, summary as by_name
    except ImportError:
        return None
    return by_name(recorded(), trace.window, trace.idle_gaps() if gaps else (), under) or None
