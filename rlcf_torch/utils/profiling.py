"""Profiling hooks (the counterpart of ``rlcf_tpu/utils/profiling.py``): the
program's span-and-counter recorder, a ``torch.profiler`` trace of the device
written as a Chrome trace with the program's spans beside it, and the card's
memory in use.

The recorder. ``span(name)`` marks a layer boundary of the program (a
context manager); ``count(name, n)`` adds to a counter on the innermost open
span. A span keeps its name, start and end, its parent, the id of the group
(request) it belongs to (a root span opens a new one; its descendants share
it) and, where given, an index (a TTA step's number). Spans stay in memory
(``recorded()``) until ``clear()``; ``summary`` reduces them by name, and
``trace`` writes them beside the device's activity.

The recorder is off by default: it records only while a ``torch.profiler``
session is active, or between ``enable()`` and ``disable()``. Off, a span
costs one flag check and returns a shared no-op context (no allocation, no
clock read, no CUDA call). Spans are stamped with ``time.time_ns()``, the
clock ``torch.profiler`` (kineto) stamps its host and device events with, so
program spans and device operations share one clock with no anchors to fit.

Host syncs are the counter ``host_syncs``: while a recorded root span is open
in a process that has initialized CUDA, the sync debug mode is ``"warn"`` and
each synchronizing-operation warning ATen raises (a pageable copy to or from
the card, ``.item()``, ``torch.cuda.synchronize()``, ...) counts against the
innermost open span, in place of being shown. The mode and the warning
filters are restored when the root span closes.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SYNC_WARNING = "called a synchronizing CUDA operation"   # ATen's warning under the sync debug mode "warn"
NO_SPAN = "(no span)"   # ``summary``'s entry for device-idle time while no program span was open


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    start: int                            # ns, ``time.time_ns()``
    parent: Optional["Span"]
    group: int
    index: Optional[int] = None
    end: int = 0                          # 0 while open
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class Recorder:
    """The process's spans: the finished and open ones in the order they
    opened, the stack of open ones, the last group id."""

    def __init__(self):
        self.explicit = False
        self.spans: List[Span] = []
        self.stack: List[Span] = []
        self.groups = 0
        self._restore = None   # closes the sync counting of the open root span

    def open(self, name: str, index: Optional[int]):
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            self.groups += 1
            self._restore = self._count_syncs()
        s = Span(name, time.time_ns(), parent, parent.group if parent else self.groups, index)
        self.spans.append(s)
        self.stack.append(s)

    def close(self):
        s = self.stack.pop()
        s.end = time.time_ns()
        if not self.stack and self._restore is not None:
            restore, self._restore = self._restore, None
            restore()

    def count(self, name: str, n: int = 1):
        if self.stack:
            counts = self.stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def _count_syncs(self):
        """Turn on the counting of host syncs (a process that has initialized
        CUDA only); returns what turns it off, or None."""
        if not torch.cuda.is_initialized():
            return None
        mode = torch.cuda.get_sync_debug_mode()
        caught = warnings.catch_warnings()
        caught.__enter__()
        shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING)

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                self.count("host_syncs")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")

        def restore():
            torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)

        return restore


RECORDER = Recorder()


class _Open:
    """A recorded span's context."""

    __slots__ = ("name", "index")

    def __init__(self, name, index):
        self.name, self.index = name, index

    def __enter__(self):
        RECORDER.open(self.name, self.index)

    def __exit__(self, *exc):
        RECORDER.close()


_OFF = contextlib.nullcontext()


def span(name: str, index: Optional[int] = None):
    """A span named ``name`` (and ``index``) around the block while the
    recorder is on; the shared no-op context while it is off."""
    if not (RECORDER.explicit or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, index)


def group():
    """The ``group`` span, the root of one group's spans: a span where none
    is open, else nothing (an entry point called by another opens none)."""
    if not (RECORDER.explicit or _autograd_profiler._is_profiler_enabled) or RECORDER.stack:
        return _OFF
    return _Open("group", None)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the innermost open span (nothing
    where none is open)."""
    RECORDER.count(name, n)


def enable():
    RECORDER.explicit = True


def disable():
    RECORDER.explicit = False


def recorded() -> List[Span]:
    """The spans recorded so far, in the order they opened."""
    return list(RECORDER.spans)


def clear():
    """Forget the finished spans (open ones stay on the stack)."""
    RECORDER.spans = [s for s in RECORDER.spans if s in RECORDER.stack]


def _owners(spans):
    """(times, owners): from ``times[i]`` on, until the next time, the
    innermost of ``spans`` open is ``owners[i]`` (None: none is)."""
    edges = sorted([(s.start, 1, -s.end, i) for i, s in enumerate(spans)] +
                   [(s.end, 0, -s.start, i) for i, s in enumerate(spans)])
    times, owners, open_ = [], [], []
    for t, opens, _, i in edges:
        if opens:
            open_.append(spans[i])
        else:
            open_.remove(spans[i])
        times.append(t)
        owners.append(open_[-1] if open_ else None)
    return times, owners


def summary(spans, window=None, gaps=(), under=None) -> Dict[str, dict]:
    """By span name: ``calls``, ``host_ms`` (their total duration), ``self_ms``
    (the duration less what their child spans cover), ``idle_ms`` (the
    device-idle ``gaps``, ``(start, end)`` ns, whose midpoint the span is the
    innermost open span at) and each counter (``host_syncs`` always), over
    the finished ``spans`` that lie in ``window`` (``(start, end)`` ns on the
    spans' clock; None: all). ``under``: names; only the spans so named and
    their descendants count, and only the gaps they own. The gaps that no
    span owns go to ``NO_SPAN`` (where ``under`` is None)."""
    lo, hi = window if window is not None else (float("-inf"), float("inf"))
    spans = [s for s in spans if s.end and lo <= s.start and s.end <= hi]
    if under is not None:
        def inside(s):
            while s is not None and s.name not in under:
                s = s.parent
            return s is not None
        spans = [s for s in spans if inside(s)]
    child_ns = {}
    for s in spans:
        if s.parent is not None:
            child_ns[id(s.parent)] = child_ns.get(id(s.parent), 0) + s.end - s.start
    out = {}

    def entry(name):
        return out.setdefault(name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0, "idle_ms": 0.0, "host_syncs": 0})

    for s in spans:
        e = entry(s.name)
        e["calls"] += 1
        e["host_ms"] += (s.end - s.start) / 1e6
        e["self_ms"] += (s.end - s.start - child_ns.get(id(s), 0)) / 1e6
        for k, v in s.counts.items():
            e[k] = e.get(k, 0) + v
    times, owners = _owners(spans)
    for g0, g1 in gaps:
        i = bisect.bisect_right(times, (g0 + g1) / 2) - 1
        owner = owners[i] if i >= 0 else None
        if owner is not None:
            entry(owner.name)["idle_ms"] += (g1 - g0) / 1e6
        elif under is None:
            entry(NO_SPAN)["idle_ms"] += (g1 - g0) / 1e6
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, recording the device's activity
    alone (its kernels, copies and the CUDA runtime's calls; the CPU's ops
    where there is no card), written to ``log_dir/trace.json`` (Chrome trace
    format) with the program's spans and counters of the block as complete
    events on a ``program`` track, on the trace's clock; a no-op when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    first = len(RECORDER.spans)
    with profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)   # kineto writes event times in us from it
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": "program", "args": {"name": "program"}})
    for s in RECORDER.spans[first:]:
        if s.end:
            args = {"group": s.group, **({"index": s.index} if s.index is not None else {}), **s.counts}
            events.append({"ph": "X", "name": s.name, "pid": "program", "tid": 0, "ts": (s.start - base) / 1e3,
                           "dur": (s.end - s.start) / 1e3, "args": args})
    with open(path, "w") as fh:
        json.dump(doc, fh)


def device_memory_stats() -> Dict[str, float]:
    """Current and peak memory in use on CUDA device 0 and its size, in GiB
    (JAX's keys: ``gib_in_use``, ``peak_gib_in_use``, ``gib_limit``); ``{}``
    without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(0)
    gib = 1024**3
    return {"gib_in_use": round(stats.get("allocated_bytes.all.current", 0) / gib, 3),
            "peak_gib_in_use": round(stats.get("allocated_bytes.all.peak", 0) / gib, 3),
            "gib_limit": round(torch.cuda.get_device_properties(0).total_memory / gib, 3)}
