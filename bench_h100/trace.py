"""The device trace of a traced stretch, read off ``torch.profiler``'s raw results.

The profiler records the device's activity alone (kernels, copies, sets and
the CUDA runtime's calls): recording every host op as well slows the
host-bound loop several times over, and the untraced loop is what the
metrics describe. ``prof.events()`` first builds an object for every op and
kernel (tens of microseconds each, minutes over a stretch's 10^5 kernels), so
this reads ``prof.profiler.kineto_results.events()`` directly. The harness's
own spans are host clock readings (``time.perf_counter_ns``); the two
``cudaDeviceSynchronize`` calls that open and close the stretch put them on
the trace's clock. Timestamps are in nanoseconds.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Tuple

NOT_KERNELS = ("Memcpy", "Memset")   # device operations that are no kernel
ANCHOR = "cudaDeviceSynchronize"     # the runtime call that opens and closes the stretch


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, int, int]]   # (name, start, end)
    spans: List[Tuple[str, int, int]]        # the harness's spans on the trace's clock: (name, start, end)
    window: Tuple[int, int]
    anchor_note: str = ""

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self):
        """The device operations in the window that are kernels."""
        lo, hi = self.window
        return [k for k in self.device_ops if not k[0].startswith(NOT_KERNELS) and k[2] > lo and k[1] < hi]

    def busy_intervals(self):
        """The union of every device operation's interval, clipped to the window."""
        lo, hi = self.window
        merged = []
        for _, s, e in sorted(self.device_ops, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self):
        """The window's intervals in which no device operation ran."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def gaps_by_span(self):
        """Idle seconds by what the host was doing: the innermost harness span
        open at each gap's middle ("loop" where none was)."""
        out = collections.Counter()
        for s, e in self.idle_gaps():
            mid = (s + e) / 2
            open_ = [sp for sp in self.spans if sp[1] <= mid < sp[2]]
            name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "loop"
            out[name] += (e - s) / 1e9
        return out

    def time_by_kernel(self):
        out = collections.Counter()
        for name, s, e in self.kernels():
            out[name] += (e - s) / 1e9
        return out

    def kernel_seconds(self, parts) -> float:
        """Device seconds of the window's kernels whose names hold one of ``parts``."""
        return sum(s for name, s in self.time_by_kernel().items() if any(p in name for p in parts))


def read(prof, host_window, host_spans) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``: ``host_window``
    is the host's clock (ns) just before the synchronizations that open and
    close the stretch, ``host_spans`` the harness's spans on that clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device_ops, anchors = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device_ops.append((name, e.start_ns(), e.end_ns()))
        elif name == ANCHOR:
            anchors.append(e.start_ns())
    h0, h1 = host_window
    if len(anchors) >= 2:
        offset = ((anchors[0] - h0) + (anchors[-1] - h1)) / 2
        note = f"offset {offset:.0f} ns, drift {(anchors[-1] - anchors[0]) - (h1 - h0)} ns over the stretch"
    else:   # no runtime calls in the trace: the stretch is the host's, its device operations all in it
        offset = min((s for _, s, _ in device_ops), default=h0) - h0
        note = "none (the stretch taken from its first device operation)"
    spans = [(n, s + offset, e + offset) for n, s, e in host_spans]
    return Trace(device_ops, spans, (h0 + offset, h1 + offset), note)
