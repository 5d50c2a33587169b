"""Profiling hooks (the counterpart of ``rlcf_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace, the card's memory in use,
and an episode timer that drains the device per block.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (host and, where there is a card,
    its kernels), written to ``log_dir/trace.json`` (Chrome trace format);
    a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


class EpisodeTimer:
    """Throughput meter that drains the device pipeline per block: ``stop``
    reads the first element of the result's first tensor to the host."""

    def __init__(self):
        self.episodes = 0
        self.seconds = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_episodes: int, result=None):
        if result is not None:
            leaves = [t for t in torch.utils._pytree.tree_leaves(result) if isinstance(t, torch.Tensor)]
            if leaves:
                leaves[0].reshape(-1)[:1].cpu()
        self.seconds += time.perf_counter() - self._t0
        self.episodes += n_episodes

    @property
    def eps_per_sec(self) -> float:
        return self.episodes / max(self.seconds, 1e-9)
