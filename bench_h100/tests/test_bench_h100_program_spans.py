"""The per-layer metrics that read the program's own spans and counters
(``program_spans.py``), on a hand-built trace and hand-built spans: which
idle gaps the episode engine owns, the window's bounds, and a program
without the recorder."""

import pytest

from bench_h100.metrics import engine_host_ms, engine_idle_ms, syncs_per_item, views_host_ms
from bench_h100.trace import Trace
from rlcf_torch.utils import profiling

READERS = (engine_host_ms, engine_idle_ms, views_host_ms, syncs_per_item)


def group(t0, gid):
    """One group's spans from ``t0`` (ns): views, prepare (policy_fwd),
    episodes (one step with its text_bwd, then final)."""
    S = profiling.Span
    g = S("group", t0, None, gid, end=t0 + 4000)
    views = S("views", t0, g, gid, end=t0 + 500, counts={"host_syncs": 1})
    prepare = S("prepare", t0 + 500, g, gid, end=t0 + 1500)
    policy = S("policy_fwd", t0 + 500, prepare, gid, end=t0 + 1000, counts={"host_syncs": 2})
    episodes = S("episodes", t0 + 1500, g, gid, end=t0 + 3800)
    step = S("step", t0 + 1500, episodes, gid, index=1, end=t0 + 3000)
    bwd = S("text_bwd", t0 + 2000, step, gid, end=t0 + 2500)
    final = S("final", t0 + 3000, episodes, gid, end=t0 + 3800)
    return [g, views, prepare, policy, episodes, step, bwd, final]


@pytest.fixture
def spans(monkeypatch):
    """Two groups, the second past the window's end."""
    recorded = group(1000, 1) + group(20000, 2)
    monkeypatch.setattr(profiling, "recorded", lambda: list(recorded))
    return recorded


def trace():
    """The device idle in three gaps: (1100, 1300) in ``views``, (3100, 3300)
    in ``text_bwd``, (5200, 5400) outside any span."""
    ops = [("k", 0, 1100), ("k", 1300, 3100), ("k", 3300, 5200), ("k", 5400, 10000)]
    return Trace(ops, [], (0, 10000))


def test_the_engine_owns_the_gaps_under_prepare_and_episodes_alone(spans):
    run = {"groups": 1, "items": 4}
    t = trace()
    assert engine_idle_ms.read(t, run) == pytest.approx(200 / 1e6)        # text_bwd's gap; not views', not outside
    assert engine_host_ms.read(t, run) == pytest.approx((1000 + 2300) / 1e6)
    assert views_host_ms.read(t, run) == pytest.approx(500 / 1e6)
    assert syncs_per_item.read(t, run) == pytest.approx(3 / 4)               # the second group's lie outside
    table = profiling.summary(profiling.recorded(), t.window, t.idle_gaps())
    assert sum(v["idle_ms"] for v in table.values()) == pytest.approx(600 / 1e6)
    assert table[profiling.NO_SPAN]["idle_ms"] == pytest.approx(200 / 1e6)


def test_a_window_without_program_spans_reads_nothing(spans):
    t = Trace([("k", 0, 100)], [], (50000, 60000))
    assert [r.read(t, {"groups": 1, "items": 4}) for r in READERS] == [None] * 4


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert [r.read(trace(), {"groups": 1, "items": 4}) for r in READERS] == [None] * 4
