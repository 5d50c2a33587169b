"""The span-and-counter recorder of ``rlcf_torch/utils/profiling.py`` on the
CPU: off by default and free there, on under a ``torch.profiler`` session,
parents, group ids and self time, the clock it shares with the profiler's
events, the Chrome trace it writes beside them, and the span trees of the
prompt-TTA classifier and of the generic episode. Host-sync counting needs a
card (``tests/test_torch_cuda.py``)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rlcf_torch.core import episode as Ep
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.tasks.classification import PromptTTAClassifier
from rlcf_torch.utils import profiling as P

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]


@pytest.fixture
def recorder():
    """The recorder emptied before and after a test, and off after it."""
    P.clear()
    yield P
    P.disable()
    P.clear()


def tree(spans):
    """The spans as nested ``(name, index, [children])``, roots first."""
    kids = {id(s): [] for s in spans}
    roots = []
    for s in spans:
        (kids[id(s.parent)] if s.parent is not None else roots).append(s)
    node = lambda s: (s.name, s.index, [node(c) for c in kids[id(s)]])
    return [node(s) for s in roots]


def test_off_records_nothing_and_returns_the_shared_noop(recorder):
    off = P.span("a")
    assert off is P.span("b", 3) and off is P.group()
    with off:
        with P.span("c"):
            P.count("host_syncs")
    assert P.recorded() == [] and not P.RECORDER.stack


def test_a_cpu_profiler_session_turns_recording_on_and_its_end_off(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("inside"):
            pass
    with P.span("after"):
        pass
    assert [s.name for s in P.recorded()] == ["inside"]


def test_parents_group_ids_and_counters(recorder):
    P.enable()
    with P.group():
        with P.span("a"):
            with P.group():   # an entry point inside a group opens none
                with P.span("b", 7):
                    P.count("x", 2)
                    P.count("x")
        with P.span("c"):
            pass
    with P.span("d"):
        P.count("y")
    P.disable()
    spans = {s.name: s for s in P.recorded()}
    assert list(spans) == ["group", "a", "b", "c", "d"]
    assert tree(P.recorded()) == [("group", None, [("a", None, [("b", 7, [])]), ("c", None, [])]), ("d", None, [])]
    g = spans["group"].group
    assert all(spans[n].group == g for n in "abc") and spans["d"].group == g + 1
    assert spans["b"].counts == {"x": 3} and spans["d"].counts == {"y": 1} and spans["a"].counts == {}
    assert all(s.start <= s.end for s in spans.values())
    assert spans["group"].start <= spans["a"].start <= spans["b"].start <= spans["b"].end <= spans["a"].end
    assert spans["a"].end <= spans["c"].start <= spans["c"].end <= spans["group"].end <= spans["d"].start


def test_summary_self_time_windows_and_idle_gaps():
    S = P.Span
    root = S("group", 0, None, 1, end=1000, counts={"host_syncs": 1})
    a = S("prepare", 100, root, 1, end=400)
    b = S("policy_fwd", 150, a, 1, end=250, counts={"host_syncs": 2})
    c = S("episodes", 500, root, 1, end=900)
    d = S("step", 550, c, 1, index=1, end=650)
    e = S("step", 700, c, 1, index=2, end=800)
    late = S("group", 2000, None, 2, end=3000)
    spans = [root, a, b, c, d, e, late]
    gaps = [(0, 40), (160, 200), (420, 480), (600, 610), (850, 870), (1100, 1500)]
    s = P.summary(spans, window=(0, 1500), gaps=gaps)
    ms = lambda ns: ns / 1e6
    assert s["group"] == {"calls": 1, "host_ms": ms(1000), "self_ms": ms(1000 - 300 - 400), "idle_ms": ms(40 + 60),
                          "host_syncs": 1}
    assert s["prepare"]["self_ms"] == ms(300 - 100) and s["prepare"]["idle_ms"] == 0
    assert s["policy_fwd"]["idle_ms"] == ms(40) and s["policy_fwd"]["host_syncs"] == 2
    assert s["step"]["calls"] == 2 and s["step"]["host_ms"] == ms(200) and s["step"]["idle_ms"] == ms(10)
    assert s["episodes"]["self_ms"] == ms(200) and s["episodes"]["idle_ms"] == ms(20)
    assert s[P.NO_SPAN]["idle_ms"] == ms(400)
    assert sum(v["idle_ms"] for v in s.values()) == pytest.approx(ms(sum(g1 - g0 for g0, g1 in gaps)))
    # only the spans under ``under`` and the gaps they own
    u = P.summary(spans, window=(0, 1500), gaps=gaps, under=("prepare", "episodes"))
    assert set(u) == {"prepare", "policy_fwd", "episodes", "step"}
    assert sum(v["idle_ms"] for v in u.values()) == pytest.approx(ms(40 + 10 + 20))
    # the second group lies outside the window; without one it counts
    assert P.summary(spans)["group"]["calls"] == 2


def test_a_profiled_ops_kineto_times_lie_inside_the_span_around_it(recorder):
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("matmul"):
            x @ x
    span, = P.recorded()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::matmul"]
    assert ops
    for e in ops:
        assert span.start <= e.start_ns() <= e.end_ns() <= span.end


def test_trace_writes_the_program_spans_beside_the_profilers_events(recorder, tmp_path):
    x = torch.randn(128, 128)
    with P.trace(str(tmp_path)):
        with P.span("step", 1):
            with P.span("mm"):
                x @ x
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    program = {e["name"]: e for e in events if e.get("pid") == "program" and e.get("ph") == "X"}
    assert set(program) == {"step", "mm"} and program["step"]["args"]["index"] == 1
    mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert mm
    for e in mm:   # the profiler's op inside the program span, in the file's own time base
        assert program["mm"]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= program["mm"]["ts"] + program["mm"]["dur"]


@pytest.fixture(scope="module")
def classifier():
    """A tiny ViT policy (patch 16) and ViT reward (patch 8) at 32 px."""
    tcfg = TC.ClipConfig("t", 16, 32, 2, 64, 16, 64, 2, vocab_size=49408, vision_heads_override=2,
                         text_heads_override=2)
    rcfg = TC.ClipConfig("r", 16, 32, 2, 64, 8, 64, 2, vocab_size=49408, vision_heads_override=2,
                         text_heads_override=2)
    reward = ClipReward(TC.init_clip_params(rcfg, seed=1), rcfg, RewardConfig(sample_k=2))

    def make(steps):
        ecfg = Ep.EpisodeConfig(tta_steps=steps, selection_p=0.25, lr=7e-3, sample_k=2)
        return PromptTTAClassifier(TC.init_clip_params(tcfg, seed=0), tcfg, reward, ecfg).setup(CLASSNAMES)

    return make


def prompt_tree(steps, views):
    step = lambda k: ("step", k, [("text_fwd", None, []), ("loss", None, []), ("text_bwd", None, []),
                                  ("adamw", None, [])])
    prepare = ("prepare", None, [("policy_fwd", None, []), ("select", None, []), ("reward_fwd", None, [])])
    episodes = ("episodes", None, [step(k) for k in range(1, steps + 1)] + [("final", None, [])])
    return [("group", None, ([("views", None, [])] if views else []) + [prepare, episodes])]


@pytest.mark.parametrize("steps", [3, 0])
def test_prompt_tta_records_the_span_tree(recorder, classifier, steps):
    clf = classifier(steps)
    imgs = torch.from_numpy(np.random.default_rng(4).integers(0, 256, size=(2, 3, 48, 48), dtype=np.uint8))
    adapt = clf.adapt_sources_fn(n_views=8, src_size=48, resolution=32)
    with profile(activities=[ProfilerActivity.CPU]):
        adapt(imgs, 11)
        adapt(imgs, 12)
    spans = P.recorded()
    assert tree(spans) == prompt_tree(steps, True) * 2
    groups = [s.group for s in spans]
    assert len(set(groups[:len(groups) // 2])) == 1 and groups[0] != groups[-1]
    # the direct entry points root their own group, without the views' span
    P.clear()
    P.enable()
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 8, 4, 768), dtype=np.uint8)
    clf.adapt_tokens(toks)
    clf.adapt(np.random.default_rng(6).integers(0, 256, size=(2, 8, 32, 32, 3), dtype=np.uint8))
    assert tree(P.recorded()) == prompt_tree(steps, False) * 2


def test_make_tta_episode_records_its_span_tree(recorder):
    g = torch.Generator().manual_seed(0)
    C, B, N, E = 5, 8, 2, 6
    views = torch.randn(N, B, E, generator=g)
    R = torch.randn(E, C, generator=g)
    ecfg = Ep.EpisodeConfig(tta_steps=2, selection_p=0.25, lr=1e-2, sample_k=2)
    episode = Ep.make_tta_episode(lambda t, cache, idx: Ep.take_rows(cache, idx) @ t["w"], lambda v: v @ R,
                                  ClipReward(None, None, RewardConfig(sample_k=2)).score_samples, ecfg)
    P.enable()
    episode({"w": torch.randn(E, C, generator=g)}, views, views)
    step = lambda k: ("step", k, [("policy_fwd", None, []), ("bwd", None, []), ("adamw", None, [])])
    assert tree(P.recorded()) == [("group", None, [("select", None, []), ("reward_fwd", None, []), step(1), step(2),
                                                   ("final", None, [])])]
