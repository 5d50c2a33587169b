"""The reward ensemble, the reward resize and zero-shot: the port against the
JAX package on the CPU, the same weights (the JAX package's random init, its
pytree carried across, as ``tests/test_torch_prompt_tta.py`` does) and the
same inputs, made with numpy from a seed.

The episodes are held where fp32 rounding cannot move them past the
tolerance: with these weights the port's fp32 ensemble episode and the same
episode in float64 differ by under 5e-5 in the final logits
(``test_ensemble_episode_is_well_conditioned_in_fp32``). Where the rewards
differ very little, AdamW's first step, lr * sign(g), can turn fp32 rounding
into more than 2e-4 of logits, and no fp32 implementation can be held to
2e-4 there (ROADMAP §C, C3).

Tolerances:
- ``resize_bicubic_align_corners``: 1e-5 absolute and relative (fp32, the
  same two matrix products);
- ensemble weights equal; ``score_samples`` within 1e-6 (fp32, the same sums);
- episodes (fp32): selections equal, per-step losses and final logits within
  2e-4, as ``tests/test_torch_prompt_tta.py`` holds the single reward's;
- zero-shot: equal top-1/top-5 counts, logits within 1e-4.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core import reward as JR
from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.ops import image_ops as JI
from rlcf_tpu.tasks import classification as JT
from rlcf_torch.core import reward as TR
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.models import convert as TV
from rlcf_torch.ops import image_ops as TI
from rlcf_torch.tasks import classification as TT

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
EPISODE_TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache()
def _pair(jcfg, tcfg, seed):
    """A tower's JAX random parameters and the port's, carried across (one
    jitted init per config and seed; the towers are frozen, so tests share them)."""
    jp = jax.jit(lambda key: JC.init_clip_params(key, jcfg))(jax.random.PRNGKey(seed))
    return jp, TV.from_jax_params(jax_params_numpy(jp), tcfg)


def _rewards(members, weighted=True):
    """The same members as a JAX and a port reward: one ``ClipReward`` or a
    ``ClipRewardEnsemble``; ``members`` (jax cfg, port cfg, seed)."""
    jr, tr = [], []
    for jcfg, tcfg, seed in members:
        jp, tp = _pair(jcfg, tcfg, seed)
        jr.append(JR.ClipReward(jp, jcfg, JR.RewardConfig(sample_k=2)))
        tr.append(TR.ClipReward(tp, tcfg, TR.RewardConfig(sample_k=2)))
    if len(members) == 1:
        return jr[0], tr[0]
    return (JR.ClipRewardEnsemble(jr, JR.RewardConfig(sample_k=2), weighted=weighted),
            TR.ClipRewardEnsemble(tr, TR.RewardConfig(sample_k=2), weighted=weighted))


# tiny towers: a ViT policy at 32 px, a ViT reward at 64 px (another
# resolution: the selected views are resized), test-tiny-rn (64 px), and a
# ResNet policy with the tokenizer's full vocabulary
POLICY = tiny_cfgs()
VIT64 = tiny_cfgs("r64", embed=16, res=64, layers=1, width=64, patch=16)
TINY_RN = (JC.get_config("test-tiny-rn"), TC.get_config("test-tiny-rn"))
_RN_ARGS = ("rn-policy", 16, 64, (1, 1, 1, 1), 16, None, 64, 1)
RN_POLICY = (JC.ClipConfig(*_RN_ARGS), TC.ClipConfig(*_RN_ARGS))


@pytest.mark.parametrize("src,dst", [(32, 64), (224, 336), (224, 448)])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(src + dst).normal(size=(2, src, src, 3)).astype(np.float32)
    want = np.asarray(JI.resize_bicubic_align_corners(jnp.asarray(x), dst))
    got = TI.resize_bicubic_align_corners(torch.from_numpy(x), dst)
    assert got.shape == (2, dst, dst, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TT.resize_bicubic_batch(torch.from_numpy(x), dst).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("names", [("ViT-L/14@336px", "RN50x64", "ViT-L/14"), ("ViT-B/16", "test-tiny-rn")])
def test_ensemble_weights_match_jax(names, weighted):
    """The confidence weights, normalized and rounded to 2 places as the
    reference rounds them (a member outside the table weighs 1)."""
    member = lambda name: types.SimpleNamespace(cfg=types.SimpleNamespace(name=name))
    want = JR.ClipRewardEnsemble([member(n) for n in names], JR.RewardConfig(), weighted=weighted).weights
    got = TR.ClipRewardEnsemble([member(n) for n in names], TR.RewardConfig(), weighted=weighted).weights
    assert got == want
    if weighted and len(names) == 3:
        assert got == [0.56, 0.17, 0.28]


@pytest.mark.parametrize("process_batch", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_score_samples_matches_jax(stacked, process_batch):
    """One episode's sims of 3 members (a list or stacked [M, S, C]), and N
    episodes' stacked [N, M, S, C] against JAX per episode."""
    rng = np.random.default_rng(11)
    N, M, S, C, K = 2, 3, 4, 7, 3
    sims = rng.uniform(-0.2, 0.6, size=(N, M, S, C)).astype(np.float32)
    idx = np.stack([np.stack([rng.permutation(C)[:K] for _ in range(S)]) for _ in range(N)]).astype(np.int64)
    member = lambda name: types.SimpleNamespace(cfg=types.SimpleNamespace(name=name))
    names = ("ViT-L/14@336px", "RN50x64", "ViT-L/14")
    kw = dict(sample_k=K, process_batch=process_batch)
    jens = JR.ClipRewardEnsemble([member(n) for n in names], JR.RewardConfig(**kw))
    tens = TR.ClipRewardEnsemble([member(n) for n in names], TR.RewardConfig(**kw))
    for n in range(N):
        jsims = jnp.asarray(sims[n]) if stacked else [jnp.asarray(s) for s in sims[n]]
        tsims = torch.from_numpy(sims[n]) if stacked else [torch.from_numpy(s) for s in sims[n]]
        want = np.asarray(jens.score_samples(jsims, jnp.asarray(idx[n])))
        np.testing.assert_allclose(tens.score_samples(tsims, torch.from_numpy(idx[n])).numpy(), want,
                                   rtol=1e-6, atol=1e-6)
        batched = tens.score_samples(torch.from_numpy(sims), torch.from_numpy(idx))
        np.testing.assert_allclose(batched[n].numpy(), want.reshape(-1), rtol=1e-6, atol=1e-6)


def _classifiers(policy, reward_members, loss="rlcf", pseed=0):
    (jpcfg, tpcfg) = policy
    jp, tp = _pair(jpcfg, tpcfg, pseed)
    jr, tr = _rewards(reward_members)
    ek = dict(tta_steps=3, selection_p=0.25, lr=7e-3, sample_k=2, loss=loss)
    jclf = JT.PromptTTAClassifier(jp, jpcfg, jr, JEpisodeConfig(**ek), ctx_init="a photo of a").setup(CLASSNAMES)
    tclf = TT.PromptTTAClassifier(tp, tpcfg, tr, EpisodeConfig(**ek), ctx_init="a photo of a").setup(CLASSNAMES)
    return jclf, tclf


def _assert_same_episodes(t, j):
    (tl, taux), (jl, jaux) = t, j
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **EPISODE_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **EPISODE_TOL)
    assert bool(torch.isfinite(tl).all())


@pytest.mark.parametrize("loss", ["rlcf", "tpt"])
def test_nhwc_adapt_with_an_ensemble_matches_jax(loss):
    """A ViT policy at 32 px; the ensemble of a ViT reward at 64 px and
    test-tiny-rn, each taking the selected views resized to 64 px."""
    jclf, tclf = _classifiers(POLICY, [(*VIT64, 1), (*TINY_RN, 2)], loss=loss)
    views = np.random.default_rng(3).integers(0, 256, size=(2, 16, 32, 32, 3), dtype=np.uint8)
    _assert_same_episodes(tclf.adapt(views), jclf.adapt(views))
    _, _, r_sim = tclf.prepare(torch.from_numpy(views))
    assert tuple(r_sim.shape) == (2, 2, 4, len(CLASSNAMES))   # stacked [N, M, S, C]


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def test_ensemble_episode_is_well_conditioned_in_fp32():
    """The ensemble episode of ``test_nhwc_adapt_with_an_ensemble_matches_jax``
    in fp32 against the same in float64: under 5e-5 in the final logits, so
    that the 2e-4 tolerance against JAX measures the port, not fp32's noise."""
    _, tp = _pair(*POLICY, 0)
    _, tr = _rewards([(*VIT64, 1), (*TINY_RN, 2)])
    views = np.random.default_rng(3).integers(0, 256, size=(2, 16, 32, 32, 3), dtype=np.uint8)
    ek = EpisodeConfig(tta_steps=3, selection_p=0.25, lr=7e-3, sample_k=2, loss="rlcf")
    logits = {}
    for dtype in (torch.float32, torch.float64):
        members = [TR.ClipReward(_cast(m.params, dtype), m.cfg, m.rcfg) for m in tr.members]
        clf = TT.PromptTTAClassifier(_cast(tp, dtype), POLICY[1], TR.ClipRewardEnsemble(members, tr.rcfg), ek,
                                     ctx_init="a photo of a").setup(CLASSNAMES)
        logits[dtype] = clf.adapt(views)[0].double()
    assert float((logits[torch.float32] - logits[torch.float64]).abs().max()) < 5e-5


def test_ensemble_refuses_kd_and_token_mode():
    jp, tp = _pair(*POLICY, 0)
    _, tr = _rewards([(*VIT64, 1), (*TINY_RN, 2)])
    with pytest.raises(ValueError, match="'rlcf'/'tpt'"):
        TT.PromptTTAClassifier(tp, POLICY[1], tr, EpisodeConfig(loss="kd"))
    clf = TT.PromptTTAClassifier(tp, POLICY[1], tr, EpisodeConfig(sample_k=2)).setup(CLASSNAMES)
    with pytest.raises(ValueError, match="needs token mode: a ViT policy and a single reward"):
        clf.adapt_tokens(np.zeros((1, 4, 4, 768), dtype=np.uint8))


@pytest.mark.parametrize("attn", ["dense", "fused"])
def test_token_path_with_a_reward_at_another_resolution_matches_jax(attn):
    """Token mode, one ViT reward at 64 px: the selected views depatchified
    and resized (``attn="fused"`` runs the kernel's plain version here)."""
    jclf, tclf = _classifiers(POLICY, [(*VIT64, 1)])
    tclf.attn = tclf.text_attn = tclf.reward_attn = attn
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 16, 4, 768), dtype=np.uint8)
    _assert_same_episodes(tclf.adapt_tokens(toks), jclf.adapt_tokens(toks))


def test_resnet_policy_adapt_matches_jax():
    """A ResNet policy through the NHWC ``adapt`` (frozen; only the text
    tower is differentiated), against a ViT reward at 32 px (views resized
    down from 64)."""
    jclf, tclf = _classifiers(RN_POLICY, [(*POLICY, 1)])
    views = np.random.default_rng(5).integers(0, 256, size=(2, 8, 64, 64, 3), dtype=np.uint8)
    _assert_same_episodes(tclf.adapt(views), jclf.adapt(views))
    with pytest.raises(ValueError, match="token mode"):
        tclf.adapt_sources_fn(n_views=8, resolution=64)


def _record(monkeypatch, meter_cls, sink):
    update = meter_cls.update

    def recording(self, logits, labels):
        sink.append(np.asarray(logits))
        return update(self, logits, labels)

    monkeypatch.setattr(meter_cls, "update", recording)


@pytest.mark.parametrize("ensemble", [False, True])
def test_zero_shot_matches_jax(monkeypatch, ensemble):
    """``zero_shot_eval`` (the tiny ViT) and ``zero_shot_eval_ensemble`` (it
    with test-tiny-rn, whose 64 px input is resized from the batch's 32) on
    the same synthetic images: the same counts, logits within 1e-4."""
    from rlcf_tpu.data.datasets import SyntheticDataset as JSynthetic
    from rlcf_tpu.metrics.classification import AccuracyMeter as JMeter
    from rlcf_torch.data.datasets import SyntheticDataset as TSynthetic
    from rlcf_torch.metrics.classification import AccuracyMeter as TMeter

    towers = [(*POLICY, 0)] + ([(*TINY_RN, 1)] if ensemble else [])
    pairs = [(_pair(j, t, s), j, t) for j, t, s in towers]
    jlog, tlog = [], []
    _record(monkeypatch, JMeter, jlog)
    _record(monkeypatch, TMeter, tlog)
    kw = dict(batch_size=4, resolution=32, limit=7, seed=3)
    names = CLASSNAMES
    if ensemble:
        want = JT.zero_shot_eval_ensemble([(jp, j) for (jp, _), j, _ in pairs], JSynthetic(n=9, n_classes=5), names,
                                          **kw)
        got = TT.zero_shot_eval_ensemble([(tp, t) for (_, tp), _, t in pairs], TSynthetic(n=9, n_classes=5), names,
                                         **kw)
    else:
        ((jp, tp), j, t), = pairs
        want = JT.zero_shot_eval(jp, j, JSynthetic(n=9, n_classes=5), names, **kw)
        got = TT.zero_shot_eval(tp, t, TSynthetic(n=9, n_classes=5), names, **kw)
    assert got == want
    assert [x.shape for x in tlog] == [x.shape for x in jlog] == [(4, 5), (3, 5)]
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_iter_batches_match_jax():
    from rlcf_tpu.data.datasets import SyntheticDataset as JSynthetic, iter_batches as jiter
    from rlcf_torch.data.datasets import SyntheticDataset as TSynthetic, iter_batches as titer

    kw = dict(batch_size=3, resolution=48, limit=5, seed=1)
    for (ti, tl), (ji, jl) in zip(titer(TSynthetic(n=8), **kw), jiter(JSynthetic(n=8), **kw)):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def _tta_argv(tmp_path, *extra):
    return [".", "--device", "cpu", "--test_sets", "synthetic", "--limit", "3", "--arch", "test-small",
            "--reward_arch", "test-small", "--precision", "fp32", "--resolution", "64", "--batch_size", "8",
            "--tta_steps", "2", "--sample_k", "2", "--lr", "7e-3", "--episode_group", "2",
            "--output", str(tmp_path), *extra]


def test_tta_cls_cli_runs_the_ensemble(tmp_path, monkeypatch):
    """``--multiple_reward_models 1`` with tiny members (a ViT at the views'
    64 px, test-tiny-rn, a ViT at 32 px): NHWC host views (``--viewgen
    native``) through ``adapt``, member i from seed --seed + i + 1."""
    from rlcf_torch.cli import common, tta_cls
    from rlcf_torch.data import native

    if not native.available():
        pytest.skip("no C++ toolchain for the native view pipeline")
    monkeypatch.setattr(common, "ENSEMBLE_ARCHS", ["test-small", "test-tiny-rn", "test-tiny-vit"])
    seen = []
    adapt = TT.PromptTTAClassifier.adapt

    def recording(self, views):
        out = adapt(self, views)
        seen.append((np.asarray(views).shape, [m.cfg.name for m in self.reward.members], self.reward.weights))
        return out

    monkeypatch.setattr(TT.PromptTTAClassifier, "adapt", recording)
    r = tta_cls.main(_tta_argv(tmp_path, "--multiple_reward_models", "1", "--viewgen", "native"))
    assert r["synthetic"]["n"] == 3 and len(r["synthetic"]["group_seconds"]) == 2
    assert seen[0] == ((2, 8, 64, 64, 3), ["test-small", "test-tiny-rn", "test-tiny-vit"], [0.33, 0.33, 0.33])


def test_ensemble_members_load_from_reward_checkpoints(tmp_path, monkeypatch):
    """``--reward_checkpoints``: one OpenAI-format checkpoint a member, in
    ``ENSEMBLE_ARCHS``' order (a ViT and a ResNet here), each read into the
    member it names; a count that does not match the members is refused."""
    import argparse

    from rlcf_torch.cli import common
    from torch_port_fixtures import openai_state_dict

    monkeypatch.setattr(common, "ENSEMBLE_ARCHS", ["test-small", "test-tiny-rn"])
    paths = []
    for i, arch in enumerate(common.ENSEMBLE_ARCHS):
        paths.append(str(tmp_path / f"member{i}.pt"))
        torch.save(openai_state_dict(TC.get_config(arch), seed=i), paths[-1])
    args = argparse.Namespace(sample_k=2, reward_process=1, process_batch=0, reward_amplify=0, resolution=64,
                              precision="fp32", multiple_reward_models=1, reward_checkpoints=paths, seed=0,
                              weighted_scores=1, reward_checkpoint=None, reward_arch="test-small")
    ens = common.build_reward(args, torch.device("cpu"))
    assert [m.cfg.is_vit for m in ens.members] == [True, False] and ens.weights == [0.5, 0.5]
    want = openai_state_dict(TC.get_config("test-tiny-rn"), seed=1)["visual.attnpool.c_proj.bias"]
    assert torch.equal(ens.members[1].params["visual"]["attnpool"]["c_b"], want)
    with pytest.raises(SystemExit, match="one checkpoint per ensemble member"):
        common.build_reward(argparse.Namespace(**{**vars(args), "reward_checkpoints": paths[:1]}), torch.device("cpu"))


def test_tta_cls_refuses_fused_views_with_an_ensemble(tmp_path):
    """As the JAX CLI: token mode (``--viewgen fused``) excludes ensembles,
    with the JAX CLI's message, which names the device generator."""
    from rlcf_torch.cli import tta_cls

    with pytest.raises(SystemExit, match="--viewgen fused needs a ViT policy in token mode") as exc:
        tta_cls.main(_tta_argv(tmp_path, "--viewgen", "fused", "--multiple_reward_models", "1"))
    assert str(exc.value).endswith("; use --viewgen device")


def test_tta_cls_cli_resizes_for_a_single_reward(tmp_path):
    """``--reward_arch`` at another resolution than the views (test-tiny-vit,
    32 px, against 64 px views), the fused views in token mode."""
    from rlcf_torch.cli import tta_cls

    argv = _tta_argv(tmp_path, "--viewgen", "fused")
    argv[argv.index("--reward_arch") + 1] = "test-tiny-vit"
    r = tta_cls.main(argv)
    assert r["synthetic"]["n"] == 3


def test_zero_shot_cli_runs_an_ensemble(tmp_path):
    from rlcf_torch.cli import zero_shot

    r = zero_shot.main([".", "--device", "cpu", "--test_sets", "synthetic", "--limit", "6", "--batch_size", "4",
                        "--resolution", "64", "--precision", "fp32", "--ensemble_archs", "test-small", "test-tiny-rn",
                        "--output", str(tmp_path)])
    assert set(r["synthetic"]) == {"top1", "top5"} and (tmp_path / "results.json").exists()
