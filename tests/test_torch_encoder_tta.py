"""Encoder TTA on the CPU against ``rlcf_tpu``: the generic episode engine
(``core/episode.py::make_tta_episode``, both step-0 strategies, every loss),
``EncoderTTAClassifier.adapt`` at N=2 against JAX's vmapped episodes (u8 and
float views, only_norm, momentum across two calls, rlcf/tpt/kd), the three
``remat`` settings, and the ``tune_cls`` entry point (a ResNet policy:
tests/test_torch_encoder_resnet.py).

Tolerances (fp32): logits and losses within atol 2e-4 + rtol 1e-3,
selections equal. Adapted weights: every element within 2.1 * lr * steps of
JAX's, and all but 0.5% within 1e-5. AdamW's first step moves a weight by
lr * g / (|g| + eps), about lr * sign(g), and its later steps by at most
~1.004 * lr each (bias-corrected moments over 3 steps), so a weight whose
gradient is zero in exact arithmetic, like a key bias (softmax ignores a
shift shared by all of a query's scores), moves by +-lr on rounding noise in
either package: up to 2 * lr apart a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core import episode as JEp
from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks.classification import EncoderTTAClassifier as JEncoder
from rlcf_torch.core import episode as Ep
from rlcf_torch.core import policy as Po
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks.classification import EncoderTTAClassifier

from torch_port_fixtures import jax_params_numpy, openai_state_dict, tiny_cfgs, weights_close

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
TOL = dict(rtol=1e-3, atol=2e-4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the episode engine on a linear policy
# ---------------------------------------------------------------------------

D, C, B, N = 6, 5, 8, 2


def _toy():
    rng = np.random.default_rng(0)
    return dict(w=rng.normal(size=(D, C)).astype(np.float32) * 0.5, b=rng.normal(size=C).astype(np.float32) * 0.1,
                reward=rng.normal(size=(D, C)).astype(np.float32), views=rng.normal(size=(N, B, D)).astype(np.float32))


def _run_both(loss, selection_p, step0_reuse=None, predict_batched=False, tta_steps=3):
    toy = _toy()
    ecfg = dict(tta_steps=tta_steps, selection_p=selection_p, lr=0.05, sample_k=2, loss=loss)
    rcfg = dict(sample_k=2)
    R = toy["reward"]
    kw = dict(predict_batched=predict_batched, teacher_scale=2.0, return_adapted=True, step0_reuse=step0_reuse)

    jep = JEp.make_tta_episode(lambda t, cache, idx: cache[idx] @ t["w"] + t["b"], lambda v: v @ R,
                               JClipReward(None, None, JRewardConfig(**rcfg)).score_samples,
                               JEp.EpisodeConfig(**ecfg), **kw)
    jfn = jax.jit(jax.vmap(lambda t, v: jep(t, v, v), in_axes=(None, 0)))
    jl, jaux = jfn({"w": jnp.asarray(toy["w"]), "b": jnp.asarray(toy["b"])}, jnp.asarray(toy["views"]))

    Rt = torch.from_numpy(R)
    tep = Ep.make_tta_episode(lambda t, cache, idx: Ep.take_rows(cache, idx) @ t["w"] + t["b"][:, None],
                              lambda v: v @ Rt, ClipReward(None, None, RewardConfig(**rcfg)).score_samples,
                              Ep.EpisodeConfig(**ecfg), **kw)
    views = torch.from_numpy(toy["views"])
    tl, taux = tep({"w": torch.from_numpy(toy["w"]), "b": torch.from_numpy(toy["b"])}, views, views)
    return (jl, jaux), (tl, taux)


@pytest.mark.parametrize("loss", ["rlcf", "tpt", "kd", "dkd", "atkd"])
@pytest.mark.parametrize("selection_p,step0_reuse", [(0.25, None), (1.0, None), (0.25, True)],
                         ids=["recompute", "reuse-all-views", "reuse-forced"])
def test_make_tta_episode_matches_jax(loss, selection_p, step0_reuse):
    """Step 0 recomputed on the selected views (selection_p 0.25), or served
    by the selection forward's graph (1.0 keeps every view; or forced)."""
    (jl, jaux), (tl, taux) = _run_both(loss, selection_p, step0_reuse)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    _close(taux["losses"], jaux["losses"])
    _close(tl, jl)
    assert tl.shape == (N, 1, C) and taux["losses"].shape == (N, 3)
    for k in ("w", "b"):
        _close(taux["adapted"][k], jaux["adapted"][k])


@pytest.mark.parametrize("tta_steps,predict_batched", [(0, False), (2, True)])
def test_make_tta_episode_no_steps_and_batched_prediction(tta_steps, predict_batched):
    (jl, jaux), (tl, taux) = _run_both("rlcf", 0.5, predict_batched=predict_batched, tta_steps=tta_steps)
    assert tl.shape == (N, B if predict_batched else 1, C) and taux["losses"].shape == (N, tta_steps)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    _close(tl, jl)
    if tta_steps == 0:   # nothing adapted: the anchor, once per episode
        toy = _toy()
        assert torch.equal(taux["adapted"]["w"], torch.from_numpy(toy["w"]).expand(N, D, C))


# ---------------------------------------------------------------------------
# EncoderTTAClassifier against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs()
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    jrp = JC.init_clip_params(jax.random.PRNGKey(1), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jrp=jrp, tp=TV.from_jax_params(jax_params_numpy(jp), tcfg),
                trp=TV.from_jax_params(jax_params_numpy(jrp), tcfg))


def _pair(t, loss="rlcf", selection_p=0.25, lr=1e-3, **kw):
    ek = dict(tta_steps=3, selection_p=selection_p, lr=lr, sample_k=2, loss=loss)
    jclf = JEncoder(t["jp"], t["jcfg"], JClipReward(t["jrp"], t["jcfg"], JRewardConfig(sample_k=2)),
                    JEp.EpisodeConfig(**ek), **kw).setup(CLASSNAMES)
    tclf = EncoderTTAClassifier(t["tp"], t["tcfg"], ClipReward(t["trp"], t["tcfg"], RewardConfig(sample_k=2)),
                                Ep.EpisodeConfig(**ek), **kw).setup(CLASSNAMES)
    return jclf, tclf


def _views(seed=0, u8=True, n=2, v=8):
    rng = np.random.default_rng(seed)
    if u8:
        return rng.integers(0, 256, size=(n, v, 32, 32, 3), dtype=np.uint8)
    return rng.normal(size=(n, v, 32, 32, 3)).astype(np.float32)


def _assert_episodes_equal(jout, tout, steps=3):
    (jl, jaux), (tl, taux) = jout, tout
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    _close(taux["losses"], jaux["losses"])
    _close(tl, jl)
    assert tl.shape == (2, len(CLASSNAMES)) and taux["losses"].shape == (2, steps)


@pytest.mark.parametrize("loss,u8,selection_p,only_norm", [
    ("rlcf", True, 0.25, False), ("rlcf", False, 0.25, False), ("tpt", True, 0.25, False),
    ("kd", True, 0.25, False), ("rlcf", True, 1.0, False), ("rlcf", True, 0.25, True)],
    ids=["rlcf-u8", "rlcf-float", "tpt-u8", "kd-u8", "rlcf-all-views", "rlcf-only-norm"])
def test_encoder_adapt_matches_jax(towers, loss, u8, selection_p, only_norm):
    jclf, tclf = _pair(towers, loss, selection_p, only_norm=only_norm)
    views = _views(u8=u8)
    _assert_episodes_equal(jclf.adapt(views), tclf.adapt(views))


def test_encoder_momentum_across_two_calls_matches_jax(towers):
    """update_freq 2 with N=2: the first call's two episodes fold into the
    EMA in order and re-anchor; the second call starts from the new anchor.
    The anchors are held with the adapted-weight tolerance; the second call
    is compared from the same anchor in both packages."""
    lr = 1e-3
    kw = dict(momentum_update=True, update_freq=2, momentum=0.5, update_w=0.8)
    jclf, tclf = _pair(towers, lr=lr, **kw)
    _assert_episodes_equal(jclf.adapt(_views(0)), tclf.adapt(_views(0)))
    assert tclf.momentum_state.counter == jclf.momentum_state.counter == 0
    anchor = Po.tree_leaves(tclf.momentum_state.reset_params)
    assert not all(torch.equal(a, b) for a, b in zip(anchor, Po.tree_leaves(tclf.trainable0)))
    weights_close(tclf.momentum_state.reset_params, jclf.momentum_state.reset_params, lr, 3)
    weights_close(tclf.momentum_state.ema_params, jclf.momentum_state.ema_params, lr, 3)
    jclf.momentum_state.reset_params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), tclf.momentum_state.reset_params)
    _assert_episodes_equal(jclf.adapt(_views(1)), tclf.adapt(_views(1)))


def test_encoder_adapted_weights_match_jax(towers):
    """One episode's adapted visual weights (JAX: the momentum EMA with
    momentum 0 holds them) within the adapted-weight tolerance."""
    lr = 1e-3
    jclf, tclf = _pair(towers, lr=lr, momentum_update=True, momentum=0.0, update_freq=100)
    views = _views(2, n=1)
    jclf.adapt(views)
    _, aux = tclf.adapt(views, return_adapted=True)
    weights_close(Po.tree_map(lambda v: v[0], aux["adapted"]), jclf.momentum_state.ema_params, lr, 3)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn", ["dense", "fused"])
def test_remat_settings_give_equal_gradients(towers, attn):
    """The visual tower's gradients with remat False, True and "save_attn",
    per-episode weights of two episodes, through the dense math or the fused
    attention's plain version: equal."""
    tcfg = towers["tcfg"]
    visual = towers["tp"]["visual"]
    tokens = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 4, 768)).astype(np.float32))
    grads = {}
    for remat in (False, True, "save_attn"):
        t = Po.tree_map(lambda v: v.detach()[None].repeat_interleave(2, 0).requires_grad_(True), visual)
        feats = TC.encode_image_tokens({"visual": t}, tcfg, tokens, attn=attn, remat=remat)
        (feats.sin().sum()).backward()
        grads[remat] = [v.grad for v in Po.tree_leaves(t)]
    for remat in (True, "save_attn"):
        for a, b in zip(grads[remat], grads[False]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_per_episode_tower_equals_one_tower_per_episode(towers):
    """Weights stacked on an episode axis give each episode what its own
    weights give alone."""
    tcfg = towers["tcfg"]
    v0 = towers["tp"]["visual"]
    v1 = Po.tree_map(lambda v: v * 1.01, v0)
    tokens = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 4, 768)).astype(np.float32))
    stacked = Po.tree_map(lambda a, b: torch.stack([a, b]), v0, v1)
    got = TC.encode_image_tokens({"visual": stacked}, tcfg, tokens)
    for n, v in enumerate((v0, v1)):
        torch.testing.assert_close(got[n], TC.encode_image_tokens({"visual": v}, tcfg, tokens[n]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", [False, "save_attn"])
def test_encoder_adapt_equal_across_remat(towers, remat):
    _, full = _pair(towers)
    _, other = _pair(towers, remat=remat)
    views = _views(5)
    (l1, a1), (l2, a2) = full.adapt(views), other.adapt(views)
    assert torch.equal(a1["selected"], a2["selected"])
    torch.testing.assert_close(l1, l2, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# refusals and the entry point
# ---------------------------------------------------------------------------


def test_encoder_refuses_what_the_port_does_not_run(towers):
    t = towers
    ecfg = Ep.EpisodeConfig()
    reward = ClipReward(t["trp"], t["tcfg"], RewardConfig())
    with pytest.raises(ValueError, match="single ClipReward"):
        EncoderTTAClassifier(t["tp"], t["tcfg"], object(), ecfg)
    # a ResNet policy and bn_prior are taken (tests/test_torch_encoder_resnet.py holds them to JAX)
    rn = TC.get_config("test-tiny-rn")
    assert EncoderTTAClassifier(TC.init_clip_params(rn), rn, reward, ecfg, bn_prior=0.5).bn_prior == 0.5
    # a reward at another resolution takes the views resized
    big = TC.ClipConfig("r", 16, 64, 1, 64, 16, 64, 1, vision_heads_override=2, text_heads_override=2)
    other = ClipReward(TC.init_clip_params(big), big, RewardConfig())
    clf = EncoderTTAClassifier(t["tp"], t["tcfg"], other, ecfg).setup(CLASSNAMES)
    logits, _ = clf.adapt(_views())
    assert bool(torch.isfinite(logits).all())


def _cli_argv(tmp_path, *extra):
    return [".", "--device", "cpu", "--test_sets", "synthetic", "--limit", "4", "--arch", "test-small",
            "--reward_arch", "test-small", "--precision", "fp32", "--resolution", "64", "--batch_size", "8",
            "--tta_steps", "2", "--sample_k", "2", "--lr", "1e-4", "--episode_group", "2",
            "--output", str(tmp_path), *extra]


def test_tune_cls_cpu_drive_matches_jax(tmp_path):
    """The tiny tune_cls drive from one OpenAI-format checkpoint per tower:
    each group's episodes equal the JAX package's EncoderTTAClassifier on
    the views the port built."""
    from rlcf_tpu.models.convert import convert_clip_state_dict
    from rlcf_torch.cli import tune_cls

    cfg = TC.get_config("test-small")
    ckpts = []
    for seed in (0, 1):
        path = tmp_path / f"clip{seed}.pt"
        torch.save(openai_state_dict(cfg, seed=seed), path)
        ckpts.append(str(path))
    seen = []
    adapt = EncoderTTAClassifier.adapt

    def recording(self, views, **kw):
        logits, aux = adapt(self, views, **kw)
        seen.append((views.clone(), logits, aux))
        return logits, aux

    EncoderTTAClassifier.adapt = recording
    try:
        r = tune_cls.main(_cli_argv(tmp_path, "--clip_checkpoint", ckpts[0], "--reward_checkpoint", ckpts[1]))
    finally:
        EncoderTTAClassifier.adapt = adapt
    assert r["synthetic"]["n"] == 4 and len(r["synthetic"]["group_seconds"]) == 2 and len(seen) == 2
    assert (tmp_path / "results.json").exists()

    jp, jcfg = convert_clip_state_dict(openai_state_dict(cfg, 0))
    jrp, jrcfg = convert_clip_state_dict(openai_state_dict(cfg, 1))
    ek = dict(tta_steps=2, selection_p=0.1, lr=1e-4, sample_k=2)
    jclf = JEncoder(jp, jcfg, JClipReward(jrp, jrcfg, JRewardConfig(sample_k=2)), JEp.EpisodeConfig(**ek),
                    prompt_prefix="a photo of a").setup(["class_%d" % i for i in range(10)])
    for views, logits, aux in seen:
        assert views.dtype == torch.float32 and tuple(views.shape) == (2, 8, 64, 64, 3)
        jl, jaux = jclf.adapt(views.numpy())
        np.testing.assert_array_equal(aux["selected"].numpy(), np.asarray(jaux["selected"]))
        _close(aux["losses"], jaux["losses"])
        _close(logits, jl)


@pytest.mark.parametrize("extra,item", [
    (("--dp", "2"), "A14"), (("--hard_aug", "1"), "A16"), (("--download", "1"), "A15")])
def test_tune_cls_refusals_name_their_roadmap_item(tmp_path, extra, item):
    """--dp (ROADMAP A14) is ported: in a single process the mesh's error names
    the launcher. --hard_aug (A16) runs, its groups' views drawn with the
    BYOL recipe from the JAX entry point's seeds. --download stays refused."""
    from rlcf_torch.cli import tune_cls
    from rlcf_torch.data.augment import make_view_generator

    if item == "A14":
        with pytest.raises(ValueError, match="torchrun"):
            tune_cls.main(_cli_argv(tmp_path, *extra))
        return
    if item == "A16":
        seen = []
        adapt = EncoderTTAClassifier.adapt

        def recording(self, views, **kw):
            seen.append(views.clone())
            return adapt(self, views, **kw)

        EncoderTTAClassifier.adapt = recording
        try:
            r = tune_cls.main(_cli_argv(tmp_path, *extra))
        finally:
            EncoderTTAClassifier.adapt = adapt
        assert r["synthetic"]["n"] == 4 and len(seen) == 2
        from rlcf_torch.data.datasets import build_dataset, iter_canonical

        imgs = [img for img, _ in iter_canonical(build_dataset("synthetic", ".", n_classes=10), 256, seed=0, limit=4)]
        gen = make_view_generator(8, 64, hard_aug=True)
        for g, views in enumerate(seen):   # the group's views: the generator seeded seed * 7 + group
            want = gen(torch.from_numpy(np.stack(imgs[2 * g:2 * g + 2])), torch.Generator().manual_seed(0 * 7 + g))
            assert torch.equal(views, want)
        return
    with pytest.raises(SystemExit, match=f"not ported yet.*ROADMAP {item}"):
        tune_cls.main(_cli_argv(tmp_path, *extra))


def test_tune_cls_help_names_the_view_generator(capsys):
    from rlcf_torch.cli import tune_cls

    with pytest.raises(SystemExit):
        tune_cls.get_args(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "make_view_generator" in out and "--seed * 7 + group" in out and "A16" not in out
