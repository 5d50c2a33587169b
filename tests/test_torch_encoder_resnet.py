"""Encoder TTA through a ResNet policy on the CPU, against ``rlcf_tpu``: the
per-episode convolution, BatchNorm (with the BN prior) and tower against a
loop over episodes, ``EncoderTTAClassifier.adapt`` on ``test-tiny-rn`` at N=2
against JAX's vmapped episodes (full weights, only_norm, ``bn_prior``,
momentum across two calls), ``norm_only_filter`` on the ResNet tree, and the
``tune_cls`` entry point with ``--prior_strength``.

Tolerances (fp32): episodes as tests/test_torch_encoder_tta.py (logits and
losses within atol 2e-4 + rtol 1e-3, selections equal); a per-episode layer
or tower against the same layer run per episode 1e-5 absolute + 1e-5 relative
(a grouped convolution sums in another order than one convolution a group).
"""

import jax
import numpy as np
import pytest
import torch

from rlcf_tpu.core import episode as JEp
from rlcf_tpu.core import policy as JPo
from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.models import convert as JV
from rlcf_tpu.tasks.classification import EncoderTTAClassifier as JEncoder
from rlcf_torch.core import episode as Ep
from rlcf_torch.core import policy as Po
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.models import convert as TV
from rlcf_torch.models import layers as TL
from rlcf_torch.tasks.classification import EncoderTTAClassifier

from torch_port_fixtures import jax_params_numpy, openai_state_dict, tiny_cfgs

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
TOL = dict(rtol=1e-3, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
RES = 64   # test-tiny-rn's resolution


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# per-episode layers and tower against a loop over episodes
# ---------------------------------------------------------------------------


def _stack_channels(xs):
    """Per-episode NCHW maps -> one map with the episodes on the channels, episode-major."""
    return torch.cat(xs, dim=1).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("stride,padding,k", [(1, 0, 1), (2, 1, 3), (1, 1, 3)])
def test_per_episode_conv2d_equals_a_loop(stride, padding, k):
    rng = np.random.default_rng(k + stride)
    xs = [torch.from_numpy(rng.normal(size=(3, 4, 8, 8)).astype(np.float32)) for _ in range(2)]
    ws = [torch.from_numpy(rng.normal(size=(6, 4, k, k)).astype(np.float32)) for _ in range(2)]
    got = TL.conv2d(_stack_channels(xs), torch.stack(ws), stride=stride, padding=padding)
    want = _stack_channels([TL.conv2d(x, w, stride=stride, padding=padding) for x, w in zip(xs, ws)])
    torch.testing.assert_close(got, want, **LAYER_TOL)


@pytest.mark.parametrize("prior", [None, 0.0, 0.5])
def test_per_episode_batch_norm_equals_a_loop(prior):
    """With a prior each episode's batch statistics are its own views',
    never the N episodes' together."""
    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(rng.normal(loc=n, size=(5, 4, 3, 3)).astype(np.float32)) for n in range(2)]
    ps = [{"w": torch.from_numpy(rng.normal(size=4).astype(np.float32)),
           "b": torch.from_numpy(rng.normal(size=4).astype(np.float32)),
           "mean": torch.from_numpy(rng.normal(size=4).astype(np.float32)),
           "var": torch.from_numpy(rng.uniform(0.5, 2, size=4).astype(np.float32))} for _ in range(2)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    got = TL.batch_norm_2d(_stack_channels(xs), stacked, prior=prior)
    want = _stack_channels([TL.batch_norm_2d(x, p, prior=prior) for x, p in zip(xs, ps)])
    torch.testing.assert_close(got, want, **LAYER_TOL)
    pooled = TL.avg_pool(got, 3)   # per channel: per episode as it stands
    torch.testing.assert_close(pooled, _stack_channels([TL.avg_pool(w, 3) for w in want.split(4, dim=1)]),
                               **LAYER_TOL)


@pytest.fixture(scope="module")
def rn():
    """test-tiny-rn in both packages from one OpenAI-format state dict
    (non-trivial BatchNorm statistics), and a tiny ViT reward at 64 px."""
    cfg = TC.get_config("test-tiny-rn")
    jp, jcfg = JV.convert_clip_state_dict(openai_state_dict(cfg, seed=0))
    jrcfg, trcfg = tiny_cfgs(res=RES)
    jrp = JC.init_clip_params(jax.random.PRNGKey(1), jrcfg)
    return dict(jcfg=jcfg, tcfg=cfg, jp=jp, tp=TV.from_jax_params(jax_params_numpy(jp), cfg), jrcfg=jrcfg,
                trcfg=trcfg, jrp=jrp, trp=TV.from_jax_params(jax_params_numpy(jrp), trcfg))


@pytest.mark.parametrize("bn_prior", [None, 0.5])
def test_per_episode_resnet_tower_equals_one_tower_per_episode(rn, bn_prior):
    v0 = rn["tp"]["visual"]
    v1 = Po.tree_map(lambda v: v * 1.01, v0)
    imgs = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, RES, RES, 3)).astype(np.float32))
    stacked = Po.tree_map(lambda a, b: torch.stack([a, b]), v0, v1)
    got = TC.encode_image({"visual": stacked}, rn["tcfg"], imgs, bn_prior=bn_prior)
    assert got.shape == (2, 3, rn["tcfg"].embed_dim)
    for n, v in enumerate((v0, v1)):
        torch.testing.assert_close(got[n], TC.encode_image({"visual": v}, rn["tcfg"], imgs[n], bn_prior=bn_prior),
                                   **LAYER_TOL)


def test_norm_only_filter_takes_the_batch_norm_affines(rn):
    """only_norm on the ResNet tree: every BatchNorm's w and b (paths with
    "/bn"), as the JAX package's partition picks them; never the running
    statistics, the convolutions or the attention pool."""
    sel, rest = Po.partition(rn["tp"]["visual"], Po.norm_only_filter)
    jsel, _ = JPo.partition(rn["jp"]["visual"], JPo.norm_only_filter)
    paths = Po.tree_leaves(Po.tree_map(lambda leaf, path: path, sel, Po._paths(rn["tp"]["visual"])))
    assert len(paths) == len(jax.tree_util.tree_leaves(jsel)) > 0
    assert all("/bn" in p or p.startswith("stem/bn") for p in paths)
    assert {p.rsplit("/", 1)[-1] for p in paths} == {"w", "b"}
    assert len(Po.tree_leaves(sel)) + len(Po.tree_leaves(rest)) == len(Po.tree_leaves(rn["tp"]["visual"]))


# ---------------------------------------------------------------------------
# EncoderTTAClassifier through a ResNet policy against the JAX package's
# ---------------------------------------------------------------------------


def _pair(t, lr=1e-3, **kw):
    ek = dict(tta_steps=3, selection_p=0.25, lr=lr, sample_k=2, loss="rlcf")
    jclf = JEncoder(t["jp"], t["jcfg"], JClipReward(t["jrp"], t["jrcfg"], JRewardConfig(sample_k=2)),
                    JEp.EpisodeConfig(**ek), **kw).setup(CLASSNAMES)
    tclf = EncoderTTAClassifier(t["tp"], t["tcfg"], ClipReward(t["trp"], t["trcfg"], RewardConfig(sample_k=2)),
                                Ep.EpisodeConfig(**ek), **kw).setup(CLASSNAMES)
    return jclf, tclf


def _views(seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(2, 8, RES, RES, 3), dtype=np.uint8)


def _assert_episodes_equal(jout, tout):
    (jl, jaux), (tl, taux) = jout, tout
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    _close(taux["losses"], jaux["losses"])
    _close(tl, jl)
    assert tl.shape == (2, len(CLASSNAMES)) and taux["losses"].shape == (2, 3)


@pytest.mark.parametrize("only_norm,bn_prior", [(False, None), (True, None), (False, 0.5), (True, 0.5)],
                         ids=["full", "only-norm", "full-bn-prior", "only-norm-bn-prior"])
def test_resnet_encoder_adapt_matches_jax(rn, only_norm, bn_prior):
    """N=2 episodes; with ``bn_prior`` the selection forward mixes in the
    statistics of an episode's 8 views and each step those of its 2 selected
    views, as the JAX package's recompute step-0 strategy does."""
    jclf, tclf = _pair(rn, only_norm=only_norm, bn_prior=bn_prior)
    views = _views()
    _assert_episodes_equal(jclf.adapt(views), tclf.adapt(views))


def test_resnet_encoder_momentum_across_two_calls_matches_jax(rn):
    """update_freq 2 with N=2 and a BN prior: the first call's episodes fold
    into the EMA and re-anchor; the second call starts from that anchor in
    both packages (the port's, carried to JAX)."""
    kw = dict(momentum_update=True, update_freq=2, momentum=0.5, update_w=0.8, bn_prior=0.5)
    jclf, tclf = _pair(rn, **kw)
    _assert_episodes_equal(jclf.adapt(_views(0)), tclf.adapt(_views(0)))
    assert tclf.momentum_state.counter == jclf.momentum_state.counter == 0
    anchor = Po.tree_leaves(tclf.momentum_state.reset_params)
    assert not all(torch.equal(a, b) for a, b in zip(anchor, Po.tree_leaves(tclf.trainable0)))
    jclf.momentum_state.reset_params = _to_jax(tclf.momentum_state.reset_params, rn["jp"]["visual"])
    _assert_episodes_equal(jclf.adapt(_views(1)), tclf.adapt(_views(1)))


def _to_jax(port_visual, like):
    """The port's visual tree (OIHW kernels) in the JAX package's layout
    (HWIO kernels), leaf for leaf like ``like``."""
    import jax.numpy as jnp

    def leaf(t, ref):
        a = t.detach().numpy()
        return jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a, ref.dtype)

    return jax.tree_util.tree_map(leaf, port_visual, like)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prior", [None, "0.5"])
def test_tune_cls_resnet_cpu_drive_matches_jax(tmp_path, prior):
    """``tune_cls --arch`` a ResNet (from an OpenAI-format checkpoint of
    test-tiny-rn), with and without ``--prior_strength``: each group's
    episodes equal the JAX package's on the views the port built."""
    from rlcf_tpu.models.convert import convert_clip_state_dict
    from rlcf_torch.cli import tune_cls

    rcfg = TC.get_config("test-small")
    paths = []
    for cfg, seed in ((TC.get_config("test-tiny-rn"), 0), (rcfg, 1)):
        path = tmp_path / f"clip{seed}.pt"
        torch.save(openai_state_dict(cfg, seed=seed), path)
        paths.append(str(path))
    seen = []
    adapt = EncoderTTAClassifier.adapt

    def recording(self, views, **kw):
        logits, aux = adapt(self, views, **kw)
        seen.append((views.clone(), logits, aux))
        return logits, aux

    extra = ("--prior_strength", prior) if prior else ()
    EncoderTTAClassifier.adapt = recording
    try:
        r = tune_cls.main([".", "--device", "cpu", "--test_sets", "synthetic", "--limit", "4", "--precision", "fp32",
                           "--resolution", str(RES), "--batch_size", "8", "--tta_steps", "2", "--sample_k", "2",
                           "--lr", "1e-4", "--episode_group", "2", "--output", str(tmp_path),
                           "--clip_checkpoint", paths[0], "--reward_checkpoint", paths[1], *extra])
    finally:
        EncoderTTAClassifier.adapt = adapt
    assert r["synthetic"]["n"] == 4 and len(seen) == 2

    jp, jcfg = convert_clip_state_dict(openai_state_dict(TC.get_config("test-tiny-rn"), 0))
    jrp, jrcfg = convert_clip_state_dict(openai_state_dict(rcfg, 1))
    jclf = JEncoder(jp, jcfg, JClipReward(jrp, jrcfg, JRewardConfig(sample_k=2)),
                    JEp.EpisodeConfig(tta_steps=2, selection_p=0.1, lr=1e-4, sample_k=2),
                    prompt_prefix="a photo of a", bn_prior=float(prior) if prior else None
                    ).setup(["class_%d" % i for i in range(10)])
    for views, logits, aux in seen:
        assert views.dtype == torch.float32 and tuple(views.shape) == (2, 8, RES, RES, 3)   # the device generator
        jl, jaux = jclf.adapt(views.numpy())
        np.testing.assert_array_equal(aux["selected"].numpy(), np.asarray(jaux["selected"]))
        _close(aux["losses"], jaux["losses"])
        _close(logits, jl)
