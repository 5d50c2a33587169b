"""The device view generator behind the CLIs, on the CPU: ``tta_cls
--viewgen device`` (with and without ``--hard_aug``, and ``auto``) builds each
group's views with ``make_view_generator`` seeded ``--seed * 100003 + group``;
``tune_cls`` with the JAX entry point's ``--seed * 7 + group`` (the last
partial group included), and under ``--dp 2`` every rank sees one process's
views and returns its fp32 logits. Then the episodes on views from JAX's
draws: the port's prompt-TTA and encoder-TTA classifiers on the port's views
against JAX's classifiers on ``generate_views`` (fp32: selections equal,
logits within 2e-4), the two sets of views within the generator's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
from rlcf_tpu.data import augment as JA
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks.classification import EncoderTTAClassifier as JEncoder, PromptTTAClassifier as JPrompt
from rlcf_torch.cli import tta_cls, tune_cls
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.data import augment as TA
from rlcf_torch.data.datasets import build_dataset, iter_canonical
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks.classification import EncoderTTAClassifier, PromptTTAClassifier

from test_torch_augment_views import MAX_DIFF, MAX_SHARE_OUTSIDE, VALUE_TOL
from test_torch_augmix import _jax_draws
from torch_parallel_workers import launch
from torch_port_fixtures import jax_params_numpy, one_thread, tiny_cfgs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = ["--device", "cpu", "--test_sets", "synthetic", "--arch", "test-small", "--reward_arch", "test-small",
        "--precision", "fp32", "--resolution", "64", "--batch_size", "8", "--tta_steps", "2", "--sample_k", "2",
        "--episode_group", "2"]
TOL = dict(rtol=2e-4, atol=2e-4)
CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]


def _recording(monkeypatch, owner):
    """Record each group's views and logits at ``owner.adapt``."""
    seen = []
    adapt = owner.adapt

    def recording(self, views, **kw):
        logits, aux = adapt(self, views, **kw)
        seen.append((views.clone(), logits.detach().clone()))
        return logits, aux

    monkeypatch.setattr(owner, "adapt", recording)
    return seen


def _groups(seed, limit, group=2):
    """The CLIs' canonical images of the synthetic set, in their groups."""
    imgs = [img for img, _ in iter_canonical(build_dataset("synthetic", ".", n_classes=10), 256, seed=seed,
                                             limit=limit)]
    return [torch.from_numpy(np.stack(imgs[i:i + group])) for i in range(0, len(imgs), group)]


@pytest.mark.parametrize("viewgen,hard_aug", [("device", 0), ("device", 1), ("auto", 1)])
def test_tta_cls_device_views_are_the_seeded_generator(tmp_path, monkeypatch, capsys, viewgen, hard_aug):
    seen = _recording(monkeypatch, PromptTTAClassifier)
    argv = TINY + ["--limit", "4", "--seed", "2", "--viewgen", viewgen, "--hard_aug", str(hard_aug), "--lr", "7e-3",
                   "--ctx_init", "a_photo_of_a", "--output", str(tmp_path)]
    r = tta_cls.main(argv)["synthetic"]
    assert r["n"] == 4 and len(r["group_seconds"]) == 2 and len(seen) == 2
    if viewgen == "auto":
        assert "viewgen: auto -> device" in capsys.readouterr().out
    gen = TA.make_view_generator(8, 64, hard_aug=bool(hard_aug))
    for g, (images, (views, logits)) in enumerate(zip(_groups(2, 4), seen)):
        assert views.dtype == torch.float32 and tuple(views.shape) == (2, 8, 64, 64, 3)
        assert torch.equal(views, gen(images, torch.Generator().manual_seed(2 * 100003 + g)))
        assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("on_cuda", [True, False])
@pytest.mark.parametrize("token_ok", [True, False])
@pytest.mark.parametrize("hard_aug", [True, False])
def test_auto_picks_device_outside_token_mode_and_under_hard_aug(on_cuda, token_ok, hard_aug):
    """JAX's rule (``rlcf_tpu/cli/tta_cls.py``): fused where it is available
    (the port: on cuda) in token mode without --hard_aug, else device."""
    want = "fused" if on_cuda and token_ok and not hard_aug else "device"
    assert tta_cls.auto_viewgen(on_cuda, token_ok, hard_aug) == want


def test_tune_cls_takes_the_jax_entry_points_seeds(tmp_path, monkeypatch):
    seen = _recording(monkeypatch, EncoderTTAClassifier)
    r = tune_cls.main(TINY + ["--limit", "3", "--seed", "3", "--lr", "1e-4", "--output", str(tmp_path)])["synthetic"]
    assert r["n"] == 3 and len(seen) == 2           # a group of 2, then the last partial group of 1
    gen = TA.make_view_generator(8, 64)
    for g, (images, (views, _)) in enumerate(zip(_groups(3, 3), seen)):
        assert torch.equal(views, gen(images, torch.Generator().manual_seed(3 * 7 + g)))


def test_tune_cls_dp_views_and_logits_equal_one_process(tmp_path, monkeypatch):
    """``tune_cls --dp 2`` on two ranks (gloo): each rank builds the whole
    group's views from the group's seed, so every rank's views equal one
    process's; its episodes' fp32 logits, gathered, equal one process's."""
    argv = TINY + ["--limit", "4", "--seed", "1", "--lr", "1e-4", "--momentum_update", "1", "--update_freq", "3"]
    seen = _recording(monkeypatch, EncoderTTAClassifier)
    tune_cls.main(argv + ["--output", str(tmp_path / "one")])
    got = launch(tmp_path, 2, "tune_cls_views", {"argv": argv + ["--dp", "2", "--output", str(tmp_path / "two")]},
                 timeout=240.0)
    assert len(got["views"]) == 2 and len(got["logits"]) == len(seen) == 2
    for rank_views in got["views"]:
        for views, (want, _) in zip(rank_views, seen):
            assert torch.equal(views, want)
    for logits, (_, want) in zip(got["logits"], seen):
        torch.testing.assert_close(logits, want, **TOL)


# ---------------------------------------------------------------------------
# episodes on views from JAX's draws
# ---------------------------------------------------------------------------

S, NV = 48, 8


@pytest.fixture(scope="module")
def views_pair():
    """JAX's ``generate_views`` (the BYOL recipe, augmix off: one short
    compile) on two images and the port's views on the same draws."""
    jcfg, _ = tiny_cfgs()
    R = jcfg.image_resolution
    imgs = np.random.default_rng(4).integers(0, 256, size=(2, S, S, 3), dtype=np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    fn = lambda img, key: JA.generate_views(img, key, NV, R, augmix=False, hard_aug=True)
    want = np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(imgs), keys))
    ds = [_jax_draws(k, NV, 0.08, hard_aug=True) for k in keys]
    draws = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in ds])) for k in ds[0]}
    got = TA.views_from_draws(torch.from_numpy(imgs), draws, resolution=R, augmix=False, hard_aug=True)
    return want, got


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs()
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    jrp = JC.init_clip_params(jax.random.PRNGKey(1), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jrp=jrp, tp=TV.from_jax_params(jax_params_numpy(jp), tcfg),
                trp=TV.from_jax_params(jax_params_numpy(jrp), tcfg))


@pytest.mark.parametrize("kind", ["prompt", "encoder"])
def test_episodes_on_the_ports_views_match_jax(views_pair, towers, kind):
    want_views, views = views_pair
    diff = np.abs(views.numpy() - want_views)   # the generator's tolerance (tests/test_torch_augment_views.py)
    assert (diff > VALUE_TOL).mean() <= MAX_SHARE_OUTSIDE and diff.max() <= MAX_DIFF
    t = towers
    ek = dict(tta_steps=3, selection_p=0.25, lr=7e-3 if kind == "prompt" else 1e-3, sample_k=2)
    if kind == "prompt":
        jclf = JPrompt(t["jp"], t["jcfg"], JClipReward(t["jrp"], t["jcfg"], JRewardConfig(sample_k=2)),
                       JEpisodeConfig(**ek), ctx_init="a photo of a").setup(CLASSNAMES)
        tclf = PromptTTAClassifier(t["tp"], t["tcfg"], ClipReward(t["trp"], t["tcfg"], RewardConfig(sample_k=2)),
                                   EpisodeConfig(**ek), ctx_init="a photo of a").setup(CLASSNAMES)
    else:
        jclf = JEncoder(t["jp"], t["jcfg"], JClipReward(t["jrp"], t["jcfg"], JRewardConfig(sample_k=2)),
                        JEpisodeConfig(**ek)).setup(CLASSNAMES)
        tclf = EncoderTTAClassifier(t["tp"], t["tcfg"], ClipReward(t["trp"], t["tcfg"], RewardConfig(sample_k=2)),
                                    EpisodeConfig(**ek)).setup(CLASSNAMES)
    jl, jaux = jclf.adapt(want_views)
    tl, taux = tclf.adapt(views)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    np.testing.assert_allclose(taux["losses"].detach().numpy(), np.asarray(jaux["losses"]), **TOL)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
