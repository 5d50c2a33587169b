"""The slice as a whole: the port's prompt-TTA episode group against
``rlcf_tpu``'s ``PromptTTAClassifier.adapt_tokens`` on the same weights and
the same u8 views, and the NHWC ``adapt`` against JAX's ``adapt`` on u8 and
float views (fp32; selections equal, per-step losses and final logits
within 2e-4), the port's CLI on the CPU, and the port's native view loader
against the JAX package's on one seed."""

import jax
import numpy as np
import pytest
import torch

from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks.classification import PromptTTAClassifier as JClassifier
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks.classification import PromptTTAClassifier

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs()
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    jrp = JC.init_clip_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, jrp, TV.from_jax_params(jax_params_numpy(jp), tcfg), \
        TV.from_jax_params(jax_params_numpy(jrp), tcfg)


def _tokens(seed=0, n=2, views=16):
    return np.random.default_rng(seed).integers(0, 256, size=(n, views, 4, 768), dtype=np.uint8)


@pytest.mark.parametrize("attn", ["dense", "fused"])
@pytest.mark.parametrize("loss", ["rlcf", "tpt", "kd"])
def test_adapt_tokens_matches_jax(towers, loss, attn):
    jcfg, tcfg, jp, jrp, tp, trp = towers
    ek = dict(tta_steps=3, selection_p=0.25, lr=7e-3, sample_k=2, loss=loss)
    jclf = JClassifier(jp, jcfg, JClipReward(jrp, jcfg, JRewardConfig(sample_k=2)), JEpisodeConfig(**ek),
                       ctx_init="a photo of a").setup(CLASSNAMES)
    tclf = PromptTTAClassifier(tp, tcfg, ClipReward(trp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(**ek),
                               ctx_init="a photo of a")
    tclf.attn = tclf.text_attn = tclf.reward_attn = attn  # "fused" runs the kernel's plain version on the CPU
    tclf.setup(CLASSNAMES)
    toks = _tokens()
    jl, jaux = jclf.adapt_tokens(toks)
    tl, taux = tclf.adapt_tokens(toks)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tl.shape == (2, len(CLASSNAMES)) and taux["losses"].shape == (2, 3)


@pytest.mark.parametrize("loss,u8", [("rlcf", True), ("tpt", True), ("kd", True), ("rlcf", False)])
def test_nhwc_adapt_matches_jax(towers, loss, u8):
    jcfg, tcfg, jp, jrp, tp, trp = towers
    ek = dict(tta_steps=3, selection_p=0.25, lr=7e-3, sample_k=2, loss=loss)
    jclf = JClassifier(jp, jcfg, JClipReward(jrp, jcfg, JRewardConfig(sample_k=2)), JEpisodeConfig(**ek),
                       ctx_init="a photo of a").setup(CLASSNAMES)
    tclf = PromptTTAClassifier(tp, tcfg, ClipReward(trp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(**ek),
                               ctx_init="a photo of a").setup(CLASSNAMES)
    rng = np.random.default_rng(2)
    views = (rng.integers(0, 256, size=(2, 16, 32, 32, 3), dtype=np.uint8) if u8
             else rng.normal(size=(2, 16, 32, 32, 3)).astype(np.float32))
    jl, jaux = jclf.adapt(views)
    tl, taux = tclf.adapt(views)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tl.shape == (2, len(CLASSNAMES)) and taux["losses"].shape == (2, 3)


def test_nhwc_adapt_refuses_a_reward_at_another_resolution(towers):
    """A reward at another resolution takes the selected views resized
    (``adapt``, and ``adapt_tokens`` without reward tokens); reward tokens
    patchified at the views' resolution are refused, as the JAX package
    refuses them (``tests/test_torch_ensemble.py`` holds the resized
    episodes to JAX's)."""
    from rlcf_torch.models import clip as TC

    _, tcfg, _, _, tp, _ = towers
    rcfg = TC.ClipConfig("r", 16, 64, 1, 64, 16, 64, 1, vision_heads_override=2, text_heads_override=2)
    reward = ClipReward(TC.init_clip_params(rcfg), rcfg, RewardConfig(sample_k=2))
    clf = PromptTTAClassifier(tp, tcfg, reward, EpisodeConfig(sample_k=2), ctx_init="a photo of a").setup(CLASSNAMES)
    logits, aux = clf.adapt(np.zeros((1, 4, 32, 32, 3), dtype=np.uint8))
    assert logits.shape == (1, len(CLASSNAMES)) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="views must be generated at the reward resolution"):
        clf.adapt_tokens(_tokens(views=4)[:1], _tokens(views=4)[:1])


def test_cli_runs_on_cpu(tmp_path):
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.data import native

    if not native.available():
        pytest.skip("no C++ toolchain for the native view pipeline")
    r = tta_cls.main(
        [".", "--device", "cpu", "--test_sets", "synthetic", "--viewgen", "native", "--limit", "3",
         "--arch", "test-small", "--reward_arch", "test-small", "--precision", "fp32", "--resolution", "64",
         "--batch_size", "8", "--tta_steps", "2", "--sample_k", "2", "--lr", "7e-3",
         "--ctx_init", "a_photo_of_a", "--episode_group", "2", "--output", str(tmp_path)]
    )
    assert r["synthetic"]["n"] == 3 and 0 <= r["synthetic"]["top1"] <= 100
    assert len(r["synthetic"]["group_seconds"]) == 2
    assert (tmp_path / "results.json").exists()


def test_cli_refuses_unported_options():
    """Only --download is refused as not ported; --hard_aug outside --viewgen
    device gets the JAX CLI's message; --tp 2 is ported (A14), and in a
    single process the mesh's error names the launcher."""
    from rlcf_torch.cli import tta_cls

    with pytest.raises(SystemExit, match="--download is not ported yet"):
        tta_cls.main(["--device", "cpu", "--download", "1"])
    with pytest.raises(SystemExit, match=r"^--viewgen native does not implement --hard_aug \(BYOL\); use --viewgen device$"):
        tta_cls.main(["--device", "cpu", "--viewgen", "native", "--hard_aug", "1"])
    with pytest.raises(ValueError, match="torchrun"):
        tta_cls.main(["--device", "cpu", "--tp", "2"])


def test_cuda_without_card_raises(monkeypatch):
    from rlcf_torch.utils.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_native_views_match_jax_loader():
    from rlcf_tpu.data import native as jnative
    from rlcf_torch.data import native as tnative

    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ toolchain for the native view pipeline")
    imgs = np.random.default_rng(0).integers(0, 256, size=(2, 48, 48, 3), dtype=np.uint8)
    kw = dict(n_views=5, p_policy=16, p_reward=8, resolution=32, seed=7)
    for a, b in zip(tnative.generate_views_native_patch_u8(imgs, **kw),
                    jnative.generate_views_native_patch_u8(imgs, **kw)):
        np.testing.assert_array_equal(a, b)


def test_class_features_and_u8_normalization_match_jax(towers):
    from rlcf_tpu.tasks import classification as JT
    from rlcf_torch.tasks import classification as TT

    jcfg, tcfg, jp, _, tp, _ = towers
    want = JT.compute_class_features(jp, jcfg, CLASSNAMES)
    got = TT.compute_class_features(tp, tcfg, CLASSNAMES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    toks = _tokens(1)
    np.testing.assert_allclose(TT.normalize_u8_patch_tokens(torch.from_numpy(toks)).numpy(),
                               np.asarray(JT.normalize_u8_patch_tokens(toks)), rtol=1e-6, atol=1e-6)
    img = toks[0, :2].reshape(2, 32, 32, 3)  # any u8 NHWC batch
    np.testing.assert_allclose(TT.maybe_normalize_u8(torch.from_numpy(img)).numpy(),
                               np.asarray(JT.maybe_normalize_u8(img)), rtol=1e-6, atol=1e-6)
