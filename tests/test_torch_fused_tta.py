"""The fused-views slice on the CPU: the classifier on policy AND reward
tokens against ``rlcf_tpu``'s ``adapt_tokens(ptoks, rtoks)`` (fp32;
selections equal, per-step losses and final logits within 2e-4), the
sources paths (``adapt_sources_fn``, ``adapt_sources_scan_fn``) against
``fused_views`` + ``adapt_tokens``, the reward-token checks' messages, and
the CLI with ``--viewgen fused``."""

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
from rlcf_torch.ops import augmix as X
from rlcf_torch.tasks.classification import PromptTTAClassifier

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
TOL = dict(rtol=2e-4, atol=2e-4)
EK = dict(tta_steps=3, selection_p=0.25, lr=7e-3, sample_k=2)


@pytest.fixture(scope="module")
def towers():
    """A policy with patch 16 and a reward with patch 8, both at 32 px."""
    jcfg, tcfg = tiny_cfgs()
    jrcfg, trcfg = tiny_cfgs(name="r", patch=8)
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    jrp = JC.init_clip_params(jax.random.PRNGKey(1), jrcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jrcfg=jrcfg, trcfg=trcfg, jp=jp, jrp=jrp,
                tp=TV.from_jax_params(jax_params_numpy(jp), tcfg), trp=TV.from_jax_params(jax_params_numpy(jrp), trcfg))


def _torch_clf(t, loss="rlcf"):
    clf = PromptTTAClassifier(t["tp"], t["tcfg"], ClipReward(t["trp"], t["trcfg"], RewardConfig(sample_k=2)),
                              EpisodeConfig(loss=loss, **EK), ctx_init="a photo of a")
    return clf.setup(CLASSNAMES)


def _views(seed=0, n=2, v=16):
    return np.random.default_rng(seed).integers(0, 256, size=(n, v, 3, 32, 32), dtype=np.uint8)


@pytest.mark.parametrize("loss", ["rlcf", "tpt", "kd"])
def test_adapt_tokens_with_reward_tokens_matches_jax(towers, loss):
    t = towers
    jclf = JClassifier(t["jp"], t["jcfg"], JClipReward(t["jrp"], t["jrcfg"], JRewardConfig(sample_k=2)),
                       JEpisodeConfig(loss=loss, **EK), ctx_init="a photo of a").setup(CLASSNAMES)
    tclf = _torch_clf(t, loss)
    views = torch.from_numpy(_views())
    ptoks, rtoks = X.patchify_planar_u8(views, 16).numpy(), X.patchify_planar_u8(views, 8).numpy()
    jl, jaux = jclf.adapt_tokens(ptoks, rtoks)
    tl, taux = tclf.adapt_tokens(ptoks, rtoks)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tl.shape == (2, len(CLASSNAMES)) and taux["losses"].shape == (2, 3)


def test_reward_token_checks_match_jax_messages(towers):
    t = towers
    jclf = JClassifier(t["jp"], t["jcfg"], JClipReward(t["jrp"], t["jrcfg"], JRewardConfig(sample_k=2)),
                       JEpisodeConfig(**EK), ctx_init="a photo of a").setup(CLASSNAMES)
    tclf = _torch_clf(t)
    views = torch.from_numpy(_views(v=4))
    ptoks = X.patchify_planar_u8(views, 16).numpy()
    bad = {"patch dim": X.patchify_planar_u8(views, 16).numpy(),                          # 768 != 192
           "patch count": X.patchify_planar_u8(torch.from_numpy(_views(v=4)[..., :16, :16]), 8).numpy()}
    for what, rtoks in bad.items():
        with pytest.raises(ValueError) as jerr:
            jclf.adapt_tokens(ptoks, rtoks)
        with pytest.raises(ValueError) as terr:
            tclf.adapt_tokens(ptoks, rtoks)
        assert str(terr.value) == str(jerr.value), what


def test_adapt_sources_fn_equals_fused_views_then_adapt_tokens(towers):
    clf = _torch_clf(towers)
    imgs = torch.from_numpy(np.random.default_rng(4).integers(0, 256, size=(2, 3, 48, 48), dtype=np.uint8))
    kw = dict(n_views=8, src_size=48, resolution=32)
    logits, losses, nxt = clf.adapt_sources_fn(**kw)(imgs, 11)
    ptoks, rtoks = X.fused_views(imgs, torch.Generator().manual_seed(11), p_policy=16, p_reward=8, **kw)
    want_logits, want_aux = clf.adapt_tokens(ptoks, rtoks)
    assert nxt == 12
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    torch.testing.assert_close(losses, want_aux["losses"], rtol=0, atol=0)


def test_adapt_sources_scan_fn_equals_chained_calls(towers):
    clf = _torch_clf(towers)
    imgs = torch.from_numpy(np.random.default_rng(5).integers(0, 256, size=(2, 2, 3, 48, 48), dtype=np.uint8))
    kw = dict(n_views=8, src_size=48, resolution=32)
    one = clf.adapt_sources_fn(**kw)
    logits, losses, nxt = clf.adapt_sources_scan_fn(**kw)(imgs, 3)
    l0, s0, seed = one(imgs[0], 3)
    l1, s1, seed = one(imgs[1], seed)
    assert nxt == seed == 5 and logits.shape == (2, 2, len(CLASSNAMES)) and losses.shape == (2, 2, 3)
    torch.testing.assert_close(logits, torch.stack([l0, l1]), rtol=0, atol=0)
    torch.testing.assert_close(losses, torch.stack([s0, s1]), rtol=0, atol=0)


def _cli_argv(tmp_path, *extra):
    return [".", "--device", "cpu", "--test_sets", "synthetic", "--limit", "3", "--arch", "test-small",
            "--reward_arch", "test-small", "--precision", "fp32", "--resolution", "64", "--batch_size", "8",
            "--tta_steps", "2", "--sample_k", "2", "--lr", "7e-3", "--ctx_init", "a_photo_of_a",
            "--episode_group", "2", "--output", str(tmp_path), *extra]


def test_cli_fused_runs_on_cpu(tmp_path):
    from rlcf_torch.cli import tta_cls

    r = tta_cls.main(_cli_argv(tmp_path, "--viewgen", "fused"))
    assert r["synthetic"]["n"] == 3 and 0 <= r["synthetic"]["top1"] <= 100
    assert len(r["synthetic"]["group_seconds"]) == 2
    assert (tmp_path / "results.json").exists()


def test_cli_fused_refusals_match_jax(tmp_path):
    from rlcf_torch.cli import tta_cls

    with pytest.raises(SystemExit, match=r"--viewgen fused does not implement --hard_aug \(BYOL\)"):
        tta_cls.main(_cli_argv(tmp_path, "--viewgen", "fused", "--hard_aug", "1"))
    with pytest.raises(SystemExit, match="--viewgen fused needs a ViT policy in token mode"):
        tta_cls.main(_cli_argv(tmp_path, "--viewgen", "fused", "--resolution", "72"))


@pytest.mark.parametrize("extra,items", [
    (("--viewgen", "fused", "--hard_aug", "1"), ("A16",)),
    (("--viewgen", "fused", "--resolution", "72"), ("A16",)),
    (("--viewgen", "fused", "--multiple_reward_models", "1"), ("A16",)),
    (("--viewgen", "fused", "--cocoop"), ("A16",)),
    (("--viewgen", "device"), ("A16",)),
])
def test_cli_refusals_name_what_the_port_runs(tmp_path, extra, items):
    """A refusal names the view generators the port runs and the ROADMAP items
    that bring the rest, never an option the port refuses itself."""
    from rlcf_torch.cli import tta_cls

    with pytest.raises(SystemExit) as exc:
        tta_cls.main(_cli_argv(tmp_path, *extra))
    msg = str(exc.value)
    assert "--viewgen fused" in msg or "--viewgen native" in msg
    assert all(f"ROADMAP {item}" in msg for item in items)
    assert "use --viewgen device" not in msg


def test_cli_resume_refusal_names_its_item(tmp_path):
    """``--resume`` waits for the progress journal, which A15 brings."""
    from rlcf_torch.cli import tta_cls

    with pytest.raises(SystemExit, match=r"--resume is not ported yet; .*\(ROADMAP A15\)"):
        tta_cls.main(_cli_argv(tmp_path, "--resume"))


def test_fine_grained_ids_are_the_jax_packages():
    from rlcf_tpu.data.datasets import ID_TO_DIRNAME as JAX_IDS, JSON_SPLITS as JAX_SPLITS
    from rlcf_torch.data.datasets import FINE_GRAINED_IDS, ID_TO_DIRNAME, JSON_SPLITS

    assert ID_TO_DIRNAME == JAX_IDS and JSON_SPLITS == JAX_SPLITS
    assert set(FINE_GRAINED_IDS) == set(JSON_SPLITS) | {"aircraft"} == set(JAX_IDS) - {"I", "A", "K", "R", "V", "C"}


@pytest.mark.parametrize("cli", ["tta_cls", "tune_cls", "zero_shot"])
@pytest.mark.parametrize("set_id", ["flower102", "dtd", "pets", "cars", "ucf101", "caltech101", "food101",
                                    "sun397", "aircraft", "eurosat"])
def test_cli_runs_fine_grained_sets(tmp_path, cli, set_id):
    """Each CLI runs each fine-grained set on its synthetic tree (the Zhou
    split JSON or the FGVC-Aircraft lists) at a tiny size on the CPU, with
    the set's own class names, through the ported loader and
    ``--dataset_mode``: two images of the split the mode names."""
    import importlib

    from rlcf_torch.data.class_names import get_classnames
    from torch_port_fixtures import write_fine_grained_tree

    n_classes = len(get_classnames(set_id))
    write_fine_grained_tree(tmp_path / "data", set_id, n_classes=min(n_classes, 3), per_class=1)
    argv = [str(tmp_path / "data"), "--device", "cpu", "--test_sets", set_id, "--dataset_mode", "val", "--limit", "2",
            "--arch", "test-small", "--resolution", "64", "--precision", "fp32", "--output", str(tmp_path / "out")]
    if cli == "zero_shot":
        argv += ["--batch_size", "2"]
    else:
        argv += ["--reward_arch", "test-small", "--batch_size", "4", "--tta_steps", "1", "--sample_k", "2",
                 "--episode_group", "2"]
    if cli == "tta_cls":
        argv += ["--viewgen", "fused"]
    r = importlib.import_module(f"rlcf_torch.cli.{cli}").main(argv)[set_id]
    assert 0 <= r["top1"] <= r["top5"] <= 100
    if cli != "zero_shot":
        assert r["n"] == 2 and len(r["group_seconds"]) == 1
