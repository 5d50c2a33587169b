"""Serving export (``rlcf_torch/utils/export.py``, the classifier's serving
hooks, ``cli/export_serving.py``) and the attention custom ops behind it, on
the CPU at ``tests/test_export.py``'s tiny config: the served logits against
the port's eager episode (atol 1e-5, the JAX test's) and against JAX's
``PromptTTAClassifier.adapt`` on the same weights and views (2e-4), an
artifact from one set of weights serving another, the token variant, the
graph's ``rlcf::`` nodes, the bad magic, and the ops' CPU implementations
against the plain versions."""

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
from rlcf_torch.ops import attention as A
from rlcf_torch.tasks.classification import PromptTTAClassifier
from rlcf_torch.utils.export import (deserialize_call, deserialize_program, export_serving, load_exported,
                                     save_exported)

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

CLASSNAMES = ["cat", "dog", "bird"]
EK = dict(tta_steps=2, selection_p=0.25, sample_k=2)


def _classifiers(seed=0):
    """JAX's classifier and the port's on the same tiny weights (the port's
    towers on the attention op, whose CPU implementation is the plain version)."""
    jcfg, tcfg = tiny_cfgs(name="p", embed=16, res=32, layers=1, width=32, patch=16, text_width=32, text_layers=1,
                           heads=2)
    jp, jrp = JC.init_clip_params(jax.random.PRNGKey(seed), jcfg), JC.init_clip_params(jax.random.PRNGKey(seed + 100),
                                                                                        jcfg)
    jclf = JClassifier(jp, jcfg, JClipReward(jrp, jcfg, JRewardConfig(sample_k=2)), JEpisodeConfig(**EK)).setup(
        CLASSNAMES)
    tclf = PromptTTAClassifier(TV.from_jax_params(jax_params_numpy(jp), tcfg), tcfg,
                               ClipReward(TV.from_jax_params(jax_params_numpy(jrp), tcfg), tcfg,
                                          RewardConfig(sample_k=2)), EpisodeConfig(**EK))
    tclf.attn = tclf.text_attn = tclf.reward_attn = "fused"
    return jclf, tclf.setup(CLASSNAMES)


@pytest.fixture(scope="module")
def clfs():
    return _classifiers()


def _views():
    return np.random.default_rng(0).normal(size=(2, 8, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def image_blob(clfs):
    """The image-input artifact of the port's classifier, exported on the CPU."""
    return export_serving(clfs[1].serving_fn(), clfs[1].serving_example_args(_views().shape))


def _tokens():
    from rlcf_tpu.models.clip import patch_tokens_from_images

    u8 = np.random.default_rng(1).integers(0, 256, size=(2, 8, 32, 32, 3), dtype=np.uint8)
    return np.stack([patch_tokens_from_images(v, 16) for v in u8])


@pytest.mark.parametrize("mode", ["images", "tokens"])
def test_served_logits_match_eager_and_jax(clfs, image_blob, mode, tmp_path):
    jclf, tclf = clfs
    if mode == "images":
        x, blob = _views(), image_blob
        direct, _ = tclf.adapt(x)
        jlogits, _ = jclf.adapt(x)
    else:
        x = _tokens()
        blob = export_serving(tclf.serving_fn_tokens(), tclf.serving_example_args_tokens(x.shape))
        direct, _ = tclf.adapt_tokens(x)
        jlogits, _ = jclf.adapt_tokens(x)
    path = str(tmp_path / "episode.rlcfx")
    save_exported(path, blob)
    served = load_exported(path)(*tclf.weights(), torch.from_numpy(x))
    np.testing.assert_allclose(served.numpy(), direct.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(served.numpy(), np.asarray(jlogits), atol=2e-4, rtol=2e-4)
    targets = {str(n.target) for n in deserialize_program(blob).graph.nodes}
    assert {"rlcf.fused_attention.default", "rlcf.fused_attention_bwd.default"} <= targets


def test_serving_export_is_weight_agnostic():
    """An artifact exported from weights A serves weights B exactly as B's
    eager episode (``tests/test_export.py::test_serving_export_is_weight_agnostic``)."""
    _, a = _classifiers(0)
    _, b = _classifiers(7)
    x = _views()
    call = deserialize_call(export_serving(a.serving_fn(), a.serving_example_args(x.shape)))
    served_b = call(*b.weights(), torch.from_numpy(x))
    direct_b, _ = b.adapt(x)
    np.testing.assert_allclose(served_b.numpy(), direct_b.numpy(), atol=1e-6, rtol=0)


def test_export_rejects_garbage():
    with pytest.raises(ValueError, match="magic"):
        deserialize_call(b"not an artifact")


def test_platforms_are_recorded_and_held(clfs, image_blob):
    _, tclf = clfs
    x, blob = _views(), image_blob   # exported on the CPU: its platforms are the example arguments' device, cpu
    with pytest.raises(ValueError, match="unknown platforms"):
        export_serving(tclf.serving_fn(), tclf.serving_example_args(x.shape), platforms=("tpu",))
    with pytest.raises(ValueError, match="exported for cpu, not cuda"):
        deserialize_call(blob, device="cuda")
    served = deserialize_call(blob, device="cpu")(*tclf.weights(), torch.from_numpy(x))
    assert served.shape == (2, len(CLASSNAMES))
    with pytest.raises(Exception):   # N=3 against the exported N=2
        deserialize_call(blob)(*tclf.weights(), torch.zeros((3, 8, 32, 32, 3)))


@pytest.mark.parametrize("T,masked,dtype", [(1, False, torch.float32), (9, True, torch.float32),
                                            (17, False, torch.float32), (9, True, torch.bfloat16)])
def test_custom_ops_cpu_match_plain(T, masked, dtype):
    """The ops' CPU implementations are the plain versions, forward and
    gradient, and the fake implementation gives the output's shape."""
    g = torch.Generator().manual_seed(T)
    qkv = torch.randn(3, T, 3 * 2 * 64, generator=g).to(dtype).requires_grad_(True)
    mask = torch.full((T, T), float("-inf")).triu(1) if masked else None
    out = A.fused_attention(qkv, mask, 2, 0.125)
    assert torch.equal(out, A.fused_attention_reference(qkv.detach(), mask, 2, 0.125))
    cot = torch.randn(out.shape, generator=g).to(dtype)
    dqkv, = torch.autograd.grad(out, qkv, cot)
    assert torch.equal(dqkv, A.fused_attention_reference_bwd(qkv.detach(), cot, mask, 2, 0.125))
    torch.library.opcheck(torch.ops.rlcf.fused_attention.default, (qkv, mask, 2, 0.125))
    meta = A.fused_attention(torch.empty(2, T, 384, device="meta", dtype=dtype), None, 2, 0.125)
    assert meta.shape == (2, T, 128) and meta.dtype == dtype


def test_cli_exports_and_serves(tmp_path):
    """``export_serving --input tokens`` on the CPU: the artifact serves the
    CLI's own random weights (rebuilt from the same seeds) as the eager
    episode does; ResNet policies and a resolution the patch does not tile
    are refused as in JAX."""
    from rlcf_torch.cli import common, export_serving as cli

    argv = ["--device", "cpu", "--test_sets", "synthetic", "--arch", "test-small", "--reward_arch", "test-small",
            "--resolution", "64", "--batch_size", "8", "--episode_group", "2", "--tta_steps", "2", "--sample_k", "2",
            "--precision", "fp32", "--input", "tokens"]
    out = str(tmp_path / "e.rlcfx")
    r = cli.main(argv + ["--out", out])
    assert r["bytes"] < 5e6 and r["classes"] == 10
    args = cli.get_args(argv + ["--out", out])
    params, cfg = common.load_policy(args, torch.device("cpu"))
    clf = PromptTTAClassifier(params, cfg, common.build_reward(args, torch.device("cpu")),
                              EpisodeConfig(tta_steps=2, sample_k=2), ctx_init="a photo of a")
    clf.setup(common.class_names("synthetic"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(2, 8, 16, 768), dtype=np.uint8))
    served = load_exported(out)(*clf.weights(), toks)
    np.testing.assert_allclose(served.numpy(), clf.adapt_tokens(toks)[0].numpy(), atol=1e-5, rtol=0)
    with pytest.raises(SystemExit, match="requires a ViT policy"):
        cli.main(argv[:4] + ["--arch", "test-tiny-rn", "--input", "tokens", "--out", out])
    with pytest.raises(SystemExit, match="resolution % patch"):
        cli.main(argv[:4] + ["--arch", "test-small", "--resolution", "72", "--input", "tokens", "--out", out])
