"""The port's CLIP towers against ``rlcf_tpu.models.clip`` on the same
weights: carried across with ``from_jax_params``, and loaded by both
packages from one OpenAI-format state dict. fp32, tolerance 1e-5 (same math,
different summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_tpu.models import convert as JV
from rlcf_tpu.tokenizer import tokenize as jtokenize
from rlcf_torch.models import clip as TC
from rlcf_torch.models import convert as TV
from rlcf_torch.tokenizer import tokenize as ttokenize

from torch_port_fixtures import jax_params_numpy, openai_state_dict, tiny_cfgs

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=["from_jax_params", "openai_state_dict"])
def models(request):
    jcfg, tcfg = tiny_cfgs()
    if request.param == "from_jax_params":
        jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
        tp = TV.from_jax_params(jax_params_numpy(jp), tcfg)
    else:
        sd = openai_state_dict(jcfg, seed=1)
        jp, jcfg = JV.convert_clip_state_dict(sd)
        tp, tcfg = TV.convert_clip_state_dict(sd)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jp, jcfg, tp, tcfg


def _images(seed=0, n=3, res=32):
    return np.random.default_rng(seed).normal(size=(n, res, res, 3)).astype(np.float32)


def test_encode_image_tokens(models):
    jp, jcfg, tp, tcfg = models
    toks = JC.patch_tokens_from_images(_images(), 16)
    want = JC.encode_image_tokens(jp, jcfg, jnp.asarray(toks))
    got = TC.encode_image_tokens(tp, tcfg, torch.from_numpy(np.ascontiguousarray(toks)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn", ["dense", "fused"])
def test_encode_image(models, attn):
    jp, jcfg, tp, tcfg = models
    imgs = _images(1)
    want = JC.encode_image(jp, jcfg, jnp.asarray(imgs))
    got = TC.encode_image(tp, tcfg, torch.from_numpy(imgs), attn=attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_token_roundtrip():
    imgs = torch.from_numpy(_images(2))
    toks = TC.patch_tokens_from_images(imgs, 16)
    np.testing.assert_array_equal(toks.numpy(), JC.patch_tokens_from_images(imgs.numpy(), 16))
    np.testing.assert_array_equal(TC.images_from_patch_tokens(toks, 16).numpy(), imgs.numpy())


@pytest.mark.parametrize("attn", ["dense", "fused"])
def test_encode_text(models, attn):
    jp, jcfg, tp, tcfg = models
    prompts = ["a photo of a goldfish.", "a photo of a tiger cat.", "x"]
    toks = jtokenize(prompts)[:, :16]
    np.testing.assert_array_equal(ttokenize(prompts)[:, :16], toks)
    want = JC.encode_text(jp, jcfg, jnp.asarray(toks))
    got = TC.encode_text(tp, tcfg, torch.from_numpy(toks.astype(np.int64)), attn=attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_text_embeds(models):
    jp, jcfg, tp, tcfg = models
    emb = np.random.default_rng(3).normal(size=(4, 8, 64)).astype(np.float32) * 0.02
    eot = np.array([3, 7, 1, 5])
    want = JC.encode_text_embeds(jp, jcfg, jnp.asarray(emb), jnp.asarray(eot))
    got = TC.encode_text_embeds(tp, tcfg, torch.from_numpy(emb), torch.from_numpy(eot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_infer_arch_matches_jax():
    jcfg, _ = tiny_cfgs()
    shapes = {k: tuple(v.shape) for k, v in openai_state_dict(jcfg).items()}
    assert dataclasses.asdict(TC.infer_arch_from_state_dict(shapes)) == dataclasses.asdict(
        JC.infer_arch_from_state_dict(shapes))


def test_best_attn():
    _, tcfg = tiny_cfgs()
    assert TC.best_attn(tcfg, "cpu") == "dense"
    assert TC.best_attn(tcfg, "cuda") == "fused"


def test_tokenizer_matches_jax_on_class_names():
    from rlcf_torch.data.class_names import get_classnames

    names = get_classnames("A") + ["don't stop", "naïve café 42", "x²!?", "<|endoftext|>ab's"]
    np.testing.assert_array_equal(ttokenize(names, truncate=True), jtokenize(names, truncate=True))
