"""The port's prompt template at every class-token position against
``rlcf_tpu``'s on the same weights: ``fixed_embed``, ``ctx_map``,
``eot_idx``, ``ctx0``, and with a learnable class token ``cls_mask`` and
``cls0`` (numpy's draws in both packages), all exactly equal; the spliced
prompts with a class token per episode, and ``select_confident`` /
``confidence_gap`` (fp32, within 1e-6); and a whole prompt-TTA episode group
with a ``[CLS]`` word in ``ctx_init`` (selections equal, losses and logits
within 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core import losses as JL
from rlcf_tpu.core import prompt as JP
from rlcf_tpu.models import clip as JC
from rlcf_torch.core import losses as TL
from rlcf_torch.core import prompt as TP
from rlcf_torch.models import convert as TV

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark", "X"]


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = tiny_cfgs()
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    return jp, TV.from_jax_params(jax_params_numpy(jp), tcfg)


CASES = {
    "end words": dict(ctx_init="a photo of a"),
    "end random": dict(ctx_init=None, n_ctx=4),
    "middle [CLS]": dict(ctx_init="a photo of a [CLS] taken"),
    "middle [CLS] underscores": dict(ctx_init="a_[CLS]_photo_of"),
    "middle default": dict(ctx_init=None, n_ctx=5, ctx_position="middle"),
    "middle words default": dict(ctx_init="a photo of a", ctx_position="middle"),
    "front words": dict(ctx_init="a photo of a", ctx_position="front"),
    "front random": dict(ctx_init=None, n_ctx=3, ctx_position="front"),
    "learned_cls random": dict(ctx_init=None, n_ctx=4, learned_cls=True),
    "learned_cls words": dict(ctx_init="a photo of a", learned_cls=True),
    "ctx0 given [CLS]": dict(ctx_init="a photo of [CLS] a", ctx0="given"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prompt_state_matches_jax(weights, case):
    jp, tp = weights
    kw = dict(CASES[case])
    if kw.get("ctx0") == "given":
        ctx0 = np.random.default_rng(3).normal(0, 0.02, size=(4, 64)).astype(np.float32)
        jkw, tkw = dict(kw, ctx0=jnp.asarray(ctx0)), dict(kw, ctx0=torch.from_numpy(ctx0))
    else:
        jkw = tkw = kw
    j = JP.build_prompt_state(jp, CLASSNAMES, **jkw)
    t = TP.build_prompt_state(tp, CLASSNAMES, **tkw)
    np.testing.assert_array_equal(t.fixed_embed.numpy(), np.asarray(j.fixed_embed))
    np.testing.assert_array_equal(t.ctx_map.numpy(), np.asarray(j.ctx_map))
    np.testing.assert_array_equal(t.eot_idx.numpy(), np.asarray(j.eot_idx))
    np.testing.assert_array_equal(t.ctx0.numpy(), np.asarray(j.ctx0))
    np.testing.assert_array_equal(t.tokenized, j.tokenized)
    assert (t.cls0 is None) == (j.cls0 is None) and (t.cls_mask is None) == (j.cls_mask is None)
    if j.cls0 is not None:
        np.testing.assert_array_equal(t.cls0.numpy(), np.asarray(j.cls0))
        np.testing.assert_array_equal(t.cls_mask.numpy(), np.asarray(j.cls_mask))
    if kw.get("ctx_position", "end") != "end" or "[CLS]" in (kw.get("ctx_init") or ""):
        assert not np.array_equal(t.ctx_map[:, 1:1 + t.n_ctx].numpy(), np.tile(np.arange(t.n_ctx), (6, 1)))


def test_learned_cls_refuses_other_positions_as_jax(weights):
    jp, tp = weights
    for build, params in ((JP.build_prompt_state, jp), (TP.build_prompt_state, tp)):
        with pytest.raises(ValueError, match=r"learned_cls requires ctx_position='end'"):
            build(params, CLASSNAMES, ctx_init="a [CLS] photo", learned_cls=True)


def test_splice_with_class_tokens_matches_jax_per_episode(weights):
    """Contexts [N, n_ctx, D] and class tokens [N, C, D] against JAX's
    ``splice_arrays`` vmapped over the episodes, fp32 and bf16."""
    jp, tp = weights
    j = JP.build_prompt_state(jp, CLASSNAMES, ctx_init=None, learned_cls=True)
    t = TP.build_prompt_state(tp, CLASSNAMES, ctx_init=None, learned_cls=True)
    rng = np.random.default_rng(0)
    ctx = rng.normal(size=(3, 4, 64)).astype(np.float32)
    cls = rng.normal(size=(3, len(CLASSNAMES), 64)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jax.vmap(lambda c, k: JP.splice_arrays(c, j.fixed_embed, j.ctx_map, k, j.cls_mask))(
            jnp.asarray(ctx).astype(jdtype), jnp.asarray(cls))
        got = TP.splice_arrays(torch.from_numpy(ctx).to(dtype), t.fixed_embed, t.ctx_map, torch.from_numpy(cls),
                               t.cls_mask)
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"   # the fp32 class token promotes
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_confident_and_confidence_gap_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(40, 7)).astype(np.float32) * 3
    logits[5] = logits[9]   # a tie: lower index first in both
    for p in (0.1, 0.25, 0.01, 1.0):
        np.testing.assert_array_equal(TL.select_confident(torch.from_numpy(logits), p).numpy(),
                                      np.asarray(JL.select_confident(jnp.asarray(logits), p)))
    np.testing.assert_allclose(TL.confidence_gap(torch.from_numpy(logits)).numpy(),
                               np.asarray(JL.confidence_gap(jnp.asarray(logits))), rtol=1e-6, atol=1e-6)
    batched = rng.normal(size=(3, 40, 7)).astype(np.float32)   # leading episode axis: each its own
    np.testing.assert_array_equal(TL.select_confident(torch.from_numpy(batched), 0.1).numpy(),
                                  np.stack([np.asarray(JL.select_confident(jnp.asarray(b), 0.1)) for b in batched]))
    np.testing.assert_allclose(TL.confidence_gap(torch.from_numpy(batched)).numpy(),
                               np.stack([np.asarray(JL.confidence_gap(jnp.asarray(b))) for b in batched]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ctx_init", ["a photo of a [CLS] taken", "[CLS] a_photo"])
def test_prompt_tta_episode_with_cls_in_ctx_init_matches_jax(weights, ctx_init):
    """``tta_cls --ctx_init`` with a ``[CLS]`` word: the class name inside the
    context (middle position) through a whole RLCF episode group, fp32
    (selections equal, losses and logits within 2e-4)."""
    from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
    from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
    from rlcf_tpu.tasks.classification import PromptTTAClassifier as JClassifier
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.tasks.classification import PromptTTAClassifier

    jp, tp = weights
    jcfg, tcfg = tiny_cfgs()
    ek = dict(tta_steps=2, selection_p=0.25, lr=7e-3, sample_k=2)
    jclf = JClassifier(jp, jcfg, JClipReward(jp, jcfg, JRewardConfig(sample_k=2)), JEpisodeConfig(**ek),
                       ctx_init=ctx_init).setup(CLASSNAMES)
    tclf = PromptTTAClassifier(tp, tcfg, ClipReward(tp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(**ek),
                               ctx_init=ctx_init).setup(CLASSNAMES)
    views = np.random.default_rng(5).integers(0, 256, size=(2, 8, 32, 32, 3), dtype=np.uint8)
    jl, jaux = jclf.adapt(views)
    tl, taux = tclf.adapt(views)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
