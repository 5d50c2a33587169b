"""The port's sharded episodes on the CPU over gloo, ranks launched by
``torch_parallel_workers.launch``, against the JAX package's unsharded runs
on the same weights and numpy inputs (``tests/test_parallel.py`` holds those
equal to JAX's mesh runs): the prompt classifier at dp 2 x tp 2 (tokens,
NHWC views, the fused sources' path, a group that does not tile dp, a
reward ensemble), encoder
TTA at dp 2 with the momentum fold, and retrieval at dp 2 x tp 2 in both
directions, with the galleries precomputed over dp and the policy's gradient
under tp against the unsharded gradient. fp32; logits and scores within
2e-4 + 2e-4 relative, selections equal."""

import jax
import numpy as np
import pytest
import torch

from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.core.reward import ClipReward as JClipReward, ClipRewardEnsemble as JClipRewardEnsemble
from rlcf_tpu.core.reward import RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks import retrieval as JR
from rlcf_tpu.tasks.classification import EncoderTTAClassifier as JEncoder, PromptTTAClassifier as JPrompt
from rlcf_torch.core import policy as Po
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks import retrieval as TR
from rlcf_torch.tasks.classification import EncoderTTAClassifier, PromptTTAClassifier
from rlcf_torch.tokenizer import tokenize

from torch_parallel_workers import launch, policy_grad
from torch_port_fixtures import jax_params_numpy, tiny_cfgs

TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ["cat", "dog", "bird", "car", "tree", "boat", "fish", "lamp"]   # 8 classes: tile tp = 2
PROMPT_EK = dict(tta_steps=2, selection_p=0.25, lr=7e-3, sample_k=2)


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs()
    jp, jrp = (JC.init_clip_params(jax.random.PRNGKey(s), jcfg) for s in (0, 1))
    return jcfg, tcfg, jp, jrp, TV.from_jax_params(jax_params_numpy(jp), tcfg), \
        TV.from_jax_params(jax_params_numpy(jrp), tcfg)


def _close(got, want):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want), **TOL)


# -- prompt TTA at dp 2 x tp 2 ------------------------------------------------


@pytest.fixture(scope="module")
def prompt_run(towers, tmp_path_factory):
    jcfg, tcfg, jp, jrp, tp, trp = towers
    rng = np.random.default_rng(0)
    payload = dict(params=tp, rparams=trp, cfg=tcfg, names=NAMES, ek=PROMPT_EK, sample_k=2, tp=2,
                   tokens=rng.integers(0, 256, size=(4, 8, 4, 768), dtype=np.uint8),
                   views=rng.integers(0, 256, size=(4, 8, 32, 32, 3), dtype=np.uint8),
                   sources=rng.integers(0, 256, size=(4, 3, 40, 40), dtype=np.uint8), n_views=8, src=40, res=32)
    return payload, launch(tmp_path_factory.mktemp("prompt"), 4, "prompt", payload)


def _jax_prompt(towers, ensemble: bool = False):
    jcfg, _, jp, jrp, _, _ = towers
    rcfg = JRewardConfig(sample_k=2)
    reward = JClipReward(jrp, jcfg, rcfg)
    if ensemble:
        reward = JClipRewardEnsemble([reward, JClipReward(jp, jcfg, rcfg)], rcfg)
    return JPrompt(jp, jcfg, reward, JEpisodeConfig(**PROMPT_EK), ctx_init="a photo of a").setup(NAMES)


def _torch_prompt(towers):
    _, tcfg, _, _, tp, trp = towers
    return PromptTTAClassifier(tp, tcfg, ClipReward(trp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(**PROMPT_EK),
                               ctx_init="a photo of a").setup(NAMES)


def test_prompt_classes_shard_over_tp(prompt_run):
    _, run = prompt_run
    assert run["mesh"] == {"dp": 2, "tp": 2}
    assert run["n_local_classes"] == 4 and run["n_local_reward_feats"] == 4   # the reward's class features too
    # an ensemble's members keep the whole class axis: [N/dp, M, S, C] with C = 8, not tp copies of it
    assert run["ensemble_reward_sim"] == (2, 2, 2, 8)


@pytest.mark.parametrize("path", ["tokens", "nhwc", "untiled", "ensemble"])
def test_prompt_classifier_matches_jax(towers, prompt_run, path):
    payload, run = prompt_run
    jclf = _jax_prompt(towers, ensemble=path == "ensemble")
    if path in ("nhwc", "ensemble"):
        jl, jaux = jclf.adapt(payload["views"])
    else:
        jl, jaux = jclf.adapt_tokens(payload["tokens"][:3] if path == "untiled" else payload["tokens"])
    got = run[path]
    np.testing.assert_array_equal(got["selected"].numpy(), np.asarray(jaux["selected"]))
    _close(got["losses"], jaux["losses"])
    _close(got["logits"], jl)


def test_prompt_sources_path_matches_one_process(towers, prompt_run):
    """``adapt_sources_fn`` on the mesh: each dp rank builds its slice's views
    (``fused_views_sharded``); the group equals the unsharded call's."""
    payload, run = prompt_run
    fn = _torch_prompt(towers).adapt_sources_fn(n_views=8, src_size=40, resolution=32)
    logits, losses, seed = fn(payload["sources"], 5)
    assert seed == 6
    _close(run["sources"]["logits"], logits)
    _close(run["sources"]["losses"], losses)


# -- encoder TTA at dp 2, momentum ------------------------------------------


def test_encoder_dp_with_momentum_matches_jax(towers, tmp_path):
    """Two groups of 2 at dp 2; the EMA re-anchors inside the second group
    (update_freq 3), folded by every rank over the gathered adapted stack."""
    jcfg, tcfg, jp, jrp, tp, trp = towers
    ek = dict(tta_steps=2, selection_p=0.25, lr=1e-3, sample_k=2)
    kw = dict(momentum_update=True, update_freq=3, momentum=0.5)
    rng = np.random.default_rng(1)
    groups = [rng.integers(0, 256, size=(2, 8, 32, 32, 3), dtype=np.uint8) for _ in range(2)]
    run = launch(tmp_path, 2, "encoder", dict(params=tp, rparams=trp, cfg=tcfg, names=NAMES[:4], ek=ek, kw=kw,
                                              groups=groups))
    jclf = JEncoder(jp, jcfg, JClipReward(jrp, jcfg, JRewardConfig(sample_k=2)), JEpisodeConfig(**ek), **kw)
    jclf.setup(NAMES[:4])
    tclf = EncoderTTAClassifier(tp, tcfg, ClipReward(trp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(**ek),
                                **kw).setup(NAMES[:4])
    for views, got in zip(groups, run["groups"]):
        jl, jaux = jclf.adapt(views)
        tl, _ = tclf.adapt(views)
        np.testing.assert_array_equal(got["selected"].numpy(), np.asarray(jaux["selected"]))
        _close(got["logits"], jl)
        _close(got["logits"], tl)
    assert run["counter"] == tclf.momentum_state.counter == 1
    for got, want in zip(Po.tree_leaves(run["reset"]), Po.tree_leaves(tclf.momentum_state.reset_params)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# -- retrieval at dp 2 x tp 2 -------------------------------------------------


RET_EK = dict(tta_steps=2, lr=1e-4, sample_k=2, adam_eps=1e-6)
TEXTS = [f"a photo of thing {i}" for i in range(8)]          # 8 captions: tile tp = 2
GALLERY_TEXTS = [f"a photo number {i}" for i in range(13)]   # batches of 5 over dp = 2: the ragged pad path


@pytest.fixture(scope="module")
def retrieval_run(towers, tmp_path_factory):
    _, tcfg, _, _, tp, trp = towers
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(11, 32, 32, 3)).astype(np.float32)
    payload = dict(params=tp, rparams=trp, cfg=tcfg, tp=2, texts=TEXTS, gallery_texts=GALLERY_TEXTS,
                   image_batches=[imgs[:6], imgs[6:]], images=rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                   tokens=tokenize(TEXTS[:4], truncate=True).astype(np.int64), ek=RET_EK, kw={})
    return payload, launch(tmp_path_factory.mktemp("retrieval"), 4, "retrieval", payload)


def test_gallery_precompute_dp_sharded_matches_jax(towers, retrieval_run):
    jcfg, _, jp, _, _, _ = towers
    payload, run = retrieval_run
    want, _ = JR.encode_text_gallery(jp, jcfg, GALLERY_TEXTS, batch_size=5)
    np.testing.assert_allclose(run["text_gallery"].numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    want_i = JR.encode_image_gallery(jp, jcfg, payload["image_batches"])
    np.testing.assert_allclose(run["image_gallery"].numpy(), np.asarray(want_i), rtol=2e-5, atol=2e-6)


def _jax_retrieval(towers, direction, payload):
    jcfg, _, jp, jrp, _, _ = towers
    tta = JR.RetrievalTTA(jp, jcfg, JClipReward(jrp, jcfg, JRewardConfig(sample_k=2)), JEpisodeConfig(**RET_EK),
                          direction=direction)
    if direction == "i2t":
        return tta.set_text_gallery(TEXTS).adapt_queries(payload["images"])
    tta.set_image_gallery([payload["images"]], [payload["images"]])
    return tta.adapt_queries(payload["tokens"])


@pytest.mark.parametrize("direction", ["i2t", "t2i"])
def test_retrieval_gallery_tp_sharding_matches_jax(towers, retrieval_run, direction):
    payload, run = retrieval_run
    assert run[direction]["local_gallery"] == {"i2t": 4, "t2i": 2}[direction]   # each tp rank scores half the gallery
    _close(run[direction]["scores"], _jax_retrieval(towers, direction, payload))


@pytest.mark.parametrize("direction", ["i2t", "t2i"])
def test_retrieval_policy_gradient_under_tp_is_the_unsharded_gradient(towers, retrieval_run, direction):
    """The policy tower's gradient of a loss over the whole gallery's score
    row: the query features' gradient summed over tp on the way back."""
    _, tcfg, _, _, tp, trp = towers
    payload, run = retrieval_run
    tta = TR.RetrievalTTA(tp, tcfg, ClipReward(trp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(**RET_EK),
                          direction=direction)
    if direction == "i2t":
        tta.set_text_gallery(TEXTS)
        queries = payload["images"]
    else:
        tta.set_image_gallery([payload["images"]], [payload["images"]])
        queries = payload["tokens"]
    want = policy_grad(tta, queries, torch.as_tensor(queries))
    got = run[direction]["grad"]
    # sharded reductions reorder fp32 sums (tests/test_parallel.py's gradient tolerance); a tp-fold gradient
    # is off by its whole norm
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-5)
    assert float((got - want).norm() / want.norm()) < 1e-4
