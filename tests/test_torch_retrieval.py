"""Retrieval TTA on the CPU against ``rlcf_tpu`` (fp32, tiny towers): the
caption and image galleries, the i2t episodes (rlcf, kd, dkd, atkd; a reward
at another resolution), the t2i episodes with the factored token embedding
and with the full tower under a momentum EMA, the per-episode text tower,
the group cap, the refusal of an ensemble and the zero-shot scores.

Tolerances: galleries within 1e-5; score rows and per-step losses within
2e-4 + 2e-4 relative; the top-k index lists of every step equal. JAX's
top-k comes from its episode through a debug callback, which under vmap
reports the (episode, step) pairs in no fixed order: the lists are compared
as multisets of ordered top-k rows."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks import retrieval as JR
from rlcf_torch.core import losses as Lo
from rlcf_torch.core import policy as Po
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.core.reward import ClipReward, ClipRewardEnsemble, RewardConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks import retrieval as TR
from rlcf_torch.tokenizer import tokenize

from torch_port_fixtures import jax_params_numpy, tiny_cfgs, weights_close

TOL = dict(rtol=2e-4, atol=2e-4)
TEXTS = ["a man riding a wave on a surfboard", "two dogs playing in the snow", "a kitchen with a stove and sink",
         "a group of people at a market", "a plane flying over mountains", "a cat sleeping on a couch",
         "a red bus parked beside a brick building"]
# "dogs" twice: the factored embedding's repeated-token gradient
QUERIES = ["two dogs chasing three dogs in deep snow", TEXTS[2], TEXTS[0], "a man on a surfboard"]


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs()
    jcfg64, tcfg64 = tiny_cfgs("t64", res=64)
    out = dict(jcfg=jcfg, tcfg=tcfg, jcfg64=jcfg64, tcfg64=tcfg64)
    for name, cfg_pair, seed in (("p", (jcfg, tcfg), 0), ("r", (jcfg, tcfg), 1), ("r64", (jcfg64, tcfg64), 2)):
        jp = JC.init_clip_params(jax.random.PRNGKey(seed), cfg_pair[0])
        out["j" + name], out["t" + name] = jp, TV.from_jax_params(jax_params_numpy(jp), cfg_pair[1])
    return out


def _images(n, res=32, seed=0):
    return np.random.default_rng(seed).normal(size=(n, res, res, 3)).astype(np.float32)


def _engines(t, direction, loss="rlcf", lr=1e-3, steps=3, sample_k=3, reward="r", **kw):
    ek = dict(tta_steps=steps, lr=lr, sample_k=sample_k, adam_eps=1e-6, loss=loss)
    rcfg = (t["jcfg64"], t["tcfg64"]) if reward == "r64" else (t["jcfg"], t["tcfg"])
    jtta = JR.RetrievalTTA(t["jp"], t["jcfg"], JClipReward(t["j" + reward], rcfg[0], JRewardConfig(sample_k=sample_k)),
                           JEpisodeConfig(**ek), direction=direction, **kw)
    ttta = TR.RetrievalTTA(t["tp"], t["tcfg"], ClipReward(t["t" + reward], rcfg[1], RewardConfig(sample_k=sample_k)),
                           EpisodeConfig(**ek), direction=direction, **kw)
    if direction == "i2t":
        return jtta.set_text_gallery(TEXTS), ttta.set_text_gallery(TEXTS)
    gallery = _images(5, seed=1)
    jtta.set_image_gallery([gallery], [gallery])
    ttta.set_image_gallery([gallery[:3], gallery[3:]], [gallery[:3], gallery[3:]])   # two batches
    return jtta, ttta


def _record_episodes(tta):
    """Wrap the engine's episode to keep each group's (logits, aux)."""
    seen, episode = [], tta._episode

    def recording(*a, **k):
        out = episode(*a, **k)
        seen.append(out)
        return out

    tta._episode = recording
    return seen


@contextlib.contextmanager
def _top_k_records(gallery_size):
    """Every step's top-k rows in both packages: (JAX's, the port's)."""
    jrec, trec = [], []
    lax_top_k, port_top_k = jax.lax.top_k, Lo.top_k_indices

    def jax_top_k(x, k):
        values, idx = lax_top_k(x, k)
        if x.shape[-1] == gallery_size:   # not the selection's top-k over views
            jax.debug.callback(lambda a: jrec.extend(tuple(r) for r in np.asarray(a).reshape(-1, k)), idx)
        return values, idx

    def torch_top_k(x, k):
        idx = port_top_k(x, k)
        trec.extend(tuple(r) for r in idx.reshape(-1, k).tolist())
        return idx

    jax.lax.top_k, Lo.top_k_indices = jax_top_k, torch_top_k
    try:
        yield jrec, trec
    finally:
        jax.lax.top_k, Lo.top_k_indices = lax_top_k, port_top_k


def _assert_runs_equal(jtta, ttta, queries, total, gallery_size, group_size=2, top_k=True):
    jseen, tseen = _record_episodes(jtta), _record_episodes(ttta)
    with _top_k_records(gallery_size) as (jrec, trec):
        jscores = jtta.run(iter(queries), total, gallery_size, group_size=group_size)
        tscores = ttta.run(iter(queries), total, gallery_size, group_size=group_size)
    np.testing.assert_allclose(tscores, jscores, **TOL)
    assert len(tseen) == len(jseen) == -(-total // group_size) and len(ttta.group_seconds) == len(tseen)
    for (_, taux), (_, jaux) in zip(tseen, jseen):
        np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **TOL)
    if top_k:
        assert len(trec) == total * ttta.ecfg.tta_steps and sorted(trec) == sorted(jrec)
    return tscores, jscores


def test_galleries_match_jax(towers):
    t = towers
    jfeats, jtok = JR.encode_text_gallery(t["jp"], t["jcfg"], TEXTS, batch_size=4)
    tfeats, ttok = TR.encode_text_gallery(t["tp"], t["tcfg"], TEXTS, batch_size=4)
    np.testing.assert_array_equal(ttok, np.asarray(jtok))
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), rtol=1e-5, atol=1e-5)
    imgs = _images(5)
    np.testing.assert_allclose(TR.encode_image_gallery(t["tp"], t["tcfg"], [imgs[:2], imgs[2:]]).numpy(),
                               np.asarray(JR.encode_image_gallery(t["jp"], t["jcfg"], [imgs])), rtol=1e-5, atol=1e-5)
    for direction in ("i2t", "t2i"):   # the reward's galleries, as each engine caches them
        jtta, ttta = _engines(t, direction, reward="r64")
        np.testing.assert_allclose(ttta.gallery_feats.numpy(), np.asarray(jtta.gallery_feats), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ttta.reward_gallery_feats.numpy(), np.asarray(jtta.reward_gallery_feats),
                                   rtol=1e-5, atol=1e-5)
        assert ttta.reward.class_features is ttta.reward_gallery_feats


@pytest.mark.parametrize("loss,reward", [("rlcf", "r"), ("kd", "r"), ("dkd", "r"), ("atkd", "r"), ("rlcf", "r64")],
                         ids=["rlcf", "kd", "dkd", "atkd", "rlcf-reward-64px"])
def test_i2t_episodes_match_jax(towers, loss, reward):
    """Three query images in groups of two (a ragged last group); the reward
    at 64 px takes the queries resized."""
    jtta, ttta = _engines(towers, "i2t", loss, reward=reward)
    _assert_runs_equal(jtta, ttta, _images(3, seed=2), 3, len(TEXTS), top_k=loss == "rlcf")


def test_t2i_factored_episodes_match_jax(towers):
    jtta, ttta = _engines(towers, "t2i", lr=5e-3, sample_k=2)
    assert ttta.factor_embedding and jtta.factor_embedding
    assert "token_embedding" not in ttta.trainable0 and ttta.trainable_bytes() == jtta.trainable_bytes()
    _assert_runs_equal(jtta, ttta, tokenize(QUERIES[:3]), 3, 5)


def test_t2i_momentum_episodes_match_jax(towers):
    """The full text tower (token embedding included) under a momentum EMA
    re-anchored every 2 queries: two groups of two, score rows, losses and
    top-k of each, and the EMA state after both groups."""
    lr = 5e-3
    jtta, ttta = _engines(towers, "t2i", lr=lr, sample_k=2, momentum_update=True, update_freq=2, momentum=0.5,
                          update_w=0.8)
    assert not ttta.factor_embedding and "token_embedding" in ttta.trainable0
    _assert_runs_equal(jtta, ttta, tokenize(QUERIES), 4, 5)
    assert ttta.momentum_state.counter == jtta.momentum_state.counter == 0
    for part in ("reset_params", "ema_params"):
        weights_close(getattr(ttta.momentum_state, part), getattr(jtta.momentum_state, part), lr, 3)


def test_t2i_factored_equals_full(towers):
    """The port's factored trainable gives the full tower's scores
    (`tests/test_retrieval.py::test_t2i_factored_matches_full` for JAX). The
    full tower is the momentum engine's: its first group starts from the
    unfactored weights, and no re-anchoring falls within it."""
    t = towers
    ecfg = EpisodeConfig(tta_steps=3, lr=5e-3, sample_k=2, adam_eps=1e-6)
    gallery = _images(4, seed=1)
    scores = {}
    for factored in (False, True):
        tta = TR.RetrievalTTA(t["tp"], t["tcfg"], ClipReward(t["tr"], t["tcfg"], RewardConfig(sample_k=2)), ecfg,
                              direction="t2i", momentum_update=not factored, update_freq=256)
        tta.set_image_gallery([gallery], [gallery])
        assert tta.factor_embedding is factored
        scores[factored] = tta.adapt_queries(tokenize(QUERIES[:2]))
    np.testing.assert_allclose(scores[True], scores[False], rtol=2e-5, atol=2e-5)
    assert tta.trainable_bytes() < 0.5 * sum(v.numel() * v.element_size() for v in Po.tree_leaves(t["tp"]["text"]))


def test_adapted_trainables_are_returned(towers):
    _, ttta = _engines(towers, "t2i", lr=5e-3, sample_k=2)
    scores, adapted = ttta.adapt_queries(tokenize(QUERIES[:2]), return_adapted=True)
    assert scores.shape == (2, 5) and adapted["emb_rows"].shape == (2, 77, towers["tcfg"].text_width)
    assert adapted["blocks"]["qkv_w"].shape == (2,) + tuple(ttta.trainable0["blocks"]["qkv_w"].shape)


def test_hbm_group_cap(towers):
    _, ttta = _engines(towers, "i2t")
    assert ttta.hbm_group_cap() is None   # the CPU: no limit known
    fixed = sum(v.numel() * v.element_size() for v in Po.tree_leaves(ttta.clip_params) +
                Po.tree_leaves(ttta.reward.params) + [ttta.gallery_feats, ttta.reward_gallery_feats])
    per = ttta.PER_EPISODE_FACTOR * ttta.trainable_bytes()
    share = ttta.HBM_USABLE_SHARE
    assert ttta.hbm_group_cap(int((fixed + 100.5 * per) / share)) == 100
    assert ttta.hbm_group_cap(int(fixed / share)) == 1   # no room for one: one all the same


def test_ensemble_reward_is_refused(towers):
    t = towers
    member = ClipReward(t["tr"], t["tcfg"], RewardConfig())
    with pytest.raises(ValueError, match="single ClipReward"):
        TR.RetrievalTTA(t["tp"], t["tcfg"], ClipRewardEnsemble([member, member], RewardConfig()), EpisodeConfig())


def test_zero_shot_scores_match_jax(towers):
    t = towers
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(n, 16)).astype(np.float32) for n in (3, 5, 3, 5)]
    ti2t, tt2i = TR.zero_shot_scores(t["tp"], t["tcfg"], torch.from_numpy(feats[0]), torch.from_numpy(feats[1]))
    ji2t, jt2i = JR.zero_shot_scores(t["jp"], t["jcfg"], jnp.asarray(feats[0]), jnp.asarray(feats[1]))
    np.testing.assert_allclose(ti2t, ji2t, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tt2i, ti2t.T)
    tens = TR.zero_shot_scores_ensemble([(t["tp"], t["tcfg"]), (t["tr"], t["tcfg"])],
                                        [torch.from_numpy(feats[0]), torch.from_numpy(feats[2])],
                                        [torch.from_numpy(feats[1]), torch.from_numpy(feats[3])])
    jens = JR.zero_shot_scores_ensemble([(t["jp"], t["jcfg"]), (t["jr"], t["jcfg"])],
                                        [jnp.asarray(feats[0]), jnp.asarray(feats[2])],
                                        [jnp.asarray(feats[1]), jnp.asarray(feats[3])])
    for a, b in zip(tens, jens):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("per_episode_table", [False, True])
def test_per_episode_text_tower_equals_single_calls(towers, per_episode_table):
    """Two episodes' text weights stacked on a leading axis ([2, ...]; the
    token table shared or per episode) give what each gives alone."""
    t = towers
    text = t["tp"]["text"]
    other = Po.tree_map(lambda v: v + 0.01 * torch.randn_like(v), text)
    stacked = Po.tree_map(lambda a, b: torch.stack([a, b]), text, other)
    if not per_episode_table:
        stacked["token_embedding"] = text["token_embedding"]
        other = {**other, "token_embedding": text["token_embedding"]}
    tokens = torch.as_tensor(tokenize(QUERIES).astype(np.int64)).reshape(2, 2, 77)
    got = TC.encode_text({"text": stacked}, t["tcfg"], tokens)
    assert got.shape == (2, 2, t["tcfg"].embed_dim)
    for n, tower in enumerate((text, other)):
        torch.testing.assert_close(got[n], TC.encode_text({"text": tower}, t["tcfg"], tokens[n]), rtol=1e-5,
                                   atol=1e-6)
