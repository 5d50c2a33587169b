"""The port's caption TTA (``rlcf_torch/tasks/caption.py``) against the JAX
package's on the same weights and inputs: the per-caption CE, the host
round trip's bucketing, the GPT-2 tokenizer copy, mapper checkpoints read
across the packages, and whole episodes (``adapt_image``, ``adapt_batch``,
with and without the momentum anchor). Tolerances: CE 1e-6 (fp32), rewards
2e-4; sampled and final captions equal."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core.reward import ClipReward as JReward, RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.models import mappers as JM
from rlcf_tpu.models import opt as JO
from rlcf_tpu.tasks import caption as JCap
from rlcf_tpu.tokenizer_gpt2 import Gpt2Tokenizer as JTok
from rlcf_torch.core import policy as Po
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.models import mappers as TM
from rlcf_torch.models import opt as TO
from rlcf_torch.models.convert import from_jax_mapper_params, from_jax_opt_params, from_jax_params
from rlcf_torch.tasks import caption as Cap
from rlcf_torch.tokenizer_gpt2 import Gpt2Tokenizer
from torch_port_fixtures import chip_smoke
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MAPPER = dict(clip_dim=16, llm_dim=32, prefix_length=4, clip_length=2, num_layers=1, n_heads=2)
TTA = dict(tta_steps=2, lr=1e-2, sample_k=3, max_new_tokens=6, token_pad_len=40)


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    """A synthetic OPT-layout vocabulary of 600 entries: the tiny OPT's 256
    ids are the specials and lowercase words, so its captions decode to text;
    the byte symbols sit at ids 344..599, past its vocabulary."""
    return chip_smoke.write_opt_vocab(str(tmp_path_factory.mktemp("vocab")), size=600, newline_id=None)


@pytest.fixture(scope="module")
def models():
    """The same tiny caption model (the OPT embedding scaled up, so that the
    beams rank clearly apart) and tiny reward CLIP in both packages."""
    ocfg = JO.OPT_CONFIGS["test-tiny-opt"]
    jccfg = JCap.CaptionModelConfig(mapper=JM.MapperConfig("transformer", **MAPPER), opt=ocfg)
    tree = jax.tree_util.tree_map(np.asarray, JCap.init_caption_params(jax.random.PRNGKey(0), jccfg))
    tree["opt"]["embed_tokens"] = tree["opt"]["embed_tokens"] * 5.0
    tccfg = Cap.CaptionModelConfig(mapper=TM.MapperConfig("transformer", **MAPPER), opt=TO.OPT_CONFIGS["test-tiny-opt"])
    tparams = {"mapper": from_jax_mapper_params(tree["mapper"]), "opt": from_jax_opt_params(tree["opt"])}
    args = ("tiny-reward", 16, 32, 1, 32, 16, 32, 1)
    jrc = JC.ClipConfig(*args, vision_heads_override=2, text_heads_override=2)
    trc = TC.ClipConfig(*args, vision_heads_override=2, text_heads_override=2)
    rtree = jax.tree_util.tree_map(np.asarray, JC.init_clip_params(jax.random.PRNGKey(1), jrc))
    jreward = JReward(jax.tree_util.tree_map(jnp.asarray, rtree), jrc, JRewardConfig(sample_k=3))
    treward = ClipReward(from_jax_params(rtree, trc), trc, RewardConfig(sample_k=3))
    return (jax.tree_util.tree_map(jnp.asarray, tree), jccfg, jreward), (tparams, tccfg, treward)


def _inputs(n=2, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, 32, 32, 3)).astype(np.float32), r.normal(size=(n, 16)).astype(np.float32)


# ---------------------------------------------------------------------------
# caption_ce
# ---------------------------------------------------------------------------


def _ce_case(case):
    """(logits [K, P+L, V], tokens [K, L], valid mask or None, per_sample) of one case of the JAX package's tests."""
    rng = np.random.default_rng(3)
    K, P, V, L = 3, 4, 256, 10
    lengths = [3, 6, 4]
    tokens = np.full((K, L), 1, np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(3, V, size=(n,))
    mask = (np.arange(L)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    logits = rng.normal(size=(K, P + L, V)).astype(np.float32)
    if case == "mean ignore 0":
        tokens[0, 1] = 0
        return logits, tokens, None, False
    if case == "per sample":
        tokens[1, 2] = 0
        return logits, tokens, None, True
    if case == "per sample unequal lengths":
        return logits, tokens, mask, True
    if case == "past the vocabulary":
        tokens[2, 1] = 258
        return logits, tokens, mask, True
    raise ValueError(case)


@pytest.mark.parametrize("case", ["mean ignore 0", "per sample", "per sample unequal lengths", "past the vocabulary"])
def test_caption_ce_matches_jax(case):
    """A target id past the vocabulary: NaN in both (JAX's take_along_axis
    fills it), and no gradient in the port."""
    logits, tokens, mask, per = _ce_case(case)
    want = np.asarray(JCap.caption_ce(jnp.asarray(logits), jnp.asarray(tokens), 4, per_sample=per,
                                      valid_mask=None if mask is None else jnp.asarray(mask)))
    lg = torch.as_tensor(logits).requires_grad_(True)
    got = Cap.caption_ce(lg, torch.as_tensor(tokens), 4, per_sample=per,
                         valid_mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)   # NaN where JAX has NaN
    torch.where(torch.isnan(got), 0.0, got).sum().backward()
    assert bool(torch.isfinite(lg.grad).all())


def test_caption_ce_pad_invariant_and_batched():
    """Any pad at least the longest caption gives the same per-sample CE
    (what makes the 32-token bucket exact), and images stacked on a leading
    axis each take their own longest length."""
    logits, tokens, mask, _ = _ce_case("per sample unequal lengths")
    t = lambda a: torch.as_tensor(a)
    long_ = Cap.caption_ce(t(logits), t(tokens), 4, per_sample=True, valid_mask=t(mask))
    short = Cap.caption_ce(t(logits[:, :4 + 7]), t(tokens[:, :7]), 4, per_sample=True, valid_mask=t(mask[:, :7]))
    torch.testing.assert_close(short, long_, rtol=1e-6, atol=1e-6)
    other = mask.copy()
    other[:, 3:] = 0   # a second image whose longest caption is 3 tokens
    stacked = Cap.caption_ce(t(np.stack([logits, logits])), t(np.stack([tokens, tokens])), 4, per_sample=True,
                             valid_mask=t(np.stack([mask, other])))
    torch.testing.assert_close(stacked[0], long_)
    torch.testing.assert_close(stacked[1], Cap.caption_ce(t(logits), t(tokens), 4, per_sample=True,
                                                          valid_mask=t(other)))


# ---------------------------------------------------------------------------
# the host round trip
# ---------------------------------------------------------------------------


def _tta(models, vocab_files, **kw):
    tparams, tccfg, treward = models[1]
    return Cap.CaptionTTA(tparams, tccfg, treward, Gpt2Tokenizer(*vocab_files), **{**TTA, **kw})


def test_decode_retokenize_bucket_and_never_truncates(models, vocab_files):
    """Short captions pad to the first 32-token bucket (capped by
    token_pad_len); a caption longer than token_pad_len grows the bucket
    with a warning and keeps every id."""
    tta = _tta(models, vocab_files, token_pad_len=96)
    tok = tta.tok
    words = [w for w, i in sorted(json.load(open(vocab_files[0])).items(), key=lambda kv: kv[1]) if 4 <= i < 40]
    seqs = np.full((3, 8), tok.pad_id, np.int32)
    for i, n in enumerate((2, 5, 1)):
        ids = tok.encode(" ".join(w.lstrip("Ġ") for w in words[:n]))
        seqs[i, : len(ids)] = ids
    texts, opt_tokens, opt_mask, clip_tokens = tta._decode_and_retokenize(seqs)
    assert opt_tokens.shape == opt_mask.shape == (3, 32) and clip_tokens.shape == (3, 77)
    assert (opt_tokens[opt_mask == 0] == tok.pad_id).all()
    assert _tta(models, vocab_files, token_pad_len=10)._decode_and_retokenize(seqs)[1].shape == (3, 10)
    long_ids = tok.encode(" ".join(w.lstrip("Ġ") for w in words) * 2)
    assert len(long_ids) > 40
    seqs = np.full((2, len(long_ids)), tok.pad_id, np.int32)
    seqs[0] = long_ids
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        texts, opt_tokens, opt_mask, _ = _tta(models, vocab_files, token_pad_len=10)._decode_and_retokenize(seqs)
    assert any("exceeds token_pad_len" in str(w.message) for w in rec)
    assert opt_tokens.shape[1] % 32 == 0 and opt_tokens.shape[1] >= len(long_ids)
    np.testing.assert_array_equal(opt_tokens[0][opt_mask[0] == 1], tok.encode(texts[0]))


def test_tokenizer_copy_matches_jax(tmp_path):
    """The port's GPT-2 tokenizer (its word split a scanner, the JAX
    package's the ``regex`` module) gives JAX's ids and texts on the golden
    texts and on sampled ids, with OPT's 50,265-entry synthetic vocabulary."""
    vocab, merges = chip_smoke.write_opt_vocab(str(tmp_path))
    jt, tt = JTok(vocab, merges), Gpt2Tokenizer(vocab, merges)
    with open(os.path.join(FIXTURES, "golden_tokens.json")) as fh:
        texts = json.load(fh)["texts"]
    texts += ["a photo of  the\tcat's toy\n", " two  dogs, 3 cats!", "naïve café — 東京", ""]
    for text in texts:
        assert tt.encode(text) == jt.encode(text), text
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    ids = np.random.default_rng(0).integers(0, 50272, size=(6, 20))
    ids[:, 5] = 50118
    assert tt.batch_decode(ids, stop_id=50118) == jt.batch_decode(ids, stop_id=50118)
    got, want = tt.batch_encode(texts[:5], return_lengths=True), jt.batch_encode(texts[:5], return_lengths=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# mapper checkpoints
# ---------------------------------------------------------------------------


def test_mapper_checkpoints_read_across_packages(models, tmp_path):
    (jparams, _, _), (tparams, _, _) = models
    Cap.save_mapper_checkpoint(str(tmp_path / "port.npz"), tparams["mapper"], epoch=3)
    loaded, epoch = JCap.load_mapper_checkpoint(str(tmp_path / "port.npz"), jparams["mapper"])
    assert epoch == 3
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), loaded,
                           jparams["mapper"])
    moved = jax.tree_util.tree_map(lambda a: a + 1.0, jparams["mapper"])
    JCap.save_mapper_checkpoint(str(tmp_path / "jax.npz"), moved, epoch=7)
    got, epoch = Cap.load_mapper_checkpoint(str(tmp_path / "jax.npz"), tparams["mapper"])
    assert epoch == 7
    for (path, want), leaf in zip(jax.tree_util.tree_flatten_with_path(moved)[0], Po.tree_leaves(got)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want), err_msg=str(path))


# ---------------------------------------------------------------------------
# episodes
# ---------------------------------------------------------------------------


def _compare_traces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([r for _, r in g], [r for _, r in w], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("momentum", [False, True])
def test_adapt_matches_jax(models, vocab_files, momentum):
    """adapt_image per image and adapt_batch over the group against
    ``rlcf_tpu``'s: each step's sampled captions equal and rewards within
    2e-4, the final captions equal; with the momentum anchor (update_freq 1,
    re-anchored after every image) the anchors agree too."""
    (jparams, jccfg, jreward), (tparams, tccfg, treward) = models
    kw = dict(momentum_update=True, update_freq=1, momentum=0.5) if momentum else {}
    jt = JCap.CaptionTTA(jparams, jccfg, jreward, JTok(*vocab_files), **TTA, **kw)
    tt = Cap.CaptionTTA(tparams, tccfg, treward, Gpt2Tokenizer(*vocab_files), **TTA, **kw)
    images, embs = _inputs()
    seen = []
    for adapt in ("image", "batch"):
        jtrace, ttrace = [], []
        if adapt == "image":
            want = [jt.adapt_image(images[i], embs[i], trace=jtrace) for i in range(2)]
            got = [tt.adapt_image(images[i], embs[i], trace=ttrace) for i in range(2)]
        else:
            want = jt.adapt_batch(images, embs, trace=jtrace)
            got = tt.adapt_batch(images, embs, trace=ttrace)
        assert got == want
        _compare_traces(ttrace, jtrace)
        seen += [pair for step in ttrace for pair in step]
    assert len({t for t, _ in seen}) > 1 and any(abs(r) > 1e-3 for _, r in seen)   # the check can tell apart
    if momentum:
        for (path, w), leaf in zip(jax.tree_util.tree_flatten_with_path(jt.momentum_state.reset_params)[0],
                                   Po.tree_leaves(tt.momentum_state.reset_params)):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_adapt_batch_equals_adapt_image(models, vocab_files):
    """The group's stacked mappers give each image what it gets alone, and a
    rerun gives the same (each group starts from the same weights)."""
    tta = _tta(models, vocab_files)
    images, embs = _inputs(3, seed=1)
    singles = [tta.adapt_image(images[i], embs[i]) for i in range(3)]
    assert tta.adapt_batch(images, embs) == singles == tta.adapt_batch(images, embs)


def test_update_matches_optax_steps(models, vocab_files):
    """Three AdamW steps of one image's mapper on fixed captions (weight
    decay on): the losses agree within 1e-5 and the weights with three
    ``optax.adamw`` steps of the JAX package's update within 1e-3 of the
    three steps' reach (3 lr): where a gradient is near eps (1e-6), AdamW's
    step follows its last bits (AdamW's first step is lr * sign(g))."""
    import optax

    (jparams, jccfg, _), (tparams, tccfg, _) = models
    tta = _tta(models, vocab_files, weight_decay=0.1)
    tokens = np.random.default_rng(4).integers(4, 256, size=(1, 3, 5)).astype(np.int64)
    attn = np.ones((1, 3, 4 + 5), np.int64)
    attn[0, 1, -2:] = 0
    rewards = np.array([[0.5, -0.2, -0.3]], np.float32)
    emb = _inputs(1)[1]
    mappers = Po.tree_map(lambda a: a.detach()[None].clone().requires_grad_(True), tparams["mapper"])
    opt = Cap.make_optimizer(Po.tree_leaves(mappers), tta.ecfg)
    jopt = optax.adamw(1e-2, eps=1e-6, weight_decay=0.1)
    jm, state = jparams["mapper"], jopt.init(jparams["mapper"])

    def jloss(m):
        logits = JO.forward(jparams["opt"], jccfg.opt, tokens=jnp.asarray(tokens[0]),
                            prefix_embeds=JCap.prefix_tokens(m, jccfg, jnp.repeat(jnp.asarray(emb), 3, axis=0)),
                            attention_mask=jnp.asarray(attn[0]))
        ce = JCap.caption_ce(logits, jnp.asarray(tokens[0]), 4, per_sample=True, valid_mask=jnp.asarray(attn[0, :, 4:]))
        return jnp.mean(jnp.asarray(rewards[0]) * ce)

    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    for _ in range(3):
        loss = tta._update_step(opt, mappers, torch.as_tensor(emb), torch.as_tensor(tokens), torch.as_tensor(attn),
                                torch.as_tensor(rewards))
        jl, grads = value_and_grad(jm)
        updates, state = jopt.update(grads, state, jm)
        jm = optax.apply_updates(jm, updates)
        np.testing.assert_allclose(float(loss[0]), float(jl), rtol=1e-5, atol=1e-6)
    for (path, w), leaf in zip(jax.tree_util.tree_flatten_with_path(jm)[0], Po.tree_leaves(mappers)):
        np.testing.assert_allclose(leaf.detach()[0].numpy(), np.asarray(w), rtol=0, atol=3e-5, err_msg=str(path))


def test_quantized_decode_and_nucleus_run(models, vocab_files):
    """int8 decode weights for generation only (the update keeps fp32), and
    nucleus sampling drawn from a generator seeded by the run's seed and the
    group's index: a rerun with the same seed gives the same captions."""
    tta = _tta(models, vocab_files, quantize_decode=True)
    assert tta.decode_params["embed_tokens"]["q8"].dtype == torch.int8
    assert tta.params["opt"]["embed_tokens"].dtype == torch.float32
    images, embs = _inputs()
    caps = tta.adapt_batch(images, embs)
    assert len(caps) == 2 and all(isinstance(c, str) for c in caps)
    runs = [_tta(models, vocab_files, use_nucleus=True, seed=5).adapt_batch(images, embs) for _ in range(2)]
    assert runs[0] == runs[1]
