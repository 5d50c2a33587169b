"""The port's OPT decoder (``rlcf_torch/models/opt.py``) against the JAX
package's on the same weights (``from_jax_opt_params``) and inputs:
teacher-forcing logits, the cached decode step, beam search with and without
the segmented cache, EOS and min-length, nucleus sampling's filter and its
greedy limit, int8 weights, the state-dict converters, token ids past the
vocabulary. Tolerances: fp32 logits and beam scores 1e-5; sequences equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.models import mappers as JM
from rlcf_tpu.models import opt as JO
from rlcf_torch.models import mappers as TM
from rlcf_torch.models import opt as TO
from rlcf_torch.models.convert import from_jax_opt_params
from torch_port_fixtures import hf_mapper_state_dict, hf_opt_state_dict
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CONFIGS = ["test-tiny-opt", "test-tiny-opt-350m"]


@functools.lru_cache()
def _weights(name):
    """(JAX params with jnp leaves, the port's) of one tiny config, the
    embedding scaled up so that the decoder's distributions are peaked (the
    beams then rank clearly apart)."""
    tree = jax.tree_util.tree_map(np.asarray, JO.init_opt_params(jax.random.PRNGKey(0), JO.OPT_CONFIGS[name]))
    tree["embed_tokens"] = tree["embed_tokens"] * 5.0
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_opt_params(tree)


def _prefix(name, B=2, P=3, seed=0):
    return np.random.default_rng(seed).normal(size=(B, P, JO.OPT_CONFIGS[name].embed_dim)).astype(np.float32)


@functools.lru_cache()
def _jax_beam(name, K, seg, max_new=8, min_length=1, eos_id=None):
    return jax.jit(functools.partial(JO.beam_generate, cfg=JO.OPT_CONFIGS[name], num_beams=K, max_new_tokens=max_new,
                                     min_length=min_length, eos_id=eos_id, seg_len=seg))


@pytest.mark.parametrize("length", [6, 130])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(name, length):
    """Logits with a prefix and a padding mask, ids past the vocabulary
    (256..259) included and, at 130 tokens, positions past the tiny table's
    130 rows: the JAX package's gather clamps both, so does the port."""
    jp, tp = _weights(name)
    rng = np.random.default_rng(1)
    pre = _prefix(name)
    toks = rng.integers(0, 260, size=(2, length)).astype(np.int32)
    toks[0, :2] = (257, 259)
    mask = np.ones((2, 3 + length), np.int32)
    mask[1, -3:] = 0
    want = np.asarray(JO.forward(jp, JO.OPT_CONFIGS[name], jnp.asarray(toks), jnp.asarray(pre), jnp.asarray(mask)))
    got = TO.forward(tp, TO.OPT_CONFIGS[name], torch.as_tensor(toks).long(), torch.as_tensor(pre),
                     torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_steps_match_the_full_forward(name):
    """Prefill + cached decode steps (a shared prefix cache read by 2 sequences
    a prefix) give the full forward's last-position logits."""
    _, tp = _weights(name)
    cfg = TO.OPT_CONFIGS[name]
    pre = torch.as_tensor(_prefix(name))
    toks = torch.as_tensor(np.random.default_rng(2).integers(4, 256, size=(4, 3)))
    logits0, cache = TO._prefill(tp, cfg, pre)
    full0 = TO.forward(tp, cfg, prefix_embeds=pre)[:, -1]
    torch.testing.assert_close(logits0, full0, rtol=1e-5, atol=1e-5)
    gen = TO._init_gen_cache(cfg, 4, 3, torch.float32, "cpu")
    for t in range(3):
        logits = TO._decode_step(tp, cfg, toks[:, t], cache, gen, t, expand=2)
        full = TO.forward(tp, cfg, tokens=toks[:, : t + 1], prefix_embeds=pre.repeat_interleave(2, dim=0))[:, -1]
        torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seg", [None, 2, 16])
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("name", CONFIGS)
def test_beam_matches_jax(name, K, seg):
    jp, tp = _weights(name)
    pre = _prefix(name, seed=3)
    want_seqs, want_scores = _jax_beam(name, K, seg)(jp, prefix_embeds=jnp.asarray(pre))
    seqs, scores = TO.beam_generate(tp, TO.OPT_CONFIGS[name], torch.as_tensor(pre), num_beams=K, max_new_tokens=8,
                                    seg_len=seg)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)


def test_beam_seg_len_is_exact():
    _, tp = _weights("test-tiny-opt")
    pre = torch.as_tensor(_prefix("test-tiny-opt", seed=4))
    cfg = TO.OPT_CONFIGS["test-tiny-opt"]
    outs = [TO.beam_generate(tp, cfg, pre, num_beams=4, max_new_tokens=11, seg_len=s) for s in (None, 0, 3, 16)]
    for seqs, scores in outs[1:]:
        assert torch.equal(seqs, outs[0][0])
        torch.testing.assert_close(scores, outs[0][1], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="seg_len"):
        TO.beam_generate(tp, cfg, pre, seg_len=-1)


@pytest.mark.parametrize("min_length", [0, 3])
def test_beam_eos_and_min_length_match_jax(min_length):
    """EOS set to the token the best beam repeats: without a minimum length
    it ends there at once and, finished, extends with pads only (its -1e9
    candidates exact ties in fp32, ordered as ``lax.top_k`` orders them);
    with ``min_length`` 3 no EOS comes before position 3. Equal to JAX."""
    name = "test-tiny-opt"
    jp, tp = _weights(name)
    cfg = TO.OPT_CONFIGS[name]
    pre = _prefix(name, seed=5)
    free, _ = TO.beam_generate(tp, cfg, torch.as_tensor(pre), num_beams=3, max_new_tokens=2)
    eos = int(free[0, 0, 0])
    seqs, scores = TO.beam_generate(tp, cfg, torch.as_tensor(pre), num_beams=3, max_new_tokens=8,
                                    min_length=min_length, eos_id=eos)
    want_seqs, want_scores = _jax_beam(name, 3, None, 8, min_length, eos)(jp, prefix_embeds=jnp.asarray(pre))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)
    s = seqs.numpy()
    assert (s[..., :min_length] != eos).all()
    ended = s == eos
    assert ended.any() == (min_length == 0)
    for row, e in zip(s.reshape(-1, 8), ended.reshape(-1, 8)):
        if e.any():
            assert (row[int(np.argmax(e)) + 1:] == cfg.pad_token_id).all()


def test_top_p_mask_matches_jax():
    """``top_p_mask`` against ``sample_top_p``'s filter (`rlcf_tpu/models/opt.py:526-534`) on the same logits
    (top_p below 1: at 1 the cut rests on the last bits of a cumulative sum that ends at 1 +- 4e-7)."""
    logits = np.random.default_rng(6).normal(size=(5, 256)).astype(np.float32) * 3
    for top_p, temp in ((0.92, 1.0), (0.5, 0.7), (1e-6, 1.0), (0.75, 1.5)):
        lg = jnp.asarray(logits) / temp
        sorted_logits = jnp.sort(lg, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jax.nn.softmax(sorted_logits, axis=-1), axis=-1)
        cutoff = jnp.take_along_axis(sorted_logits, jnp.sum(cum < top_p, axis=-1)[:, None], axis=-1)
        want = np.asarray(jnp.where(lg < cutoff, -1e9, lg))
        np.testing.assert_array_equal(TO.top_p_mask(torch.as_tensor(logits), top_p, temp).numpy(), want)


def test_nucleus_greedy_limit_matches_jax():
    """At a tiny top_p nucleus sampling keeps one token a step: JAX's greedy decode, draws or not."""
    name = "test-tiny-opt"
    jp, tp = _weights(name)
    pre = _prefix(name, seed=7)
    want = JO.nucleus_generate(jp, JO.OPT_CONFIGS[name], jnp.asarray(pre), jax.random.PRNGKey(0), num_captions=3,
                               max_new_tokens=6, top_p=1e-6)
    got = TO.nucleus_generate(tp, TO.OPT_CONFIGS[name], torch.as_tensor(pre), torch.Generator().manual_seed(0),
                              num_captions=3, max_new_tokens=6, top_p=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sampled = TO.nucleus_generate(tp, TO.OPT_CONFIGS[name], torch.as_tensor(pre), torch.Generator().manual_seed(0),
                                  num_captions=3, max_new_tokens=6)
    assert sampled.shape == (2, 3, 6) and int(sampled.max()) < 256


@pytest.mark.parametrize("name", CONFIGS)
def test_int8_weights_match_jax(name):
    """``quantize_opt_params``: q8 and sc bit for bit, the dequantized forward within 1e-5."""
    jp, tp = _weights(name)
    jq = JO.quantize_opt_params(jp)
    tq = TO.quantize_opt_params(tp)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jq)[0], _leaves_by_path(tq, jq)):
        assert got.dtype == (torch.int8 if np.asarray(want).dtype == np.int8 else torch.float32), path
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(path))
    pre = _prefix(name)
    toks = np.random.default_rng(8).integers(0, 256, size=(2, 4)).astype(np.int32)
    want = np.asarray(JO.forward(jq, JO.OPT_CONFIGS[name], jnp.asarray(toks), jnp.asarray(pre)))
    got = TO.forward(tq, TO.OPT_CONFIGS[name], torch.as_tensor(toks).long(), torch.as_tensor(pre)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _leaves_by_path(tree, jax_tree):
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = tree
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        out.append(t)
    return out


@pytest.mark.parametrize("proj,final_ln", [(False, True), (True, False), (False, False)])
def test_opt_state_dict_converters_agree(proj, final_ln):
    """One HF-format state dict (pre-LN, OPT-350m's projection and post-LN,
    HF's removed final LN) through both packages' converters: equal."""
    sd = hf_opt_state_dict(proj, final_ln)
    jp, jcfg = JO.convert_opt_state_dict(sd, n_heads=2)
    tp, tcfg = TO.convert_opt_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, n_heads=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0], _leaves_by_path(tp, jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(path))
    with pytest.raises(ValueError, match="n_heads"):
        TO.convert_opt_state_dict(sd)


@pytest.mark.parametrize("kind", ["mlp", "transformer"])
def test_mapper_state_dict_converters_agree(kind):
    kw = dict(clip_dim=16, llm_dim=24, prefix_length=5, clip_length=3, num_layers=2)
    jcfg, tcfg = JM.MapperConfig(kind, **kw), TM.MapperConfig(kind, **kw)
    sd = hf_mapper_state_dict(jcfg)
    jp = JM.convert_mapper_state_dict(sd, jcfg)
    tp = TM.convert_mapper_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0], _leaves_by_path(tp, jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(path))
