"""The port's GPT-2 ClipCap backend (``rlcf_torch/models/gpt2.py``) against the
JAX package's on the same weights (``from_jax_gpt2_params``) and inputs, on
``test-tiny-gpt2``: teacher-forcing logits (fp32, 1e-5), the cached decode
against the full forward, the ClipCap beam search and greedy loop (tokens,
lengths and order equal, beams that stop included), the HF state-dict
converter, and ``clipcap_predict``'s captions (equal strings)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.models import gpt2 as JG
from rlcf_tpu.models import mappers as JM
from rlcf_tpu.tasks import caption as JCap
from rlcf_tpu.tokenizer_gpt2 import Gpt2Tokenizer as JTok
from rlcf_torch.models import gpt2 as TG
from rlcf_torch.models import mappers as TM
from rlcf_torch.models.convert import from_jax_gpt2_params, from_jax_mapper_params
from rlcf_torch.tasks import caption as Cap
from rlcf_torch.tokenizer_gpt2 import Gpt2Tokenizer
from torch_port_fixtures import chip_smoke
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "test-tiny-gpt2"
JCFG, TCFG = JG.GPT2_CONFIGS[NAME], TG.GPT2_CONFIGS[NAME]
STOP = 7


@functools.lru_cache()
def _weights(stop_prone=False):
    """(JAX params, the port's) of the tiny GPT-2: the token table scaled up
    5x, so that the distributions are peaked (the beams rank clearly apart);
    or, ``stop_prone``, as drawn but token 7's row 6x, so that beams write
    token 7 (the stop token of the beam tests that stop) along the way."""
    tree = jax.tree_util.tree_map(np.array, JG.init_gpt2_params(jax.random.PRNGKey(0), JCFG))
    if stop_prone:
        tree["wte"][STOP] *= 6.0
    else:
        tree["wte"] = tree["wte"] * 5.0
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_gpt2_params(tree)


def _prefix(P=3, seed=0, B=None):
    shape = (P, JCFG.n_embd) if B is None else (B, P, JCFG.n_embd)
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


@functools.lru_cache()
def _jax_beam(stop, beam, steps, temperature=1.0):
    return jax.jit(functools.partial(JG.clipcap_beam_generate, cfg=JCFG, stop_token=stop, beam_size=beam,
                                     entry_length=steps, temperature=temperature))


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    """Tokens after prefix embeddings, ids past the vocabulary (96, 99: JAX's
    gather clamps them, the port too), with and without a padding mask."""
    jp, tp = _weights()
    rng = np.random.default_rng(1)
    pre = _prefix(B=2)
    toks = rng.integers(0, 100, size=(2, 6)).astype(np.int32)
    toks[0, :2] = (96, 99)
    mask = np.ones((2, 9), np.float32)
    mask[1, -2:] = 0
    m = mask if masked else None
    want = np.asarray(JG.forward(jp, JCFG, tokens=jnp.asarray(toks), prefix_embeds=jnp.asarray(pre),
                                 attention_mask=None if m is None else jnp.asarray(m)))
    got = TG.forward(tp, TCFG, tokens=torch.as_tensor(toks).long(), prefix_embeds=torch.as_tensor(pre),
                     attention_mask=None if m is None else torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_steps_match_the_full_forward_and_jax():
    """Prefill + cached decode steps give the full forward's last-position
    logits, and JAX's static-cache steps' logits."""
    jp, tp = _weights()
    pre = _prefix(B=2, seed=2)
    toks = np.random.default_rng(2).integers(0, 96, size=(2, 4))
    logits, cache = TG._prefill(tp, TCFG, torch.as_tensor(pre), max_len=3 + 4)
    jlogits, jcache = JG._prefill(jp, JCFG, jnp.asarray(pre), max_len=3 + 4)
    for i in range(5):
        full = TG.forward(tp, TCFG, tokens=torch.as_tensor(toks[:, :i]).long() if i else None,
                          prefix_embeds=torch.as_tensor(pre))[:, -1]
        torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
        if i < 4:
            logits = TG._decode_step(tp, TCFG, cache, tp["wte"][torch.as_tensor(toks[:, i])][:, None, :])
            jlogits, jcache = JG._decode_step(jp, JCFG, jcache, jp["wte"][jnp.asarray(toks[:, i])][:, None, :])


def _beam_pair(jp, tp, pre, stop, beam, steps, temperature):
    want = _jax_beam(stop, beam, steps, temperature)(jp, prefix_embeds=jnp.asarray(pre))
    got = TG.clipcap_beam_generate(tp, TCFG, torch.as_tensor(pre), stop, beam_size=beam, entry_length=steps,
                                   temperature=temperature)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("beam,steps,seed,temperature", [(5, 12, 3, 1.0), (3, 10, 4, 1.0), (4, 9, 5, 0.7),
                                                          (2, 66, 6, 1.0)])
def test_beam_matches_jax(beam, steps, seed, temperature):
    """Tokens, lengths and order equal to the JAX package's, no beam
    stopping; at 3 + 66 positions the decode runs past the tiny table's 64
    (the last row, as JAX's dynamic slice clamps)."""
    jp, tp = _weights()
    _, lengths, _ = _beam_pair(jp, tp, _prefix(seed=seed), JCFG.vocab_size + 1, beam, steps, temperature)
    assert (lengths == steps).all()


@pytest.mark.parametrize("beam,steps,seed", [(5, 12, 3), (3, 10, 4)])
def test_beam_with_stopped_beams_matches_jax(beam, steps, seed):
    """Beams that write the stop token freeze (their score through column 0,
    their other candidates exact -1e9 ties); tokens, lengths and order equal
    JAX's: at 5 beams every beam stops and the search ends early, at 3 a
    stopped beam ranks among running ones."""
    jp, tp = _weights(stop_prone=True)
    tokens, lengths, _ = _beam_pair(jp, tp, _prefix(seed=seed), STOP, beam, steps, 1.0)
    assert (tokens == STOP).any() and (lengths < steps).all() if beam == 5 else \
        (lengths < steps).any() and (lengths == steps).any()


def test_top_p_matches_jax_and_writes_the_stop_token():
    """The greedy loop's tokens and length equal JAX's, free and with a stop
    token it writes (the stop token counted in the length)."""
    jp, tp = _weights()
    pre = _prefix(seed=6)
    run_j = lambda stop: [np.asarray(a) for a in JG.clipcap_top_p_generate(
        jp, JCFG, jnp.asarray(pre), stop, entry_length=10, alt_stop_token=JCFG.vocab_size + 2)]
    run_t = lambda stop: TG.clipcap_top_p_generate(tp, TCFG, torch.as_tensor(pre), stop, entry_length=10,
                                                   alt_stop_token=JCFG.vocab_size + 2)
    free_j, free_t = run_j(JCFG.vocab_size + 1), run_t(JCFG.vocab_size + 1)
    np.testing.assert_array_equal(free_t[0].numpy(), free_j[0])
    assert free_t[1] == int(free_j[1]) == 10
    stop = int(free_j[0][3])
    j = list(free_j[0]).index(stop)
    (tj, lj), (tt, lt) = run_j(stop), run_t(stop)
    np.testing.assert_array_equal(tt.numpy(), tj)
    assert lt == int(lj) == j + 1 and int(tt[lt - 1]) == stop


def test_alt_stop_token_ends_the_greedy_loop():
    """Token 764 (GPT-2's ' .') ends it too, as in JAX: here with a vocabulary that holds it."""
    jtree = jax.tree_util.tree_map(np.array, JG.init_gpt2_params(
        jax.random.PRNGKey(1), JG.GPT2Config("v800", vocab_size=800, n_positions=32, n_embd=32, n_layer=1, n_head=2)))
    jtree["wte"][764] *= 40.0   # the most likely next token everywhere
    tcfg = TG.GPT2Config("v800", vocab_size=800, n_positions=32, n_embd=32, n_layer=1, n_head=2)
    jcfg = JG.GPT2Config("v800", vocab_size=800, n_positions=32, n_embd=32, n_layer=1, n_head=2)
    pre = np.random.default_rng(7).normal(size=(2, 32)).astype(np.float32)
    tj, lj = JG.clipcap_top_p_generate(jax.tree_util.tree_map(jnp.asarray, jtree), jcfg, jnp.asarray(pre), 801,
                                       entry_length=8)
    tt, lt = TG.clipcap_top_p_generate(from_jax_gpt2_params(jtree), tcfg, torch.as_tensor(pre), 801, entry_length=8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert lt == int(lj) and lt < 8 and int(tt[lt - 1]) == 764


def test_state_dict_converter_matches_jax():
    """An HF ``GPT2LMHeadModel`` state dict (random, built by transformers)
    converts to the same leaves and config in both packages."""
    from transformers import GPT2Config as HFConfig, GPT2LMHeadModel

    torch.manual_seed(0)
    model = GPT2LMHeadModel(HFConfig(vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2)).eval()
    sd = model.state_dict()
    jparams, jcfg = JG.convert_gpt2_state_dict({k: v.numpy() for k, v in sd.items()}, n_head=2)
    tparams, tcfg = TG.convert_gpt2_state_dict(sd, n_head=2)
    assert (tcfg.vocab_size, tcfg.n_positions, tcfg.n_embd, tcfg.n_layer, tcfg.n_head) == \
        (jcfg.vocab_size, jcfg.n_positions, jcfg.n_embd, jcfg.n_layer, jcfg.n_head)
    for path, w in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        t = tparams
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=str(path))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 96, size=(2, 7)))
    with torch.no_grad():
        ref = model(tokens).logits
    torch.testing.assert_close(TG.forward(tparams, tcfg, tokens=tokens), ref, rtol=1e-4, atol=2e-4)
    assert TG.convert_gpt2_state_dict({k[len("transformer."):]: v for k, v in sd.items()
                                       if k.startswith("transformer.")})[1].n_head == 1   # 32 // 64, at least 1


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """A synthetic GPT-2-layout vocabulary: ids 0..255 the byte symbols (``.`` at 13), words after."""
    return chip_smoke.write_gpt2_vocab(str(tmp_path_factory.mktemp("gpt2vocab")), size=600)


@pytest.mark.parametrize("use_beam", [True, False])
def test_clipcap_predict_matches_jax(vocab, use_beam):
    """CLIP embeddings -> mapper prefix -> GPT-2 captions: the same strings
    as the JAX package's, by beam search and by the greedy loop."""
    jp, tp = _weights()
    mkw = dict(clip_dim=16, llm_dim=32, prefix_length=3, clip_length=3)
    jccfg = JCap.CaptionModelConfig(mapper=JM.MapperConfig("mlp", **mkw), llm="gpt2", gpt2=JCFG)
    tccfg = Cap.CaptionModelConfig(mapper=TM.MapperConfig("mlp", **mkw), llm="gpt2", gpt2=TCFG)
    mapper = jax.tree_util.tree_map(np.asarray, JM.init_mapper_params(jax.random.PRNGKey(3), jccfg.mapper))
    embs = np.random.default_rng(8).normal(size=(3, 16)).astype(np.float32)
    kw = dict(use_beam=use_beam, beam_size=3, entry_length=12)
    want = JCap.clipcap_predict({"mapper": jax.tree_util.tree_map(jnp.asarray, mapper), "gpt2": jp}, jccfg, embs,
                                JTok(*vocab, bos_id=599, pad_id=599), **kw)
    got = Cap.clipcap_predict({"mapper": from_jax_mapper_params(mapper), "gpt2": tp}, tccfg, embs,
                              Gpt2Tokenizer(*vocab, bos_id=599, pad_id=599), **kw)
    assert got == want and all(isinstance(c, str) and c for c in got)
    with pytest.raises(ValueError, match="llm='gpt2'"):
        Cap.clipcap_predict({"mapper": None}, Cap.CaptionModelConfig(mapper=tccfg.mapper), embs, None)
