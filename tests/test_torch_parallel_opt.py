"""The Megatron split of the OPT decode (``rlcf_torch/parallel/tp_opt.py``)
and caption TTA on a (dp, tp) mesh, on the CPU over gloo, ranks launched by
``torch_parallel_workers.launch``, against the JAX package's unsharded runs
on the same weights and inputs (``tests/test_parallel.py`` holds those equal
to JAX's mesh runs, ``test_tp_opt_decode_*``): the tp forward within 1e-4 +
1e-5, beams and captions equal (ROADMAP's beam-tie rule: a sequence may
differ only where its two candidates' scores lie within 1e-5), plain and
int8, with the projections of OPT-350m; nucleus sampling against the port's
one-process run (the JAX package's draws are not the port's)."""

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

from torch_parallel_workers import launch
from torch_port_fixtures import chip_smoke

MODELS = {"plain": ("test-tiny-opt", False), "int8 350m": ("test-tiny-opt-350m", True)}


def _weights(name):
    tree = jax.tree_util.tree_map(np.asarray, JO.init_opt_params(jax.random.PRNGKey(0), JO.OPT_CONFIGS[name]))
    tree["embed_tokens"] = tree["embed_tokens"] * 5.0   # peaked distributions: the beams rank clearly apart
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_opt_params(tree)


@pytest.fixture(scope="module")
def opt_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    models, jax_models, prefix, tokens = {}, {}, {}, {}
    for key, (name, int8) in MODELS.items():
        jp, tp = _weights(name)
        if int8:
            jp, tp = JO.quantize_opt_params(jp), TO.quantize_opt_params(tp)
        models[key], jax_models[key] = (tp, TO.OPT_CONFIGS[name]), (jp, JO.OPT_CONFIGS[name])
        prefix[key] = (rng.normal(size=(2, 4, TO.OPT_CONFIGS[name].embed_dim)) * 0.1).astype(np.float32)
        tokens[key] = np.array([[5, 9, 100], [7, 30, 11]], dtype=np.int64)
    run = launch(tmp_path_factory.mktemp("opt"), 2, "opt", {"models": models, "prefix": prefix, "tokens": tokens})
    return models, jax_models, prefix, tokens, run


@pytest.mark.parametrize("key", sorted(MODELS))
def test_tp_opt_forward_matches_jax(opt_run, key):
    models, jax_models, prefix, tokens, run = opt_run
    jp, jcfg = jax_models[key]
    want = JO.forward(jp, jcfg, tokens=tokens[key].astype(np.int32), prefix_embeds=jnp.asarray(prefix[key]))
    np.testing.assert_allclose(run[key]["forward"].numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    cfg = models[key][1]
    assert tuple(run[key]["local_q"]) == (cfg.n_layers, cfg.hidden, cfg.hidden // 2)   # heads split over tp = 2


@pytest.mark.parametrize("key", sorted(MODELS))
def test_tp_opt_beam_matches_jax(opt_run, key):
    _, jax_models, prefix, _, run = opt_run
    jp, jcfg = jax_models[key]
    seqs, scores = JO.beam_generate(jp, jcfg, jnp.asarray(prefix[key]), num_beams=3, max_new_tokens=6, num_return=3)
    got_seqs, got_scores = run[key]["beam"]
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(scores), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_tp_opt_nucleus_matches_one_process(opt_run, key):
    models, _, prefix, _, run = opt_run
    params, cfg = models[key]
    want = TO.nucleus_generate(params, cfg, torch.as_tensor(prefix[key]), torch.Generator().manual_seed(3),
                               num_captions=2, max_new_tokens=5)
    assert torch.equal(run[key]["nucleus"], want)


def test_nucleus_rows_draw_the_whole_group():
    """A slice of the group (``rows``) samples what the whole group's run
    samples for those rows."""
    _, params = _weights("test-tiny-opt")
    cfg = TO.OPT_CONFIGS["test-tiny-opt"]
    prefix = torch.as_tensor(np.random.default_rng(4).normal(size=(4, 3, cfg.embed_dim)).astype(np.float32))
    whole = TO.nucleus_generate(params, cfg, prefix, torch.Generator().manual_seed(9), num_captions=2,
                                max_new_tokens=5, top_p=0.9)
    part = TO.nucleus_generate(params, cfg, prefix[2:], torch.Generator().manual_seed(9), num_captions=2,
                               max_new_tokens=5, top_p=0.9, rows=(4, 8))
    assert torch.equal(part, whole[2:])


# -- caption TTA at dp 2 x tp 2 ------------------------------------------------

MAPPER = dict(clip_dim=16, llm_dim=32, prefix_length=4, clip_length=2, num_layers=1, n_heads=2)
TTA = dict(tta_steps=2, lr=1e-2, sample_k=3, max_new_tokens=6, token_pad_len=40)
RUNS = {"beam": {}, "momentum": dict(momentum_update=True, update_freq=1, momentum=0.5),
        "nucleus": dict(use_nucleus=True, seed=5)}


@pytest.fixture(scope="module")
def caption_run(tmp_path_factory):
    vocab = chip_smoke.write_opt_vocab(str(tmp_path_factory.mktemp("vocab")), size=600, newline_id=None)
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
    rng = np.random.default_rng(0)
    images, embs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32), rng.normal(size=(4, 16)).astype(np.float32)
    tok = Gpt2Tokenizer(*vocab)
    payload = dict(params=tparams, ccfg=tccfg, rparams=from_jax_params(rtree, trc), rcfg=trc, tok=tok,
                   images=images, embs=embs, dp=2, tp=2, runs={k: {**TTA, **kw} for k, kw in RUNS.items()})
    run = launch(tmp_path_factory.mktemp("caption"), 4, "caption", payload)
    jax_side = (jax.tree_util.tree_map(jnp.asarray, tree), jccfg,
                JReward(jax.tree_util.tree_map(jnp.asarray, rtree), jrc, JRewardConfig(sample_k=2, process_batch=True)),
                JTok(*vocab))
    return payload, jax_side, run


@pytest.mark.parametrize("name", ["beam", "momentum"])
def test_caption_tta_on_mesh_matches_jax(caption_run, name):
    """Two groups of 4 images at dp 2 x tp 2: each step's sampled captions
    equal and rewards within 2e-4, the final captions equal; with the
    momentum anchor (re-anchored after every image) the anchors agree."""
    payload, (jparams, jccfg, jreward, jtok), run = caption_run
    jt = JCap.CaptionTTA(jparams, jccfg, jreward, jtok, **TTA, **RUNS[name])
    got, jtrace = run[name], []
    for caps in got["captions"]:
        assert caps == jt.adapt_batch(payload["images"], payload["embs"], trace=jtrace)
    steps = got["trace"]
    assert [[t for t, _ in s] for s in steps] == [[t for t, _ in s] for s in jtrace]
    np.testing.assert_allclose([r for s in steps for _, r in s], [r for s in jtrace for _, r in s],
                               rtol=2e-4, atol=2e-4)
    if name == "momentum":
        for (path, w), leaf in zip(jax.tree_util.tree_flatten_with_path(jt.momentum_state.reset_params)[0],
                                   Po.tree_leaves(got["reset"])):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_caption_tta_nucleus_on_mesh_matches_one_process(caption_run):
    """Nucleus draws: every rank draws the whole group's and keeps its rows."""
    payload, _, run = caption_run
    reward = ClipReward(payload["rparams"], payload["rcfg"], RewardConfig(sample_k=2, process_batch=True))
    tt = Cap.CaptionTTA(payload["params"], payload["ccfg"], reward, payload["tok"], **payload["runs"]["nucleus"])
    trace = []
    want = [tt.adapt_batch(payload["images"], payload["embs"], trace=trace) for _ in range(2)]
    assert run["nucleus"]["captions"] == want
    assert [[t for t, _ in s] for s in run["nucleus"]["trace"]] == [[t for t, _ in s] for s in trace]


def test_caption_nucleus_slice_finishing_first_matches_one_process(caption_run, tmp_path):
    """Nucleus caption TTA at dp 2 where rank 0's images all take EOS as
    their second token and rank 1's run on: the whole group's run draws
    until its last row finishes, so rank 0 draws the steps it no longer
    needs and its next step samples what one process samples."""
    payload, _, _ = caption_run
    embs = payload["embs"].copy()
    embs[:2, 0] = 100.0   # rank 0's two images carry the mark of torch_parallel_workers.force_early_eos
    eos = dict(payload, embs=embs, kw=payload["runs"]["nucleus"])
    run = launch(tmp_path, 2, "caption_eos", {k: eos[k] for k in
                                               ("params", "ccfg", "rparams", "rcfg", "tok", "images", "embs", "kw")})
    one, sharded = run["one"], run["sharded"]
    K = payload["runs"]["nucleus"]["sample_k"]
    for call in one["lengths"]:   # rank 0's rows end at their second token; rank 1's run on
        assert max(call[:2 * K]) == 2 and max(call[2 * K:]) > 2
    assert len(one["lengths"]) == 2 * payload["runs"]["nucleus"]["tta_steps"]
    assert sharded["captions"] == one["captions"]
    assert [[t for t, _ in s] for s in sharded["trace"]] == [[t for t, _ in s] for s in one["trace"]]
    np.testing.assert_allclose([r for s in sharded["trace"] for _, r in s], [r for s in one["trace"] for _, r in s],
                               rtol=2e-4, atol=2e-4)
