"""The port's caption trainer and feature extraction (``rlcf_torch/tasks/caption.py``)
against the JAX package's on the same weights and inputs: the learning-rate
schedule at every step (equal), four AdamW steps of the mapper (mlp and
transformer, ClipCap and CapDec fed JAX's own noise draws, OPT and GPT-2;
losses within rtol 1e-5, leaves within 3e-5), the epoch loop's losses and
checkpoints read across the packages, ``extract_clip_features`` (fp32, 1e-5),
and the GPT-2 backend's place in the model (``CaptionTTA`` refuses it as JAX does)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_tpu.models import gpt2 as JG
from rlcf_tpu.models import mappers as JM
from rlcf_tpu.models import opt as JO
from rlcf_tpu.tasks import caption as JCap
from rlcf_torch.core import policy as Po
from rlcf_torch.models import gpt2 as TG
from rlcf_torch.models import mappers as TM
from rlcf_torch.models import opt as TO
from rlcf_torch.models.convert import from_jax_gpt2_params, from_jax_mapper_params, from_jax_opt_params, from_jax_params
from rlcf_torch.tasks import caption as Cap
from torch_port_fixtures import jax_params_numpy, tiny_cfgs
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MAPPER = dict(clip_dim=16, prefix_length=4, clip_length=2, num_layers=1, n_heads=2)
B, L = 4, 6


def _jax_lr_fn(tcfg):
    """The schedule the JAX package's trainer hands to ``optax.adamw``."""
    seen = {}
    real = optax.adamw

    def spy(learning_rate, **kw):
        seen["lr_fn"] = learning_rate
        return real(learning_rate, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adamw", spy)
        JCap.make_caption_trainer(JCap.CaptionModelConfig(mapper=JM.MapperConfig("mlp", **MAPPER, llm_dim=32),
                                                          opt=JO.OPT_CONFIGS["test-tiny-opt"]), tcfg)
    return seen["lr_fn"]


@pytest.mark.parametrize("lr,warmup,total", [(2e-5, 5000, 100_000), (1e-3, 5, 12), (3e-4, 0, 7), (1e-2, 20, 8)])
def test_lr_matches_jax_at_every_step(lr, warmup, total):
    """Equal at every step up to past the end (warm-up, decay, clamp at 0)."""
    kw = dict(lr=lr, warmup_steps=warmup, total_steps=total)
    lr_fn = _jax_lr_fn(JCap.TrainConfig(**kw))
    steps = list(range(0, total + 4)) if total < 1000 else list(range(0, 6000, 7)) + list(range(99_990, 100_004))
    want = [float(lr_fn(jnp.int32(s))) for s in steps]
    got = [Cap.train_lr(Cap.TrainConfig(**kw), s) for s in steps]
    assert got == want
    assert got[0] == 0.0 if warmup else got[0] == np.float32(lr)


def _models(kind, llm):
    """The same tiny caption model in both packages: (JAX config, params), (port config, params)."""
    if llm == "gpt2":
        jccfg = JCap.CaptionModelConfig(mapper=JM.MapperConfig(kind, **MAPPER, llm_dim=32), llm="gpt2",
                                        gpt2=JG.GPT2_CONFIGS["test-tiny-gpt2"])
        tccfg = Cap.CaptionModelConfig(mapper=TM.MapperConfig(kind, **MAPPER, llm_dim=32), llm="gpt2",
                                       gpt2=TG.GPT2_CONFIGS["test-tiny-gpt2"])
    else:
        jccfg = JCap.CaptionModelConfig(mapper=JM.MapperConfig(kind, **MAPPER, llm_dim=32),
                                        opt=JO.OPT_CONFIGS["test-tiny-opt"])
        tccfg = Cap.CaptionModelConfig(mapper=TM.MapperConfig(kind, **MAPPER, llm_dim=32),
                                       opt=TO.OPT_CONFIGS["test-tiny-opt"])
    tree = jax_params_numpy(JCap.init_caption_params(jax.random.PRNGKey(0), jccfg))
    convert = from_jax_gpt2_params if llm == "gpt2" else from_jax_opt_params
    tparams = {"mapper": from_jax_mapper_params(tree["mapper"]), llm: convert(tree[llm])}
    return (jccfg, jax.tree_util.tree_map(jnp.asarray, tree)), (tccfg, tparams)


def _batch(seed, V, pads=True):
    rng = np.random.default_rng(seed)
    prefix = rng.normal(size=(B, 16)).astype(np.float32)
    tokens = rng.integers(3, V, size=(B, L)).astype(np.int32)
    mask = np.ones((B, 4 + L), np.int32)
    if pads:   # OPT's pad (1) after short captions, and an ignored 0
        tokens[1, 4:], mask[1, 4 + 4:] = 1, 0
        tokens[2, 3] = 0
    return prefix, tokens, mask


def _assert_leaves_close(got, want_jax, atol=3e-5):
    for (path, w), leaf in zip(jax.tree_util.tree_flatten_with_path(want_jax)[0], Po.tree_leaves(got)):
        np.testing.assert_allclose(leaf.detach().cpu().numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("kind,cap_model,normalize,llm", [
    ("mlp", "ClipCap", False, "opt"), ("transformer", "CapDec", False, "opt"), ("mlp", "CapDec", True, "opt"),
    ("transformer", "ClipCap", True, "opt"), ("mlp", "ClipCap", False, "gpt2"), ("transformer", "CapDec", False,
                                                                                  "gpt2")])
def test_trainer_steps_match_optax(kind, cap_model, normalize, llm):
    """Four steps (warm-up 2 of 4: rates 0, lr/2, lr, lr/2) from the same
    mapper on the same batches, CapDec's noise JAX's own draws: each loss
    within rtol 1e-5, the mapper's leaves within 3e-5 after the four."""
    (jccfg, jparams), (tccfg, tparams) = _models(kind, llm)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=4, cap_model=cap_model, normalize_prefix=normalize)
    jopt, jstep = JCap.make_caption_trainer(jccfg, JCap.TrainConfig(**kw))
    init_opt, step = Cap.make_caption_trainer(tccfg, Cap.TrainConfig(**kw))
    jm, state = jparams["mapper"], jopt.init(jparams["mapper"])
    tm = Po.tree_map(lambda a: a.clone().requires_grad_(True), tparams["mapper"])
    opt = init_opt(tm)
    rng = jax.random.PRNGKey(5)
    V = 96 if llm == "gpt2" else 256
    for i in range(4):
        prefix, tokens, mask = _batch(i, V, pads=llm == "opt")
        rng, sub = jax.random.split(rng)
        noise = np.array(jax.random.normal(sub, prefix.shape, jnp.float32))
        jm, state, jloss = jstep(jm, jparams[llm], state, sub, jnp.asarray(prefix), jnp.asarray(tokens),
                                 jnp.asarray(mask))
        loss = step(tm, tparams[llm], opt, torch.as_tensor(prefix), torch.as_tensor(tokens).long(),
                    torch.as_tensor(mask).long(), torch.as_tensor(noise))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_leaves_close(tm, jm)
    assert opt.param_groups[0]["lr"] == Cap.train_lr(Cap.TrainConfig(**kw), 3)


def test_train_caption_model_matches_jax(tmp_path):
    """The epoch loop (ClipCap, 7 epochs of 2 steps): each epoch's mean loss
    within rtol 1e-5; the checkpoints of the last six epochs and
    ``ckpt-latest.npz`` written by both, each package's read by the other
    within 3e-5 of its own; resuming at epoch 5 trains the last two."""
    (jccfg, jparams), (tccfg, tparams) = _models("transformer", "opt")
    batches = [_batch(10 + i, 256) for i in range(2)]
    data = lambda: iter(batches)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=14, epochs=7, cap_model="ClipCap", normalize_prefix=True)
    jout, jlosses = JCap.train_caption_model(jparams, jccfg, JCap.TrainConfig(**kw), data,
                                             checkpoint_dir=str(tmp_path / "jax"))
    tout, tlosses = Cap.train_caption_model(tparams, tccfg, Cap.TrainConfig(**kw), data,
                                            checkpoint_dir=str(tmp_path / "port"))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["ckpt-001.npz", "ckpt-002.npz", "ckpt-003.npz",
                                                              "ckpt-004.npz", "ckpt-005.npz", "ckpt-006.npz",
                                                              "ckpt-latest.npz"]
    _assert_leaves_close(tout["mapper"], jout["mapper"])
    for name in names:
        got, epoch = Cap.load_mapper_checkpoint(str(tmp_path / "jax" / name), tparams["mapper"])
        want, jepoch = JCap.load_mapper_checkpoint(str(tmp_path / "port" / name), jparams["mapper"])
        assert epoch == jepoch == (6 if name == "ckpt-latest.npz" else int(name[5:8]))
        _assert_leaves_close(got, want)
    resumed, losses = Cap.train_caption_model(tout, tccfg, Cap.TrainConfig(**kw), data, start_epoch=5)
    _, jres = JCap.train_caption_model(jout, jccfg, JCap.TrainConfig(**kw), data, start_epoch=5)
    np.testing.assert_allclose(losses, jres, rtol=1e-5)
    assert len(losses) == 2


def test_capdec_noise_comes_from_the_generator():
    """The epoch loop draws CapDec's noise from the generator it is given:
    the same seed gives the same losses, another seed others."""
    (_, _), (tccfg, tparams) = _models("mlp", "opt")
    batches = [_batch(20, 256)]
    tcfg = Cap.TrainConfig(lr=1e-3, warmup_steps=0, total_steps=2, epochs=2, cap_model="CapDec")
    run = lambda seed: Cap.train_caption_model(tparams, tccfg, tcfg, lambda: iter(batches),
                                               generator=torch.Generator().manual_seed(seed))[1]
    assert run(1) == run(1) != run(2)
    assert run(0) == Cap.train_caption_model(tparams, tccfg, tcfg, lambda: iter(batches))[1]


def test_extract_clip_features_matches_jax():
    """Image embeddings of two batches and text embeddings of five captions
    in batches of 2, fp32: within 1e-5; float32 arrays."""
    jcfg, tcfg = tiny_cfgs()
    tree = jax_params_numpy(JC.init_clip_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(n, 32, 32, 3)).astype(np.float32) for n in (3, 2)]
    texts = ["a dog on a street", "two cats", "a red car parked near a tree", "", "a bowl of fruit"]
    want = JCap.extract_clip_features(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, images_iter=iter(images),
                                      texts=texts, batch_size=2)
    got = Cap.extract_clip_features(from_jax_params(tree, tcfg), tcfg, images_iter=iter(images), texts=texts,
                                    batch_size=2)
    assert sorted(got) == sorted(want) == ["image_embeddings", "text_embeddings"]
    for key in got:
        assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, atol=1e-5)


def test_gpt2_backend_initialises_and_caption_tta_refuses_it():
    """``llm="gpt2"`` builds and runs the model (it raised until the GPT-2
    backend was ported); ``CaptionTTA`` refuses it with JAX's ValueError."""
    (jccfg, jparams), (tccfg, _) = _models("mlp", "gpt2")
    params = Cap.init_caption_params(0, tccfg)
    assert sorted(params) == ["gpt2", "mapper"] and tccfg.llm_key == "gpt2"
    logits = Cap.caption_forward(params, tccfg, torch.randn(2, 16), torch.randint(0, 96, (2, 5)))
    assert logits.shape == (2, 4 + 5, 96) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError) as want:
        JCap.CaptionTTA(jparams, jccfg, reward=None, opt_tokenizer=None)
    with pytest.raises(ValueError) as got:
        Cap.CaptionTTA(params, tccfg, reward=None, opt_tokenizer=None)
    assert str(got.value) == str(want.value) and "clipcap_predict" in str(got.value)
