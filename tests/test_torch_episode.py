"""The port's losses, selection, reward scoring, prompt state and optimizer
against ``rlcf_tpu``'s on the same numpy inputs (fp32; tolerance 1e-6
relative for the losses, 1e-6 absolute for three AdamW steps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlcf_tpu.core import episode as JE
from rlcf_tpu.core import losses as JL
from rlcf_tpu.core import prompt as JP
from rlcf_tpu.core import reward as JR
from rlcf_tpu.models import clip as JC
from rlcf_torch.core import episode as TE
from rlcf_torch.core import losses as TL
from rlcf_torch.core import prompt as TP
from rlcf_torch.core import reward as TR
from rlcf_torch.models import convert as TV

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

TOL = dict(rtol=1e-5, atol=1e-6)
R = np.random.default_rng(0)
LOGITS = (R.normal(size=(6, 10)) * 3).astype(np.float32)
TEACHER = (R.normal(size=(6, 10)) * 3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["entropy_per_sample", "avg_entropy", "kd_loss", "atkd_loss", "dkd_loss"])
def test_losses_match_jax(name):
    if name in ("entropy_per_sample", "avg_entropy"):
        want, got = getattr(JL, name)(jnp.asarray(LOGITS)), getattr(TL, name)(_t(LOGITS))
    elif name == "dkd_loss":
        target = TEACHER.argmax(-1)
        want = JL.dkd_loss(jnp.asarray(LOGITS), jnp.asarray(TEACHER), jnp.asarray(target))
        got = TL.dkd_loss(_t(LOGITS), _t(TEACHER), _t(target))
    else:
        want = getattr(JL, name)(jnp.asarray(LOGITS), jnp.asarray(TEACHER))
        got = getattr(TL, name)(_t(LOGITS), _t(TEACHER))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batched_losses_equal_per_episode():
    """A leading episode axis gives each episode's own loss."""
    stacked = np.stack([LOGITS, TEACHER])
    for fn in (TL.avg_entropy, lambda x: TL.kd_loss(x, x.flip(-1)), lambda x: TL.atkd_loss(x, x.flip(-1))):
        got = fn(_t(stacked))
        np.testing.assert_allclose(got.numpy(), [fn(_t(LOGITS)).item(), fn(_t(TEACHER)).item()], rtol=1e-6)


def test_select_confident_entropy_ties_ascending():
    ent = np.array([[0.5, 0.1, 0.1, 0.3, 0.1, 0.2]], np.float32)
    want = np.asarray(JL.select_confident_entropy(jnp.asarray(ent), 4))
    got = TL.select_confident_entropy(_t(ent), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 2, 4, 5]])
    ent_b = np.random.default_rng(1).integers(0, 3, size=(4, 64)).astype(np.float32)
    np.testing.assert_array_equal(TL.select_confident_entropy(_t(ent_b), 6).numpy(),
                                  np.asarray(JL.select_confident_entropy(jnp.asarray(ent_b), 6)))


@pytest.mark.parametrize("process_batch,amplify", [(False, False), (True, False), (False, True)])
def test_reinforce_with_reward_scoring(process_batch, amplify):
    rcfg = dict(sample_k=3, process_batch=process_batch, amplify=amplify)
    jr = JR.ClipReward(None, None, JR.RewardConfig(**rcfg))
    tr = TR.ClipReward({"logit_scale": torch.zeros(())}, None, TR.RewardConfig(**rcfg))
    sim = np.random.default_rng(2).uniform(-0.2, 0.5, size=(6, 10)).astype(np.float32)
    idx = np.asarray(jax.lax.top_k(jnp.asarray(LOGITS), 3)[1])
    np.testing.assert_array_equal(TL.top_k_indices(_t(LOGITS), 3).numpy(), idx)
    rw_j = jr.score_samples(jnp.asarray(sim), jnp.asarray(idx))
    rw_t = tr.score_samples(_t(sim), _t(idx.astype(np.int64)))
    np.testing.assert_allclose(rw_t.numpy(), np.asarray(rw_j), **TOL)
    want = JL.reinforce_loss(jnp.asarray(LOGITS), jnp.asarray(idx), rw_j)
    got = TL.reinforce_loss(_t(LOGITS), _t(idx.astype(np.int64)), rw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("loss", ["rlcf", "tpt", "kd", "dkd", "atkd"])
def test_step_loss_matches_jax(loss):
    ecfg_j = JE.EpisodeConfig(loss=loss, sample_k=3)
    ecfg_t = TE.EpisodeConfig(**dataclasses.asdict(ecfg_j))
    jr = JR.ClipReward(None, None, JR.RewardConfig(sample_k=3))
    tr = TR.ClipReward({"logit_scale": torch.zeros(())}, None, TR.RewardConfig(sample_k=3))
    sim = np.random.default_rng(3).uniform(-0.2, 0.5, size=(6, 10)).astype(np.float32)
    want = JE.step_loss(jnp.asarray(LOGITS), jnp.asarray(sim), ecfg_j, jr.score_samples, 50.0)
    got = TE.step_loss(_t(LOGITS), _t(sim), ecfg_t, tr.score_samples, 50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_three_adamw_steps_match_optax():
    """torch.optim.AdamW on one [N, ...] tensor with the summed loss ==
    N independent optax.adamw episodes."""
    ecfg = TE.EpisodeConfig(lr=7e-3, weight_decay=5e-4)
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(3, 4, 8)).astype(np.float32)
    targets = rng.normal(size=(3, 4, 8)).astype(np.float32)
    loss_j = lambda x, t: jnp.sum((x - t) ** 3 * jnp.sin(x))
    opt = JE.make_optimizer(JE.EpisodeConfig(lr=7e-3, weight_decay=5e-4))
    want = []
    for n in range(3):
        x, s = jnp.asarray(x0[n]), None
        s = opt.init(x)
        for _ in range(3):
            g = jax.grad(loss_j)(x, jnp.asarray(targets[n]))
            u, s = opt.update(g, s, x)
            x = optax.apply_updates(x, u)
        want.append(np.asarray(x))
    x = _t(x0).clone().requires_grad_(True)
    topt = TE.make_optimizer([x], ecfg)
    for _ in range(3):
        topt.zero_grad()
        per_ep = ((x - _t(targets)) ** 3 * torch.sin(x)).sum(dim=(1, 2))
        per_ep.sum().backward()
        topt.step()
    np.testing.assert_allclose(x.detach().numpy(), np.stack(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_functional_adamw_step_matches_optax(weight_decay):
    """``adamw_step`` (the prompt episodes', Bongard's and the runner's
    AdamW) on one [N, ...] tensor, three steps == N independent optax.adamw
    episodes, within float32 roundings of optax's own arithmetic."""
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(3, 4, 8)).astype(np.float32)
    targets = rng.normal(size=(3, 4, 8)).astype(np.float32)
    loss_j = lambda x, t: jnp.sum((x - t) ** 3 * jnp.sin(x))
    opt = optax.adamw(7e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    want = []
    for n in range(3):
        x = jnp.asarray(x0[n])
        s = opt.init(x)
        for _ in range(3):
            u, s = opt.update(jax.grad(loss_j)(x, jnp.asarray(targets[n])), s, x)
            x = optax.apply_updates(x, u)
        want.append(np.asarray(x))
    x, state = _t(x0), TE.adamw_init([_t(x0)])
    for step in (1, 2, 3):
        xg = x.clone().requires_grad_(True)
        g, = torch.autograd.grad(((xg - _t(targets)) ** 3 * torch.sin(xg)).sum(), xg)
        (x,), state = TE.adamw_step([x], [g], state, step, 7e-3, weight_decay)
    np.testing.assert_allclose(x.numpy(), np.stack(want), rtol=1e-6, atol=1e-7)


def test_prompt_state_and_splice_match_jax():
    jcfg, tcfg = tiny_cfgs()
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    tp = TV.from_jax_params(jax_params_numpy(jp), tcfg)
    names = ["goldfish", "tiger_cat", "a very long class name with many words"]
    js = JP.build_prompt_state(jp, names, ctx_init="a_photo_of_a")
    ts = TP.build_prompt_state(tp, names, ctx_init="a_photo_of_a")
    np.testing.assert_array_equal(ts.tokenized, js.tokenized)
    np.testing.assert_array_equal(ts.ctx_map.numpy(), np.asarray(js.ctx_map))
    np.testing.assert_array_equal(ts.eot_idx.numpy(), np.asarray(js.eot_idx))
    np.testing.assert_array_equal(ts.ctx0.numpy(), np.asarray(js.ctx0))
    np.testing.assert_array_equal(ts.fixed_embed.numpy(), np.asarray(js.fixed_embed))
    ctx = np.random.default_rng(5).normal(size=(2,) + tuple(js.ctx0.shape)).astype(np.float32)
    got = TP.splice_arrays(_t(ctx), ts.fixed_embed, ts.ctx_map)
    for n in range(2):
        want = JP.splice_arrays(jnp.asarray(ctx[n]), js.fixed_embed, js.ctx_map)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want))
