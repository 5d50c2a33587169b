"""The port's generic runner (``rlcf_torch/core/runner.py``) against the JAX
package's (``rlcf_tpu/core/runner.py``) on the CPU: the same steps under the
warm-up + cosine and the step schedules with a weight-decay split (the
parameters within rtol 1e-6), checkpoints in the JAX runner's names, and a
resume in either direction that equals the uninterrupted run."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlcf_tpu.core import runner as JR
from rlcf_torch.core import runner as TR

STEPS, EPOCHS = 4, 2


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32),
            "ln": {"g": (1 + 0.1 * rng.normal(size=(4,))).astype(np.float32)},
            "layers": [{"k": rng.normal(size=(4, 4)).astype(np.float32)}]}


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32))
            for _ in range(STEPS)]


def _cfg(tmp_path, sched, name):
    kw = dict(max_epoch=EPOCHS, steps_per_epoch=STEPS, init_lr=0.05, min_lr=1e-3, warmup_lr=1e-3, warmup_steps=3,
              weight_decay=0.1, lr_sched=sched, lr_decay_rate=0.5, output_dir=str(tmp_path / name))
    return JR.RunnerConfig(**kw), TR.RunnerConfig(**kw)


def _loss(xp, p, x, y):
    h = (x @ p["w"] + p["b"]) * p["ln"]["g"]
    return (((h + 0.1 * h * h) @ p["layers"][0]["k"] - y) ** 2).mean()   # no tanh: XLA's is an approximation


def _jax_runner(cfg):
    params = jax.tree_util.tree_map(jnp.asarray, _init())
    opt = JR.build_optimizer(cfg, params)

    @jax.jit
    def train_step(p, s, batch, rng):
        loss, g = jax.value_and_grad(lambda q: _loss(jnp, q, *batch))(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, {"loss": loss}

    return JR.Runner(cfg, params, train_step)


def _torch_runner(cfg, device="cpu"):
    params = TR.tree_map(lambda a: torch.from_numpy(a).to(device), _init())
    step = lambda p, batch, gen: _loss(torch, p, *(torch.from_numpy(b).to(device) for b in batch))
    return TR.Runner(cfg, params, step)


def _close(port, jax_params, rtol=1e-6):
    for name, t in TR._flatten(port).items():
        want = np.asarray(JR._flatten(jax_params)[name])
        np.testing.assert_allclose(t.detach().cpu().numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_decay_mask_and_schedules(tmp_path):
    params = {"w": torch.zeros(4, 4), "b": torch.zeros(4), "ln": {"g": torch.ones(4)}}
    assert TR.decay_mask(params) == {"w": True, "b": False, "ln": {"g": False}}
    for sched in ("linear_warmup_cosine_lr", "linear_warmup_step_lr"):
        jcfg, tcfg = _cfg(tmp_path, sched, "x")
        js, ts = JR.build_lr_schedule(jcfg), TR.build_lr_schedule(tcfg)
        for step in range(EPOCHS * STEPS + 2):   # float32 both: a few ulps apart where XLA's cos and numpy's differ
            assert abs(ts(step) - float(js(step))) <= 1e-6 * abs(float(js(step))), (sched, step)


@pytest.mark.parametrize("sched", ["linear_warmup_cosine_lr", "linear_warmup_step_lr"])
def test_runner_steps_match_jax(tmp_path, sched):
    jcfg, tcfg = _cfg(tmp_path, sched, "run")
    jrun, trun = _jax_runner(jcfg), _torch_runner(tcfg)
    jhist = jrun.train(_batches)
    thist = trun.train(_batches)
    _close(trun.params, jrun.params)
    # the epochs' mean losses: float32 sums in each package, ~1e-6 apart
    np.testing.assert_allclose([h["train_loss"] for h in thist], [h["train_loss"] for h in jhist], rtol=1e-5)
    port_ckpt = dict(np.load(tmp_path / "run" / "checkpoint_latest.npz"))
    assert int(port_ckpt["__epoch__"]) == EPOCHS - 1 and int(port_ckpt["opt/0/.count"]) == EPOCHS * STEPS
    assert set(port_ckpt) == {"__epoch__"} | {f"model/{k}" for k in JR._flatten(jrun.params)} | \
        {f"opt/{k}" for k in JR._flatten(jrun.opt_state)}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_from_either_runner(tmp_path, writer):
    """Epoch 0's checkpoint (of the JAX runner or the port's) and a fresh
    runner of the port or of JAX, resumed at epoch 1, end where one
    uninterrupted JAX run ends: the Adam moments and the count come across."""
    jcfg, tcfg = _cfg(tmp_path, "linear_warmup_cosine_lr", "full")
    full = _jax_runner(jcfg)
    full.train(_batches)
    if writer == "jax":
        ckpt = tmp_path / "full" / "checkpoint_0.npz"
        resumed = _torch_runner(_cfg(tmp_path, "linear_warmup_cosine_lr", "resumed")[1])
    else:
        first = _torch_runner(_cfg(tmp_path, "linear_warmup_cosine_lr", "first")[1])
        first.train(_batches)
        ckpt = tmp_path / "first" / "checkpoint_0.npz"
        resumed = _jax_runner(_cfg(tmp_path, "linear_warmup_cosine_lr", "resumed")[0])
    resumed.load_checkpoint(str(ckpt))
    assert resumed.start_epoch == 1
    resumed.train(_batches)
    if writer == "jax":
        _close(resumed.params, full.params)
    else:
        for name, want in JR._flatten(full.params).items():
            np.testing.assert_allclose(np.asarray(JR._flatten(resumed.params)[name]), np.asarray(want), rtol=1e-6,
                                       atol=1e-6 * np.abs(np.asarray(want)).max())


def test_port_resume_equals_uninterrupted(tmp_path):
    _, tcfg = _cfg(tmp_path, "linear_warmup_step_lr", "a")
    full = _torch_runner(tcfg)
    full.train(_batches)
    fresh = _torch_runner(_cfg(tmp_path, "linear_warmup_step_lr", "b")[1])
    fresh.load_checkpoint(str(tmp_path / "a" / "checkpoint_0.npz"))
    fresh.train(_batches)
    for name, t in TR._flatten(fresh.params).items():
        assert torch.equal(t, TR._flatten(full.params)[name]), name
