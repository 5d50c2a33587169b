"""Generic training/eval runner (the LAVIS ``RunnerBase`` equivalent), the
counterpart of ``rlcf_tpu/core/runner.py``.

AdamW with a weight-decay split (`runner_base.py:103-120`), linear warm-up
then cosine or step LR schedules (`:141-171`), epoch train/eval loops
(`:357-476`), and checkpoints that save the model, the optimizer and the
epoch and resume at epoch + 1 (`:565-635`). The model is a nested dict (and
list) of tensors that the runner trains in place; the checkpoints are npz
files in the JAX runner's layout (``model/<path>``, ``opt/...``,
``__epoch__``), so either package resumes from the other's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..models.convert import from_jax_numpy_tree
from .episode import adamw_step
from .policy import tree_leaves, tree_map


@dataclasses.dataclass
class RunnerConfig:
    max_epoch: int = 10
    init_lr: float = 1e-4
    min_lr: float = 1e-6
    warmup_lr: float = 1e-8
    warmup_steps: int = 0
    weight_decay: float = 0.05
    lr_sched: str = "linear_warmup_cosine_lr"  # or linear_warmup_step_lr
    lr_decay_rate: float = 0.9
    steps_per_epoch: int = 1000
    output_dir: str = "output"
    evaluate_only: bool = False
    seed: int = 42


def decay_mask(params):
    """True where weight decay applies: ndim >= 2 (skips norms and biases),
    the torch convention the LAVIS split reproduces (`runner_base.py:103-120`)."""
    return tree_map(lambda p: p.dim() >= 2, params)


def build_lr_schedule(cfg: RunnerConfig) -> Callable[[int], float]:
    """``sched(step) -> lr``: linear warm-up from ``warmup_lr`` to ``init_lr``
    over ``warmup_steps``, then a cosine to ``min_lr`` over the rest of
    ``max_epoch * steps_per_epoch`` steps, or ``init_lr * lr_decay_rate **
    epoch``. In float32, as the JAX schedule computes it."""
    f32 = np.float32
    total = cfg.max_epoch * cfg.steps_per_epoch

    def sched(step: int) -> float:
        if step < cfg.warmup_steps:
            return float(f32(cfg.warmup_lr) + f32(cfg.init_lr - cfg.warmup_lr) * f32(step) / f32(max(cfg.warmup_steps, 1)))
        if cfg.lr_sched == "linear_warmup_cosine_lr":
            t = min(max(f32(step - cfg.warmup_steps) / f32(max(total - cfg.warmup_steps, 1)), f32(0)), f32(1))
            return float(f32(cfg.min_lr) + f32(0.5 * (cfg.init_lr - cfg.min_lr)) * (f32(1) + np.cos(f32(math.pi) * t)))
        return float(f32(cfg.init_lr) * f32(cfg.lr_decay_rate) ** f32(step // cfg.steps_per_epoch))

    return sched


class AdamW:
    """The JAX runner's ``optax.chain(scale_by_adam(), masked(add_decayed_weights(wd)),
    scale_by_schedule(-sched))``: ``core/episode.py::adamw_step`` (optax's
    arithmetic op for op in float32) on each param group with its own decay,
    at the rate and count the ``Runner`` gives. ``state`` holds each leaf's
    moments (``exp_avg``, ``exp_avg_sq``) once it has stepped."""

    def __init__(self, groups, eps: float = 1e-8):
        self.groups, self.eps, self.state = groups, eps, {}

    @torch.no_grad()
    def step(self, grads: Dict, count: int, lr: float):
        """One step of every leaf from ``grads`` {leaf: gradient} (a leaf
        without one steps on zeros, as optax's chain does); ``count`` >= 1."""
        fresh = lambda p: {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        for group in self.groups:
            params = group["params"]
            state = [self.state.get(p) or fresh(p) for p in params]
            g = [grads[p] if grads.get(p) is not None else torch.zeros_like(p) for p in params]
            new, (mus, nus) = adamw_step(params, g, ([s["exp_avg"] for s in state], [s["exp_avg_sq"] for s in state]),
                                         count, lr, group["weight_decay"], self.eps)
            for p, q, mu, nu in zip(params, new, mus, nus):
                p.copy_(q)
                self.state[p] = {"exp_avg": mu, "exp_avg_sq": nu}


def build_optimizer(cfg: RunnerConfig, params) -> AdamW:
    """``AdamW`` over the params' leaves in two groups, the decayed
    (``decay_mask``) and the rest; the ``Runner`` steps it at the schedule's
    rate for the count of steps taken (0 first)."""
    leaves, mask = tree_leaves(params), tree_leaves(decay_mask(params))
    groups = [{"params": [p for p, m in zip(leaves, mask) if m], "weight_decay": cfg.weight_decay},
              {"params": [p for p, m in zip(leaves, mask) if not m], "weight_decay": 0.0}]
    return AdamW([g for g in groups if g["params"]])


def _flatten(tree, prefix: str = "") -> Dict:
    """{path: leaf} with the JAX runner's names (``visual/blocks/0/w``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flatten(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flatten(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Runner:
    """Epoch-driven trainer around ``train_step(params, batch, generator) ->
    loss``: a scalar differentiable in the params' leaves (which the runner
    makes require grad); the runner takes its gradient and one AdamW step at
    the schedule's rate. ``eval_fn(params, loader) -> metrics`` marks the best
    epoch by ``agg_metrics`` (default: minus the epoch's mean loss)."""

    def __init__(self, cfg: RunnerConfig, params, train_step: Callable, eval_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        self.opt = build_optimizer(cfg, self.params)
        self.sched = build_lr_schedule(cfg)
        self.steps = 0   # optimizer steps taken: the schedule's count and Adam's
        self.train_step = train_step
        self.eval_fn = eval_fn
        self.start_epoch = 0
        self.best_metric = -np.inf

    # -- checkpointing ----------------------------------------------------

    def _opt_state_flat(self) -> Dict[str, np.ndarray]:
        """The optimizer in the JAX runner's names: Adam's count and moments,
        the schedule's count."""
        flat = {"0/.count": np.asarray(self.steps, np.int32), "2/.count": np.asarray(self.steps, np.int32)}
        for path, p in _flatten(self.params).items():
            state = self.opt.state.get(p, {})
            flat[f"0/.mu/{path}"] = _numpy(state["exp_avg"]) if state else np.zeros(p.shape, np.float32)
            flat[f"0/.nu/{path}"] = _numpy(state["exp_avg_sq"]) if state else np.zeros(p.shape, np.float32)
        return flat

    def save_checkpoint(self, epoch: int, is_best: bool = False):
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        payload = {f"model/{k}": _numpy(v) for k, v in _flatten(self.params).items()}
        payload.update({f"opt/{k}": v for k, v in self._opt_state_flat().items()})
        payload["__epoch__"] = np.asarray(epoch)
        name = "checkpoint_best.npz" if is_best else f"checkpoint_{epoch}.npz"
        np.savez(os.path.join(self.cfg.output_dir, name), **payload)
        np.savez(os.path.join(self.cfg.output_dir, "checkpoint_latest.npz"), **payload)

    def load_checkpoint(self, path: str):
        """Restore the params, the optimizer (moments and count) and the
        epoch from a checkpoint of either runner; training resumes at the
        epoch after it."""
        data = dict(np.load(path, allow_pickle=False))
        self.steps = int(data["opt/0/.count"])
        with torch.no_grad():
            for name, p in _flatten(self.params).items():
                p.copy_(from_jax_numpy_tree(data[f"model/{name}"]))
                self.opt.state[p] = {
                    "exp_avg": from_jax_numpy_tree(data[f"opt/0/.mu/{name}"]).to(p.device, p.dtype),
                    "exp_avg_sq": from_jax_numpy_tree(data[f"opt/0/.nu/{name}"]).to(p.device, p.dtype)}
        self.start_epoch = int(data["__epoch__"]) + 1

    # -- loops ------------------------------------------------------------

    def step(self, batch, generator) -> float:
        loss = self.train_step(self.params, batch, generator)
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        self.opt.step(dict(zip(leaves, grads)), self.steps + 1, self.sched(self.steps))
        self.steps += 1
        return float(loss.detach())

    def train(self, train_loader_fn: Callable[[], Iterable], eval_loader_fn: Optional[Callable] = None):
        generator = torch.Generator().manual_seed(self.cfg.seed)
        history = []
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            losses = [self.step(batch, generator) for batch in train_loader_fn()]
            epoch_loss = sum(losses) / max(len(losses), 1)
            record = {"epoch": epoch, "train_loss": epoch_loss}
            if self.eval_fn and eval_loader_fn:
                with torch.no_grad():
                    eval_metrics = self.eval_fn(self.params, eval_loader_fn())
                record.update(eval_metrics)
                agg = eval_metrics.get("agg_metrics", -epoch_loss)
                if agg > self.best_metric:
                    self.best_metric = agg
                    self.save_checkpoint(epoch, is_best=True)
            history.append(record)
            self.save_checkpoint(epoch)
        return history
