"""Policy state utilities: trainable-subset partitioning and the momentum
EMA of adapted weights (the counterpart of ``rlcf_tpu/core/policy.py``).

Parameters are the port's nested dicts of tensors, whose leaf paths are the
JAX package's (``visual/blocks/ln1_w``; ``models/convert.py::from_jax_params``).

- ``partition``/``merge`` take the place of the overridden ``parameters()``
  that limits AdamW to the visual tower or to its normalization layers
  (`TPT/clip/custom_clip.py:477-485`).
- ``MomentumState`` and ``momentum_update`` take the place of
  ``momentum_update_model`` (`custom_clip.py:460-475`): after each episode
  the EMA absorbs the adapted weights; every ``update_freq`` episodes the
  episodes' starting point is re-anchored to ``(1-w)*orig + w*ema``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts and lists (a ResNet's groups of
    blocks) of the same structure; a leaf that is None in the first tree
    stays None."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(tree_map(fn, *parts) for parts in zip(*trees))
    return None if trees[0] is None else fn(*trees)


def tree_leaves(tree):
    """The non-None leaves of nested dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def _paths(tree, prefix=""):
    """Each leaf's path, as the JAX package writes it (``visual/groups/0/1/bn1/w``)."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return prefix[:-1]


def norm_only_filter(path: str) -> bool:
    """True for LayerNorm / BatchNorm affine params (only_norm mode)."""
    tail = path.rsplit("/", 1)[-1]
    is_ln = ("ln" in path and tail in ("ln1_w", "ln1_b", "ln2_w", "ln2_b")) or tail.startswith(
        ("ln_pre", "ln_post", "ln_final", "ln1", "ln2")
    )
    is_bn = "/bn" in path and tail in ("w", "b")
    return is_ln or is_bn


def partition(params, predicate: Callable[[str], bool]) -> Tuple[Any, Any]:
    """Split nested dicts into (selected, rest) by a predicate on the leaf
    path; leaves not taken become None so that the two stay mergeable."""
    paths = _paths(params)
    pick = lambda keep: tree_map(lambda leaf, path: leaf if predicate(path) == keep else None, params, paths)
    return pick(True), pick(False)


def merge(selected, rest):
    """Inverse of :func:`partition` (leaf-wise first non-None)."""
    if isinstance(selected, dict):
        return {k: merge(selected[k], rest[k]) for k in selected}
    if isinstance(selected, (list, tuple)):
        return type(selected)(merge(a, b) for a, b in zip(selected, rest))
    return selected if selected is not None else rest


@dataclasses.dataclass
class MomentumState:
    """Cross-episode EMA of adapted weights (`momentum_update_model`)."""

    orig_params: Any          # pristine checkpoint weights (clip_state_dict)
    reset_params: Any         # episodes' starting point (initial_state_dict)
    ema_params: Any           # momentum_state_dict
    counter: int = 0

    @classmethod
    def create(cls, params):
        return cls(orig_params=params, reset_params=params, ema_params=params)


@torch.no_grad()
def momentum_update(state: MomentumState, adapted, momentum: float = 0.9999, update_freq: int = 256,
                    update_w: float = 1.0) -> MomentumState:
    """Fold one episode's adapted params into the EMA; re-anchor every
    ``update_freq`` episodes (`custom_clip.py:460-475`)."""
    ema = tree_map(lambda e, a: momentum * e + (1.0 - momentum) * a, state.ema_params, adapted)
    counter = state.counter + 1
    if counter >= update_freq:
        reset = tree_map(lambda o, e: (1.0 - update_w) * o + update_w * e, state.orig_params, ema)
        return MomentumState(state.orig_params, reset, ema, 0)
    return MomentumState(state.orig_params, state.reset_params, ema, counter)


@torch.no_grad()
def momentum_update_batch(state: MomentumState, adapted_stack, momentum: float = 0.9999, update_freq: int = 256,
                          update_w: float = 1.0) -> MomentumState:
    """Fold a group of adapted params, stacked on a leading episode axis, in
    episode order: the same as ``momentum_update`` applied to each in turn,
    a re-anchor inside the group included."""
    for i in range(tree_leaves(adapted_stack)[0].shape[0]):
        state = momentum_update(state, tree_map(lambda a: a[i], adapted_stack), momentum, update_freq, update_w)
    return state
