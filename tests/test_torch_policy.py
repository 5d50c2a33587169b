"""The port's policy state (``rlcf_torch/core/policy.py``) against
``rlcf_tpu.core.policy`` on the same tiny CLIP visual tower: the norm-only
filter, partition and merge, and the momentum folds (one episode, and a
group folded in episode order with a re-anchor inside it). fp32; the folds
agree within 1e-6 (summation order of two products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core import policy as JPo
from rlcf_tpu.models import clip as JC
from rlcf_torch.core import policy as Po
from rlcf_torch.models import convert as TV

from torch_port_fixtures import jax_params_numpy, tiny_cfgs

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def visual():
    jcfg, tcfg = tiny_cfgs()
    jp = jax_params_numpy(JC.init_clip_params(jax.random.PRNGKey(0), jcfg))
    return jp["visual"], TV.from_jax_params(jp, tcfg)["visual"]


def _flat_jax(tree):
    """path -> leaf (None kept) of a JAX pytree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf for path, leaf in flat}


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat_torch(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _assert_tree_close(got, want, **tol):
    got, want = _flat_torch(got), _flat_jax(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if w is None:
            assert got[path] is None, path
        else:
            np.testing.assert_allclose(got[path].numpy(), np.asarray(w), err_msg=path, **tol)


def _perturbed(visual_t, seed):
    gen = torch.Generator().manual_seed(seed)
    return Po.tree_map(lambda v: v + 0.01 * torch.randn(v.shape, generator=gen), visual_t)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree.numpy())


@pytest.mark.parametrize("path", ["ln_pre_w", "ln_post_b", "blocks/ln1_w", "blocks/ln2_b", "blocks/qkv_w",
                                  "blocks/fc_b", "conv_w", "proj", "layer1/0/bn1/w", "bn/w", "ln_final_w"])
def test_norm_only_filter_matches_jax(path):
    assert Po.norm_only_filter(path) == JPo.norm_only_filter(path)


def test_partition_and_merge_match_jax(visual):
    jv, tv = visual
    jsel, jrest = JPo.partition(jv, JPo.norm_only_filter)
    tsel, trest = Po.partition(tv, Po.norm_only_filter)
    _assert_tree_close(tsel, jsel, rtol=0, atol=0)
    _assert_tree_close(trest, jrest, rtol=0, atol=0)
    assert any(v is not None for v in _flat_torch(tsel).values())
    _assert_tree_close(Po.merge(tsel, trest), jv, rtol=0, atol=0)


@pytest.mark.parametrize("only_norm", [False, True])
def test_momentum_update_matches_jax(visual, only_norm):
    jv, tv = visual
    if only_norm:
        tv = Po.partition(tv, Po.norm_only_filter)[0]
    jst, tst = JPo.MomentumState.create(_to_jax(tv)), Po.MomentumState.create(tv)
    for i in range(3):   # update_freq 2: the second update re-anchors
        adapted = _perturbed(tv, i)
        jst = JPo.momentum_update(jst, _to_jax(adapted), momentum=0.7, update_freq=2, update_w=0.6)
        tst = Po.momentum_update(tst, adapted, momentum=0.7, update_freq=2, update_w=0.6)
        assert tst.counter == jst.counter
        _assert_tree_close(tst.ema_params, jst.ema_params, **TOL)
        _assert_tree_close(tst.reset_params, jst.reset_params, **TOL)


@pytest.mark.parametrize("n,update_freq", [(3, 2), (4, 4), (2, 5)])
def test_momentum_update_batch_matches_jax_and_sequential(visual, n, update_freq):
    """A group folded in episode order, re-anchoring inside the group where
    the counter reaches update_freq, equals JAX's scan and the port's own
    sequential updates."""
    jv, tv = visual
    stack = Po.tree_map(lambda *xs: torch.stack(xs), *[_perturbed(tv, s) for s in range(n)])
    kw = dict(momentum=0.9, update_freq=update_freq, update_w=1.0)
    tst = Po.MomentumState.create(tv)
    tst.counter = 1
    jst = JPo.MomentumState(_to_jax(tv), _to_jax(tv), _to_jax(tv), 1)
    got = Po.momentum_update_batch(tst, stack, **kw)
    want = JPo.momentum_update_batch(jst, _to_jax(stack), **kw)
    seq = tst
    for i in range(n):
        seq = Po.momentum_update(seq, Po.tree_map(lambda v: v[i], stack), **kw)
    assert got.counter == want.counter == seq.counter
    _assert_tree_close(got.ema_params, want.ema_params, **TOL)
    _assert_tree_close(got.reset_params, want.reset_params, **TOL)
    for a, b in zip(Po.tree_leaves(got.reset_params), Po.tree_leaves(seq.reset_params)):
        assert torch.equal(a, b)
