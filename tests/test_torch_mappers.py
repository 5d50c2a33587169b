"""The port's prefix mappers (``rlcf_torch/models/mappers.py``) against the
JAX package's on the same weights (``from_jax_mapper_params``), and the
per-episode form (N mappers stacked on a leading axis, one batched call)
against N separate calls, values and gradients. Tolerances: 1e-5 against
JAX (fp32), 1e-6 between the two forms of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.models import mappers as JM
from rlcf_torch.core import policy as Po
from rlcf_torch.models import mappers as TM
from rlcf_torch.models.convert import from_jax_mapper_params
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

KINDS = {
    "mlp": dict(clip_dim=16, llm_dim=24, prefix_length=5),
    "transformer": dict(clip_dim=16, llm_dim=24, prefix_length=5, clip_length=3, num_layers=2, n_heads=4),
    "transformer_encoder_decoder": dict(clip_dim=16, llm_dim=24, prefix_length=5, clip_length=3, num_layers=2,
                                        n_heads=4, enc_dec_width=32),
}


def _pair(kind, seed=0):
    jcfg, tcfg = JM.MapperConfig(kind, **KINDS[kind]), TM.MapperConfig(kind, **KINDS[kind])
    tree = jax.tree_util.tree_map(np.asarray, JM.init_mapper_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), from_jax_mapper_params(tree)


@pytest.mark.parametrize("kind", list(KINDS))
def test_mapper_matches_jax(kind):
    jcfg, tcfg, jp, tp = _pair(kind)
    x = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    want = np.asarray(JM.mapper_forward(jp, jcfg, jnp.asarray(x)))
    got = TM.mapper_forward(tp, tcfg, torch.as_tensor(x)).numpy()
    assert got.shape == (3, 5, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_per_episode_mapper_equals_separate_calls(kind):
    """Three different mappers stacked on a leading axis, two embeddings
    each: one call equals the three calls, outputs and gradients."""
    _, cfg, _, base = _pair(kind)
    g = torch.Generator().manual_seed(1)
    mappers = [Po.tree_map(lambda v: v + 0.05 * torch.randn(v.shape, generator=g), base) for _ in range(3)]
    x = torch.randn(3, 2, 16, generator=g)
    stacked = Po.tree_map(lambda *vs: torch.stack(vs).requires_grad_(True), *mappers)
    singles = [Po.tree_map(lambda v: v.clone().requires_grad_(True), m) for m in mappers]
    out = TM.mapper_forward(stacked, cfg, x)
    want = torch.stack([TM.mapper_forward(m, cfg, x[i]) for i, m in enumerate(singles)])
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    w = torch.randn(out.shape, generator=g)
    (out * w).sum().backward()
    (want * w).sum().backward()
    for got, *per in zip(Po.tree_leaves(stacked), *(Po.tree_leaves(m) for m in singles)):
        torch.testing.assert_close(got.grad, torch.stack([p.grad for p in per]), rtol=1e-5, atol=1e-6)
