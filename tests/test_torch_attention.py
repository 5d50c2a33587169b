"""The port's fused attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode: forward, gradients, routing.

Tolerances: fp32 forward 1e-5 and gradients 1e-4 (same math, different
summation order); bf16 one bf16 rounding step of the output (2**-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlcf_tpu.ops.pallas_attention as PA
from rlcf_tpu.models import layers as JL
from rlcf_torch.models import layers as TL
from rlcf_torch.ops import attention as TA


def _qkv(seed, B, T, H, D):
    return np.random.default_rng(seed).normal(size=(B, T, 3 * H * D)).astype(np.float32)


def _masks(T, masked):
    return (JL.causal_mask(T), TL.causal_mask(T)) if masked else (None, None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [9, 13, 17])
def test_forward_matches_pallas_interpret(T, masked):
    qkv = _qkv(T, 3, T, 2, 16)
    jm, tm = _masks(T, masked)
    want = PA.fused_attention(jnp.asarray(qkv), jm, 2, 0.25, True)
    got = TA.fused_attention(torch.from_numpy(qkv), tm, 2, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [9, 13, 17])
def test_grad_matches_pallas_vjp(T, masked):
    qkv = _qkv(100 + T, 2, T, 2, 16)
    cot = np.random.default_rng(T).normal(size=(2, T, 32)).astype(np.float32)
    jm, tm = _masks(T, masked)
    _, vjp = jax.vjp(lambda t: PA.fused_attention(t, jm, 2, 0.25, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(qkv).requires_grad_(True)
    TA.fused_attention(x, tm, 2, 0.25).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bf16_forward_within_bf16_rounding():
    qkv = _qkv(7, 2, 13, 2, 16)
    jm, tm = _masks(13, True)
    want = PA.fused_attention(jnp.asarray(qkv, jnp.bfloat16), jm, 2, 0.25, True)
    got = TA.fused_attention(torch.from_numpy(qkv).to(torch.bfloat16), tm, 2, 0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2**-7, atol=2**-7)


def test_reference_backward_is_the_explicit_formula():
    """The plain backward equals autograd of the plain fp32 forward."""
    qkv = torch.from_numpy(_qkv(3, 2, 11, 2, 16))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 11, 32)).astype(np.float32))
    x = qkv.clone().requires_grad_(True)
    TA.fused_attention_reference(x, TL.causal_mask(11), 2, 0.3).backward(g)
    got = TA.fused_attention_reference_bwd(qkv, g, TL.causal_mask(11), 2, 0.3)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_fused_matches_jax(masked, monkeypatch):
    """layers.multi_head_attention(attn='fused') of both packages, the JAX
    kernel in interpret mode."""
    orig = PA.fused_attention
    monkeypatch.setattr(PA, "fused_attention", lambda qkv, m, h, s, interpret=False: orig(qkv, m, h, s, True))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    qkv_w = (rng.normal(size=(32, 96)) * 0.1).astype(np.float32)
    qkv_b = (rng.normal(size=(96,)) * 0.1).astype(np.float32)
    out_w = (rng.normal(size=(32, 32)) * 0.1).astype(np.float32)
    out_b = np.zeros((32,), np.float32)
    jm, tm = _masks(8, masked)
    want = JL.multi_head_attention(*map(jnp.asarray, (x, qkv_w, qkv_b, out_w, out_b)), 4, jm, attn="fused")
    t = lambda a: torch.from_numpy(a)
    got = TL.multi_head_attention(t(x), t(qkv_w), t(qkv_b), t(out_w), t(out_b), 4, tm, attn="fused")
    dense = TL.multi_head_attention(t(x), t(qkv_w), t(qkv_b), t(out_w), t(out_b), 4, tm, attn="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_path_launches_no_kernel():
    TA.reset_launch_counts()
    x = torch.from_numpy(_qkv(1, 1, 5, 1, 64)).requires_grad_(True)
    TA.fused_attention(x, None, 1, 0.125).sum().backward()
    assert TA.LAUNCHES == {"fwd": 0, "bwd": 0}
