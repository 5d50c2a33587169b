"""The ``ATTN_IMPL = "flash"`` switch of the port's ``models/layers.py`` and
the routing of the fused attention forward, on the CPU.

The JAX package's "flash" is the upstream Pallas flash attention, which runs
only on a TPU, so its dense path is the CPU reference for the switch; the
port serves the switch with its own fused attention (plain version on the
CPU). Tolerances as in ``test_torch_attention.py``: fp32 forward 1e-5 and
gradients 1e-4 (same math, different summation order).
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


def _mha_inputs(seed, B, T, width):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, width)).astype(np.float32)
    qkv_w = (rng.normal(size=(width, 3 * width)) * width**-0.5).astype(np.float32)
    qkv_b = (rng.normal(size=(3 * width,)) * 0.1).astype(np.float32)
    out_w = (rng.normal(size=(width, width)) * width**-0.5).astype(np.float32)
    out_b = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
    return x, qkv_w, qkv_b, out_w, out_b


def _masks(T, masked):
    return (JL.causal_mask(T), TL.causal_mask(T)) if masked else (None, None)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_switch_matches_jax_dense(masked, monkeypatch):
    """T=128 with "flash" goes through the fused attention (head dim 64) and
    equals the JAX package's dense path, forward and gradient in x."""
    arrs = _mha_inputs(11, 2, 128, 128)
    jm, tm = _masks(128, masked)
    cot = np.random.default_rng(12).normal(size=(2, 128, 128)).astype(np.float32)
    jx, *jw = map(jnp.asarray, arrs)
    f = lambda t: JL.multi_head_attention(t, *jw, 2, jm)
    want, vjp = jax.vjp(f, jx)
    (want_grad,) = vjp(jnp.asarray(cot))

    monkeypatch.setattr(TL, "ATTN_IMPL", "flash")
    calls = []
    orig = TA.fused_attention
    monkeypatch.setattr(TA, "fused_attention", lambda *a: calls.append(a[0].shape) or orig(*a))
    x, *w = (torch.from_numpy(a) for a in arrs)
    x.requires_grad_(True)
    got = TL.multi_head_attention(x, *w, 2, tm)
    got.backward(torch.from_numpy(cot))
    assert calls == [(2, 128, 384)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_switch_leaves_other_lengths_dense(masked, monkeypatch):
    """T=120 is no multiple of 128: "flash" takes the dense branch, bit for bit."""
    x, *w = (torch.from_numpy(a) for a in _mha_inputs(13, 2, 120, 128))
    _, tm = _masks(120, masked)
    want = TL.multi_head_attention(x, *w, 2, tm)
    monkeypatch.setattr(TL, "ATTN_IMPL", "flash")
    monkeypatch.setattr(TA, "fused_attention", lambda *a: pytest.fail("T=120 went to the fused attention"))
    assert torch.equal(TL.multi_head_attention(x, *w, 2, tm), want)


def test_flash_switch_refusals(monkeypatch):
    x, *w = (torch.from_numpy(a) for a in _mha_inputs(14, 1, 8, 64))
    monkeypatch.setattr(TL, "ATTN_IMPL", "flush")
    with pytest.raises(ValueError, match="ATTN_IMPL"):
        TL.multi_head_attention(x, *w, 1)
    monkeypatch.setattr(TL, "ATTN_IMPL", "flash")
    long_x = torch.zeros(1, 384, 64)
    # T=384: the kernels serve it in both directions (the backward above T = 257 is the xlong one)
    assert TL.multi_head_attention(long_x, *w, 1).shape == (1, 384, 64)
    grad_x = long_x.clone().requires_grad_(True)
    TL.multi_head_attention(grad_x, *w, 1).sum().backward()
    assert grad_x.grad.shape == (1, 384, 64)
    with pytest.raises(ValueError, match="577"):
        TL.multi_head_attention(torch.zeros(1, 640, 64), *w, 1)
    # attn="fused" is not the switch's business: its plain version takes any T on the CPU
    assert TL.multi_head_attention(long_x, *w, 1, attn="fused").shape == (1, 384, 64)
    assert JL.ATTN_IMPL == "dense"


@pytest.mark.parametrize("T,dtype,want", [
    (1, torch.bfloat16, "mma_short"), (8, torch.bfloat16, "mma_short"), (16, torch.bfloat16, "mma_short"),
    (17, torch.bfloat16, "mma_long"), (24, torch.bfloat16, "mma_long"), (197, torch.bfloat16, "mma_long"),
    (257, torch.bfloat16, "mma_long"), (1, torch.float32, "tf32x6_short"), (16, torch.float32, "tf32x6_short"),
    (257, torch.float32, "tf32x3_long"),
])
def test_forward_variant(T, dtype, want):
    assert TA.forward_variant(T, dtype) == want


def test_forward_variant_and_wrapper_refuse():
    for T in (0, 578, 640):
        with pytest.raises(ValueError, match="577"):
            TA.forward_variant(T, torch.bfloat16)
    with pytest.raises(TypeError):
        TA.forward_variant(16, torch.float16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.launch_fwd(torch.zeros(1, 16, 192, dtype=torch.bfloat16), None, 1, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.launch_bwd(torch.zeros(1, 16, 192), torch.zeros(1, 16, 64), None, 1, 0.125)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [16, 24, 33])
def test_plain_version_matches_pallas_at_tile_edges(T, masked):
    """Head dimension 64 at the tensor-core kernel's tile edges (one full
    16-row tile, one and a half, two and a row)."""
    qkv = np.random.default_rng(200 + T).normal(size=(2, T, 3 * 2 * 64)).astype(np.float32)
    jm, tm = _masks(T, masked)
    want = PA.fused_attention(jnp.asarray(qkv), jm, 2, 0.125, True)
    got = TA.fused_attention_reference(torch.from_numpy(qkv), tm, 2, 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want16 = PA.fused_attention(jnp.asarray(qkv, jnp.bfloat16), jm, 2, 0.125, True)
    got16 = TA.fused_attention_reference(torch.from_numpy(qkv).to(torch.bfloat16), tm, 2, 0.125)
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16.astype(jnp.float32)), rtol=2**-7, atol=2**-7)
