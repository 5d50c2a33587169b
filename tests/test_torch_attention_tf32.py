"""The fp32 attention kernels' arithmetic on the tensor cores, emulated in
plain PyTorch (``ops/attention.py::rna_tf32``, ``tf32_reference``,
``tf32_reference_bwd``): 3xTF32 for T > 16 (each operand split into
hi = rna(x) and lo = rna(x - hi), each product lo.hi + hi.lo + hi.hi) and
six products of a three-way split for T <= 16, held to the JAX package's
Pallas kernel in interpret mode and to the plain fp32 version at full head
width.

Tolerances are the kernels' own (``chip_smoke.py`` TOL, unchanged): forward
1e-5 + 1e-5 * |reference|, backward 1e-4 + 1e-4 * |reference|. One TF32 pass
does not hold the forward's: that is why each product is split.
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

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.125  # 1 / sqrt(64)


def _inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, 3 * H * 64)).astype(np.float32),
            rng.normal(size=(B, T, H * 64)).astype(np.float32))


def _masks(T, masked):
    return (JL.causal_mask(T), TL.causal_mask(T)) if masked else (None, None)


@pytest.mark.parametrize("x,want", [
    (1 + 2**-11, 1 + 2**-10),          # a tie goes away from zero (to even would give 1)
    (-(1 + 2**-11), -(1 + 2**-10)),
    (1 + 2**-11 - 2**-23, 1.0),        # below the tie: down
    (1 + 3 * 2**-11, 1 + 2**-9),       # above the last TF32 bit
    (3.0, 3.0),                        # a TF32 value is kept
])
def test_rna_tf32_rounds_to_nearest_ties_away(x, want):
    assert TA.rna_tf32(torch.tensor([x], dtype=torch.float32)).item() == want


def test_rna_tf32_split_is_exact_to_fp32():
    """hi keeps 10 mantissa bits (13 low bits clear) within half a TF32 step;
    x - hi is exact, and hi + rna(x - hi) is within 2^-21 of x."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32) * 10.0 ** np.arange(-4, 4).repeat(512))
    hi = TA.rna_tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((x - hi).abs() <= 2.0**-11 * x.abs()).all())
    lo = TA.rna_tf32(x - hi)
    assert bool(((x - (hi + lo)).abs() <= 2.0**-21 * x.abs()).all())


def _float64_heads(x):
    B, T, W = x.shape
    return x.double().reshape(B, T, 2, -1).transpose(1, 2)


def _float64_probs(qkv, mask):
    q, k, v = (_float64_heads(t) for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
    return torch.softmax(q @ k.transpose(-1, -2) * SCALE + TA.prep_mask(mask).double(), -1), q, k, v


def _float64_fwd(qkv, mask):
    p, _, _, v = _float64_probs(qkv, mask)
    return (p @ v).transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], -1)


def _float64_bwd(qkv, cot, mask):
    p, q, k, v = _float64_probs(qkv, mask)
    g = _float64_heads(cot)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    merge = lambda t: t.transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], -1)
    return torch.cat([merge(ds @ k * SCALE), merge(ds.transpose(-1, -2) @ q * SCALE), merge(p.transpose(-1, -2) @ g)], -1)


def _passes(T):
    """The kernels' form at this length: six products up to T = 16, 3xTF32 above."""
    return 6 if T <= 16 else 3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [9, 16, 17])
def test_tf32_forward_matches_pallas_interpret(T, masked):
    qkv, _ = _inputs(T, 2, T, 2)
    jm, tm = _masks(T, masked)
    want = PA.fused_attention(jnp.asarray(qkv), jm, 2, SCALE, True)
    got = TA.tf32_reference(torch.from_numpy(qkv), tm, 2, SCALE, passes=_passes(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [9, 16, 17])
def test_tf32_backward_matches_pallas_vjp(T, masked):
    qkv, cot = _inputs(100 + T, 2, T, 2)
    jm, tm = _masks(T, masked)
    _, vjp = jax.vjp(lambda t: PA.fused_attention(t, jm, 2, SCALE, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(cot))
    got = TA.tf32_reference_bwd(torch.from_numpy(qkv), torch.from_numpy(cot), tm, 2, SCALE, passes=_passes(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_six_products_are_closer_to_float64_than_3xtf32(direction):
    """The short kernels' three-way split carries every term down to 2^-22 of
    hi.hi: against a float64 reference it is at least as close as 3xTF32."""
    qkv, cot = (torch.from_numpy(a) for a in _inputs(5, 4, 16, 2))
    mask = TL.causal_mask(16)
    if direction == "fwd":
        run = lambda x, p: TA.tf32_reference(x, mask, 2, SCALE, passes=p)
        want = _float64_fwd(qkv, mask)
    else:
        run = lambda x, p: TA.tf32_reference_bwd(x, cot, mask, 2, SCALE, passes=p)
        want = _float64_bwd(qkv, cot, mask)
    err = lambda p: float((run(qkv, p).double() - want).norm() / want.norm())
    assert err(6) <= err(3) < err(1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [197, 257])
def test_tf32x3_full_width_head_within_fp32_tolerance(T, masked):
    """A full-width head (D=64, 2 heads) at the vision towers' lengths, both
    directions, against the plain fp32 version."""
    qkv, cot = (torch.from_numpy(a) for a in _inputs(T, 1, T, 2))
    mask = TL.causal_mask(T) if masked else None
    torch.testing.assert_close(TA.tf32_reference(qkv, mask, 2, SCALE),
                               TA.fused_attention_reference(qkv, mask, 2, SCALE), **FWD_TOL)
    torch.testing.assert_close(TA.tf32_reference_bwd(qkv, cot, mask, 2, SCALE),
                               TA.fused_attention_reference_bwd(qkv, cot, mask, 2, SCALE), **BWD_TOL)


@pytest.mark.parametrize("T", [16, 197])
def test_one_tf32_pass_does_not_hold_fp32_tolerance(T):
    """Why the products are split: one TF32 pass (10 mantissa bits a
    product) misses the forward's 1e-5 by far where 3xTF32 holds it."""
    qkv = torch.from_numpy(_inputs(T, 1, T, 2)[0])
    want = TA.fused_attention_reference(qkv, None, 2, SCALE)
    err = lambda got: float(((got - want).abs() / (FWD_TOL["atol"] + FWD_TOL["rtol"] * want.abs())).max())
    assert err(TA.tf32_reference(qkv, None, 2, SCALE, passes=1)) > 10.0
    assert err(TA.tf32_reference(qkv, None, 2, SCALE, passes=3)) < 1.0
