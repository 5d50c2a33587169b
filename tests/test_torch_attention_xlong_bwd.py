"""The fused attention backward above T = 257 (encoder TTA of ViT-L/14 at
336 px: T = 577; ``ATTN_IMPL="flash"`` at T = 384 and 512), on the CPU:
which kernel a ``(T, dtype)`` runs on the card, the refusal above 577, the
plain backward (the CPU path, and what the card's ``mma_xlong`` and
``tf32x3_xlong`` are held to) against the VJP of the JAX package's Pallas
kernel in interpret mode, the emulations of the kernels' operand rounding
(3xTF32; bf16 P and dS split into hi + lo) at those lengths, and U1's
differentiated call at T = 384.

Tolerances: fp32 gradients 1e-4 absolute + 1e-4 relative (same math, other
summation orders: the backward kernels' own, ``chip_smoke.py`` TOL); bf16 one
rounding step of the output (2**-7 relative and absolute).
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

BWD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)
SCALE = 0.125  # 1 / sqrt(64)
LENGTHS = (258, 300, 577)   # one key past the long kernels; a ragged chunk; ViT-L/14@336px


@pytest.mark.parametrize("T", [258, 300, 384, 512, 577])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma_xlong"), (torch.float32, "tf32x3_xlong")])
def test_backward_variant_above_257(T, dtype, want):
    """The streamed two-launch kernels; fp32's is another kernel than its
    forward (``tf32x3_long`` streams the keys at any T), so another name."""
    assert TA.backward_variant(T, dtype) == want
    assert TA.backward_variant(257, dtype) != want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_refuses_above_577_naming_the_kernels(dtype):
    with pytest.raises(ValueError, match=r"T <= 577 \(the xlong backward kernels' longest sequence"):
        TA.backward_variant(578, dtype)


def test_launch_bwd_on_a_cpu_tensor_at_577_raises():
    """The wrapper never gives way to the plain version, at the new lengths too."""
    TA.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.launch_bwd(torch.zeros(1, 577, 192), torch.zeros(1, 577, 64), None, 1, SCALE)
    assert TA.LAUNCHES == {"fwd": 0, "bwd": 0} and not TA.LAUNCH_VARIANTS


@pytest.mark.parametrize("T,want", [(258, 25), (384, 36), (512, 64), (577, 100)])
def test_tile_classes_scratch_is_a_byte_a_tile(T, want):
    """The mask's 64 x 64 tiles that the bf16 xlong backward classifies (as
    the long one does) before its two launches: ceil(T / 64)^2 bytes."""
    assert TA.tile_classes_bytes(T) == want


@pytest.mark.parametrize("variant,B,T,H,masked,want", [
    ("mma_xlong", 6, 577, 16, True, [(torch.uint8, 100), (torch.float32, 6 * 16 * 3 * 640)]),
    ("mma_xlong", 24, 512, 16, False, [(torch.uint8, 0), (torch.float32, 24 * 16 * 3 * 512)]),
    ("tf32x3_xlong", 6, 577, 16, True, [(torch.float32, 6 * 16 * 3 * 640)]),
    ("tf32x3_xlong", 24, 384, 16, False, [(torch.float32, 24 * 16 * 3 * 384)]),
    ("mma_long", 24, 257, 16, True, [(torch.uint8, 25)]),
    ("mma_short", 800, 16, 8, True, []),
])
def test_backward_scratch_in_the_kernels_argument_order(variant, B, T, H, masked, want):
    """The scratch each backward kernel takes behind the mask: the bf16
    xlong kernel the tile classes (a null pointer without a mask), then the
    statistics of 64 rows a block for every (sequence, head)."""
    assert TA.bwd_scratch(variant, B, T, H, masked) == want
    assert TA.xlong_stats_floats(B, T, H) == B * H * 3 * ((T + 63) // 64 * 64)


def test_tf32_xlong_shared_memory_fits_a_cta():
    """The fp32 xlong backward's two launches (each CTA 128 own rows, the
    streamed slices in chunks of 32 rows, two buffers of split copies)
    within the 232,448 bytes a CTA can have, at the sizes its source's head
    note gives."""
    rows, keys = TA.tf32_xlong_smem_bytes()
    assert (rows, keys) == (182_304, 222_720) and TA.TF32_XLONG_CHUNK == 32
    assert max(rows, keys) <= TA.SMEM_PER_CTA == 232_448
    own = 2 * 64 * 64 * 4 * 2   # both warpgroups' G (rows) or V (keys), hi and lo
    copy, raw = 32 * 64 * 4, 2 * 32 * 68 * 4   # a hi or lo copy of a chunk; the next chunk's two padded slices
    assert rows == own + 2 * 6 * copy + raw + 4 * 8 + 1024   # K, V rows and K columns twice; mbarriers; alignment
    assert keys == own + 2 * 8 * copy + raw + 3 * 640 * 4 + 1024   # Q, G rows and columns twice; statistics


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed + T)
    return (rng.normal(size=(1, T, 3 * 64)).astype(np.float32), rng.normal(size=(1, T, 64)).astype(np.float32))


def _mask(T, kind):
    """None, causal, or a general mask: random, -inf on one key for every
    query and on two whole query rows, one of them the last (their softmax is
    uniform), and on every key behind the last whole 64 for a third of the rows."""
    if kind is None:
        return None
    if kind == "causal":
        return np.array(JL.causal_mask(T))
    mask = np.random.default_rng(T).normal(size=(T, T)).astype(np.float32)
    mask[:, 3] = -np.inf
    mask[[T // 3, T - 1]] = -np.inf
    mask[: T // 3, T // 64 * 64:] = -np.inf
    return mask


def _pallas_vjp(qkv, cot, mask, dtype=jnp.float32):
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda t: PA.fused_attention(t, jm, 1, SCALE, True), jnp.asarray(qkv, dtype))
    return np.asarray(vjp(jnp.asarray(cot, dtype))[0].astype(jnp.float32))


@pytest.mark.parametrize("kind", [None, "causal", "general"])
@pytest.mark.parametrize("T", LENGTHS)
def test_plain_backward_matches_pallas_vjp_above_257(T, kind):
    """One sequence, one full-width head (D=64), fp32 and bf16."""
    qkv, cot = _inputs(T)
    mask = _mask(T, kind)
    tm = None if mask is None else torch.from_numpy(mask)
    got = TA.fused_attention_reference_bwd(torch.from_numpy(qkv), torch.from_numpy(cot), tm, 1, SCALE)
    np.testing.assert_allclose(got.numpy(), _pallas_vjp(qkv, cot, mask), **BWD_TOL)
    got16 = TA.fused_attention_reference_bwd(torch.from_numpy(qkv).to(torch.bfloat16),
                                             torch.from_numpy(cot).to(torch.bfloat16), tm, 1, SCALE)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), _pallas_vjp(qkv, cot, mask, jnp.bfloat16), **BF16_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", LENGTHS)
def test_tf32x3_backward_within_fp32_tolerance_above_257(T, masked):
    """``tf32x3_xlong``'s arithmetic (every product in 3xTF32) at two heads
    against the plain fp32 backward; one TF32 pass would miss it."""
    rng = np.random.default_rng(T)
    qkv = torch.from_numpy(rng.normal(size=(1, T, 3 * 2 * 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, T, 2 * 64)).astype(np.float32))
    mask = TL.causal_mask(T) if masked else None
    want = TA.fused_attention_reference_bwd(qkv, g, mask, 2, SCALE)
    torch.testing.assert_close(TA.tf32_reference_bwd(qkv, g, mask, 2, SCALE, passes=3), want, **BWD_TOL)
    one = TA.tf32_reference_bwd(qkv, g, mask, 2, SCALE, passes=1)
    assert float(((one - want).abs() / (1e-4 + 1e-4 * want.abs())).max()) > 1.0


@pytest.mark.parametrize("kind", [None, "causal"])
@pytest.mark.parametrize("T", [258, 384, 577])
def test_tf32x3_emulation_matches_pallas_vjp_above_257(T, kind):
    """``tf32x3_xlong``'s arithmetic emulated (every product in 3xTF32, the
    statistics of each row in fp32) against the VJP of the JAX package's
    Pallas kernel in interpret mode, one full-width head."""
    qkv, cot = _inputs(T, seed=7)
    mask = _mask(T, kind)
    tm = None if mask is None else torch.from_numpy(mask)
    got = TA.tf32_reference_bwd(torch.from_numpy(qkv), torch.from_numpy(cot), tm, 1, SCALE, passes=3)
    np.testing.assert_allclose(got.numpy(), _pallas_vjp(qkv, cot, mask), **BWD_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", LENGTHS)
def test_bf16_operand_split_within_tolerance_above_257(T, masked):
    """``mma_xlong``'s operands: P and dS split into bf16 hi + lo. On bf16
    inputs the split's result is within one output rounding of the plain
    backward (the kernels' bf16 tolerance, ``chip_smoke.py`` TOL), and in
    fp32 far nearer to it than P and dS rounded once."""
    rng = np.random.default_rng(T + 1)
    qkv = torch.from_numpy(rng.normal(size=(2, T, 3 * 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, T, 64)).astype(np.float32))
    mask = TL.causal_mask(T) if masked else None
    want = TA.fused_attention_reference_bwd(qkv, g, mask, 1, SCALE)
    split = TA.bf16_operand_reference_bwd(qkv, g, mask, 1, SCALE, split=True)
    once = TA.bf16_operand_reference_bwd(qkv, g, mask, 1, SCALE, split=False)
    assert float((split - want).abs().max()) * 20 < float((once - want).abs().max())
    q16, g16 = qkv.bfloat16(), g.bfloat16()
    torch.testing.assert_close(TA.bf16_operand_reference_bwd(q16, g16, mask, 1, SCALE).float(),
                               TA.fused_attention_reference_bwd(q16, g16, mask, 1, SCALE).float(),
                               rtol=2**-7, atol=1e-2)


@pytest.mark.parametrize("T", [384, 512])
def test_flash_switch_takes_a_differentiated_call_above_257(T, monkeypatch):
    """U1 (``ATTN_IMPL="flash"``) at T = 384 and 512, causal: the gradient
    through the fused attention's autograd function (on the card the xlong
    backward; here its plain version) equals the dense branch's."""
    rng = np.random.default_rng(T)
    D = 128
    x = torch.from_numpy(rng.normal(size=(1, T, D)).astype(np.float32))
    w = [torch.from_numpy((rng.normal(size=s) * D ** -0.5).astype(np.float32))
         for s in ((D, 3 * D), (3 * D,), (D, D), (D,))]
    mask = TL.causal_mask(T)
    grads = {}
    for impl in ("dense", "flash"):
        monkeypatch.setattr(TL, "ATTN_IMPL", impl)
        xi = x.clone().requires_grad_(True)
        TL.multi_head_attention(xi, *w, 2, mask).sin().sum().backward()
        grads[impl] = xi.grad
    torch.testing.assert_close(grads["flash"], grads["dense"], **BWD_TOL)
