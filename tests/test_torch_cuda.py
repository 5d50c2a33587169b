"""The CUDA kernels (attention and AugMix) against their plain PyTorch
versions, on the card (marked ``cuda``; they skip where there is no card).

Run on a machine with an H100 (which has no JAX, hence no conftest):
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q``.
Tolerances: fp32 forward 1e-5 and backward 1e-4 (summation order); bf16 one
rounding step of the output on top of that (2**-7 relative, 1e-2 absolute).
AugMix: each test states its own.
"""

import numpy as np
import pytest
import torch

from rlcf_torch.models.layers import causal_mask
from rlcf_torch.ops import attention as A
from rlcf_torch.ops import augmix as X

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype, bwd=False):
    return dict(rtol=2**-7, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4 if bwd else 1e-5,
                                                                             atol=1e-4 if bwd else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,masked", [(3, 1, 1, False), (5, 16, 8, True), (2, 24, 8, True),
                                          (2, 197, 12, False), (2, 257, 16, False), (1, 257, 2, True)])
def test_kernel_matches_plain(dev, dtype, B, T, H, masked):
    g = torch.Generator(device=dev).manual_seed(T * 131 + H)
    qkv = torch.randn(B, T, 3 * H * 64, device=dev, generator=g).to(dtype)
    cot = torch.randn(B, T, H * 64, device=dev, generator=g).to(dtype)
    mask = causal_mask(T, dev) if masked else None
    scale = 0.125
    got = A.launch_fwd(qkv, mask, H, scale)
    dq = A.launch_bwd(qkv, cot, mask, H, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), A.fused_attention_reference(qkv, mask, H, scale).float(), **_tol(dtype))
    torch.testing.assert_close(dq.float(), A.fused_attention_reference_bwd(qkv, cot, mask, H, scale).float(),
                               **_tol(dtype, bwd=True))


SWEEP_T = [1, 7, 8, 15, 16, 17, 24, 32, 33, 50, 64, 65, 77, 80, 81, 128, 196, 197, 256, 257]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [8, 12, 16])
@pytest.mark.parametrize("T", SWEEP_T)
def test_bf16_forward_sweep(dev, T, H, masked):
    """The tensor-core forward over the edges of both regimes."""
    g = torch.Generator(device=dev).manual_seed(T * 100 + H)
    qkv = torch.randn(3, T, 3 * H * 64, device=dev, generator=g).to(torch.bfloat16)
    mask = causal_mask(T, dev) if masked else None
    want = A.fused_attention_reference(qkv, mask, H, 0.125).float()
    A.reset_launch_counts()
    got = A.launch_fwd(qkv, mask, H, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"mma_short" if T <= 16 else "mma_long": 1}
    torch.testing.assert_close(got.float(), want, **_tol(torch.bfloat16))


XLONG_T = [258, 271, 272, 288, 320, 321, 384, 449, 512, 513, 576, 577]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", XLONG_T)
def test_forward_above_257(dev, T, masked, dtype):
    """The forward at 258 <= T <= 577 (bf16: the one-sweep ``mma_xlong``;
    fp32: the streamed ``tf32x3_long``) against the plain version, and two
    launches bit for bit."""
    g = torch.Generator(device=dev).manual_seed(T * 10 + masked)
    qkv = torch.randn(2, T, 3 * 16 * 64, device=dev, generator=g).to(dtype)
    mask = causal_mask(T, dev) if masked else None
    A.reset_launch_counts()
    got, again = A.launch_fwd(qkv, mask, 16, 0.125), A.launch_fwd(qkv, mask, 16, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"mma_xlong" if dtype == torch.bfloat16 else "tf32x3_long": 2}
    torch.testing.assert_close(got.float(), A.fused_attention_reference(qkv, mask, 16, 0.125).float(), **_tol(dtype))
    assert torch.equal(got, again)


def test_bf16_forward_general_mask(dev):
    """An additive mask that is not causal, with one key masked out for every query."""
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(2, 197, 3 * 12 * 64, device=dev, generator=g).to(torch.bfloat16)
    mask = torch.randn(197, 197, device=dev, generator=g)
    mask[:, 3] = float("-inf")
    got = A.launch_fwd(qkv, mask, 12, 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), A.fused_attention_reference(qkv, mask, 12, 0.125).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("B,T,H,masked", [(7, 16, 8, True), (3, 197, 12, False), (2, 257, 16, True)])
def test_bf16_forward_is_bit_identical_between_launches(dev, B, T, H, masked):
    qkv = torch.randn(B, T, 3 * H * 64, device=dev).to(torch.bfloat16)
    mask = causal_mask(T, dev) if masked else None
    a, b = A.launch_fwd(qkv, mask, H, 0.125), A.launch_fwd(qkv, mask, H, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


FP32_SWEEP_T = [1, 16, 17, 64, 197, 257]
FP32_CASES = ([(T, kind) for T in FP32_SWEEP_T for kind in (None, "causal")]
              + [(T, kind) for T in FP32_SWEEP_T if T >= 16
                 for kind in ("key_out", "dead_row", "block_diagonal", "block_diagonal_dead_row", "dead_tail")])


def _fp32_inputs(dev, T, H, mask_kind):
    g = torch.Generator(device=dev).manual_seed(T * 100 + H)
    qkv = torch.randn(2, T, 3 * H * 64, device=dev, generator=g)
    cot = torch.randn(2, T, H * 64, device=dev, generator=g)
    mask = None if mask_kind is None else causal_mask(T, dev) if mask_kind == "causal" else \
        _general_mask(mask_kind, T, dev, g)
    return qkv, cot, mask


@pytest.mark.parametrize("H", [2, 12])
@pytest.mark.parametrize("T,mask_kind", FP32_CASES)
def test_fp32_forward_sweep_on_the_tf32_kernels(dev, T, H, mask_kind):
    """The split-TF32 forward over both regimes and the general masks: the
    counters show which kernel ran; fp32's tolerance; repeats bit-identical."""
    qkv, _, mask = _fp32_inputs(dev, T, H, mask_kind)
    A.reset_launch_counts()
    got = A.launch_fwd(qkv, mask, H, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"tf32x6_short" if T <= 16 else "tf32x3_long": 1}
    torch.testing.assert_close(got, A.fused_attention_reference(qkv, mask, H, 0.125), **_tol(torch.float32))
    assert torch.equal(got, A.launch_fwd(qkv, mask, H, 0.125))


def _bwd_inputs(dev, B, T, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, T, 3 * H * 64, device=dev, generator=g).to(torch.bfloat16)
    cot = torch.randn(B, T, H * 64, device=dev, generator=g).to(torch.bfloat16)
    return qkv, cot, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [8, 12, 16])
@pytest.mark.parametrize("T", SWEEP_T)
def test_bf16_backward_sweep(dev, T, H, masked):
    """The tensor-core backward over the edges of both regimes; the counters
    show which kernel ran; a second launch gives the same bits."""
    qkv, cot, _ = _bwd_inputs(dev, 3, T, H, T * 100 + H)
    mask = causal_mask(T, dev) if masked else None
    want = A.fused_attention_reference_bwd(qkv, cot, mask, H, 0.125).float()
    A.reset_launch_counts()
    got = A.launch_bwd(qkv, cot, mask, H, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"bwd_mma_short" if T <= 16 else "bwd_mma_long": 1}
    assert A.LAUNCHES == {"fwd": 0, "bwd": 1}
    torch.testing.assert_close(got.float(), want, **_tol(torch.bfloat16, bwd=True))
    assert torch.equal(got, A.launch_bwd(qkv, cot, mask, H, 0.125))


def _general_mask(kind, T, dev, gen):
    """A random additive mask with -inf on one key for every query
    (``key_out``), on two whole query rows, one of them the last
    (``dead_row``), on every 64 x 64 tile off the diagonal
    (``block_diagonal``), on both, or on the keys behind the last whole 64
    (``dead_tail``)."""
    mask = torch.randn(T, T, device=dev, generator=gen)
    block = torch.arange(T, device=dev) // 64
    if kind == "key_out":
        mask[:, 3] = float("-inf")
    if kind.startswith("block_diagonal"):
        mask[block[:, None] != block[None, :]] = float("-inf")
    if kind.endswith("dead_row"):
        mask[[T // 3, T - 1]] = float("-inf")
    if kind == "dead_tail":
        mask[:, T // 64 * 64:] = float("-inf")
    return mask


@pytest.mark.parametrize("T,kind", [(16, "key_out"), (197, "key_out"), (16, "dead_row"), (197, "dead_row"),
                                    (257, "dead_row"), (197, "block_diagonal"), (257, "block_diagonal"),
                                    (197, "block_diagonal_dead_row"), (257, "block_diagonal_dead_row"),
                                    (197, "dead_tail"), (257, "dead_tail")])
def test_bf16_backward_general_mask(dev, T, kind):
    """Additive masks that are not causal: what the long kernel's skipping of
    fully masked 64 x 64 tiles must get right (a fully masked row keeps every
    tile of its block; a row whose live keys lie in one tile; a dead tail)."""
    qkv, cot, g = _bwd_inputs(dev, 2, T, 12, 5)
    mask = _general_mask(kind, T, dev, g)
    got, again = A.launch_bwd(qkv, cot, mask, 12, 0.125), A.launch_bwd(qkv, cot, mask, 12, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), A.fused_attention_reference_bwd(qkv, cot, mask, 12, 0.125).float(),
                               **_tol(torch.bfloat16, bwd=True))


@pytest.mark.parametrize("B,T,H,masked", [(800, 16, 8, True), (24, 197, 12, False), (24, 257, 16, False),
                                          (24, 256, 16, True)])
def test_bf16_backward_at_full_batch(dev, B, T, H, masked):
    """The shapes the smoke script times: more CTAs than the card holds at once."""
    qkv, cot, _ = _bwd_inputs(dev, B, T, H, B + T)
    mask = causal_mask(T, dev) if masked else None
    got, again = A.launch_bwd(qkv, cot, mask, H, 0.125), A.launch_bwd(qkv, cot, mask, H, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), A.fused_attention_reference_bwd(qkv, cot, mask, H, 0.125).float(),
                               **_tol(torch.bfloat16, bwd=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_kind", [None, "causal", "dead_row"])
@pytest.mark.parametrize("T", [258, 321, 385, 448, 513, 576, 577])
def test_xlong_backward_matches_plain(dev, T, mask_kind, dtype):
    """The backward above T = 257 (``mma_xlong`` / ``tf32x3_xlong``, two
    launches) against the plain backward, with the edges of its chunks of 64
    and the one-row tail of T = 577; two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(T)
    qkv = torch.randn(2, T, 3 * 16 * 64, device=dev, generator=g).to(dtype)
    cot = torch.randn(2, T, 16 * 64, device=dev, generator=g).to(dtype)
    mask = None if mask_kind is None else causal_mask(T, dev) if mask_kind == "causal" else \
        _general_mask(mask_kind, T, dev, g)
    want = A.fused_attention_reference_bwd(qkv, cot, mask, 16, 0.125).float()
    A.reset_launch_counts()
    got = A.launch_bwd(qkv, cot, mask, 16, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"bwd_" + ("mma_xlong" if dtype == torch.bfloat16 else "tf32x3_xlong"): 1}
    torch.testing.assert_close(got.float(), want, **_tol(dtype, bwd=True))
    assert torch.equal(got, A.launch_bwd(qkv, cot, mask, 16, 0.125))


@pytest.mark.parametrize("B,T", [(3, 258), (6, 577), (24, 577)])
def test_fp32_xlong_backward_bits_do_not_depend_on_the_batch(dev, B, T):
    """``tf32x3_xlong`` sums dq over keys in its rows launch and dk, dv over
    queries in its keys launch, each in one fixed order and without atomics:
    two launches give the same bits, and so does the first sequence launched
    alone, at the encoder-336 step's batch and the smoke script's B=24."""
    g = torch.Generator(device=dev).manual_seed(T + B)
    qkv = torch.randn(B, T, 3 * 16 * 64, device=dev, generator=g)
    cot = torch.randn(B, T, 16 * 64, device=dev, generator=g)
    A.reset_launch_counts()
    got, again = A.launch_bwd(qkv, cot, None, 16, 0.125), A.launch_bwd(qkv, cot, None, 16, 0.125)
    alone = A.launch_bwd(qkv[:1].contiguous(), cot[:1].contiguous(), None, 16, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"bwd_tf32x3_xlong": 3}
    assert torch.equal(got, again) and torch.equal(got[:1], alone)
    torch.testing.assert_close(got[:1], A.fused_attention_reference_bwd(qkv[:1], cot[:1], None, 16, 0.125),
                               **_tol(torch.float32, bwd=True))


@pytest.mark.parametrize("mask_kind", ["key_out", "block_diagonal", "block_diagonal_dead_row", "dead_tail"])
def test_fp32_xlong_backward_masked_at_577(dev, mask_kind):
    """General masks at T = 577 (a dead key, dead tiles, fully masked rows,
    the keys past the last whole 64 masked) at the encoder-336 step's shape."""
    g = torch.Generator(device=dev).manual_seed(577 * 7)
    qkv = torch.randn(6, 577, 3 * 16 * 64, device=dev, generator=g)
    cot = torch.randn(6, 577, 16 * 64, device=dev, generator=g)
    mask = _general_mask(mask_kind, 577, dev, g)
    got, again = A.launch_bwd(qkv, cot, mask, 16, 0.125), A.launch_bwd(qkv, cot, mask, 16, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, A.fused_attention_reference_bwd(qkv, cot, mask, 16, 0.125),
                               **_tol(torch.float32, bwd=True))


def test_fp32_xlong_shared_memory_is_the_sources(dev):
    """The wrapper's sizing (``tf32_xlong_smem_bytes``) is what the source
    launches with."""
    lib = A._bwd_lib(torch.float32)
    assert (lib.rlcf_mha_bwd_tf32x3_xlong_smem(0), lib.rlcf_mha_bwd_tf32x3_xlong_smem(1)) == \
        A.tf32_xlong_smem_bytes()


@pytest.mark.parametrize("B,T", [(3, 258), (24, 577), (64, 577)])
def test_bf16_xlong_forward_bits_do_not_depend_on_the_batch(dev, B, T):
    """The one-sweep forward adds its two warpgroups' partial P.V in one
    fixed order and takes as many 64-row blocks a CTA as the batch makes
    best: two launches give the same bits, and so does the first sequence
    launched alone (another split of the blocks between CTAs)."""
    g = torch.Generator(device=dev).manual_seed(T + B)
    qkv = torch.randn(B, T, 3 * 16 * 64, device=dev, generator=g).to(torch.bfloat16)
    A.reset_launch_counts()
    got, again = A.launch_fwd(qkv, None, 16, 0.125), A.launch_fwd(qkv, None, 16, 0.125)
    alone = A.launch_fwd(qkv[:1].contiguous(), None, 16, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"mma_xlong": 3} and A.LAUNCHES == {"fwd": 3, "bwd": 0}
    assert torch.equal(got, again) and torch.equal(got[:1], alone)


@pytest.mark.parametrize("mask_kind", [None, "causal", "dead_row", "block_diagonal"])
@pytest.mark.parametrize("T", [513, 529, 576, 577])
def test_bf16_xlong_forward_tail_block(dev, T, mask_kind):
    """The forward's last block: a tail of at most 16 rows on the CTA's
    warps (T = 513: one row, 529: 16, 577: one), a whole block (T = 576),
    with and without masks, against the plain version."""
    g = torch.Generator(device=dev).manual_seed(T * 3)
    qkv = torch.randn(2, T, 3 * 16 * 64, device=dev, generator=g).to(torch.bfloat16)
    mask = None if mask_kind is None else causal_mask(T, dev) if mask_kind == "causal" else \
        _general_mask(mask_kind, T, dev, g)
    A.reset_launch_counts()
    got = A.launch_fwd(qkv, mask, 16, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"mma_xlong": 1}
    torch.testing.assert_close(got.float(), A.fused_attention_reference(qkv, mask, 16, 0.125).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("mask_kind", ["causal", "dead_row", "block_diagonal", "block_diagonal_dead_row"])
@pytest.mark.parametrize("T", [384, 512, 577])
def test_bf16_xlong_backward_skips_dead_tiles(dev, T, mask_kind):
    """Masks with 64 x 64 tiles at the floor everywhere, which both xlong
    launches skip (causal: 36 of 64 tiles visited at T = 512), with fully
    masked rows (their softmax is uniform: every tile of their block kept):
    against the plain backward, two launches bit for bit, one launch."""
    g = torch.Generator(device=dev).manual_seed(T * 5)
    qkv = torch.randn(2, T, 3 * 16 * 64, device=dev, generator=g).to(torch.bfloat16)
    cot = torch.randn(2, T, 16 * 64, device=dev, generator=g).to(torch.bfloat16)
    mask = causal_mask(T, dev) if mask_kind == "causal" else _general_mask(mask_kind, T, dev, g)
    A.reset_launch_counts()
    got, again = A.launch_bwd(qkv, cot, mask, 16, 0.125), A.launch_bwd(qkv, cot, mask, 16, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"bwd_mma_xlong": 2} and A.LAUNCHES == {"fwd": 0, "bwd": 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), A.fused_attention_reference_bwd(qkv, cot, mask, 16, 0.125).float(),
                               **_tol(torch.bfloat16, bwd=True))


@pytest.mark.parametrize("H", [2, 12])
@pytest.mark.parametrize("T,mask_kind", FP32_CASES)
def test_fp32_backward_sweep_on_the_tf32_kernels(dev, T, H, mask_kind):
    """The split-TF32 backward as the forward's sweep."""
    qkv, cot, mask = _fp32_inputs(dev, T, H, mask_kind)
    A.reset_launch_counts()
    got = A.launch_bwd(qkv, cot, mask, H, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"bwd_tf32x6_short" if T <= 16 else "bwd_tf32x3_long": 1}
    torch.testing.assert_close(got, A.fused_attention_reference_bwd(qkv, cot, mask, H, 0.125),
                               **_tol(torch.float32, bwd=True))
    assert torch.equal(got, A.launch_bwd(qkv, cot, mask, H, 0.125))


@pytest.mark.parametrize("T", [16, 50])
def test_bf16_autograd_runs_both_tensor_core_kernels(dev, T):
    A.reset_launch_counts()
    x = torch.randn(4, T, 3 * 8 * 64, device=dev).to(torch.bfloat16).requires_grad_(True)
    A.fused_attention(x, causal_mask(T, dev), 8, 0.125).float().sum().backward()
    torch.cuda.synchronize()
    regime = "mma_short" if T <= 16 else "mma_long"
    assert dict(A.LAUNCH_VARIANTS) == {regime: 1, "bwd_" + regime: 1}
    assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,masked", [(128, False), (128, True), (256, True)])
def test_flash_switch_launches_the_kernel(dev, monkeypatch, T, masked, dtype):
    """ATTN_IMPL="flash" sends the dense branch through the kernel at
    T % 128 == 0 and equals the dense math; at T=384 a differentiated call
    runs the xlong backward."""
    from rlcf_torch.models import layers as L

    D, H = 256, 4
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn(2, T, D, device=dev, generator=g).to(dtype)
    w = [(torch.randn(s, device=dev, generator=g) * D ** -0.5).to(dtype) for s in ((D, 3 * D), (3 * D,), (D, D), (D,))]
    mask = causal_mask(T, dev) if masked else None
    want = L.multi_head_attention(x, *w, H, mask)
    monkeypatch.setattr(L, "ATTN_IMPL", "flash")
    A.reset_launch_counts()
    got = L.multi_head_attention(x, *w, H, mask)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fwd"] == 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    x384 = torch.zeros(1, 384, D, device=dev, dtype=dtype, requires_grad=True)
    L.multi_head_attention(x384, *w, H).float().sum().backward()
    torch.cuda.synchronize()
    assert A.LAUNCH_VARIANTS["bwd_" + A.backward_variant(384, dtype)] == 1 and bool(torch.isfinite(x384.grad).all())


def test_autograd_function_launches_kernels(dev):
    A.reset_launch_counts()
    x = torch.randn(4, 16, 3 * 8 * 64, device=dev, requires_grad=True)
    A.fused_attention(x, causal_mask(16, dev), 8, 0.125).sum().backward()
    torch.cuda.synchronize()
    assert A.LAUNCHES == {"fwd": 1, "bwd": 1}


def test_kernel_refuses_unsupported_shapes(dev):
    with pytest.raises(ValueError):
        A.launch_fwd(torch.randn(2, 8, 3 * 2 * 32, device=dev), None, 2, 0.2)  # head dim 32
    with pytest.raises(ValueError):
        A.launch_fwd(torch.randn(1, 578, 3 * 64, device=dev), None, 1, 0.125)  # T > 577
    with pytest.raises(TypeError):
        A.launch_fwd(torch.randn(1, 8, 3 * 64, device=dev).half(), None, 1, 0.125)
    with pytest.raises(ValueError):
        A.launch_bwd(torch.randn(1, 578, 3 * 64, device=dev), torch.randn(1, 578, 64, device=dev), None, 1, 0.125)
    with pytest.raises(ValueError, match="cotangent"):
        A.launch_bwd(torch.randn(1, 8, 3 * 64, device=dev), torch.randn(1, 8, 32, device=dev), None, 1, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction,B,T,H", [("fwd", 64, 197, 12), ("fwd", 6, 197, 12), ("fwd", 1, 197, 12),
                                             ("fwd", 6, 257, 16), ("bwd", 6, 197, 12)])
def test_encoder_tta_shapes_match_plain(dev, dtype, direction, B, T, H):
    """Encoder TTA's launch shapes (one image: 64 views selected from, 6
    through the steps and the reward, view 0 predicted): the long kernels."""
    g = torch.Generator(device=dev).manual_seed(B * 7 + T)
    qkv = torch.randn(B, T, 3 * H * 64, device=dev, generator=g).to(dtype)
    cot = torch.randn(B, T, H * 64, device=dev, generator=g).to(dtype)
    A.reset_launch_counts()
    if direction == "fwd":
        got, want = A.launch_fwd(qkv, None, H, 0.125), A.fused_attention_reference(qkv, None, H, 0.125)
    else:
        got, want = A.launch_bwd(qkv, cot, None, H, 0.125), A.fused_attention_reference_bwd(qkv, cot, None, H, 0.125)
    torch.cuda.synchronize()
    long_kernel = "mma_long" if dtype == torch.bfloat16 else "tf32x3_long"
    assert dict(A.LAUNCH_VARIANTS) == {long_kernel if direction == "fwd" else "bwd_" + long_kernel: 1}
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, bwd=direction == "bwd"))


def _encoder_classifiers(dev, dtype=torch.float32, **kw):
    """One EncoderTTAClassifier on the card and one on the CPU, same weights:
    ViT towers with 64-wide heads at T = (64/8)^2 + 1 = 65 (the long kernels)."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.models import clip as TC
    from rlcf_torch.tasks.classification import EncoderTTAClassifier

    cfg = TC.ClipConfig("t", 32, 64, 2, 128, 8, 128, 1, vision_heads_override=2, text_heads_override=2)
    names = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
    ecfg = EpisodeConfig(tta_steps=3, selection_p=0.25, lr=1e-4, sample_k=2)
    out = []
    for device in (dev, torch.device("cpu")):
        move = lambda p: Po.tree_map(lambda v: v.to(device, dtype if v.dim() else v.dtype), p)
        reward = ClipReward(move(TC.init_clip_params(cfg, seed=1)), cfg, RewardConfig(sample_k=2))
        out.append(EncoderTTAClassifier(move(TC.init_clip_params(cfg, seed=0)), cfg, reward, ecfg, **kw).setup(names))
    return out


@pytest.mark.parametrize("remat", [True, "save_attn", False])
def test_encoder_episode_on_the_card_matches_cpu(dev, remat):
    """fp32 encoder TTA (N=2, 8 views) through the split-TF32 kernels against
    the CPU's dense plain path: selections equal, logits and losses within
    2e-4 + 1e-3 relative."""
    card, cpu = _encoder_classifiers(dev, remat=remat)
    views = np.random.default_rng(0).integers(0, 256, size=(2, 8, 64, 64, 3), dtype=np.uint8)
    A.reset_launch_counts()
    got, got_aux = card.adapt(views)
    torch.cuda.synchronize()
    want, want_aux = cpu.adapt(views)
    assert A.LAUNCH_VARIANTS["tf32x3_long"] > 0 and A.LAUNCH_VARIANTS["bwd_tf32x3_long"] == 3 * 2
    assert torch.equal(got_aux["selected"].cpu(), want_aux["selected"])
    torch.testing.assert_close(got_aux["losses"].cpu(), want_aux["losses"], rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-4)


def test_encoder_bf16_episode_runs_the_long_backward(dev):
    card, _ = _encoder_classifiers(dev, torch.bfloat16, momentum_update=True, update_freq=2)
    views = np.random.default_rng(1).integers(0, 256, size=(2, 8, 64, 64, 3), dtype=np.uint8)
    A.reset_launch_counts()
    logits, aux = card.adapt(views, return_adapted=True)
    torch.cuda.synchronize()
    assert A.LAUNCH_VARIANTS["bwd_mma_long"] == 3 * 2 and A.LAUNCH_VARIANTS["mma_long"] > 0
    assert logits.shape == (2, 5) and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux["losses"]).all())
    assert card.momentum_state.counter == 0   # two episodes folded with update_freq 2: re-anchored


def _tune_cls_argv(tmp_path, *extra):
    return [".", "--device", "cuda", "--test_sets", "synthetic", "--limit", "1", "--precision", "bf16",
            "--batch_size", "64", "--tta_steps", "3", "--sample_k", "3", "--lr", "1e-5", "--episode_group", "1",
            "--output", str(tmp_path), *extra]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_text_kernels_at_t24_full_batch(dev, dtype, direction):
    """The text tower of Stanford Cars' and ImageNet's prompts (T = 24, causal,
    B = 4 x 196): the long kernels over 64-row tiles of which 24 rows live."""
    B, T, H = 784, 24, 8
    g = torch.Generator(device=dev).manual_seed(B + T)
    qkv = torch.randn(B, T, 3 * H * 64, device=dev, generator=g).to(dtype)
    cot = torch.randn(B, T, H * 64, device=dev, generator=g).to(dtype)
    mask = causal_mask(T, dev)
    A.reset_launch_counts()
    if direction == "fwd":
        run, want = lambda: A.launch_fwd(qkv, mask, H, 0.125), A.fused_attention_reference(qkv, mask, H, 0.125)
    else:
        run = lambda: A.launch_bwd(qkv, cot, mask, H, 0.125)
        want = A.fused_attention_reference_bwd(qkv, cot, mask, H, 0.125)
    got, again = run(), run()
    torch.cuda.synchronize()
    variant = "mma_long" if dtype == torch.bfloat16 else "tf32x3_long"
    assert dict(A.LAUNCH_VARIANTS) == {variant if direction == "fwd" else "bwd_" + variant: 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, bwd=direction == "bwd"))


def _tiny_card_and_cpu(dev):
    """The same tiny ViT CLIP (64-wide heads: vision T = 65, the long kernels;
    class prompts T <= 16, the short ones) on the card and on the CPU, fp32."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import clip as TC

    cfg = TC.ClipConfig("t", 32, 64, 2, 128, 8, 128, 1, vision_heads_override=2, text_heads_override=2)
    params = TC.init_clip_params(cfg, seed=0)   # drawn on the CPU, then copied: the same weights
    return cfg, {dev.type: Po.tree_map(lambda v: v.to(dev), params), "cpu": params}


def test_cocoop_episode_on_the_card_matches_cpu(dev):
    """CoCoOp (N=3 images, 16 views, 2 entropy steps; each episode from its own
    instance-conditioned context) through the fp32 kernels against the CPU's
    dense plain path: selections equal, logits and losses within 2e-4 + 1e-3
    relative."""
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.tasks.classification import CoCoOpTTAClassifier

    cfg, params = _tiny_card_and_cpu(dev)
    names = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
    ecfg = EpisodeConfig(tta_steps=2, selection_p=0.25, lr=5e-3, loss="tpt")
    card, cpu = (CoCoOpTTAClassifier(params[d], cfg, ecfg).setup(names) for d in (dev.type, "cpu"))
    views = np.random.default_rng(0).integers(0, 256, size=(3, 16, 64, 64, 3), dtype=np.uint8)
    A.reset_launch_counts()
    got, got_aux = card.adapt(views)
    torch.cuda.synchronize()
    want, want_aux = cpu.adapt(views)
    assert A.LAUNCH_VARIANTS["tf32x3_long"] > 0 and A.LAUNCH_VARIANTS["bwd_tf32x6_short"] == 2
    assert torch.equal(got_aux["selected"].cpu(), want_aux["selected"])
    torch.testing.assert_close(got_aux["losses"].cpu(), want_aux["losses"], rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("learned_cls", [True, False])
def test_bongard_episode_on_the_card_matches_cpu(dev, learned_cls):
    """Bongard-HOI (N=2 tasks, float task images, 3 steps) on the card
    against the CPU's dense plain path: query logits and support losses
    within 2e-4 + 1e-3 relative; the float images are not quantised."""
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.tasks.bongard import BongardTTA

    cfg, params = _tiny_card_and_cpu(dev)
    ecfg = EpisodeConfig(tta_steps=3, lr=0.05)
    card, cpu = (BongardTTA(params[d], cfg, ecfg, n_ctx=2, learned_cls=learned_cls).setup()
                 for d in (dev.type, "cpu"))
    imgs = np.random.default_rng(1).normal(size=(2, 14, 64, 64, 3)).astype(np.float32)
    labels = np.tile(np.array([0] * 6 + [1] * 6), (2, 1))
    A.reset_launch_counts()
    got, got_aux = card.adapt_tasks(imgs, labels)
    torch.cuda.synchronize()
    want, want_aux = cpu.adapt_tasks(imgs, labels)
    assert A.LAUNCH_VARIANTS["tf32x3_long"] > 0 and A.LAUNCH_VARIANTS["bwd_tf32x6_short"] == 3
    torch.testing.assert_close(got_aux["losses"].cpu(), want_aux["losses"], rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-4)
    feats = card.encode_images(torch.from_numpy(imgs[0]).to(dev))   # float NHWC in, as given
    torch.testing.assert_close(feats.cpu(), cpu.encode_images(torch.from_numpy(imgs[0])), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("prior", [None, "0.5"])
def test_tune_cls_resnet_policy_on_the_card(dev, tmp_path, prior):
    """tune_cls through test-tiny-rn (grouped per-episode convolutions on the
    card), with and without the BN prior: one image, finite results; the
    views from the AugMix kernel, the reward through the attention kernels."""
    from rlcf_torch.cli import tune_cls

    X.reset_launch_counts()
    A.reset_launch_counts()
    extra = ("--prior_strength", prior) if prior else ()
    r = tune_cls.main(_tune_cls_argv(tmp_path, "--arch", "test-tiny-rn", "--reward_arch", "test-small",
                                     "--resolution", "64", *extra))
    torch.cuda.synchronize()
    assert r["synthetic"]["n"] == 1 and X.LAUNCHES["augmix"] == 1 and A.LAUNCHES["fwd"] > 0


def test_tune_cls_vit_l14_336_on_the_card(dev, tmp_path):
    """tune_cls through ViT-L/14@336px at 336 px (views from the AugMix
    kernel's large layout), one image: every step's backward through the 24
    layers runs ``mma_xlong``, 72 launches."""
    from rlcf_torch.cli import tune_cls

    X.reset_launch_counts()
    A.reset_launch_counts()
    r = tune_cls.main(_tune_cls_argv(tmp_path, "--arch", "ViT-L/14@336px", "--resolution", "336", "--reward_arch",
                                     "ViT-L/14", "--selection_p", "0.1", "--remat", "full"))
    torch.cuda.synchronize()
    assert r["synthetic"]["n"] == 1 and X.LAUNCHES["augmix"] == 1
    assert A.LAUNCH_VARIANTS["bwd_mma_xlong"] == 24 * 3 and A.LAUNCH_SHAPES[("bwd", 6, 577, 16, "torch.bfloat16")] == 72


def test_tta_cls_fused_views_at_336_on_the_card(dev, tmp_path):
    """Prompt TTA in token mode at 336 px (ViT-L/14@336px policy, 336 % 14 = 0):
    one group of 4 images whose views the AugMix kernel builds in its large
    layout; the reward (ViT-L/14) takes them depatchified and resized."""
    from rlcf_torch.cli import tta_cls

    X.reset_launch_counts()
    r = tta_cls.main([".", "--device", "cuda", "--test_sets", "synthetic", "--limit", "4", "--viewgen", "fused",
                      "--arch", "ViT-L/14@336px", "--resolution", "336", "--reward_arch", "ViT-L/14",
                      "--precision", "bf16", "--batch_size", "64", "--tta_steps", "1", "--sample_k", "3",
                      "--episode_group", "4", "--output", str(tmp_path)])
    torch.cuda.synchronize()
    assert r["synthetic"]["n"] == 4 and X.LAUNCH_SHAPES[("augmix", 4, 64, 256, 336)] == 1


# ---------------------------------------------------------------------------
# the AugMix kernel (csrc/augmix.cu) against its plain version
# ---------------------------------------------------------------------------

def _sources(dev, n, size, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n, 3, size, size), generator=g, device=dev, dtype=torch.uint8)


@pytest.mark.parametrize("severity", [1.0, 2.0])
def test_augmix_single_ops_match_plain(dev, severity):
    """Every op alone at the identity crop (R = S = 64): exact. Both sides
    round each product and sum alike (the kernel is built with -fmad=false);
    the warp's fused multiply-adds are fmaf in the kernel and one float64
    sum in the plain version."""
    R = 64
    ops = [op for op in range(9) for _ in range(4)]
    params = X.single_op_params(torch.Generator(device=dev).manual_seed(int(severity)), ops, R, severity, device=dev)
    shifts = X.op_shift_bounds(severity, R)
    imgs = _sources(dev, 1, R)
    basew = X.bicubic_matrix(R, R, device=dev)
    got = X.launch_views(imgs, params, basew, R, R, len(ops) + 1, shifts)
    torch.cuda.synchronize()
    want = X.augmix_views_reference(imgs, params, basew, R, R, len(ops) + 1, shifts)
    bad = [(ops[v - 1], int((got[0, v] != want[0, v]).sum())) for v in range(1, len(ops) + 1)
           if not torch.equal(got[0, v], want[0, v])]
    assert torch.equal(got[0, 0], want[0, 0]) and not bad, bad


@pytest.mark.parametrize("augmix", [True, False])
def test_augmix_pipeline_matches_plain(dev, augmix):
    """N=1, V=8, S=256, R=224. Both versions sum the crop exactly and round
    every step alike; the plain version's float64 stand-in for a fused
    multiply-add can still round twice in rare cases, so: augmix off, at most
    1 gray; augmix on (a pixel's difference travels along its chain), at
    least 99.9% of pixels equal."""
    S, R, V = 256, 224, 8
    imgs = _sources(dev, 1, S, seed=3)
    params = X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(7), 1, V, S, R,
                                                   augmix=augmix, device=dev))
    basew = X.bicubic_matrix(S, R, device=dev)
    shifts = X.op_shift_bounds(1.0, R)
    got = X.launch_views(imgs, params, basew, R, S, V, shifts)
    torch.cuda.synchronize()
    want = X.augmix_views_reference(imgs, params, basew, R, S, V, shifts)
    d = (got.int() - want.int()).abs()
    if augmix:
        assert (d == 0).float().mean().item() >= 0.999
    else:
        assert d.max().item() <= 1


def test_augmix_kernel_refuses_bad_inputs(dev):
    S, R, V = 64, 32, 2
    params = X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(0), 1, V, S, R,
                                                   device=dev))
    basew = X.bicubic_matrix(S, R, device=dev)
    shifts = X.op_shift_bounds(1.0, R)
    imgs = _sources(dev, 1, S)
    with pytest.raises(ValueError, match="CUDA tensor"):
        X.launch_views(imgs.cpu(), params, basew, R, S, V, shifts)
    with pytest.raises(TypeError, match="uint8"):
        X.launch_views(imgs.float(), params, basew, R, S, V, shifts)
    with pytest.raises(ValueError, match="source images"):
        X.launch_views(imgs[:, :, :48], params, basew, R, S, V, shifts)
    with pytest.raises(ValueError, match="param 'ops'"):
        X.launch_views(imgs, dict(params, ops=params["ops"][:, :8].contiguous()), basew, R, S, V, shifts)


def _rotate_everywhere(dev, n, v, size, severity):
    """Every augmented view at depth 3 on all chains, every step a rotate, at
    the identity crop (source = view size): the slowest CTA there is."""
    r = X.draw_view_randoms(torch.Generator(device=dev).manual_seed(3), n, v, device=dev)
    r["op_idx"][:] = 3
    r["depths"][:] = 3
    p = X.derive_view_params(r, src_size=size, resolution=size, severity=severity)
    p["rrc"][:, 1:] = torch.tensor([0.0, 0.0, size, size], device=dev)
    p["flip"][:, 1:] = 0
    return X.flatten_params(p)


def _unequal(got, want):
    return int((got != want).sum())


def test_augmix_flagship_group_matches_plain(dev):
    """A full flagship group (N=4, V=64, S=256, R=224): the count of pixels
    unequal to the plain version is the count the first design of the
    kernel gave on these inputs: 0. Two launches give the same bits."""
    S, R, V = 256, 224, 64
    imgs = _sources(dev, 4, S, seed=1234)
    params = X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(0), 4, V, S, R,
                                                   device=dev))
    basew, shifts = X.bicubic_matrix(S, R, device=dev), X.op_shift_bounds(1.0, R)
    got, again = (X.launch_views(imgs, params, basew, R, S, V, shifts) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _unequal(got, X.augmix_views_reference(imgs, params, basew, R, S, V, shifts)) == 0


@pytest.mark.parametrize("severity", [1.0, 2.0])
def test_augmix_rotate_at_every_step_matches_plain(dev, severity):
    """Rotate at all 9 steps of every view (R = S = 64): unequal pixels
    against the plain version, as the first kernel gave on these inputs: 0."""
    R, V = 64, 16
    params = _rotate_everywhere(dev, 2, V, R, severity)
    imgs = _sources(dev, 2, R, seed=4)
    basew, shifts = X.bicubic_matrix(R, R, device=dev), X.op_shift_bounds(severity, R)
    got = X.launch_views(imgs, params, basew, R, R, V, shifts)
    torch.cuda.synchronize()
    assert _unequal(got, X.augmix_views_reference(imgs, params, basew, R, R, V, shifts)) == 0


@pytest.mark.parametrize("S,R,severity", [(255, 223, 1.0), (48, 32, 2.0), (64, 32, 1.0)])
def test_augmix_odd_and_small_shapes_match_plain(dev, S, R, severity):
    """A view size that is not a multiple of the kernel's 4-pixel words (rows
    padded in shared memory, byte-wise stores), an odd source size (byte-wise
    source loads) and small views: 0 unequal pixels, as the first kernel."""
    V = 8
    imgs = _sources(dev, 2, S, seed=S)
    params = X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(7), 2, V, S, R,
                                                   severity=severity, device=dev))
    basew, shifts = X.bicubic_matrix(S, R, device=dev), X.op_shift_bounds(severity, R)
    got, again = (X.launch_views(imgs, params, basew, R, S, V, shifts) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _unequal(got, X.augmix_views_reference(imgs, params, basew, R, S, V, shifts)) == 0


@pytest.mark.parametrize("R,S", [(224, 256), (223, 255), (64, 64), (32, 48), (300, 320), (480, 512), (336, 256),
                                 (448, 256), (448, 448)])
def test_augmix_shared_bytes_is_the_sources(dev, R, S):
    """``shared_bytes`` (the wrapper's check) is the source's own layout, and
    so is where its second plane lives (the scratch's planes a CTA)."""
    assert X._lib().rlcf_augmix_shared_bytes(R, S) == X.shared_bytes(R, S)
    assert X._lib().rlcf_augmix_keep_planes(R, S) == (3 if X.large_layout(R, S) else 2)


@pytest.mark.parametrize("R", [336, 448])
@pytest.mark.parametrize("augmix,seed", [(True, 0), (True, 1), (False, 0), (False, 1)])
def test_augmix_large_views_match_plain(dev, R, augmix, seed):
    """Views at 336 and 448 px from 256 px sources (the layout with one plane
    on chip): one image, 16 views, 0 unequal pixels, two launches alike."""
    V, S = 16, 256
    imgs = _sources(dev, 1, S, seed=seed)
    params = X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(seed + R), 1, V, S, R,
                                                   augmix=augmix, device=dev))
    basew, shifts = X.bicubic_matrix(S, R, device=dev), X.op_shift_bounds(1.0, R)
    got, again = (X.launch_views(imgs, params, basew, R, S, V, shifts) for _ in range(2))
    torch.cuda.synchronize()
    assert X.large_layout(R, S) and torch.equal(got, again)
    assert _unequal(got, X.augmix_views_reference(imgs, params, basew, R, S, V, shifts)) == 0


@pytest.mark.parametrize("R", [336, 448])
@pytest.mark.parametrize("severity", [1.0, 2.0])
def test_augmix_large_single_ops_match_plain(dev, R, severity):
    """Every op, 4 views each, at the identity crop at 336 and 448 px: 0 unequal."""
    src = _sources(dev, 1, R, seed=R)
    ops = [op for op in range(9) for _ in range(4)]
    params = X.single_op_params(torch.Generator(device=dev).manual_seed(int(severity)), ops, R, severity, device=dev)
    eye, sh = X.bicubic_matrix(R, R, device=dev), X.op_shift_bounds(severity, R)
    got = X.launch_views(src, params, eye, R, R, len(ops) + 1, sh)
    torch.cuda.synchronize()
    assert _unequal(got, X.augmix_views_reference(src, params, eye, R, R, len(ops) + 1, sh)) == 0


def test_augmix_kernel_refuses_too_large_views(dev):
    S, R, V = 512, 480, 2
    params = X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(0), 1, V, S, R,
                                                   device=dev))
    with pytest.raises(ValueError, match=f"limit of {X.MAX_SHARED_BYTES} bytes"):
        X.launch_views(_sources(dev, 1, S), params, X.bicubic_matrix(S, R, device=dev), R, S, V,
                       X.op_shift_bounds(1.0, R))


def test_augmix_views_counts_one_launch(dev):
    S, R, V = 64, 32, 4
    imgs = _sources(dev, 2, S)
    X.reset_launch_counts()
    out = X.fused_views(imgs, torch.Generator(device=dev).manual_seed(0), n_views=V, resolution=R, src_size=S)
    torch.cuda.synchronize()
    assert out.shape == (2, V, 3, R, R) and out.is_cuda and X.LAUNCHES["augmix"] == 1


def _retrieval_engines(dev, direction, dtype=torch.float32, **kw):
    """One RetrievalTTA on the card and one on the CPU, same weights (drawn on
    the CPU): 64-wide heads, the vision tower at T = 65 and the text at T = 77
    (the long kernels); galleries of 6 captions or 5 images."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.models import clip as TC
    from rlcf_torch.tasks.retrieval import RetrievalTTA

    cfg = TC.ClipConfig("t", 32, 64, 2, 128, 8, 128, 1, vision_heads_override=2, text_heads_override=2)
    ecfg = EpisodeConfig(tta_steps=3, lr=1e-3, sample_k=2, adam_eps=1e-6)
    gallery = np.random.default_rng(1).normal(size=(5, 64, 64, 3)).astype(np.float32)
    out = []
    for device in (dev, torch.device("cpu")):
        move = lambda p: Po.tree_map(lambda v: v.to(device, dtype if v.dim() else v.dtype), p)
        reward = ClipReward(move(TC.init_clip_params(cfg, seed=1)), cfg, RewardConfig(sample_k=2))
        tta = RetrievalTTA(move(TC.init_clip_params(cfg, seed=0)), cfg, reward, ecfg, direction=direction, **kw)
        if direction == "i2t":
            tta.set_text_gallery(["a dog on a beach", "a red car in the rain", "two cats on a sofa", "a plate of food",
                                  "a man riding a wave", "a clock tower at night"])
        else:
            tta.set_image_gallery([gallery], [gallery])
        out.append(tta)
    return out


def _retrieval_queries(direction):
    from rlcf_torch.tokenizer import tokenize

    if direction == "i2t":
        return np.random.default_rng(2).normal(size=(3, 64, 64, 3)).astype(np.float32)
    return tokenize(["two dogs chasing three dogs in the snow", "a red car in the rain", "a man riding a wave"])


@pytest.mark.parametrize("direction,kw", [("i2t", {}), ("t2i", {}), ("t2i", {"momentum_update": True,
                                                                            "update_freq": 2, "momentum": 0.5})],
                         ids=["i2t", "t2i-factored", "t2i-momentum"])
def test_retrieval_episode_on_the_card_matches_cpu(dev, direction, kw):
    """fp32 retrieval episodes (3 queries in groups of 2, 3 steps) through the
    split-TF32 kernels against the CPU's dense plain path: each step's top-k
    equal, score rows within 2e-4 + 1e-3 relative."""
    from rlcf_torch.core import losses as Lo

    card, cpu = _retrieval_engines(dev, direction, **kw)
    records, top_k = [], Lo.top_k_indices

    def recording(x, k):
        idx = top_k(x, k)
        records.append(idx.cpu())
        return idx

    Lo.top_k_indices = recording
    try:
        A.reset_launch_counts()
        got = card.run(iter(_retrieval_queries(direction)), 3, card.gallery_feats.shape[0], group_size=2)
        torch.cuda.synchronize()
        card_topk = list(records)
        records.clear()
        want = cpu.run(iter(_retrieval_queries(direction)), 3, cpu.gallery_feats.shape[0], group_size=2)
    finally:
        Lo.top_k_indices = top_k
    assert A.LAUNCH_VARIANTS["bwd_tf32x3_long"] > 0 and A.LAUNCH_VARIANTS["tf32x3_long"] > 0
    assert len(card_topk) == len(records) == 2 * 3 and all(torch.equal(a, b) for a, b in zip(card_topk, records))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("direction", ["i2t", "t2i"])
def test_retrieval_bf16_episode_runs_the_long_backward(dev, direction):
    card, _ = _retrieval_engines(dev, direction, torch.bfloat16)
    A.reset_launch_counts()
    scores, adapted = card.adapt_queries(_retrieval_queries(direction)[:2], return_adapted=True)
    torch.cuda.synchronize()
    assert A.LAUNCH_VARIANTS["bwd_mma_long"] == 3 * (2 if direction == "i2t" else 1)
    assert scores.shape == (2, card.gallery_feats.shape[0]) and np.isfinite(scores).all()


def test_reward_text_takes_the_kernel_under_a_resnet(dev):
    """A ResNet reward's class features go through the fused forward on the
    card, and equal the CPU's plain ones (fp32)."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.models import clip as TC
    from rlcf_torch.tokenizer import tokenize

    cfg = TC.ClipConfig("rn", 64, 64, (1, 1, 1, 1), 16, None, 128, 1, text_heads_override=2)
    params = TC.init_clip_params(cfg, seed=0)
    card = ClipReward(Po.tree_map(lambda v: v.to(dev), params), cfg, RewardConfig())
    A.reset_launch_counts()
    got = card.set_class_features(tokenize(["a goldfish", "a tiger cat", "an airliner"]))
    torch.cuda.synchronize()
    want = ClipReward(params, cfg, RewardConfig()).set_class_features(tokenize(["a goldfish", "a tiger cat",
                                                                               "an airliner"]))
    assert A.LAUNCHES["fwd"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,masked", [(16, 197, 12, False), (4, 197, 12, False), (16, 257, 16, False),
                                          (4, 257, 16, False), (96, 77, 12, True), (24, 77, 12, True),
                                          (32, 50, 12, False), (32, 77, 8, True), (160, 77, 8, True)])
def test_caption_shapes_match_plain(dev, dtype, B, T, H, masked):
    """Caption TTA's forward shapes (a group of 16 images, or the fp32 runs'
    4: the ViT-B/16 feature tower, the ViT-L/14 reward's image tower and its
    text on sample_k 6 captions an image) and clipscore_eval's (ViT-B/32:
    image batches of 32 at T = 50, 32 candidates and 160 references at T = 77):
    the long kernels, one launch each."""
    g = torch.Generator(device=dev).manual_seed(B * 11 + T)
    qkv = torch.randn(B, T, 3 * H * 64, device=dev, generator=g).to(dtype)
    mask = causal_mask(T, dev) if masked else None
    A.reset_launch_counts()
    got = A.launch_fwd(qkv, mask, H, 0.125)
    torch.cuda.synchronize()
    assert dict(A.LAUNCH_VARIANTS) == {"mma_long" if dtype == torch.bfloat16 else "tf32x3_long": 1}
    torch.testing.assert_close(got.float(), A.fused_attention_reference(qkv, mask, H, 0.125).float(), **_tol(dtype))


def _caption_engines(dev):
    """One fp32 CaptionTTA on the card and one on the CPU, same weights (drawn
    on the CPU): a tiny OPT and mapper, a reward CLIP with 64-wide heads (its
    vision tower at T = 65, its text at T = 77: the long kernels), the
    synthetic OPT-layout vocabulary of 600 entries."""
    import importlib.util
    import pathlib
    import tempfile

    from rlcf_torch.core import policy as Po
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.models import clip as TC
    from rlcf_torch.models import mappers as TM
    from rlcf_torch.models import opt as TO
    from rlcf_torch.tasks import caption as Cap
    from rlcf_torch.tokenizer_gpt2 import Gpt2Tokenizer

    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    vocab = smoke.write_opt_vocab(tempfile.mkdtemp(), size=600, newline_id=None)
    cfg = TC.ClipConfig("t", 32, 64, 2, 128, 8, 128, 1, vision_heads_override=2, text_heads_override=2)
    ccfg = Cap.CaptionModelConfig(mapper=TM.MapperConfig("transformer", clip_dim=32, llm_dim=32, prefix_length=4,
                                                         clip_length=2, num_layers=1, n_heads=2),
                                  opt=TO.OPT_CONFIGS["test-tiny-opt"])
    params = Cap.init_caption_params(0, ccfg)
    params["opt"]["embed_tokens"] = params["opt"]["embed_tokens"] * 5.0
    out = []
    for device in (dev, torch.device("cpu")):
        move = lambda p: Po.tree_map(lambda v: v.to(device), p)
        reward = ClipReward(move(TC.init_clip_params(cfg, seed=1)), cfg, RewardConfig(sample_k=3))
        out.append(Cap.CaptionTTA(move(params), ccfg, reward, Gpt2Tokenizer(*vocab), tta_steps=2, lr=1e-2,
                                  sample_k=3, max_new_tokens=8))
    return out


def test_caption_episode_on_the_card_matches_cpu(dev):
    """fp32 caption TTA of a group of 2 images (2 steps) with the reward on
    the split-TF32 kernels and OPT's plain attention on the card, against the
    CPU's dense plain path: sampled captions equal, rewards within 2e-4, the
    final captions equal."""
    card, cpu = _caption_engines(dev)
    r = np.random.default_rng(0)
    images, embs = r.normal(size=(2, 64, 64, 3)).astype(np.float32), r.normal(size=(2, 32)).astype(np.float32)
    A.reset_launch_counts()
    got_trace, want_trace = [], []
    got = card.adapt_batch(images, embs, trace=got_trace)
    torch.cuda.synchronize()
    cfg = card.reward.cfg   # a launch a layer: the group's image features once, the captions' text each step
    assert A.LAUNCH_VARIANTS["tf32x3_long"] == cfg.vision_layers + card.tta_steps * cfg.text_layers
    want = cpu.adapt_batch(images, embs, trace=want_trace)
    assert got == want
    for g, w in zip(got_trace, want_trace):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seg_len", [None, 3])
def test_beam_early_exit_on_the_card_matches_cpu(dev, seg_len):
    """Beams that all end early (the EOS logit raised at every position, no
    minimum length): the card's sequences and scores equal the CPU's, and the
    early exit stops the decode well before the budget."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import opt as TO

    cfg = TO.OPT_CONFIGS["test-tiny-opt"]
    params = TO.init_opt_params(0, cfg)
    eos = 7
    row = params["embed_tokens"][eos]
    params["final_ln_b"] = 10.0 * row / row.square().sum()   # every position's EOS logit up by 10
    pre = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 3, 32)).astype(np.float32))
    card = Po.tree_map(lambda v: v.to(dev), params)
    steps, step = [], TO._decode_step

    def counting(*a, **k):
        steps.append(1)
        return step(*a, **k)

    TO._decode_step = counting
    try:
        got = TO.beam_generate(card, cfg, pre.to(dev), num_beams=3, max_new_tokens=12, min_length=0, eos_id=eos,
                               seg_len=seg_len)
    finally:
        TO._decode_step = step
    want = TO.beam_generate(params, cfg, pre, num_beams=3, max_new_tokens=12, min_length=0, eos_id=eos,
                            seg_len=seg_len)
    assert torch.equal(got[0].cpu(), want[0]) and len(steps) < 12
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap_model,normalize,llm", [("CapDec", False, "opt"), ("ClipCap", True, "opt"),
                                                     ("ClipCap", False, "gpt2")])
def test_caption_train_steps_on_the_card_match_cpu(dev, cap_model, normalize, llm):
    """Three steps of the caption trainer (warm-up 1: rates 0, lr, lr/2) on
    the card and on the CPU from the same weights, batches and noise: each
    loss within rtol 1e-5, the mapper's leaves within 3e-5 after the three
    (the CPU trainer tests' tolerances against optax)."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import gpt2 as TG
    from rlcf_torch.models import mappers as TM
    from rlcf_torch.models import opt as TO
    from rlcf_torch.tasks import caption as Cap

    mcfg = TM.MapperConfig("transformer", clip_dim=16, llm_dim=32, prefix_length=4, clip_length=2, num_layers=1,
                           n_heads=2)
    ccfg = Cap.CaptionModelConfig(mapper=mcfg, opt=TO.OPT_CONFIGS["test-tiny-opt"]) if llm == "opt" else \
        Cap.CaptionModelConfig(mapper=mcfg, llm="gpt2", gpt2=TG.GPT2_CONFIGS["test-tiny-gpt2"])
    tcfg = Cap.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=3, cap_model=cap_model, normalize_prefix=normalize)
    params = Cap.init_caption_params(0, ccfg)
    rng = np.random.default_rng(0)
    V = 96 if llm == "gpt2" else 256
    batches = [(rng.normal(size=(4, 16)).astype(np.float32), rng.integers(3, V, size=(4, 6)), np.ones((4, 10), np.int64),
                rng.normal(size=(4, 16)).astype(np.float32)) for _ in range(3)]
    out = {}
    for device in ("cpu", dev):
        init_opt, step = Cap.make_caption_trainer(ccfg, tcfg)
        mapper = Po.tree_map(lambda a: a.detach().to(device).clone().requires_grad_(True), params["mapper"])
        lm = Po.tree_map(lambda a: a.to(device), params[llm])
        opt = init_opt(mapper)
        losses = [float(step(mapper, lm, opt, *(torch.as_tensor(a, device=device) for a in b))) for b in batches]
        out[str(device)] = losses, [a.detach().cpu() for a in Po.tree_leaves(mapper)]
    (want, want_leaves), (got, got_leaves) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(got_leaves, want_leaves):
        torch.testing.assert_close(g, w, rtol=0, atol=3e-5)


def test_gpt2_forward_and_beam_on_the_card_match_cpu(dev):
    """The tiny GPT-2 (its token table 5x, peaked): fp32 logits within 1e-5,
    and the ClipCap beam search's and greedy loop's tokens, lengths and order
    equal to the CPU's."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import gpt2 as TG

    cfg = TG.GPT2_CONFIGS["test-tiny-gpt2"]
    params = TG.init_gpt2_params(0, cfg)
    params["wte"] = params["wte"] * 5.0
    card = Po.tree_map(lambda v: v.to(dev), params)
    r = np.random.default_rng(3)
    pre = torch.as_tensor((r.normal(size=(2, 3, 32)) * 0.5).astype(np.float32))
    toks = torch.as_tensor(r.integers(0, 96, size=(2, 5)))
    want = TG.forward(params, cfg, tokens=toks, prefix_embeds=pre)
    got = TG.forward(card, cfg, tokens=toks.to(dev), prefix_embeds=pre.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for i in range(2):
        beams = [TG.clipcap_beam_generate(p, cfg, pre[i].to(d), 97, beam_size=5, entry_length=12)
                 for p, d in ((params, "cpu"), (card, dev))]
        for w, g in zip(*beams):
            assert torch.equal(g.cpu(), w)
        greedy = [TG.clipcap_top_p_generate(p, cfg, pre[i].to(d), 97, entry_length=12)
                  for p, d in ((params, "cpu"), (card, dev))]
        assert torch.equal(greedy[1][0].cpu(), greedy[0][0]) and greedy[1][1] == greedy[0][1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_extraction_on_the_card_matches_cpu(dev, dtype):
    """``extract_clip_features`` with 64-wide heads (the vision tower at
    T = 65, the text at T = 77: the long kernels) on two image batches and
    five captions in batches of 2: one launch a layer a batch; within rtol
    1e-4, atol 1e-5 of the CPU's plain path in the same dtype for fp32, 2e-2
    for bf16 (the CPU's bf16 against its fp32 reaches 0.76 of 2e-2 + 2e-2
    relative); float32 arrays either way."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import clip as TC
    from rlcf_torch.tasks import caption as Cap

    cfg = TC.ClipConfig("t", 32, 64, 2, 128, 8, 128, 1, vision_heads_override=2, text_heads_override=2)
    params = TC.init_clip_params(cfg, seed=0)
    card = Po.tree_map(lambda v: v.to(dev, dtype if v.dim() else v.dtype), params)
    r = np.random.default_rng(0)
    images = [r.normal(size=(n, 64, 64, 3)).astype(np.float32) for n in (3, 2)]
    texts = ["a dog on a street", "two cats", "a red car parked near a tree", "", "a bowl of fruit"]
    A.reset_launch_counts()
    got = Cap.extract_clip_features(card, cfg, images_iter=iter(images), texts=texts, batch_size=2)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fwd"] == 2 * cfg.vision_layers + 3 * cfg.text_layers
    assert dict(A.LAUNCH_VARIANTS) == {"mma_long" if dtype == torch.bfloat16 else "tf32x3_long": A.LAUNCHES["fwd"]}
    cpu = Po.tree_map(lambda v: v.to(dtype) if v.dim() else v, params)
    want = Cap.extract_clip_features(cpu, cfg, images_iter=iter(images), texts=texts, batch_size=2)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,masked", [(16, True), (197, False), (577, False)])
def test_custom_ops_launch_the_kernels(dev, dtype, T, masked):
    """``fused_attention`` on a CUDA tensor is the op ``rlcf::fused_attention``:
    it and its gradient through ``rlcf::fused_attention_bwd`` equal the direct
    launches bit for bit, each launch counted once; ``opcheck`` holds the
    registration (fake implementation, autograd) on the card."""
    H = 12
    g = torch.Generator(device=dev).manual_seed(T)
    qkv = torch.randn(2, T, 3 * H * 64, device=dev, generator=g).to(dtype).requires_grad_(True)
    cot = torch.randn(2, T, H * 64, device=dev, generator=g).to(dtype)
    mask = causal_mask(T, dev) if masked else None
    A.reset_launch_counts()
    out = A.fused_attention(qkv, mask, H, 0.125)
    dqkv, = torch.autograd.grad(out, qkv, cot)
    assert A.LAUNCHES == {"fwd": 1, "bwd": 1}
    assert torch.equal(out, A.launch_fwd(qkv.detach(), mask, H, 0.125))
    assert torch.equal(dqkv, A.launch_bwd(qkv.detach(), cot, mask, H, 0.125))
    torch.library.opcheck(torch.ops.rlcf.fused_attention.default, (qkv, mask, H, 0.125),
                          test_utils=("test_schema", "test_faketensor", "test_autograd_registration"))


def test_exported_program_serves_on_the_card(dev, tmp_path):
    """A tiny episode exported from the card serves there, launching both
    kernels, with the eager episode's logits (fp32, 1e-5)."""
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.models import clip as C
    from rlcf_torch.tasks.classification import PromptTTAClassifier
    from rlcf_torch.utils.export import export_serving, load_exported, save_exported

    cfg = C.ClipConfig("p", 16, 32, 1, 128, 16, 128, 1, vision_heads_override=2, text_heads_override=2)
    clf = PromptTTAClassifier(C.init_clip_params(cfg, seed=0, device=dev), cfg,
                              ClipReward(C.init_clip_params(cfg, seed=1, device=dev), cfg, RewardConfig(sample_k=2)),
                              EpisodeConfig(tta_steps=2, selection_p=0.25, sample_k=2)).setup(["cat", "dog", "bird"])
    assert clf.attn == clf.text_attn == "fused"
    toks = torch.randint(0, 256, (2, 8, 4, 768), dtype=torch.uint8, generator=torch.Generator().manual_seed(0)).to(dev)
    path = str(tmp_path / "e.rlcfx")
    save_exported(path, export_serving(clf.serving_fn_tokens(), clf.serving_example_args_tokens(toks.shape)))
    A.reset_launch_counts()
    served = load_exported(path, device="cuda")(*clf.weights(), toks)
    assert A.LAUNCHES["fwd"] and A.LAUNCHES["bwd"]
    torch.testing.assert_close(served, clf.adapt_tokens(toks)[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("augmix,hard_aug,R", [(True, False, 224), (False, False, 224), (True, True, 224),
                                                (True, False, 336)])
def test_device_generator_matches_the_cpu(dev, augmix, hard_aug, R):
    """The device view generator (``data/augment.py``) on the card against
    the CPU from the same draws: 2 images of 16 views, within the CPU tests'
    tolerance against JAX (at most 0.1% of values beyond 1e-4 in normalised
    units, none beyond 3 gray levels), and no AugMix kernel launched."""
    from rlcf_torch.data import augment as TA
    from rlcf_torch.data.transforms import CLIP_STD

    imgs = torch.randint(0, 256, (2, 256, 256, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(R))
    draws = TA.draw_generator_randoms(torch.Generator().manual_seed(7), 2, 16, hard_aug=hard_aug)
    kw = dict(resolution=R, augmix=augmix, hard_aug=hard_aug)
    X.reset_launch_counts()
    card = TA.views_from_draws(imgs.to(dev), {k: v.to(dev) for k, v in draws.items()}, **kw).cpu()
    assert X.LAUNCHES["augmix"] == 0
    diff = (card - TA.views_from_draws(imgs, draws, **kw)).abs()
    assert (diff > 1e-4).double().mean() <= 1e-3
    assert float((diff * torch.as_tensor(CLIP_STD) * 255.0).max()) <= 3.0


def test_program_spans_and_device_operations_share_one_clock(dev, capsys):
    """Under the benchmark's CUDA-only ``torch.profiler`` session the recorder
    is on, and a program span around a long kernel and a synchronization
    holds the kernel's device interval and the ``cudaDeviceSynchronize``
    runtime record, with no offset fitted."""
    from torch.profiler import ProfilerActivity, profile

    from rlcf_torch.utils import profiling as P

    x = torch.randn(8192, 8192, device=dev)
    torch.cuda.synchronize()
    P.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with P.span("long"):
            x @ x
            torch.cuda.synchronize()
    span, = P.recorded()
    P.clear()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    ops = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    longest = max(ops, key=lambda e: e.end_ns() - e.start_ns())
    syncs = [e for e in events if e.name() == "cudaDeviceSynchronize"]
    with capsys.disabled():
        print(f"\nCLOCK kernel {longest.name()[:40]} {longest.end_ns() - longest.start_ns()} ns; span opens "
              f"{longest.start_ns() - span.start} ns before it, closes {span.end - longest.end_ns()} ns after; "
              f"sync records {[(e.start_ns() - span.start, span.end - e.end_ns()) for e in syncs]}")
    assert longest.end_ns() - longest.start_ns() > 1e6
    assert span.start <= longest.start_ns() <= longest.end_ns() <= span.end
    assert any(span.start <= e.start_ns() <= e.end_ns() <= span.end for e in syncs)


def test_host_syncs_are_counted_where_they_happen(dev):
    """A pageable copy to the card inside a span counts one host sync there,
    a matmul none; off, a span counts nothing and leaves the sync debug mode
    at its default."""
    from rlcf_torch.utils import profiling as P

    x = torch.randn(64, 64, device=dev)
    x @ x
    torch.cuda.synchronize()
    P.clear()
    P.enable()
    try:
        with P.span("copy"):
            torch.as_tensor(np.ones(3), device="cuda")
        with P.span("matmul"):
            x @ x
        assert torch.cuda.get_sync_debug_mode() == 0
    finally:
        P.disable()
    assert {s.name: s.counts.get("host_syncs", 0) for s in P.recorded()} == {"copy": 1, "matmul": 0}
    P.clear()
    with P.span("off"):
        assert torch.cuda.get_sync_debug_mode() == 0
        torch.as_tensor(np.ones(3), device="cuda")
    assert P.recorded() == [] and torch.cuda.get_sync_debug_mode() == 0
