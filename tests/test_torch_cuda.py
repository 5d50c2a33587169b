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
