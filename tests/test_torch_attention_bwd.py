"""The routing of the port's fused attention backward and its plain version,
on the CPU: which kernel a ``(T, dtype)`` runs on the card, what the wrapper
refuses, and the plain backward (the CPU path, and what the card's kernels are
held to) against the VJP of the JAX package's Pallas kernel in interpret mode
at the head dimension and the tile edges of the tensor-core kernel.

Tolerances: fp32 gradients 1e-4 (same math, different summation order); bf16
one rounding step of the output (2**-7 relative and absolute).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlcf_tpu.ops.pallas_attention as PA
from rlcf_tpu.models import layers as JL
from rlcf_torch.models import layers as TL
from rlcf_torch.ops import attention as TA
from rlcf_torch.ops import cuda_build


@pytest.mark.parametrize("T,dtype,want", [
    (1, torch.bfloat16, "mma_short"), (16, torch.bfloat16, "mma_short"), (17, torch.bfloat16, "mma_long"),
    (257, torch.bfloat16, "mma_long"), (1, torch.float32, "tf32x6_short"), (16, torch.float32, "tf32x6_short"),
    (17, torch.float32, "tf32x3_long"), (257, torch.float32, "tf32x3_long"), (258, torch.bfloat16, "mma_xlong"),
    (577, torch.float32, "tf32x3_xlong"),
])
def test_backward_variant(T, dtype, want):
    assert TA.backward_variant(T, dtype) == want


@pytest.mark.parametrize("T,dtype,error", [(0, torch.bfloat16, ValueError), (578, torch.bfloat16, ValueError),
                                           (578, torch.float32, ValueError), (16, torch.float16, TypeError)])
def test_backward_variant_refuses(T, dtype, error):
    """The backward takes 1 <= T <= 577, as the forward; a longer sequence is
    refused naming the kernels whose limit it is."""
    with pytest.raises(error) as exc:
        TA.backward_variant(T, dtype)
    assert T <= TA.MAX_T_BWD or "xlong backward kernels' longest sequence" in str(exc.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_bwd_on_a_cpu_tensor_raises(dtype):
    """The wrapper never gives way to the plain version: a CPU tensor is refused."""
    TA.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.launch_bwd(torch.zeros(1, 16, 192, dtype=dtype), torch.zeros(1, 16, 64, dtype=dtype), None, 1, 0.125)
    assert TA.LAUNCHES == {"fwd": 0, "bwd": 0} and not TA.LAUNCH_VARIANTS


def test_cpu_backward_counts_no_variant():
    TA.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 17, 192)).astype(np.float32)).requires_grad_(True)
    TA.fused_attention(x, TL.causal_mask(17), 1, 0.125).sum().backward()
    assert TA.LAUNCHES == {"fwd": 0, "bwd": 0} and not TA.LAUNCH_VARIANTS and not TA.LAUNCH_SHAPES


def _inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, 3 * H * 64)).astype(np.float32),
            rng.normal(size=(B, T, H * 64)).astype(np.float32))


def _masks(T, masked):
    return (JL.causal_mask(T), TL.causal_mask(T)) if masked else (None, None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [16, 17, 33])
def test_plain_backward_matches_pallas_vjp_at_tile_edges(T, masked):
    """Head dimension 64; one full 16-row tile, a tile and a row, two and a row."""
    qkv, cot = _inputs(300 + T, 2, T, 2)
    jm, tm = _masks(T, masked)
    _, vjp = jax.vjp(lambda t: PA.fused_attention(t, jm, 2, 0.125, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(cot))
    got = TA.fused_attention_reference_bwd(torch.from_numpy(qkv), torch.from_numpy(cot), tm, 2, 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["key_out", "dead_row", "block_diagonal_dead_row"])
def test_plain_backward_matches_pallas_vjp_under_a_general_mask(kind):
    """The masks the card's kernel is held to the plain version on: -inf on
    one key for every query, on whole query rows (their softmax is uniform),
    and on the 64 x 64 tiles off the diagonal as well."""
    T = 70
    qkv, cot = _inputs(500, 2, T, 2)
    mask = np.random.default_rng(7).normal(size=(T, T)).astype(np.float32)
    block = np.arange(T) // 64
    if kind == "key_out":
        mask[:, 3] = -np.inf
    if kind.startswith("block_diagonal"):
        mask[block[:, None] != block[None, :]] = -np.inf
    if kind.endswith("dead_row"):
        mask[[T // 3, T - 1]] = -np.inf
    _, vjp = jax.vjp(lambda t: PA.fused_attention(t, jnp.asarray(mask), 2, 0.125, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(cot))
    got = TA.fused_attention_reference_bwd(torch.from_numpy(qkv), torch.from_numpy(cot), torch.from_numpy(mask), 2,
                                           0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [16, 24])
def test_plain_backward_bf16_within_bf16_rounding(T):
    qkv, cot = _inputs(400 + T, 2, T, 2)
    jm, tm = _masks(T, True)
    _, vjp = jax.vjp(lambda t: PA.fused_attention(t, jm, 2, 0.125, True), jnp.asarray(qkv, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    got = TA.fused_attention_reference_bwd(torch.from_numpy(qkv).to(torch.bfloat16),
                                           torch.from_numpy(cot).to(torch.bfloat16), tm, 2, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2**-7, atol=2**-7)


def test_build_is_redone_when_a_header_is_newer(tmp_path, monkeypatch):
    """``cuda_build.build`` keeps a library only while it is newer than its
    source and the headers the source includes."""
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    (csrc / "k.cu").write_text("// source\n")
    (csrc / "k.cuh").write_text("// header\n")
    lib = out / "libk.so"
    lib.write_text("built")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(out))

    def no_compiler():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "nvcc", no_compiler)
    os.utime(csrc / "k.cu", (1000, 1000))
    os.utime(csrc / "k.cuh", (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert cuda_build.build("k.cu", "k", deps=("k.cuh",)) == str(lib)
    os.utime(csrc / "k.cuh", (3000, 3000))
    assert cuda_build.build("k.cu", "k") == str(lib)   # the header is not this build's
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("k.cu", "k", deps=("k.cuh",))
