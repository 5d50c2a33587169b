"""The fused attention forward above T = 257 (ViT-L/14 at 336 px: T = 577),
on the CPU: which kernel a ``(T, dtype)`` runs on the card, the backward's
routing at T = 258, the fp32 kernel's split-TF32 arithmetic emulated in PyTorch at
T = 577, and the plain version (what the card's kernels are held to) against
the JAX package's Pallas kernel in interpret mode at a T above 257 (the
backward there: tests/test_torch_attention_xlong_bwd.py).

Tolerances: fp32 1e-5 absolute + 1e-5 relative (the forward kernels' own,
``chip_smoke.py`` TOL); bf16 one rounding step of the output (2**-7
relative and absolute).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlcf_tpu.ops.pallas_attention as PA
from rlcf_tpu.models import layers as JL
from rlcf_torch.models import layers as TL
from rlcf_torch.ops import attention as TA

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.125  # 1 / sqrt(64)


@pytest.mark.parametrize("T", [258, 384, 577])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma_xlong"), (torch.float32, "tf32x3_long")])
def test_forward_variant_above_257(T, dtype, want):
    """bf16: the one-sweep kernel; fp32: the streamed kernel, at any T."""
    assert TA.forward_variant(T, dtype) == want


@pytest.mark.parametrize("T", [0, 578])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_variant_refuses_outside_1_to_577(T, dtype):
    with pytest.raises(ValueError, match="577"):
        TA.forward_variant(T, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_still_refuses_258(dtype):
    """The backward at T = 258 is no longer refused: past the long kernels
    (T <= 257) the xlong ones take it, up to the forward's 577; T = 578 is
    refused (tests/test_torch_attention_xlong_bwd.py covers the new range)."""
    assert TA.backward_variant(257, dtype) in ("mma_long", "tf32x3_long")
    assert TA.backward_variant(258, dtype) in ("mma_xlong", "tf32x3_xlong")
    with pytest.raises(ValueError, match="577"):
        TA.backward_variant(578, dtype)


def test_wrapper_refuses_a_cpu_tensor_at_577():
    """The wrapper never gives way to the plain version, at the new lengths too."""
    TA.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.launch_fwd(torch.zeros(1, 577, 192, dtype=torch.bfloat16), None, 1, SCALE)
    assert TA.LAUNCHES == {"fwd": 0, "bwd": 0} and not TA.LAUNCH_VARIANTS


@pytest.mark.parametrize("masked", [False, True])
def test_tf32x3_within_fp32_tolerance_at_577(masked):
    """The fp32 kernel's 3xTF32 products at the ensemble reward's length (a
    full-width head, D=64, 2 heads) against the plain fp32 version."""
    qkv = torch.from_numpy(np.random.default_rng(577).normal(size=(1, 577, 3 * 2 * 64)).astype(np.float32))
    mask = TL.causal_mask(577) if masked else None
    torch.testing.assert_close(TA.tf32_reference(qkv, mask, 2, SCALE),
                               TA.fused_attention_reference(qkv, mask, 2, SCALE), **FWD_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [321, 577])
def test_plain_version_matches_pallas_interpret_above_257(T, masked):
    """T = 321 (five chunks of 64 keys and one key over) and 577, one
    sequence, one full-width head: the Pallas forward in interpret mode
    against the plain version, fp32 and bf16."""
    qkv = np.random.default_rng(T + masked).normal(size=(1, T, 3 * 64)).astype(np.float32)
    jm, tm = (JL.causal_mask(T), TL.causal_mask(T)) if masked else (None, None)
    want = PA.fused_attention(jnp.asarray(qkv), jm, 1, SCALE, True)
    got = TA.fused_attention_reference(torch.from_numpy(qkv), tm, 1, SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    want16 = PA.fused_attention(jnp.asarray(qkv, jnp.bfloat16), jm, 1, SCALE, True)
    got16 = TA.fused_attention_reference(torch.from_numpy(qkv).to(torch.bfloat16), tm, 1, SCALE)
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16.astype(jnp.float32)), rtol=2**-7, atol=2**-7)
