"""The CUDA attention kernels against their plain PyTorch version, on the
card (marked ``cuda``; they skip where there is no card).

Run on a machine with an H100 (which has no JAX, hence no conftest):
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q``.
Tolerances: fp32 forward 1e-5 and backward 1e-4 (summation order); bf16 one
rounding step of the output on top of that (2**-7 relative, 1e-2 absolute).
"""

import pytest
import torch

from rlcf_torch.models.layers import causal_mask
from rlcf_torch.ops import attention as A

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
        A.launch_fwd(torch.randn(1, 258, 3 * 64, device=dev), None, 1, 0.125)  # T > 257
    with pytest.raises(TypeError):
        A.launch_fwd(torch.randn(1, 8, 3 * 64, device=dev).half(), None, 1, 0.125)
