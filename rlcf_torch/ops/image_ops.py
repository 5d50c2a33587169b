"""Image resizing on the device (the part of ``rlcf_tpu/ops/image_ops.py``
that the reward towers and the zero-shot ensemble need; the AugMix ops of
that file come with ROADMAP A16).

``resize_bicubic_align_corners`` is what ``torch.nn.functional.interpolate(
mode="bicubic", align_corners=True)`` computes (`TPT/clip_reward.py:130-137`),
written as the JAX package writes it: two interpolation matrices with the
a = -0.75 cubic kernel and border-clamped taps, each applied as one matrix
product with fp32 accumulation, so that it equals the JAX function op for op.
"""

from __future__ import annotations

import torch


def _torch_cubic_weight(x, a: float = -0.75):
    """PyTorch's bicubic kernel (a = -0.75; PIL and JAX use -0.5)."""
    ax = x.abs()
    w1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    w2 = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return torch.where(ax < 1.0, w1, torch.where(ax < 2.0, w2, torch.zeros_like(ax)))


def _align_corners_cubic_matrix(src: int, dst: int, dtype=torch.float32, device="cpu"):
    """[dst, src] bicubic interpolation matrix with aligned corners: the four
    taps' weights from each output's fractional offset, each tap's weight
    added onto its border-clamped source index."""
    k = (src - 1) / max(dst - 1, 1)
    centers = torch.arange(dst, dtype=dtype, device=device) * k   # input coordinates
    base = torch.floor(centers)
    frac = centers - base
    src_idx = torch.arange(src, device=device)
    w = torch.zeros((dst, src), dtype=dtype, device=device)
    for t in range(-1, 3):
        tap = torch.clamp(base.long() + t, 0, src - 1)
        w = w + _torch_cubic_weight(frac - t)[:, None] * (tap[:, None] == src_idx[None, :]).to(dtype)
    return w


def resize_bicubic_align_corners(images, out_size: int):
    """NHWC images [B, H, W, C] -> [B, out_size, out_size, C], bicubic with
    aligned corners and no antialiasing, in the images' dtype."""
    B, H, W, C = images.shape
    wy = _align_corners_cubic_matrix(H, out_size, images.dtype, images.device)
    wx = _align_corners_cubic_matrix(W, out_size, images.dtype, images.device)
    tmp = torch.einsum("oh,bhwc->bowc", wy.float(), images.float())
    return torch.einsum("pw,bowc->bopc", wx.float(), tmp).to(images.dtype)
