"""PIL-semantic image operations on the tensor's device: the port of
``rlcf_tpu/ops/image_ops.py``.

The 9 AugMix base augmentations the reference applies with PIL on the host
(`TPT/data/augmix_ops.py:56-148`): autocontrast, equalize, posterize, rotate,
solarize, shear_x/y, translate_x/y, plus the crop resize and the aligned-corner
bicubic resize of the reward towers. PIL's integer LUT semantics (truncation in
autocontrast, the equalize step LUT) are reproduced exactly on uint8-valued
float images; geometric ops use inverse affine maps with bilinear sampling and
black fill (``Image.transform(..., AFFINE, BILINEAR)`` / ``Image.rotate``).

All single-image functions take and return float32 images in [0, 255] of
shape [H, W, C]. Histograms are counted with ``scatter_add_`` on integers,
not with the JAX package's one-hot compare-and-sum (which would materialise
``[pixels, 256]``).

Where a later ``round`` or ``floor`` depends on the last bit, the arithmetic
is that of the JAX package's XLA CPU program for parameters passed as
arguments: XLA contracts a product feeding an addition into one fused
multiply-add (``fma``), and divides by a constant as a multiplication by its
float32 reciprocal.
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """float32 fused multiply-add ``a·b + c`` rounded once: the product of two
    float32 values is exact in float64, so one float64 sum and one cast give
    it (bar a double rounding, which needs more than 53 bits between the
    terms' ends), on every device."""
    return (a.double() * b.double() + c.double()).float()


def _per_channel_lut(img, lut):
    """Per-channel 256-entry LUTs ``lut [C, 256]`` applied to an integer-valued
    float image ``[H, W, C]`` (values clipped to [0, 255])."""
    H, W, C = img.shape
    idx = torch.clamp(img, 0, 255).long().reshape(-1, C).T          # [C, HW]
    return torch.gather(lut.to(img.dtype), 1, idx).T.reshape(H, W, C)


def autocontrast(img):
    """Per-channel min/max stretch with PIL's truncating LUT (cutoff=0); the
    small eps keeps integer-exact multiples from flooring down."""
    x = torch.round(img)
    lo = x.amin(dim=(0, 1))
    hi = x.amax(dim=(0, 1))
    out = torch.clamp(torch.floor((x - lo) * 255.0 / torch.clamp(hi - lo, min=1.0) + 1e-3), 0, 255)
    return torch.where(hi <= lo, x, out)


def histograms(idx, bins: int = 256):
    """Integer histograms of the rows of ``idx [R, P]`` (values in
    [0, bins)) -> ``[R, bins]`` int64, by one ``scatter_add_``."""
    hist = torch.zeros((idx.shape[0], bins), dtype=torch.int64, device=idx.device)
    return hist.scatter_add_(1, idx, torch.ones_like(idx))


def equalize_lut_rows(hist):
    """PIL's equalize step LUTs ``[R, 256]`` (int64) from histograms ``[R, 256]``:
    lut[i] = (step//2 + cumsum_{j<i} h[j]) // step, step = (n_pixels - h[last
    nonzero bin]) // 255; the identity where a row has one level or step 0."""
    ids = torch.arange(256, device=hist.device).expand_as(hist)
    nonzero = hist > 0
    last_nz = torch.where(nonzero, ids, -1).amax(dim=1, keepdim=True).clamp(min=0)
    step = (hist.sum(dim=1, keepdim=True) - torch.gather(hist, 1, last_nz)) // 255
    cum = torch.cumsum(hist, dim=1) - hist                               # exclusive
    lut = torch.clamp((step // 2 + cum) // step.clamp(min=1), 0, 255)
    return torch.where((nonzero.sum(dim=1, keepdim=True) <= 1) | (step == 0), ids, lut)


def equalize_luts(img):
    """Per-channel PIL equalize LUTs ``[C, 256]`` in the image's dtype."""
    C = img.shape[-1]
    idx = torch.clamp(torch.round(img), 0, 255).long().reshape(-1, C).T
    return equalize_lut_rows(histograms(idx)).to(img.dtype)


def equalize(img):
    """Per-channel histogram equalization with PIL's step LUT (ImageOps.equalize)."""
    return _per_channel_lut(torch.round(img), equalize_luts(img))


def posterize(img, bits):
    """Keep the top ``bits`` bits per channel (PIL ImageOps.posterize)."""
    mask = (0xFF00 >> bits) & 0xFF
    return (torch.round(img).to(torch.int32) & mask).to(img.dtype)


def solarize(img, threshold):
    """Invert pixels >= threshold (PIL ImageOps.solarize)."""
    x = torch.round(img)
    return torch.where(x >= threshold, 255.0 - x, x)


def shift_blend(x, delta, frac, bound: int, axis: int):
    """1-D bilinear resample along ``axis`` with a per-pixel integer shift and
    fraction: ``(1-frac)·x[i+delta] + frac·x[i+delta+1]``, taps outside the
    image or past the window ``[-bound, bound]`` black. ``delta`` (integer,
    already within the window) and ``frac`` broadcast against ``x``.

    The JAX package sums one ``roll`` per tap of the window; only the two
    taps above carry weight, so they are gathered directly. XLA contracts
    each tap's product into the running sum, so the sum is
    ``fma(frac, x[i+delta+1], (1-frac)·x[i+delta])``, kept here; the window's
    first two taps are both bare products, and XLA fuses the first of them
    (``delta == -bound``: ``fma(1-frac, x[i+delta], frac·x[i+delta+1])``)."""
    size = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = size
    pos = torch.arange(size, device=x.device).reshape(shape)
    delta = delta.long()
    ia, ib = pos + delta, pos + delta + 1
    ok_a = (ia >= 0) & (ia < size) & (delta >= -bound) & (delta <= bound)
    ok_b = (ib >= 0) & (ib < size) & (delta >= -bound - 1) & (delta < bound)
    take = lambda i: torch.gather(x, axis, i.clamp(0, size - 1).expand_as(x))
    wa = torch.where(ok_a, 1.0 - frac, 0.0)
    wb = torch.where(ok_b, frac, 0.0)
    xa, xb = take(ia), take(ib)
    return torch.where(delta == -bound, fma(wa, xa, wb * xb), fma(wb, xb, wa * xa))


_shift_blend = shift_blend   # an [H, W, C] image along axis 0 or 1


def _affine_coords(matrix, H: int, W: int, dtype=torch.float32, device="cpu"):
    """Sampling coordinates of a 6-tuple matrix with PIL's half-pixel centers
    (in = M @ (out + 0.5), sampled at in - 0.5), as XLA's program computes
    them for a matrix it takes as an argument: ``(in_x, in_y, in_y_fused)``
    ``[H, W]``, the last with its x term's product fused into the sum (the
    vertical fraction's)."""
    a, b, c, d, e, f = (torch.as_tensor(m, dtype=dtype, device=device).expand(H, W) for m in matrix)
    yy = (torch.arange(H, dtype=dtype, device=device)[:, None] + 0.5).expand(H, W)
    xx = (torch.arange(W, dtype=dtype, device=device)[None, :] + 0.5).expand(H, W)
    return (a * xx + b * yy) + c - 0.5, (d * xx + e * yy) + f - 0.5, fma(d, xx, e * yy) + f - 0.5


def affine_transform_fast(img, matrix, max_shift: int = 12):
    """Small-displacement affine warp as two separable shift-blend passes
    (along W, then along H); displacements beyond ``max_shift`` clamp.
    Exact bilinear for shears and translates; a rotation's two passes
    commute up to |b|·|dy| of sampling position."""
    H, W, _ = img.shape
    in_x, in_y, in_y_fused = _affine_coords(matrix, H, W, img.dtype, img.device)
    pos_x = torch.arange(W, device=img.device)[None, :]
    pos_y = torch.arange(H, device=img.device)[:, None]
    x0, y0 = torch.floor(in_x), torch.floor(in_y)
    dx = torch.clamp(x0.long() - pos_x, -max_shift, max_shift)[..., None]
    h = _shift_blend(img, dx, (in_x - x0)[..., None], max_shift, axis=1)
    dy = torch.clamp(y0.long() - pos_y, -max_shift, max_shift)[..., None]
    return _shift_blend(h, dy, (in_y_fused - torch.floor(in_y_fused))[..., None], max_shift, axis=0)


def affine_transform(img, matrix):
    """PIL ``Image.transform(size, AFFINE, matrix, BILINEAR)``, exact:
    output (x, y) samples input (a x + b y + c, d x + e y + f), black fill."""
    H, W, C = img.shape
    in_x, in_y, in_y_fused = (t.reshape(-1) for t in _affine_coords(matrix, H, W, img.dtype, img.device))
    y0, x0 = torch.floor(in_y), torch.floor(in_x)
    wy, wx = (in_y_fused - torch.floor(in_y_fused))[None, :], (in_x - x0)[None, :]
    y0, x0 = y0.long(), x0.long()
    img_cf = img.permute(2, 0, 1).reshape(C, H * W)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        return img_cf[:, flat] * valid[None, :].to(img.dtype)

    lerp = lambda p, q, t: fma(p, (1 - t).expand_as(p), q * t)
    top = lerp(gather(y0, x0), gather(y0, x0 + 1), wx)
    bot = lerp(gather(y0 + 1, x0), gather(y0 + 1, x0 + 1), wx)
    return lerp(top, bot, wy).reshape(C, H, W).permute(1, 2, 0)


def rotate(img, degrees):
    """PIL ``Image.rotate(degrees, BILINEAR)``: counterclockwise about the
    center, same output size, black fill."""
    H, W, _ = img.shape
    theta = -torch.deg2rad(torch.as_tensor(degrees, dtype=torch.float32, device=img.device))
    cos, sin = torch.cos(theta.double()).float(), torch.sin(theta.double()).float()
    cx, cy = W / 2.0, H / 2.0
    a, b, d, e = cos, sin, -sin, cos
    return affine_transform(img, (a, b, (cx - cx * a) - cy * b, d, e, (cy - cx * d) - cy * e))


def shear_x(img, level):
    return affine_transform(img, (1.0, level, 0.0, 0.0, 1.0, 0.0))


def shear_y(img, level):
    return affine_transform(img, (1.0, 0.0, 0.0, level, 1.0, 0.0))


def translate_x(img, pixels):
    return affine_transform(img, (1.0, 0.0, pixels, 0.0, 1.0, 0.0))


def translate_y(img, pixels):
    return affine_transform(img, (1.0, 0.0, 0.0, 0.0, 1.0, pixels))


def hflip(img):
    return torch.flip(img, dims=(1,))


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
    """NHWC images [B, H, W, C] -> [B, out_size, out_size, C]: what
    ``torch.nn.functional.interpolate(mode="bicubic", align_corners=True)``
    computes (`TPT/clip_reward.py:130-137`), written as the JAX package writes
    it: two interpolation matrices with the a = -0.75 kernel and
    border-clamped taps, each one matrix product with fp32 accumulation."""
    B, H, W, C = images.shape
    wy = _align_corners_cubic_matrix(H, out_size, images.dtype, images.device)
    wx = _align_corners_cubic_matrix(W, out_size, images.dtype, images.device)
    tmp = torch.einsum("oh,bhwc->bowc", wy.float(), images.float())
    return torch.einsum("pw,bowc->bopc", wx.float(), tmp).to(images.dtype)


def _resize_weights(src_size: int, out_size: int, start, length, dtype=torch.float32, device="cpu"):
    """Antialiased bilinear (triangle-kernel) interpolation matrix [out, src]:
    output center o+0.5 maps to input start + (o+0.5)·scale, the kernel's
    support stretched by the downscale factor, rows normalised to 1."""
    start = torch.as_tensor(start, dtype=dtype, device=device)
    length = torch.as_tensor(length, dtype=dtype, device=device)
    scale = length * (1.0 / out_size)
    centers = start + (torch.arange(out_size, dtype=dtype, device=device) + 0.5) * scale
    src = torch.arange(src_size, dtype=dtype, device=device) + 0.5
    inv = 1.0 / torch.clamp(scale, min=1.0)
    w = torch.clamp(1.0 - torch.abs((src[None, :] - centers[:, None]) * inv), min=0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)


def crop_and_resize(img, top, left, height, width, out_size: int):
    """Crop the (possibly fractional) box, then resize it to
    ``[out_size, out_size]`` with antialiased bilinear weights (the
    torchvision/PIL box resize): two interpolation-matrix products."""
    H, W, C = img.shape
    wy = _resize_weights(H, out_size, top, height, img.dtype, img.device)
    wx = _resize_weights(W, out_size, left, width, img.dtype, img.device)
    tmp = torch.einsum("oh,hwc->owc", wy, img.float())
    return torch.einsum("pw,owc->opc", wx, tmp).to(img.dtype)
