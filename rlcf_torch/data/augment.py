"""The device view generator: the port of ``rlcf_tpu/data/augment.py``.

One test image -> ``n_views`` CLIP-normalised views, as PyTorch ops on the
image's device. View 0 is the bicubic resize of the canonical square
(`datautils.py:125-128`); views 1.. are a RandomResizedCrop + HFlip
(``hard_aug`` adds the BYOL jitter / gray / blur recipe with crop_min 0.2,
`datautils.py:76-91`), then, with ``augmix``, 3 AugMix chains of depth 1-3
over the 9 PIL ops (every op rounds its output) mixed with Dirichlet weights
and a Beta(1, 1) ``m`` in normalised space.

The sampler is split in two. The draws are made with an explicit
``torch.Generator``: ``draw_rrc`` (the crop's), ``ops/augmix.py::
draw_view_randoms`` (every draw of the JAX split tree ``k_crop, k_flip,
k_chain, k_m, k_w``, shared with ``--viewgen fused``) and
``draw_hard_aug_randoms`` (``k_hard``'s). The rest is a deterministic function
of those draws (``rrc_boxes``, ``views_from_draws``), so that fed the numbers
JAX drew it gives JAX's views.

Where a ``round`` or ``floor`` decides the result, the arithmetic is the JAX
package's XLA CPU program's: its products feeding a sum are fused
multiply-adds (``image_ops.fma``), its crop products sum each dot product in
two accumulators (even and odd source index, each a chain of fused
multiply-adds, ``_banded_product``), its row sums add in its order
(``_row_sum``), and it divides by a constant as a multiplication by the
constant's float32 reciprocal, folded into the constants before it
(``_const``). float64 carries the fused multiply-adds on every device, so
the card and the CPU give the same bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import image_ops as ops
from .transforms import CLIP_MEAN, CLIP_STD

N_AUGMIX_OPS = 9
MAX_CHAIN_DEPTH = 3
N_CHAINS = 3
WARP_MAX_SHIFT = 12
RRC_ATTEMPTS = 10
RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)
HARD_AUG_CROP_MIN = 0.2
WARP_OPS = (3, 5, 6, 7, 8)   # rotate, shear x/y, translate x/y


def _const(*factors) -> float:
    """The float32 product of float32 constants, folded left to right as XLA
    folds ``x * a / b`` into ``x * (f32(a) * f32(1/b))``."""
    out = np.float32(1.0)
    for f in factors:
        out = np.float32(out * np.float32(f))
    return float(out)


def _int_param(level, maxval):
    return torch.floor(level * _const(maxval, 0.1))


def _float_param(level, maxval):
    return level * _const(maxval, 0.1)


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------


def draw_rrc(generator, shape, crop_min: float, ratio=RRC_RATIO, device="cpu"):
    """Random draws of ``rrc_boxes`` for boxes of leading shape ``shape``:
    ``ta`` (area fraction, U[crop_min, 1)), ``lr`` (log aspect,
    U[log r0, log r1))  with a trailing attempts axis, and ``u_top``, ``u_left``."""
    shape = tuple(shape)
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    return {
        "ta": u(*shape, RRC_ATTEMPTS) * (1.0 - crop_min) + crop_min,
        "lr": u(*shape, RRC_ATTEMPTS) * (hi - lo) + lo,
        "u_top": u(*shape),
        "u_left": u(*shape),
    }


def draw_hard_aug_randoms(generator, n_images: int, n_views: int, device="cpu"):
    """The draws of ``_hard_aug_batched`` (JAX's ``k_hard`` keys 0-7; key 8 is
    drawn there and never used), each ``[N, n_views - 1]``: the jitter, gray
    and blur coins, brightness ``b`` and contrast ``c`` in U[0.6, 1.4),
    saturation ``s`` in U[0.8, 1.2), hue ``h`` in U[-0.1, 0.1) turns, blur
    ``sigma`` in U[0.1, 2)."""
    u = lambda lo=0.0, hi=1.0: torch.rand((n_images, n_views - 1), generator=generator, device=device) * (hi - lo) + lo
    return {"u_jitter": u(), "b": u(0.6, 1.4), "c": u(0.6, 1.4), "s": u(0.8, 1.2), "h": u(-0.1, 0.1),
            "u_gray": u(), "u_blur": u(), "sigma": u(0.1, 2.0)}


def draw_generator_randoms(generator, n_images: int, n_views: int, crop_min: float = 0.08, hard_aug: bool = False,
                           device="cpu"):
    """Every draw of ``views_from_draws`` for a group of ``n_images``, from one
    generator in one fixed order: ``draw_view_randoms`` (crop_min raised to
    0.2 under ``hard_aug``), then ``draw_hard_aug_randoms``."""
    from ..ops.augmix import draw_view_randoms

    if hard_aug:
        crop_min = max(crop_min, HARD_AUG_CROP_MIN)
    draws = draw_view_randoms(generator, n_images, n_views, crop_min, device=device)
    if hard_aug:
        draws.update(draw_hard_aug_randoms(generator, n_images, n_views, device=device))
    return draws


# ---------------------------------------------------------------------------
# Batched RandomResizedCrop (torchvision sampler + two banded products)
# ---------------------------------------------------------------------------


def rrc_boxes(ta, lr, u_top, u_left, H: int, W: int, ratio=RRC_RATIO):
    """Crop boxes (top, left, h, w), float32 and integer-valued, from the
    draws of ``draw_rrc``: the first of the attempts that fits, else the
    clamped-aspect center crop (``rlcf_tpu/data/augment.py::_rrc_boxes``)."""
    area = H * W
    t = ta * area
    aspect = torch.exp(lr)
    ws = torch.floor(torch.sqrt(t * aspect))
    hs = torch.floor(torch.sqrt(t / aspect))
    valid = (ws <= W) & (hs <= H) & (ws > 0) & (hs > 0)
    first = valid.to(torch.uint8).argmax(dim=-1, keepdim=True)  # first fitting attempt (0 if none)
    any_valid = valid.any(dim=-1)
    w = torch.gather(ws, -1, first)[..., 0]
    h = torch.gather(hs, -1, first)[..., 0]
    top = torch.floor(u_top * (H - h + 1))
    left = torch.floor(u_left * (W - w + 1))
    in_ratio = W / H
    fb_w = float(W) if in_ratio < ratio[0] else (float(round(H * ratio[1])) if in_ratio > ratio[1] else float(W))
    fb_h = float(round(W / ratio[0])) if in_ratio < ratio[0] else float(H)
    fb_top, fb_left = float(round((H - fb_h) / 2.0)), float(round((W - fb_w) / 2.0))
    pick = lambda a, b: torch.where(any_valid, a, torch.full_like(a, b))
    return pick(top, fb_top), pick(left, fb_left), pick(h, fb_h), pick(w, fb_w)


def _batched_resize_weights(src_size: int, out_size: int, start, length, dtype=torch.float32):
    """``[n, out, src]`` triangle-kernel interpolation matrices (antialiased)
    of the boxes' ``start`` and ``length`` ``[n]``."""
    scale = length.to(dtype) * (1.0 / out_size)
    o = torch.arange(out_size, dtype=dtype, device=start.device) + 0.5
    centers = ops.fma(o[None, :], scale[:, None], start.to(dtype)[:, None])
    src = torch.arange(src_size, dtype=dtype, device=start.device)[None, None, :] + 0.5
    inv = 1.0 / torch.clamp(scale, min=1.0)
    w = torch.clamp(1.0 - torch.abs((src - centers[..., None]) * inv[:, None, None]), min=0.0)
    return w / torch.clamp(_row_sum(w), min=1e-12)


def _row_sum(w, block: int = 32, lanes: int = 8):
    """``w.sum(-1, keepdim=True)`` in the order XLA's CPU program adds it:
    a row of at most ``block`` entries in ``lanes`` lanes (index mod lanes,
    each in index order), then the lanes pairwise; a longer row (split by
    XLA's tree rewrite) in runs of ``block`` entries, each in index order,
    then the runs' sums in order."""
    K = w.shape[-1]
    width = lanes if K <= block else block
    pad = (-K) % width
    runs = torch.nn.functional.pad(w, (0, pad)).reshape(w.shape[:-1] + ((K + pad) // width, width))
    if K <= block:
        acc = runs[..., 0, :]
        for i in range(1, runs.shape[-2]):
            acc = acc + runs[..., i, :]
        while acc.shape[-1] > 1:
            half = acc.shape[-1] // 2
            acc = acc[..., :half] + acc[..., half:]
        return acc
    part = runs[..., 0]
    for i in range(1, block):
        part = part + runs[..., i]
    total = part[..., :1]
    for i in range(1, part.shape[-1]):
        total = total + part[..., i:i + 1]
    return total


def _banded_product(wt, x):
    """``out[..., c, o, m] = sum_k wt[..., o, k] · x[..., c, k, m]`` for
    banded weights ``wt [n, O, K]`` (a crop's: at most ``2·max(K/O, 1) + 1``
    nonzero taps from the first) and ``x [n or 1, C, K, M]``, summed as XLA's
    CPU dot sums: the even and the odd taps each in a chain of fused
    multiply-adds in index order, then the two added."""
    n, O, K = wt.shape
    taps = int(2 * max(K / O, 1.0)) + 1
    k0 = (wt > 0).to(torch.uint8).argmax(dim=-1)                           # [n, O] first nonzero tap
    acc = [x.new_zeros((n, x.shape[1], O, x.shape[3])) for _ in range(2)]   # the even and the odd taps
    for t in range(taps):
        k = k0 + t
        kc = k.clamp(max=K - 1)
        wk = torch.where(k < K, torch.gather(wt, 2, kc[..., None])[..., 0], 0.0)[:, None, :, None]
        xk = torch.take_along_dim(x, kc[:, None, :, None], dim=2)          # [n, C, O, M]
        even = (kc % 2 == 0)[:, None, :, None]
        upd = ops.fma(wk, xk, torch.where(even, acc[0], acc[1]))
        acc = [torch.where(even, upd, acc[0]), torch.where(even, acc[1], upd)]
    return acc[0] + acc[1]


def batched_random_resized_crop_planar(planar, boxes, out_size: int):
    """Planar crops: ``planar [C, H, W]`` (or ``[n, C, H, W]``, one image a
    box) and ``boxes`` (top, left, h, w), each ``[n]`` -> ``[n, C, out, out]``
    float32, unrounded."""
    H, W = planar.shape[-2], planar.shape[-1]
    top, left, h, w = boxes
    wy = _batched_resize_weights(H, out_size, top, h)   # [n, out, H]
    wx = _batched_resize_weights(W, out_size, left, w)  # [n, out, W]
    src = planar.float()[None] if planar.dim() == 3 else planar.float()
    tmp = _banded_product(wy, src)                      # [n, C, out, W]
    return _banded_product(wx, tmp.transpose(2, 3)).transpose(2, 3)


def batched_random_resized_crop(imgs_or_img, boxes, out_size: int):
    """Crops of one image ``[H, W, C]`` (or one image a box, ``[n, H, W, C]``)
    -> ``[n, out, out, C]`` (NHWC)."""
    img = imgs_or_img
    planar = img.permute(2, 0, 1) if img.dim() == 3 else img.permute(0, 3, 1, 2)
    return batched_random_resized_crop_planar(planar, boxes, out_size).permute(0, 2, 3, 1)


def random_resized_crop(img, generator, out_size: int, scale=(0.08, 1.0), ratio=RRC_RATIO):
    """One RandomResizedCrop of an ``[H, W, C]`` image, drawn from ``generator``."""
    H, W = img.shape[0], img.shape[1]
    d = draw_rrc(generator, (1,), scale[0], ratio, device=img.device)
    return batched_random_resized_crop(img, rrc_boxes(d["ta"], d["lr"], d["u_top"], d["u_left"], H, W, ratio),
                                       out_size)[0]


# ---------------------------------------------------------------------------
# Batched AugMix chain step
# ---------------------------------------------------------------------------


def _batched_affine_coords(mats, H: int, W: int, fused: bool = False):
    """Per-view sampling coordinates ``(in_x, in_y) [V, H, W]`` from matrices
    ``[V, 6]`` (PIL half-pixel centers). ``fused``: with each x term's
    product fused into the sum, as XLA's program computes the coordinates it
    floors (it computes the fractions' from rounded products)."""
    dev = mats.device
    xx = (torch.arange(W, dtype=mats.dtype, device=dev) + 0.5)[None, None, :].expand(len(mats), H, W)
    yy = (torch.arange(H, dtype=mats.dtype, device=dev) + 0.5)[None, :, None].expand(len(mats), H, W)
    a, b, c, d, e, f = (mats[:, i, None, None].expand(-1, H, W) for i in range(6))
    if fused:
        return ops.fma(a, xx, b * yy) + c - 0.5, ops.fma(d, xx, e * yy) + f - 0.5
    return (a * xx + b * yy) + c - 0.5, (d * xx + e * yy) + f - 0.5


def _apply_op_batched(imgs, op_idx, u_level, u_sign, severity, image_size: int):
    """One AugMix chain step over a view batch: ``imgs [V, C, H, W]``
    (integer-valued), ``op_idx``, ``u_level``, ``u_sign`` ``[V]``. The warp
    ops share one separable shift-blend warp (a matrix per view); the pixel
    ops are batched closed forms; each op rounds its output. A view whose
    ``op_idx`` is none of 0-8 passes through. Each op runs on its views only."""
    V, C, H, W = imgs.shape
    level = ops.fma(u_level, torch.full_like(u_level, severity - 0.1), torch.full_like(u_level, 0.1))
    sign = torch.where(u_sign > 0.5, 1.0, -1.0)
    out = imgs.clone()

    warp = torch.isin(op_idx, torch.tensor(WARP_OPS, device=op_idx.device)).nonzero()[:, 0]
    if warp.numel():
        op, lv, sg = op_idx[warp], level[warp], sign[warp]
        theta = -(sg * _int_param(lv, 30) * math.radians(1.0))
        cos, sin = torch.cos(theta.double()).float(), torch.sin(theta.double()).float()
        cx = cy = image_size / 2.0
        shear = sg * _float_param(lv, 0.3)
        trans = sg * _int_param(lv, image_size / 3.0)
        zero, one = torch.zeros_like(lv), torch.ones_like(lv)
        c = lambda v: torch.full_like(cos, v)
        c_rot = ops.fma(c(-cy), sin, ops.fma(c(-cx), cos, c(cx)))
        f_rot = ops.fma(c(-cy), cos, ops.fma(c(cx), sin, c(cy)))
        mats = torch.stack([one, zero, zero, zero, one, zero], dim=-1)
        for o, row in ((3, (cos, sin, c_rot, -sin, cos, f_rot)), (5, (one, shear, zero, zero, one, zero)),
                       (6, (one, zero, zero, shear, one, zero)), (7, (one, zero, trans, zero, one, zero)),
                       (8, (one, zero, zero, zero, one, trans))):
            mats = torch.where((op == o)[:, None], torch.stack(row, dim=-1), mats)
        fx, fy = _batched_affine_coords(mats, H, W, fused=True)
        in_x, in_y = _batched_affine_coords(mats, H, W)
        dx = torch.clamp(torch.floor(fx).long() - torch.arange(W, device=imgs.device), -WARP_MAX_SHIFT,
                         WARP_MAX_SHIFT)[:, None]
        dy = torch.clamp(torch.floor(fy).long() - torch.arange(H, device=imgs.device)[:, None], -WARP_MAX_SHIFT,
                         WARP_MAX_SHIFT)[:, None]
        frac = lambda t: (t - torch.floor(t))[:, None]
        h = _planar_shift_blend(imgs[warp], dx, frac(in_x), WARP_MAX_SHIFT, axis=3)
        out[warp] = torch.round(_planar_shift_blend(h, dy, frac(in_y), WARP_MAX_SHIFT, axis=2))

    def on(o, fn):
        idx = (op_idx == o).nonzero()[:, 0]
        if idx.numel():
            out[idx] = fn(out[idx], level[idx][:, None, None, None])

    def auto(x, _):
        lo = x.amin(dim=(2, 3), keepdim=True)
        hi = x.amax(dim=(2, 3), keepdim=True)
        a = torch.clamp(torch.floor((x - lo) * 255.0 / torch.clamp(hi - lo, min=1.0) + 1e-3), 0, 255)
        return torch.where(hi <= lo, x, a)

    def post(x, lv):
        bits = (4 - _int_param(lv, 4)).to(torch.int32)
        return (x.to(torch.int32) & ((torch.full_like(bits, 0xFF00) >> bits) & 0xFF)).to(x.dtype)

    def sol(x, lv):
        return torch.where(x >= 256.0 - _int_param(lv, 256), 255.0 - x, x)

    on(0, auto)
    on(1, lambda x, _: _planar_equalize(x))
    on(2, post)
    on(4, sol)
    return out


_planar_shift_blend = ops.shift_blend   # over [V, C, H, W] along H (axis 2) or W (axis 3)


def _planar_equalize(x):
    """Batched PIL equalize over ``[V, C, H, W]``: a histogram a plane by one
    ``scatter_add_``, PIL's step LUT, one gather."""
    V, C, H, W = x.shape
    idx = torch.clamp(x, 0, 255).long().reshape(V * C, H * W)
    lut = ops.equalize_lut_rows(ops.histograms(idx))
    return torch.gather(lut, 1, idx).reshape(V, C, H, W).to(x.dtype)


# ---------------------------------------------------------------------------
# Hard (BYOL-style) pre-augmentation (`datautils.py:76-91`), planar batched
# ---------------------------------------------------------------------------


def _luma(r, g, b):
    """0.299 r + 0.587 g + 0.114 b with XLA's contraction of the three products."""
    return ops.fma(torch.full_like(b, 0.114), b, ops.fma(torch.full_like(r, 0.299), r, 0.587 * g))


def _hard_aug_batched(x, draws):
    """ColorJitter(0.4, 0.4, 0.2, 0.1) p=0.5, grayscale p=0.2, blur(3) p=0.1 on
    ``x [V, 3, H, W]`` in [0, 255] from the draws of ``draw_hard_aug_randoms``
    (each ``[V]``). The hue shift is the standard YIQ rotation
    (distributional, not PIL-exact: the JAX package's documented deviation);
    the contrast mean is over all three channels; the blur wraps around the
    edges (``jnp.roll``). Rounds to integers in [0, 255]."""
    col = lambda k: draws[k][:, None, None, None]
    const = lambda v, like: torch.full_like(like, v)
    x01 = x * (1.0 / 255.0)

    j = x01 * col("b")
    mean = j.double().sum(dim=(1, 2, 3), keepdim=True).float() * (1.0 / j[0].numel())
    j = ops.fma(j - mean, col("c").expand_as(j), mean.expand_as(j))
    lum = _luma(j[:, 0], j[:, 1], j[:, 2])[:, None]
    j = ops.fma(j - lum, col("s").expand_as(j), lum.expand_as(j))
    h = draws["h"] * _const(2.0, math.pi)
    cos_h, sin_h = torch.cos(h.double()).float()[:, None, None], torch.sin(h.double()).float()[:, None, None]
    r, g, b = j[:, 0], j[:, 1], j[:, 2]
    yy = _luma(r, g, b)
    ii = ops.fma(const(-0.322, b), b, ops.fma(const(0.596, r), r, -(0.274 * g)))
    qq = ops.fma(const(0.312, b), b, ops.fma(const(0.211, r), r, -(0.523 * g)))
    ii2 = ops.fma(ii, cos_h.expand_as(ii), -(qq * sin_h))
    qq2 = ops.fma(ii, sin_h.expand_as(ii), qq * cos_h)
    rr = ops.fma(const(0.621, qq2), qq2, ops.fma(const(0.956, ii2), ii2, yy))
    gg = ops.fma(const(-0.647, qq2), qq2, ops.fma(const(-0.272, ii2), ii2, yy))
    bb = ops.fma(const(1.703, qq2), qq2, ops.fma(const(-1.106, ii2), ii2, yy))
    j = torch.stack([rr, gg, bb], dim=1)
    x01 = torch.where(col("u_jitter") < 0.5, torch.clamp(j, 0.0, 1.0), x01)

    gray = _luma(x01[:, 0], x01[:, 1], x01[:, 2])[:, None]
    x01 = torch.where(col("u_gray") < 0.2, gray.expand_as(x01), x01)

    sigma = draws["sigma"]
    w1 = torch.exp((torch.full_like(sigma, -0.5) / torch.clamp(sigma, min=1e-3) ** 2).double()).float()
    k0 = torch.ones_like(w1) / ops.fma(torch.full_like(w1, 2.0), w1, torch.ones_like(w1))
    k1 = (w1 * k0)[:, None, None, None].expand_as(x01)
    k0 = k0[:, None, None, None].expand_as(x01)
    blur_h = ops.fma(k0, x01, k1 * (torch.roll(x01, 1, dims=3) + torch.roll(x01, -1, dims=3)))
    blur = ops.fma(k0, blur_h, k1 * (torch.roll(blur_h, 1, dims=2) + torch.roll(blur_h, -1, dims=2)))
    x01 = torch.where(col("u_blur") < 0.1, blur, x01)
    return torch.clamp(torch.round(x01 * 255.0), 0.0, 255.0)


# ---------------------------------------------------------------------------
# Views
# ---------------------------------------------------------------------------


def views_from_draws(images, draws, *, resolution: int = 224, augmix: bool = True, severity: float = 1.0,
                     hard_aug: bool = False):
    """Images ``[N, S, S, 3]`` (u8 or float, [0, 255]) and the group's draws
    (``draw_generator_randoms``; ``n_views - 1`` views an image) -> CLIP-
    normalised float32 views ``[N, n_views, R, R, 3]``, on the images' device."""
    N, S = images.shape[0], images.shape[1]
    V = draws["u_flip"].shape[1]
    R = resolution
    dev = images.device
    planar = images.float().permute(0, 3, 1, 2)                                  # [N, 3, S, S]
    mean = torch.as_tensor(CLIP_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(CLIP_STD, device=dev)[:, None, None]
    norm = lambda x255: (x255 * (1.0 / 255.0) - mean) / std

    from ..ops.augmix import bicubic_matrix

    basew = bicubic_matrix(S, R, device=dev).double()
    base = torch.clamp((basew @ planar.double() @ basew.T).float(), 0.0, 255.0)   # [N, 3, R, R]

    flat = lambda k: draws[k].reshape((N * V,) + tuple(draws[k].shape[2:]))
    boxes = rrc_boxes(flat("ta"), flat("lr"), flat("u_top"), flat("u_left"), S, S)
    img_of = torch.arange(N, device=dev).repeat_interleave(V)
    x_orig = batched_random_resized_crop_planar(planar[img_of], boxes, R)
    x_orig = torch.clamp(torch.round(x_orig), 0.0, 255.0)                       # [N*V, 3, R, R]
    if hard_aug:
        x_orig = _hard_aug_batched(x_orig, {k: flat(k) for k in ("u_jitter", "b", "c", "s", "h", "u_gray", "u_blur",
                                                                  "sigma")})
    x_orig = torch.where((flat("u_flip") < 0.5)[:, None, None, None], torch.flip(x_orig, dims=(3,)), x_orig)

    if not augmix:
        views = norm(x_orig)
    else:
        per_view = lambda k: draws[k].movedim(-1, 1).reshape((N * V,) + tuple(draws[k].shape[1:-1]))
        depths, op_idx = per_view("depths"), per_view("op_idx")                  # [N*V, 3], [N*V, 3, 3]
        u_level, u_sign = per_view("u_level"), per_view("u_sign")
        e = flat("e_w")
        w = e / e.sum(dim=-1, keepdim=True)                                      # Dirichlet(1, 1, 1), [N*V, 3]
        m = flat("m")[:, None, None, None]
        mix = torch.zeros_like(x_orig)
        for chain in range(N_CHAINS):
            x_aug = x_orig
            for step in range(MAX_CHAIN_DEPTH):
                op = torch.where(step < depths[:, chain], op_idx[:, chain, step], -1)   # inactive: pass through
                x_aug = _apply_op_batched(x_aug, op, u_level[:, chain, step], u_sign[:, chain, step], severity, R)
            mix = mix + w[:, chain, None, None, None] * norm(x_aug)
        views = m * norm(x_orig) + (1.0 - m) * mix

    out = torch.cat([norm(base)[:, None], views.reshape(N, V, 3, R, R)], dim=1)   # [N, n_views, 3, R, R]
    return out.permute(0, 1, 3, 4, 2).contiguous()                               # NHWC once, at the boundary


def generate_views(image, generator, n_views: int, resolution: int = 224, augmix: bool = True, severity: float = 1.0,
                   crop_min: float = 0.08, hard_aug: bool = False):
    """One test image ``[S, S, 3]`` (u8 or float) -> ``[n_views, R, R, 3]``
    normalised views, drawn from ``generator`` on the image's device."""
    draws = draw_generator_randoms(generator, 1, n_views, crop_min, hard_aug, device=image.device)
    return views_from_draws(image[None], draws, resolution=resolution, augmix=augmix, severity=severity,
                            hard_aug=hard_aug)[0]


def make_view_generator(n_views: int, resolution: int = 224, augmix: bool = True, severity: float = 1.0,
                        crop_min: float = 0.08, hard_aug: bool = False):
    """The batched generator: ``(images [N, S, S, 3] on the device, generator)
    -> [N, n_views, R, R, 3]`` float32 views, every draw of the group taken
    from ``generator`` in one fixed order (``draw_generator_randoms``)."""

    def gen(images, generator):
        images = torch.as_tensor(images)
        draws = draw_generator_randoms(generator, images.shape[0], n_views, crop_min, hard_aug, device=images.device)
        return views_from_draws(images, draws, resolution=resolution, augmix=augmix, severity=severity,
                                hard_aug=hard_aug)

    return gen
