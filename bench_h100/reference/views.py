"""The views a group's u8 sources and seed give, worked out again: a frozen
copy of the view arithmetic as the repository fixed it when this benchmark
was written, so that a later change to the program's views (a new kernel, a
fused generator) is held to it.

Two generators, the two the prompt-TTA cells drive:
- ``augmix_tokens``: what ``--viewgen fused`` (the AugMix kernel) computes:
  u8 views ``[N, V, 3, R, R]``, view by view and op by op, the crop's dot
  products summed in float64;
- ``generator_views``: what ``--viewgen device`` (the batched generator)
  computes: CLIP-normalised float32 NHWC views, the rounding decisions taken
  on XLA's CPU arithmetic (products feeding a sum fused, float64 carrying
  them).

Both draw every random number from one ``torch.Generator`` on the sources'
device, seeded with the group's seed, in one fixed order (the crop's, the
flip, the chains' depths, ops, levels and signs, the Dirichlet mixing
weights, the blend), so that the same seed gives the same views.

``lowp``: the control. The crop's interpolation weights and its products are
rounded to bfloat16, the precision below the float32 that the views are
stated in; everything else as above.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_AUGMIX_OPS = 9
MAX_CHAIN_DEPTH = 3
N_CHAINS = 3
RRC_ATTEMPTS = 10
RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)
WARP_MAX_SHIFT = 12
WARP_OPS = (3, 5, 6, 7, 8)   # rotate, shear x/y, translate x/y
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def bf16(x):
    return x.to(torch.bfloat16).float()


def fma(a, b, c):
    """float32 ``a·b + c`` rounded once (the float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _div(a, b: float):
    """``a / b`` by IEEE division (not by a multiplication by ``1/b``)."""
    return a / torch.full_like(a, b)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def draw_rrc(generator, shape, crop_min: float, device):
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    lo, hi = math.log(RRC_RATIO[0]), math.log(RRC_RATIO[1])
    return {"ta": u(*shape, RRC_ATTEMPTS) * (1.0 - crop_min) + crop_min,
            "lr": u(*shape, RRC_ATTEMPTS) * (hi - lo) + lo,
            "u_top": u(*shape), "u_left": u(*shape)}


def draw_view_randoms(generator, n_images: int, n_views: int, device, crop_min: float = 0.08):
    """Every draw of a group of ``n_images`` sources, ``n_views`` views each
    (view 0, the base view, draws nothing)."""
    N, V = n_images, n_views - 1
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    randint = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=generator, device=device)
    out = draw_rrc(generator, (N, V), crop_min, device)
    out.update(u_flip=u(N, V), depths=randint(1, MAX_CHAIN_DEPTH + 1, N, N_CHAINS, V),
               op_idx=randint(0, N_AUGMIX_OPS, N, N_CHAINS, MAX_CHAIN_DEPTH, V),
               u_level=u(N, N_CHAINS, MAX_CHAIN_DEPTH, V), u_sign=u(N, N_CHAINS, MAX_CHAIN_DEPTH, V),
               e_w=torch.empty((N, V, N_CHAINS), device=device).exponential_(generator=generator), m=u(N, V))
    return out


def rrc_boxes(ta, lr, u_top, u_left, H: int, W: int):
    """RandomResizedCrop boxes (top, left, h, w): the first attempt that fits."""
    t = ta * (H * W)
    aspect = torch.exp(lr)
    ws = torch.floor(torch.sqrt(t * aspect))
    hs = torch.floor(torch.sqrt(t / aspect))
    valid = (ws <= W) & (hs <= H) & (ws > 0) & (hs > 0)
    first = valid.to(torch.uint8).argmax(dim=-1, keepdim=True)
    any_valid = valid.any(dim=-1)
    w = torch.gather(ws, -1, first)[..., 0]
    h = torch.gather(hs, -1, first)[..., 0]
    top = torch.floor(u_top * (H - h + 1))
    left = torch.floor(u_left * (W - w + 1))
    pick = lambda a, b: torch.where(any_valid, a, torch.full_like(a, b))
    return pick(top, 0.0), pick(left, 0.0), pick(h, float(H)), pick(w, float(W))


def derive_view_params(r, *, src_size: int, resolution: int, severity: float = 1.0):
    """Per-view parameters ``[N, n_views, ...]`` from the draws; row 0 of each
    source is the base view (depth 0, m = 1)."""
    N, V = r["u_flip"].shape
    top, left, h, w = rrc_boxes(r["ta"], r["lr"], r["u_top"], r["u_left"], src_size, src_size)
    wmix = r["e_w"] / r["e_w"].sum(dim=-1, keepdim=True)
    level = 0.1 + r["u_level"] * (severity - 0.1)
    sign = torch.where(r["u_sign"] > 0.5, 1.0, -1.0)
    deg = sign * torch.floor(level * 3.0)
    theta = -(deg * (math.pi / 180.0))
    alpha = torch.tan(theta / 2.0)
    beta = -torch.sin(theta)
    shear = sign * level * 0.03
    trans = sign * torch.floor(_div(level * (resolution / 3.0), 10.0))
    bits = (4 - torch.floor(level * 0.4)).to(torch.int32)
    pmask = (torch.full_like(bits, 0xFF00) >> bits) & 0xFF
    sthr = 256.0 - torch.floor(level * 25.6)
    o = r["op_idx"]
    p0 = torch.zeros_like(level)
    p0 = torch.where(o == 3, alpha, p0)
    p0 = torch.where((o == 5) | (o == 6), shear, p0)
    p0 = torch.where((o == 7) | (o == 8), trans, p0)
    p0 = torch.where(o == 4, sthr, p0)
    p1 = torch.where(o == 3, beta, torch.zeros_like(beta))
    ip0 = torch.where(o == 2, pmask, torch.zeros_like(pmask))

    def pad_front(a, val=0):
        return torch.cat([torch.full((N, 1) + a.shape[2:], val, dtype=a.dtype, device=a.device), a], dim=1)

    flat9 = lambda a: a.reshape(N, N_CHAINS * MAX_CHAIN_DEPTH, V).transpose(1, 2)
    return {"rrc": pad_front(torch.stack([top, left, h, w], dim=-1).float()),
            "flip": pad_front((r["u_flip"] < 0.5).to(torch.int32)),
            "depth": pad_front(r["depths"].transpose(1, 2).to(torch.int32)),
            "ops": pad_front(flat9(o).to(torch.int32)), "p0": pad_front(flat9(p0).float()),
            "p1": pad_front(flat9(p1).float()), "ip0": pad_front(flat9(ip0).to(torch.int32)),
            "wm": pad_front(wmix.float()), "m": pad_front(r["m"], 1.0).float()}


def group_view_params(seed: int, n_images: int, n_views: int, src_size: int, resolution: int, device):
    """The AugMix kernel's per-view parameters of a group, flattened to
    ``[N * n_views, ...]``, drawn from a generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p = derive_view_params(draw_view_randoms(gen, n_images, n_views, device), src_size=src_size,
                           resolution=resolution)
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in p.items()}


# ---------------------------------------------------------------------------
# The AugMix kernel's arithmetic, view by view
# ---------------------------------------------------------------------------


def op_shift_bounds(severity: float, R: int) -> tuple:
    """Tap windows (rot_alpha, rot_beta, shear, trans) of the warp ops."""
    deg = math.floor(3.0 * severity)
    half = R / 2.0 - 0.5
    rot_a = math.tan(math.radians(deg) / 2.0) * half
    rot_b = math.sin(math.radians(deg)) * half
    shear = 0.03 * severity * (R - 0.5)
    trans = math.floor(severity * (R / 3.0) / 10.0)
    frac = lambda x: int(math.floor(x)) + 1
    return (frac(rot_a), frac(rot_b), frac(shear), int(trans))


def bicubic_matrix(src: int, dst: int, device="cpu"):
    """``[dst, src]`` antialiased Keys (a = -0.5) resize weights, float32 step by step."""
    if src == dst:
        return torch.eye(src, dtype=torch.float32, device=device)
    f32 = np.float32
    inv_scale = f32(1.0 / (dst / src))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps), w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    w = np.where(((sample_f >= -0.5) & (sample_f <= src - 0.5))[None, :], w, f32(0.0))
    return torch.from_numpy(np.ascontiguousarray(w.T, dtype=f32)).to(device)


def resize_weights(start, length, flip, R: int, S: int):
    """Triangle-kernel crop matrix ``[R, S]``, each row divided by its exact sum."""
    dev = start.device
    scale = _div(length, R)
    o = torch.arange(R, dtype=torch.float32, device=dev)[:, None]
    if flip:
        o = (R - 1) - o
    centers = start + (o + 0.5) * scale
    src = torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5
    inv = 1.0 / torch.clamp(scale, min=1.0)
    w = torch.clamp(1.0 - torch.abs((src - centers) * inv), min=0.0)
    return w / torch.clamp(w.double().sum(dim=1, keepdim=True).float(), min=1e-12)


def _warp(x, shift, axis: int, max_shift: int):
    """The shift-blend of a warp op along W (``axis=2``) or H (``axis=1``),
    its two taps summed as the kernel sums them."""
    R = x.shape[axis]
    d0 = torch.floor(shift)
    f = shift - d0
    d = torch.clamp(d0, -max_shift, max_shift).long()
    pos = torch.arange(R, device=x.device)
    per = (lambda t: t[:, None]) if axis == 2 else (lambda t: t[None, :])
    along = pos[None, :] if axis == 2 else pos[:, None]
    ia = along + per(d)
    ib = ia + 1
    take = lambda i, ok: torch.where(ok, torch.gather(x, axis, i.clamp(0, R - 1).expand_as(x)), 0.0)
    xa = take(ia, (ia >= 0) & (ia < R))
    xb = take(ib, (ib >= 0) & (ib < R) & per(d < max_shift))
    wa, wb = per(1.0 - f), per(f)
    pa, pb = wa * xa, wb * xb
    tap = per(d + max_shift)
    single_last = (2 * max_shift + 1) % 5 == 1
    apart = (tap % 5 == 4) & ~((tap + 1 == 2 * max_shift) & single_last)
    return torch.where(apart, pa + pb, torch.where(tap % 5 == 0, fma(wa, xa, pb), fma(wb, xb, pa)))


def equalize_lut_rows(hist):
    """PIL's equalize step LUTs ``[R, 256]`` from integer histograms ``[R, 256]``."""
    ids = torch.arange(256, device=hist.device).expand_as(hist)
    nonzero = hist > 0
    last_nz = torch.where(nonzero, ids, -1).amax(dim=1, keepdim=True).clamp(min=0)
    step = (hist.sum(dim=1, keepdim=True) - torch.gather(hist, 1, last_nz)) // 255
    cum = torch.cumsum(hist, dim=1) - hist
    lut = torch.clamp((step // 2 + cum) // step.clamp(min=1), 0, 255)
    return torch.where((nonzero.sum(dim=1, keepdim=True) <= 1) | (step == 0), ids, lut)


def equalize(x):
    """PIL ImageOps.equalize per plane of an integer-valued ``[..., P, H, W]``."""
    shape = x.shape
    idx = torch.clamp(x, 0, 255).long().reshape(-1, shape[-2] * shape[-1])
    hist = torch.zeros((idx.shape[0], 256), dtype=torch.int64, device=x.device).scatter_add_(1, idx,
                                                                                             torch.ones_like(idx))
    return torch.gather(equalize_lut_rows(hist), 1, idx).reshape(shape).to(x.dtype)


def _apply_op(x, op: int, q0, q1, qi: int, shifts):
    """One AugMix op on an integer-valued ``[3, R, R]`` plane stack; every op rounds."""
    ms_ra, ms_rb, ms_sh, ms_tr = shifts
    R = x.shape[-1]
    cxy = R / 2.0
    pos = torch.arange(R, dtype=torch.float32, device=x.device)
    if op == 0:
        lo = x.amin(dim=(1, 2), keepdim=True)
        hi = x.amax(dim=(1, 2), keepdim=True)
        out = torch.clamp(torch.floor((x - lo) * 255.0 / torch.clamp(hi - lo, min=1.0) + 1e-3), 0.0, 255.0)
        return torch.where(hi <= lo, x, out)
    if op == 1:
        return equalize(x)
    if op == 2:
        return (x.to(torch.int32) & qi).float()
    if op == 3:
        t = _warp(x, q0 * (pos + 0.5 - cxy), axis=2, max_shift=ms_ra)
        t = _warp(t, q1 * (pos + 0.5 - cxy), axis=1, max_shift=ms_rb)
        return torch.round(_warp(t, q0 * (pos + 0.5 - cxy), axis=2, max_shift=ms_ra))
    if op == 4:
        return torch.where(x >= q0, 255.0 - x, x)
    if op in (5, 6):
        return torch.round(_warp(x, q0 * (pos + 0.5), axis=2 if op == 5 else 1, max_shift=ms_sh))
    if op in (7, 8):
        return torch.round(_warp(x, q0.expand(R), axis=2 if op == 7 else 1, max_shift=ms_tr))
    return x


def augmix_views(images_planar, params, R: int, V: int, lowp: bool = False):
    """u8 sources ``[N, 3, S, S]`` and per-view parameters ``[N*V, ...]`` ->
    u8 views ``[N, V, 3, R, R]``."""
    N, S = images_planar.shape[0], images_planar.shape[-1]
    dev = images_planar.device
    shifts = op_shift_bounds(1.0, R)
    basew = bicubic_matrix(S, R, device=dev)
    host = {k: params[k].cpu().tolist() for k in ("flip", "depth", "ops", "ip0")}
    rnd = bf16 if lowp else (lambda t: t)
    out = torch.empty((N, V, 3, R, R), dtype=torch.uint8, device=dev)
    for n in range(N):
        src = images_planar[n].float()
        for v in range(V):
            i = n * V + v
            if v == 0:
                wy = wx = basew
            else:
                box = params["rrc"][i]
                wy = resize_weights(box[0], box[2], 0, R, S)
                wx = resize_weights(box[1], box[3], host["flip"][i], R, S)
            wy, wx = rnd(wy), rnd(wx)
            t = rnd((wy.double() @ src.double()).float())
            xorig = torch.clamp(torch.round(rnd((t.double() @ wx.T.double()).float())), 0.0, 255.0)
            mix = torch.zeros_like(xorig)
            for chain in range(N_CHAINS):
                a = xorig
                for st in range(host["depth"][i][chain]):
                    s = chain * MAX_CHAIN_DEPTH + st
                    a = _apply_op(a, host["ops"][i][s], params["p0"][i, s], params["p1"][i, s], host["ip0"][i][s],
                                  shifts)
                mix = mix + params["wm"][i, chain] * a
            mv = params["m"][i]
            out[n, v] = torch.clamp(torch.round(mv * xorig + (1.0 - mv) * mix), 0.0, 255.0).to(torch.uint8)
    return out


def augmix_tokens(images_planar, seed: int, n_views: int, resolution: int, lowp: bool = False):
    """The fused path's views of a group: u8 ``[N, n_views, 3, R, R]``."""
    N, S = images_planar.shape[0], images_planar.shape[-1]
    params = group_view_params(seed, N, n_views, S, resolution, images_planar.device)
    return augmix_views(images_planar, params, resolution, n_views, lowp)


def patchify(views, patch: int):
    """``[N, V, 3, R, R]`` -> patch-major tokens ``[N, V, (R/p)^2, p*p*3]``, (row, col, channel)."""
    N, V, C, R, _ = views.shape
    g = R // patch
    return views.reshape(N, V, C, g, patch, g, patch).permute(0, 1, 3, 5, 4, 6, 2).reshape(N, V, g * g,
                                                                                           patch * patch * C)


# ---------------------------------------------------------------------------
# The batched device generator's arithmetic
# ---------------------------------------------------------------------------


def _const(*factors) -> float:
    out = np.float32(1.0)
    for f in factors:
        out = np.float32(out * np.float32(f))
    return float(out)


def _int_param(level, maxval):
    return torch.floor(level * _const(maxval, 0.1))


def _float_param(level, maxval):
    return level * _const(maxval, 0.1)


def _row_sum(w, block: int = 32, lanes: int = 8):
    """Row sums in the order XLA's CPU program adds them."""
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


def _batched_resize_weights(src_size: int, out_size: int, start, length):
    scale = length.float() * (1.0 / out_size)
    o = torch.arange(out_size, dtype=torch.float32, device=start.device) + 0.5
    centers = fma(o[None, :], scale[:, None], start.float()[:, None])
    src = torch.arange(src_size, dtype=torch.float32, device=start.device)[None, None, :] + 0.5
    inv = 1.0 / torch.clamp(scale, min=1.0)
    w = torch.clamp(1.0 - torch.abs((src - centers[..., None]) * inv[:, None, None]), min=0.0)
    return w / torch.clamp(_row_sum(w), min=1e-12)


def _banded_product(wt, x):
    """``sum_k wt[n, o, k] x[n, c, k, m]`` over a crop's banded taps, the even
    and the odd taps each a chain of fused multiply-adds, then the two added."""
    n, O, K = wt.shape
    taps = int(2 * max(K / O, 1.0)) + 1
    k0 = (wt > 0).to(torch.uint8).argmax(dim=-1)
    acc = [x.new_zeros((n, x.shape[1], O, x.shape[3])) for _ in range(2)]
    for t in range(taps):
        k = k0 + t
        kc = k.clamp(max=K - 1)
        wk = torch.where(k < K, torch.gather(wt, 2, kc[..., None])[..., 0], 0.0)[:, None, :, None]
        xk = torch.take_along_dim(x, kc[:, None, :, None], dim=2)
        even = (kc % 2 == 0)[:, None, :, None]
        upd = fma(wk, xk, torch.where(even, acc[0], acc[1]))
        acc = [torch.where(even, upd, acc[0]), torch.where(even, acc[1], upd)]
    return acc[0] + acc[1]


def _crop_planar(planar, boxes, out_size: int, lowp: bool):
    H, W = planar.shape[-2], planar.shape[-1]
    top, left, h, w = boxes
    wy = _batched_resize_weights(H, out_size, top, h)
    wx = _batched_resize_weights(W, out_size, left, w)
    if lowp:
        wy, wx = bf16(wy), bf16(wx)
    tmp = _banded_product(wy, planar.float())
    if lowp:
        tmp = bf16(tmp)
    return _banded_product(wx, tmp.transpose(2, 3)).transpose(2, 3)


def _affine_coords(mats, H: int, W: int, fused: bool = False):
    dev = mats.device
    xx = (torch.arange(W, dtype=mats.dtype, device=dev) + 0.5)[None, None, :].expand(len(mats), H, W)
    yy = (torch.arange(H, dtype=mats.dtype, device=dev) + 0.5)[None, :, None].expand(len(mats), H, W)
    a, b, c, d, e, f = (mats[:, i, None, None].expand(-1, H, W) for i in range(6))
    if fused:
        return fma(a, xx, b * yy) + c - 0.5, fma(d, xx, e * yy) + f - 0.5
    return (a * xx + b * yy) + c - 0.5, (d * xx + e * yy) + f - 0.5


def shift_blend(x, delta, frac, bound: int, axis: int):
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


def _apply_op_batched(imgs, op_idx, u_level, u_sign, severity, image_size: int):
    """One chain step over views ``[V, C, H, W]``; a view whose op is none of 0-8 passes."""
    level = fma(u_level, torch.full_like(u_level, severity - 0.1), torch.full_like(u_level, 0.1))
    sign = torch.where(u_sign > 0.5, 1.0, -1.0)
    out = imgs.clone()
    _, _, H, W = imgs.shape
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
        c_rot = fma(c(-cy), sin, fma(c(-cx), cos, c(cx)))
        f_rot = fma(c(-cy), cos, fma(c(cx), sin, c(cy)))
        mats = torch.stack([one, zero, zero, zero, one, zero], dim=-1)
        for o, row in ((3, (cos, sin, c_rot, -sin, cos, f_rot)), (5, (one, shear, zero, zero, one, zero)),
                       (6, (one, zero, zero, shear, one, zero)), (7, (one, zero, trans, zero, one, zero)),
                       (8, (one, zero, zero, zero, one, trans))):
            mats = torch.where((op == o)[:, None], torch.stack(row, dim=-1), mats)
        fx, fy = _affine_coords(mats, H, W, fused=True)
        in_x, in_y = _affine_coords(mats, H, W)
        dx = torch.clamp(torch.floor(fx).long() - torch.arange(W, device=imgs.device), -WARP_MAX_SHIFT,
                         WARP_MAX_SHIFT)[:, None]
        dy = torch.clamp(torch.floor(fy).long() - torch.arange(H, device=imgs.device)[:, None], -WARP_MAX_SHIFT,
                         WARP_MAX_SHIFT)[:, None]
        frac = lambda t: (t - torch.floor(t))[:, None]
        h = shift_blend(imgs[warp], dx, frac(in_x), WARP_MAX_SHIFT, axis=3)
        out[warp] = torch.round(shift_blend(h, dy, frac(in_y), WARP_MAX_SHIFT, axis=2))

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
    on(1, lambda x, _: equalize(x))
    on(2, post)
    on(4, sol)
    return out


def generator_views(images, seed: int, n_views: int, resolution: int, lowp: bool = False, severity: float = 1.0):
    """The device generator's views of a group: u8 sources ``[N, S, S, 3]``
    -> CLIP-normalised float32 NHWC views ``[N, n_views, R, R, 3]``."""
    N, S = images.shape[0], images.shape[1]
    dev = images.device
    R = resolution
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    draws = draw_view_randoms(gen, N, n_views, dev)
    V = n_views - 1
    planar = images.float().permute(0, 3, 1, 2)
    mean = torch.as_tensor(CLIP_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(CLIP_STD, device=dev)[:, None, None]
    norm = lambda x255: (x255 * (1.0 / 255.0) - mean) / std
    basew = bicubic_matrix(S, R, device=dev).double()
    if lowp:
        basew = bf16(basew).double()
    base = torch.clamp((basew @ planar.double() @ basew.T).float(), 0.0, 255.0)
    flat = lambda k: draws[k].reshape((N * V,) + tuple(draws[k].shape[2:]))
    boxes = rrc_boxes(flat("ta"), flat("lr"), flat("u_top"), flat("u_left"), S, S)
    img_of = torch.arange(N, device=dev).repeat_interleave(V)
    x_orig = torch.clamp(torch.round(_crop_planar(planar[img_of], boxes, R, lowp)), 0.0, 255.0)
    x_orig = torch.where((flat("u_flip") < 0.5)[:, None, None, None], torch.flip(x_orig, dims=(3,)), x_orig)
    per_view = lambda k: draws[k].movedim(-1, 1).reshape((N * V,) + tuple(draws[k].shape[1:-1]))
    depths, op_idx = per_view("depths"), per_view("op_idx")
    u_level, u_sign = per_view("u_level"), per_view("u_sign")
    e = flat("e_w")
    w = e / e.sum(dim=-1, keepdim=True)
    m = flat("m")[:, None, None, None]
    mix = torch.zeros_like(x_orig)
    for chain in range(N_CHAINS):
        x_aug = x_orig
        for step in range(MAX_CHAIN_DEPTH):
            op = torch.where(step < depths[:, chain], op_idx[:, chain, step], -1)
            x_aug = _apply_op_batched(x_aug, op, u_level[:, chain, step], u_sign[:, chain, step], severity, R)
        mix = mix + w[:, chain, None, None, None] * norm(x_aug)
    views = m * norm(x_orig) + (1.0 - m) * mix
    out = torch.cat([norm(base)[:, None], views.reshape(N, V, 3, R, R)], dim=1)
    return out.permute(0, 1, 3, 4, 2).contiguous()
