"""On-device AugMix view generation: a hand-written CUDA kernel for Hopper
(``csrc/augmix.cu``), its plain PyTorch version, the per-view parameter
sampler and the patch-major token emitter.

Replaces the TPU kernel ``_augmix_kernel`` of ``rlcf_tpu/ops/pallas_augmix.py``
(``_fused_call`` / ``fused_views``). Function: u8 sources ``[N, 3, S, S]``
plus per-view packed parameters -> u8 views ``[N, V, 3, R, R]``. View 0 of
each image is a bicubic resize (``basew @ src @ basewᵀ``); views 1.. are a
RandomResizedCrop with a free horizontal flip (triangle-kernel weights), then
3 AugMix chains of depth 1-3 over 9 PIL ops, each op rounding its output, then
``m·orig + (1 - m)·mix`` rounded to u8.

``augmix_views`` dispatches: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs ``augmix_views_reference``. ``LAUNCHES`` counts kernel
launches, so a run can show that it went through the kernel.

The parameter sampler is split like the JAX one is not: ``draw_view_randoms``
makes every random draw with an explicit ``torch.Generator``, and
``derive_view_params`` is a deterministic function of those draws (level
scalings, the rotation's shear pair, posterize mask, solarize threshold, row-0
padding). Fed the numbers that JAX drew, it gives JAX's parameters.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from ..data.augment import MAX_CHAIN_DEPTH, N_AUGMIX_OPS, N_CHAINS, draw_rrc, rrc_boxes
from . import cuda_build
from .image_ops import fma as _fma

# kernel launches by the wrapper, and per (name, N, V, S, R)
LAUNCHES = {"augmix": 0}
LAUNCH_SHAPES = collections.Counter()

PARAM_FIELDS = ("rrc", "flip", "depth", "ops", "p0", "p1", "ip0", "wm", "m")
_INT_FIELDS = ("flip", "depth", "ops", "ip0")
_FIELD_WIDTH = {"rrc": 4, "flip": 0, "depth": N_CHAINS, "ops": 9, "p0": 9, "p1": 9, "ip0": 9, "wm": N_CHAINS, "m": 0}


def _div(a, b: float):
    """``a / b`` by IEEE division on every device: PyTorch's CUDA kernels turn
    a division by a host scalar into a multiplication by its reciprocal, which
    can differ in the last bit (and then move a crop weight or a floor)."""
    return a / torch.full_like(a, b)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def op_shift_bounds(severity: float, R: int) -> tuple:
    """Tap windows (rot_alpha, rot_beta, shear, trans) of the warp ops at this
    severity and resolution (``pallas_augmix.py::_op_shift_bounds``): the
    sampled level never exceeds ``severity``, which bounds every shift; a
    fractional shift needs taps floor(bound) and floor(bound)+1, an integer
    translate only its bound."""
    deg = math.floor(3.0 * severity)
    half = R / 2.0 - 0.5
    rot_a = math.tan(math.radians(deg) / 2.0) * half
    rot_b = math.sin(math.radians(deg)) * half
    shear = 0.03 * severity * (R - 0.5)
    trans = math.floor(severity * (R / 3.0) / 10.0)
    frac = lambda x: int(math.floor(x)) + 1
    return (frac(rot_a), frac(rot_b), frac(shear), int(trans))


# ---------------------------------------------------------------------------
# Per-view parameters: random draws, then a deterministic derivation
# ---------------------------------------------------------------------------


def draw_view_randoms(generator, n_images: int, n_views: int, crop_min: float = 0.08, device="cpu"):
    """Every random number ``sample_view_params`` needs, for ``n_images``
    images of ``n_views`` views (row 0, the base view, draws nothing), with
    JAX's shapes behind a leading image axis: crop draws ``ta``, ``lr``
    ``[N, V-1, 10]`` and ``u_top``, ``u_left``, ``u_flip``, ``m`` ``[N, V-1]``;
    ``depths [N, 3, V-1]`` in 1..3; ``op_idx``, ``u_level``, ``u_sign``
    ``[N, 3, 3, V-1]``; Dirichlet draws ``e_w [N, V-1, 3]`` (exponentials)."""
    N, V = n_images, n_views - 1
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    randint = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=generator, device=device)
    out = draw_rrc(generator, (N, V), crop_min, device=device)
    out.update(
        u_flip=u(N, V),
        depths=randint(1, MAX_CHAIN_DEPTH + 1, N, N_CHAINS, V),
        op_idx=randint(0, N_AUGMIX_OPS, N, N_CHAINS, MAX_CHAIN_DEPTH, V),
        u_level=u(N, N_CHAINS, MAX_CHAIN_DEPTH, V),
        u_sign=u(N, N_CHAINS, MAX_CHAIN_DEPTH, V),
        e_w=torch.empty((N, V, N_CHAINS), device=device).exponential_(generator=generator),
        m=u(N, V),
    )
    return out


def derive_view_params(randoms, *, src_size: int, resolution: int, augmix: bool = True,
                       severity: float = 1.0):
    """Packed kernel parameters ``[N, n_views, ...]`` from the draws of
    ``draw_view_randoms`` (``pallas_augmix.py::sample_view_params`` after its
    draws). Row 0 is the base view: depth 0, m = 1, wm = 0."""
    r = randoms
    N, V = r["u_flip"].shape
    top, left, h, w = rrc_boxes(r["ta"], r["lr"], r["u_top"], r["u_left"], src_size, src_size)
    wmix = r["e_w"] / r["e_w"].sum(dim=-1, keepdim=True)  # Dirichlet(1, 1, 1) as normalized exponentials

    level = 0.1 + r["u_level"] * (severity - 0.1)                   # augmix_ops.py level scalings
    sign = torch.where(r["u_sign"] > 0.5, 1.0, -1.0)
    deg = sign * torch.floor(level * 3.0)
    theta = -(deg * (math.pi / 180.0))
    alpha = torch.tan(theta / 2.0)                                   # rotate = ShX(alpha) ShY(beta) ShX(alpha)
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

    flat9 = lambda a: a.reshape(N, N_CHAINS * MAX_CHAIN_DEPTH, V).transpose(1, 2)  # [N, V, 9], s = chain*3 + step
    depths = r["depths"] if augmix else torch.zeros_like(r["depths"])
    m = pad_front(r["m"], 1.0) if augmix else torch.ones((N, V + 1), device=r["m"].device)
    return {
        "rrc": pad_front(torch.stack([top, left, h, w], dim=-1).float()),
        "flip": pad_front((r["u_flip"] < 0.5).to(torch.int32)),
        "depth": pad_front(depths.transpose(1, 2).to(torch.int32)),
        "ops": pad_front(flat9(o).to(torch.int32)),
        "p0": pad_front(flat9(p0).float()),
        "p1": pad_front(flat9(p1).float()),
        "ip0": pad_front(flat9(ip0).to(torch.int32)),
        "wm": pad_front(wmix.float()),
        "m": m.float(),
    }


def sample_view_params(generator, n_images: int, n_views: int, src_size: int, resolution: int,
                       augmix: bool = True, severity: float = 1.0, crop_min: float = 0.08, device="cpu"):
    """``derive_view_params(draw_view_randoms(...))``: ``[N, n_views, ...]``."""
    randoms = draw_view_randoms(generator, n_images, n_views, crop_min, device=device)
    return derive_view_params(randoms, src_size=src_size, resolution=resolution, augmix=augmix,
                              severity=severity)


def single_op_params(generator, ops, R: int, severity: float = 1.0, device="cpu"):
    """Kernel rows ``[1 + len(ops), ...]`` of one image for a per-op check at
    the identity crop (source size = R): view 0 is the base view, view k
    applies ``ops[k-1]`` alone (one step of chain 0, wm = (1, 0, 0), m = 0)
    at a level and sign sampled at ``severity``."""
    randoms = draw_view_randoms(generator, 1, 1 + len(ops), device=device)
    randoms["op_idx"][:] = torch.as_tensor(ops, device=device)
    p = derive_view_params(randoms, src_size=R, resolution=R, severity=severity)
    new = lambda vals, dtype: torch.tensor(vals, dtype=dtype, device=device)
    p["rrc"][:, 1:] = new([0.0, 0.0, R, R], torch.float32)
    p["flip"][:, 1:] = 0
    p["depth"][:, 1:] = new([1, 0, 0], torch.int32)
    p["wm"][:, 1:] = new([1.0, 0.0, 0.0], torch.float32)
    p["m"][:, 1:] = 0.0
    return flatten_params(p)


def flatten_params(params):
    """``[N, V, ...]`` parameters -> the kernel's ``[N*V, ...]`` rows, contiguous."""
    return {k: params[k].reshape((-1,) + tuple(params[k].shape[2:])).contiguous() for k in PARAM_FIELDS}


# ---------------------------------------------------------------------------
# Interpolation weights
# ---------------------------------------------------------------------------


def bicubic_matrix(src: int, dst: int, device="cpu"):
    """``[dst, src]`` weights of ``jax.image.resize(method='bicubic')`` along
    one axis (``jax._src.image.scale.compute_weight_mat``): the Keys a=-0.5
    kernel, widened by ``max(src/dst, 1)`` when downsampling (antialias),
    columns normalized by their sum, samples outside the input zeroed. In
    float32, step by step as JAX computes it (the sample positions rounded to
    float32 move the weights by up to ~1e-5 against a float64 build)."""
    if src == dst:  # jax.image.resize skips an identity axis
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
    """Triangle-kernel (antialiased bilinear) crop matrix ``[R, S]`` from the
    box scalars (0-dim float32 tensors); ``flip`` reverses the output order
    (``pallas_augmix.py::_resize_weights``). Each row's normalizer is its
    exact sum (float64, a few nonzero float32 terms) rounded once to
    float32, so that it does not depend on the order of the reduction."""
    dev = start.device
    scale = _div(length, R)
    o = torch.arange(R, dtype=torch.float32, device=dev)[:, None]
    if flip:
        o = (R - 1) - o
    centers = start + (o + 0.5) * scale
    src = torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5
    inv = 1.0 / torch.clamp(scale, min=1.0)
    d = (src - centers) * inv
    w = torch.clamp(1.0 - torch.abs(d), min=0.0)
    return w / torch.clamp(w.double().sum(dim=1, keepdim=True).float(), min=1e-12)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the kernel is held to it on the card)
# ---------------------------------------------------------------------------


def _warp(x, shift, axis: int, max_shift: int):
    """1-D shift-blend of ``x [3, R, R]`` along W (``axis=2``, one shift per
    row) or H (``axis=1``, one shift per column), black fill:
    ``(1-f)·x[i+d] + f·x[i+d+1]`` with d = floor(shift) clipped to the tap
    window and f its fraction; the tap d+1 exists only inside the window.
    These are the only two taps of ``_warp_pass`` that carry weight.

    The pair is summed as the reference computes it: ``_warp_pass`` adds its
    taps in chunks of 5, and XLA contracts each product into the running sum
    as a fused multiply-add; the first two terms of a chunk fuse the first
    product, a tap that starts a chunk of more than one tap starts a new
    partial sum, and a chunk of one tap fuses into the accumulator."""
    R = x.shape[axis]
    d0 = torch.floor(shift)
    f = shift - d0
    d = torch.clamp(d0, -max_shift, max_shift).long()
    pos = torch.arange(R, device=x.device)
    per = (lambda t: t[:, None]) if axis == 2 else (lambda t: t[None, :])   # the shift's broadcast
    along = pos[None, :] if axis == 2 else pos[:, None]                     # the index being shifted
    ia = along + per(d)
    ib = ia + 1
    take = lambda i, ok: torch.where(ok, torch.gather(x, axis, i.clamp(0, R - 1).expand_as(x)), 0.0)
    xa = take(ia, (ia >= 0) & (ia < R))
    xb = take(ib, (ib >= 0) & (ib < R) & per(d < max_shift))
    wa, wb = per(1.0 - f), per(f)
    pa, pb = wa * xa, wb * xb
    tap = per(d + max_shift)  # the position of tap d among the window's taps
    single_last = (2 * max_shift + 1) % 5 == 1
    apart = (tap % 5 == 4) & ~((tap + 1 == 2 * max_shift) & single_last)
    return torch.where(apart, pa + pb, torch.where(tap % 5 == 0, _fma(wa, xa, pb), _fma(wb, xb, pa)))


def _equalize(x):
    """PIL ImageOps.equalize per channel of an integer-valued ``[3, R, R]``:
    an integer histogram and PIL's step LUT (``_equalize_plane``'s semantics)."""
    C = x.shape[0]
    xi = x.long().reshape(C, -1)
    hist = torch.stack([torch.bincount(xi[c], minlength=256) for c in range(C)])  # [3, 256]
    cum = torch.cumsum(hist, dim=1) - hist                                         # exclusive
    idx = torch.arange(256, device=x.device).expand(C, 256)
    nz = hist > 0
    last_nz = torch.where(nz, idx, -1).amax(dim=1, keepdim=True)
    h_last = torch.gather(hist, 1, last_nz.clamp(min=0))
    step = (hist.sum(dim=1, keepdim=True) - h_last) // 255
    lut = torch.clamp((step // 2 + cum) // step.clamp(min=1), 0, 255)
    lut = torch.where((nz.sum(dim=1, keepdim=True) <= 1) | (step == 0), idx, lut)
    return torch.gather(lut, 1, xi).reshape(x.shape).to(x.dtype)


def _apply_op(x, op: int, q0, q1, qi: int, shifts):
    """One AugMix op on an integer-valued ``[3, R, R]`` float32 plane stack
    (``pallas_augmix.py::_apply_op``): 0 autocontrast, 1 equalize, 2 posterize,
    3 rotate (three shears, unrounded between), 4 solarize, 5/6 shear x/y,
    7/8 translate x/y. Every op rounds its output."""
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
        return _equalize(x)
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


def augmix_views_reference(images_planar, params, basew, R: int, S: int, V: int, shifts):
    """What ``_augmix_kernel`` computes, view by view and op by op:
    images ``[N, 3, S, S]`` u8, ``params`` rows ``[N*V, ...]``, ``basew``
    ``[R, S]`` f32 -> u8 views ``[N, V, 3, R, R]``. The crop is
    ``wy @ src @ wxᵀ`` on float32 weights, rounded to float32 after each of
    its two products; each dot product is summed in float64 (exact for its
    few nonzero terms), so that it does not depend on the order of summation
    (BLAS's or the kernel's). Then round and clip."""
    N = images_planar.shape[0]
    dev = images_planar.device
    host = {k: params[k].cpu().tolist() for k in ("flip", "depth", "ops", "ip0")}
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
            t = (wy.double() @ src.double()).float()                 # over source rows
            xorig = torch.clamp(torch.round((t.double() @ wx.T.double()).float()), 0.0, 255.0)
            mix = torch.zeros_like(xorig)
            for chain in range(N_CHAINS):
                a = xorig
                for st in range(host["depth"][i][chain]):
                    s = chain * MAX_CHAIN_DEPTH + st
                    a = _apply_op(a, host["ops"][i][s], params["p0"][i, s], params["p1"][i, s],
                                  host["ip0"][i][s], shifts)
                mix = mix + params["wm"][i, chain] * a
            mv = params["m"][i]
            final = mv * xorig + (1.0 - mv) * mix
            out[n, v] = torch.clamp(torch.round(final), 0.0, 255.0).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_LIB_NAME = "rlcf_augmix"
MAX_SHARED_BYTES = 232448   # an H100 block's dynamic shared memory
_STRIP_ROWS = 32            # csrc/augmix.cu kStrip
_TAPS = 6                   # csrc/augmix.cu kTaps
_THREADS = 512              # csrc/augmix.cu kThreads


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _layout(R: int, S: int):
    """``layout`` of the source: (shared bytes, whether plane B lives in the
    device scratch). Two u8 planes of R rows padded to a multiple of 4 bytes
    (the first also holds the crop's tables, the second its float64 strip of
    row sums, up to 32 rows), the rotate's two shift tables, the histogram,
    the byte table and the reduction slots; where that is more than a CTA can
    have (R above ~330), one plane, with the strip behind the tables, and the
    second plane in the scratch."""
    a16 = lambda b: (b + 15) // 16 * 16
    rows = lambda room: max(1, min(_STRIP_ROWS, room // (8 * _round4(S))))
    plane = R * _round4(R)
    tables = 2 * a16(8 * R * _TAPS) + 2 * 16 * R + 4 * R
    rest = 2 * 16 * R + 256 * 4 + 256 + 2 * (_THREADS // 32) * 4 + 16
    two = a16(max(plane, tables)) + a16(max(plane, 8 * _round4(S) * rows(plane))) + rest
    if two <= MAX_SHARED_BYTES:
        return two, False
    t16 = a16(tables)
    return a16(max(plane, t16 + 8 * _round4(S) * rows(max(plane - t16, 0)))) + rest, True


def shared_bytes(R: int, S: int) -> int:
    """The kernel's dynamic shared memory at (R, S) (``_layout``)."""
    return _layout(R, S)[0]


def large_layout(R: int, S: int) -> bool:
    """Whether the kernel keeps its second working plane in the device
    scratch at (R, S): above ~330 px (R = 336, 384, 448 at S = 256)."""
    return _layout(R, S)[1]


def keep_bytes(N: int, V: int, R: int, S: int = 256) -> int:
    """The device scratch the kernel keeps the first two chains' u8 results
    in, and its second working plane where ``large_layout``:
    ``[N*V*3, 2 or 3, R, round4(R)]`` (S: the sources' size, the CLIs' 256)."""
    return N * V * 3 * (3 if large_layout(R, S) else 2) * R * _round4(R)


def build(force: bool = False) -> str:
    """Compile ``csrc/augmix.cu`` for sm_90a without multiply-add contraction
    (``-fmad=false``: each product and sum rounds as in the plain version);
    the ptxas report lands in ``cuda_build.PTXAS["rlcf_augmix"]``."""
    return cuda_build.build("augmix.cu", _LIB_NAME, extra_flags=("-fmad=false",), force=force)


@functools.lru_cache()
def _lib():
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rlcf_augmix_views.argtypes = [vp] * 13 + [ci] * 8 + [vp]
    lib.rlcf_augmix_views.restype = ci
    lib.rlcf_augmix_shared_bytes.argtypes = [ci, ci]
    lib.rlcf_augmix_shared_bytes.restype = ctypes.c_size_t
    lib.rlcf_augmix_keep_planes.argtypes = [ci, ci]
    lib.rlcf_augmix_keep_planes.restype = ci
    return lib


def _check_inputs(images, params, basew, R: int, S: int, V: int, shifts):
    if not images.is_cuda:
        raise ValueError(f"the CUDA AugMix kernel needs a CUDA tensor; got one on {images.device}")
    if images.dtype != torch.uint8:
        raise TypeError(f"the AugMix kernel takes uint8 source images, not {images.dtype}")
    if images.dim() != 4 or tuple(images.shape[1:]) != (3, S, S) or not images.is_contiguous():
        raise ValueError(f"source images must be contiguous [N, 3, {S}, {S}]; got {tuple(images.shape)}")
    if not (1 <= R and 1 <= S <= 0xFFFF and V >= 1):
        raise ValueError(f"the AugMix kernel takes 1 <= R, 1 <= S <= 65535, V >= 1; got R={R}, S={S}, V={V}")
    if shared_bytes(R, S) > MAX_SHARED_BYTES:
        raise ValueError(f"R={R}, S={S} needs {shared_bytes(R, S)} bytes of shared memory per CTA, above the "
                         f"limit of {MAX_SHARED_BYTES} bytes a CTA can have on an H100")
    if len(shifts) != 4 or any(int(s) < 0 for s in shifts):
        raise ValueError(f"shifts must be 4 non-negative tap windows; got {shifts}")
    rows = images.shape[0] * V
    for k in PARAM_FIELDS:
        t = params[k]
        want = (rows,) if _FIELD_WIDTH[k] == 0 else (rows, _FIELD_WIDTH[k])
        dtype = torch.int32 if k in _INT_FIELDS else torch.float32
        if t.device != images.device or t.dtype != dtype or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"param {k!r} must be contiguous {dtype} {list(want)} on {images.device}; "
                             f"got {t.dtype} {list(t.shape)} on {t.device}")
    if basew.device != images.device or basew.dtype != torch.float32 or tuple(basew.shape) != (R, S) \
            or not basew.is_contiguous():
        raise ValueError(f"basew must be contiguous float32 [{R}, {S}] on {images.device}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def launch_views(images_planar_u8, params, basew, R: int, S: int, V: int, shifts):
    """The kernel on CUDA tensors: ``[N, 3, S, S]`` u8 + ``[N*V, ...]``
    parameters + ``basew [R, S]`` -> u8 views ``[N, V, 3, R, R]``, one launch."""
    _check_inputs(images_planar_u8, params, basew, R, S, V, shifts)
    N = images_planar_u8.shape[0]
    dev = images_planar_u8.device
    out = torch.empty((N, V, 3, R, R), dtype=torch.uint8, device=dev)
    keep = torch.empty(keep_bytes(N, V, R, S), dtype=torch.uint8, device=dev)  # kept chains (and plane B)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = _lib().rlcf_augmix_views(
        _ptr(images_planar_u8), _ptr(basew), *(_ptr(params[k]) for k in PARAM_FIELDS), _ptr(out), _ptr(keep),
        N, V, R, S, *(int(s) for s in shifts), stream)
    if rc != 0:
        raise RuntimeError(f"CUDA AugMix kernel failed to launch (error code {rc})")
    LAUNCHES["augmix"] += 1
    LAUNCH_SHAPES[("augmix", N, V, S, R)] += 1
    return out


def augmix_views(images_planar_u8, params, basew, R: int, S: int, V: int, shifts):
    """u8 views ``[N, V, 3, R, R]``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if images_planar_u8.is_cuda:
        return launch_views(images_planar_u8, params, basew, R, S, V, shifts)
    return augmix_views_reference(images_planar_u8, params, basew, R, S, V, shifts)


# ---------------------------------------------------------------------------
# Views and tokens
# ---------------------------------------------------------------------------


def patchify_planar_u8(views, patch_size: int):
    """``[N, V, 3, R, R]`` -> patch-major tokens ``[N, V, (R/p)², p²·3]``,
    feature order (row, col, channel) as ``models.clip.patch_tokens_from_images``."""
    N, V, C, R, _ = views.shape
    g, p = R // patch_size, patch_size
    x = views.reshape(N, V, C, g, p, g, p).permute(0, 1, 3, 5, 4, 6, 2)
    return x.reshape(N, V, g * g, p * p * C)


def fused_views(images_planar_u8, generator, *, n_views: int, resolution: int = 224, src_size: int = 256,
                augmix: bool = True, severity: float = 1.0, crop_min: float = 0.08, max_shift=None,
                p_policy: int = 0, p_reward: int = 0, mesh=None):
    """u8 sources ``[N, 3, S, S]`` -> all views, on the images' device, in
    one kernel launch. The sampler draws on that device from ``generator``.
    Returns planar views ``[N, V, 3, R, R]`` when ``p_policy == 0``, else
    patch-major policy tokens, or a (policy, reward) token pair when
    ``p_reward > 0`` (``pallas_augmix.py::fused_views``).

    With a ``mesh`` (episode DP, ``pallas_augmix.py::fused_views_sharded``)
    the launch builds this dp rank's ``N/dp`` images' views only. Every rank
    draws the whole group's view parameters, in the unsharded order, and
    keeps its rows, so its views equal the unsharded run's bit for bit.
    ``N`` must tile dp."""
    from ..parallel.mesh import dp_slice

    N = images_planar_u8.shape[0]
    if mesh is not None and N % mesh.dp:
        raise ValueError(f"fused_views: batch {N} must tile dp={mesh.dp}")
    dev = images_planar_u8.device
    params = sample_view_params(generator, N, n_views, src_size, resolution, augmix=augmix, severity=severity,
                                crop_min=crop_min, device=dev)
    mine = {k: dp_slice(mesh, v) for k, v in params.items()}
    basew = bicubic_matrix(src_size, resolution, device=dev)
    shifts = (max_shift,) * 4 if max_shift is not None else op_shift_bounds(severity, resolution)
    views = augmix_views(dp_slice(mesh, images_planar_u8).contiguous(), flatten_params(mine), basew, resolution,
                         src_size, n_views, shifts)
    if p_policy == 0:
        return views
    ptoks = patchify_planar_u8(views, p_policy)
    if p_reward == 0:
        return ptoks
    return ptoks, patchify_planar_u8(views, p_reward)


def fused_views_sharded(images_planar_u8, generator, mesh, **kw):
    """``fused_views`` of this dp rank's images of the group (the name of
    ``pallas_augmix.py::fused_views_sharded``)."""
    return fused_views(images_planar_u8, generator, mesh=mesh, **kw)
