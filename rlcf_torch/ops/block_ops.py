"""The CLIP residual block's pointwise work, forward and backward: LayerNorm
(alone, or fused with the bias and the residual add before it), bias +
QuickGELU and bias + residual, as hand-written CUDA kernels for the H100
(``csrc/block_ops.cu``) and their plain PyTorch versions.

They replace no TPU kernel: the JAX package writes this work as plain jnp
code, which XLA fuses on the TPU. Run as PyTorch's own elementwise kernels it
was ~30 launches a block forward and ~45 backward, mostly fp32 passes over
the activation. Here each is one launch (a weight gradient adds a column-sum
pass and an ordered reduction, only where a weight needs its gradient).

Functions (``models/layers.py``'s block calls them; every LayerNorm of the
port goes through ``layer_norm``):

- ``layer_norm(x, weight, bias, eps)``: LN in fp32 (population variance),
  weight and bias widened to fp32, rounded once to x's dtype.
- ``add_layer_norm(x, a, a_bias, weight, bias, eps) -> (y, LN(y))``,
  ``y = x + (a + a_bias)`` rounded to x's dtype: the attention projection's
  bias, the residual and the second LayerNorm.
- ``bias_quick_gelu(a, bias)``: ``u * sigmoid(1.702 u)``, ``u = a + bias``.
- ``bias_residual(x, a, bias)``: ``x + (a + bias)``.

Weights and biases are ``[D]``, or ``[N, D]`` per episode with activations
``[N, ..., D]``; a shared weight expanded to ``[N, D]`` (stride 0) is read as
one row. The kernels take bf16 or fp32 activations and weights and any D
(a LayerNorm row up to 2048 wide in one warp's registers, a wider one, as
OPT's 2560 to 9216, by one CTA), 16-byte vector accesses where D and the
pointers allow, one element a thread otherwise.

Each is a ``torch.library`` custom op (``rlcf::layer_norm``,
``rlcf::add_layer_norm``, ``rlcf::bias_quick_gelu``, ``rlcf::bias_residual``)
whose gradient is another (``rlcf::layer_norm_bwd``,
``rlcf::bias_quick_gelu_bwd``, ``rlcf::bias_grad``), so that a graph capture
(``torch.export``) records them as nodes; an eager call on the card takes a
``torch.autograd.Function`` around the same launchers instead, a fraction of
the custom op's host cost. On a CUDA tensor the functions launch the kernels
or raise; on any other tensor they run the plain version, the port's
composition of stock ops (their CPU numbers and gradients are what they were
before the kernels). The ops' CPU implementations are the plain versions too,
with the backward written out as the kernels compute it (``*_bwd_plain``),
for the tests. ``LAUNCHES`` counts kernel launches by kernel and variant,
and each launch adds to the program's ``block_ops`` counter
(``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from ..utils import profiling
from . import cuda_build

COL_THREADS = 256        # threads a CTA of the column kernels (csrc/block_ops.cu, kColThreads)
TARGET_CTAS = 132 * 8    # CTAs a column kernel spreads a launch over: 8 an SM of the H100
_LIB_NAME = "rlcf_block_ops"
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by the wrappers, by kernel and variant (plain integers): LayerNorm
# alone and after the bias and residual, its backward, bias + QuickGELU and its
# backward, bias + residual, and the weight gradients' column sums and reductions
LAUNCHES = {"ln_fwd": 0, "add_ln_fwd": 0, "ln_bwd": 0, "bias_gelu_fwd": 0, "bias_gelu_bwd": 0,
            "bias_residual_fwd": 0, "col_sums": 0, "reduce": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the kernels are held to them on the card)
# ---------------------------------------------------------------------------


def per_episode(v, x):
    """A per-episode parameter ``[N, *s]`` viewed to broadcast against ``x [N, ..., *s]``."""
    return v.reshape(v.shape[:1] + (1,) * (x.dim() - v.dim()) + v.shape[1:])


def _bias(b, a):
    """A bias ``[D]`` or ``[N, D]`` cast to a's dtype, to broadcast against ``a``."""
    return (per_episode(b, a) if b.dim() == 2 else b).to(a.dtype)


def _wide(t):
    """``t`` in fp32, or float64 where it is (the plain backward formulas are
    checked in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """LayerNorm computed in fp32 (population variance), cast back to x's
    dtype; ``weight``/``bias`` ``[D]``, or ``[N, D]`` per episode."""
    if weight.dim() == 2:
        weight, bias = per_episode(weight, x), per_episode(bias, x)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_stats_plain(x, weight, bias, eps: float = 1e-5):
    """``(layer_norm_plain(x, ...), stats)``, ``stats [2, *x.shape[:-1]]``
    each row's mean and rstd in fp32 (float64 for a float64 x, which is then
    normalised in float64)."""
    if weight.dim() == 2:
        weight, bias = per_episode(weight, x), per_episode(bias, x)
    x32 = _wide(x)
    mean = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(x32.var(dim=-1, keepdim=True, correction=0) + eps)
    y = (x32 - mean) * rstd
    y = y * _wide(weight) + _wide(bias)
    return y.to(x.dtype), torch.stack((mean.squeeze(-1), rstd.squeeze(-1)))


def add_layer_norm_plain(x, a, a_bias, weight, bias, eps: float = 1e-5):
    """``(y, LN(y))`` with ``y = x + (a + a_bias)``."""
    y = x + (a + _bias(a_bias, a))
    return y, layer_norm_plain(y, weight, bias, eps)


def bias_quick_gelu_plain(a, bias):
    u = a + _bias(bias, a)
    return u * torch.sigmoid(1.702 * u)


def bias_residual_plain(x, a, bias):
    return x + (a + _bias(bias, a))


def column_sum_plain(t, like):
    """The fp32 sums of ``t [..., D]`` over its rows in the shape and dtype of
    the weight ``like``: ``[D]``, or ``[N, D]`` over each episode's rows."""
    t = _wide(t)
    d = t.shape[-1]
    s = t.reshape(like.shape[0], -1, d).sum(1) if like.dim() == 2 else t.reshape(-1, d).sum(0)
    return s.to(like.dtype)


def layer_norm_bwd_plain(y, g, gy, stats, weight, a_bias=None, need_w: bool = False):
    """The LayerNorm backward as the kernels compute it: ``[dx]`` (+ ``[dw,
    db]`` where ``need_w``, + ``[da_bias]`` where ``a_bias`` is given), ``dx =
    rstd (g w - mean(g w) - xhat mean(g w xhat)) + gy`` in fp32 (float64 for
    float64) rounded once,
    ``dw = sum g xhat``, ``db = sum g``, ``da_bias = sum dx`` (the rounded dx)."""
    mean, rstd = stats[0], stats[1]
    w = _wide(per_episode(weight, y) if weight.dim() == 2 else weight)
    xh = (_wide(y) - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)
    gw = _wide(g) * w
    dx = rstd.unsqueeze(-1) * (gw - gw.mean(-1, keepdim=True) - xh * (gw * xh).mean(-1, keepdim=True))
    if gy is not None:
        dx = dx + _wide(gy)
    dx = dx.to(y.dtype)
    out = [dx]
    if need_w:
        out += [column_sum_plain(_wide(g) * xh, weight), column_sum_plain(g, weight)]
    if a_bias is not None:
        out.append(column_sum_plain(dx, a_bias))
    return out


def bias_quick_gelu_bwd_plain(a, bias, g, need_bias: bool = False):
    """``[da]`` (+ ``[dbias]``): ``da = g (s + 1.702 u s (1 - s))``, ``u = a +
    bias`` and ``s = sigmoid(1.702 u)`` in fp32, rounded once; ``dbias`` the
    sum of the rounded da."""
    u = _wide(a) + _wide(per_episode(bias, a) if bias.dim() == 2 else bias)
    s = torch.sigmoid(1.702 * u)
    da = (_wide(g) * (s + 1.702 * u * s * (1 - s))).to(a.dtype)
    return [da, column_sum_plain(da, bias)] if need_bias else [da]


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------


def build(force: bool = False) -> str:
    """Compile ``csrc/block_ops.cu`` for sm_90a; returns the library path.
    The ptxas report lands in ``cuda_build.PTXAS["rlcf_block_ops"]``."""
    return cuda_build.build("block_ops.cu", _LIB_NAME, force=force)


@functools.lru_cache()
def _lib():
    lib = ctypes.CDLL(build())
    vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rlcf_block_ln_fwd.argtypes = [vp, vp, vp, cl, vp, cl, vp, cl, vp, vp, vp, vp, ci, ci, ci, cf, ci, ci, ci, vp]
    lib.rlcf_block_ln_bwd.argtypes = [vp, vp, vp, vp, vp, vp, cl, vp, ci, ci, ci, ci, ci, ci, vp]
    cols = [ci] * 8   # d, rpe, n, bx, by, tiles, ctas, chunk
    lib.rlcf_block_bias_act.argtypes = [ci, vp, vp, vp, cl, vp, *cols, ci, ci, ci, vp]
    lib.rlcf_block_gelu_bwd.argtypes = [vp, vp, cl, vp, vp, vp, *cols, ci, ci, ci, vp]
    lib.rlcf_block_col_sums.argtypes = [ci, vp, vp, vp, vp, vp, vp, *cols, ci, ci, vp]
    lib.rlcf_block_reduce.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    for fn in (lib.rlcf_block_ln_fwd, lib.rlcf_block_ln_bwd, lib.rlcf_block_bias_act, lib.rlcf_block_gelu_bwd,
               lib.rlcf_block_col_sums, lib.rlcf_block_reduce):
        fn.restype = ci
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _launched(kernel: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"CUDA block kernel {kernel} failed to launch (error code {rc})")
    LAUNCHES[kernel] += 1
    profiling.count("block_ops")


def _code(t, what: str) -> int:
    code = _TYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the block kernels take float32 or bfloat16 {what}, not {t.dtype}")
    return code


def _act(t, like=None):
    """The activation ``t`` on the card (of ``like``'s dtype and shape), contiguous."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA block kernels need CUDA tensors; got one on {t.device}")
    if like is not None and (t.dtype != like.dtype or t.shape != like.shape):
        raise ValueError(f"the block kernels need activations of one dtype and shape; got {t.dtype} "
                         f"{tuple(t.shape)} beside {like.dtype} {tuple(like.shape)}")
    return t.contiguous()


def _weights(ws, x, d: int):
    """``(episodes, [(weight, stride), ...])`` for the weights and biases
    ``ws`` of one launch: each ``[d]`` (stride 0, one episode) or ``[N, d]``
    per episode of ``x [N, ..., d]`` (its row stride, 0 where expanded from
    one); all of one dtype, on the card, with contiguous rows."""
    n, out = 1, []
    for w in ws:
        if not w.is_cuda:
            raise ValueError(f"the CUDA block kernels need CUDA weights; got one on {w.device}")
        if w.dtype != ws[0].dtype:
            raise TypeError(f"the block kernels take the weights of a launch in one dtype; got {w.dtype} "
                            f"beside {ws[0].dtype}")
        dim = w.dim()
        if dim not in (1, 2) or w.shape[-1] != d or (dim == 2 and w.shape[0] != x.shape[0]):
            raise ValueError(f"a block weight must be [{d}], or [N, {d}] with activations [N, ..., {d}]; "
                             f"got {tuple(w.shape)} beside {tuple(x.shape)}")
        if w.stride(-1) != 1:
            w = w.contiguous()
        if dim == 2:
            if n not in (1, w.shape[0]):
                raise ValueError(f"per-episode weights of {n} and {w.shape[0]} episodes in one launch")
            n = w.shape[0]
        out.append((w, w.stride(0) if dim == 2 else 0))
    return n, out


def _vec(d: int, size: int, acts, weights) -> int:
    """1 where 16-byte vector accesses of elements of ``size`` bytes reach
    every element: D a multiple of the vector and every pointer and weight row
    aligned to its access."""
    v = 16 // size
    if d % v:
        return 0
    for t in acts:
        if t is not None and t.data_ptr() % 16:
            return 0
    for w, stride in weights:
        align = min(16, v * w.element_size())
        if w.data_ptr() % align or stride * w.element_size() % align:
            return 0
    return 1


def column_layout(d: int, v: int, rpe: int, n: int):
    """``(bx, by, tiles, ctas, chunk)`` of a column kernel over ``n``
    episodes of ``rpe`` rows of ``d`` columns, ``v`` a vector: ``bx`` threads
    over the column vectors (a multiple of 32, at most 256), ``by`` over rows,
    ``tiles`` CTAs across the columns, ``ctas`` an episode, ``chunk`` rows a
    CTA, so that a launch spreads over ~``TARGET_CTAS`` CTAs."""
    nvec = -(-d // v)
    bx = min(COL_THREADS, -(-nvec // 32) * 32)
    by = max(1, COL_THREADS // bx)
    tiles = -(-nvec // bx)
    per_ep = max(1, TARGET_CTAS // (tiles * n))
    chunk = max(4 * by, -(-rpe // per_ep))
    return bx, by, tiles, -(-rpe // chunk), chunk


def _reduce(part, likes, n: int, ctas: int, d: int):
    """The weight gradients ``[D]`` or ``[N, D]`` (each ``likes``' shape and
    dtype) from the partial column sums ``part [n, ctas, len(likes), d]``:
    summed over each episode's CTAs, or over all of them for a shared weight,
    in a fixed order. One launch for each run of likes of one shape."""
    k = len(likes)
    outs = [torch.empty(w.shape, dtype=w.dtype, device=part.device) for w in likes]
    q = 0
    while q < k:
        e = q + 1
        while e < k and likes[e].shape == likes[q].shape:
            e += 1
        nout, cred = (n, ctas) if likes[q].dim() == 2 else (1, n * ctas)
        o = outs[q:e] + [None] * (3 - (e - q))
        rc = _lib().rlcf_block_reduce(part.data_ptr(), *map(_ptr, o), d, k, q, e - q, nout, cred,
                                      _code(likes[q], "weights"), _stream(part))
        _launched("reduce", rc)
        q = e
    return outs


def _col_sums(kind: int, g, y, dx, stats, likes, n: int, rpe: int, d: int, vec: int):
    """Launch ``col_sums`` of ``kind`` (0: g; 1: g xhat, g; 2: and dx) and
    reduce its partials into the weight gradients shaped as ``likes``."""
    v = 16 // g.element_size() if vec else 1
    bx, by, tiles, ctas, chunk = column_layout(d, v, rpe, n)
    part = torch.empty((n, ctas, kind + 1, d), dtype=torch.float32, device=g.device)
    sp = stats.data_ptr() if stats is not None else None
    rc = _lib().rlcf_block_col_sums(kind, g.data_ptr(), _ptr(y), _ptr(dx), sp, sp and sp + 4 * n * rpe,
                                    part.data_ptr(), d, rpe, n, bx, by, tiles, ctas, chunk, _code(g, "activations"),
                                    vec, _stream(g))
    _launched("col_sums", rc)
    return _reduce(part, likes, n, ctas, d)


def launch_layer_norm(x, weight, bias, eps: float, a=None, a_bias=None):
    """LayerNorm kernel on CUDA tensors: ``(y, LN(y), stats)`` with ``y = x +
    (a + a_bias)`` where ``a`` is given, else ``(None, LN(x), stats)``;
    ``stats [2, *x.shape[:-1]]`` each row's mean and rstd in fp32. Launches
    or raises."""
    x = _act(x)
    d = x.shape[-1]
    dt = _code(x, "activations")
    if d < 1:
        raise ValueError("the LayerNorm kernel takes rows of 1 element or more; got 0")
    if a is None:
        n, ws = _weights((weight, bias), x, d)
        ab, s_ab, y = None, 0, None
    else:
        a = _act(a, x)
        n, ws = _weights((weight, bias, a_bias), x, d)
        ab, s_ab = ws[2]
        y = torch.empty_like(x)
    (w, s_w), (b, s_b) = ws[0], ws[1]
    out = torch.empty_like(x)
    stats = torch.empty((2,) + x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = x.numel() // d
    if rows:
        sp = stats.data_ptr()
        rc = _lib().rlcf_block_ln_fwd(x.data_ptr(), _ptr(a), _ptr(ab), s_ab, w.data_ptr(), s_w, b.data_ptr(), s_b,
                                      _ptr(y), out.data_ptr(), sp, sp + 4 * rows, rows, d, rows // n, float(eps), dt,
                                      _code(w, "weights"), _vec(d, x.element_size(), (x, a, y, out), ws), _stream(x))
        _launched("ln_fwd" if a is None else "add_ln_fwd", rc)
    return y, out, stats


def launch_layer_norm_bwd(y, g, gy, stats, weight, a_bias=None, need_w: bool = False):
    """The LayerNorm backward on CUDA tensors (``layer_norm_bwd_plain``'s
    list). Launches or raises."""
    y = _act(y)
    g = _act(g, y)
    gy = None if gy is None else _act(gy, y)
    stats = stats.contiguous()
    d = y.shape[-1]
    n, ws = _weights((weight,), y, d)
    dx = torch.empty_like(y)
    rows = y.numel() // d
    vec = _vec(d, y.element_size(), (y, g, gy, dx), ws)
    if rows:
        sp = stats.data_ptr()
        rc = _lib().rlcf_block_ln_bwd(y.data_ptr(), g.data_ptr(), _ptr(gy), sp, sp + 4 * rows, ws[0][0].data_ptr(),
                                      ws[0][1], dx.data_ptr(), rows, d, rows // n, _code(y, "activations"),
                                      _code(weight, "weights"), vec, _stream(y))
        _launched("ln_bwd", rc)
    if not need_w and a_bias is None:
        return [dx]
    likes = ([weight, weight] if need_w else []) + ([a_bias] if a_bias is not None else [])
    if a_bias is not None and a_bias.dim() == 2:
        n = a_bias.shape[0]
    if not rows:
        return [dx] + [torch.zeros_like(w) for w in likes]
    kind = 0 if not need_w else 2 if a_bias is not None else 1
    return [dx] + _col_sums(kind, dx if kind == 0 else g, y, dx, stats, likes, n, rows // n, d, vec)


def _bias_launch(kind: int, x, a, bias):
    """``bias_act`` of ``kind`` (0: QuickGELU(a + bias); 1: x + (a + bias))."""
    a = _act(a)
    x = None if x is None else _act(x, a)
    d = a.shape[-1]
    n, ws = _weights((bias,), a, d)
    out = torch.empty_like(a)
    rows = a.numel() // d
    if rows:
        vec = _vec(d, a.element_size(), (x, a, out), ws)
        layout = column_layout(d, 16 // a.element_size() if vec else 1, rows // n, n)
        rc = _lib().rlcf_block_bias_act(kind, _ptr(x), a.data_ptr(), ws[0][0].data_ptr(), ws[0][1], out.data_ptr(),
                                        d, rows // n, n, *layout, _code(a, "activations"), _code(bias, "weights"),
                                        vec, _stream(a))
        _launched("bias_gelu_fwd" if kind == 0 else "bias_residual_fwd", rc)
    return out


def launch_bias_quick_gelu(a, bias):
    """``QuickGELU(a + bias)`` on CUDA tensors. Launches or raises."""
    return _bias_launch(0, None, a, bias)


def launch_bias_residual(x, a, bias):
    """``x + (a + bias)`` on CUDA tensors. Launches or raises."""
    return _bias_launch(1, x, a, bias)


def launch_bias_quick_gelu_bwd(a, bias, g, need_bias: bool = False):
    """``bias_quick_gelu_bwd_plain``'s list on CUDA tensors. Launches or raises."""
    a = _act(a)
    g = _act(g, a)
    d = a.shape[-1]
    n, ws = _weights((bias,), a, d)
    da = torch.empty_like(a)
    rows = a.numel() // d
    if not rows:
        return [da, torch.zeros_like(bias)] if need_bias else [da]
    vec = _vec(d, a.element_size(), (a, g, da), ws)
    bx, by, tiles, ctas, chunk = column_layout(d, 16 // a.element_size() if vec else 1, rows // n, n)
    part = torch.empty((n, ctas, 1, d), dtype=torch.float32, device=a.device) if need_bias else None
    rc = _lib().rlcf_block_gelu_bwd(a.data_ptr(), ws[0][0].data_ptr(), ws[0][1], g.data_ptr(), da.data_ptr(),
                                    _ptr(part), d, rows // n, n, bx, by, tiles, ctas, chunk, _code(a, "activations"),
                                    _code(bias, "weights"), vec, _stream(a))
    _launched("bias_gelu_bwd", rc)
    return [da] + (_reduce(part, [bias], n, ctas, d) if need_bias else [])


def launch_bias_grad(g, bias):
    """The column sums of ``g`` shaped as ``bias`` (``column_sum_plain``) on
    CUDA tensors. Launches or raises."""
    g = _act(g)
    d = g.shape[-1]
    n, _ = _weights((bias,), g, d)
    rows = g.numel() // d
    if not rows:
        return torch.zeros_like(bias)
    return _col_sums(0, g, None, None, None, [bias], n, rows // n, d, _vec(d, g.element_size(), (g,), ()))[0]


# ---------------------------------------------------------------------------
# Routes to the kernels: custom ops for graph captures, autograd Functions eagerly
# ---------------------------------------------------------------------------
# As ``ops/attention.py``'s custom ops: the CUDA implementation launches the
# kernel, the CPU one is the plain version, the fake one gives the outputs'
# shapes, and each forward op is wired to its backward op with
# ``register_autograd``, so that a capture (``utils/export.py``) records them.
# An eager call on the card takes a ``torch.autograd.Function`` around the same
# launchers, saving the same tensors, with the same gradient rules
# (``_*_grads``), or the launcher alone where no gradient is taken: a custom
# op's dispatch and autograd wrapper cost the host about as much again as the
# launch (PERF.md §6).


def _eager(x) -> bool:
    """True outside any graph capture: a plain tensor, no torch dispatch
    mode (``make_fx``'s proxy and fake modes, ``torch.export``'s) and no
    dynamo trace."""
    return type(x) is torch.Tensor and not torch._C._len_torch_dispatch_stack() and not torch.compiler.is_compiling()


def _stats_like(x):
    return x.new_empty((2,) + x.shape[:-1], dtype=torch.float32)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _ln_grads(ctx, g, bwd):
    """The gradients of ``(x, weight, bias, eps)``: dx always, the weights'
    where they need them. A gradient not given is None (the custom ops
    materialize none): zeros for the LayerNorm's output, nothing added for
    the residual's."""
    x, stats, weight = ctx.saved_tensors
    g = torch.zeros_like(x) if g is None else g
    need_w = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
    grads = bwd(x, g, None, stats, weight, None, need_w)
    return grads[0], *(grads[1:3] if need_w else (None, None)), None


def _add_ln_grads(ctx, g_y, g, bwd):
    """The gradients of ``(x, a, a_bias, weight, bias, eps)``: ``dx = da``
    (the LayerNorm's backward plus the residual's gradient ``g_y``), the
    biases' and weights' where they need them."""
    y, stats, weight, a_bias = ctx.saved_tensors
    g = torch.zeros_like(y) if g is None else g
    need_w = ctx.needs_input_grad[3] or ctx.needs_input_grad[4]
    need_ab = ctx.needs_input_grad[2]
    grads = bwd(y, g, g_y, stats, weight, a_bias if need_ab else None, need_w)
    dx = grads[0]
    return dx, dx, grads[-1] if need_ab else None, *(grads[1:3] if need_w else (None, None)), None


def _gelu_grads(ctx, g, bwd):
    a, bias = ctx.saved_tensors
    grads = bwd(a, bias, g, ctx.needs_input_grad[1])
    return grads[0], grads[1] if ctx.needs_input_grad[1] else None


def _residual_grads(ctx, g, bias_grad):
    (bias,) = ctx.saved_tensors
    return g, g, bias_grad(g, bias) if ctx.needs_input_grad[2] else None


@torch.library.custom_op("rlcf::layer_norm", mutates_args=(), device_types="cuda")
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return launch_layer_norm(x, weight, bias, eps)[1:]


@_layer_norm_op.register_kernel("cpu")
def _(x, weight, bias, eps):
    return layer_norm_stats_plain(x, weight, bias, eps)


@_layer_norm_op.register_fake
def _(x, weight, bias, eps):
    return x.new_empty(x.shape), _stats_like(x)


@torch.library.custom_op("rlcf::add_layer_norm", mutates_args=(), device_types="cuda")
def _add_layer_norm_op(x: torch.Tensor, a: torch.Tensor, a_bias: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return launch_layer_norm(x, weight, bias, eps, a, a_bias)


@_add_layer_norm_op.register_kernel("cpu")
def _(x, a, a_bias, weight, bias, eps):
    y = x + (a + _bias(a_bias, a))
    return (y, *layer_norm_stats_plain(y, weight, bias, eps))


@_add_layer_norm_op.register_fake
def _(x, a, a_bias, weight, bias, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape), _stats_like(x)


@torch.library.custom_op("rlcf::layer_norm_bwd", mutates_args=(), device_types="cuda")
def _layer_norm_bwd_op(y: torch.Tensor, g: torch.Tensor, gy: Optional[torch.Tensor], stats: torch.Tensor,
                       weight: torch.Tensor, a_bias: Optional[torch.Tensor], need_w: bool) -> List[torch.Tensor]:
    return launch_layer_norm_bwd(y, g, gy, stats, weight, a_bias, need_w)


@_layer_norm_bwd_op.register_kernel("cpu")
def _(y, g, gy, stats, weight, a_bias, need_w):
    return layer_norm_bwd_plain(y, g, gy, stats, weight, a_bias, need_w)


@_layer_norm_bwd_op.register_fake
def _(y, g, gy, stats, weight, a_bias, need_w):
    likes = ([weight, weight] if need_w else []) + ([a_bias] if a_bias is not None else [])
    return [y.new_empty(y.shape)] + [w.new_empty(w.shape) for w in likes]


def _ln_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output[1], inputs[1])
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)   # no zeros filled in for the statistics' gradient


_layer_norm_op.register_autograd(lambda ctx, g, *_: _ln_grads(ctx, g, _layer_norm_bwd_op), setup_context=_ln_setup)


def _add_ln_setup(ctx, inputs, output):
    ctx.save_for_backward(output[0], output[2], inputs[3], inputs[2])
    ctx.mark_non_differentiable(output[2])
    ctx.set_materialize_grads(False)


_add_layer_norm_op.register_autograd(lambda ctx, g_y, g, *_: _add_ln_grads(ctx, g_y, g, _layer_norm_bwd_op),
                                     setup_context=_add_ln_setup)


@torch.library.custom_op("rlcf::bias_quick_gelu", mutates_args=(), device_types="cuda")
def _bias_quick_gelu_op(a: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return launch_bias_quick_gelu(a, bias)


@_bias_quick_gelu_op.register_kernel("cpu")
def _(a, bias):
    return bias_quick_gelu_plain(a, bias)


@_bias_quick_gelu_op.register_fake
def _(a, bias):
    return a.new_empty(a.shape)


@torch.library.custom_op("rlcf::bias_quick_gelu_bwd", mutates_args=(), device_types="cuda")
def _bias_quick_gelu_bwd_op(a: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                            need_bias: bool) -> List[torch.Tensor]:
    return launch_bias_quick_gelu_bwd(a, bias, g, need_bias)


@_bias_quick_gelu_bwd_op.register_kernel("cpu")
def _(a, bias, g, need_bias):
    return bias_quick_gelu_bwd_plain(a, bias, g, need_bias)


@_bias_quick_gelu_bwd_op.register_fake
def _(a, bias, g, need_bias):
    return [a.new_empty(a.shape)] + ([bias.new_empty(bias.shape)] if need_bias else [])


_bias_quick_gelu_op.register_autograd(lambda ctx, g: _gelu_grads(ctx, g, _bias_quick_gelu_bwd_op),
                                      setup_context=lambda ctx, inputs, output: ctx.save_for_backward(*inputs))


@torch.library.custom_op("rlcf::bias_residual", mutates_args=(), device_types="cuda")
def _bias_residual_op(x: torch.Tensor, a: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return launch_bias_residual(x, a, bias)


@_bias_residual_op.register_kernel("cpu")
def _(x, a, bias):
    return bias_residual_plain(x, a, bias)


@_bias_residual_op.register_fake
def _(x, a, bias):
    return x.new_empty(x.shape)


@torch.library.custom_op("rlcf::bias_grad", mutates_args=(), device_types="cuda")
def _bias_grad_op(g: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return launch_bias_grad(g, bias)


@_bias_grad_op.register_kernel("cpu")
def _(g, bias):
    return column_sum_plain(g, bias)


@_bias_grad_op.register_fake
def _(g, bias):
    return bias.new_empty(bias.shape)


_bias_residual_op.register_autograd(lambda ctx, g: _residual_grads(ctx, g, _bias_grad_op),
                                    setup_context=lambda ctx, inputs, output: ctx.save_for_backward(inputs[2]))


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        _, out, stats = launch_layer_norm(x, weight, bias, eps)
        ctx.save_for_backward(x, stats, weight)
        return out

    @staticmethod
    def backward(ctx, g):
        return _ln_grads(ctx, g, launch_layer_norm_bwd)


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, a_bias, weight, bias, eps):
        y, out, stats = launch_layer_norm(x, weight, bias, eps, a, a_bias)
        ctx.save_for_backward(y, stats, weight, a_bias)
        return y, out

    @staticmethod
    def backward(ctx, g_y, g):
        return _add_ln_grads(ctx, g_y, g, launch_layer_norm_bwd)


class _BiasQuickGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, bias):
        ctx.save_for_backward(a, bias)
        return launch_bias_quick_gelu(a, bias)

    @staticmethod
    def backward(ctx, g):
        return _gelu_grads(ctx, g, launch_bias_quick_gelu_bwd)


class _BiasResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, bias):
        ctx.save_for_backward(bias)
        return launch_bias_residual(x, a, bias)

    @staticmethod
    def backward(ctx, g):
        return _residual_grads(ctx, g, launch_bias_grad)


# ---------------------------------------------------------------------------
# The functions the models call
# ---------------------------------------------------------------------------


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm computed in fp32 (population variance), cast back to x's
    dtype; ``weight``/``bias`` ``[D]``, or ``[N, D]`` per episode. The kernel
    on a CUDA tensor (launched directly where no gradient is taken), the plain
    version otherwise."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps)
    if not _eager(x):
        return _layer_norm_op(x, weight, bias, float(eps))[0]
    if _needs_grad(x, weight, bias):
        return _LayerNorm.apply(x, weight, bias, float(eps))
    return launch_layer_norm(x, weight, bias, float(eps))[1]


def add_layer_norm(x, a, a_bias, weight, bias, eps: float = 1e-5):
    """``(y, LN(y))`` with ``y = x + (a + a_bias)`` (the projection's bias
    first, as ``linear`` adds it), as ``layer_norm``."""
    if not x.is_cuda:
        return add_layer_norm_plain(x, a, a_bias, weight, bias, eps)
    if not _eager(x):
        return _add_layer_norm_op(x, a, a_bias, weight, bias, float(eps))[:2]
    if _needs_grad(x, a, a_bias, weight, bias):
        return _AddLayerNorm.apply(x, a, a_bias, weight, bias, float(eps))
    return launch_layer_norm(x, weight, bias, float(eps), a, a_bias)[:2]


def bias_quick_gelu(a, bias):
    """``u * sigmoid(1.702 u)`` with ``u = a + bias``, as ``layer_norm``."""
    if not a.is_cuda:
        return bias_quick_gelu_plain(a, bias)
    if not _eager(a):
        return _bias_quick_gelu_op(a, bias)
    return _BiasQuickGelu.apply(a, bias) if _needs_grad(a, bias) else launch_bias_quick_gelu(a, bias)


def bias_residual(x, a, bias):
    """``x + (a + bias)``, as ``layer_norm``."""
    if not x.is_cuda:
        return bias_residual_plain(x, a, bias)
    if not _eager(x):
        return _bias_residual_op(x, a, bias)
    return _BiasResidual.apply(x, a, bias) if _needs_grad(x, a, bias) else launch_bias_residual(x, a, bias)
