"""Fused multi-head attention from the unsplit QKV projection, forward and
backward: hand-written CUDA kernels for Hopper (``csrc/attention_mma.cu`` and
``csrc/attention_bwd_mma.cu``: the bf16 forward and backward on the tensor
cores; ``csrc/attention.cu``: the fp32 forward and backward on the CUDA
cores) and their plain PyTorch version.

Replaces the TPU kernels ``_mha_fwd_kernel`` / ``_mha_bwd_kernel`` of
``rlcf_tpu/ops/pallas_attention.py`` (``fused_attention``, a custom VJP).
Function: ``qkv [B, T, 3*H*D]`` (+ an optional additive ``[T, T]`` mask, -inf
clamped to -1e9) -> ``[B, T, H*D]``. Scores ``q.k * scale`` in fp32, a
max-subtracted fp32 softmax, probabilities rounded to the input dtype before
``P.V``, fp32 accumulation. The backward recomputes P in fp32 and returns
``dqkv`` in the fused layout: ``dv = P^T g``, ``dp = g v^T``,
``ds = P * (dp - rowsum(dp * P))``, ``dq = ds k * scale``,
``dk = ds^T q * scale``.

``fused_attention`` is a ``torch.autograd.Function``: a CUDA tensor runs the
CUDA kernels (or raises), a CPU tensor runs the plain version. ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernel.
Which kernel a CUDA tensor runs is a rule of ``(T, dtype)`` in both
directions (``forward_variant``, ``backward_variant``), not a fallback: bf16
goes to the tensor-core kernels (one warp per head on ``mma.sync`` for
``T <= 16``, warpgroups per 64 rows on ``wgmma`` above), fp32 to the
CUDA-core kernels, because TF32 would not hold fp32's 1e-5 (forward) and 1e-4
(backward) tolerances.

Each source is built at first use with ``nvcc`` for ``sm_90a`` into the
package's git-ignored ``_build/`` directory as a plain-C shared library and
bound with ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import cuda_build

NEG_BIG = -1e9  # finite stand-in for the causal mask's -inf
HEAD_DIM = 64   # the kernel's head dimension
MAX_T = 257     # the kernel's longest sequence (ViT-L/14 at 224 px)
SHORT_T = 16    # longest sequence of the tensor-core kernels' one-warp-per-head regime

# kernel launches by the wrapper, per direction (plain integers), per
# (direction, B, T, H, dtype), and per variant (the forward's under its name,
# the backward's under "bwd_" + its name)
LAUNCHES = {"fwd": 0, "bwd": 0}
LAUNCH_SHAPES = collections.Counter()
LAUNCH_VARIANTS = collections.Counter()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()
    LAUNCH_VARIANTS.clear()


def prep_mask(mask):
    """Clamp -inf to a finite floor (exp after max-subtraction gives exact 0)."""
    return None if mask is None else torch.clamp(mask.to(torch.float32), min=NEG_BIG).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the kernel is held to it on the card)
# ---------------------------------------------------------------------------


def _split_heads(qkv, n_heads: int):
    B, T, threeHD = qkv.shape
    D = threeHD // 3 // n_heads
    q, k, v = qkv.float().split(threeHD // 3, dim=-1)
    sh = lambda t: t.reshape(B, T, n_heads, D).transpose(1, 2)  # [B, H, T, D]
    return sh(q), sh(k), sh(v)


def _probs(q, k, mask, scale: float):
    s = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask
    return torch.softmax(s, dim=-1)


def fused_attention_reference(qkv, mask, n_heads: int, scale: float):
    """Forward: the dense math of ``_dense_reference`` (``pallas_attention.py:185``)."""
    B, T, threeHD = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    p = _probs(q, k, prep_mask(mask), scale).to(qkv.dtype).float()
    out = (p @ v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, T, threeHD // 3)


def fused_attention_reference_bwd(qkv, g, mask, n_heads: int, scale: float):
    """Backward: the explicit fp32 formula of ``_mha_bwd_kernel``."""
    B, T, threeHD = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    g = g.float().reshape(B, T, n_heads, -1).transpose(1, 2)
    p = _probs(q, k, prep_mask(mask), scale)
    dv = p.transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    merge = lambda t: t.transpose(1, 2).reshape(B, T, threeHD // 3)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(qkv.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_LIB_NAME = "rlcf_attention"
_MMA_LIB_NAME = "rlcf_attention_mma"
_BWD_MMA_LIB_NAME = "rlcf_attention_bwd_mma"
_MMA_HEADER = ("attention_mma.cuh",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _variant(T: int, dtype) -> str:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, not {dtype}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"fused_attention kernel takes 1 <= T <= {MAX_T}; got T={T}")
    if dtype == torch.float32:
        return "cuda_core"
    return "mma_short" if T <= SHORT_T else "mma_long"


def forward_variant(T: int, dtype) -> str:
    """The forward kernel a CUDA tensor of this sequence length and dtype
    runs: ``"mma_short"`` / ``"mma_long"`` (bf16, ``csrc/attention_mma.cu``)
    or ``"cuda_core"`` (fp32, ``csrc/attention.cu``)."""
    return _variant(T, dtype)


def backward_variant(T: int, dtype) -> str:
    """The backward kernel a CUDA tensor of this sequence length and dtype
    runs: ``"mma_short"`` / ``"mma_long"`` (bf16,
    ``csrc/attention_bwd_mma.cu``) or ``"cuda_core"`` (fp32,
    ``csrc/attention.cu``). The same rule as the forward's."""
    return _variant(T, dtype)


def build(force: bool = False) -> str:
    """Compile ``csrc/attention.cu`` for sm_90a; returns the library path.
    The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention"]``."""
    return cuda_build.build("attention.cu", _LIB_NAME, force=force)


def build_mma(force: bool = False) -> str:
    """Compile ``csrc/attention_mma.cu`` for sm_90a; returns the library path.
    The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention_mma"]``."""
    return cuda_build.build("attention_mma.cu", _MMA_LIB_NAME, force=force, deps=_MMA_HEADER)


def build_bwd_mma(force: bool = False) -> str:
    """Compile ``csrc/attention_bwd_mma.cu`` for sm_90a; returns the library
    path. The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention_bwd_mma"]``."""
    return cuda_build.build("attention_bwd_mma.cu", _BWD_MMA_LIB_NAME, force=force, deps=_MMA_HEADER)


@functools.lru_cache()
def _lib():
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rlcf_mha_fwd.argtypes = [vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, vp]
    lib.rlcf_mha_fwd.restype = ci
    lib.rlcf_mha_bwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, vp]
    lib.rlcf_mha_bwd.restype = ci
    return lib


@functools.lru_cache()
def _mma_lib():
    lib = ctypes.CDLL(build_mma())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rlcf_mha_fwd_mma_short, lib.rlcf_mha_fwd_mma_long):
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    return lib


@functools.lru_cache()
def _bwd_mma_lib():
    lib = ctypes.CDLL(build_bwd_mma())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rlcf_mha_bwd_mma_short.argtypes = [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
    lib.rlcf_mha_bwd_mma_long.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
    lib.rlcf_mha_bwd_mma_short.restype = lib.rlcf_mha_bwd_mma_long.restype = ci
    return lib


def _check_cuda_inputs(qkv, n_heads: int, mask):
    if not qkv.is_cuda:
        raise ValueError(f"the CUDA attention kernel needs a CUDA tensor; got one on {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, not {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * n_heads * HEAD_DIM:
        raise ValueError(f"fused_attention kernel needs qkv [B, T, 3*H*{HEAD_DIM}]; got {tuple(qkv.shape)} "
                         f"with {n_heads} heads")
    B, T, _ = qkv.shape
    if not 1 <= T <= MAX_T:
        raise ValueError(f"fused_attention kernel takes 1 <= T <= {MAX_T}; got T={T}")
    if mask is not None and (tuple(mask.shape) != (T, T) or mask.device != qkv.device):
        raise ValueError(f"mask must be [{T}, {T}] on {qkv.device}; got {tuple(mask.shape)} on {mask.device}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"CUDA attention {what} kernel failed to launch (error code {rc})")


def _aligned(t):
    """Contiguous, with the 16-byte alignment the kernel's vector loads need."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def launch_fwd(qkv, mask, n_heads: int, scale: float):
    """Forward kernel on a CUDA tensor: qkv [B, T, 3HD] -> out [B, T, HD].

    The kernel is ``forward_variant(T, dtype)``: bf16 runs the tensor-core
    kernel, fp32 the CUDA-core kernel (a routing rule by dtype; TF32 would not
    hold fp32's tolerance). The chosen kernel runs or this raises."""
    _check_cuda_inputs(qkv, n_heads, mask)
    variant = forward_variant(qkv.shape[1], qkv.dtype)
    qkv = _aligned(qkv)
    mask = prep_mask(mask)
    B, T, threeHD = qkv.shape
    out = torch.empty((B, T, threeHD // 3), dtype=qkv.dtype, device=qkv.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream)
    args = (_ptr(qkv), _ptr(mask), _ptr(out), B, T, n_heads, float(scale))
    if variant == "cuda_core":
        rc = _lib().rlcf_mha_fwd(*args, _DTYPE_CODE[qkv.dtype], stream)
    elif variant == "mma_short":
        rc = _mma_lib().rlcf_mha_fwd_mma_short(*args, stream)
    else:
        rc = _mma_lib().rlcf_mha_fwd_mma_long(*args, stream)
    _raise_on(rc, f"forward ({variant})")
    LAUNCHES["fwd"] += 1
    LAUNCH_SHAPES[("fwd", B, T, n_heads, str(qkv.dtype))] += 1
    LAUNCH_VARIANTS[variant] += 1
    return out


def launch_bwd(qkv, g, mask, n_heads: int, scale: float):
    """Backward kernel on CUDA tensors: (qkv, g [B, T, HD]) -> dqkv [B, T, 3HD].

    The kernel is ``backward_variant(T, dtype)``: bf16 runs the tensor-core
    kernel, fp32 the CUDA-core kernel (a routing rule by dtype; TF32 would not
    hold fp32's tolerance). The chosen kernel runs or this raises."""
    _check_cuda_inputs(qkv, n_heads, mask)
    variant = backward_variant(qkv.shape[1], qkv.dtype)
    qkv = _aligned(qkv)
    g = _aligned(g.to(qkv.dtype))
    if g.shape != (qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3):
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not match qkv {tuple(qkv.shape)}")
    mask = prep_mask(mask)
    B, T, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    stream = ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream)
    args = (_ptr(qkv), _ptr(g), _ptr(mask), _ptr(dqkv), B, T, n_heads, float(scale))
    if variant == "cuda_core":
        rc = _lib().rlcf_mha_bwd(*args, _DTYPE_CODE[qkv.dtype], stream)
    elif variant == "mma_short":
        rc = _bwd_mma_lib().rlcf_mha_bwd_mma_short(*args, stream)
    else:
        # scratch for the kernel's own classification of the mask's 64 x 64 tiles
        classes = None if mask is None else torch.empty(((T + 63) // 64) ** 2, dtype=torch.uint8, device=qkv.device)
        rc = _bwd_mma_lib().rlcf_mha_bwd_mma_long(*args[:3], _ptr(classes), *args[3:], stream)
    _raise_on(rc, f"backward ({variant})")
    LAUNCHES["bwd"] += 1
    LAUNCH_SHAPES[("bwd", B, T, n_heads, str(qkv.dtype))] += 1
    LAUNCH_VARIANTS["bwd_" + variant] += 1
    return dqkv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, n_heads, scale):
        ctx.save_for_backward(qkv, mask)
        ctx.n_heads, ctx.scale = n_heads, scale
        if qkv.is_cuda:
            return launch_fwd(qkv, mask, n_heads, scale)
        return fused_attention_reference(qkv, mask, n_heads, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        if qkv.is_cuda:
            dqkv = launch_bwd(qkv, g, mask, ctx.n_heads, ctx.scale)
        else:
            dqkv = fused_attention_reference_bwd(qkv, g, mask, ctx.n_heads, ctx.scale)
        return dqkv, None, None, None


def fused_attention(qkv, mask, n_heads: int, scale: float):
    """MHA from the fused projection: [B, T, 3*H*D] (+ optional additive
    [T, T] mask) -> [B, T, H*D]; differentiable in ``qkv``."""
    return _FusedAttention.apply(qkv, mask, n_heads, float(scale))
