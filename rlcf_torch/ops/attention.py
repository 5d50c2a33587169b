"""Fused multi-head attention from the unsplit QKV projection, forward and
backward: hand-written CUDA kernels for Hopper's tensor cores
(``csrc/attention_mma.cu`` and ``csrc/attention_bwd_mma.cu``: bf16 forward and
backward; ``csrc/attention_tf32.cu`` and ``csrc/attention_bwd_tf32.cu``: fp32
forward and backward on split TF32 operands) and their plain PyTorch version.

Replaces the TPU kernels ``_mha_fwd_kernel`` / ``_mha_bwd_kernel`` of
``rlcf_tpu/ops/pallas_attention.py`` (``fused_attention``, a custom VJP).
Function: ``qkv [B, T, 3*H*D]`` (+ an optional additive ``[T, T]`` mask, -inf
clamped to -1e9) -> ``[B, T, H*D]``. Scores ``q.k * scale`` in fp32, a
max-subtracted fp32 softmax, probabilities rounded to the input dtype before
``P.V``, fp32 accumulation. The backward recomputes P in fp32 and returns
``dqkv`` in the fused layout: ``dv = P^T g``, ``dp = g v^T``,
``ds = P * (dp - rowsum(dp * P))``, ``dq = ds k * scale``,
``dk = ds^T q * scale``.

``fused_attention`` is the custom op ``rlcf::fused_attention``, whose
gradient is the op ``rlcf::fused_attention_bwd``: a CUDA tensor runs the
CUDA kernels (or raises), a CPU tensor runs the plain version, and a graph
capture (``torch.export``) records the two ops as nodes. ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernel.
Which kernel a CUDA tensor runs is a rule of ``(T, dtype)`` in both
directions (``forward_variant``, ``backward_variant``), not a fallback: one
warp per head on ``mma.sync`` for ``T <= 16`` (``mma_short``,
``tf32x6_short``), several warps per head above (``mma_long``, ``tf32x3_long``).
Both directions take ``T <= 577`` (ViT-L/14 at 336 px). Above T = 257 the
bf16 forward is ``mma_xlong``: one sweep over the keys, split between two
warpgroups that keep their scores in registers (P normalised, then rounded,
then P.V); the fp32 forward ``tf32x3_long`` streams the keys at any T. The
backward above T = 257 is ``mma_xlong`` / ``tf32x3_xlong``: two launches, one
per block of query rows (the rows' statistics and dq) and one per block of
keys (dk and dv), the statistics passed between them in a device scratch; the
other two slices are held whole in shared memory (bf16) or streamed through
it in chunks of 32 rows, split once per CTA into TF32 hi / lo copies for
``wgmma`` (fp32, ``tf32_xlong_smem_bytes``).
fp32 products run on the tensor cores with split operands: 3xTF32 above
T = 16 (each operand split into two TF32 values, each product three passes),
six products of a three-way split up to T = 16 (kernels bound by bytes, which
take the products to fp32's accuracy). Both hold fp32's 1e-5 (forward) and
1e-4 (backward) tolerances, where one TF32 pass does not.

Each source is built at first use with ``nvcc`` for ``sm_90a`` into the
package's git-ignored ``_build/`` directory as a plain-C shared library and
bound with ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build

NEG_BIG = -1e9  # finite stand-in for the causal mask's -inf
HEAD_DIM = 64   # the kernel's head dimension
MAX_T = 577     # the kernels' longest sequence (ViT-L/14 at 336 px)
MAX_T_BWD = 577  # the backward kernels' (the same)
LONG_T = 257    # longest sequence of the kernels that hold a head's slices in shared memory (or score rows in registers)
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
    """Backward: the explicit fp32 formula of ``_mha_bwd_kernel``, at any T
    (what every backward kernel, the xlong ones too, is held to)."""
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


def bf16_operand_reference_bwd(qkv, g, mask, n_heads: int, scale: float, split: bool = True):
    """The backward with P and dS rounded to bf16 where the bf16 kernels'
    tensor cores take them as operands (fp32 products of the rounded values,
    fp32 sums): ``split`` into a bf16 value plus the bf16 value of what that
    rounding lost (the kernels' hi + lo), or rounded once. For the tests and
    the smoke script's PRECISION line."""
    B, T, threeHD = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    g = g.float().reshape(B, T, n_heads, -1).transpose(1, 2)
    p = _probs(q, k, prep_mask(mask), scale)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))

    def operand(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi

    p, ds = operand(p), operand(ds)
    grads = ((ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, p.transpose(-1, -2) @ g)
    return torch.cat([t.transpose(1, 2).reshape(B, T, threeHD // 3) for t in grads], dim=-1).to(qkv.dtype)


def rna_tf32(x):
    """``x`` rounded to the nearest TF32 value (10 mantissa bits), ties away
    from zero: what ``cvt.rna.tf32.f32`` gives, by integer ops on the fp32
    bits (add 0x1000, clear the 13 low bits)."""
    return ((x.float().contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes: int):
    """``a @ b`` on TF32 operands as the fp32 kernels take them: one TF32
    pass (``hi . hi``), 3xTF32 (``lo . hi + hi . lo + hi . hi``, lo the TF32
    value of what rounding to hi lost; the long kernels) or six products of a
    three-way split (``x = hi + mid + lo``; the short kernels). The products
    of TF32 values are exact in fp32, the sums fp32, the smallest first."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    if passes == 1:
        return ah @ bh
    am, bm = rna_tf32(a - ah), rna_tf32(b - bh)
    if passes == 3:
        return (am @ bh + ah @ bm) + ah @ bh
    al, bl = rna_tf32(a - ah - am), rna_tf32(b - bh - bm)
    return ((((ah @ bl + al @ bh) + am @ bm) + ah @ bm) + am @ bh) + ah @ bh


def tf32_reference(qkv, mask, n_heads: int, scale: float, passes: int = 3):
    """The fp32 forward with every product on TF32 operands
    (``_tf32_matmul``, ``passes`` 1, 3 or 6): the fp32 kernels' arithmetic in
    plain PyTorch, for the tests and the smoke script's PRECISION line."""
    B, T, threeHD = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    s = _tf32_matmul(q, k.transpose(-1, -2), passes) * scale
    if mask is not None:
        s = s + prep_mask(mask)
    out = _tf32_matmul(torch.softmax(s, dim=-1), v, passes)
    return out.transpose(1, 2).reshape(B, T, threeHD // 3)


def tf32_reference_bwd(qkv, g, mask, n_heads: int, scale: float, passes: int = 3):
    """The fp32 backward with every product on TF32 operands, as
    ``tf32_reference``."""
    B, T, threeHD = qkv.shape
    q, k, v = _split_heads(qkv, n_heads)
    g = g.float().reshape(B, T, n_heads, -1).transpose(1, 2)
    mm = functools.partial(_tf32_matmul, passes=passes)
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s if mask is None else s + prep_mask(mask), dim=-1)
    dp = mm(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    grads = (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale, mm(p.transpose(-1, -2), g))
    return torch.cat([t.transpose(1, 2).reshape(B, T, threeHD // 3) for t in grads], dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_MMA_LIB_NAME = "rlcf_attention_mma"
_BWD_MMA_LIB_NAME = "rlcf_attention_bwd_mma"
_TF32_LIB_NAME = "rlcf_attention_tf32"
_BWD_TF32_LIB_NAME = "rlcf_attention_bwd_tf32"
_MMA_HEADER = ("attention_mma.cuh",)
_TF32_HEADERS = ("attention_mma.cuh", "attention_tf32.cuh")
# the kernels of each direction and dtype: (T <= SHORT_T, T <= LONG_T, above);
# the fp32 forward streams its keys at any T, the fp32 backward above LONG_T is another kernel
_VARIANTS = {"fwd": {torch.bfloat16: ("mma_short", "mma_long", "mma_xlong"),
                     torch.float32: ("tf32x6_short", "tf32x3_long", "tf32x3_long")},
             "bwd": {torch.bfloat16: ("mma_short", "mma_long", "mma_xlong"),
                     torch.float32: ("tf32x6_short", "tf32x3_long", "tf32x3_xlong")}}
_XLONG_BWD = ("mma_xlong", "tf32x3_xlong")   # the backward kernels that take a statistics scratch
_CLASSES_BWD = ("mma_long", "mma_xlong")      # the backward kernels that classify a mask's tiles into a scratch


def _check_dtype(dtype):
    if dtype not in _VARIANTS["fwd"]:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, not {dtype}")


def _check_length(T: int, direction: str):
    limit = MAX_T if direction == "fwd" else MAX_T_BWD
    if not 1 <= T <= limit:
        kernels = "the forward kernels'" if direction == "fwd" else "the xlong backward kernels'"
        raise ValueError(f"fused_attention {'forward' if direction == 'fwd' else 'backward'} kernel takes "
                         f"1 <= T <= {limit} ({kernels} longest sequence, ViT-L/14 at 336 px); got T={T}")


def _variant(T: int, dtype, direction: str) -> str:
    _check_dtype(dtype)
    _check_length(T, direction)
    return _VARIANTS[direction][dtype][0 if T <= SHORT_T else 1 if T <= LONG_T else 2]


def forward_variant(T: int, dtype) -> str:
    """The forward kernel a CUDA tensor of this sequence length and dtype
    runs: ``"mma_short"`` / ``"mma_long"`` / ``"mma_xlong"`` (bf16, T <= 16,
    257, 577; ``csrc/attention_mma.cu``) or ``"tf32x6_short"`` /
    ``"tf32x3_long"`` (fp32, T <= 16, 577; ``csrc/attention_tf32.cu``)."""
    return _variant(T, dtype, "fwd")


def backward_variant(T: int, dtype) -> str:
    """The backward kernel a CUDA tensor of this sequence length and dtype
    runs: ``"mma_short"`` / ``"mma_long"`` / ``"mma_xlong"`` (bf16, T <= 16,
    257, 577; ``csrc/attention_bwd_mma.cu``) or ``"tf32x6_short"`` /
    ``"tf32x3_long"`` / ``"tf32x3_xlong"`` (fp32; ``csrc/attention_bwd_tf32.cu``)."""
    return _variant(T, dtype, "bwd")


def build_mma(force: bool = False) -> str:
    """Compile ``csrc/attention_mma.cu`` for sm_90a; returns the library path.
    The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention_mma"]``."""
    return cuda_build.build("attention_mma.cu", _MMA_LIB_NAME, force=force, deps=_MMA_HEADER)


def build_bwd_mma(force: bool = False) -> str:
    """Compile ``csrc/attention_bwd_mma.cu`` for sm_90a; returns the library
    path. The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention_bwd_mma"]``."""
    return cuda_build.build("attention_bwd_mma.cu", _BWD_MMA_LIB_NAME, force=force, deps=_MMA_HEADER)


def build_tf32(force: bool = False) -> str:
    """Compile ``csrc/attention_tf32.cu`` for sm_90a; returns the library
    path. The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention_tf32"]``."""
    return cuda_build.build("attention_tf32.cu", _TF32_LIB_NAME, force=force, deps=_TF32_HEADERS)


def build_bwd_tf32(force: bool = False) -> str:
    """Compile ``csrc/attention_bwd_tf32.cu`` for sm_90a; returns the library
    path. The ptxas report lands in ``cuda_build.PTXAS["rlcf_attention_bwd_tf32"]``."""
    return cuda_build.build("attention_bwd_tf32.cu", _BWD_TF32_LIB_NAME, force=force, deps=_TF32_HEADERS)


@functools.lru_cache()
def _fwd_lib(dtype):
    lib = ctypes.CDLL(build_tf32() if dtype == torch.float32 else build_mma())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for variant in set(_VARIANTS["fwd"][dtype]):
        fn = getattr(lib, f"rlcf_mha_fwd_{variant}")
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    return lib


@functools.lru_cache()
def _bwd_lib(dtype):
    lib = ctypes.CDLL(build_bwd_tf32() if dtype == torch.float32 else build_bwd_mma())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for variant in _VARIANTS["bwd"][dtype]:
        fn = getattr(lib, f"rlcf_mha_bwd_{variant}")
        extra = [vp] * len(bwd_scratch(variant, 1, 1, 1, False))
        fn.argtypes = [vp, vp, vp, *extra, vp, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    if dtype == torch.float32:
        lib.rlcf_mha_bwd_tf32x3_xlong_smem.argtypes = [ci]
        lib.rlcf_mha_bwd_tf32x3_xlong_smem.restype = ci
    return lib


def tile_classes_bytes(T: int) -> int:
    """Bytes of the scratch in which the bf16 long and xlong backward kernels
    classify a mask's 64 x 64 tiles (dead, plain, mixed): one a tile."""
    return ((T + 63) // 64) ** 2


def xlong_stats_floats(B: int, T: int, n_heads: int) -> int:
    """Floats of the xlong backward's scratch: each row's max, 1 / sum and
    rowsum(dp * P), 64 rows a block, written by its first launch for its second."""
    return B * n_heads * 3 * ((T + 63) // 64 * 64)


# the fp32 xlong backward's layout in shared memory (csrc/attention_bwd_tf32.cu, kXl*)
TF32_XLONG_CHUNK = 32          # rows of a streamed chunk
_TF32_SPLIT_COPY = 64 * 64 * 4  # a hi or lo copy of 64 rows of a head's slice
SMEM_PER_CTA = 232_448         # the most dynamic shared memory a CTA can have on an H100


def tf32_xlong_smem_bytes():
    """Dynamic shared memory of the fp32 xlong backward's two launches,
    ``(rows, keys)``: both warpgroups' own G (rows) or V (keys) split hi / lo
    (A operands), two buffers of the streamed chunk's hi / lo copies (rows: K
    and V in the rows layout and K turned over; keys: Q and G in both
    layouts), two padded raw slices of the next chunk, the rows launch four
    mbarriers, the keys launch every row's three statistics, and 1 KB to
    align the copies."""
    own = 2 * 2 * _TF32_SPLIT_COPY
    copy = TF32_XLONG_CHUNK * HEAD_DIM * 4
    raw = 2 * TF32_XLONG_CHUNK * (HEAD_DIM + 4) * 4
    stats = 3 * ((MAX_T_BWD + 63) // 64 * 64) * 4
    bars = 4 * 8
    return own + 2 * 6 * copy + raw + bars + 1024, own + 2 * 8 * copy + raw + stats + 1024


def bwd_scratch(variant: str, B: int, T: int, n_heads: int, masked: bool):
    """The scratch a backward kernel takes after the mask, in the order of
    its C arguments, as ``(dtype, elements)``, 0 elements for a null pointer:
    the bf16 long and xlong kernels classify the mask's tiles (no mask: none),
    the xlong kernels pass the rows' statistics from their first launch to
    their second."""
    sizes = []
    if variant in _CLASSES_BWD:
        sizes.append((torch.uint8, tile_classes_bytes(T) if masked else 0))
    if variant in _XLONG_BWD:
        sizes.append((torch.float32, xlong_stats_floats(B, T, n_heads)))
    return sizes


def _check_cuda_inputs(qkv, n_heads: int, mask, direction: str):
    if not qkv.is_cuda:
        raise ValueError(f"the CUDA attention kernel needs a CUDA tensor; got one on {qkv.device}")
    _check_dtype(qkv.dtype)
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * n_heads * HEAD_DIM:
        raise ValueError(f"fused_attention kernel needs qkv [B, T, 3*H*{HEAD_DIM}]; got {tuple(qkv.shape)} "
                         f"with {n_heads} heads")
    B, T, _ = qkv.shape
    _check_length(T, direction)
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

    The kernel is ``forward_variant(T, dtype)`` (T <= 577): bf16 on bf16
    operands, fp32 on split TF32 operands (three or six tensor-core passes a
    product), both on the tensor cores. The chosen kernel runs or this raises."""
    _check_cuda_inputs(qkv, n_heads, mask, "fwd")
    variant = forward_variant(qkv.shape[1], qkv.dtype)
    qkv = _aligned(qkv)
    mask = prep_mask(mask)
    B, T, threeHD = qkv.shape
    out = torch.empty((B, T, threeHD // 3), dtype=qkv.dtype, device=qkv.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream)
    args = (_ptr(qkv), _ptr(mask), _ptr(out), B, T, n_heads, float(scale))
    rc = getattr(_fwd_lib(qkv.dtype), f"rlcf_mha_fwd_{variant}")(*args, stream)
    _raise_on(rc, f"forward ({variant})")
    LAUNCHES["fwd"] += 1
    LAUNCH_SHAPES[("fwd", B, T, n_heads, str(qkv.dtype))] += 1
    LAUNCH_VARIANTS[variant] += 1
    return out


def launch_bwd(qkv, g, mask, n_heads: int, scale: float):
    """Backward kernel on CUDA tensors: (qkv, g [B, T, HD]) -> dqkv [B, T, 3HD].

    The kernel is ``backward_variant(T, dtype)`` (T <= 577), on the tensor
    cores as the forward's. The chosen kernel runs or this raises."""
    _check_cuda_inputs(qkv, n_heads, mask, "bwd")
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
    fn = getattr(_bwd_lib(qkv.dtype), f"rlcf_mha_bwd_{variant}")
    scratch = [torch.empty(n, dtype=dtype, device=qkv.device) if n else None
               for dtype, n in bwd_scratch(variant, B, T, n_heads, mask is not None)]
    rc = fn(*args[:3], *map(_ptr, scratch), *args[3:], stream)
    _raise_on(rc, f"backward ({variant})")
    LAUNCHES["bwd"] += 1
    LAUNCH_SHAPES[("bwd", B, T, n_heads, str(qkv.dtype))] += 1
    LAUNCH_VARIANTS["bwd_" + variant] += 1
    return dqkv


# ---------------------------------------------------------------------------
# The custom ops: the one route from a model to the kernels, eager or traced
# ---------------------------------------------------------------------------
# ``torch.export`` and other graph captures trace through fake tensors, which
# a ctypes launch cannot take: each direction is a ``torch.library`` op whose
# CUDA implementation launches the kernel (``launch_fwd`` / ``launch_bwd``,
# looked up when called) and whose CPU implementation is the plain version.
# The fake implementations give the outputs' shapes; the backward op is wired
# to the forward with ``register_autograd``, so an exported episode holds both
# as graph nodes and a program loaded with ``torch.export.load`` runs them once
# this module is imported (it registers them).


@torch.library.custom_op("rlcf::fused_attention", mutates_args=(), device_types="cuda")
def _fused_attention_op(qkv: torch.Tensor, mask: Optional[torch.Tensor], n_heads: int, scale: float) -> torch.Tensor:
    return launch_fwd(qkv, mask, n_heads, scale)


@_fused_attention_op.register_kernel("cpu")
def _(qkv, mask, n_heads, scale):
    return fused_attention_reference(qkv, mask, n_heads, scale)


@_fused_attention_op.register_fake
def _(qkv, mask, n_heads, scale):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


@torch.library.custom_op("rlcf::fused_attention_bwd", mutates_args=(), device_types="cuda")
def _fused_attention_bwd_op(qkv: torch.Tensor, g: torch.Tensor, mask: Optional[torch.Tensor], n_heads: int,
                            scale: float) -> torch.Tensor:
    return launch_bwd(qkv, g, mask, n_heads, scale)


@_fused_attention_bwd_op.register_kernel("cpu")
def _(qkv, g, mask, n_heads, scale):
    return fused_attention_reference_bwd(qkv, g, mask, n_heads, scale)


@_fused_attention_bwd_op.register_fake
def _(qkv, g, mask, n_heads, scale):
    return torch.empty_like(qkv)


def _setup_context(ctx, inputs, output):
    qkv, mask, n_heads, scale = inputs
    ctx.save_for_backward(qkv, mask)
    ctx.n_heads, ctx.scale = n_heads, scale


def _backward(ctx, g):
    qkv, mask = ctx.saved_tensors
    return _fused_attention_bwd_op(qkv, g, mask, ctx.n_heads, ctx.scale), None, None, None


_fused_attention_op.register_autograd(_backward, setup_context=_setup_context)


def fused_attention(qkv, mask, n_heads: int, scale: float):
    """MHA from the fused projection: [B, T, 3*H*D] (+ optional additive
    [T, T] mask) -> [B, T, H*D]; differentiable in ``qkv``. The op
    ``rlcf::fused_attention``: the kernel on a CUDA tensor (or it raises),
    the plain version on a CPU tensor."""
    return _fused_attention_op(qkv, mask, n_heads, float(scale))
