"""Shared neural-net building blocks as plain functions on tensors (the
counterpart of ``rlcf_tpu/models/layers.py``).

OpenAI CLIP blocks: fp32 LayerNorm whatever the activation dtype, QuickGELU,
pre-LN residual attention blocks (their LayerNorms, biases, QuickGELU and
residuals through ``ops/block_ops.py``: fused kernels on the card). Weights
keep the JAX layout: linear weights ``[in, out]``, a transformer's blocks
stacked on a leading layer axis (a Python loop over that axis takes the place
of ``lax.scan``).

Per-episode weights: where the JAX package vmaps one episode's tower over N
episodes, the port stacks the N episodes' weights on a leading axis (a
linear ``[N, in, out]``, a LayerNorm or bias ``[N, D]``, a transformer's
blocks ``[N, L, ...]``) and gives activations the same leading axis
``[N, ..., D]``; each function here takes either layout, told apart by the
weight's rank. A weight shared by the episodes may come expanded (stride 0
on the episode axis) and is then applied as one matrix.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.block_ops import add_layer_norm, bias_quick_gelu, bias_residual, layer_norm, per_episode


def linear(x, w, b=None):
    """x @ w (+ b), weights stored input-major ``w[in, out]``, or ``[N, in,
    out]`` per episode with ``x [N, ..., in]`` (one batched product); the
    product is taken in the promoted dtype and cast back to x's dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if w.dim() == 3 and w.stride(0) != 0:
        y = torch.matmul(x.to(dt).reshape(x.shape[0], -1, x.shape[-1]), w.to(dt))
        y = y.reshape(x.shape[:-1] + w.shape[-1:]).to(x.dtype)
    else:   # one matrix (a per-episode weight expanded from one is applied as that one)
        y = torch.matmul(x.to(dt), (w[0] if w.dim() == 3 else w).to(dt)).to(x.dtype)
    if b is not None:
        y = y + (per_episode(b, y) if b.dim() == 2 else b).to(x.dtype)
    return y


def causal_mask(length: int, device=None):
    """Additive [T, T] causal mask (0 on/below the diagonal, -inf above)."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


# Module-wide switch for the dense branch of ``multi_head_attention``:
# "dense" (default) or "flash". The JAX package's "flash" is the upstream
# Pallas flash-attention kernel (``rlcf_tpu/models/layers.py:48``), taken when
# T is a multiple of 128; here the same switch is served by the port's own
# hand-written kernels (``ops/attention.py``), forward and backward, which take
# T <= 577: so T = 128, 256, 384 and 512, differentiated or not. Any T above
# 577 raises.
ATTN_IMPL = "dense"


def attention_core(qkv, n_heads: int, mask=None, attn: str = "dense"):
    """Attention from the fused QKV projection ``[..., T, 3D]`` to the heads'
    merged output ``[..., T, D]``, before the output projection.

    ``attn="fused"`` hands the unsplit projection to the fused kernel
    (``ops/attention.py``: the CUDA kernel on the card, its plain version on
    the CPU), masked or not; ``"dense"`` is the plain head-split math, unless
    ``ATTN_IMPL == "flash"`` and ``T % 128 == 0``: then the dense branch goes
    through the same kernel too. The kernel takes the unsplit projection and
    the additive mask itself (the JAX package maps any mask to its kernel's
    causal flag), so the head split is skipped.
    """
    *lead, T, threeD = qkv.shape
    D = threeD // 3
    head_dim = D // n_heads
    qkv = qkv.reshape(-1, T, threeD)
    B = qkv.shape[0]
    scale = 1.0 / math.sqrt(head_dim)
    if ATTN_IMPL not in ("dense", "flash"):
        raise ValueError(f"unknown ATTN_IMPL {ATTN_IMPL!r} (\"dense\" or \"flash\")")
    if attn == "fused" or (attn == "dense" and ATTN_IMPL == "flash" and T % 128 == 0):
        from ..ops.attention import MAX_T, fused_attention

        if attn == "dense" and T > MAX_T:
            raise ValueError(f"ATTN_IMPL=\"flash\" is served by the fused attention kernels, which take "
                             f"T <= {MAX_T} (so T = 128 to 512); got T={T}")
        return fused_attention(qkv, mask, n_heads, scale).reshape(*lead, T, D)
    if attn != "dense":
        raise ValueError(f"unknown attention implementation {attn!r}")
    q, k, v = (t.reshape(B, T, n_heads, head_dim).transpose(1, 2) for t in qkv.split(D, dim=-1))
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = (probs.float() @ v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(*lead, T, D)


def multi_head_attention(x, qkv_w, qkv_b, out_w, out_b, n_heads: int, mask=None, attn: str = "dense"):
    """Self-attention over ``[..., T, D]`` with the fused QKV projection
    (``attention_core`` between the two projections)."""
    return linear(attention_core(linear(x, qkv_w, qkv_b), n_heads, mask, attn), out_w, out_b)


def _block_in(x, p):
    """A block's first LayerNorm and QKV projection."""
    return linear(layer_norm(x, p["ln1_w"], p["ln1_b"]), p["qkv_w"], p["qkv_b"])


def _block_out(x, o, p):
    """The rest of a block after attention ``o``: output projection, residual,
    second LayerNorm, QuickGELU MLP, residual. The biases, residuals,
    LayerNorm and QuickGELU are ``ops/block_ops.py``'s fused kernels on the
    card (the plain composition elsewhere); the products stay matmuls."""
    x, h = add_layer_norm(x, linear(o, p["out_w"]), p["out_b"], p["ln2_w"], p["ln2_b"])
    return bias_residual(x, linear(bias_quick_gelu(linear(h, p["fc_w"]), p["fc_b"]), p["proj_w"]), p["proj_b"])


def residual_block(x, p, n_heads: int, mask=None, attn: str = "dense"):
    """Pre-LN residual attention block (attention + QuickGELU MLP)."""
    return _block_out(x, attention_core(_block_in(x, p), n_heads, mask, attn), p)


def transformer(x, blocks, n_heads: int, mask=None, attn: str = "dense", remat=False):
    """Run a stacked-block transformer: ``blocks`` maps names to tensors whose
    leading axis is the layer index (``[N, L, ...]`` per episode).

    ``remat`` checkpoints each layer where gradients are taken
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package's
    ``jax.checkpoint`` of its scan body: ``False`` stores every activation;
    ``True`` keeps only each layer's input and recomputes the whole block in
    the backward (the attention forward included); ``"save_attn"`` keeps
    each block's attention input and output (the fused projection and the
    merged heads) and recomputes the rest, the two sides of the attention
    checkpointed apart, so that the backward runs no attention forward.
    The gradients are the same in all three.

    The layers' weights are taken apart once (``unbind``, whose backward
    stacks the layers' gradients in one kernel a tensor; a per-layer index
    would write a zero-filled copy of the whole stack for each layer)."""
    layer_axis = int(blocks["ln1_w"].dim() == 3)   # [N, L, ...] per episode
    remat = remat if torch.is_grad_enabled() else False
    per_layer = {k: v.unbind(layer_axis) for k, v in blocks.items()}
    for layer in range(blocks["ln1_w"].shape[layer_axis]):
        p = {k: v[layer] for k, v in per_layer.items()}
        if remat == "save_attn":
            o = attention_core(checkpoint(_block_in, x, p, use_reentrant=False), n_heads, mask, attn)
            x = checkpoint(_block_out, x, o, p, use_reentrant=False)
        elif remat:
            x = checkpoint(residual_block, x, p, n_heads, mask, attn, use_reentrant=False)
        else:
            x = residual_block(x, p, n_heads, mask, attn=attn)
    return x


# ---------------------------------------------------------------------------
# Convolution blocks of the ModifiedResNet towers
#
# The JAX package runs them NHWC with HWIO kernels; here a feature map is
# NCHW in the channels_last memory format (the same bytes as NHWC), and a
# kernel OIHW in channels_last (physically O, H, W, I): cuDNN's native
# layouts for bf16 and fp32 convolutions on the card. The towers take and
# give NHWC at their interface, as the JAX package's do.
#
# Per-episode weights (a ResNet policy under encoder TTA, where the JAX
# package vmaps the tower over N episodes): a kernel ``[N, O, I, kh, kw]``,
# a BatchNorm's leaves ``[N, C]``; the N episodes' feature maps are stacked
# on the channels, episode-major (``[B, N*C, H, W]``), so that a convolution
# is grouped by episode and BatchNorm and the average pool, being per
# channel, are per episode as they stand: a BN prior takes each episode's
# batch statistics over its own views only, as under the JAX package's vmap.
# ---------------------------------------------------------------------------


def conv2d(x, w, stride: int = 1, padding: int = 0):
    """NCHW (channels_last) convolution with an OIHW kernel cast to x's
    dtype, no bias. The JAX package's 1x1 convolutions with "SAME" padding
    are ``padding=0`` here. Per-episode kernels ``[N, O, I, kh, kw]`` take
    ``x [B, N*I, H, W]`` and give ``[B, N*O, H', W']`` (one grouped
    convolution)."""
    if w.dim() == 5:
        n = w.shape[0]
        w = w.reshape((-1,) + w.shape[2:]).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding, groups=n)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def avg_pool(x, window: int):
    """Non-overlapping average pool in the JAX package's order: the window
    summed in fp32, the sum cast to x's dtype, then divided by the window's
    size in that dtype (in bf16 two roundings, as there). Per channel, so
    per episode where episodes are stacked on the channels."""
    summed = F.avg_pool2d(x.float(), window, divisor_override=1).to(x.dtype)
    return summed / (window * window)


def batch_norm_2d(x, p, eps: float = 1e-5, prior=None):
    """Inference BatchNorm over NCHW with running statistics, computed in
    fp32 and cast back to x's dtype. ``prior`` (the reference's BN-prior
    encoder TTA, `TPT/tune_cls_rl.py:35-44`) mixes in the batch's own
    statistics with population variance: ``prior * running + (1 - prior) *
    batch``. Per-episode leaves ``[N, C]`` take ``x [B, N*C, H, W]``; the
    batch statistics are then each episode's over its own B views."""
    flat = lambda v: v.reshape(-1).float()
    mean, var = flat(p["mean"]), flat(p["var"])
    if prior is not None:
        x32 = x.float()
        mean = prior * mean + (1.0 - prior) * x32.mean(dim=(0, 2, 3))
        var = prior * var + (1.0 - prior) * x32.var(dim=(0, 2, 3), correction=0)
    inv = torch.rsqrt(var + eps) * flat(p["w"])
    shift = flat(p["b"]) - mean * inv
    return (x.float() * inv[:, None, None] + shift[:, None, None]).to(x.dtype)


def init_transformer_blocks(gen: torch.Generator, n_layers: int, width: int, dtype=torch.float32, device="cpu"):
    """Random stacked transformer blocks (the CLIP init scheme)."""
    proj_std = (width**-0.5) * ((2 * n_layers) ** -0.5)
    attn_std = width**-0.5
    fc_std = (2 * width) ** -0.5
    shape = lambda *s: (n_layers,) + s
    normal = lambda s, std: (torch.randn(shape(*s), generator=gen, device=device) * std).to(dtype)
    ones = lambda *s: torch.ones(shape(*s), dtype=dtype, device=device)
    zeros = lambda *s: torch.zeros(shape(*s), dtype=dtype, device=device)
    return {
        "ln1_w": ones(width), "ln1_b": zeros(width),
        "qkv_w": normal((width, 3 * width), attn_std), "qkv_b": zeros(3 * width),
        "out_w": normal((width, width), proj_std), "out_b": zeros(width),
        "ln2_w": ones(width), "ln2_b": zeros(width),
        "fc_w": normal((width, 4 * width), fc_std), "fc_b": zeros(4 * width),
        "proj_w": normal((4 * width, width), proj_std), "proj_b": zeros(width),
    }
