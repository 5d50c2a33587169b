"""Shared neural-net building blocks as plain functions on tensors (the
counterpart of ``rlcf_tpu/models/layers.py``).

OpenAI CLIP blocks: fp32 LayerNorm whatever the activation dtype, QuickGELU,
pre-LN residual attention blocks. Weights keep the JAX layout: linear
weights ``[in, out]``, a transformer's blocks stacked on a leading layer axis
(a Python loop over that axis takes the place of ``lax.scan``).
"""

from __future__ import annotations

import math

import torch


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm computed in fp32 (population variance), cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def linear(x, w, b=None):
    """x @ w (+ b), weights stored input-major ``w[in, out]``; the product is
    taken in the promoted dtype and cast back to x's dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def causal_mask(length: int, device=None):
    """Additive [T, T] causal mask (0 on/below the diagonal, -inf above)."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


# Module-wide switch for the dense branch of ``multi_head_attention``:
# "dense" (default) or "flash". The JAX package's "flash" is the upstream
# Pallas flash-attention kernel (``rlcf_tpu/models/layers.py:48``), taken when
# T is a multiple of 128; here the same switch is served by the port's own
# hand-written kernel (``ops/attention.py``), which takes T <= 257, so T = 128
# and 256.
ATTN_IMPL = "dense"


def multi_head_attention(x, qkv_w, qkv_b, out_w, out_b, n_heads: int, mask=None, attn: str = "dense"):
    """Self-attention over [B, T, D] with the fused QKV projection.

    ``attn="fused"`` hands the unsplit projection to the fused kernel
    (``ops/attention.py``: the CUDA kernel on the card, its plain version on
    the CPU), masked or not; ``"dense"`` is the plain head-split math, unless
    ``ATTN_IMPL == "flash"`` and ``T % 128 == 0``: then the dense branch goes
    through the same kernel too. The kernel takes the unsplit projection and
    the additive mask itself (the JAX package maps any mask to its kernel's
    causal flag), so the head split is skipped.
    """
    B, T, D = x.shape
    head_dim = D // n_heads
    qkv = linear(x, qkv_w, qkv_b)  # [B, T, 3D]
    scale = 1.0 / math.sqrt(head_dim)
    if ATTN_IMPL not in ("dense", "flash"):
        raise ValueError(f"unknown ATTN_IMPL {ATTN_IMPL!r} (\"dense\" or \"flash\")")
    if attn == "fused" or (attn == "dense" and ATTN_IMPL == "flash" and T % 128 == 0):
        from ..ops.attention import MAX_T, fused_attention

        if attn == "dense" and T > MAX_T:
            raise ValueError(f"ATTN_IMPL=\"flash\" is served by the fused attention kernel, which takes "
                             f"T <= {MAX_T} (so T = 128 or 256); got T={T}")
        return linear(fused_attention(qkv, mask, n_heads, scale), out_w, out_b)
    if attn != "dense":
        raise ValueError(f"unknown attention implementation {attn!r}")
    q, k, v = (t.reshape(B, T, n_heads, head_dim).transpose(1, 2) for t in qkv.split(D, dim=-1))
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = (probs.float() @ v.float()).to(x.dtype)
    return linear(out.transpose(1, 2).reshape(B, T, D), out_w, out_b)


def residual_block(x, p, n_heads: int, mask=None, attn: str = "dense"):
    """Pre-LN residual attention block (attention + QuickGELU MLP)."""
    h = layer_norm(x, p["ln1_w"], p["ln1_b"])
    x = x + multi_head_attention(h, p["qkv_w"], p["qkv_b"], p["out_w"], p["out_b"], n_heads, mask, attn=attn)
    h = layer_norm(x, p["ln2_w"], p["ln2_b"])
    return x + linear(quick_gelu(linear(h, p["fc_w"], p["fc_b"])), p["proj_w"], p["proj_b"])


def transformer(x, blocks, n_heads: int, mask=None, attn: str = "dense"):
    """Run a stacked-block transformer: ``blocks`` maps names to tensors whose
    leading axis is the layer index."""
    for layer in range(next(iter(blocks.values())).shape[0]):
        x = residual_block(x, {k: v[layer] for k, v in blocks.items()}, n_heads, mask, attn=attn)
    return x


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
