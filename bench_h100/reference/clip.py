"""Plain CLIP towers on an OpenAI-format state dict, in float32 (or, for the
control, with every product's operands rounded to float8).

Written from OpenAI's ``clip/model.py`` (``VisionTransformer``,
``ModifiedResNet``, ``AttentionPool2d``, the text ``Transformer``): the same
layer equations on the state dict's own keys and layouts (linear weights
``[out, in]``, the attention's stacked ``in_proj``, OIHW convolutions,
BatchNorm in eval mode). Images are NCHW and CLIP-normalized. Nothing here
imports the program under test.

``Prec`` says how a product is computed: ``fp32`` takes float32 operands
(TF32 must be off, ``reference.setup_fp32``); ``fp8`` rounds both operands to
float8 e4m3 with a per-tensor scale before a float32 product: the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # the largest finite float8 e4m3 value


def to_fp8(x):
    """``x`` rounded to float8 e4m3 on a per-tensor scale, back in float32.
    The gradient passes by in float32 (a cast's own gradient would be
    float8, where the episodes' small gradients underflow to 0)."""
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


class Prec:
    """The precision of the reference's products: ``fp32`` or ``fp8``."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def op(self, x):
        """An operand of a product, float32 or rounded to float8."""
        x = x.float()
        return to_fp8(x) if self.name == "fp8" else x

    def matmul(self, a, b):
        return self.op(a) @ self.op(b)

    def linear(self, x, w, b=None):
        """``x @ w.T + b``, ``w`` in torch's ``[out, in]`` layout."""
        y = self.matmul(x, w.float().t())
        return y if b is None else y + b.float()

    def conv2d(self, x, w, stride=1, padding=0):
        return F.conv2d(self.op(x), self.op(w), stride=stride, padding=padding)


def layer_norm(x, sd, name):
    return F.layer_norm(x.float(), x.shape[-1:], sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(), 1e-5)


def attention(x, sd, name, heads: int, prec: Prec, mask=None):
    """``nn.MultiheadAttention`` of a residual block on ``x [B, T, W]``."""
    B, T, W = x.shape
    qkv = prec.linear(x, sd[f"{name}.in_proj_weight"], sd[f"{name}.in_proj_bias"])
    q, k, v = (t.reshape(B, T, heads, W // heads).transpose(1, 2) for t in qkv.split(W, dim=-1))
    scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(W // heads)
    if mask is not None:
        scores = scores + mask
    out = prec.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(B, T, W)
    return prec.linear(out, sd[f"{name}.out_proj.weight"], sd[f"{name}.out_proj.bias"])


def transformer(x, sd, prefix: str, layers: int, heads: int, prec: Prec, mask=None):
    """OpenAI's ``Transformer``: pre-LN residual blocks with QuickGELU."""
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        x = x + attention(layer_norm(x, sd, f"{p}.ln_1"), sd, f"{p}.attn", heads, prec, mask)
        h = prec.linear(layer_norm(x, sd, f"{p}.ln_2"), sd[f"{p}.mlp.c_fc.weight"], sd[f"{p}.mlp.c_fc.bias"])
        h = h * torch.sigmoid(1.702 * h)
        x = x + prec.linear(h, sd[f"{p}.mlp.c_proj.weight"], sd[f"{p}.mlp.c_proj.bias"])
    return x


def encode_image_vit(sd, cfg, images, prec: Prec):
    """``VisionTransformer.forward`` on NCHW images -> ``[B, embed_dim]``."""
    P, W = cfg["vision_patch_size"], cfg["vision_width"]
    x = prec.conv2d(images, sd["visual.conv1.weight"], stride=P)          # [B, W, g, g]
    x = x.flatten(2).transpose(1, 2)                                       # [B, g*g, W]
    cls = sd["visual.class_embedding"].float().expand(x.shape[0], 1, W)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"].float()
    x = layer_norm(x, sd, "visual.ln_pre")
    x = transformer(x, sd, "visual.transformer", cfg["vision_layers"], W // 64, prec)
    x = layer_norm(x[:, 0], sd, "visual.ln_post")
    return prec.matmul(x, sd["visual.proj"].float())


def batch_norm(x, sd, name):
    return F.batch_norm(x, sd[f"{name}.running_mean"].float(), sd[f"{name}.running_var"].float(),
                        sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(), False, 0.0, 1e-5)


def bottleneck(x, sd, name, stride: int, prec: Prec):
    """``Bottleneck``: 1x1, 3x3, an average pool where it strides, 1x1; the
    shortcut pooled, then a 1x1 convolution, where the block changes width."""
    out = F.relu(batch_norm(prec.conv2d(x, sd[f"{name}.conv1.weight"]), sd, f"{name}.bn1"))
    out = F.relu(batch_norm(prec.conv2d(out, sd[f"{name}.conv2.weight"], padding=1), sd, f"{name}.bn2"))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = batch_norm(prec.conv2d(out, sd[f"{name}.conv3.weight"]), sd, f"{name}.bn3")
    identity = x
    if f"{name}.downsample.0.weight" in sd:
        identity = F.avg_pool2d(x, stride) if stride > 1 else x
        identity = batch_norm(prec.conv2d(identity, sd[f"{name}.downsample.0.weight"]), sd, f"{name}.downsample.1")
    return F.relu(out + identity)


def attention_pool(x, sd, heads: int, prec: Prec):
    """``AttentionPool2d``: the spatial mean token first, the positional
    embedding added, one query (the mean token's) over every token."""
    B, C, H, W = x.shape
    x = x.flatten(2).transpose(1, 2)                                       # [B, HW, C]
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + sd["visual.attnpool.positional_embedding"].float()
    p = "visual.attnpool"
    d = C // heads
    q = prec.linear(x[:, :1], sd[f"{p}.q_proj.weight"], sd[f"{p}.q_proj.bias"]).reshape(B, 1, heads, d)
    k = prec.linear(x, sd[f"{p}.k_proj.weight"], sd[f"{p}.k_proj.bias"]).reshape(B, -1, heads, d)
    v = prec.linear(x, sd[f"{p}.v_proj.weight"], sd[f"{p}.v_proj.bias"]).reshape(B, -1, heads, d)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    probs = torch.softmax(prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    out = prec.matmul(probs, v).transpose(1, 2).reshape(B, C)
    return prec.linear(out, sd[f"{p}.c_proj.weight"], sd[f"{p}.c_proj.bias"])


def encode_image_resnet(sd, cfg, images, prec: Prec):
    """``ModifiedResNet.forward`` on NCHW images -> ``[B, embed_dim]``."""
    x = images.float()
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = F.relu(batch_norm(prec.conv2d(x, sd[f"visual.conv{i}.weight"], stride=stride, padding=1), sd,
                              f"visual.bn{i}"))
    x = F.avg_pool2d(x, 2)
    for g, n_blocks in enumerate(cfg["vision_layers"]):
        for b in range(n_blocks):
            x = bottleneck(x, sd, f"visual.layer{g + 1}.{b}", 2 if (b == 0 and g > 0) else 1, prec)
    return attention_pool(x, sd, cfg["vision_width"] * 32 // 64, prec)


def encode_image(sd, cfg, images, prec: Prec, block: int = 32):
    """Image features ``[B, embed_dim]`` of NCHW images, ``block`` images at a time."""
    fn = encode_image_vit if cfg.get("vision_patch_size") else encode_image_resnet
    return torch.cat([fn(sd, cfg, images[i:i + block], prec) for i in range(0, images.shape[0], block)])


def encode_text_embeds(sd, cfg, embeds, eot_idx, prec: Prec):
    """Text features ``[B, embed_dim]`` of token embeddings ``[B, T, D]``
    pooled at ``eot_idx [B]``; causal attention, so positions past the
    longest EOT may be left out of ``embeds`` without changing a feature."""
    T = embeds.shape[1]
    x = embeds.float() + sd["positional_embedding"].float()[:T]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    x = transformer(x, sd, "transformer", cfg["text_layers"], cfg["text_width"] // 64, prec, mask)
    x = layer_norm(x, sd, "ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_idx]
    return prec.matmul(pooled, sd["text_projection"].float())


def normalize(x):
    return x / x.norm(dim=-1, keepdim=True)
