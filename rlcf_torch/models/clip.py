"""CLIP image towers (ViT and ModifiedResNet) and text tower as plain
functions on a parameter dict (the counterpart of ``rlcf_tpu/models/clip.py``).

Parameters keep the JAX package's pytree layout (``visual``/``text`` dicts,
transformer blocks stacked on a leading layer axis, ``[in, out]`` linears,
the ViT patch-embedding conv as HWIO), so ``models/convert.py`` carries JAX
parameters across unchanged, except the ResNet towers' convolution kernels,
which are OIHW in the channels_last memory format here (``models/layers.py``).
Images are NHWC, patch tokens patch-major. Both towers take per-episode
weights (every leaf on a leading episode axis, ``models/layers.py``) for
encoder TTA; the ResNet towers take the BN-prior statistics too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import layers as L


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    name: str
    embed_dim: int
    image_resolution: int
    vision_layers: Union[int, Tuple[int, int, int, int]]
    vision_width: int
    vision_patch_size: Optional[int]
    text_width: int
    text_layers: int
    context_length: int = 77
    vocab_size: int = 49408
    # Overrides for tiny test configs where width//64 would be 0.
    vision_heads_override: Optional[int] = None
    text_heads_override: Optional[int] = None

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.vision_heads_override:
            return self.vision_heads_override
        return self.vision_width // 64 if self.is_vit else self.vision_width * 32 // 64

    @property
    def text_heads(self) -> int:
        return self.text_heads_override or self.text_width // 64

    @property
    def grid_size(self) -> int:
        assert self.is_vit
        return self.image_resolution // self.vision_patch_size


def _cfg(name, embed_dim, res, vl, vw, patch, tw, tl, **kw):
    return ClipConfig(name, embed_dim, res, vl, vw, patch, tw, tl, **kw)


CLIP_ARCHS = {
    "ViT-B/32": _cfg("ViT-B/32", 512, 224, 12, 768, 32, 512, 12),
    "ViT-B/16": _cfg("ViT-B/16", 512, 224, 12, 768, 16, 512, 12),
    "ViT-L/14": _cfg("ViT-L/14", 768, 224, 24, 1024, 14, 768, 12),
    "ViT-L/14@336px": _cfg("ViT-L/14@336px", 768, 336, 24, 1024, 14, 768, 12),
    "RN50": _cfg("RN50", 1024, 224, (3, 4, 6, 3), 64, None, 512, 12),
    "RN101": _cfg("RN101", 512, 224, (3, 4, 23, 3), 64, None, 512, 12),
    "RN50x4": _cfg("RN50x4", 640, 288, (4, 6, 10, 6), 80, None, 640, 12),
    "RN50x16": _cfg("RN50x16", 768, 384, (6, 8, 18, 8), 96, None, 768, 12),
    "RN50x64": _cfg("RN50x64", 1024, 448, (3, 15, 36, 10), 128, None, 1024, 12),
    # Tiny architectures for tests (same code paths).
    "test-tiny-vit": _cfg("test-tiny-vit", 32, 32, 2, 64, 8, 64, 2, vocab_size=512),
    "test-tiny-rn": _cfg("test-tiny-rn", 64, 64, (1, 1, 1, 1), 16, None, 64, 2, vocab_size=512),
    "test-small": _cfg("test-small", 64, 64, 2, 64, 16, 64, 2),
}


def get_config(arch: str) -> ClipConfig:
    if arch not in CLIP_ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: {sorted(CLIP_ARCHS)}")
    return CLIP_ARCHS[arch]


# ---------------------------------------------------------------------------
# Random initialization (weights from a torch.Generator)
# ---------------------------------------------------------------------------


def init_clip_params(cfg: ClipConfig, seed: int = 0, dtype=torch.float32, device="cpu"):
    """Random CLIP parameters (the CLIP init scheme) from ``seed``, made on
    ``device`` with a generator of that device."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = lambda shape, std: (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    if cfg.is_vit:
        W, P = cfg.vision_width, cfg.vision_patch_size
        scale = W**-0.5
        visual = {
            "conv_w": normal((P, P, 3, W), scale),
            "class_emb": normal((W,), scale),
            "pos_emb": normal((cfg.grid_size**2 + 1, W), scale),
            "ln_pre_w": ones(W), "ln_pre_b": zeros(W),
            "blocks": L.init_transformer_blocks(gen, cfg.vision_layers, W, dtype, device),
            "ln_post_w": ones(W), "ln_post_b": zeros(W),
            "proj": normal((W, cfg.embed_dim), scale),
        }
    else:
        visual = _init_resnet(cfg, normal, ones, zeros)
    tw = cfg.text_width
    text = {
        "token_embedding": normal((cfg.vocab_size, tw), 0.02),
        "positional_embedding": normal((cfg.context_length, tw), 0.01),
        "blocks": L.init_transformer_blocks(gen, cfg.text_layers, tw, dtype, device),
        "ln_final_w": ones(tw), "ln_final_b": zeros(tw),
        "projection": normal((tw, cfg.embed_dim), tw**-0.5),
    }
    logit_scale = torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device)
    return {"visual": visual, "text": text, "logit_scale": logit_scale}


def _init_resnet(cfg: ClipConfig, normal, ones, zeros):
    """The ModifiedResNet's random parameters (``_init_resnet`` of the JAX
    package): He-normal convolutions (OIHW, channels_last), BatchNorm at the
    identity (running mean 0 and variance 1, fp32), the attention pool's
    projections at std width^-0.5."""
    def conv(cout, cin, k):
        w = normal((cout, cin, k, k), (2.0 / (cin * k * k)) ** 0.5)
        return w.contiguous(memory_format=torch.channels_last)

    def bn(c):
        return {"w": ones(c), "b": zeros(c), "mean": zeros(c).float(), "var": ones(c).float()}

    W = cfg.vision_width
    stem = {"conv1_w": conv(W // 2, 3, 3), "bn1": bn(W // 2), "conv2_w": conv(W // 2, W // 2, 3), "bn2": bn(W // 2),
            "conv3_w": conv(W, W // 2, 3), "bn3": bn(W)}
    groups, inplanes = [], W
    for g, n_blocks in enumerate(cfg.vision_layers):
        planes = W * 2**g
        blocks = []
        for b in range(n_blocks):
            block = {"conv1_w": conv(planes, inplanes, 1), "bn1": bn(planes), "conv2_w": conv(planes, planes, 3),
                     "bn2": bn(planes), "conv3_w": conv(planes * 4, planes, 1), "bn3": bn(planes * 4)}
            if b == 0:  # every group's first block changes the width (and strides past the first group)
                block["downsample"] = {"conv_w": conv(planes * 4, inplanes, 1), "bn": bn(planes * 4)}
            blocks.append(block)
            inplanes = planes * 4
        groups.append(blocks)
    C = W * 32
    std = C**-0.5
    attnpool = {"pos_emb": normal(((cfg.image_resolution // 32) ** 2 + 1, C), std),
                "q_w": normal((C, C), std), "q_b": zeros(C), "k_w": normal((C, C), std), "k_b": zeros(C),
                "v_w": normal((C, C), std), "v_b": zeros(C), "c_w": normal((C, cfg.embed_dim), std),
                "c_b": zeros(cfg.embed_dim)}
    return {"stem": stem, "groups": groups, "attnpool": attnpool}


# ---------------------------------------------------------------------------
# Vision towers
# ---------------------------------------------------------------------------


def _vit_post_patch(p, cfg: ClipConfig, x, pool=True, attn="dense", remat=False):
    """Shared ViT trunk after patch embedding: x [B, T, W] patch activations,
    or ``[N, B, T, W]`` with per-episode weights (``models/layers.py``)."""
    *lead, _, W = x.shape
    cls_tok, pos = p["class_emb"].to(x.dtype), p["pos_emb"].to(x.dtype)
    if cls_tok.dim() == 2:   # per episode: [N, W] and [N, T, W]
        cls_tok, pos = cls_tok[:, None, None], pos[:, None]
    x = torch.cat([cls_tok.expand(*lead, 1, W), x], dim=-2)
    x = x + pos
    x = L.layer_norm(x, p["ln_pre_w"], p["ln_pre_b"])
    x = L.transformer(x, p["blocks"], cfg.vision_heads, attn=attn, remat=remat)
    x = L.layer_norm(x[..., 0, :] if pool else x, p["ln_post_w"], p["ln_post_b"])
    return L.linear(x, p["proj"])


def encode_image(params, cfg: ClipConfig, images, pool=True, attn="dense", remat=False, bn_prior=None):
    """NHWC images (normalized) -> [B, embed_dim]. A ViT's patch embedding is
    a strided convolution, as in the reference tower (``remat``: see
    ``layers.transformer``); a ResNet tower ignores ``pool``, ``attn`` and
    ``remat`` (its attention pool is dense), as the JAX package's does, and
    takes ``bn_prior`` (``layers.batch_norm_2d``), which a ViT ignores. A
    ResNet with per-episode weights takes images ``[N, B, H, W, 3]`` and gives
    ``[N, B, embed_dim]``."""
    if not cfg.is_vit:
        return _resnet_encode(params["visual"], cfg, images, bn_prior=bn_prior)
    p = params["visual"]
    w = p["conv_w"]  # HWIO
    x = F.conv2d(images.to(w.dtype).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=cfg.vision_patch_size)
    B, W, gh, gw = x.shape
    return _vit_post_patch(p, cfg, x.permute(0, 2, 3, 1).reshape(B, gh * gw, W), pool=pool, attn=attn, remat=remat)


def patch_tokens_from_images(images, patch_size: int):
    """NHWC images -> patch-major tokens [B, T, p*p*3], vector order (row,
    col, channel): the contraction order of the HWIO patch conv."""
    B, H, W, C = images.shape
    gh, gw = H // patch_size, W // patch_size
    x = images.reshape(B, gh, patch_size, gw, patch_size, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch_size * patch_size * C)


def images_from_patch_tokens(tokens, patch_size: int):
    """Inverse of ``patch_tokens_from_images``: [B, T, p*p*3] -> NHWC images."""
    B, T, _ = tokens.shape
    g = int(round(T**0.5))
    p = patch_size
    x = tokens.reshape(B, g, g, p, p, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * p, g * p, 3)


def encode_image_tokens(params, cfg: ClipConfig, tokens, pool=True, attn="dense", remat=False):
    """Encode pre-patchified views: tokens [B, T, p*p*3] -> [B, embed_dim];
    the patch embedding is one matmul against the conv kernel reshaped
    [p*p*3, width]. ViT towers only. With per-episode weights (``conv_w``
    ``[N, p, p, 3, width]``, every leaf on a leading episode axis) tokens are
    ``[N, B, T, p*p*3]`` and the features ``[N, B, embed_dim]``."""
    if not cfg.is_vit:
        raise ValueError("encode_image_tokens requires a ViT tower")
    p = params["visual"]
    w = p["conv_w"]
    kmat = w.reshape(w.shape[:-4] + (-1, w.shape[-1]))  # HWIO row-major == (row, col, channel)
    x = L.linear(tokens.to(kmat.dtype), kmat)
    return _vit_post_patch(p, cfg, x, pool=pool, attn=attn, remat=remat)


def _bottleneck(x, p, stride: int, bn_prior=None):
    """ModifiedResNet bottleneck on NCHW (channels_last): 1x1, 3x3, an
    average pool where it strides, 1x1, and the downsampling shortcut."""
    bn = lambda h, q: L.batch_norm_2d(h, q, prior=bn_prior)
    out = F.relu(bn(L.conv2d(x, p["conv1_w"]), p["bn1"]))
    out = F.relu(bn(L.conv2d(out, p["conv2_w"], padding=1), p["bn2"]))
    if stride > 1:
        out = L.avg_pool(out, stride)
    out = bn(L.conv2d(out, p["conv3_w"]), p["bn3"])
    if "downsample" in p:
        identity = x if stride == 1 else L.avg_pool(x, stride)
        identity = bn(L.conv2d(identity, p["downsample"]["conv_w"]), p["downsample"]["bn"])
    else:
        identity = x
    return F.relu(out + identity)


def _attention_pool(x, p, n_heads: int):
    """QKV attention pool (`TPT/clip/model.py:58-91`) over an NCHW
    (channels_last) feature map -> [B, embed_dim]: the spatial mean token
    first, one query (the mean token's), fp32 logits divided by
    sqrt(head_dim), probabilities cast to x's dtype. Dense: one query row.
    Per-episode weights (``q_w [N, C, C]``) take the N episodes' maps stacked
    on the channels, ``[B, N*C, H, W]``, and give ``[N, B, embed_dim]``."""
    B, C, H, W = x.shape
    if p["q_w"].dim() == 3:
        N = p["q_w"].shape[0]
        C //= N
        tokens, pos = x.reshape(B, N, C, H * W).permute(1, 0, 3, 2), p["pos_emb"][:, None]   # [N, B, HW, C]
    else:
        tokens, pos = x.flatten(2).transpose(1, 2), p["pos_emb"]   # [B, HW, C]
    lead = tokens.shape[:-2]
    mean_tok = tokens.float().mean(dim=-2, keepdim=True).to(x.dtype)
    tokens = torch.cat([mean_tok, tokens], dim=-2) + pos.to(x.dtype)
    head_dim = C // n_heads
    heads = lambda t: t.reshape(*t.shape[:-1], n_heads, head_dim).transpose(-2, -3)   # [..., heads, T, head_dim]
    q = heads(L.linear(tokens[..., :1, :], p["q_w"], p["q_b"]))
    k = heads(L.linear(tokens, p["k_w"], p["k_b"]))
    v = heads(L.linear(tokens, p["v_w"], p["v_b"]))
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(head_dim)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = (probs.float() @ v.float()).to(x.dtype)   # [..., heads, 1, head_dim]
    return L.linear(out.transpose(-2, -3).reshape(*lead, C), p["c_w"], p["c_b"])


def _resnet_encode(p, cfg: ClipConfig, images, bn_prior=None):
    """NHWC images -> [B, embed_dim] through the ModifiedResNet: a 3-conv
    stem, an average pool, four groups of bottlenecks (a group's first block
    strides by 2 past the first group), the attention pool. Per-episode
    weights take ``[N, B, H, W, 3]`` (stacked on the channels inside,
    ``models/layers.py``) and give ``[N, B, embed_dim]``."""
    stem = p["stem"]
    x = images.to(stem["conv1_w"].dtype)
    if stem["conv1_w"].dim() == 5:   # per episode: [N, B, H, W, 3] -> [B, N*3, H, W]
        N, B, H, W, _ = x.shape
        x = x.permute(1, 0, 4, 2, 3).reshape(B, N * 3, H, W)
    else:
        x = x.permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    bn = lambda h, q: L.batch_norm_2d(h, q, prior=bn_prior)
    x = F.relu(bn(L.conv2d(x, stem["conv1_w"], stride=2, padding=1), stem["bn1"]))
    x = F.relu(bn(L.conv2d(x, stem["conv2_w"], padding=1), stem["bn2"]))
    x = F.relu(bn(L.conv2d(x, stem["conv3_w"], padding=1), stem["bn3"]))
    x = L.avg_pool(x, 2)
    for g, blocks in enumerate(p["groups"]):
        for b, block in enumerate(blocks):
            x = _bottleneck(x, block, 1 if (b > 0 or g == 0) else 2, bn_prior)
    return _attention_pool(x, p["attnpool"], cfg.vision_heads)


def best_attn(cfg: Optional[ClipConfig] = None, device="cpu") -> str:
    """The attention implementation for a ViT or text tower on ``device``:
    the fused CUDA kernel on the card, the dense plain math on the CPU."""
    if torch.device(device).type != "cuda":
        return "dense"
    if cfg is not None and not cfg.is_vit:
        return "dense"
    return "fused"


def text_attn(device="cpu") -> str:
    """The attention of a text tower on ``device``, whatever its vision
    tower is: the JAX package's rule for text towers (``best_attn(None)``),
    so the fused kernel on the card under a ResNet policy or reward too."""
    return best_attn(None, device)


# ---------------------------------------------------------------------------
# Text tower
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens):
    """Token ids [B, T] -> embeddings [B, T, D]. A per-episode table ``[N,
    V, D]`` takes ids ``[N, B, T]`` and gathers each episode's rows from its
    own table. An id past the vocabulary reads its last row, as the JAX
    package's gather clamps it (the tiny test configs' vocabularies are
    smaller than the tokenizer's)."""
    table = params["text"]["token_embedding"]
    tokens = tokens.clamp(max=table.shape[-2] - 1)
    if table.dim() == 3:
        return table[torch.arange(table.shape[0], device=tokens.device).view(-1, *([1] * (tokens.dim() - 1))), tokens]
    return table[tokens]


def encode_text_embeds(params, cfg: ClipConfig, embeds, eot_index, attn="dense"):
    """Text features from pre-assembled token embeddings [B, T, D]; the
    pooled position per row is ``eot_index`` [B] (argmax of the token ids).
    Per-episode weights (``positional_embedding [N, T, D]``, ``ln_final_*
    [N, D]``, ``projection [N, D, E]``, blocks ``[N, L, ...]``) take embeds
    ``[N, B, T, D]`` and ``eot_index [N, B]`` and give ``[N, B, E]``."""
    t = params["text"]
    T, D = embeds.shape[-2:]
    pos = t["positional_embedding"][..., :T, :].to(embeds.dtype)
    x = embeds + (pos[:, None] if pos.dim() == 3 else pos)
    x = L.transformer(x, t["blocks"], cfg.text_heads, mask=L.causal_mask(T, x.device), attn=attn)
    x = L.layer_norm(x, t["ln_final_w"], t["ln_final_b"])
    eot = eot_index.to(x.device)
    pooled = torch.gather(x, -2, eot[..., None, None].expand(*eot.shape, 1, D)).squeeze(-2)
    return L.linear(pooled, t["projection"])


def encode_text(params, cfg: ClipConfig, tokens, attn="dense"):
    """Pooled text features from token ids [B, T] (T <= context_length), or
    ``[N, B, T]`` with per-episode weights (``encode_text_embeds``; the
    table ``[N, V, D]`` or shared)."""
    return encode_text_embeds(params, cfg, embed_tokens(params, tokens), tokens.argmax(dim=-1), attn=attn)


def normalize(features, dim=-1):
    return features / features.norm(dim=dim, keepdim=True)


def truncate_tokens(tokens):
    """Drop the all-padding tail of token ids [C, T] (numpy): causal
    attention + EOT pooling make positions past max(eot) dead compute
    (exact, not approximate)."""
    t_max = int(tokens.argmax(axis=-1).max()) + 1
    t_max = min(tokens.shape[1], -(-t_max // 8) * 8)
    return tokens[:, :t_max]


@torch.no_grad()
def encode_token_batches(params, cfg: ClipConfig, tokens, batch_size: int = 256, attn: str = "dense"):
    """Normalized text features [C, E] of token ids [C, T] (numpy), encoded in batches."""
    tokens = tokens.astype("int64")
    device = params["logit_scale"].device
    feats = [encode_text(params, cfg, torch.as_tensor(tokens[s : s + batch_size], device=device), attn=attn)
             for s in range(0, tokens.shape[0], batch_size)]
    return normalize(torch.cat(feats).float())


# ---------------------------------------------------------------------------
# Architecture inference from a checkpoint's key/shape map
# ---------------------------------------------------------------------------


def infer_arch_from_state_dict(shapes: dict) -> ClipConfig:
    """``build_model``'s shape sniffing (`TPT/clip/model.py:399-422`) for
    ViT and ResNet checkpoints; ``shapes`` maps state-dict keys to shapes."""
    if "visual.proj" in shapes:
        vision_width = shapes["visual.conv1.weight"][0]
        vision_layers = len([k for k in shapes if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
        vision_patch = shapes["visual.conv1.weight"][-1]
        image_resolution = vision_patch * round((shapes["visual.positional_embedding"][0] - 1) ** 0.5)
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in shapes if k.startswith(f"visual.layer{g}")})
                              for g in (1, 2, 3, 4))
        vision_width = shapes["visual.layer1.0.conv1.weight"][0]
        vision_patch = None
        image_resolution = 32 * round((shapes["visual.attnpool.positional_embedding"][0] - 1) ** 0.5)
    return ClipConfig(
        name="from-checkpoint",
        embed_dim=shapes["text_projection"][1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch,
        text_width=shapes["ln_final.weight"][0],
        text_layers=len({k.split(".")[2] for k in shapes if k.startswith("transformer.resblocks")}),
        context_length=shapes["positional_embedding"][0],
        vocab_size=shapes["token_embedding.weight"][0],
    )
