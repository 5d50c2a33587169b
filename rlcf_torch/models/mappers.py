"""Prefix mappers: CLIP embedding -> LLM prefix tokens (ClipCap/CapDec), as
plain functions on a parameter dict (the counterpart of
``rlcf_tpu/models/mappers.py``; `caption/image_llm/models/modules.py`).

- ``mlp`` (`modules.py:13-25`): Linear/Tanh emitting prefix_length * llm_dim.
- ``transformer`` (`modules.py:139-160`): the embedding projected to
  ``clip_length`` tokens, concatenated with learned prefix constants, run
  through pre-LN layers (ReLU MLP, bias-free q and kv projections); the
  trailing ``prefix_length`` tokens are the prefix.
- ``transformer_encoder_decoder`` (`modules.py:163-178`): a self-attention
  encoder over the projected tokens and a decoder of alternating cross and
  self layers driven by the prefix constants.

Per-episode mappers: N mappers stacked on a leading axis (every leaf
``[N, ...]``, a layer list's leaves too) take embeddings ``[N, B, clip_dim]``
and give ``[N, B, prefix_length, llm_dim]`` in one batched call, the JAX
package's ``vmap`` over per-image mapper states (``models/layers.py``'s
per-episode convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    kind: str  # "mlp" | "transformer" | "transformer_encoder_decoder"
    clip_dim: int = 512
    llm_dim: int = 768
    prefix_length: int = 40
    clip_length: int = 40
    num_layers: int = 8
    n_heads: int = 8
    mlp_ratio: float = 2.0
    enc_dec_width: int = 512  # TransformerEncoderDecoder internal width


def init_mapper_params(cfg: MapperConfig, seed: int = 0, dtype=torch.float32, device="cpu"):
    """Random mapper parameters (linears normal with std d_in^-0.5 and zero
    biases, LayerNorms at the identity, prefix constants standard normal)
    from ``seed``, made on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = lambda *s, std=1.0: (torch.randn(s, generator=gen, device=device) * std).to(dtype)

    def linear(d_in, d_out, bias=True):
        p = {"w": normal(d_in, d_out, std=d_in**-0.5)}
        if bias:
            p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
        return p

    def xf_layer(d_self, d_ref):
        h = int(d_self * cfg.mlp_ratio)
        ones, zeros = torch.ones(d_self, dtype=dtype, device=device), torch.zeros(d_self, dtype=dtype, device=device)
        return {"norm1_w": ones, "norm1_b": zeros, "q": linear(d_self, d_self, False),
                "kv": linear(d_ref, 2 * d_self, False), "proj": linear(d_self, d_self),
                "norm2_w": ones.clone(), "norm2_b": zeros.clone(), "fc1": linear(d_self, h), "fc2": linear(h, d_self)}

    if cfg.kind == "mlp":
        hidden = (cfg.llm_dim * cfg.prefix_length) // 2
        return {"fc1": linear(cfg.clip_dim, hidden), "fc2": linear(hidden, cfg.llm_dim * cfg.prefix_length)}
    if cfg.kind == "transformer":
        return {"linear": linear(cfg.clip_dim, cfg.clip_length * cfg.llm_dim),
                "prefix_const": normal(cfg.prefix_length, cfg.llm_dim),
                "layers": [xf_layer(cfg.llm_dim, cfg.llm_dim) for _ in range(cfg.num_layers)]}
    if cfg.kind == "transformer_encoder_decoder":
        W = cfg.enc_dec_width
        return {"linear": linear(cfg.clip_dim, cfg.clip_length * W),
                "prefix_const": normal(cfg.prefix_length, cfg.llm_dim),
                "encoder": [xf_layer(W, W) for _ in range(cfg.num_layers)],
                # the decoder alternates cross (ref = the encoder's width) and self layers
                "decoder": [xf_layer(cfg.llm_dim, W if i % 2 == 0 else cfg.llm_dim)
                            for i in range(cfg.num_layers * 2)]}
    raise ValueError(cfg.kind)


def _linear(x, p):
    return L.linear(x, p["w"], p.get("b"))


def _mha(x, y, p, n_heads: int):
    """modules.py MultiHeadAttention: q from x [..., n, C], fused kv from y [..., m, C_ref]."""
    *lead, n, C = x.shape
    m = y.shape[-2]
    hd = C // n_heads
    q = _linear(x, p["q"]).reshape(*lead, n, n_heads, hd)
    kv = _linear(y, p["kv"]).reshape(*lead, m, 2, n_heads, hd)
    k, v = kv[..., 0, :, :], kv[..., 1, :, :]
    att = torch.einsum("...nhd,...mhd->...nmh", q.float(), k.float()) * (hd**-0.5)
    att = torch.softmax(att, dim=-2).to(x.dtype)
    out = torch.einsum("...nmh,...mhd->...nhd", att.float(), v.float()).to(x.dtype)
    return _linear(out.reshape(*lead, n, C), p["proj"])


def _xf_layer(x, y, p, n_heads: int):
    """Pre-LN block (`modules.py:79-98`). ``y=None``: self-attention, whose
    keys and values come from the normed queries (the reference forwards
    ``attn(norm1(x), y=None)``); an explicit ``y`` is used unnormed."""
    xn = L.layer_norm(x, p["norm1_w"], p["norm1_b"])
    x = x + _mha(xn, xn if y is None else y, p, n_heads)
    h = L.layer_norm(x, p["norm2_w"], p["norm2_b"])
    return x + _linear(F.relu(_linear(h, p["fc1"])), p["fc2"])


def _prefix_const(params, lead):
    """The learned constants ``[P, D]`` (or ``[N, P, D]`` per episode) broadcast to ``[*lead, P, D]``."""
    c = params["prefix_const"]
    if c.dim() == 3:
        c = c.reshape(c.shape[0], *([1] * (len(lead) - 1)), *c.shape[1:])
    return c.expand(*lead, *c.shape[-2:])


def mapper_forward(params, cfg: MapperConfig, clip_emb):
    """clip_emb [B, clip_dim] -> prefix tokens [B, prefix_length, llm_dim];
    with per-episode parameters clip_emb [N, B, clip_dim] -> [N, B, P, D]."""
    lead = clip_emb.shape[:-1]
    if cfg.kind == "mlp":
        out = _linear(torch.tanh(_linear(clip_emb, params["fc1"])), params["fc2"])
        return out.reshape(*lead, cfg.prefix_length, cfg.llm_dim)
    if cfg.kind == "transformer":
        x = _linear(clip_emb, params["linear"]).reshape(*lead, cfg.clip_length, cfg.llm_dim)
        h = torch.cat([x, _prefix_const(params, lead).to(x.dtype)], dim=-2)
        for layer in params["layers"]:
            h = _xf_layer(h, None, layer, cfg.n_heads)
        return h[..., cfg.clip_length:, :]
    if cfg.kind == "transformer_encoder_decoder":
        ref = _linear(clip_emb, params["linear"]).reshape(*lead, cfg.clip_length, cfg.enc_dec_width)
        for layer in params["encoder"]:
            ref = _xf_layer(ref, None, layer, cfg.n_heads)
        x = _prefix_const(params, lead).to(ref.dtype)
        for i, layer in enumerate(params["decoder"]):
            x = _xf_layer(x, ref if i % 2 == 0 else x, layer, cfg.n_heads)
        return x
    raise ValueError(cfg.kind)


def convert_mapper_state_dict(sd, cfg: MapperConfig, prefix: str = "clip_project.", dtype=torch.float32,
                              device="cpu"):
    """ClipCap/CapDec torch checkpoint (``clip_project.*`` keys; tensors or
    numpy arrays) -> mapper parameters (``mlp`` or ``transformer``)."""

    def t(k, tr=False):
        v = sd[prefix + k]
        v = v.detach().cpu().float() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v, np.float32))
        return (v.T.contiguous() if tr else v).to(device=device, dtype=dtype)

    if cfg.kind == "mlp":
        return {"fc1": {"w": t("model.0.weight", True), "b": t("model.0.bias")},
                "fc2": {"w": t("model.2.weight", True), "b": t("model.2.bias")}}
    if cfg.kind == "transformer":
        layers = []
        for i in range(cfg.num_layers):
            base = f"transformer.layers.{i}."
            layers.append({
                "norm1_w": t(base + "norm1.weight"), "norm1_b": t(base + "norm1.bias"),
                "q": {"w": t(base + "attn.to_queries.weight", True)},
                "kv": {"w": t(base + "attn.to_keys_values.weight", True)},
                "proj": {"w": t(base + "attn.project.weight", True), "b": t(base + "attn.project.bias")},
                "norm2_w": t(base + "norm2.weight"), "norm2_b": t(base + "norm2.bias"),
                "fc1": {"w": t(base + "mlp.fc1.weight", True), "b": t(base + "mlp.fc1.bias")},
                "fc2": {"w": t(base + "mlp.fc2.weight", True), "b": t(base + "mlp.fc2.bias")},
            })
        return {"linear": {"w": t("linear.weight", True), "b": t("linear.bias")},
                "prefix_const": t("prefix_const"), "layers": layers}
    raise ValueError(f"conversion for {cfg.kind} not supported")
