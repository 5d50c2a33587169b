"""OPT causal decoder with prefix (query_embeds) conditioning, as plain
functions on a parameter dict (the counterpart of ``rlcf_tpu/models/opt.py``).

The reference's HF-OPT fork (`caption/image_llm/models/modeling_opt.py`)
concatenates ``query_embeds`` before the token embeddings (:702-704) and
derives positions from the attention-mask cumsum with OPT's +2 offset, so a
learned prefix conditions generation. Generation follows
`caption/image_llm/models/generate_opt.py:6-85`: beam search (or nucleus
sampling) with EOS = the newline token, at most 50 new tokens.

Parameters keep the JAX package's layout (decoder blocks stacked on a leading
layer axis, linears ``[in, out]``), so ``models/convert.py`` carries them
across. The attention is plain torch, as the JAX package's is plain ``jnp``:
q scaled before the product, fp32 logits plus an additive -1e9 bias, the
softmax in fp32 and the probabilities cast to the activation dtype.

A tree split over tp by ``parallel/tp_opt.py::tp_opt_params`` carries a
``"tp"`` entry, and these functions run the Megatron collectives it needs:
each rank holds its heads (and KV caches), its share of the MLP and of the
vocabulary; the row-parallel products are summed over tp before their bias,
the embedding rows summed, the head's logits gathered.

Generation runs eagerly: the prefix K/V are computed once per prefix and
shared by reference by every beam or sample of it; only the generated
positions have a per-sequence cache, which a beam reorder gathers. The JAX
package's ``while_loop`` exit becomes a host check per token
(``_all_finished``); stepping past the point where every sequence finished
only appends pads at no score cost, so the result would not depend on
checking less often.

OPT-125m: 12 layers, d=768, 12 heads, ffn 3072, ReLU, pre-LN, tied LM head.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.losses import top_k_indices
from ..parallel.collectives import all_reduce_sum, gather_replicated, max_over
from ..parallel.mesh import shard_range
from .layers import layer_norm

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn: int = 3072
    max_positions: int = 2048
    pos_offset: int = 2  # OPTLearnedPositionalEmbedding offset
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_newline_id: int = 50118  # '\n' for the OPT tokenizer ("\n" eos, generate_opt.py:53)
    # OPT-350m: embeddings and prefixes live in a smaller space bridged by
    # project_in/project_out, the blocks are POST-LN and there is no final LN.
    word_embed_proj_dim: Optional[int] = None  # None -> == hidden (no projection)
    do_layer_norm_before: bool = True

    @property
    def embed_dim(self) -> int:
        """Input-embedding dim: what mappers must produce (`modules.py:205-207`)."""
        return self.word_embed_proj_dim or self.hidden


OPT_CONFIGS = {
    "opt-125m": OPTConfig(),
    "opt-350m": OPTConfig(hidden=1024, n_layers=24, n_heads=16, ffn=4096,
                          word_embed_proj_dim=512, do_layer_norm_before=False),
    "opt-1.3b": OPTConfig(hidden=2048, n_layers=24, n_heads=32, ffn=8192),
    "opt-2.7b": OPTConfig(hidden=2560, n_layers=32, n_heads=32, ffn=10240),
    "test-tiny-opt": OPTConfig(vocab_size=256, hidden=32, n_layers=2, n_heads=2, ffn=64, max_positions=128,
                               eos_newline_id=3),
    "test-tiny-opt-350m": OPTConfig(vocab_size=256, hidden=32, n_layers=2, n_heads=2, ffn=64,
                                    max_positions=128, eos_newline_id=3,
                                    word_embed_proj_dim=16, do_layer_norm_before=False),
}


def init_opt_params(seed: int, cfg: OPTConfig, dtype=torch.float32, device="cpu"):
    """Random OPT parameters (normal, std 0.02; LayerNorms at the identity)
    from ``seed``, made on ``device`` with a generator of that device."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, Fh, L, E = cfg.hidden, cfg.ffn, cfg.n_layers, cfg.embed_dim
    norm = lambda *s: (torch.randn(s, generator=gen, device=device) * 0.02).to(dtype)
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    blocks = {
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "q_w": norm(L, D, D), "q_b": zeros(L, D), "k_w": norm(L, D, D), "k_b": zeros(L, D),
        "v_w": norm(L, D, D), "v_b": zeros(L, D), "out_w": norm(L, D, D), "out_b": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "fc1_w": norm(L, D, Fh), "fc1_b": zeros(L, Fh), "fc2_w": norm(L, Fh, D), "fc2_b": zeros(L, D),
    }
    params = {"embed_tokens": norm(cfg.vocab_size, E), "embed_positions": norm(cfg.max_positions + cfg.pos_offset, D),
              "blocks": blocks}
    if cfg.do_layer_norm_before:  # HF: final_layer_norm exists only pre-LN
        params["final_ln_w"], params["final_ln_b"] = ones(D), zeros(D)
    if E != D:
        params["project_in"], params["project_out"] = norm(E, D), norm(D, E)
    return params


# ---------------------------------------------------------------------------
# Weight-only int8 (decode weight stream)
# ---------------------------------------------------------------------------


def _w(p, name, dt):
    """Weight fetch with optional int8 weight-only dequant: quantized entries
    are ``{"q8": int8, "sc": fp32 per-output-channel scales}``."""
    v = p[name]
    if isinstance(v, dict):
        return (v["q8"].float() * v["sc"]).to(dt)
    return v


def _clamp_ids(tokens, table):
    """Token ids past the vocabulary read its last row, as the JAX package's
    gather clamps them (a tokenizer's ids may outnumber a tiny config's)."""
    return tokens.clamp(max=table.shape[0] - 1)


def _rows(v, tokens, dt):
    """Rows ``tokens`` of a table, plain or int8 (per-row scales)."""
    if isinstance(v, dict):
        return (v["q8"][tokens].float() * v["sc"][tokens][..., None]).to(dt)
    return v[tokens]


def _embed_rows(params, tokens, dt):
    """Embedding lookup supporting int8 rows (per-row scales). Split over tp
    (vocabulary rows): each rank looks up the ids in its range, zeros
    elsewhere, and the rows are summed over tp."""
    v, s = params["embed_tokens"], params.get("tp")
    if s is None or not s.vocab:
        return _rows(v, _clamp_ids(tokens, v["q8"] if isinstance(v, dict) else v), dt)
    lo, hi = s.vocab_range()
    local = tokens.clamp(max=s.vocab_size - 1) - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = _rows(v, local.clamp(0, hi - lo - 1), dt).masked_fill(~inside[..., None], 0)
    return all_reduce_sum(rows, s.group)


def quantize_opt_params(params):
    """Weight-only int8 quantization of the decode weight stream: symmetric
    per-output-channel scales for the block matrices and projections,
    per-row scales for the tied embedding / LM-head matrix; LayerNorms,
    biases and positional embeddings stay in full precision. Generation only:
    the CE/update path keeps the full-precision weights. Computed in numpy on
    the host, as the JAX package computes it, so ``q8`` and ``sc`` are equal
    bit for bit."""

    def q(w, axis):
        w32 = w.detach().float().cpu().numpy()
        sc = np.max(np.abs(w32), axis=axis, keepdims=True) / 127.0
        sc = np.maximum(sc, 1e-12)
        q8 = np.clip(np.rint(w32 / sc), -127, 127).astype(np.int8)
        return {"q8": torch.from_numpy(q8).to(w.device), "sc": torch.from_numpy(np.squeeze(sc, axis=axis)).to(w.device)}

    out = dict(params)
    blocks = dict(params["blocks"])
    for name in ("q_w", "k_w", "v_w", "out_w", "fc1_w", "fc2_w"):
        blocks[name] = q(blocks[name], axis=1)  # [L, in, out] -> sc [L, out]
    out["blocks"] = blocks
    out["embed_tokens"] = q(params["embed_tokens"], axis=1)  # [V, E] -> sc [V]
    for name in ("project_in", "project_out"):
        if name in params:
            out[name] = q(params[name], axis=0)  # [in, out] -> sc [out]
    return out


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _layer_params(params, i):
    """Layer ``i`` of the stacked blocks (int8 entries sliced leaf by leaf),
    with the tree's tp split under ``"tp"``."""
    blocks = params["blocks"]
    layer = {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i]) for k, v in blocks.items()}
    layer["tp"] = params.get("tp")
    return layer


def _local_heads(p, cfg: OPTConfig) -> int:
    """The heads this rank holds: its share under a tp split of the attention."""
    s = p.get("tp")
    return cfg.n_heads // s.size if s is not None and s.attn else cfg.n_heads


def _row_parallel(x, p, w: str, b: str, split: bool):
    """``x @ w + b``; for a weight split along its input features (``split``)
    the partial products are summed over tp first, and the bias added once."""
    y = x @ _w(p, w, x.dtype)
    if split:
        y = all_reduce_sum(y, p["tp"].group)
    return y + p[b]


def _qkv(x, p, cfg: OPTConfig):
    """q (scaled, as OPT scales it before the product), k and v of ``x [B, T, D]``, heads split: [B, H, T, hd]
    (H this rank's heads)."""
    B, T, D = x.shape
    H, hd = _local_heads(p, cfg), D // cfg.n_heads
    q = (x @ _w(p, "q_w", x.dtype) + p["q_b"]) * (hd**-0.5)
    k = x @ _w(p, "k_w", x.dtype) + p["k_b"]
    v = x @ _w(p, "v_w", x.dtype) + p["v_b"]
    split = lambda t: t.reshape(B, T, H, hd).transpose(1, 2)
    return split(q), split(k), split(v)


def _out_proj(out, p):
    """The attention's output projection of the heads' outputs ``[..., H * hd]``."""
    return _row_parallel(out, p, "out_w", "out_b", p["tp"] is not None and p["tp"].attn)


def _attn(x, p, cfg: OPTConfig, mask_bias):
    """Self-attention over ``x [B, T, D]`` -> (output, (k, v) [B, H, T, hd])."""
    B, T, D = x.shape
    q, k, v = _qkv(x, p, cfg)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + mask_bias
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, T, -1)
    return _out_proj(out, p), (k, v)


def _mlp(x, p):
    h = F.relu(x @ _w(p, "fc1_w", x.dtype) + p["fc1_b"])
    return _row_parallel(h, p, "fc2_w", "fc2_b", p.get("tp") is not None and p["tp"].ffn)


def _layer(x, p, cfg: OPTConfig, mask_bias):
    """OPTDecoderLayer: pre-LN (125m/1.3b/...) or post-LN (350m)."""
    if cfg.do_layer_norm_before:
        h, kv = _attn(layer_norm(x, p["ln1_w"], p["ln1_b"]), p, cfg, mask_bias)
        x = x + h
        return x + _mlp(layer_norm(x, p["ln2_w"], p["ln2_b"]), p), kv
    h, kv = _attn(x, p, cfg, mask_bias)
    x = layer_norm(x + h, p["ln1_w"], p["ln1_b"])
    return layer_norm(x + _mlp(x, p), p["ln2_w"], p["ln2_b"]), kv


def _split_proj(params) -> bool:
    s = params.get("tp")
    return s is not None and s.proj


def _embed_in(params, x):
    """Projection-space embeddings -> hidden space (project_in; split over tp
    along its outputs, which are gathered)."""
    if "project_in" in params:
        y = (x.float() @ _w(params, "project_in", torch.float32)).to(x.dtype)
        return gather_replicated(y, params["tp"].group, dim=-1) if _split_proj(params) else y
    return x


def _head(params, x):
    """Final LN (where the checkpoint has one) + project_out + tied LM head
    -> fp32 logits. Keyed on the parameter's presence: pre-LN checkpoints
    saved with HF's ``_remove_final_layer_norm`` quirk have none."""
    if "final_ln_w" in params:
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    if "project_out" in params:
        s, xf = params.get("tp"), x.float()
        if _split_proj(params):   # split along its inputs: this rank's features, the products summed over tp
            lo, hi = shard_range(x.shape[-1], s.size, s.index)
            x = all_reduce_sum(xf[..., lo:hi] @ _w(params, "project_out", torch.float32), s.group).to(x.dtype)
        else:
            x = (xf @ _w(params, "project_out", torch.float32)).to(x.dtype)
    emb, s = params["embed_tokens"], params.get("tp")
    if isinstance(emb, dict):   # per-row scales apply per output column of x @ W.T
        logits = (x.float() @ emb["q8"].to(x.dtype).float().T) * emb["sc"]
    else:
        logits = x.float() @ emb.float().T
    return gather_replicated(logits, s.group, dim=-1) if s is not None and s.vocab else logits


def _positions_from_mask(mask, offset: int):
    """OPTLearnedPositionalEmbedding: cumsum(mask) * mask - 1 + offset. No
    clamp before the offset: pads get raw id -1, i.e. row ``offset - 1``, as
    in HF; their CE terms count in the TTA loss, so this must match."""
    m = mask.long()
    return torch.cumsum(m, dim=1) * m - 1 + offset


def _embed_positions(params, pos):
    """Position rows; a position past the table reads its last row, as the
    JAX package's gather clamps it (a tiny config's table is short)."""
    table = params["embed_positions"]
    return table[pos.clamp(max=table.shape[0] - 1) if torch.is_tensor(pos) else min(pos, table.shape[0] - 1)]


def _causal(T, device):
    return torch.full((T, T), NEG, device=device).triu(1)


def forward(params, cfg: OPTConfig, tokens=None, prefix_embeds=None, attention_mask=None):
    """Teacher-forcing forward -> fp32 logits [B, P+T, V]. ``prefix_embeds``
    [B, P, E] go before the token embeddings (`modeling_opt.py:702-704`);
    ``attention_mask`` [B, P+T] marks the valid positions, prefix included."""
    embeds = []
    if prefix_embeds is not None:
        embeds.append(prefix_embeds)
    if tokens is not None:
        dt = prefix_embeds.dtype if prefix_embeds is not None else torch.float32
        embeds.append(_embed_rows(params, tokens, dt))
    x = _embed_in(params, torch.cat(embeds, dim=1))
    B, T, _ = x.shape
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.long, device=x.device)
    x = x + _embed_positions(params, _positions_from_mask(attention_mask, cfg.pos_offset))
    pad_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG).float()
    mask_bias = _causal(T, x.device)[None, None] + pad_bias
    for i in range(cfg.n_layers):
        x, _ = _layer(x, _layer_params(params, i), cfg, mask_bias)
    return _head(params, x)


# ---------------------------------------------------------------------------
# Cached generation
# ---------------------------------------------------------------------------


def _prefill(params, cfg: OPTConfig, prefix_embeds):
    """Run the prefix through the decoder -> (logits of its last position
    [B, V], prefix cache (k, v) each [L, B, H, P, hd]). The cache is never
    written afterwards: every beam or sample of a prefix reads it by
    reference (the per-image prefix K/V are equal across its beams, so a
    beam reorder need not move them)."""
    B, P = prefix_embeds.shape[:2]
    mask = torch.ones((B, P), dtype=torch.long, device=prefix_embeds.device)
    x = _embed_in(params, prefix_embeds) + _embed_positions(params, _positions_from_mask(mask, cfg.pos_offset))
    causal = _causal(P, x.device)[None, None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(x, _layer_params(params, i), cfg, causal)
        ks.append(k)
        vs.append(v)
    return _head(params, x[:, -1:])[:, 0], (torch.stack(ks), torch.stack(vs))


def _init_gen_cache(cfg: OPTConfig, n_seqs: int, slots: int, dtype, device, heads: Optional[int] = None):
    """Per-sequence cache of generated positions: (k, v) each [L, N, H, slots, hd], H the heads a rank holds
    (all of them by default)."""
    shape = (cfg.n_layers, n_seqs, heads or cfg.n_heads, slots, cfg.hidden // cfg.n_heads)
    return torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device)


def _decode_step(params, cfg: OPTConfig, token, prefix_cache, gen_cache, t: int, expand: int):
    """One cached decode step. ``token`` [N] (N = B * expand sequences); the
    prefix cache holds one entry per prefix, read by the ``expand``
    sequences of it through a product over the ``[B, E]`` split (never
    expanded per sequence); the generated-position cache [L, N, H, G, hd] is
    written at slot ``t`` (absolute position P + t) in place. -> logits [N, V]."""
    k_pre, v_pre = prefix_cache
    k_gen, v_gen = gen_cache
    L, B, H, P, hd = k_pre.shape
    G = k_gen.shape[3]
    N = token.shape[0]
    E = expand
    x = _embed_in(params, _embed_rows(params, token, k_pre.dtype)[:, None, :])  # [N, 1, D]
    x = x + _embed_positions(params, P + t + cfg.pos_offset)
    gen_bias = torch.where(torch.arange(G, device=x.device) <= t, 0.0, NEG).float()   # attend to slots [0, t]
    for i in range(cfg.n_layers):
        p = _layer_params(params, i)
        h_ln = layer_norm(x, p["ln1_w"], p["ln1_b"]) if cfg.do_layer_norm_before else x
        q, k_new, v_new = _qkv(h_ln, p, cfg)          # [N, H, 1, hd]
        k_gen[i, :, :, t] = k_new[:, :, 0].to(k_gen.dtype)
        v_gen[i, :, :, t] = v_new[:, :, 0].to(v_gen.dtype)
        q = q[:, :, 0].float()                        # [N, H, hd]
        lg_pre = torch.einsum("behd,bhpd->behp", q.reshape(B, E, H, hd), k_pre[i].float()).reshape(N, H, P)
        lg_gen = torch.einsum("nhd,nhgd->nhg", q, k_gen[i].float()) + gen_bias
        probs = torch.softmax(torch.cat([lg_pre, lg_gen], dim=-1), dim=-1).to(x.dtype).float()
        out_pre = torch.einsum("behp,bhpd->behd", probs[:, :, :P].reshape(B, E, H, P), v_pre[i].float())
        out_gen = torch.einsum("nhg,nhgd->nhd", probs[:, :, P:], v_gen[i].float())
        out = _out_proj((out_pre.reshape(N, H, hd) + out_gen).to(x.dtype).reshape(N, 1, H * hd), p)
        if cfg.do_layer_norm_before:
            x = x + out
            x = x + _mlp(layer_norm(x, p["ln2_w"], p["ln2_b"]), p)
        else:
            x = layer_norm(x + out, p["ln1_w"], p["ln1_b"])
            x = layer_norm(x + _mlp(x, p), p["ln2_w"], p["ln2_b"])
    return _head(params, x)[:, 0]


def _all_finished(finished) -> bool:
    """The early exit's host check: a device sync each token, whose cost
    ``chip_smoke.py``'s ``exit_check_cost`` could not tell from the host's
    noise (+-0.7 ms of a 13-16 ms token at a group of 16 on an NVIDIA H100
    80GB HBM3 at 700 W)."""
    return bool(finished.all())


def _segment_bounds(max_new_tokens: int, seg_len: Optional[int]):
    if not seg_len:
        return [max_new_tokens]
    bounds, b = [], 0
    while b < max_new_tokens:
        b = min(b + seg_len, max_new_tokens)
        bounds.append(b)
    return bounds


@torch.no_grad()
def beam_generate(params, cfg: OPTConfig, prefix_embeds, num_beams: int = 5, max_new_tokens: int = 50,
                  min_length: int = 1, eos_id: Optional[int] = None, length_penalty: float = 1.0,
                  num_return: Optional[int] = None, seg_len: Optional[int] = None):
    """Beam search conditioned on ``prefix_embeds`` [B, P, E] -> (sequences
    [B, num_return, max_new_tokens] int64, padded with the pad token after
    EOS; scores [B, num_return]). EOS defaults to the newline token
    (`generate_opt.py:53`); hypotheses are ranked by score /
    length^length_penalty, a stable sort, as HF beam search ranks them.

    ``seg_len``: the generated-position cache grows ``seg_len`` slots at a
    time, so the beam reorder's gather and the generated-position attention
    read the slots elapsed so far, not ``max_new_tokens``; same sequences.
    None or 0: one full-size cache. A negative value raises."""
    if seg_len is not None and seg_len < 0:
        raise ValueError(f"seg_len must be positive (or None/0 = off), got {seg_len}")
    eos = cfg.eos_newline_id if eos_id is None else eos_id
    num_return = num_return or num_beams
    B, K, dev = prefix_embeds.shape[0], num_beams, prefix_embeds.device
    logits0, prefix_cache = _prefill(params, cfg, prefix_embeds)
    V = logits0.shape[-1]
    bounds = _segment_bounds(max_new_tokens, seg_len)
    k_gen, v_gen = _init_gen_cache(cfg, B * K, bounds[0], prefix_cache[0].dtype, dev, prefix_cache[0].shape[2])
    seqs = torch.full((B, K, max_new_tokens), cfg.pad_token_id, dtype=torch.long, device=dev)
    beam_scores = torch.full((B, K), NEG, device=dev)
    beam_scores[:, 0] = 0.0    # only beam 0 live initially
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    pad_only = torch.full((V,), NEG, device=dev)
    pad_only[cfg.pad_token_id] = 0.0
    is_eos = torch.arange(V, device=dev) == eos
    rows = torch.arange(B, device=dev)[:, None]
    logits = logits0.repeat_interleave(K, dim=0)   # [B*K, V]
    step = 0
    for bound in bounds:
        if k_gen.shape[3] < bound:   # grow the cache to the next segment's slots
            grow = lambda c: F.pad(c, (0, 0, 0, bound - c.shape[3]))
            k_gen, v_gen = grow(k_gen), grow(v_gen)
        while step < bound and not _all_finished(finished):
            logp = torch.log_softmax(logits.reshape(B, K, V).float(), dim=-1)
            if step < min_length:   # no EOS before min_length
                logp = torch.where(is_eos, NEG, logp)
            # finished beams extend with pad only, at no cost
            cand = torch.where(finished[..., None], beam_scores[..., None] + pad_only, beam_scores[..., None] + logp)
            # ties by the lower index, as lax.top_k breaks them (a finished beam's -1e9 candidates are fp32 ties)
            flat = cand.reshape(B, K * V)
            top_idx = top_k_indices(flat, K)
            top_scores = torch.gather(flat, 1, top_idx)
            src_beam, token = top_idx // V, top_idx % V
            seqs = seqs[rows, src_beam]
            was_finished = finished[rows, src_beam]
            token = torch.where(was_finished, cfg.pad_token_id, token)
            seqs[:, :, step] = token
            finished = was_finished | (token == eos)
            beam_scores = top_scores
            # the beam reorder moves the generated-position cache only
            reorder = lambda c: c.reshape(c.shape[0], B, K, *c.shape[2:])[:, rows, src_beam].reshape(c.shape)
            k_gen, v_gen = reorder(k_gen), reorder(v_gen)
            logits = _decode_step(params, cfg, token.reshape(B * K), prefix_cache, (k_gen, v_gen), step, K)
            step += 1
    lengths = (seqs != cfg.pad_token_id).sum(dim=-1).clamp(min=1)
    norm_scores = beam_scores / lengths.float() ** length_penalty
    order = torch.sort(-norm_scores, dim=1, stable=True).indices[:, :num_return]
    return seqs[rows, order], torch.gather(norm_scores, 1, order)


def top_p_mask(logits, top_p: float, temperature: float = 1.0):
    """The nucleus filter of ``nucleus_generate`` (`sample_top_p`): logits /
    temperature with every entry below the smallest kept one set to -1e9;
    entries are kept, largest first, until their probability mass reaches
    ``top_p``."""
    logits = logits / temperature
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)   # keep tokens until cum >= p
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp(max=logits.shape[-1] - 1))
    return torch.where(logits < cutoff, NEG, logits)


@torch.no_grad()
def nucleus_generate(params, cfg: OPTConfig, prefix_embeds, generator: torch.Generator, num_captions: int = 5,
                     max_new_tokens: int = 50, min_length: int = 1, top_p: float = 0.92, temperature: float = 1.0,
                     eos_id: Optional[int] = None, rows: Optional[Tuple[int, int]] = None, group=None):
    """Nucleus sampling: ``num_captions`` independent samples per prefix ->
    [B, num_captions, max_new_tokens]. The draws come from ``generator``
    (a ``torch.Generator`` on the prefix's device): the JAX package's recipe,
    not its draws (``jax.random.categorical`` on split keys). Each step draws
    one uniform a sequence and inverts the filtered distribution's CDF.
    ``rows`` = (first, total): these B * num_captions sequences are rows
    first.. of a group of ``total`` (a dp rank's slice); every step draws the
    whole group's uniforms and keeps these rows, so that the slice samples
    what the whole group's run samples. ``group``: the process group of the
    ranks that hold the other rows. The whole group's run steps until its
    last row finishes, so a slice that finishes first draws the uniforms of
    the steps left, and ``generator`` ends where the whole group's run
    leaves it."""
    eos = cfg.eos_newline_id if eos_id is None else eos_id
    B, K, dev = prefix_embeds.shape[0], num_captions, prefix_embeds.device
    logits0, prefix_cache = _prefill(params, cfg, prefix_embeds)
    V = logits0.shape[-1]
    gen_cache = _init_gen_cache(cfg, B * K, max_new_tokens, prefix_cache[0].dtype, dev, prefix_cache[0].shape[2])
    seqs = torch.full((B * K, max_new_tokens), cfg.pad_token_id, dtype=torch.long, device=dev)
    finished = torch.zeros((B * K,), dtype=torch.bool, device=dev)
    is_eos = torch.arange(V, device=dev) == eos
    logits = logits0.repeat_interleave(K, dim=0)
    first, total = rows or (0, B * K)
    step = 0
    while step < max_new_tokens and not _all_finished(finished):
        if step < min_length:
            logits = torch.where(is_eos, NEG, logits)
        cdf = torch.softmax(top_p_mask(logits, top_p, temperature), dim=-1).cumsum(dim=-1)
        u = torch.rand(total, generator=generator, device=dev)[first : first + B * K, None] * cdf[:, -1:]
        # the first token whose cumulative mass passes u: never a filtered (zero-mass) one
        token = torch.searchsorted(cdf, u, right=True)[:, 0].clamp(max=V - 1)
        token = torch.where(finished, cfg.pad_token_id, token)
        seqs[:, step] = token
        finished = finished | (token == eos)
        logits = _decode_step(params, cfg, token, prefix_cache, gen_cache, step, K)
        step += 1
    if rows is not None:
        for _ in range(step, max_over(step, group, dev)):
            torch.rand(total, generator=generator, device=dev)
    return seqs.reshape(B, K, max_new_tokens)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


# released OPT sizes: hidden -> attention heads (head_dim is NOT constant
# across the family: 64 up to 2.7b, 128 from 6.7b; never derive heads from
# hidden // 64)
_OPT_N_HEADS = {768: 12, 1024: 16, 2048: 32, 2560: 32, 4096: 32, 5120: 40, 7168: 56, 9216: 72}


def convert_opt_state_dict(sd: Dict, dtype=torch.float32, n_heads: Optional[int] = None,
                           device="cpu") -> Tuple[dict, OPTConfig]:
    """HF OPT state dict (``model.decoder.*`` or ``decoder.*`` keys; torch
    tensors or numpy arrays) -> (params, config). ``n_heads`` overrides the
    head count, which HF state dicts do not record: the released sizes are
    inferred, anything else must be given."""

    def t(x):
        x = x.detach().cpu().float() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
        return x.to(device=device, dtype=dtype)

    pre = "model.decoder." if any(k.startswith("model.decoder.") for k in sd) else "decoder."
    get = lambda k: t(sd[pre + k])
    n_layers = len({m.group(1) for k in sd for m in [re.search(r"\.layers\.(\d+)\.", k)] if m})
    embed = get("embed_tokens.weight")
    # OPT-350m: embed_tokens live in word_embed_proj_dim and project_in maps
    # to the transformer width; its presence also means post-LN blocks and no
    # decoder-level final_layer_norm (HF OPTConfig semantics).
    has_proj = (pre + "project_in.weight") in sd
    hidden = sd[pre + "project_in.weight"].shape[0] if has_proj else embed.shape[1]
    has_final_ln = (pre + "final_layer_norm.weight") in sd
    if n_heads is None:
        n_heads = _OPT_N_HEADS.get(hidden)
        if n_heads is None:
            raise ValueError(f"cannot infer attention heads for hidden={hidden} (not a released OPT size); "
                             "pass n_heads= explicitly to convert_opt_state_dict")
    # post-LN only in OPT-350m (the one size with an embed projection); a
    # missing final_layer_norm WITHOUT a projection is HF's
    # _remove_final_layer_norm quirk: pre-LN blocks, no final LN (_head).
    cfg = OPTConfig(vocab_size=embed.shape[0], hidden=hidden, n_layers=n_layers,
                    ffn=sd[pre + "layers.0.fc1.weight"].shape[0],
                    max_positions=sd[pre + "embed_positions.weight"].shape[0] - 2, n_heads=n_heads,
                    word_embed_proj_dim=embed.shape[1] if has_proj else None,
                    do_layer_norm_before=has_final_ln or not has_proj)
    stack = lambda name, tr=False: torch.stack(
        [get(f"layers.{i}.{name}").T.contiguous() if tr else get(f"layers.{i}.{name}") for i in range(n_layers)])
    blocks = {
        "ln1_w": stack("self_attn_layer_norm.weight"), "ln1_b": stack("self_attn_layer_norm.bias"),
        "q_w": stack("self_attn.q_proj.weight", True), "q_b": stack("self_attn.q_proj.bias"),
        "k_w": stack("self_attn.k_proj.weight", True), "k_b": stack("self_attn.k_proj.bias"),
        "v_w": stack("self_attn.v_proj.weight", True), "v_b": stack("self_attn.v_proj.bias"),
        "out_w": stack("self_attn.out_proj.weight", True), "out_b": stack("self_attn.out_proj.bias"),
        "ln2_w": stack("final_layer_norm.weight"), "ln2_b": stack("final_layer_norm.bias"),
        "fc1_w": stack("fc1.weight", True), "fc1_b": stack("fc1.bias"),
        "fc2_w": stack("fc2.weight", True), "fc2_b": stack("fc2.bias"),
    }
    params = {"embed_tokens": embed, "embed_positions": get("embed_positions.weight"), "blocks": blocks}
    if has_final_ln:
        params["final_ln_w"], params["final_ln_b"] = get("final_layer_norm.weight"), get("final_layer_norm.bias")
    if has_proj:
        params["project_in"] = get("project_in.weight").T.contiguous()
        params["project_out"] = get("project_out.weight").T.contiguous()
    return params, cfg
