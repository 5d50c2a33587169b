"""GPT-2 language model, the legacy ClipCap captioner backend, as plain
functions on a parameter dict (the counterpart of ``rlcf_tpu/models/gpt2.py``).

The reference's ``LLMModel`` wraps HF GPT-2 or the OPT fork
(`caption/image_llm/models/modules.py:188-209`); ClipCap captions come from a
length-normalised beam search and a top-p greedy sampler over
``inputs_embeds`` (`caption/image_llm/generate.py:9-145`).

Numerics follow HF ``GPT2LMHeadModel`` as the JAX package does: learned
absolute positions added to (prefix ++ token) embeddings, sequential whatever
the attention mask; pre-LN blocks with the ``gelu_new`` tanh activation (in
fp32); scores scaled by 1/sqrt(head_dim) in fp32 plus an additive -1e9 bias;
the probabilities cast to the activation dtype before P.V; a final ``ln_f``
and the LM head tied to ``wte``, its logits in fp32. The attention is plain
torch, as the JAX package's is plain ``jnp`` (no Pallas kernel).

Parameters keep the JAX package's layout (blocks stacked on a leading layer
axis, HF Conv1D weights ``[in, out]``), so ``models/convert.py`` carries them
across. Token ids past the vocabulary read its last row, as JAX's gather
clamps them.

Generation runs eagerly with a cache of ``P + entry_length`` slots written in
place; each step attends over the slots written so far (JAX's static cache
masks the rest to exact zeros). The JAX package's ``while_loop`` exit becomes
a host check per token.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch

from ..core.losses import top_k_indices
from .layers import layer_norm

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    name: str
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    ln_eps: float = 1e-5


GPT2_CONFIGS = {
    "gpt2": GPT2Config("gpt2"),
    "gpt2-medium": GPT2Config("gpt2-medium", n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": GPT2Config("gpt2-large", n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": GPT2Config("gpt2-xl", n_embd=1600, n_layer=48, n_head=25),
    "test-tiny-gpt2": GPT2Config("test-tiny-gpt2", vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2),
}


def gelu_new(x):
    """HF 'gelu_new' tanh approximation (GPT-2's activation), in fp32."""
    x32 = x.float()
    y = 0.5 * x32 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x32 + 0.044715 * x32**3)))
    return y.to(x.dtype)


def init_gpt2_params(seed: int, cfg: GPT2Config, dtype=torch.float32, device="cpu"):
    """Random GPT-2 parameters from ``seed``: normal std 0.02, the c_proj
    layers std 0.02 / sqrt(2 n_layer) (GPT-2's scaled init), LayerNorms at
    the identity, zero biases; made on ``device`` with a generator there."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, L = cfg.n_embd, cfg.n_layer
    std, pstd = 0.02, 0.02 / np.sqrt(2 * L)
    normal = lambda s, *shape: (torch.randn(shape, generator=gen, device=device) * s).to(dtype)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    blocks = {
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "attn_w": normal(std, L, D, 3 * D), "attn_b": zeros(L, 3 * D),
        "attn_proj_w": normal(pstd, L, D, D), "attn_proj_b": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "fc_w": normal(std, L, D, 4 * D), "fc_b": zeros(L, 4 * D),
        "proj_w": normal(pstd, L, 4 * D, D), "proj_b": zeros(L, D),
    }
    return {"wte": normal(std, cfg.vocab_size, D), "wpe": normal(std, cfg.n_positions, D), "blocks": blocks,
            "lnf_w": ones(D), "lnf_b": zeros(D)}


def _layer(blocks, i):
    return {k: v[i] for k, v in blocks.items()}


def _attention(x, bp, cfg: GPT2Config, bias, cache=None, index: int = 0):
    """Causal self-attention of ``x [B, T, D]``. With ``cache`` = (k, v)
    ``[B, H, S, hd]`` the new keys and values are written at slots
    ``index .. index + T`` and the queries attend over slots ``0 .. index + T``
    (``bias``, None for none, covers them)."""
    B, T, D = x.shape
    H = cfg.n_head
    hd = D // H
    qkv = x @ bp["attn_w"] + bp["attn_b"]
    split = lambda t: t.reshape(B, T, H, hd).transpose(1, 2)
    q, k, v = (split(t) for t in qkv.split(D, dim=-1))
    if cache is not None:
        ck, cv = cache
        ck[:, :, index : index + T] = k
        cv[:, :, index : index + T] = v
        k, v = ck[:, :, : index + T], cv[:, :, : index + T]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / np.sqrt(hd)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype).transpose(1, 2).reshape(B, T, D)
    return out @ bp["attn_proj_w"] + bp["attn_proj_b"]


def _block(x, bp, cfg: GPT2Config, bias, cache=None, index: int = 0):
    x = x + _attention(layer_norm(x, bp["ln1_w"], bp["ln1_b"], eps=cfg.ln_eps), bp, cfg, bias, cache, index)
    h = layer_norm(x, bp["ln2_w"], bp["ln2_b"], eps=cfg.ln_eps)
    return x + gelu_new(h @ bp["fc_w"] + bp["fc_b"]) @ bp["proj_w"] + bp["proj_b"]


def _token_rows(params, tokens):
    wte = params["wte"]
    return wte[tokens.clamp(max=wte.shape[0] - 1)]


def _logits(params, cfg: GPT2Config, x):
    """Final LayerNorm and the tied LM head -> fp32 logits."""
    x = layer_norm(x, params["lnf_w"], params["lnf_b"], eps=cfg.ln_eps)
    return x.float() @ params["wte"].float().T


def _causal(T, device):
    return torch.full((T, T), NEG_INF, device=device).triu(1)


def forward(params, cfg: GPT2Config, tokens=None, prefix_embeds=None, attention_mask=None):
    """LM logits [B, T, V] (fp32) over (prefix ++ tokens). ``attention_mask``
    [B, T] (1 = attend) adds -1e9 on the masked keys to the causal bias, as
    HF does; positions stay sequential whatever the mask."""
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(params["wte"].dtype))
    if tokens is not None:
        parts.append(_token_rows(params, tokens))
    x = torch.cat(parts, dim=1)
    T = x.shape[1]
    x = x + params["wpe"][:T]
    bias = _causal(T, x.device)[None, None]
    if attention_mask is not None:
        bias = bias + (1.0 - attention_mask[:, None, None, :].float()) * NEG_INF
    for i in range(cfg.n_layer):
        x = _block(x, _layer(params["blocks"], i), cfg, bias)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Cached decoding
# ---------------------------------------------------------------------------


def _prefill(params, cfg: GPT2Config, embeds, max_len: int):
    """Run the prompt embeddings ``[B, P, D]`` -> (last position's logits
    [B, V], cache {"k", "v": [L, B, H, max_len, hd], "index": P})."""
    B, P, D = embeds.shape
    shape = (cfg.n_layer, B, cfg.n_head, max_len, D // cfg.n_head)
    dt = params["wte"].dtype
    ks, vs = torch.zeros(shape, dtype=dt, device=embeds.device), torch.zeros(shape, dtype=dt, device=embeds.device)
    x = embeds.to(dt) + params["wpe"][:P]
    bias = _causal(P, x.device)[None, None]
    for i in range(cfg.n_layer):
        x = _block(x, _layer(params["blocks"], i), cfg, bias, (ks[i], vs[i]), 0)
    return _logits(params, cfg, x[:, -1]), {"k": ks, "v": vs, "index": P}


def _decode_step(params, cfg: GPT2Config, cache, token_embeds):
    """One decode step from ``[B, 1, D]`` new-position embeddings: writes the
    cache at its index in place and advances it -> logits [B, V]."""
    idx = cache["index"]
    wpe = params["wpe"]   # a position past the table reads its last row, as JAX's dynamic slice clamps it
    x = token_embeds.to(params["wte"].dtype) + wpe[min(idx, wpe.shape[0] - 1)]
    for i in range(cfg.n_layer):   # the one new query attends to every slot written: no bias
        x = _block(x, _layer(params["blocks"], i), cfg, None, (cache["k"][i], cache["v"][i]), idx)
    cache["index"] = idx + 1
    return _logits(params, cfg, x[:, 0])


# ---------------------------------------------------------------------------
# ClipCap generation loops (`caption/image_llm/generate.py`)
# ---------------------------------------------------------------------------


@torch.no_grad()
def clipcap_beam_generate(params, cfg: GPT2Config, prefix_embeds, stop_token: int, beam_size: int = 5,
                          entry_length: int = 67, temperature: float = 1.0):
    """Length-normalised beam search over inputs_embeds, ``generate_beam``
    (`generate.py:9-84`) as the JAX package runs it: beams re-ranked every
    step by score / length (ties by the lower flat index, as ``lax.top_k``),
    a stopped beam's score frozen through column 0 (its other candidates
    exact -1e9 ties), the early exit once every beam stopped, the outputs
    ordered by a stable argsort of -score / length.

    prefix_embeds: [P, D] (one image) -> (tokens [beam, entry_length] int64,
    lengths [beam] int64, order [beam]); the best caption is row
    ``order[0]`` up to ``lengths[order[0]]``."""
    P = prefix_embeds.shape[0]
    temp = temperature if temperature > 0 else 1.0
    dev = prefix_embeds.device
    logits0, cache = _prefill(params, cfg, prefix_embeds[None], P + entry_length)
    logp0 = torch.log_softmax(logits0[0] / temp, dim=-1)
    first = top_k_indices(logp0, beam_size)
    scores = logp0[first]
    cache["k"] = cache["k"].repeat_interleave(beam_size, dim=1)
    cache["v"] = cache["v"].repeat_interleave(beam_size, dim=1)
    tokens = torch.zeros((beam_size, entry_length), dtype=torch.long, device=dev)
    tokens[:, 0] = first
    seq_lengths = torch.ones(beam_size, device=dev)
    is_stopped = first == stop_token
    i = 1
    while i < entry_length and not bool(is_stopped.all()):   # a host sync each token
        logits = _decode_step(params, cfg, cache, params["wte"][tokens[:, i - 1]][:, None, :])
        logp = torch.log_softmax(logits / temp, dim=-1)
        logp = torch.where(is_stopped[:, None], NEG_INF, logp)
        logp[:, 0] = torch.where(is_stopped, 0.0, logp[:, 0])
        scores_sum = scores[:, None] + logp
        seq_lengths = seq_lengths + (~is_stopped).float()
        avg = (scores_sum / seq_lengths[:, None]).reshape(-1)
        flat = top_k_indices(avg, beam_size)
        src, nxt = flat // logp.shape[-1], flat % logp.shape[-1]
        seq_lengths = seq_lengths[src]
        tokens = tokens[src]
        tokens[:, i] = nxt
        scores = avg[flat] * seq_lengths
        is_stopped = is_stopped[src] | (nxt == stop_token)
        n = cache["index"]
        cache["k"][:, :, :, :n] = cache["k"][:, src, :, :n]
        cache["v"][:, :, :, :n] = cache["v"][:, src, :, :n]
        i += 1
    order = torch.sort(-(scores / seq_lengths), stable=True).indices
    return tokens, seq_lengths.long(), order


@torch.no_grad()
def clipcap_top_p_generate(params, cfg: GPT2Config, prefix_embeds, stop_token: int, entry_length: int = 67,
                           temperature: float = 1.0, alt_stop_token: int = 764):
    """Greedy decoding over nucleus-filtered logits, ``generate2``
    (`generate.py:87-145`) as the JAX package runs it: the filter never
    removes the most probable token, so each step is the argmax of the
    temperature-scaled logits, and the reference's ``top_p`` has no part
    here. Stops after writing ``stop_token`` or ``alt_stop_token`` (764,
    GPT-2's ' .').

    prefix_embeds: [P, D] -> (tokens [entry_length] int64, length): the
    caption is ``tokens[:length]``, the stop token included."""
    P = prefix_embeds.shape[0]
    temp = temperature if temperature > 0 else 1.0
    logits0, cache = _prefill(params, cfg, prefix_embeds[None], P + entry_length)
    tokens = torch.zeros(entry_length, dtype=torch.long, device=prefix_embeds.device)
    tokens[0] = torch.argmax(logits0[0] / temp)
    is_stop = lambda t: (t == stop_token) | (t == alt_stop_token)
    stopped = is_stop(tokens[0])
    i = 1
    # each step runs only while nothing has stopped, so it writes its token (the
    # stop token too, which the reference appends before it breaks): the JAX
    # package's "wrote" count, from the flag before the step
    while i < entry_length and not bool(stopped):
        logits = _decode_step(params, cfg, cache, params["wte"][tokens[i - 1]][None, None, :])
        tokens[i] = torch.argmax(logits[0] / temp)
        stopped = is_stop(tokens[i])
        i += 1
    return tokens, i


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


def convert_gpt2_state_dict(sd: dict, n_head: Optional[int] = None, dtype=torch.float32, device="cpu"):
    """HF ``GPT2LMHeadModel`` state dict (torch tensors or numpy arrays) ->
    (params, config). HF Conv1D weights are already ``[in, out]``: no
    transpose. The head count is not in the state dict: inferred from the
    width for the released sizes (else width // 64); ``n_head`` overrides it."""

    def get(k):
        x = sd[k]
        x = x.detach().cpu().float() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
        return x.to(device=device, dtype=dtype)

    pref = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    L = len({int(m.group(1)) for k in sd if (m := re.search(r"\bh\.(\d+)\.", k))})
    stack = lambda name: torch.stack([get(f"{pref}h.{i}.{name}") for i in range(L)])
    blocks = {
        "ln1_w": stack("ln_1.weight"), "ln1_b": stack("ln_1.bias"),
        "attn_w": stack("attn.c_attn.weight"), "attn_b": stack("attn.c_attn.bias"),
        "attn_proj_w": stack("attn.c_proj.weight"), "attn_proj_b": stack("attn.c_proj.bias"),
        "ln2_w": stack("ln_2.weight"), "ln2_b": stack("ln_2.bias"),
        "fc_w": stack("mlp.c_fc.weight"), "fc_b": stack("mlp.c_fc.bias"),
        "proj_w": stack("mlp.c_proj.weight"), "proj_b": stack("mlp.c_proj.bias"),
    }
    params = {"wte": get(f"{pref}wte.weight"), "wpe": get(f"{pref}wpe.weight"), "blocks": blocks,
              "lnf_w": get(f"{pref}ln_f.weight"), "lnf_b": get(f"{pref}ln_f.bias")}
    V, D = params["wte"].shape
    heads = n_head or {768: 12, 1024: 16, 1280: 20, 1600: 25}.get(D, max(1, D // 64))
    cfg = GPT2Config(name=f"gpt2-converted-{D}", vocab_size=V, n_positions=params["wpe"].shape[0], n_embd=D,
                     n_layer=L, n_head=heads)
    return params, cfg
