"""CoOp-style learnable prompt state as embedding surgery (the counterpart
of ``rlcf_tpu/core/prompt.py``).

Prompt assembly is one static-shaped expression:

    prompts[c, t] = fixed_embed[c, t]        where ctx_map[c, t] < 0
                    ctx[ctx_map[c, t]]       where ctx_map[c, t] >= 0

so gradients reach only ``ctx``. ``ctx`` may carry leading batch axes (one
context per episode), which then lead the prompts too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..tokenizer import get_tokenizer, tokenize


@dataclasses.dataclass
class PromptState:
    """Tensors describing the prompt template for one class set."""

    ctx0: torch.Tensor         # [n_ctx, D] initial context vectors
    fixed_embed: torch.Tensor  # [C, T, D] embeddings, zeroed at ctx positions
    ctx_map: torch.Tensor      # [C, T] int64: ctx index or -1
    eot_idx: torch.Tensor      # [C] pooling positions (argmax of token ids)
    tokenized: np.ndarray      # [C, 77] token ids (reward model re-tokenization)

    @property
    def n_cls(self) -> int:
        return self.fixed_embed.shape[0]

    @property
    def n_ctx(self) -> int:
        return self.ctx0.shape[0]


def splice_arrays(ctx, fixed_embed, ctx_map):
    """[..., n_ctx, D] contexts -> [..., C, T, D] prompt embeddings."""
    onehot = (ctx_map[..., None] == torch.arange(ctx.shape[-2], device=ctx.device)).float()  # [C, T, n]
    spliced = torch.einsum("ctn,...nd->...ctd", onehot, ctx.float()).to(ctx.dtype)
    return fixed_embed.to(ctx.dtype) + spliced


def init_ctx_from_words(clip_params, ctx_init: str):
    """Context vectors from a word phrase (`custom_clip.py:90-107`)."""
    phrase = ctx_init.replace("_", " ").replace("[CLS] ", "")
    tokens = tokenize(phrase)[0]
    n_ctx = int((tokens > 0).sum()) - 2  # minus SOT/EOT
    emb = clip_params["text"]["token_embedding"]
    idx = torch.as_tensor(tokens[1 : 1 + n_ctx].astype(np.int64), device=emb.device)
    return emb[idx].clone(), phrase, n_ctx


def build_prompt_state(
    clip_params,
    classnames: Sequence[str],
    ctx_init: Optional[str] = "a photo of a",
    n_ctx: int = 4,
    ctx0: Optional[torch.Tensor] = None,
    rng: Optional[np.random.Generator] = None,
) -> PromptState:
    """Host-side prompt-template construction for a class set, context at
    the end of the template (CoOp's "end" position).

    ``ctx0`` overrides the initial context (e.g. loaded CoOp weights);
    otherwise it is word-initialized from ``ctx_init`` or drawn at random
    (std 0.02) from ``rng``.
    """
    tok = get_tokenizer()
    token_embedding = clip_params["text"]["token_embedding"]
    device = token_embedding.device
    if ctx_init and "[CLS]" in ctx_init:
        raise NotImplementedError("middle/front class-token positions are not ported yet")
    if ctx_init:
        if ctx0 is None:
            ctx0, prompt_prefix, n_ctx = init_ctx_from_words(clip_params, ctx_init)
        else:
            prompt_prefix = ctx_init.replace("_", " ")
            n_ctx = ctx0.shape[0]
    else:
        if ctx0 is None:
            rng = rng or np.random.default_rng(0)
            ctx0 = torch.from_numpy(rng.normal(0.0, 0.02, size=(n_ctx, token_embedding.shape[1])).astype(np.float32))
        else:
            n_ctx = ctx0.shape[0]
        prompt_prefix = " ".join(["X"] * n_ctx)

    classnames = [name.replace("_", " ") for name in classnames]
    tokenized = tokenize([f"{prompt_prefix} {name}." for name in classnames])  # [C, 77]
    C, T = tokenized.shape
    ctx_map = np.full((C, T), -1, dtype=np.int64)
    ctx_map[:, 1 : 1 + n_ctx] = np.arange(n_ctx)
    tok_t = torch.as_tensor(tokenized.astype(np.int64), device=device)
    fixed = token_embedding[tok_t].clone()  # [C, 77, D]
    ctx_map_t = torch.as_tensor(ctx_map, device=device)
    fixed[ctx_map_t >= 0] = 0.0

    eot = tokenized.argmax(axis=-1)
    # causal attention + EOT pooling make positions past max(eot) dead
    # compute: keep max(eot)+1 positions, padded to a multiple of 8 (exact)
    t_max = min(T, int(-(-(int(eot.max()) + 1) // 8) * 8))
    return PromptState(
        ctx0=torch.as_tensor(ctx0).to(device),
        fixed_embed=fixed[:, :t_max].contiguous(),
        ctx_map=ctx_map_t[:, :t_max].contiguous(),
        eot_idx=torch.as_tensor(eot.astype(np.int64), device=device),
        tokenized=tokenized,
    )


def load_coop_ctx(path: str) -> torch.Tensor:
    """Pretrained CoOp context vectors from a torch checkpoint
    (`TPT/tpt_cls_rl.py:95-101`)."""
    from ..models.convert import load_torch_file

    sd = load_torch_file(path)
    for key in ("ctx", "state_dict.ctx", "prompt_learner.ctx"):
        if key in sd:
            return sd[key]
    raise KeyError(f"no ctx tensor found in {path}; keys: {list(sd)[:10]}")
