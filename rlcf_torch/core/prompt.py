"""CoOp-style learnable prompt state as embedding surgery (the counterpart
of ``rlcf_tpu/core/prompt.py``).

Prompt assembly is one static-shaped expression:

    prompts[c, t] = fixed_embed[c, t]        where ctx_map[c, t] < 0
                    ctx[ctx_map[c, t]]       where ctx_map[c, t] >= 0
                    (+ cls[c] where cls_mask[c, t], with a learnable class token)

which covers the three class-token positions (end, middle, front); gradients
reach only ``ctx`` (and ``cls``). ``ctx`` and ``cls`` may carry leading batch
axes (one context per episode), which then lead the prompts too.
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
    fixed_embed: torch.Tensor  # [C, T, D] embeddings, zeroed at ctx (and class-token) positions
    ctx_map: torch.Tensor      # [C, T] int64: ctx index or -1
    eot_idx: torch.Tensor      # [C] pooling positions (argmax of token ids)
    tokenized: np.ndarray      # [C, 77] token ids (reward model re-tokenization)
    cls0: Optional[torch.Tensor] = None      # [C, D] learnable class token init
    cls_mask: Optional[torch.Tensor] = None  # [C, T] 1.0 at the class-token slot

    @property
    def n_cls(self) -> int:
        return self.fixed_embed.shape[0]

    @property
    def n_ctx(self) -> int:
        return self.ctx0.shape[0]


def splice_arrays(ctx, fixed_embed, ctx_map, cls=None, cls_mask=None):
    """[..., n_ctx, D] contexts (and [..., C, D] class tokens at ``cls_mask``)
    -> [..., C, T, D] prompt embeddings. The class token's term promotes as
    JAX's does: an fp32 ``cls`` makes the prompts fp32."""
    onehot = (ctx_map[..., None] == torch.arange(ctx.shape[-2], device=ctx.device)).float()  # [C, T, n]
    spliced = torch.einsum("ctn,...nd->...ctd", onehot, ctx.float()).to(ctx.dtype)
    prompts = fixed_embed.to(ctx.dtype) + spliced
    if cls is not None:
        prompts = prompts + cls[..., None, :] * cls_mask[..., None].to(ctx.dtype)
    return prompts


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
    ctx_position: str = "end",
    ctx0: Optional[torch.Tensor] = None,
    learned_cls: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> PromptState:
    """Host-side prompt-template construction for a class set.

    ``ctx0`` overrides the initial context (e.g. loaded CoOp weights);
    otherwise it is word-initialized from ``ctx_init`` or drawn at random
    (std 0.02) from ``rng``. A ``[CLS]`` word in ``ctx_init`` puts the class
    name there ("middle"); ``ctx_position`` "front" puts it first; without
    either the name follows the context ("end"). ``learned_cls`` (the
    Bongard mode, "end" only) gives every class the prompt "<ctx> X." with a
    learnable token in place of the X, drawn (std 0.02) after the context
    from the same ``rng``, as the JAX package draws it.
    """
    tok = get_tokenizer()
    token_embedding = clip_params["text"]["token_embedding"]
    device = token_embedding.device
    ctx_dim = token_embedding.shape[1]

    split_idx = None
    if ctx_init:
        if "[CLS]" in ctx_init:
            ctx_position = "middle"
            split_idx = ctx_init.replace("_", " ").split(" ").index("[CLS]")
        if ctx0 is None:
            ctx0, prompt_prefix, n_ctx = init_ctx_from_words(clip_params, ctx_init)
        else:
            prompt_prefix = ctx_init.replace("_", " ").replace("[CLS] ", "")
            n_ctx = ctx0.shape[0]
    else:
        if ctx0 is None:
            rng = rng or np.random.default_rng(0)
            ctx0 = torch.from_numpy(rng.normal(0.0, 0.02, size=(n_ctx, ctx_dim)).astype(np.float32))
        else:
            n_ctx = ctx0.shape[0]  # provided weights define the slot count
        prompt_prefix = " ".join(["X"] * n_ctx)

    if learned_cls and ctx_position != "end":
        # the reference wires the learnable class token into the "end" layout
        # only (`custom_clip.py:239-260`); elsewhere it would be dropped silently
        raise ValueError("learned_cls requires ctx_position='end'")

    classnames = [name.replace("_", " ") for name in classnames]
    if learned_cls:
        name_lens = [1] * len(classnames)
        prompts = [f"{prompt_prefix} X." for _ in classnames]
    else:
        name_lens = [len(tok.encode(name)) for name in classnames]
        prompts = [f"{prompt_prefix} {name}." for name in classnames]
    tokenized = tokenize(prompts)  # [C, 77]
    C, T = tokenized.shape

    # src[c, t]: the position of the prefix-first tokenization whose embedding
    # lands at t (-1: none). Middle and front move the embedding slices of
    # that one tokenization into place, as the reference does
    # (`custom_clip.py:239-284`), without tokenizing again.
    ctx_map = np.full((C, T), -1, dtype=np.int64)
    cls_mask = np.zeros((C, T), dtype=np.float32)
    src = np.tile(np.arange(T), (C, 1))
    pos = np.arange(T)
    for c in range(C):
        nl = name_lens[c]
        if ctx_position == "end":
            ctx_map[c, 1 : 1 + n_ctx] = np.arange(n_ctx)
            if learned_cls:
                cls_mask[c, 1 + n_ctx] = 1.0
        elif ctx_position == "middle":
            half = split_idx if split_idx is not None else n_ctx // 2
            # layout: SOT, ctx[:half], name, ctx[half:], rest
            ctx_map[c, 1 : 1 + half] = np.arange(half)
            start2 = 1 + half + nl
            ctx_map[c, start2 : start2 + (n_ctx - half)] = np.arange(half, n_ctx)
            src[c] = -1
            src[c, 0] = 0
            src[c, 1 + half : 1 + half + nl] = pos[1 + n_ctx : 1 + n_ctx + nl]
            rest = pos[1 + n_ctx + nl :]
            src[c, 1 + half + nl + (n_ctx - half) :] = rest[: T - (1 + half + nl + (n_ctx - half))]
        elif ctx_position == "front":
            # layout: SOT, name, ctx, rest
            ctx_map[c, 1 + nl : 1 + nl + n_ctx] = np.arange(n_ctx)
            src[c] = -1
            src[c, 0] = 0
            src[c, 1 : 1 + nl] = pos[1 + n_ctx : 1 + n_ctx + nl]
            rest = pos[1 + n_ctx + nl :]
            src[c, 1 + nl + n_ctx :] = rest[: T - (1 + nl + n_ctx)]
        else:
            raise ValueError(ctx_position)
    dead = (src < 0) | (ctx_map >= 0) | (cls_mask > 0)
    ids = np.take_along_axis(tokenized, np.maximum(src, 0), axis=1).astype(np.int64)
    fixed = token_embedding[torch.as_tensor(ids, device=device)]  # [C, 77, D]
    fixed[torch.as_tensor(dead, device=device)] = 0.0

    cls0 = None
    if learned_cls:
        rng = rng or np.random.default_rng(0)
        cls0 = torch.from_numpy(rng.normal(0.0, 0.02, size=(C, ctx_dim)).astype(np.float32)).to(device)

    eot = tokenized.argmax(axis=-1)
    # causal attention + EOT pooling make positions past max(eot) dead
    # compute: keep max(eot)+1 positions, padded to a multiple of 8 (exact)
    t_max = min(T, int(-(-(int(eot.max()) + 1) // 8) * 8))
    return PromptState(
        ctx0=torch.as_tensor(ctx0).to(device),
        fixed_embed=fixed[:, :t_max].contiguous(),
        ctx_map=torch.as_tensor(ctx_map[:, :t_max], device=device).contiguous(),
        eot_idx=torch.as_tensor(eot.astype(np.int64), device=device),
        tokenized=tokenized,
        cls0=cls0,
        cls_mask=torch.as_tensor(cls_mask[:, :t_max], device=device) if learned_cls else None,
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
