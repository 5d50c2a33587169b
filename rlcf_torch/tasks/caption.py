"""Captioning: the ClipCap/CapDec model, its supervised trainer, caption TTA
with a CLIP reward, the legacy GPT-2 ClipCap predictor and CLIP feature
extraction (the counterpart of ``rlcf_tpu/tasks/caption.py``).

- Model (`caption/image_llm/models/modules.py:212-268`): a prefix mapper
  projects a CLIP embedding to ``prefix_length`` LLM token embeddings, which
  condition a frozen OPT (or GPT-2) decoder; only the mapper trains.
- Supervised trainer (`caption/train.py:18-76`): teacher-forcing CE on
  precomputed CLIP embeddings; CapDec adds Gaussian noise to the text
  embedding (`caption/image_llm/utils.py:24-41`); a linear warm-up then
  linear decay; the loss slice ``logits[:, P-1:-1]`` with ignore_index 0.
- TTA (`caption/capdec_tta.py:49-156`): per image, ``tta_steps`` of {beam-
  sample K captions, CLIPScore them against the image, baseline-subtract,
  reward-weighted teacher-forcing CE on the sampled tokens}; then a final
  beam-5 caption. Generation and reward need a host round trip (OPT ids ->
  text -> CLIP BPE) between the device stages.

A group of N images adapts N mappers at once: each mapper leaf carries a
leading image axis (``models/mappers.py``), the loss is the SUM of the N
per-image losses and one AdamW steps them all, which is N independent
``optax.adamw`` steps (``core/episode.py``); the JAX package vmaps the
per-image states instead.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import policy as Po
from ..core.episode import EpisodeConfig, make_optimizer
from ..core.losses import clipscore, rewards_post_process
from ..core.reward import reward_image_features
from ..models import clip as clip_model
from ..models import gpt2 as G
from ..models import mappers as M
from ..models import opt as O
from ..parallel.mesh import dp_gather, dp_slice
from ..tokenizer import tokenize as clip_tokenize


@dataclasses.dataclass(frozen=True)
class CaptionModelConfig:
    """Mapper + frozen LLM. ``llm`` names the backend as the reference's
    ``LLMModel(config_dir)`` dispatch does (`modules.py:188-209`): "opt"
    (the RLCF TTA path, ``opt``) or "gpt2" (the legacy ClipCap path,
    ``gpt2`` a ``models.gpt2.GPT2Config``)."""

    mapper: M.MapperConfig
    opt: Optional[O.OPTConfig] = None
    normalize_prefix: bool = False
    llm: str = "opt"
    gpt2: Optional[G.GPT2Config] = None

    @property
    def prefix_length(self) -> int:
        return self.mapper.prefix_length

    @property
    def llm_key(self) -> str:
        """The LLM's key in the parameter dict ("opt" or "gpt2")."""
        return "gpt2" if self.llm == "gpt2" else "opt"


def llm_forward(llm_params, ccfg: CaptionModelConfig, tokens=None, prefix_embeds=None, attention_mask=None):
    """The frozen LLM's teacher-forcing forward on the configured backend."""
    if ccfg.llm == "gpt2":
        return G.forward(llm_params, ccfg.gpt2, tokens=tokens, prefix_embeds=prefix_embeds,
                         attention_mask=attention_mask)
    return O.forward(llm_params, ccfg.opt, tokens=tokens, prefix_embeds=prefix_embeds, attention_mask=attention_mask)


def init_caption_params(seed: int, ccfg: CaptionModelConfig, dtype=torch.float32, device="cpu"):
    """Random mapper (from ``seed``) and LLM (from ``seed + 1``) parameters."""
    out = {"mapper": M.init_mapper_params(ccfg.mapper, seed, dtype, device)}
    if ccfg.llm == "gpt2":
        out["gpt2"] = G.init_gpt2_params(seed + 1, ccfg.gpt2, dtype, device)
    else:
        out["opt"] = O.init_opt_params(seed + 1, ccfg.opt, dtype, device)
    return out


def prefix_tokens(mapper_params, ccfg: CaptionModelConfig, clip_emb):
    """CLIP embedding [B, E] -> prefix embeddings [B, P, D] (per-episode
    mappers: [N, B, E] -> [N, B, P, D])."""
    return M.mapper_forward(mapper_params, ccfg.mapper, clip_emb)


def caption_forward(params, ccfg: CaptionModelConfig, clip_emb, tokens, attention_mask=None):
    """Teacher-forcing logits [B, P+T, V] (`modules.py:239-252`)."""
    return llm_forward(params[ccfg.llm_key], ccfg, tokens=tokens,
                       prefix_embeds=prefix_tokens(params["mapper"], ccfg, clip_emb), attention_mask=attention_mask)


def caption_ce(logits, tokens, prefix_length: int, ignore_id: int = 0, per_sample: bool = False, valid_mask=None):
    """CE over ``logits[..., P-1:-1, :]`` against ``tokens [..., T]``,
    ignore_index 0 (`caption/train.py:46-47`, `capdec_tta.py:120-123`).

    ``per_sample`` (the TTA path): one loss per caption. The reference pads
    an image's K captions to their longest (``padding=True``) and means over
    that length, so pad-id-1 targets inside it count (ignore_index is 0, OPT
    pads with 1) and the divisor is the longest length; ``valid_mask`` (the
    captions' token masks ``[..., K, T]``) recovers that from any longer pad:
    positions past the image's longest caption drop out and the mean divides
    by that length, the longest taken over the K captions of each leading
    index. A target id past the vocabulary gives NaN, as the JAX package's
    ``take_along_axis`` fills it, and no gradient.
    """
    V = logits.shape[-1]
    logp = F.log_softmax(logits[..., prefix_length - 1 : -1, :].float(), dim=-1)
    tokens = tokens.long()
    ce = -torch.gather(logp, -1, tokens.clamp(max=V - 1)[..., None])[..., 0]
    ce = torch.where(tokens < V, ce, float("nan"))
    keep = (tokens != ignore_id).float()
    if not per_sample:
        return (ce * keep).sum() / keep.sum().clamp(min=1.0)
    if valid_mask is None:
        return (ce * keep).sum(dim=-1) / ce.shape[-1]
    l_eff = valid_mask.sum(dim=-1).amax(dim=-1, keepdim=True).clamp(min=1).float()
    in_batch = (torch.arange(tokens.shape[-1], device=tokens.device) < l_eff[..., None]).float()
    return (ce * keep * in_batch).sum(dim=-1) / l_eff


def noise_injection(x, noise, variance: float = 0.016, dont_norm: bool = False):
    """CapDec Gaussian noise on the CLIP text embedding (`utils.py:24-41`):
    ``noise`` holds standard normal draws of ``x``'s shape, scaled here by
    sqrt(variance); a variance <= 0 returns ``x`` untouched."""
    if variance <= 0:
        return x
    if not dont_norm:
        x = clip_model.normalize(x)
    return clip_model.normalize(x + noise * np.sqrt(variance))


# ---------------------------------------------------------------------------
# Supervised trainer (ClipCap / CapDec)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainConfig:
    lr: float = 2e-5
    warmup_steps: int = 5000
    total_steps: int = 100_000
    epochs: int = 10
    batch_size: int = 40
    cap_model: str = "CapDec"  # CapDec => noise injection on text embeddings
    noise_variance: float = 0.016
    normalize_prefix: bool = False


def train_lr(tcfg: TrainConfig, step: int) -> float:
    """The learning rate of update ``step`` (0 first): a linear warm-up then
    a linear decay to 0 at ``total_steps`` (HF
    ``get_linear_schedule_with_warmup``, `caption/train.py:96-101`), in fp32
    as the JAX package computes it."""
    f32 = np.float32
    if step < tcfg.warmup_steps:
        frac = f32(step) / f32(max(tcfg.warmup_steps, 1))
    else:
        frac = max(f32(0.0), f32(tcfg.total_steps - step) / f32(max(tcfg.total_steps - tcfg.warmup_steps, 1)))
    return float(f32(tcfg.lr) * f32(frac))


def make_caption_trainer(ccfg: CaptionModelConfig, tcfg: TrainConfig):
    """-> (init_opt, train_step).

    ``init_opt(mapper)``: AdamW over the mapper's leaves (tensors that
    require grad), eps 1e-6, weight decay 0 (`caption/train.py:96`).
    ``train_step(mapper, llm_params, opt, prefix, tokens, mask, noise=None)``
    -> the loss (detached); the mapper steps in place. Only the mapper
    trains (`ClipCaptionPrefixV2.parameters()`, `modules.py:255-258`).
    CapDec takes ``noise``, standard normal draws of ``prefix``'s shape,
    from the caller (``train_caption_model`` draws them from a torch
    generator: the JAX package's recipe, not its draws). The schedule is
    evaluated at the count of updates before this one, as optax counts, so
    the first update's rate is ``train_lr(tcfg, 0)``.

    The JAX package's quirks are kept: CapDec's noise injection skips its
    normalisation under ``normalize_prefix`` (``dont_norm``), and ClipCap
    normalises the prefix under it.
    """

    def init_opt(mapper):
        opt = torch.optim.AdamW(Po.tree_leaves(mapper), lr=train_lr(tcfg, 0), betas=(0.9, 0.999), eps=1e-6,
                                weight_decay=0.0)
        opt.param_groups[0]["updates"] = 0
        return opt

    def train_step(mapper, llm_params, opt, prefix, tokens, mask, noise=None):
        if tcfg.cap_model == "CapDec":
            prefix = noise_injection(prefix, noise, tcfg.noise_variance, dont_norm=tcfg.normalize_prefix)
        elif tcfg.normalize_prefix:
            prefix = clip_model.normalize(prefix)
        group = opt.param_groups[0]
        group["lr"] = train_lr(tcfg, group["updates"])
        group["updates"] += 1
        opt.zero_grad(set_to_none=True)
        logits = llm_forward(llm_params, ccfg, tokens=tokens, prefix_embeds=prefix_tokens(mapper, ccfg, prefix),
                             attention_mask=mask)
        loss = caption_ce(logits, tokens, ccfg.prefix_length)
        loss.backward()
        opt.step()
        return loss.detach()

    return init_opt, train_step


def train_caption_model(params, ccfg: CaptionModelConfig, tcfg: TrainConfig, dataset_iter_fn: Callable[[], object],
                        generator: Optional[torch.Generator] = None, checkpoint_dir: Optional[str] = None,
                        start_epoch: int = 0):
    """The epoch loop over an iterator factory yielding numpy (prefix,
    tokens, mask) batches -> (params with the trained mapper, each epoch's
    mean loss). CapDec's noise comes from ``generator`` (a torch generator on
    the mapper's device; seed 0 when None). Writes ``ckpt-latest.npz``
    every epoch and ``ckpt-{epoch:03d}.npz`` for the last six, as
    `caption/train.py:62-71`. The losses reach the host once an epoch."""
    dev = Po.tree_leaves(params["mapper"])[0].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    noisy = tcfg.cap_model == "CapDec" and tcfg.noise_variance > 0
    init_opt, train_step = make_caption_trainer(ccfg, tcfg)
    mapper = Po.tree_map(lambda a: a.detach().clone().requires_grad_(True), params["mapper"])
    opt = init_opt(mapper)
    losses = []
    for epoch in range(start_epoch, tcfg.epochs):
        step_losses = []
        for prefix, tokens, mask in dataset_iter_fn():
            prefix = torch.as_tensor(np.asarray(prefix, np.float32), device=dev)
            noise = torch.randn(prefix.shape, generator=generator, device=dev) if noisy else None
            step_losses.append(train_step(mapper, params[ccfg.llm_key], opt, prefix,
                                          torch.as_tensor(np.asarray(tokens, np.int64), device=dev),
                                          torch.as_tensor(np.asarray(mask, np.int64), device=dev), noise))
        total = sum(torch.stack(step_losses).tolist()) if step_losses else 0.0
        losses.append(total / max(len(step_losses), 1))
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_mapper_checkpoint(os.path.join(checkpoint_dir, "ckpt-latest.npz"), mapper, epoch)
            if epoch >= tcfg.epochs - 6:
                save_mapper_checkpoint(os.path.join(checkpoint_dir, f"ckpt-{epoch:03d}.npz"), mapper, epoch)
    return {**params, "mapper": Po.tree_map(lambda a: a.detach(), mapper)}, losses


def save_mapper_checkpoint(path: str, mapper_params, epoch: int):
    """The JAX package's ``.npz`` layout: one array a leaf under its path
    (``layers/0/q/w``) and ``__epoch__``; either package reads the other's file."""
    names = Po.tree_leaves(Po._paths(mapper_params))
    np.savez(path, __epoch__=epoch,
             **{n: v.detach().cpu().float().numpy() for n, v in zip(names, Po.tree_leaves(mapper_params))})


def load_mapper_checkpoint(path: str, template):
    """Read a mapper ``.npz`` into ``template``'s structure, each leaf on its
    template's device and dtype -> (params, epoch)."""
    data = np.load(path)
    params = Po.tree_map(lambda v, name: torch.from_numpy(np.asarray(data[name])).to(device=v.device, dtype=v.dtype),
                         template, Po._paths(template))
    return params, int(data["__epoch__"])


class CaptionTTA:
    """Caption TTA with a frozen CLIP reward: the OPT and reward weights stay
    frozen, each image adapts its own copy of the mapper.

    ``mesh`` (``parallel/mesh.py``): each dp rank adapts the mappers of its
    slice of a group (its own optimizer states), and the captions, the trace
    and, under momentum, the adapted mappers are gathered in image order;
    the decode takes the OPT weights split over tp (``parallel/tp_opt.py``).
    """

    def __init__(self, params, ccfg: CaptionModelConfig, reward, opt_tokenizer, tta_steps: int = 4,
                 lr: float = 3e-6, weight_decay: float = 5e-4, sample_k: int = 6, max_new_tokens: int = 50,
                 use_nucleus: bool = False, momentum_update: bool = False, update_freq: int = 256,
                 update_w: float = 1.0, momentum: float = 0.9999, token_pad_len: Optional[int] = None,
                 quantize_decode: bool = False, decode_seg_len: Optional[int] = None, seed: int = 0, mesh=None):
        if ccfg.llm != "opt":
            raise ValueError("CaptionTTA requires the OPT backend (the reference TTA path generates through "
                             "opt_generate, `capdec_tta.py:98-100`); use clipcap_predict for GPT-2 no-TTA captioning")
        self.params = params
        self.ccfg = ccfg
        self.reward = reward
        self.tok = opt_tokenizer
        self.tta_steps = tta_steps
        self.sample_k = sample_k
        self.max_new_tokens = max_new_tokens
        self.use_nucleus = use_nucleus
        self.decode_seg_len = decode_seg_len
        self.seed = seed
        self.device = params["opt"]["embed_positions"].device
        # Re-tokenized captions never truncate below what generation can emit
        # (the reference pads to longest, `capdec_tta.py:111`): an id whose
        # bytes are not valid UTF-8 decodes to U+FFFD, which re-encodes as 3
        # byte-tokens, so budget 4x the generated length (+BOS +slack);
        # _decode_and_retokenize warns if a caption would still truncate.
        self.token_pad_len = token_pad_len or (4 * max_new_tokens + 4)
        # the reference's AdamW eps=1e-6 (`capdec_tta.py:189`)
        self.ecfg = EpisodeConfig(lr=lr, weight_decay=weight_decay, adam_eps=1e-6)
        self.momentum_update = momentum_update
        self.momentum_cfg = dict(momentum=momentum, update_freq=update_freq, update_w=update_w)
        self.momentum_state = Po.MomentumState.create(params["mapper"]) if momentum_update else None
        self._sample_counter = 0
        # int8 weight-only decode: generation only; the update keeps full precision
        self.decode_params = O.quantize_opt_params(params["opt"]) if quantize_decode else params["opt"]
        self.mesh = mesh
        if mesh is not None and mesh.tp > 1:   # the Megatron split of the decode's weights
            from ..parallel.tp_opt import tp_opt_params

            self.decode_params = tp_opt_params(mesh, self.decode_params, ccfg.opt)
        self.reward_attn = clip_model.best_attn(reward.cfg, self.device)

    # -- device stages ----------------------------------------------------

    @torch.no_grad()
    def _prefixes(self, mappers, clip_embs):
        """Each image's prefix [N, P, D] under its own mapper."""
        return prefix_tokens(mappers, self.ccfg, clip_embs[:, None])[:, 0]

    def _generate_k(self, mappers, clip_embs, generator, rows=None):
        """K sampled captions per image -> OPT ids [N, K, L]; ``rows``: the
        nucleus sequences' place in the whole group (``nucleus_generate``)."""
        prefixes = self._prefixes(mappers, clip_embs)
        if self.use_nucleus:
            return O.nucleus_generate(self.decode_params, self.ccfg.opt, prefixes, generator,
                                      num_captions=self.sample_k, max_new_tokens=self.max_new_tokens, rows=rows,
                                      group=None if rows is None else self.mesh.dp_group)
        return O.beam_generate(self.decode_params, self.ccfg.opt, prefixes, num_beams=self.sample_k,
                               max_new_tokens=self.max_new_tokens, num_return=self.sample_k,
                               seg_len=self.decode_seg_len)[0]

    def _generate_final(self, mappers, clip_embs):
        """The final beam-5 caption's ids [N, L]."""
        seqs, _ = O.beam_generate(self.decode_params, self.ccfg.opt, self._prefixes(mappers, clip_embs),
                                  num_beams=5, max_new_tokens=self.max_new_tokens, num_return=1,
                                  seg_len=self.decode_seg_len)
        return seqs[:, 0]

    def reward_image_feats(self, images):
        """The frozen reward's normalized image features [N, E], once a group:
        the captions change every step, the images do not (the reference
        recomputes them each step through `get_clip_score`,
        `capdec_tta.py:104-110`; the features are the same)."""
        with torch.no_grad():
            return reward_image_features(self.reward.params, self.reward.cfg, images, self.reward_attn)

    @torch.no_grad()
    def _rewards(self, img_feats, clip_tokens):
        """CLIPScore of K captions an image against its image feature,
        baseline-subtracted per image: img_feats [N, E], clip_tokens [N, K, 77] -> [N, K]."""
        rcfg = self.reward.rcfg
        txt = self.reward.text_features(clip_tokens)                     # [N, K, E], normalized fp32
        scores = clipscore(torch.einsum("nke,ne->nk", txt, img_feats), rcfg.clipscore_weight)
        return rewards_post_process(scores, rcfg.reward_process, rcfg.amplify, batch_dims=1)

    def _update_step(self, opt, mappers, clip_embs, opt_tokens, attn_mask, rewards):
        """One AdamW step of every image's mapper on the reward-weighted CE of
        its K sampled captions (`capdec_tta.py:111-130`): opt_tokens [N, K, L],
        attn_mask [N, K, P+L], rewards [N, K] -> the N losses."""
        N, K, Lt = opt_tokens.shape
        P = self.ccfg.prefix_length
        opt.zero_grad(set_to_none=True)
        prefix = prefix_tokens(mappers, self.ccfg, clip_embs[:, None])          # [N, 1, P, D]: once an image
        prefix = prefix.expand(N, K, *prefix.shape[2:]).reshape(N * K, *prefix.shape[2:])
        logits = O.forward(self.params["opt"], self.ccfg.opt, tokens=opt_tokens.reshape(N * K, Lt),
                           prefix_embeds=prefix, attention_mask=attn_mask.reshape(N * K, -1))
        per_caption = caption_ce(logits.reshape(N, K, *logits.shape[1:]), opt_tokens, P, per_sample=True,
                                 valid_mask=attn_mask[..., P:])                  # [N, K]
        loss = (rewards * per_caption).mean(dim=-1)
        loss.sum().backward()
        opt.step()
        return loss.detach()

    # -- host round trip --------------------------------------------------

    def _decode_and_retokenize(self, seqs_np):
        """OPT ids [K, L] -> texts + (opt tokens+mask padded, clip tokens).

        Tokens pad to the group's longest caption rounded UP to a 32-token
        bucket (``token_pad_len`` pre-sizes the bucket but never truncates: a
        longer caption grows the bucket), so the update's cost follows the
        captions' length. Exact: the per-sample CE drops positions past the
        longest caption and divides by its length (``caption_ce``), so any
        pad at least that long gives the same loss.
        """
        texts = self.tok.batch_decode(seqs_np, stop_id=self.ccfg.opt.eos_newline_id)
        opt_tokens, opt_mask, lengths = self.tok.batch_encode(texts, return_lengths=True)
        longest = max(lengths, default=0)
        bucket = max(32, -(-opt_tokens.shape[1] // 32) * 32)
        if longest > self.token_pad_len:
            # NEVER truncate: the reference computes CE on the full caption
            # (`capdec_tta.py:111-119`); grow past the configured cap instead
            import warnings

            warnings.warn(
                f"re-tokenized caption length {longest} exceeds token_pad_len {self.token_pad_len}; padding up to "
                f"a {bucket}-token bucket (one more update shape) — raise token_pad_len to pre-size the bucket",
                RuntimeWarning,
            )
            pad_to = bucket
        else:
            pad_to = min(self.token_pad_len, bucket)
        if opt_tokens.shape[1] < pad_to:
            fill = ((0, 0), (0, pad_to - opt_tokens.shape[1]))
            opt_tokens = np.pad(opt_tokens, fill, constant_values=self.tok.pad_id)
            opt_mask = np.pad(opt_mask, fill, constant_values=0)
        elif opt_tokens.shape[1] > pad_to:
            opt_tokens = opt_tokens[:, :pad_to]
            opt_mask = opt_mask[:, :pad_to]
        clip_tokens = clip_tokenize([t if t else " " for t in texts], truncate=True)
        return texts, opt_tokens, opt_mask, clip_tokens

    def _captions(self, ids):
        return [t.lower() for t in self.tok.batch_decode(ids.cpu().numpy(), stop_id=self.ccfg.opt.eos_newline_id)]

    # -- entry points -------------------------------------------------------

    def adapt_batch(self, images, clip_embs, trace: Optional[list] = None) -> List[str]:
        """TTA for a group of images at once: images [N, H, W, 3] (normalized),
        clip_embs [N, E] (numpy or tensors) -> N final captions. ``trace``
        gets each step's (caption, reward) pairs, image-major. On a mesh each
        dp rank adapts its slice of the group; what it returns is the whole
        group's, on every rank."""
        dev, mesh = self.device, self.mesh
        clip_embs = torch.as_tensor(clip_embs, dtype=torch.float32).to(dev)
        images = torch.as_tensor(images).to(dev)
        n_all, K = clip_embs.shape[0], self.sample_k
        clip_embs, images = dp_slice(mesh, clip_embs), dp_slice(mesh, images)
        N, P = clip_embs.shape[0], self.ccfg.prefix_length
        gather = lambda x: dp_gather(mesh, x, n_all)
        # nucleus draws: every rank draws the whole group's, in its order, and keeps its rows
        rows = (mesh.dp_rank * N * K, n_all * K) if N < n_all else None
        start = self.momentum_state.reset_params if self.momentum_update else self.params["mapper"]
        mappers = Po.tree_map(lambda a: a.detach()[None].expand(N, *a.shape).clone().requires_grad_(True), start)
        opt = make_optimizer(Po.tree_leaves(mappers), self.ecfg)   # fresh per group: the per-image reset
        generator = torch.Generator(device=dev)
        # nucleus draws: seeded from the run's seed and the call counter (the JAX package keys them by the counter)
        generator.manual_seed(int(np.random.SeedSequence([self.seed, self._sample_counter]).generate_state(1)[0]))
        self._sample_counter += 1
        img_feats = self.reward_image_feats(images)
        for _ in range(self.tta_steps):
            seqs = self._generate_k(mappers, clip_embs, generator, rows)
            texts, opt_tokens, opt_mask, clip_tokens = self._decode_and_retokenize(
                seqs.reshape(N * K, -1).cpu().numpy())
            rewards = self._rewards(img_feats, torch.as_tensor(clip_tokens.astype(np.int64), device=dev)
                                    .reshape(N, K, -1))
            if trace is not None:
                trace.append(list(zip(gather(texts), gather(rewards).reshape(-1).cpu().tolist())))
            attn = np.concatenate([np.ones((N * K, P), np.int64), opt_mask], axis=1)
            self._update_step(opt, mappers, clip_embs, torch.as_tensor(opt_tokens.astype(np.int64), device=dev)
                              .reshape(N, K, -1), torch.as_tensor(attn, device=dev).reshape(N, K, -1), rewards)
        captions = gather(self._captions(self._generate_final(mappers, clip_embs)))
        if self.momentum_update:   # every rank folds the whole group's mappers, in image order
            self.momentum_state = Po.momentum_update_batch(self.momentum_state,
                                                           Po.tree_map(lambda v: gather(v.detach()), mappers),
                                                           **self.momentum_cfg)
        return captions

    def adapt_image(self, image, clip_emb, trace: Optional[list] = None) -> str:
        """One image's TTA -> its final caption: a group of one."""
        return self.adapt_batch(torch.as_tensor(image)[None], torch.as_tensor(clip_emb)[None], trace=trace)[0]

    @torch.no_grad()
    def predict_only(self, clip_emb) -> List[str]:
        """No-TTA beam-5 captions of embeddings [B, E] (`caption/predictions.py:21-70`)."""
        prefixes = prefix_tokens(self.params["mapper"], self.ccfg,
                                 torch.as_tensor(clip_emb, dtype=torch.float32).to(self.device))
        seqs, _ = O.beam_generate(self.decode_params, self.ccfg.opt, prefixes, num_beams=5,
                                  max_new_tokens=self.max_new_tokens, num_return=1, seg_len=self.decode_seg_len)
        return self._captions(seqs[:, 0])


# ---------------------------------------------------------------------------
# Legacy ClipCap predictor (GPT-2 backend, `caption/image_llm/generate.py`)
# ---------------------------------------------------------------------------


@torch.no_grad()
def clipcap_predict(params, ccfg: CaptionModelConfig, clip_embs, gpt2_tokenizer, use_beam: bool = True,
                    beam_size: int = 5, entry_length: int = 67, temperature: float = 1.0,
                    stop_token: str = ".") -> List[str]:
    """No-TTA ClipCap captions through the GPT-2 backend, the legacy path of
    `caption/predictions.py:21-70`: CLIP embedding -> mapper prefix ->
    ``generate_beam`` (the best beam) or ``generate2`` (greedy), one image
    at a time. ``clip_embs`` [N, E] -> N caption strings."""
    if ccfg.llm != "gpt2":
        raise ValueError("clipcap_predict requires a CaptionModelConfig with llm='gpt2'")
    # the raw token id: GPT-2 tokenizers prepend no BOS, unlike OPT's </s>
    stop_id = gpt2_tokenizer.encode(stop_token, add_bos=False)[0]
    lm = params["gpt2"]
    prefixes = prefix_tokens(params["mapper"], ccfg, torch.as_tensor(clip_embs, dtype=torch.float32)
                             .to(lm["wte"].device))
    out = []
    for prefix in prefixes:
        if use_beam:
            tokens, lengths, order = G.clipcap_beam_generate(lm, ccfg.gpt2, prefix, stop_id, beam_size=beam_size,
                                                             entry_length=entry_length, temperature=temperature)
            best = int(order[0])
            ids = tokens[best][: int(lengths[best])]
        else:
            tokens, length = G.clipcap_top_p_generate(lm, ccfg.gpt2, prefix, stop_id, entry_length=entry_length,
                                                      temperature=temperature)
            ids = tokens[:length]
        out.append(gpt2_tokenizer.decode(ids.tolist()))
    return out


# ---------------------------------------------------------------------------
# CLIP feature pre-extraction (`caption/extractor_pickle.py`)
# ---------------------------------------------------------------------------


@torch.no_grad()
def extract_clip_features(clip_params, clip_cfg, images_iter=None, texts: Optional[Sequence[str]] = None,
                          batch_size: int = 256):
    """CLIP image embeddings of the batches ``images_iter`` yields (NHWC,
    normalised) and/or text embeddings of ``texts`` (77 tokens, in batches
    of ``batch_size``), unnormalised, for caption training -> {"image_embeddings",
    "text_embeddings"}: float32 arrays whatever the towers' dtype, the
    values the towers computed (a bf16 -> fp32 cast is exact), so that
    ``np.load`` reads them as numbers (the JAX package writes bf16 towers'
    arrays in bf16, which ``np.load`` reads as raw ``|V2`` bytes).

    On the card the image tower takes ``clip_model.best_attn`` and the text
    tower ``clip_model.text_attn`` (the fused kernel); the JAX package's
    function runs both dense, the same function within the kernel's
    tolerance. On the CPU both packages run dense."""
    dev = clip_params["logit_scale"].device
    out = {}
    if images_iter is not None:
        attn = clip_model.best_attn(clip_cfg, dev)
        feats = [clip_model.encode_image(clip_params, clip_cfg, torch.as_tensor(b, device=dev), attn=attn)
                 .float().cpu().numpy() for b in images_iter]
        out["image_embeddings"] = np.concatenate(feats, axis=0)
    if texts is not None:
        attn = clip_model.text_attn(dev)
        tok = torch.as_tensor(clip_tokenize(list(texts), truncate=True).astype(np.int64), device=dev)
        feats = [clip_model.encode_text(clip_params, clip_cfg, tok[s : s + batch_size], attn=attn).float().cpu().numpy()
                 for s in range(0, tok.shape[0], batch_size)]
        out["text_embeddings"] = np.concatenate(feats, axis=0)
    return out
