"""Retrieval TTA: per-query REINFORCE over a cached gallery (the counterpart
of ``rlcf_tpu/tasks/retrieval.py``).

- i2t ("image2text"): the gallery's caption features (policy and reward
  text towers) are computed once (`clip_ret_policy.py:150-156`); each query
  image runs an episode that adapts the policy's **visual** tower with the
  reward-weighted loss over the top-K retrieved captions (`tune_image`,
  `:76-103`); the final logits row fills the score matrix (`:168-173`).
- t2i ("text2image"): the gallery's image features are cached, and the
  episodes adapt the **text** tower per query caption (`tune_text`,
  `:106-137`).

A group of N queries runs as N episodes on one batch axis
(``core/episode.py``): the adapted tower's weights carry a leading episode
axis, every step is one batched forward and backward, and each episode
starts from the same weights with a fresh AdamW (eps 1e-6, `:235`). A query
is one "view" (``selection_p = 1``), so step 0 reuses the selection
forward's graph. The KD variants (`clip_ret_kd.py:37-93`) distill the frozen
reward's similarity row instead; a momentum EMA re-anchors the episodes'
start as in encoder TTA.

On a process mesh (``parallel/mesh.py``) the galleries are encoded with
their batches split over dp, then split over tp: each tp rank scores its
share of the gallery, and the score rows are gathered over tp (so top-k and
the rewards see the whole gallery) and over dp (the queries of a group).
The query features' gradient is summed over tp on the way back
(``reduce_grad``), which makes the adapted tower's gradient the whole one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import policy as Po
from ..core.episode import EpisodeConfig, make_tta_episode, take_rows
from ..core.reward import reward_image_features
from ..models import clip as clip_model
from ..parallel.collectives import gather_replicated, reduce_grad
from ..parallel.mesh import class_sharded, dp_gather, dp_slice, ranks_per_device
from ..tokenizer import tokenize
from .classification import is_ensemble


@dataclasses.dataclass
class RetrievalGallery:
    """Eval-set annotations: images, captions, and GT mappings
    (`retrieval_datasets.py:63-95`)."""

    image_paths: List[str]
    texts: List[str]
    img2txt: Dict[int, List[int]]
    txt2img: Dict[int, int]


def blip_caption_process(caption: str, prompt: str = "", max_words: int = 50) -> str:
    """LAVIS ``BlipCaptionProcessor`` text cleaning
    (`retrieval/lavis/processors/blip_processors.py:29-68`): lowercase,
    punctuation subset -> space, whitespace collapse, word-truncate."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return prompt + caption


def load_karpathy_annotations(ann_path: str, vis_root: str = "", process_text: bool = True) -> RetrievalGallery:
    """LAVIS retrieval annotation json: [{"image": rel, "caption": [...]}].

    ``process_text`` applies the blip_caption processor the reference eval
    datasets run on every caption (`retrieval_datasets.py:83`).
    """
    with open(ann_path) as fh:
        annotations = json.load(fh)
    image_paths, texts = [], []
    img2txt, txt2img = {}, {}
    tid = 0
    for img_id, ann in enumerate(annotations):
        image_paths.append(os.path.join(vis_root, ann["image"]))
        img2txt[img_id] = []
        caps = ann["caption"] if isinstance(ann["caption"], list) else [ann["caption"]]
        for cap in caps:
            texts.append(blip_caption_process(cap) if process_text else cap)
            img2txt[img_id].append(tid)
            txt2img[tid] = img_id
            tid += 1
    return RetrievalGallery(image_paths, texts, img2txt, txt2img)


def dp_batch(mesh, batch, encode):
    """``encode(batch)`` with the batch's rows split over dp and the results
    gathered (the counterpart of ``_dp_batch``): a ragged batch is padded to a
    multiple of dp with its last row, whose copies' results are dropped."""
    n = batch.shape[0]
    if mesh is None or mesh.dp == 1:
        return encode(batch)
    pad = -n % mesh.dp
    if pad:
        batch = torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])
    return dp_gather(mesh, encode(dp_slice(mesh, batch)))[:n]


@torch.no_grad()
def encode_text_gallery(params, cfg, texts: Sequence[str], batch_size: int = 256, attn: str = "dense", mesh=None):
    """Normalized text features [N, E] of the whole caption gallery, and its
    token ids with the dead padded tail dropped (``truncate_tokens``);
    ``mesh``: each batch's rows split over dp."""
    tokens = clip_model.truncate_tokens(tokenize(list(texts), truncate=True))
    if mesh is None or mesh.dp == 1:
        return clip_model.encode_token_batches(params, cfg, tokens, batch_size, attn), tokens
    ids = torch.as_tensor(tokens.astype("int64"), device=params["logit_scale"].device)
    encode = lambda t: clip_model.encode_text(params, cfg, t, attn=attn)
    feats = [dp_batch(mesh, ids[s : s + batch_size], encode) for s in range(0, ids.shape[0], batch_size)]
    return clip_model.normalize(torch.cat(feats).float()), tokens


@torch.no_grad()
def encode_image_gallery(params, cfg, images_iter, attn: str = "dense", mesh=None):
    """Normalized image features [M, E] from an iterator of normalized NHWC
    batches (numpy or tensors); ``mesh``: each batch's rows split over dp."""
    device = params["logit_scale"].device
    encode = lambda x: clip_model.encode_image(params, cfg, x, attn=attn)
    feats = [dp_batch(mesh, torch.as_tensor(batch).to(device), encode) for batch in images_iter]
    return clip_model.normalize(torch.cat(feats).float())


class RetrievalTTA:
    """Per-query retrieval TTA engine for one direction."""

    def __init__(self, clip_params, clip_cfg, reward, ecfg: EpisodeConfig, direction: str = "i2t",
                 momentum_update: bool = False, update_freq: int = 256, update_w: float = 1.0,
                 momentum: float = 0.9999, mesh=None):
        assert direction in ("i2t", "t2i")
        if is_ensemble(reward):
            raise ValueError(
                "RetrievalTTA requires a single ClipReward (the reference "
                "retrieval path uses one reward CLIP, `retrieval/clip_rewards.py`)"
            )
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.reward = reward
        self.ecfg = ecfg
        self.direction = direction
        self.mesh = mesh
        self._tp_group = None   # set when the galleries shard over tp
        self.momentum_update = momentum_update
        self.momentum_cfg = dict(momentum=momentum, update_freq=update_freq, update_w=update_w)
        self.device = clip_params["logit_scale"].device
        self.text_attn = clip_model.text_attn(self.device)   # the galleries' and t2i's text tower
        # the differentiated tower: a vision tower's own choice, a text tower the kernel (as the reward's text)
        self.attn = clip_model.best_attn(clip_cfg, self.device) if direction == "i2t" else self.text_attn
        self.reward_attn = clip_model.best_attn(reward.cfg, self.device)
        # t2i trains the text tower with its [49408, 512] token embedding
        # (`clip_ret_policy.py:106-137`), yet an episode reads only its own
        # query's <= 77 rows: the others see zero gradient, so their update is
        # pure decoupled weight decay, which the final forward never reads.
        # The factored trainable is the tower without the table plus the
        # query's gathered rows, with the same outputs. A momentum EMA needs
        # the whole table (per-query rows fold into no shared anchor), so
        # momentum trains the full tower, as in the JAX package.
        self.factor_embedding = direction == "t2i" and not momentum_update
        if direction == "i2t":
            self.trainable0 = clip_params["visual"]
        elif self.factor_embedding:
            self.trainable0 = {k: v for k, v in clip_params["text"].items() if k != "token_embedding"}
        else:
            self.trainable0 = clip_params["text"]
        self.momentum_state = Po.MomentumState.create(self.trainable0) if momentum_update else None
        self.gallery_feats = None
        self.reward_gallery_feats = None
        self.group_seconds: List[float] = []
        self._episode = make_tta_episode(
            self.policy_logits, self.reward_sim, reward.score_samples,
            dataclasses.replace(ecfg, selection_p=1.0),   # one query, no view selection: keep the one "view"
            teacher_scale=reward.params["logit_scale"].exp().float(),   # the KD variants' teacher
            return_adapted=True)

    # -- gallery setup ----------------------------------------------------

    def _shard_galleries(self):
        """Keep this tp rank's share of the galleries (the counterpart of
        ``_maybe_shard_galleries``)."""
        mesh = self.mesh
        if mesh is None or mesh.tp == 1:
            return
        g = self.gallery_feats.shape[0]
        if g % mesh.tp:
            print(f"NOTE: gallery size {g} not divisible by tp={mesh.tp}; gallery replicated")
            return
        self._tp_group = mesh.tp_group
        self.gallery_feats = class_sharded(mesh, self.gallery_feats).contiguous()
        self.reward_gallery_feats = class_sharded(mesh, self.reward_gallery_feats).contiguous()
        self.reward.class_features = self.reward_gallery_feats

    def _gather_gallery(self, x):
        """Score rows over the whole gallery from this tp rank's columns."""
        return x if self._tp_group is None else gather_replicated(x, self._tp_group, dim=-1)

    def set_text_gallery(self, texts: Sequence[str]):
        """i2t: cache the policy's and the reward's features of every caption."""
        self.gallery_feats, tokens = encode_text_gallery(self.clip_params, self.clip_cfg, texts, attn=self.text_attn,
                                                         mesh=self.mesh)
        self.reward_gallery_feats = self.reward.set_class_features(tokens)   # the same truncation: exact
        self._shard_galleries()
        return self

    def set_image_gallery(self, images_iter_policy, images_iter_reward):
        """t2i: cache the policy's and the reward's features of every gallery
        image (the reward's taken resized to its own resolution)."""
        self.gallery_feats = encode_image_gallery(self.clip_params, self.clip_cfg, images_iter_policy,
                                                  attn=clip_model.best_attn(self.clip_cfg, self.device), mesh=self.mesh)
        encode = lambda x: reward_image_features(self.reward.params, self.reward.cfg, x, self.reward_attn)
        with torch.no_grad():
            feats = [dp_batch(self.mesh, torch.as_tensor(b).to(self.device), encode) for b in images_iter_reward]
        self.reward_gallery_feats = torch.cat(feats)
        self.reward.class_features = self.reward_gallery_feats
        self._shard_galleries()
        return self

    # -- episode ----------------------------------------------------------

    def policy_logits(self, trainable, cache, idx):
        """Logits [N, k, G] of the queries' views ``idx [N, k]`` against the
        gallery under per-episode weights ``trainable`` (leaves ``[N, ...]``)."""
        N, k = idx.shape
        if self.direction == "i2t":
            views = take_rows(cache["views"], idx)   # [N, k, H, W, 3]
            if self.clip_cfg.is_vit:
                toks = clip_model.patch_tokens_from_images(views.reshape((N * k,) + views.shape[2:]),
                                                           self.clip_cfg.vision_patch_size)
                feats = clip_model.encode_image_tokens({"visual": trainable}, self.clip_cfg,
                                                       toks.reshape((N, k) + toks.shape[1:]), attn=self.attn)
            else:
                feats = clip_model.encode_image({"visual": trainable}, self.clip_cfg, views)
        elif self.factor_embedding:
            # position i reads row firstocc[i]: a repeated token's gradient
            # lands on one row, as the JAX package's one-hot adjoint puts it
            rows = trainable["emb_rows"]
            embeds = torch.gather(rows, 1, cache["firstocc"][..., None].expand(-1, -1, rows.shape[-1]))
            text = {k_: v for k_, v in trainable.items() if k_ != "emb_rows"}
            feats = clip_model.encode_text_embeds({"text": text}, self.clip_cfg,
                                                  embeds[:, None].expand(N, k, *embeds.shape[1:]),
                                                  cache["eot"][:, None].expand(N, k), attn=self.attn)
        else:
            feats = clip_model.encode_text({"text": trainable}, self.clip_cfg, take_rows(cache["views"], idx),
                                           attn=self.attn)
        scale = self.clip_params["logit_scale"].exp().float()
        feats = clip_model.normalize(feats.float())
        if self._tp_group is not None:   # the product's consumers are sharded: sum the features' gradient over tp
            feats = reduce_grad(feats, self._tp_group)
        return self._gather_gallery(scale * (feats @ self.gallery_feats.T))

    def reward_sim(self, views):
        """Frozen reward similarities [N, S, G] of the selected views
        ``[N, S, ...]``: images (i2t, resized to the reward's resolution
        where it differs) or token ids (t2i)."""
        N, S = views.shape[:2]
        flat = views.reshape((N * S,) + views.shape[2:])
        if self.direction == "i2t":
            feats = reward_image_features(self.reward.params, self.reward.cfg, flat, self.reward_attn)
        else:
            feats = self.reward.text_features(flat)
        return self._gather_gallery(feats @ self.reward_gallery_feats.T).reshape(N, S, -1)

    # -- memory ------------------------------------------------------------

    # Device bytes an episode adds at its peak, as a multiple of its trainable
    # bytes: the adapted copy, its gradient, AdamW's two moments and the
    # foreach step's sqrt(v); one query's activations are small beside them.
    # tools/retrieval_group_memory.py measured 5.002-5.005 (the allocated
    # peak per episode, groups of 8 to 190, both directions, bf16 and fp32,
    # ViT-B/16 policy and ViT-L/14 reward with the COCO Karpathy test split's
    # galleries) on an NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py's
    # RETRIEVAL line prints it again.
    PER_EPISODE_FACTOR = 5.01
    # The share of the card's memory a group may take: the caching allocator's
    # fragmentation holds the rest. In that tool's run the largest groups that
    # ran peaked at 0.81-0.87 of total_memory allocated (bf16: i2t 82, t2i 190
    # episodes; fp32: i2t 41, t2i 87), and the next sizes, at 0.88-0.95, ran
    # out of memory with the rest reserved but unusable. chip_smoke.py runs
    # one group at the cap.
    HBM_USABLE_SHARE = 0.80

    def trainable_bytes(self) -> int:
        """Per-episode trainable bytes (the factored embedding rows included)."""
        n = sum(v.numel() * v.element_size() for v in Po.tree_leaves(self.trainable0))
        if self.factor_embedding:
            table = self.clip_params["text"]["token_embedding"]
            n += self.clip_cfg.context_length * table.shape[1] * table.element_size()
        return n

    def hbm_group_cap(self, hbm_limit_bytes: int | None = None) -> int | None:
        """Largest episode group a rank may run in the card's memory, or None
        on the CPU (no limit known): the weights and the galleries, plus a
        group of ``PER_EPISODE_FACTOR`` x the trainable bytes, against
        ``HBM_USABLE_SHARE`` of ``hbm_limit_bytes`` (by default the card's
        ``total_memory`` over the ranks that share the card)."""
        if hbm_limit_bytes is None:
            if self.device.type != "cuda":
                return None
            hbm_limit_bytes = torch.cuda.get_device_properties(self.device).total_memory // ranks_per_device()
        tensors = Po.tree_leaves(self.clip_params) + Po.tree_leaves(self.reward.params) + [
            f for f in (self.gallery_feats, self.reward_gallery_feats) if f is not None]
        budget = self.HBM_USABLE_SHARE * hbm_limit_bytes - sum(v.numel() * v.element_size() for v in tensors)
        return max(1, int(budget / (self.PER_EPISODE_FACTOR * self.trainable_bytes())))

    # -- entry points -------------------------------------------------------

    def episode_inputs(self, queries):
        """What the episode of a group of queries takes: ``(start, cache,
        views, per_episode)``, views ``[N, 1, ...]`` (the singleton view axis).
        t2i's factored start is per episode: the tower's leaves expanded to
        ``[N, ...]`` and each query's own embedding rows ``emb_rows [N, 77,
        D]``, read through ``cache["firstocc"]``."""
        q = torch.as_tensor(queries).to(self.device)
        if self.direction == "t2i":
            q = q.long()
        start = self.momentum_state.reset_params if self.momentum_update else self.trainable0
        cache, per_episode = {"views": q[:, None]}, False
        if self.factor_embedding:
            N = q.shape[0]
            start = {**Po.tree_map(lambda v: v.detach()[None].expand(N, *v.shape), start),
                     "emb_rows": clip_model.embed_tokens(self.clip_params, q)}   # [N, 77, D]
            cache["firstocc"] = (q[:, None, :] == q[:, :, None]).int().argmax(dim=-1)   # [N, 77]
            cache["eot"] = q.argmax(dim=-1)
            per_episode = True
        return start, cache, cache["views"], per_episode

    def adapt_queries(self, queries, return_adapted: bool = False):
        """Run episodes for a group of queries -> score rows [N, gallery_size]
        (numpy), and with ``return_adapted`` the N adapted trainables (leaves
        ``[N, ...]``; t2i's factored ones with their ``emb_rows``).

        queries: [N, H, W, 3] normalized images (i2t) or [N, 77] token ids
        (t2i), numpy or tensors.
        """
        queries = torch.as_tensor(queries)
        n = queries.shape[0]
        start, cache, views, per_episode = self.episode_inputs(dp_slice(self.mesh, queries))
        logits, aux = self._episode(start, cache, views, per_episode=per_episode)
        adapted = aux["adapted"]
        if self.momentum_update or return_adapted:   # the whole group's, in query order
            adapted = Po.tree_map(lambda a: dp_gather(self.mesh, a, n), adapted)
        if self.momentum_update:
            self.momentum_state = Po.momentum_update_batch(self.momentum_state, adapted, **self.momentum_cfg)
        scores = dp_gather(self.mesh, logits[:, 0], n).float().cpu().numpy()
        return (scores, adapted) if return_adapted else scores

    def run(self, queries_iter, total: int, gallery_size: int, group_size: int = 8) -> np.ndarray:
        """Fill the full score matrix (init -100, `clip_ret_policy.py:146-147`);
        each group's seconds go to ``group_seconds``."""
        cap = self.hbm_group_cap()
        if cap is not None and self.mesh is not None:   # a rank runs its dp share of a group
            cap *= self.mesh.dp
        if cap is not None and group_size > cap:
            print(f"NOTE: episode group {group_size} would exceed the card's memory; capping to {cap}")
            group_size = cap
        scores = np.full((total, gallery_size), -100.0, dtype=np.float32)
        row, buf = 0, []
        t0 = time.perf_counter()

        def flush():
            nonlocal row, t0
            scores[row : row + len(buf)] = self.adapt_queries(torch.stack(buf) if torch.is_tensor(buf[0])
                                                              else np.stack(buf))
            row += len(buf)
            self.group_seconds.append(time.perf_counter() - t0)
            buf.clear()
            t0 = time.perf_counter()

        for q in queries_iter:
            buf.append(q)
            if len(buf) == group_size:
                flush()
        if buf:
            flush()
        return scores


def zero_shot_scores(clip_params, cfg, image_feats, text_feats):
    """Zero-shot score matrices (`retrieval/zero_shot.py:24-36`)."""
    i2t = clip_params["logit_scale"].exp().float() * (image_feats.float() @ text_feats.float().T)
    i2t = i2t.cpu().numpy()
    return i2t, i2t.T


def zero_shot_scores_ensemble(models, image_feats_list, text_feats_list):
    """Multi-arch zero-shot retrieval: mean of per-model scaled sims
    (`retrieval/zero_shot.py:24-36` via CLIPRet_Multiple)."""
    mats = [params["logit_scale"].exp().float() * (ifeat.float() @ tfeat.float().T)
            for (params, _cfg), ifeat, tfeat in zip(models, image_feats_list, text_feats_list)]
    i2t = torch.stack(mats).mean(dim=0).cpu().numpy()
    return i2t, i2t.T
