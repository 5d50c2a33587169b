"""Bongard-HOI few-shot prompt test-time adaptation (the counterpart of
``rlcf_tpu/tasks/bongard.py``).

The reference wires Bongard-HOI through the prompt-TTA entry as a binary
few-shot problem: a 2-class prompt learner, class names ``['X', 'X']`` with a
learnable class token when ``learned_cls`` is set, else ``['True', 'False']``
(`TPT/clip/custom_clip.py:347-361`), and each task as 6 positive and 6
negative support images plus one query of each polarity, support labels
``[0] * 6 + [1] * 6`` (the positive class is 0) and query labels ``[neg, pos]
= [1, 0]`` (`TPT/data/hoi_dataset.py:79-111`).

Per group of N tasks: the frozen visual tower encodes the N * 14 images once
(support and queries share it), ``tta_steps`` AdamW steps tune the context
(and the class tokens) under cross-entropy on the labelled support set, and
the two queries are scored with the adapted prompt. The N tasks run as one
batch axis with the summed loss: AdamW is elementwise, so each task's update
is its own, as under the JAX package's vmap.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prompt as P
from ..core.episode import EpisodeConfig, adamw_init, adamw_step
from ..models import clip as clip_model
from .classification import maybe_normalize_u8, prompt_text_features

N_SUPPORT = 12  # 6 positive + 6 negative (`hoi_dataset.py:103`)
N_QUERY = 2  # [negative, positive] (`hoi_dataset.py:104-105`)


class BongardTTA:
    """Few-shot prompt TTA over Bongard-HOI tasks. ``learned_cls=True`` is
    the reference's ``['X', 'X']`` learnable class-token mode; otherwise the
    fixed ``['True', 'False']`` names (`custom_clip.py:350-355`)."""

    def __init__(self, clip_params, clip_cfg, ecfg: EpisodeConfig, ctx_init: Optional[str] = None, n_ctx: int = 4,
                 learned_cls: bool = True):
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.ecfg = ecfg
        self.ctx_init = ctx_init
        self.n_ctx = n_ctx
        self.learned_cls = learned_cls
        self.prompt_state = None
        self.device = clip_params["logit_scale"].device
        self.attn = clip_model.best_attn(clip_cfg, self.device)
        self.text_attn = clip_model.text_attn(self.device)

    def setup(self):
        classnames = ["X", "X"] if self.learned_cls else ["True", "False"]
        self.prompt_state = P.build_prompt_state(self.clip_params, classnames, ctx_init=self.ctx_init,
                                                 n_ctx=self.n_ctx, learned_cls=self.learned_cls)
        return self

    def text_features(self, tr):
        """Normalized text features [N, 2, E] of the trainables ``tr`` (ctx [N, n_ctx, D], cls [N, 2, D])."""
        return prompt_text_features(self.clip_params, self.clip_cfg, self.prompt_state, tr["ctx"], self.text_attn,
                                    tr.get("cls"))

    @torch.no_grad()
    def encode_images(self, images):
        """[M, H, W, 3] (u8 or CLIP-normalized float) -> normalized features [M, E]."""
        feats = clip_model.encode_image(self.clip_params, self.clip_cfg, maybe_normalize_u8(images), attn=self.attn)
        return clip_model.normalize(feats.float())

    def adapt_tasks(self, task_images, support_labels):
        """A group of Bongard tasks.

        Args:
          task_images: [N, 14, H, W, 3] float (CLIP-normalized) or u8, numpy
            or tensor: support images 0..11, queries 12..13 ([neg, pos]).
          support_labels: [N, 12] int (0 = positive class, 1 = negative).

        Returns (query logits [N, 2, 2], {"losses": [N, tta_steps]}).
        """
        task_images = torch.as_tensor(task_images).to(self.device)
        N = task_images.shape[0]
        feats = self.encode_images(task_images.reshape((N * (N_SUPPORT + N_QUERY),) + task_images.shape[2:]))
        feats = feats.reshape(N, N_SUPPORT + N_QUERY, -1)
        sup_feats, q_feats = feats[:, :N_SUPPORT], feats[:, N_SUPPORT:]
        labels = torch.as_tensor(np.asarray(support_labels), device=self.device).long()
        pt = self.prompt_state
        tr = {"ctx": pt.ctx0}
        if self.learned_cls:
            tr["cls"] = pt.cls0
        tr = {k: v.detach()[None].expand(N, *v.shape).clone().requires_grad_(True) for k, v in tr.items()}
        scale = self.clip_params["logit_scale"].exp().float()
        ecfg, state = self.ecfg, adamw_init(list(tr.values()))   # fresh state per group: the per-task reset
        losses = []
        for step in range(1, ecfg.tta_steps + 1):
            logits = scale * torch.einsum("nse,nce->nsc", sup_feats, self.text_features(tr))   # [N, 12, 2]
            loss = F.cross_entropy(logits.reshape(-1, 2), labels.reshape(-1), reduction="none").reshape(N, -1)
            loss = loss.mean(dim=-1)   # [N]: each task's mean support cross-entropy
            grads = torch.autograd.grad(loss.sum(), list(tr.values()))
            new, state = adamw_step([v.detach() for v in tr.values()], grads, state, step, ecfg.lr,
                                    ecfg.weight_decay, ecfg.adam_eps)
            tr = {k: v.requires_grad_(True) for k, v in zip(tr, new)}
            losses.append(loss.detach())
        with torch.no_grad():
            q_logits = scale * torch.einsum("nqe,nce->nqc", q_feats, self.text_features(tr))
        stacked = torch.stack(losses, dim=1) if losses else torch.zeros((N, 0), device=q_logits.device)
        return q_logits, {"losses": stacked}


def run_bongard(args, params, cfg, logger) -> dict:
    """The CLI's Bongard-HOI run: ``BongardHOIDataset`` tasks in groups of
    ``--episode_group``, images preprocessed on the host (the CLIP eval
    transform, float NHWC), short support sets padded by repetition to 6 + 6.
    Accuracy is the mean over all query predictions (labels ``[1, 0]``,
    `hoi_dataset.py:104-105`), as the reference's top-1 meter gives it.
    Returns the JAX package's keys (``top1``, ``n_tasks``, ``n_queries``) and
    ``group_seconds``: each group from the first decode of its images to its
    predictions on the host, preprocessing included."""
    from ..data.datasets import BongardHOIDataset
    from ..data.transforms import preprocess_pil

    ecfg = EpisodeConfig(tta_steps=args.tta_steps, selection_p=args.selection_p, lr=args.lr,
                         weight_decay=args.weight_decay, loss="bongard_ce", sample_k=args.sample_k)
    tta = BongardTTA(params, cfg, ecfg, ctx_init=args.ctx_init, n_ctx=args.n_ctx,
                     learned_cls=bool(args.learned_cls)).setup()
    dataset = BongardHOIDataset(args.data, split=args.bongard_split, mode=args.dataset_mode)
    n_tasks = len(dataset) if args.limit is None else min(args.limit, len(dataset))

    support_labels = np.array([0] * 6 + [1] * 6, dtype=np.int64)  # `hoi_dataset.py:103`
    query_labels = np.array([1, 0], dtype=np.int64)  # `hoi_dataset.py:105`
    correct = total = 0
    group_imgs, group_seconds = [], []

    def flush():
        nonlocal correct, total
        if not group_imgs:
            return
        batch = np.stack(group_imgs)  # [N, 14, H, W, 3]
        q_logits, _ = tta.adapt_tasks(batch, np.tile(support_labels, (batch.shape[0], 1)))
        preds = q_logits.argmax(dim=-1).cpu().numpy()  # [N, 2]; synchronizes with the device
        group_seconds.append(time.perf_counter() - t0)
        correct += int((preds == query_labels[None, :]).sum())
        total += preds.size
        group_imgs.clear()

    for i in range(n_tasks):
        if not group_imgs:
            t0 = time.perf_counter()
        task = dataset[i]
        # a static [12 support + 2 query] layout, 6 per polarity as the
        # reference's fixed label vector: short tasks pad by repetition
        imgs = (task["pos_support"] * 6)[:6] + (task["neg_support"] * 6)[:6] + [task["neg_query"], task["pos_query"]]
        group_imgs.append(np.stack([preprocess_pil(im, args.resolution) for im in imgs]))
        if len(group_imgs) == args.episode_group:
            flush()
    flush()

    result = {"top1": round(100.0 * correct / max(total, 1), 2), "n_tasks": n_tasks, "n_queries": total,
              "group_seconds": group_seconds}
    logger.text(f"=> Bongard-HOI [{args.bongard_split}]: @1 {result['top1']}")
    return result
