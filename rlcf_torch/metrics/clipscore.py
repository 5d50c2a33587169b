"""CLIPScore / RefCLIPScore evaluator (`clipscore/clipscore.py`; the
counterpart of ``rlcf_tpu/metrics/clipscore.py``).

CLIPScore(i, c) = w * max(cos(img, "A photo depicts " + c), 0) with w=2.5 and
a ViT-B/32 scorer by default (`clipscore.py:81,149-174,247`); RefCLIPScore is
the harmonic mean with the max text-text similarity over references
(`clipscore.py:177-217,263`). Features are computed in batches on the
device, with the fused attention on the card (``best_attn``/``text_attn``),
and normalized on the host in float32, as the JAX package normalizes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import clip as clip_model
from ..tokenizer import tokenize

CAPTION_PREFIX = "A photo depicts "
CLIPSCORE_W = 2.5


def _normalize(feats: np.ndarray) -> np.ndarray:
    return feats / np.sqrt(np.sum(feats**2, axis=1, keepdims=True))


@torch.no_grad()
def extract_caption_features(params, cfg, captions: Sequence[str], prefix: str = CAPTION_PREFIX,
                             batch_size: int = 256, attn: Optional[str] = None) -> np.ndarray:
    """Normalized text features [N, E] (float32 numpy) of ``prefix + caption``
    at the full 77 tokens, in batches of ``batch_size``."""
    device = params["logit_scale"].device
    attn = attn or clip_model.text_attn(device)
    tokens = torch.as_tensor(tokenize([prefix + c for c in captions], truncate=True).astype(np.int64))
    feats = [clip_model.encode_text(params, cfg, tokens[s : s + batch_size].to(device), attn=attn).float().cpu()
             for s in range(0, tokens.shape[0], batch_size)]
    return _normalize(torch.cat(feats).numpy())


@torch.no_grad()
def extract_image_features(params, cfg, images_iter, attn: Optional[str] = None) -> np.ndarray:
    """Normalized image features [N, E] (float32 numpy) of NHWC batches."""
    device = params["logit_scale"].device
    attn = attn or clip_model.best_attn(cfg, device)
    feats = [clip_model.encode_image(params, cfg, torch.as_tensor(b).to(device), attn=attn).float().cpu()
             for b in images_iter]
    return _normalize(torch.cat(feats).numpy())


def clip_score(image_feats: np.ndarray, caption_feats: np.ndarray, w: float = CLIPSCORE_W):
    """Paired per-instance CLIPScore + mean (`clipscore.py:149-174`)."""
    per = w * np.clip(np.sum(image_feats * caption_feats, axis=1), 0, None)
    return float(np.mean(per)), per


def ref_clip_score(caption_feats: np.ndarray, references_feats: List[np.ndarray], per_image_text: np.ndarray):
    """RefCLIPScore: harmonic mean of image-text score and max ref similarity."""
    per_text = np.array([float(np.max(cand @ refs.T)) for cand, refs in zip(caption_feats, references_feats)])
    ref_scores = 2 * per_image_text * per_text / np.maximum(per_image_text + per_text, 1e-12)
    return float(np.mean(per_text)), ref_scores


def evaluate_captions(params, cfg, candidates: Dict[str, str], images_iter_factory, image_ids: Sequence[str],
                      references: Optional[Dict[str, List[str]]] = None) -> Dict:
    """Full evaluation: {image_id: caption} (+refs) -> score dict.
    ``images_iter_factory()`` yields NHWC batches aligned with ``image_ids``.
    The references, prefixed as the reference tool prefixes them
    (`clipscore.py:177-198`), are encoded in batches across images (the JAX
    package encodes each image's own): the same features."""
    caps = [candidates[i] for i in image_ids]
    img_feats = extract_image_features(params, cfg, images_iter_factory())
    cap_feats = extract_caption_features(params, cfg, caps)
    mean_cs, per_cs = clip_score(img_feats, cap_feats)
    out = {"clipscore": mean_cs, "per_instance": {i: {"CLIPScore": float(s)} for i, s in zip(image_ids, per_cs)}}
    if references is not None:
        refs = [references[i] for i in image_ids]
        flat = extract_caption_features(params, cfg, [r for rs in refs for r in rs])
        bounds = np.cumsum([0] + [len(rs) for rs in refs])
        _, ref_scores = ref_clip_score(cap_feats, [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])], per_cs)
        out["ref_clipscore"] = float(np.mean(ref_scores))
        for i, s in zip(image_ids, ref_scores):
            out["per_instance"][i]["RefCLIPScore"] = float(s)
    return out
