"""Retrieval metrics: Recall@1/5/10 from score matrices (the counterpart of
``rlcf_tpu/metrics/retrieval.py``, numpy).

Parity with `retrieval/lavis/tasks/retrieval.py:52-107`: for i2t the rank of
the best-ranked ground-truth caption per image; for t2i the rank of the single
ground-truth image per caption; plus per-direction and overall means.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np


def _ranks_i2t(scores_i2t: np.ndarray, img2txt: Mapping[int, Sequence[int]]) -> np.ndarray:
    order = np.argsort(-scores_i2t, axis=1)
    ranks = np.empty(scores_i2t.shape[0])
    for i in range(scores_i2t.shape[0]):
        pos = np.empty(scores_i2t.shape[1], dtype=np.int64)
        pos[order[i]] = np.arange(scores_i2t.shape[1])
        ranks[i] = min(pos[t] for t in img2txt[i])
    return ranks


def _ranks_t2i(scores_t2i: np.ndarray, txt2img: Mapping[int, int]) -> np.ndarray:
    order = np.argsort(-scores_t2i, axis=1)
    ranks = np.empty(scores_t2i.shape[0])
    for t in range(scores_t2i.shape[0]):
        ranks[t] = np.where(order[t] == txt2img[t])[0][0]
    return ranks


def retrieval_metrics(scores_i2t, scores_t2i, txt2img, img2txt) -> Dict[str, float]:
    tranks = _ranks_i2t(np.asarray(scores_i2t), img2txt)
    iranks = _ranks_t2i(np.asarray(scores_t2i), txt2img)
    tr = {k: 100.0 * (tranks < k).mean() for k in (1, 5, 10)}
    ir = {k: 100.0 * (iranks < k).mean() for k in (1, 5, 10)}
    tr_mean = sum(tr.values()) / 3
    ir_mean = sum(ir.values()) / 3
    return {
        "txt_r1": tr[1],
        "txt_r5": tr[5],
        "txt_r10": tr[10],
        "txt_r_mean": tr_mean,
        "img_r1": ir[1],
        "img_r5": ir[5],
        "img_r10": ir[10],
        "img_r_mean": ir_mean,
        "r_mean": (tr_mean + ir_mean) / 2,
        "agg_metrics": tr_mean,
    }
