"""Classification metrics (top-k accuracy), parity with `TPT/utils/tools.py:84-98`."""

from __future__ import annotations

import numpy as np


def topk_correct(logits, labels, ks=(1, 5)):
    """Per-k correct counts for a batch of numpy logits [B, C] and labels [B]."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, : max(ks)]
    hits = top == labels[:, None]
    return {k: int(np.sum(np.any(hits[:, :k], axis=-1))) for k in ks}


class AccuracyMeter:
    """Running top-k accuracy accumulator (host-side)."""

    def __init__(self, ks=(1, 5)):
        self.ks = ks
        self.correct = {k: 0 for k in ks}
        self.count = 0

    def update(self, logits, labels):
        self.update_counts(topk_correct(logits, labels, self.ks), int(np.asarray(labels).shape[0]))

    def update_counts(self, counts: dict, n: int):
        for k in self.ks:
            self.correct[k] += int(counts[k])
        self.count += n

    def accuracy(self, k: int) -> float:
        return 100.0 * self.correct[k] / max(self.count, 1)

    def summary(self) -> dict:
        return {f"top{k}": round(self.accuracy(k), 3) for k in self.ks}
