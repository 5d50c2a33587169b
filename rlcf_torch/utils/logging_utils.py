"""Run logs: append-only ``log.txt``, ``results.json`` (`TPT/tpt_cls_rl.py:199-207`),
JSON result lines, and the caption TTA's sampled-caption/reward trace."""

from __future__ import annotations

import json
import os
import time


class RunLogger:
    """``enabled=False`` (a rank other than 0 of a sharded run) writes and
    prints nothing."""

    def __init__(self, output_dir: str, enabled: bool = True):
        self.dir = output_dir
        self.enabled = enabled
        if enabled:
            os.makedirs(output_dir, exist_ok=True)
        self._t0 = time.time()

    def text(self, *lines: str):
        if not self.enabled:
            return
        with open(os.path.join(self.dir, "log.txt"), "a") as fh:
            for line in lines:
                fh.write(line.rstrip("\n") + "\n")
        for line in lines:
            print(line, flush=True)

    def result_line(self, payload: dict, name: str = "evaluate.txt"):
        """Append one JSON line (`lavis/tasks/retrieval.py:103-106`)."""
        if not self.enabled:
            return
        with open(os.path.join(self.dir, name), "a") as fh:
            fh.write(json.dumps(payload) + "\n")

    def results_json(self, results: dict, name: str = "results.json"):
        if not self.enabled:
            return
        with open(os.path.join(self.dir, name), "a+") as fh:
            json.dump(results, fh, indent=4)

    def elapsed_line(self, label: str) -> str:
        dt = time.time() - self._t0
        return f"The running time for {label} is {dt // 3600:.1f} Hour {dt % 3600 / 60:.1f} Minute"


class CaptionTraceLogger:
    """Per-image sampled-caption/reward trace (`TxtLogger`, `capdec_tta.py:22-46`),
    in the JAX package's file format."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def log_id(self, image_id: str):
        self._fh.write(f"\n==== {image_id} ====\n")

    def log_samples(self, captions, rewards):
        for c, r in zip(captions, rewards):
            self._fh.write(f"  [{r:+.4f}] {c}\n")

    def log_final(self, caption: str):
        self._fh.write(f"  FINAL: {caption}\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
