"""Run hyperparameters dumped next to the outputs (`TPT/params.py:101-107`)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


def save_hparams(output_dir: str, payload: Any, name: str = "hparams_train.json"):
    os.makedirs(output_dir, exist_ok=True)
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        payload = dataclasses.asdict(payload)
    with open(os.path.join(output_dir, name), "w") as fh:
        json.dump(payload, fh, indent=2, default=str)
