"""Configs: a nested dict loaded from YAML and overridden by ``key.sub=value``
items, materialized into dataclasses; run hyperparameters dumped next to the
outputs (`TPT/params.py:101-107`). The counterpart of
``rlcf_tpu/utils/config.py``. PyYAML is imported only where a YAML file or
override is read: nothing on the card's path needs it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional


def load_config(path: Optional[str] = None, overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """The YAML file at ``path`` (or an empty dict) with each ``key.sub=value``
    of ``overrides`` set in turn, its value parsed as YAML."""
    import yaml

    cfg: Dict[str, Any] = {}
    if path:
        with open(path) as fh:
            cfg = yaml.safe_load(fh) or {}
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = yaml.safe_load(value)
    return cfg


def materialize(dc_type, cfg: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys."""
    fields = {f.name for f in dataclasses.fields(dc_type)}
    return dc_type(**{k: v for k, v in cfg.items() if k in fields})


def save_hparams(output_dir: str, payload: Any, name: str = "hparams_train.json"):
    os.makedirs(output_dir, exist_ok=True)
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        payload = dataclasses.asdict(payload)
    with open(os.path.join(output_dir, name), "w") as fh:
        json.dump(payload, fh, indent=2, default=str)
