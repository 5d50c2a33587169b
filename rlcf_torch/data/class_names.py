"""Class-name metadata and prompt assembly (the port's copy of
``rlcf_tpu/data/class_names.py``): dataset id -> class names from the
packaged JSON asset, and ``"<prefix> <name>."`` prompts."""

from __future__ import annotations

import functools
import json
import os
from typing import List, Sequence

_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "class_metadata.json")

# Single letters are ImageNet variants, long names fine-grained sets.
IMAGENET_VARIANTS = ("I", "A", "R", "V", "K", "C")


@functools.lru_cache()
def _meta() -> dict:
    with open(_ASSET) as fh:
        return json.load(fh)


def variant_class_indices(set_id: str) -> List[int]:
    """Indices into the 1000 ImageNet classes kept by an OOD variant."""
    meta = _meta()
    if set_id in ("I", "K", "C"):
        return list(range(1000))
    if set_id == "A":
        return list(meta["imagenet_a_mask"])
    if set_id == "R":
        return [i for i, keep in enumerate(meta["imagenet_r_mask"]) if keep]
    if set_id == "V":
        return list(meta["imagenet_v_mask"])
    raise KeyError(set_id)


def get_classnames(set_id: str) -> List[str]:
    """Class names for a dataset id (ImageNet variant letter or fine-grained name)."""
    meta = _meta()
    if set_id in IMAGENET_VARIANTS:
        names = meta["imagenet_classes"]
        return [names[i] for i in variant_class_indices(set_id)]
    if set_id in meta["fine_grained"]:
        return list(meta["fine_grained"][set_id])
    raise KeyError(f"unknown dataset id {set_id!r}")


def assemble_prompts(classnames: Sequence[str], prefix: str = "a photo of a") -> List[str]:
    """``"<prefix> <name>."`` with underscores in names replaced by spaces."""
    prefix = prefix.replace("_", " ")
    return [f"{prefix} {name.replace('_', ' ')}." for name in classnames]
