"""Tensor-parallel OPT decode: the Megatron split of the per-token weight
stream over tp (the counterpart of ``rlcf_tpu/parallel/tp_opt.py``).

Cached decode reads every OPT weight once a token. With tp ranks each rank
holds and reads 1/tp of them: QKV and fc1 split their output features
(column-parallel: whole heads, so each rank's KV caches hold its heads),
out_proj and fc2 their input features (row-parallel: the partial products
are summed over tp, and the bias is added once, after the sum), the tied
embedding its vocabulary rows (each rank looks up the ids in its range and
the rows are summed over tp; the head's logits are gathered over tp before
top-k), and OPT-350m's project_in / project_out split like fc1 / fc2. JAX
places the arrays with these shardings and lets GSPMD insert the
collectives; here ``models/opt.py`` reads the ``"tp"`` entry this function
adds and runs them (``parallel/collectives.py``). Plain and int8
(``quantize_opt_params``) trees split alike: the int8 payload with its
weight, the scales along the weight axis ``_place`` gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .mesh import shard_range

# the split axis of each array (None: replicated); blocks carry a leading layer axis
_BLOCK_AXES = {
    "q_w": 2, "q_b": 1, "k_w": 2, "k_b": 1, "v_w": 2, "v_b": 1,   # heads: output features
    "out_w": 1,                                                   # contracts the heads: partial sums
    "fc1_w": 2, "fc1_b": 1, "fc2_w": 1,                           # fc1 splits its output, fc2 contracts it
}
_TOP_AXES = {"embed_tokens": 0, "project_in": 1, "project_out": 0}
# the arrays that split together, and the size that must tile tp for them to
_ATTN = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "out_w")
_FFN = ("fc1_w", "fc1_b", "fc2_w")


@dataclasses.dataclass(frozen=True)
class OptShard:
    """What ``models/opt.py`` needs of the split: the tp group, this rank's
    index and the tp size, which parts are split, and the vocabulary size."""

    group: Any
    size: int
    index: int
    attn: bool
    ffn: bool
    vocab: bool
    proj: bool
    vocab_size: int

    def vocab_range(self):
        return shard_range(self.vocab_size, self.size, self.index) if self.vocab else (0, self.vocab_size)


def _part(t, axis: int, tp: int, index: int):
    lo, hi = shard_range(t.shape[axis], tp, index)
    return t.narrow(axis, lo, hi - lo).contiguous()


def _slice(arr, axis, tp: int, index: int, sc_axis: str = "last"):
    """This rank's part of a weight along ``axis`` (None: the whole weight),
    plain or int8 ``{"q8", "sc"}``: the scales split where their axis is the
    weight's split one ("last": per-output-channel scales, the last axis;
    "first": per-row scales, the first; as ``_place`` places them)."""
    if axis is None:
        return arr
    if isinstance(arr, dict):
        q8, sc = arr["q8"], arr["sc"]
        follows = axis == 0 if sc_axis == "first" else axis == q8.dim() - 1
        return {"q8": _part(q8, axis, tp, index), "sc": _part(sc, sc.dim() - 1, tp, index) if follows else sc}
    return _part(arr, axis, tp, index)


def tp_opt_params(mesh, params, cfg):
    """This tp rank's part of an OPT parameter tree (plain or int8) of the
    config ``cfg``, with a ``"tp"`` entry (``OptShard``) that the model's
    functions read; the tree as it is without a tp axis.

    Divisibility: heads, ffn, vocabulary and hidden size must tile tp (true
    for every released OPT size at tp in {2, 4, 8}); otherwise that part
    (attention, MLP, embedding, projections) is replicated, with a note for
    each of its arrays, as in the JAX package."""
    tp = 1 if mesh is None else mesh.tp
    if tp <= 1:
        return params
    dim = lambda a, i: (a["q8"] if isinstance(a, dict) else a).shape[i]
    ok = {"attn": cfg.n_heads % tp == 0, "ffn": dim(params["blocks"]["fc1_w"], 2) % tp == 0,
          "vocab": dim(params["embed_tokens"], 0) % tp == 0,
          "proj": "project_in" in params and dim(params["project_in"], 1) % tp == 0}
    part_of = {**{n: "attn" for n in _ATTN}, **{n: "ffn" for n in _FFN}, "embed_tokens": "vocab",
               "project_in": "proj", "project_out": "proj"}

    def split(name, arr, axes, sc_axis="last"):
        axis = axes.get(name)
        if axis is not None and not ok[part_of[name]]:
            print(f"NOTE: tp_opt_params: {name} not divisible by tp={tp}; replicated")
            axis = None
        return _slice(arr, axis, tp, mesh.tp_rank, sc_axis)

    out = {name: split(name, arr, _TOP_AXES, "first" if name == "embed_tokens" else "last")
           for name, arr in params.items() if name != "blocks"}
    out["blocks"] = {name: split(name, arr, _BLOCK_AXES) for name, arr in params["blocks"].items()}
    out["tp"] = OptShard(mesh.tp_group, tp, mesh.tp_rank, ok["attn"], ok["ffn"], ok["vocab"], ok["proj"],
                         dim(params["embed_tokens"], 0))
    return out
