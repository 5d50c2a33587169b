"""Sharded streaming store for precomputed caption-training features (a
copy of ``rlcf_tpu/data/sharded_embeddings.py``: framework-free; the manifest
and shard files are the same, so either package reads the other's).

The counterpart of the reference's LMDB extractor
(`caption/tools/extractor_lmdb.py:20-90`): bounded-memory writes and
bounded-memory epoch reads of COCO-scale extractions (~600k captions), as
npz shards plus a JSON manifest; the trainer reads them shard by shard
(shuffled shard order x in-shard permutation).

Layout (``base`` = manifest path without extension):
    <base>.manifest.json      {"shards": [...], "counts": [...], "keys": [...]}
    <base>.shard-0000.npz     arrays, first axis = captions in the shard
    <base>.shard-0001.npz     ...
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Sequence

import numpy as np

_MANIFEST_SUFFIX = ".manifest.json"


class ShardWriter:
    """Append dict-of-array chunks; flushes a shard every ``shard_size`` rows."""

    def __init__(self, base: str, shard_size: int = 50_000):
        if shard_size <= 0:
            raise ValueError("shard_size must be positive")
        self.base = base
        self.shard_size = shard_size
        self._buf: Dict[str, List[np.ndarray]] = {}
        self._buffered = 0
        self._shards: List[str] = []
        self._counts: List[int] = []
        self._keys: List[str] | None = None
        os.makedirs(os.path.dirname(os.path.abspath(base)) or ".", exist_ok=True)

    def append(self, chunk: Dict[str, np.ndarray]):
        keys = sorted(chunk)
        if self._keys is None:
            self._keys = keys
        elif keys != self._keys:
            raise ValueError(f"chunk keys {keys} != first chunk's {self._keys}")
        n = len(chunk[keys[0]])
        for k in keys:
            if len(chunk[k]) != n:
                raise ValueError(f"ragged chunk: {k} has {len(chunk[k])} rows, expected {n}")
            self._buf.setdefault(k, []).append(np.asarray(chunk[k]))
        self._buffered += n
        while self._buffered >= self.shard_size:
            self._flush(self.shard_size)

    def _flush(self, n_rows: int):
        if n_rows == 0:
            return
        assert self._keys is not None
        merged = {k: np.concatenate(self._buf[k], axis=0) for k in self._keys}
        out = {k: v[:n_rows] for k, v in merged.items()}
        rest = {k: v[n_rows:] for k, v in merged.items()}
        path = f"{self.base}.shard-{len(self._shards):04d}.npz"
        np.savez(path, **out)
        self._shards.append(os.path.basename(path))
        self._counts.append(n_rows)
        self._buf = {k: [v] for k, v in rest.items() if len(v)}
        if not self._buf:
            self._buf = {}
        self._buffered -= n_rows

    def close(self) -> str:
        """Flush the tail shard and write the manifest; returns manifest path."""
        self._flush(self._buffered)
        manifest = {
            "format": "rlcf_tpu-sharded-embeddings-v1",
            "shards": self._shards,
            "counts": self._counts,
            "keys": self._keys or [],
            "total": int(sum(self._counts)),
        }
        mpath = self.base + _MANIFEST_SUFFIX
        with open(mpath, "w") as fh:
            json.dump(manifest, fh)
        return mpath

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        return False


def is_sharded(path: str) -> bool:
    if path.endswith(_MANIFEST_SUFFIX) or os.path.exists(path + _MANIFEST_SUFFIX):
        return True
    # the extractor maps '--out feats.npz --shard_size N' to feats.manifest.json
    return path.endswith(".npz") and os.path.exists(path[:-4] + _MANIFEST_SUFFIX)


class ShardedEmbeddings:
    """Bounded-memory reader: one shard resident at a time."""

    def __init__(self, path: str):
        if path.endswith(_MANIFEST_SUFFIX):
            mpath = path
        else:
            base = path[:-4] if path.endswith(".npz") else path
            mpath = path + _MANIFEST_SUFFIX
            if not os.path.exists(mpath):
                mpath = base + _MANIFEST_SUFFIX
        with open(mpath) as fh:
            self.manifest = json.load(fh)
        self.root = os.path.dirname(os.path.abspath(mpath))
        self.keys: List[str] = list(self.manifest["keys"])
        self.counts: List[int] = list(self.manifest["counts"])
        self.total: int = int(self.manifest["total"])
        self._cache_idx: int | None = None
        self._cache: Dict[str, np.ndarray] | None = None

    def __len__(self) -> int:
        return self.total

    def load_shard(self, i: int) -> Dict[str, np.ndarray]:
        if self._cache_idx != i:
            with np.load(os.path.join(self.root, self.manifest["shards"][i]), allow_pickle=True) as z:
                self._cache = {k: z[k] for k in self.keys}
            self._cache_idx = i
        assert self._cache is not None
        return self._cache

    def column(self, key: str) -> np.ndarray:
        """Materialize one full column across shards (small columns only)."""
        return np.concatenate([self.load_shard(i)[key] for i in range(len(self.counts))], axis=0)

    def batches(
        self,
        batch_size: int,
        keys: Sequence[str],
        rng: np.random.Generator | None = None,
    ) -> Iterator[tuple]:
        """One epoch of batches holding ONE shard in memory at a time.

        Shuffling = shard-order permutation x in-shard permutation — the
        standard bounded-memory approximation of a global shuffle (each
        epoch reshuffles both levels from ``rng``). Rows past the last full
        batch of a shard spill into a small carry buffer joined with the
        next shard, so no data is lost across shard boundaries; the epoch's
        last partial batch is dropped, as the JAX package's default drops it.
        """
        order = rng.permutation(len(self.counts)) if rng is not None else np.arange(len(self.counts))
        carry: List[np.ndarray] | None = None
        for si in order:
            shard = self.load_shard(int(si))
            cols = [shard[k] for k in keys]
            perm = rng.permutation(len(cols[0])) if rng is not None else np.arange(len(cols[0]))
            cols = [c[perm] for c in cols]
            if carry is not None:
                cols = [np.concatenate([cc, c], axis=0) for cc, c in zip(carry, cols)]
            n_full = len(cols[0]) // batch_size * batch_size
            for s in range(0, n_full, batch_size):
                yield tuple(c[s : s + batch_size] for c in cols)
            carry = [c[n_full:].copy() for c in cols] if n_full < len(cols[0]) else None
