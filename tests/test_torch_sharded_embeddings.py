"""The port's sharded feature store (``rlcf_torch/data/sharded_embeddings.py``)
against the JAX package's: the same shards and manifest from the same
chunks, each package reading the other's files, the same epoch batches in
the same order from the same numpy generator (shard order x in-shard
permutation, the carry across shards), and the same refusals."""

import json

import numpy as np
import pytest

from rlcf_tpu.data import sharded_embeddings as J
from rlcf_torch.data import sharded_embeddings as T


def _write(module, base, n=25, shard_size=10, chunk=7, dim=4):
    with module.ShardWriter(str(base), shard_size=shard_size) as w:
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            w.append({"emb": np.arange(s, s + m, dtype=np.float32)[:, None].repeat(dim, 1) + 0.5,
                      "tokens": np.arange(s, s + m, dtype=np.int32)[:, None].repeat(3, 1),
                      "captions": np.array([f"caption {i}" for i in range(s, s + m)], dtype=object)})
    return str(base) + ".manifest.json"


def test_writers_agree_and_read_across(tmp_path):
    """The same manifest and shard arrays from both writers; each reader
    takes the other's store (found from the ``.npz`` path the extractor was given)."""
    jm, tm = _write(J, tmp_path / "jax"), _write(T, tmp_path / "port")
    jman, tman = json.loads(open(jm).read()), json.loads(open(tm).read())
    assert [s.replace("jax", "port") for s in jman.pop("shards")] == tman.pop("shards")
    assert jman == tman and tman["counts"] == [10, 10, 5]
    for reader, path in ((T.ShardedEmbeddings, tmp_path / "jax.npz"), (J.ShardedEmbeddings, tmp_path / "port.npz")):
        assert T.is_sharded(str(path)) and J.is_sharded(str(path))
        r = reader(str(path))
        assert len(r) == 25
        np.testing.assert_array_equal(r.column("tokens")[:, 0], np.arange(25))
        assert list(r.column("captions")) == [f"caption {i}" for i in range(25)]


@pytest.mark.parametrize("batch", [4, 7, 9, 10])
def test_batches_match_jax(tmp_path, batch):
    """Two epochs from one generator each: the same batches in the same
    order as JAX's default (``drop_last``); rows carried across shards (a
    batch that does not divide 10 joins the next shard's rows), every row
    at most once, the epoch's partial tail dropped."""
    _write(T, tmp_path / "f", n=24, chunk=9)
    jr, tr = J.ShardedEmbeddings(str(tmp_path / "f")), T.ShardedEmbeddings(str(tmp_path / "f"))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        want = list(jr.batches(batch, ("emb", "tokens"), rng=jrng))
        got = list(tr.batches(batch, ("emb", "tokens"), rng=trng))
        assert len(got) == len(want)
        for (ge, gt), (we, wt) in zip(got, want):
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_array_equal(gt, wt)
        rows = np.concatenate([t[:, 0] for _, t in got])
        assert len(set(rows.tolist())) == len(rows) == 24 // batch * batch
    unshuffled = [t[:, 0].tolist() for _, t in tr.batches(7, ("emb", "tokens"))]
    assert unshuffled == [list(range(0, 7)), list(range(7, 14)), list(range(14, 21))]   # 10 + 4 carried, ...


def test_writer_refusals_match_jax(tmp_path):
    """Ragged chunks, changed keys and a shard size of 0 raise, as in JAX."""
    for module, name in ((J, "j"), (T, "t")):
        w = module.ShardWriter(str(tmp_path / name), shard_size=10)
        w.append({"a": np.zeros(3), "b": np.zeros(3)})
        with pytest.raises(ValueError, match="keys"):
            w.append({"a": np.zeros(3)})
        with pytest.raises(ValueError, match="ragged"):
            w.append({"a": np.zeros(3), "b": np.zeros(2)})
        with pytest.raises(ValueError, match="positive"):
            module.ShardWriter(str(tmp_path / (name + "0")), shard_size=0)
