"""The port's dataset loaders against ``rlcf_tpu``'s on the same synthetic
trees: the ten fine-grained sets (Zhou-split JSON and FGVC-Aircraft) in each
mode, their samples, labels and order, the canonical images' bytes, the
``n_shot`` picks, the registry's messages and Bongard-HOI's tasks (exact
equality throughout)."""

import random

import numpy as np
import pytest

from rlcf_tpu.data import datasets as J
from rlcf_tpu.utils.registry import Registry as JRegistry
from rlcf_torch.data import datasets as T
from rlcf_torch.utils.registry import Registry as TRegistry

from torch_port_fixtures import chip_smoke, write_fine_grained_tree


def _refs(ds):
    return [ds.sample_ref(i) for i in range(len(ds))]


@pytest.mark.parametrize("set_id", T.FINE_GRAINED_IDS)
def test_fine_grained_loader_matches_jax(tmp_path, set_id):
    """Every mode: the same files, labels and order; the first images of the
    seeded stream decode to the same canonical bytes."""
    write_fine_grained_tree(tmp_path, set_id, n_classes=5)
    for mode in ("test", "val", "train"):
        jds = J.build_dataset(set_id, str(tmp_path), mode=mode)
        tds = T.build_dataset(set_id, str(tmp_path), mode=mode)
        assert type(tds).__name__ == type(jds).__name__
        assert _refs(tds) == _refs(jds) and len(tds) == len(jds) == (10 if mode == "test" else 5)
        if set_id == "aircraft":
            assert tds.classes == jds.classes and tds.classes != sorted(tds.classes)   # variants.txt order
        img, label = tds[3]
        jimg, jlabel = jds[3]
        np.testing.assert_array_equal(img, jimg)
        assert label == jlabel
    tstream = list(T.iter_canonical(tds, 64, seed=3, limit=4))
    jstream = list(J.iter_canonical(jds, 64, seed=3, limit=4))
    assert [lb for _, lb in tstream] == [lb for _, lb in jstream]
    for (a, _), (b, _) in zip(tstream, jstream):
        assert a.shape == (64, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("set_id", ["flower102", "cars", "sun397"])
def test_n_shot_picks_match_jax_and_leave_global_random_alone(tmp_path, set_id):
    write_fine_grained_tree(tmp_path, set_id, n_classes=4, per_class=5)
    random.seed(123)
    state = random.getstate()
    tds = T.build_dataset(set_id, str(tmp_path), n_shot=2)
    assert random.getstate() == state
    jds = J.build_dataset(set_id, str(tmp_path), n_shot=2)
    assert tds.samples == jds.samples and len(tds) == 8


def test_build_dataset_dispatches_every_id_through_the_registry(tmp_path):
    assert TRegistry.list("dataset") == JRegistry.list("dataset")
    assert set(T.FINE_GRAINED_IDS) <= set(TRegistry.list("dataset"))
    assert T.build_dataset("synthetic", ".", n_classes=7).n_classes == 7
    for build in (T.build_dataset, J.build_dataset):
        with pytest.raises(KeyError) as err:
            build("no_such_set", str(tmp_path))
        assert "unknown dataset id 'no_such_set'" in str(err.value)
    with pytest.raises(KeyError) as terr:
        T.build_dataset("no_such_set", ".")
    with pytest.raises(KeyError) as jerr:
        J.build_dataset("no_such_set", ".")
    assert str(terr.value) == str(jerr.value)


def test_registry_messages_match_jax():
    kind = "torch-port-test-kind"
    for reg in (TRegistry, JRegistry):
        reg.register(kind, "a")(len)
    for reg in (TRegistry, JRegistry):
        with pytest.raises(KeyError) as err:
            reg.register(kind, "a")(len)
        assert str(err.value) == "'torch-port-test-kind:a already registered'"
    with pytest.raises(KeyError) as terr:
        TRegistry.get(kind, "b")
    with pytest.raises(KeyError) as jerr:
        JRegistry.get(kind, "b")
    assert str(terr.value) == str(jerr.value) and "known: ['a']" in str(terr.value)
    assert TRegistry.get(kind, "a") is len and TRegistry.list(kind) == JRegistry.list(kind) == ["a"]
    assert TRegistry.list("no kind") == []


@pytest.mark.parametrize("swap", [False, True])
def test_bongard_tasks_match_jax(tmp_path, swap):
    """The same tasks (annotation, the seed-0 shuffle of each polarity,
    support and query images), the train/val swap of ``resolve`` included."""
    chip_smoke.write_bongard_tree(tmp_path, n_tasks=2, swap_split=swap)
    tds, jds = T.BongardHOIDataset(str(tmp_path)), J.BongardHOIDataset(str(tmp_path))
    assert len(tds) == len(jds) == 2 and tds.tasks == jds.tasks
    random.seed(5)
    state = random.getstate()
    tasks = [tds[i] for i in range(2)]
    assert random.getstate() == state   # the shuffle draws from a local Random(0)
    for i, t in enumerate(tasks):
        j = jds[i]
        assert t["annotation"] == j["annotation"] == f"ride horse_{i}"
        assert len(t["pos_support"]) == len(t["neg_support"]) == 6
        for key in ("pos_support", "neg_support"):
            for a, b in zip(t[key], j[key]):
                np.testing.assert_array_equal(a, b)
        for key in ("pos_query", "neg_query"):
            np.testing.assert_array_equal(t[key], j[key])
    if swap:
        rel = tds.tasks[0]["neg_samples"][0]
        assert "/pic/image/val/" in rel and "/pic/image/train/" in tds.resolve(rel)
        assert tds.resolve(rel) == jds.resolve(rel)
    assert T.build_dataset("bongard_hoi", str(tmp_path)).tasks == tds.tasks
