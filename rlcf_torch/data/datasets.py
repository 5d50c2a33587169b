"""Dataset loaders for the episode stream and zero-shot evaluation (the
counterpart of ``rlcf_tpu/data/datasets.py``): ImageFolder layouts of
ImageNet and its OOD variants, the Zhou-split JSON and FGVC-Aircraft layouts
of the ten fine-grained sets, Bongard-HOI tasks, a synthetic set for runs
without data, the canonical-image and the preprocessed-batch iterators and a
background prefetcher. ``build_dataset`` dispatches through the registry.

Loaders expose ``__len__`` and ``__getitem__ -> (uint8 HWC image, label)``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.registry import Registry
from .transforms import center_crop, load_image, preprocess_pil, resize_short_side_pil

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff")

# Dataset id -> directory name (the reference's `TPT/data/datautils.py:22-39`).
ID_TO_DIRNAME = {
    "I": "ImageNet",
    "A": "imagenet-a",
    "K": "ImageNet-Sketch",
    "R": "imagenet-r",
    "V": "imagenetv2-matched-frequency-format-val",
    "C": "imagenet-c",
    "flower102": "oxford_flowers",
    "dtd": "dtd",
    "pets": "oxford_pets",
    "cars": "stanford_cars",
    "ucf101": "ucf101",
    "caltech101": "caltech-101",
    "food101": "food-101",
    "sun397": "sun397",
    "aircraft": "fgvc_aircraft",
    "eurosat": "eurosat",
}

# Fine-grained: (image subdir, Zhou split json), `TPT/data/fewshot_datasets.py:51-70`.
JSON_SPLITS = {
    "flower102": ("jpg", "split_zhou_OxfordFlowers.json"),
    "food101": ("images", "split_zhou_Food101.json"),
    "dtd": ("images", "split_zhou_DescribableTextures.json"),
    "pets": ("images", "split_zhou_OxfordPets.json"),
    "sun397": ("SUN397", "split_zhou_SUN397.json"),
    "caltech101": ("101_ObjectCategories", "split_zhou_Caltech101.json"),
    "ucf101": ("UCF-101-midframes", "split_zhou_UCF101.json"),
    "cars": ("cars_test", "split_zhou_StanfordCars.json"),
    "eurosat": ("2750", "split_zhou_EuroSAT.json"),
}

# the ten fine-grained sets of `scripts/rlcf-prompt-fine.sh`
FINE_GRAINED_IDS = ("flower102", "dtd", "pets", "cars", "ucf101", "caltech101", "food101", "sun397", "aircraft",
                    "eurosat")


class ImageFolderDataset:
    """Directory-per-class layout; classes sorted by name (torchvision order)."""

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.samples: List[Tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            for dirpath, _, files in sorted(os.walk(os.path.join(root, cls))):
                for f in sorted(files):
                    if f.lower().endswith(IMAGE_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, f), label))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        return load_image(path), label


class JsonSplitDataset:
    """Zhou-split JSON dataset: {"train"|"val"|"test": [[path, label, name], ...]}.
    ``n_shot`` keeps that many samples of each class, drawn as the JAX
    package draws them (``random.seed(0)`` then ``random.sample`` per class)
    from a local ``random.Random(0)``, which leaves the global state alone."""

    def __init__(self, image_root: str, json_path: str, mode: str = "test", n_shot: Optional[int] = None):
        with open(json_path) as fh:
            samples = json.load(fh)[mode]
        self.image_root = image_root
        self.samples = [(s[0], int(s[1])) for s in samples]
        if n_shot is not None:
            by_class = {}
            for i, (_, label) in enumerate(self.samples):
                by_class.setdefault(label, []).append(i)
            keep = []
            for label in sorted(by_class):
                keep.extend(random.Random(0).sample(by_class[label], n_shot))
            self.samples = [self.samples[i] for i in keep]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Tuple[np.ndarray, int]:
        path, label = self.sample_ref(idx)
        return load_image(path), label

    def sample_ref(self, idx) -> Tuple[str, int]:
        rel, label = self.samples[idx]
        return os.path.join(self.image_root, rel), label


class AircraftDataset:
    """FGVC-Aircraft split from ``images_variant_{mode}.txt``
    (`TPT/data/fewshot_datasets.py:87`); classes in ``variants.txt`` file
    order, not sorted."""

    def __init__(self, root: str, mode: str = "test"):
        self.image_root = os.path.join(root, "images")
        with open(os.path.join(root, "variants.txt")) as fh:
            self.classes = [ln.strip() for ln in fh if ln.strip()]
        index = {v: i for i, v in enumerate(self.classes)}
        self.samples = []
        with open(os.path.join(root, f"images_variant_{mode}.txt")) as fh:
            for ln in fh:
                ln = ln.strip()
                if ln:
                    img_id, variant = ln.split(" ", 1)
                    self.samples.append((f"{img_id}.jpg", index[variant]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Tuple[np.ndarray, int]:
        path, label = self.sample_ref(idx)
        return load_image(path), label

    def sample_ref(self, idx) -> Tuple[str, int]:
        rel, label = self.samples[idx]
        return os.path.join(self.image_root, rel), label


class BongardHOIDataset:
    """Bongard-HOI few-shot tasks (`TPT/data/hoi_dataset.py:26-115`): each
    item is a task, its positive and negative support images, one query of
    each polarity and the text annotation, from
    ``data/bongard_splits/bongard_hoi_{mode}_{split}.json`` (entries
    ``[neg_samples, pos_samples, ..., annotation]``)."""

    def __init__(self, data_root: str, split: str = "unseen_obj_unseen_act", mode: str = "test"):
        self.data_root = data_root
        path = os.path.join(data_root, "data", "bongard_splits", f"bongard_hoi_{mode}_{split}.json")
        with open(path) as fh:
            items = json.load(fh)
        self.tasks = [{"neg_samples": [s["im_path"] for s in task[0]],
                       "pos_samples": [s["im_path"] for s in task[1]],
                       "annotation": task[-1].replace("++", " ")} for task in items]

    def __len__(self):
        return len(self.tasks)

    def resolve(self, rel_path: str) -> str:
        path = os.path.join(self.data_root, rel_path.replace("./", ""))
        if not os.path.isfile(path):
            # the published file lists occasionally point at the wrong split
            swap = path.replace("/val", "/train") if "/pic/image/val" in path else path.replace("/train", "/val")
            if os.path.isfile(swap):
                return swap
        return path

    def __getitem__(self, idx):
        task = self.tasks[idx]
        # the reference shuffles each polarity with a fixed seed before the
        # support/query split (`hoi_dataset.py:84-89`); a local Random(0)
        # gives the same shuffle without touching the global state
        rng = random.Random(0)
        pos, neg = list(task["pos_samples"]), list(task["neg_samples"])
        rng.shuffle(pos)
        rng.shuffle(neg)
        load = lambda rel: load_image(self.resolve(rel))
        return {"pos_support": [load(p) for p in pos[:-1]], "neg_support": [load(p) for p in neg[:-1]],
                "pos_query": load(pos[-1]), "neg_query": load(neg[-1]), "annotation": task["annotation"]}


class SyntheticDataset:
    """Deterministic random images for tests/benches without real data (the
    same images and labels as ``rlcf_tpu``'s for the same arguments)."""

    def __init__(self, n: int = 64, n_classes: int = 10, size: int = 256, seed: int = 0):
        self.n = n
        self.n_classes = n_classes
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        img = rng.integers(0, 256, size=(self.size, self.size, 3), dtype=np.uint8)
        return img, int(rng.integers(0, self.n_classes))


def _register_builders():
    """Register every dataset id with :class:`Registry`; ``build_dataset``
    dispatches through it, so other code can add a set without editing this
    module: ``Registry.register("dataset", "my_set")(lambda root, **kw: MySet(root))``."""
    if "synthetic" in Registry._stores.get("dataset", {}):  # module re-import
        return
    reg = lambda name: Registry.register("dataset", name)
    reg("synthetic")(lambda root, n_classes=10, **kw: SyntheticDataset(n_classes=n_classes))
    reg("I")(lambda root, **kw: ImageFolderDataset(os.path.join(root, ID_TO_DIRNAME["I"], "val")))
    for sid in ("A", "K", "R", "V"):
        reg(sid)(lambda root, _sid=sid, **kw: ImageFolderDataset(os.path.join(root, ID_TO_DIRNAME[_sid])))
    reg("C")(lambda root, corruption="defocus_blur", level="5", **kw: ImageFolderDataset(
        os.path.join(root, ID_TO_DIRNAME["C"], corruption, level)))
    reg("aircraft")(lambda root, mode="test", **kw: AircraftDataset(os.path.join(root, ID_TO_DIRNAME["aircraft"]),
                                                                    mode=mode))
    for sid, (subdir, split_json) in JSON_SPLITS.items():
        def _json_builder(root, mode="test", n_shot=None, _sid=sid, _sub=subdir, _json=split_json, **kw):
            base = os.path.join(root, ID_TO_DIRNAME[_sid])
            return JsonSplitDataset(os.path.join(base, _sub), os.path.join(base, _json), mode=mode, n_shot=n_shot)

        reg(sid)(_json_builder)
    reg("bongard_hoi")(lambda root, mode="test", split="unseen_obj_unseen_act", **kw: BongardHOIDataset(
        root, split=split, mode=mode))


_register_builders()


def build_dataset(set_id: str, data_root: str, mode: str = "test", n_shot: Optional[int] = None,
                  corruption: str = "defocus_blur", level: str = "5", n_classes: int = 10):
    """Resolve a dataset id to a loader through the registry (mirrors
    `TPT/data/datautils.py:42-72`); ``n_classes`` sizes the synthetic set's
    labels."""
    try:
        builder = Registry.get("dataset", set_id)
    except KeyError:
        raise KeyError(f"unknown dataset id {set_id!r}; known: {Registry.list('dataset')}") from None
    return builder(data_root, mode=mode, n_shot=n_shot, corruption=corruption, level=level, n_classes=n_classes)


def _order(n: int, shuffle: bool, seed: int, limit: Optional[int]) -> np.ndarray:
    """The (shuffle, seed, limit)-determined sample order of ``rlcf_tpu``'s iterators."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order if limit is None else order[:limit]


def iter_batches(
    dataset,
    batch_size: int,
    resolution: int = 224,
    shuffle: bool = True,
    seed: int = 0,
    limit: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images [B, R, R, 3] float32, CLIP-normalized; labels [B] int32)
    with the host's CLIP eval transform, for zero-shot evaluation."""
    order = _order(len(dataset), shuffle, seed, limit)
    for start in range(0, len(order), batch_size):
        samples = [dataset[int(i)] for i in order[start : start + batch_size]]
        yield (np.stack([preprocess_pil(img, resolution) for img, _ in samples]),
               np.array([label for _, label in samples], dtype=np.int32))


def iter_canonical(
    dataset,
    size: int = 256,
    shuffle: bool = True,
    seed: int = 0,
    limit: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (canonical [size, size, 3] u8, label) for the episode stream, in
    the (shuffle, seed, limit)-determined order of ``rlcf_tpu``'s iterator:
    bicubic short-side resize + center crop on the host."""
    for i in _order(len(dataset), shuffle, seed, limit):
        img, label = dataset[int(i)]
        yield center_crop(resize_short_side_pil(img, size), size), label


class PrefetchIterator:
    """Background-thread prefetch over any iterator: host-side decode
    overlaps device compute."""

    _END = object()

    def __init__(self, iterable, depth: int = 4):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as exc:  # propagate into the consumer
                self._err = exc
            finally:
                self._q.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
