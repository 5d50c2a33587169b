"""Dataset loaders for the episode stream and zero-shot evaluation (the part
of ``rlcf_tpu/data/datasets.py`` the classification CLIs need): ImageFolder
layouts of ImageNet and its OOD variants, a synthetic set for runs without
data, the canonical-image and the preprocessed-batch iterators and a
background prefetcher.

Loaders expose ``__len__`` and ``__getitem__ -> (uint8 HWC image, label)``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

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
}

# The fine-grained sets the JAX package also runs (`rlcf_tpu/data/datasets.py:27-57`); their class
# names are here (assets/class_metadata.json), their loaders come with ROADMAP A17.
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


def build_dataset(set_id: str, data_root: str, corruption: str = "defocus_blur", level: str = "5",
                  n_classes: int = 10):
    """Resolve a dataset id to a loader (mirrors `TPT/data/datautils.py:42-72`
    for the ImageNet variants; ``n_classes`` sizes the synthetic set's labels)."""
    if set_id == "synthetic":
        return SyntheticDataset(n_classes=n_classes)
    if set_id == "I":
        return ImageFolderDataset(os.path.join(data_root, ID_TO_DIRNAME["I"], "val"))
    if set_id == "C":
        return ImageFolderDataset(os.path.join(data_root, ID_TO_DIRNAME["C"], corruption, level))
    if set_id in ID_TO_DIRNAME:
        return ImageFolderDataset(os.path.join(data_root, ID_TO_DIRNAME[set_id]))
    raise KeyError(f"unknown dataset id {set_id!r}; known: {['synthetic'] + sorted(ID_TO_DIRNAME)}")


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
