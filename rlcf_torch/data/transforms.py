"""Image helpers and the CLIP normalization constants (the port of
``rlcf_tpu/data/transforms.py``): PIL decoding, the native decoder of
``data/native.py`` behind ``decode="native"``, and ``preprocess_device``, the
eval transform on the tensor's device.

With ``decode="native"`` a JPEG or PNG path is decoded, resized and cropped
in one C++ call; the files that call does not take (other containers, CMYK
or truncated JPEGs, bomb headers, arrays instead of paths) are decoded with
PIL, as the JAX package does, and counted in ``DECODE_COUNTS``. A library
built without its codecs raises instead (``native.require_decoder``).
"""

from __future__ import annotations

import collections
import os
import threading

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 HWC RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def resize_short_side_pil(img: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize so the short side equals ``size`` (host, PIL).

    An image already at the target size is returned as it is, which is what
    PIL's ``resize`` does for an unchanged size (so synthetic streams need no
    PIL)."""
    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = size, max(size, int(round(w * size / h)))
    else:
        new_h, new_w = max(size, int(round(h * size / w))), size
    if (new_h, new_w) == (h, w):
        return img
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((new_w, new_h), Image.BICUBIC))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top : top + size, left : left + size]


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> CLIP-normalized float32 HWC."""
    return (img.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def preprocess_pil(path_or_array, resolution: int = 224) -> np.ndarray:
    """The CLIP eval transform on the host: decode (a path; an array passes),
    bicubic short-side resize, center crop, normalize -> float32
    [resolution, resolution, 3]."""
    img = path_or_array if isinstance(path_or_array, np.ndarray) else load_image(path_or_array)
    return normalize(center_crop(resize_short_side_pil(img, resolution), resolution))


# images decoded under decode="native": by the native decoder, and by PIL
# (the files the native call does not take); reset and read by the CLIs
DECODE_COUNTS = collections.Counter()
_COUNT_LOCK = threading.Lock()


def _count(route: str):
    with _COUNT_LOCK:
        DECODE_COUNTS[route] += 1


def check_decode(decode: str):
    """Refuse an unknown decoder, and ``"native"`` when the library has no
    codecs (this builds the library, once, before any thread pool)."""
    if decode not in ("pil", "native"):
        raise ValueError(f"decode must be 'pil' or 'native', not {decode!r}")
    if decode == "native":
        from .native import require_decoder

        require_decoder()


def load_canonical(path, size: int):
    """Native file bytes -> the canonical [size, size, 3] u8 square (decode,
    bicubic short-side resize, center crop in one GIL-releasing C++ call;
    decode bit-identical to PIL, the resize within ~+-2 gray on ~0.03% of
    pixels), or None where the caller decodes with PIL: not a JPEG or PNG
    path, or a file the native decoder refuses. Needs a library with codecs
    (``check_decode("native")`` first)."""
    if not (isinstance(path, str) and path.lower().endswith((".jpg", ".jpeg", ".png"))):
        return None
    from .native import load_canonical_native

    with open(path, "rb") as fh:
        return load_canonical_native(fh.read(), size)


def canonical(path_or_array, size: int, decode: str = "pil") -> np.ndarray:
    """The canonical [size, size, 3] u8 square of an image (a path or an
    array): the native call under ``decode="native"``, else (and for the
    files it does not take) PIL's decode, resize and crop."""
    if decode == "native":
        arr = load_canonical(path_or_array, size)
        _count("pil" if arr is None else "native")
        if arr is not None:
            return arr
    img = path_or_array if isinstance(path_or_array, np.ndarray) else load_image(path_or_array)
    return center_crop(resize_short_side_pil(img, size), size)


def preprocess(path_or_array, resolution: int = 224, decode: str = "pil") -> np.ndarray:
    """``preprocess_pil``, or with ``decode="native"`` the native decode,
    resize and crop (``canonical``), then the normalization."""
    if decode == "native":
        return normalize(canonical(path_or_array, resolution, decode))
    return preprocess_pil(path_or_array, resolution)


def preprocess_many(items, resolution: int = 224, decode: str = "pil", workers: int = 0):
    """``preprocess`` over a list of paths or arrays, in order; under
    ``decode="native"`` on a pool of ``workers`` threads (0: up to 8, one a
    core), whose native calls run in parallel."""
    items = list(items)
    check_decode(decode)
    if decode != "native" or len(items) <= 1:
        return [preprocess(i, resolution, decode) for i in items]
    workers = workers or min(8, os.cpu_count() or 1)
    if workers <= 1:
        return [preprocess(i, resolution, decode) for i in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as ex:
        return list(ex.map(lambda i: preprocess(i, resolution, decode), items))


def preprocess_device(img, resolution: int = 224):
    """The eval transform on the tensor's device for a uint8 or float HWC
    image: bicubic short-side resize (``jax.image.resize``'s antialiased
    Keys a = -0.5 weights, ``ops/augmix.py::bicubic_matrix``, per axis),
    center crop, CLIP normalization -> float32 ``[resolution, resolution, 3]``.
    A uint8 image is scaled to [0, 1]; a float image is taken as it is."""
    import torch

    from ..ops.augmix import bicubic_matrix

    img = torch.as_tensor(img)
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    h, w = img.shape[0], img.shape[1]
    if h < w:
        new_h, new_w = resolution, int(round(w * resolution / h))
    else:
        new_h, new_w = int(round(h * resolution / w)), resolution
    wy = bicubic_matrix(h, new_h, device=img.device).double()
    wx = bicubic_matrix(w, new_w, device=img.device).double()
    img = torch.einsum("oh,hwc,pw->opc", wy, img.double(), wx).float()
    top, left = (new_h - resolution) // 2, (new_w - resolution) // 2
    img = img[top:top + resolution, left:left + resolution]
    mean = torch.as_tensor(CLIP_MEAN, device=img.device)
    std = torch.as_tensor(CLIP_STD, device=img.device)
    return (img - mean) / std
