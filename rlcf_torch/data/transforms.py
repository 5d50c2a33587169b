"""Host image helpers and the CLIP normalization constants (the part of
``rlcf_tpu/data/transforms.py`` the episode stream, zero-shot and retrieval
need; PIL decoding only)."""

from __future__ import annotations

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


def preprocess(path_or_array, resolution: int = 224, decode: str = "pil") -> np.ndarray:
    """``preprocess_pil``; ``decode="native"`` (the JAX package's C++ decoder)
    is not ported yet (ROADMAP A15), and the CLIs refuse it up front."""
    if decode != "pil":
        raise ValueError(f"decode {decode!r} is not ported yet; only 'pil' is (ROADMAP A15)")
    return preprocess_pil(path_or_array, resolution)


def preprocess_many(items, resolution: int = 224, decode: str = "pil"):
    """``preprocess`` over a list of paths or arrays, in order."""
    return [preprocess(i, resolution, decode) for i in items]
