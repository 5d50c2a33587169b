"""Host-side PIL AugMix view generator (reference-distribution parity mode):
the port of ``rlcf_tpu/data/augmix_host.py``, a copy that gives its views for
the same numpy seed.

A faithful reimplementation of the reference's augmentation stack
(`TPT/data/datautils.py:75-128`, `TPT/data/augmix_ops.py`) using PIL on the
host: RandomResizedCrop + HFlip pre-augment, 3 chains of 1-3 ops from the
9-op set with Dirichlet/Beta mixing, CLIP normalization. Use this when
sample-level distributional parity with the PyTorch pipeline matters more
than throughput; the device generator (`rlcf_torch/data/augment.py`) computes
the same distributions on device.

Also includes the "hard" BYOL-style recipe (`datautils.py:76-91`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from .transforms import CLIP_MEAN, CLIP_STD

IMAGE_SIZE = 224


def _sample_level(rng, n):
    return rng.uniform(0.1, n)


def _int_param(level, maxval):
    return int(level * maxval / 10)


def _float_param(level, maxval):
    return float(level) * maxval / 10.0


def _autocontrast(img, _l, _r):
    return ImageOps.autocontrast(img)


def _equalize(img, _l, _r):
    return ImageOps.equalize(img)


def _posterize(img, level, rng):
    return ImageOps.posterize(img, 4 - _int_param(_sample_level(rng, level), 4))


def _rotate(img, level, rng):
    deg = _int_param(_sample_level(rng, level), 30)
    if rng.uniform() > 0.5:
        deg = -deg
    return img.rotate(deg, resample=Image.BILINEAR)


def _solarize(img, level, rng):
    return ImageOps.solarize(img, 256 - _int_param(_sample_level(rng, level), 256))


def _shear_x(img, level, rng):
    lv = _float_param(_sample_level(rng, level), 0.3)
    if rng.uniform() > 0.5:
        lv = -lv
    return img.transform((IMAGE_SIZE, IMAGE_SIZE), Image.AFFINE, (1, lv, 0, 0, 1, 0), resample=Image.BILINEAR)


def _shear_y(img, level, rng):
    lv = _float_param(_sample_level(rng, level), 0.3)
    if rng.uniform() > 0.5:
        lv = -lv
    return img.transform((IMAGE_SIZE, IMAGE_SIZE), Image.AFFINE, (1, 0, 0, lv, 1, 0), resample=Image.BILINEAR)


def _translate_x(img, level, rng):
    lv = _int_param(_sample_level(rng, level), IMAGE_SIZE / 3)
    if rng.random() > 0.5:
        lv = -lv
    return img.transform((IMAGE_SIZE, IMAGE_SIZE), Image.AFFINE, (1, 0, lv, 0, 1, 0), resample=Image.BILINEAR)


def _translate_y(img, level, rng):
    lv = _int_param(_sample_level(rng, level), IMAGE_SIZE / 3)
    if rng.random() > 0.5:
        lv = -lv
    return img.transform((IMAGE_SIZE, IMAGE_SIZE), Image.AFFINE, (1, 0, 0, 0, 1, lv), resample=Image.BILINEAR)


AUGMENTATIONS = [_autocontrast, _equalize, _posterize, _rotate, _solarize, _shear_x, _shear_y, _translate_x, _translate_y]


def _random_resized_crop(img: Image.Image, rng, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> Image.Image:
    W, H = img.size
    area = W * H
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(log_r)
        w = int(round(math.sqrt(target * aspect)))
        h = int(round(math.sqrt(target / aspect)))
        if 0 < w <= W and 0 < h <= H:
            left = rng.integers(0, W - w + 1)
            top = rng.integers(0, H - h + 1)
            return img.resize((size, size), Image.BILINEAR, box=(left, top, left + w, top + h))
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(H * ratio[1])), H
    else:
        w, h = W, H
    left, top = (W - w) // 2, (H - h) // 2
    return img.resize((size, size), Image.BILINEAR, box=(left, top, left + w, top + h))


def _normalize(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def _base_view(img: Image.Image, size: int) -> Image.Image:
    W, H = img.size
    if W < H:
        img = img.resize((size, max(size, int(round(H * size / W)))), Image.BICUBIC)
    else:
        img = img.resize((max(size, int(round(W * size / H))), size), Image.BICUBIC)
    W, H = img.size
    left, top = (W - size) // 2, (H - size) // 2
    return img.crop((left, top, left + size, top + size))


def generate_views_host(
    image: np.ndarray,
    n_views: int,
    rng: Optional[np.random.Generator] = None,
    resolution: int = 224,
    augmix: bool = True,
    severity: float = 1.0,
    hard_aug: bool = False,
) -> np.ndarray:
    """uint8 HWC image -> [n_views, R, R, 3] float32 normalized views.

    View 0 is the resize+center-crop base view; the rest follow the AugMix
    recipe (`datautils.py:94-128`).
    """
    rng = rng or np.random.default_rng(0)
    pil = Image.fromarray(image)
    views = [_normalize(_base_view(pil, resolution))]
    for _ in range(n_views - 1):
        if hard_aug:
            x_orig = _random_resized_crop(pil, rng, resolution, scale=(0.2, 1.0))
            if rng.uniform() < 0.5:
                x_orig = ImageEnhance.Color(x_orig).enhance(1 + rng.uniform(-0.2, 0.2))
                x_orig = ImageEnhance.Brightness(x_orig).enhance(1 + rng.uniform(-0.4, 0.4))
                x_orig = ImageEnhance.Contrast(x_orig).enhance(1 + rng.uniform(-0.4, 0.4))
            if rng.uniform() < 0.2:
                x_orig = x_orig.convert("L").convert("RGB")
            if rng.uniform() < 0.1:
                x_orig = x_orig.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.1, 2.0)))
        else:
            x_orig = _random_resized_crop(pil, rng, resolution)
        if rng.uniform() < 0.5:
            x_orig = x_orig.transpose(Image.FLIP_LEFT_RIGHT)
        x_proc = _normalize(x_orig)
        if not augmix:
            views.append(x_proc)
            continue
        w = rng.dirichlet([1.0, 1.0, 1.0]).astype(np.float32)
        m = np.float32(rng.beta(1.0, 1.0))
        mix = np.zeros_like(x_proc)
        for chain in range(3):
            x_aug = x_orig.copy()
            for _ in range(rng.integers(1, 4)):
                op = AUGMENTATIONS[rng.integers(0, len(AUGMENTATIONS))]
                x_aug = op(x_aug, severity, rng)
            mix += w[chain] * _normalize(x_aug)
        views.append(m * x_proc + (1 - m) * mix)
    return np.stack(views)
