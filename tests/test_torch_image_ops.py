"""The port's single-image ops (``rlcf_torch/ops/image_ops.py``) and
``data/transforms.py::preprocess_device`` against ``rlcf_tpu`` on the CPU:
the integer ops exactly; the warps, the crop resize and the eval transform
within 1e-4 in the views' normalised units (gray / 255 / CLIP std: the warps'
and the crop's gray levels within ``TOL_GRAY``). The JAX functions take their
parameters as arguments of the jitted call, as the view generator passes
them (a closed-over constant lets XLA fold them into other arithmetic)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.data import transforms as JT
from rlcf_tpu.ops import image_ops as J
from rlcf_torch.data import transforms as TT
from rlcf_torch.ops import image_ops as T
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SIZES = (24, 40, 64)
TOL_GRAY = 1e-4 * 255.0 * float(TT.CLIP_STD.min())


def _img(size, seed=0, h=None):
    """A structured u8-valued float image [h, size, 3] with noise (so that
    every op has ranges, histograms and edges to act on)."""
    h = h or size
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:size].astype(np.float64)
    base = np.stack([127 + 90 * np.sin(2 * np.pi * x / 11) * np.cos(2 * np.pi * y / 13), 30 + 150 * x / size,
                     220 - 120 * y / h], axis=-1)
    return np.clip(np.round(base + rng.normal(0, 12, base.shape)), 0, 255).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jitted(name, static=()):
    return jax.jit(getattr(J, name), static_argnums=static)


def _jax(name, *args, static=()):
    """JAX's ``name`` jitted once per name (a compile per shape), the arrays
    as arguments."""
    return np.asarray(_jitted(name, static)(*[a if i in static else jnp.asarray(a) for i, a in enumerate(args)]))


def _torch(fn, img, *args):
    return fn(torch.from_numpy(img), *args).numpy()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["autocontrast", "equalize", "hflip"])
def test_integer_ops_equal(size, name):
    img = _img(size, seed=size)
    if name == "autocontrast":
        img = np.clip(img // 2 + 30, 0, 255)
    np.testing.assert_array_equal(_torch(getattr(T, name), img), _jax(name, img))


@pytest.mark.parametrize("size", SIZES)
def test_equalize_luts_equal(size):
    img = _img(size, seed=size + 1)
    img[..., 2] = 77.0          # a channel with one level: the identity LUT
    np.testing.assert_array_equal(_torch(T.equalize_luts, img), _jax("equalize_luts", img))
    np.testing.assert_array_equal(_torch(T.equalize, img), _jax("equalize", img))


@pytest.mark.parametrize("bits", [1, 2, 4, 7])
def test_posterize_equal(bits):
    img = _img(40, seed=bits)
    np.testing.assert_array_equal(_torch(T.posterize, img, bits), _jax("posterize", img, np.int32(bits)))


@pytest.mark.parametrize("threshold", [0, 64, 128, 231, 256])
def test_solarize_equal(threshold):
    img = _img(40, seed=threshold)
    np.testing.assert_array_equal(_torch(T.solarize, img, threshold), _jax("solarize", img, np.float32(threshold)))


WARPS = [("rotate", 5.0), ("rotate", -17.0), ("shear_x", 0.2), ("shear_x", -0.13), ("shear_y", 0.25),
         ("translate_x", 5.0), ("translate_x", -9.0), ("translate_y", 3.0), ("translate_y", -2.5)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name,level", WARPS, ids=[f"{n}{v}" for n, v in WARPS])
def test_warps_within_1e_4(size, name, level):
    img = _img(size, seed=size + 7)
    got = _torch(getattr(T, name), img, torch.tensor(level))
    want = _jax(name, img, np.float32(level))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRAY)


MATRICES = [(1.0, 0.1, 0.0, 0.0, 1.0, 0.0), (1.0, 0.0, 3.5, -0.08, 1.0, -2.0),
            (0.9994, 0.0349, -3.1, -0.0349, 0.9994, 4.2), (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("m", range(len(MATRICES)))
@pytest.mark.parametrize("fast", [False, True])
def test_affine_transforms_within_1e_4(size, m, fast):
    img = _img(size, seed=m)
    matrix = MATRICES[m]
    fn = "affine_transform_fast" if fast else "affine_transform"
    got = _torch(getattr(T, fn), img, tuple(torch.tensor(matrix, dtype=torch.float32)))
    want = _jax(fn, img, tuple(np.float32(matrix)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRAY)


@pytest.mark.parametrize("box", [(0.0, 0.0, 40.0, 40.0), (3.0, 5.0, 17.0, 29.0), (10.5, 2.25, 7.0, 30.0),
                                 (0.0, 8.0, 40.0, 12.0)])
@pytest.mark.parametrize("out", [16, 32, 57])
def test_crop_and_resize_within_1e_4(box, out):
    img = _img(40, seed=out)
    got = _torch(T.crop_and_resize, img, *torch.tensor(box), out)
    want = _jax("crop_and_resize", img, *np.float32(box), out, static=(5,))
    assert got.shape == want.shape == (out, out, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRAY)


_preprocess_jitted = jax.jit(JT.preprocess_device, static_argnums=(1,))


@pytest.mark.parametrize("h,w,res", [(48, 64, 32), (64, 40, 32), (30, 30, 24), (33, 57, 16), (40, 24, 32)])
@pytest.mark.parametrize("u8", [True, False])
def test_preprocess_device_within_1e_4(h, w, res, u8):
    img = _img(w, seed=h, h=h)
    img = img.astype(np.uint8) if u8 else img / 255.0
    got = TT.preprocess_device(torch.from_numpy(img), res).numpy()
    want = np.asarray(_preprocess_jitted(jnp.asarray(img), res))
    assert got.shape == want.shape == (res, res, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_histograms_count_with_scatter_add():
    """The equalize histograms are integer counts of a row's levels, as many
    as the row's pixels (no one-hot plane)."""
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(3, 1000)))
    hist = T.histograms(idx)
    assert hist.shape == (3, 256) and hist.dtype == torch.int64 and (hist.sum(dim=1) == 1000).all()
    for r in range(3):
        np.testing.assert_array_equal(hist[r].numpy(), np.bincount(idx[r].numpy(), minlength=256))
