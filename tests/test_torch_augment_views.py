"""The port's device view generator (``rlcf_torch/data/augment.py``) against
``rlcf_tpu/data/augment.py`` on the CPU, on JAX's own draws (the split tree
of ``test_torch_augmix.py::_jax_draws``, ``k_hard`` included): every AugMix
op of ``_apply_op_batched`` at severities 1 and 2 and ``_planar_equalize``
equal; the crop's floats before rounding within 1e-4; the whole
``generate_views`` (augmix on, off, and the BYOL hard augmentation) within
1e-4 in normalised units on all but 0.1% of values and nowhere beyond 3 gray
levels (3/255 over the smallest CLIP std). Then the batching, the torch
sampler's distributions, and the API around the draws.

Each JAX pipeline compiles once per module (a module-scoped ``jax.jit``)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.data import augment as JA
from rlcf_torch.data import augment as TA
from rlcf_torch.data.transforms import CLIP_STD

from test_torch_augmix import _jax_draws
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

S, R, NV, N = 32, 16, 5, 2
SEED = 0
VALUE_TOL = 1e-4                                # normalised units
MAX_SHARE_OUTSIDE = 1e-3                        # of all values
MAX_DIFF = 3.0 / 255.0 / float(CLIP_STD.min())  # 3 gray levels, normalised


def _images(n=N, size=S, seed=SEED):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def _draws(keys, hard_aug=False, n_views=NV):
    ds = [_jax_draws(k, n_views, 0.08, hard_aug) for k in keys]
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in ds])) for k in ds[0]}


def _keys(n=N, seed=SEED):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_views(augmix, hard_aug, n_views=NV, res=R):
    fn = lambda img, key: JA.generate_views(img, key, n_views, res, augmix=augmix, hard_aug=hard_aug)
    return jax.jit(jax.vmap(fn))


@pytest.fixture(scope="module")
def jax_generators():
    return {cfg: _jax_views(*cfg) for cfg in ((True, False), (False, False), (False, True), (True, True))}


@pytest.mark.parametrize("augmix,hard_aug", [(True, False), (False, False), (False, True), (True, True)],
                         ids=["augmix", "no_augmix", "hard_aug", "augmix_hard_aug"])
def test_generate_views_matches_jax(jax_generators, augmix, hard_aug):
    imgs = _images()
    want = np.asarray(jax_generators[(augmix, hard_aug)](jnp.asarray(imgs), _keys()))
    got = TA.views_from_draws(torch.from_numpy(imgs), _draws(_keys(), hard_aug), resolution=R, augmix=augmix,
                              hard_aug=hard_aug).numpy()
    assert got.shape == want.shape == (N, NV, R, R, 3) and got.dtype == np.float32
    diff = np.abs(got - want)
    outside = int((diff > VALUE_TOL).sum())
    print(f"generate_views augmix={augmix} hard_aug={hard_aug}: {outside} of {diff.size} values outside "
          f"{VALUE_TOL}, max {diff.max():.3g}")
    assert outside <= MAX_SHARE_OUTSIDE * diff.size and diff.max() <= MAX_DIFF


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def _chain_input(v=12, size=S, seed=1):
    """Integer-valued planar views [v, 3, size, size]: smooth structure with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    base = np.stack([127 + 90 * np.sin(2 * np.pi * x / 9) * np.cos(2 * np.pi * y / 11), 40 + 180 * x / size,
                     210 - 150 * y / size])
    return np.clip(np.round(base[None] + rng.normal(0, 15, (v, 3, size, size))), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def jax_step():
    step = lambda sev: jax.jit(lambda x, o, lv, sg: JA._apply_op_batched(x, o, lv, sg, sev, S))
    return {sev: step(sev) for sev in (1.0, 2.0)}


@pytest.mark.parametrize("severity", [1.0, 2.0])
@pytest.mark.parametrize("op", range(9), ids=["autocontrast", "equalize", "posterize", "rotate", "solarize",
                                              "shear_x", "shear_y", "translate_x", "translate_y"])
def test_apply_op_batched_equals_jax(jax_step, op, severity):
    x = _chain_input(seed=op)
    rng = np.random.default_rng(100 + op)
    o = np.full(len(x), op, np.int32)
    lv, sg = rng.random(len(x), dtype=np.float32), rng.random(len(x), dtype=np.float32)
    want = np.asarray(jax_step[severity](jnp.asarray(x), o, lv, sg))
    got = TA._apply_op_batched(torch.from_numpy(x), torch.from_numpy(o), torch.from_numpy(lv), torch.from_numpy(sg),
                               severity, S).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_op_batched_passes_other_views_through():
    """A view whose op is none of 0-8 (the port's inactive chain step) is
    returned as it is, beside views that do run an op."""
    x = torch.from_numpy(_chain_input(v=3))
    out = TA._apply_op_batched(x, torch.tensor([-1, 3, -1]), torch.rand(3), torch.rand(3), 1.0, S)
    assert torch.equal(out[0], x[0]) and torch.equal(out[2], x[2])


def test_planar_equalize_equals_jax():
    x = _chain_input(v=6, seed=5)
    x[2, 1] = 9.0                         # a plane of one level: the identity LUT
    want = np.asarray(jax.jit(JA._planar_equalize)(jnp.asarray(x)))
    np.testing.assert_array_equal(TA._planar_equalize(torch.from_numpy(x)).numpy(), want)


@functools.lru_cache(maxsize=None)
def _jax_shift_blend(axis):
    return jax.jit(lambda a, b, c: JA._planar_shift_blend(a, b, c, 12, axis))


@pytest.mark.parametrize("delta,frac", [(-3, 0.25), (0, 0.0), (2, 0.75), (12, 0.5), (-12, 0.9)])
@pytest.mark.parametrize("axis", [2, 3])
def test_planar_shift_blend_equals_jax(delta, frac, axis):
    x = _chain_input(v=2, seed=7)
    shape = (2, 1, S, S)
    d = np.full(shape, delta, np.int32)
    f = np.full(shape, frac, np.float32)
    want = np.asarray(_jax_shift_blend(axis)(x, d, f))
    got = TA._planar_shift_blend(torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(f), 12, axis).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_boxes(key, n, size, crop_min=0.08):
    return JA._rrc_boxes(key, n, size, size, (crop_min, 1.0))


@pytest.mark.parametrize("out", [224, 336])
def test_crop_rounds_as_jax_at_the_cli_shapes(out):
    """63 views of a 256 px source at the CLIs' resolutions: rounded, the
    port's crops on JAX's boxes equal JAX's. This is the shape the crop's
    two parity accumulators (``_banded_product``) follow XLA's dot at; a
    plain float32 or float64 product rounds some of these values the other
    way."""
    src, n = 256, 63
    img = _images(1, src, seed=out)[0].astype(np.float32)
    key = jax.random.PRNGKey(out)
    want = np.asarray(jax.jit(lambda im, k: JA.batched_random_resized_crop_planar(im.transpose(2, 0, 1), k, n, out))(
        jnp.asarray(img), key))
    boxes = tuple(torch.from_numpy(np.array(b)) for b in jax.jit(lambda k: _jax_boxes(k, n, src))(key))
    got = TA.batched_random_resized_crop_planar(torch.from_numpy(img).permute(2, 0, 1), boxes, out).numpy()
    assert got.shape == want.shape == (n, 3, out, out)
    flips = int((np.round(got) != np.round(want)).sum())
    print(f"crop 256 -> {out} px, {n} views: {flips} of {got.size} values round differently, "
          f"{int((got != want).sum())} floats unequal")
    assert flips == 0


@pytest.mark.parametrize("src,out,n", [(32, 16, 8), (24, 40, 5)])
def test_crop_floats_before_rounding_within_1e_4(src, out, n):
    img = _images(1, src, seed=src)[0].astype(np.float32)
    key = jax.random.PRNGKey(src)
    want = np.asarray(jax.jit(lambda im, k: JA.batched_random_resized_crop_planar(im.transpose(2, 0, 1), k, n, out))(
        jnp.asarray(img), key))
    boxes = tuple(torch.from_numpy(np.array(b)) for b in jax.jit(lambda k: _jax_boxes(k, n, src))(key))
    got = TA.batched_random_resized_crop_planar(torch.from_numpy(img).permute(2, 0, 1), boxes, out).numpy()
    assert got.shape == want.shape == (n, 3, out, out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    wy = np.asarray(jax.jit(lambda t, h: JA._batched_resize_weights(src, out, t, h, jnp.float32))(
        *(jnp.asarray(b.numpy()) for b in (boxes[0], boxes[2]))))
    np.testing.assert_allclose(TA._batched_resize_weights(src, out, boxes[0], boxes[2]).numpy(), wy, rtol=0, atol=1e-6)


def test_random_resized_crop_nhwc_matches_jax():
    """``random_resized_crop`` draws its box and crops it;
    ``batched_random_resized_crop`` on JAX's box gives JAX's single crop."""
    img = _images(1, 40, seed=3)[0].astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda im, k: JA.random_resized_crop(im, k, 24))(jnp.asarray(img), key))
    boxes = tuple(torch.from_numpy(np.array(b)) for b in _jax_boxes(key, 1, 40))
    got = TA.batched_random_resized_crop(torch.from_numpy(img), boxes, 24)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mine = TA.random_resized_crop(torch.from_numpy(img), torch.Generator().manual_seed(4), 24)
    again = TA.random_resized_crop(torch.from_numpy(img), torch.Generator().manual_seed(4), 24)
    assert mine.shape == (24, 24, 3) and torch.equal(mine, again)


# ---------------------------------------------------------------------------
# batching, the draws, the generator's API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("augmix,hard_aug", [(True, False), (True, True)])
def test_group_equals_single_images_on_the_same_draws(augmix, hard_aug):
    imgs = torch.from_numpy(_images(2, 32, seed=11))
    draws = TA.draw_generator_randoms(torch.Generator().manual_seed(3), 2, 6, hard_aug=hard_aug)
    kw = dict(resolution=16, augmix=augmix, hard_aug=hard_aug)
    group = TA.views_from_draws(imgs, draws, **kw)
    for n in range(2):
        single = TA.views_from_draws(imgs[n:n + 1], {k: v[n:n + 1] for k, v in draws.items()}, **kw)
        assert torch.equal(group[n], single[0])
    gen = TA.make_view_generator(6, 16, augmix=augmix, hard_aug=hard_aug)
    assert torch.equal(gen(imgs, torch.Generator().manual_seed(3)), group)


def test_generate_views_draws_from_the_generator():
    img = torch.from_numpy(_images(1, 32, seed=12)[0])
    a = TA.generate_views(img, torch.Generator().manual_seed(7), 4, 16)
    b = TA.generate_views(img, torch.Generator().manual_seed(7), 4, 16)
    c = TA.generate_views(img, torch.Generator().manual_seed(8), 4, 16)
    assert a.shape == (4, 16, 16, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a[1:], c[1:]) and torch.equal(a[0], c[0])  # view 0: the base view


def _share(x, p):
    x = x.reshape(-1)
    n = x.numel()
    return abs(float((x < p).float().mean()) - p) <= 4 * math.sqrt(p * (1 - p) / n)


def test_sampler_distributions():
    """At a fixed seed: crop_min becomes 0.2 under hard_aug; the flip,
    jitter, gray and blur coins come up with the recipe's shares."""
    d = TA.draw_generator_randoms(torch.Generator().manual_seed(0), 64, 65, hard_aug=True)
    plain = TA.draw_generator_randoms(torch.Generator().manual_seed(0), 64, 65)
    assert float(d["ta"].min()) >= 0.2 and float(plain["ta"].min()) < 0.2
    assert "u_jitter" not in plain and d["u_jitter"].shape == (64, 64)
    for key, p in (("u_flip", 0.5), ("u_jitter", 0.5), ("u_gray", 0.2), ("u_blur", 0.1)):
        assert _share(d[key], p), key
    for key, lo, hi in (("b", 0.6, 1.4), ("c", 0.6, 1.4), ("s", 0.8, 1.2), ("h", -0.1, 0.1), ("sigma", 0.1, 2.0)):
        assert lo <= float(d[key].min()) and float(d[key].max()) < hi, key


def test_draw_order_is_fixed():
    """One generator, one order: the hard-aug draws follow every AugMix draw,
    so the AugMix draws of a hard-aug group are the plain sampler's at
    crop_min 0.2."""
    g = torch.Generator().manual_seed(5)
    d = TA.draw_generator_randoms(g, 2, 8, hard_aug=True)
    from rlcf_torch.ops.augmix import draw_view_randoms

    g2 = torch.Generator().manual_seed(5)
    plain = draw_view_randoms(g2, 2, 8, 0.2)
    hard = TA.draw_hard_aug_randoms(g2, 2, 8)
    for k, v in {**plain, **hard}.items():
        assert torch.equal(d[k], v), k
