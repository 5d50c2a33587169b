"""The port's AugMix view generator against ``rlcf_tpu/ops/pallas_augmix.py``
on the CPU: the bicubic matrix and tap windows, the parameter derivation on
JAX's own draws, the torch sampler's distributions, every single op, and the
whole view pipeline against ``_fused_call(interpret=True)``.

Interpret mode compiles once per shape (one module-scoped ``jax.jit`` with
the parameters as arguments), so every case after the first costs
milliseconds.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rlcf_tpu.ops import pallas_augmix as J
from rlcf_torch.ops import augmix as T

FIELDS = T.PARAM_FIELDS


def _jit_fused(R, S, V, shifts):
    return jax.jit(functools.partial(J._fused_call, R=R, S=S, V=V, shifts=shifts, interpret=True))


def _to_torch(params):
    return {k: torch.from_numpy(np.array(params[k])) for k in FIELDS}


def _smooth_img(size):
    """Smooth structured planar image (as ``tests/test_fused_augmix.py``)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    img = np.stack([127 + 90 * np.sin(2 * np.pi * x / 23) * np.cos(2 * np.pi * y / 31),
                    40 + 2.5 * x + 0.8 * y,
                    200 - 1.9 * y + 30 * np.sin(2 * np.pi * (x + y) / 41)])
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _noise_img(size, seed=7):
    return np.random.default_rng(seed).integers(0, 256, size=(3, size, size), dtype=np.uint8)


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(256, 224), (48, 32), (32, 32)])
def test_bicubic_matrix_matches_jax(src, dst):
    want = np.asarray(J._bicubic_matrix(src, dst))
    got = T.bicubic_matrix(src, dst).numpy()
    assert got.shape == want.shape == (dst, src)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("severity", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("R", [32, 224])
def test_op_shift_bounds_match_jax(severity, R):
    assert T.op_shift_bounds(severity, R) == J._op_shift_bounds(severity, R)


def _jax_draws(rng, n_views, crop_min, hard_aug=False):
    """The draws of ``sample_view_params`` under its own split tree (that of
    ``rlcf_tpu/data/augment.py::generate_views``); with ``hard_aug`` also
    ``_hard_aug_batched``'s from ``k_hard`` (its ninth key is never used)
    and crop_min raised to 0.2, as ``generate_views`` does."""
    V = n_views - 1
    if hard_aug:
        crop_min = max(crop_min, 0.2)
    k_crop, k_flip, k_chain, k_m, k_w, k_hard = jax.random.split(rng, 6)
    k_area, k_ratio, k_top, k_left = jax.random.split(k_crop, 4)
    ratio = (3.0 / 4.0, 4.0 / 3.0)
    k_depth, k_ops, k_lv, k_sg = jax.random.split(k_chain, 4)
    draws = {
        "ta": jax.random.uniform(k_area, (V, 10), minval=crop_min, maxval=1.0),
        "lr": jax.random.uniform(k_ratio, (V, 10), minval=np.log(ratio[0]), maxval=np.log(ratio[1])),
        "u_top": jax.random.uniform(k_top, (V,)),
        "u_left": jax.random.uniform(k_left, (V,)),
        "u_flip": jax.random.uniform(k_flip, (V,)),
        "depths": jax.random.randint(k_depth, (3, V), 1, 4),
        "op_idx": jax.random.randint(k_ops, (3, 3, V), 0, 9),
        "u_level": jax.random.uniform(k_lv, (3, 3, V)),
        "u_sign": jax.random.uniform(k_sg, (3, 3, V)),
        "e_w": jax.random.exponential(k_w, (V, 3)),
        "m": jax.random.uniform(k_m, (V,)),
    }
    if hard_aug:
        ks = jax.random.split(k_hard, 9)
        u = lambda k, lo=0.0, hi=1.0: jax.random.uniform(k, (V,), minval=lo, maxval=hi)
        draws.update(u_jitter=u(ks[0]), b=u(ks[1], 0.6, 1.4), c=u(ks[2], 0.6, 1.4), s=u(ks[3], 0.8, 1.2),
                     h=u(ks[4], -0.1, 0.1), u_gray=u(ks[5]), u_blur=u(ks[6]), sigma=u(ks[7], 0.1, 2.0))
    return draws


@pytest.mark.parametrize("augmix,severity,crop_min,src,res", [(True, 1.0, 0.08, 256, 224), (True, 2.0, 0.08, 48, 32),
                                                               (False, 1.0, 0.5, 96, 64)])
def test_derive_view_params_on_jax_draws(augmix, severity, crop_min, src, res):
    n_views = 65
    rngs = [jax.random.PRNGKey(s) for s in (3, 17)]
    want = [J.sample_view_params(r, n_views, src, res, augmix, severity, crop_min) for r in rngs]
    draws = [_jax_draws(r, n_views, crop_min) for r in rngs]
    randoms = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]}
    got = T.derive_view_params(randoms, src_size=src, resolution=res, augmix=augmix, severity=severity)
    for k in FIELDS:
        w = np.stack([np.asarray(p[k]) for p in want])
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if k in ("p0", "p1", "wm"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_draw_view_randoms_matches_jax_distribution():
    """A torch.Generator cannot replay JAX's stream: compare distributions."""
    n_img, n_views, S = 64, 65, 256
    tp = T.sample_view_params(torch.Generator().manual_seed(0), n_img, n_views, S, 224)
    keys = jax.random.split(jax.random.PRNGKey(0), n_img)
    jp = jax.jit(jax.vmap(lambda k: J.sample_view_params(k, n_views, S, 224, True, 1.0, 0.08)))(keys)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    tp = {k: v.numpy() for k, v in tp.items()}
    for p in (tp, jp):  # row 0 is always the base view
        assert (p["depth"][:, 0] == 0).all() and (p["m"][:, 0] == 1).all() and (p["wm"][:, 0] == 0).all()
    area = lambda p: (p["rrc"][:, 1:, 2] * p["rrc"][:, 1:, 3]).ravel() / S**2
    for name, f in (("area", area), ("m", lambda p: p["m"][:, 1:].ravel()), ("wm0", lambda p: p["wm"][:, 1:, 0].ravel())):
        assert stats.ks_2samp(f(tp), f(jp)).pvalue > 1e-3, name
    for name, values, k in (("depth", tp["depth"][:, 1:].ravel() - 1, 3), ("ops", tp["ops"][:, 1:].ravel(), 9)):
        counts = np.bincount(values, minlength=k)
        n, p = values.size, 1.0 / k
        assert counts.size == k and (np.abs(counts - n * p) <= 4 * math.sqrt(n * p * (1 - p))).all(), (name, counts)


# ---------------------------------------------------------------------------
# single ops at the identity crop, against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

OP_R = 32
# windows wider than severity 2 needs at R=32 (1, 2, 2, 2): taps then span
# 2-3 chunks of ``_warp_pass``'s 5-tap sums, so every summation case occurs
OP_SHIFTS = (5, 4, 5, 4)


def _rot(deg):
    theta = -np.deg2rad(np.float32(deg))
    return float(np.tan(np.float32(theta) / 2)), float(-np.sin(np.float32(theta)))


def _op_cases():
    cases = [("autocontrast", 0, 0.0, 0.0, 0), ("equalize", 1, 0.0, 0.0, 0)]
    cases += [(f"posterize{b}", 2, 0.0, 0.0, (0xFF00 >> b) & 0xFF) for b in (1, 2, 3, 4)]
    cases += [(f"solarize{t}", 4, float(t), 0.0, 0) for t in (128, 231, 256)]
    cases += [(f"rotate{d}", 3, *_rot(d), 0) for d in (1, -1, 3, -3, 6, -6)]
    cases += [(f"shear{x}{s}", op, s, 0.0, 0) for op, x in ((5, "x"), (6, "y"))
              for s in (0.05, -0.05, 0.013, -0.06, 0.15, -0.15)]
    cases += [(f"translate{x}{s}", op, float(s), 0.0, 0) for op, x in ((7, "x"), (8, "y")) for s in (1, -1, 2, -2)]
    return cases


OP_CASES = _op_cases()


def _op_params(cases, n_img):
    """One view per case after the base view, identity crop, m = 0, one step."""
    V = 1 + len(cases)
    z = lambda *s, dt=np.float32: np.zeros(s, dt)
    p = {"rrc": np.tile(np.float32([0, 0, OP_R, OP_R]), (V, 1)), "flip": z(V, dt=np.int32),
         "depth": z(V, 3, dt=np.int32), "ops": z(V, 9, dt=np.int32), "p0": z(V, 9), "p1": z(V, 9),
         "ip0": z(V, 9, dt=np.int32), "wm": z(V, 3), "m": z(V)}
    p["m"][0] = 1.0
    for v, (_, op, q0, q1, qi) in enumerate(cases, start=1):
        p["depth"][v, 0], p["ops"][v, 0], p["p0"][v, 0], p["p1"][v, 0], p["ip0"][v, 0] = 1, op, q0, q1, qi
        p["wm"][v, 0] = 1.0
    return {k: np.concatenate([a] * n_img) for k, a in p.items()}


@pytest.fixture(scope="module")
def single_op_outputs():
    imgs = np.stack([_smooth_img(OP_R), _noise_img(OP_R)])
    V = 1 + len(OP_CASES)
    params = _op_params(OP_CASES, len(imgs))
    basew = np.eye(OP_R, dtype=np.float32)
    want = np.asarray(_jit_fused(OP_R, OP_R, V, OP_SHIFTS)(jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in params.items()},
                                                          jnp.asarray(basew)))
    got = T.augmix_views_reference(torch.from_numpy(imgs), _to_torch(params), torch.from_numpy(basew), OP_R, OP_R, V,
                                   OP_SHIFTS).numpy()
    return got, want


@pytest.mark.parametrize("case", range(len(OP_CASES)), ids=[c[0] for c in OP_CASES])
def test_single_op_equals_pallas_interpret(single_op_outputs, case):
    got, want = single_op_outputs
    v = case + 1
    np.testing.assert_array_equal(got[:, 0], want[:, 0])  # the base view passes through
    d = np.abs(got[:, v].astype(int) - want[:, v].astype(int))
    assert d.max() == 0, (OP_CASES[case][0], int(d.max()), int((d > 0).sum()))


# ---------------------------------------------------------------------------
# the whole view pipeline on JAX's sampled parameters
# ---------------------------------------------------------------------------

PIPE_S, PIPE_R, PIPE_V, PIPE_N = 48, 32, 8, 2
PIPE_SHIFTS = J._op_shift_bounds(1.0, PIPE_R)


@pytest.fixture(scope="module")
def pipeline_call():
    return _jit_fused(PIPE_R, PIPE_S, PIPE_V, PIPE_SHIFTS)


@pytest.mark.parametrize("augmix", [True, False])
def test_pipeline_matches_pallas_interpret(pipeline_call, augmix):
    """Same sources, same parameters (JAX's), same base matrix. XLA sums the
    crop's dot products in float32 in its own order, the plain version sums
    them exactly, so a value within an ulp of .5 may round the other way:
    augmix off, at most 1 gray; augmix on (the ops carry such a pixel along
    their chain), at least 99% of pixels equal."""
    imgs = np.stack([_noise_img(PIPE_S, 1), _smooth_img(PIPE_S)])
    basew = J._bicubic_matrix(PIPE_S, PIPE_R)
    equal = total = 0
    for seed in range(3):
        keys = jax.random.split(jax.random.PRNGKey(seed), PIPE_N)
        p = jax.vmap(lambda k: J.sample_view_params(k, PIPE_V, PIPE_S, PIPE_R, augmix, 1.0, 0.08))(keys)
        flat = {k: v.reshape((PIPE_N * PIPE_V,) + v.shape[2:]) for k, v in p.items()}
        want = np.asarray(pipeline_call(jnp.asarray(imgs), flat, basew))
        got = T.augmix_views_reference(torch.from_numpy(imgs), _to_torch(flat), torch.from_numpy(np.array(basew)),
                                       PIPE_R, PIPE_S, PIPE_V, PIPE_SHIFTS).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        if not augmix:
            assert d.max() <= 1, int(d.max())
        equal += int((d == 0).sum())
        total += d.size
    assert equal / total >= 0.99, equal / total


def test_patchify_matches_jax():
    views = np.random.default_rng(0).integers(0, 256, size=(2, 3, 3, 32, 32), dtype=np.uint8)
    for p in (16, 8):
        np.testing.assert_array_equal(T.patchify_planar_u8(torch.from_numpy(views), p).numpy(),
                                      np.asarray(J.patchify_planar_u8(jnp.asarray(views), p)))


def test_fused_views_on_cpu_is_the_plain_version():
    """``fused_views`` on a CPU tensor: the sampler on the caller's generator,
    the plain version, and tokens that are patchifications of the views."""
    imgs = torch.from_numpy(np.stack([_noise_img(PIPE_S, 2)]))
    kw = dict(n_views=4, resolution=PIPE_R, src_size=PIPE_S)
    views = T.fused_views(imgs, torch.Generator().manual_seed(5), **kw)
    ptoks, rtoks = T.fused_views(imgs, torch.Generator().manual_seed(5), p_policy=16, p_reward=8, **kw)
    params = T.flatten_params(T.sample_view_params(torch.Generator().manual_seed(5), 1, 4, PIPE_S, PIPE_R))
    want = T.augmix_views_reference(imgs, params, T.bicubic_matrix(PIPE_S, PIPE_R), PIPE_R, PIPE_S, 4,
                                    T.op_shift_bounds(1.0, PIPE_R))
    assert views.shape == (1, 4, 3, PIPE_R, PIPE_R) and views.dtype == torch.uint8
    assert torch.equal(views, want)
    assert torch.equal(ptoks, T.patchify_planar_u8(views, 16)) and torch.equal(rtoks, T.patchify_planar_u8(views, 8))


def test_kernel_layout_fits_two_ctas_an_sm_at_the_flagship():
    """The kernel's design holds two CTAs an SM at R=224, S=256 (two u8
    planes and tables, ~109 KB each); one CTA at most 227 KB."""
    sm_bytes, per_cta = 233472, 1024   # an H100 SM's shared memory; what each resident CTA also takes
    assert T.shared_bytes(224, 256) == 108944
    assert sm_bytes // (T.shared_bytes(224, 256) + per_cta) == 2
    assert T.shared_bytes(223, 255) <= T.shared_bytes(224, 256)   # rows padded to 4 bytes, not more
    assert T.shared_bytes(480, 512) > T.MAX_SHARED_BYTES


@pytest.mark.parametrize("R,S", [(224, 256), (223, 255), (64, 64), (32, 48), (8, 256)])
def test_kernel_layout_holds_planes_tables_and_strip(R, S):
    """Shared memory holds two padded u8 planes, and the first holds the
    crop's tables and the second its float64 strip of at least one row, at
    every shape (a small R with a large S needs more than two planes)."""
    r4 = -(-R // 4) * 4
    tables = 2 * 8 * R * T._TAPS + 2 * 16 * R + 4 * R
    rest = 2 * 16 * R + 256 * 4 + 256 + 2 * (T._THREADS // 32) * 4 + 16
    planes = T.shared_bytes(R, S) - rest
    assert planes >= 2 * R * r4 and planes >= max(R * r4, tables) + 8 * (-(-S // 4) * 4)


@pytest.mark.parametrize("R", [336, 384, 448])
def test_kernel_layout_keeps_one_plane_on_chip_above_330(R):
    """The 336, 384 and 448 px towers' views (S = 256, the CLIs' sources):
    two planes do not fit a CTA, so the kernel keeps one u8 plane in shared
    memory, the crop's tables and a float64 strip of at least one row behind
    them, and its second plane in the device scratch (three planes a view and
    channel there); the flagship's 224 px keeps both planes on chip."""
    r4 = -(-R // 4) * 4
    tables = 2 * 8 * R * T._TAPS + 2 * 16 * R + 4 * R
    rest = 2 * 16 * R + 256 * 4 + 256 + 2 * (T._THREADS // 32) * 4 + 16
    assert T.large_layout(R, 256) and not T.large_layout(224, 256) and not T.large_layout(320, 256)
    assert 2 * R * r4 + rest > T.MAX_SHARED_BYTES >= T.shared_bytes(R, 256)
    assert T.shared_bytes(R, 256) - rest >= max(R * r4, tables + 8 * 256)
    assert T.keep_bytes(1, 64, R) == 64 * 3 * 3 * R * r4


def test_keep_buffer_is_two_u8_planes_per_view():
    """The device scratch: the first two chains' u8 results, half the f32 mix
    buffer of the first design (154 MB at a flagship group)."""
    assert T.keep_bytes(4, 64, 224) == 4 * 64 * 3 * 2 * 224 * 224
    assert T.keep_bytes(4, 64, 224) * 2 == 4 * 64 * 3 * 224 * 224 * 4
    assert T.keep_bytes(1, 1, 223) == 3 * 2 * 223 * 224


def test_augmix_views_dispatch_and_checks():
    """A CPU tensor takes the plain version (no launch is counted); the
    kernel's wrapper refuses a CPU tensor."""
    imgs = torch.from_numpy(_noise_img(PIPE_S)[None])
    params = T.flatten_params(T.sample_view_params(torch.Generator().manual_seed(1), 1, 2, PIPE_S, PIPE_R))
    basew = T.bicubic_matrix(PIPE_S, PIPE_R)
    T.reset_launch_counts()
    out = T.augmix_views(imgs, params, basew, PIPE_R, PIPE_S, 2, PIPE_SHIFTS)
    assert out.shape == (1, 2, 3, PIPE_R, PIPE_R) and T.LAUNCHES["augmix"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.launch_views(imgs, params, basew, PIPE_R, PIPE_S, 2, PIPE_SHIFTS)
