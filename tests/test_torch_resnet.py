"""The port's ModifiedResNet towers against the JAX package's, on the CPU:
the same parameters (one random OpenAI-format state dict, read by the JAX
package's converter and its pytree carried across, or read by both
converters) and the same inputs, made with numpy from a seed.

Tolerances:
- fp32: 1e-5 absolute + 1e-5 relative (same math, other summation orders);
- bf16, whole tower: relative L2 error 2**-7 (one bf16 rounding step). The
  two frameworks round a bf16 convolution's sums at other places, so one
  element can differ by an ulp early on and the difference propagates
  through the later layers; each op on equal inputs is held tighter below;
- ``avg_pool`` in bf16: bit for bit (sum in fp32, cast, divide, as JAX does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_tpu.models import convert as JV
from rlcf_tpu.models import layers as JL
from rlcf_torch.models import clip as TC
from rlcf_torch.models import convert as TV
from rlcf_torch.models import layers as TL

from torch_port_fixtures import jax_params_numpy, openai_state_dict

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 2**-7
NAMES = ["test-tiny-rn", "rn-deeper"]


def _cfgs(name):
    """``test-tiny-rn`` (one bottleneck a group, width 16) and a deeper,
    narrower tower (2, 1, 2, 1 bottlenecks, width 8), in both packages."""
    if name == "test-tiny-rn":
        return JC.get_config(name), TC.get_config(name)
    args = (name, 32, 64, (2, 1, 2, 1), 8, None, 64, 1)
    return JC.ClipConfig(*args, vocab_size=512), TC.ClipConfig(*args, vocab_size=512)


def _params(name, seed, dtype=np.float32):
    """(jax cfg, port cfg, JAX params, the port's params carried across)
    from one random OpenAI-format state dict (non-trivial BatchNorm
    statistics); ``dtype`` the towers' (running statistics stay fp32)."""
    jcfg, tcfg = _cfgs(name)
    jp, _ = JV.convert_clip_state_dict(openai_state_dict(tcfg, seed=seed), dtype=dtype)
    return jcfg, tcfg, jp, TV.from_jax_params(jax_params_numpy(jp), tcfg)


def _images(seed, n=3, res=64):
    return np.random.default_rng(seed).normal(size=(n, res, res, 3)).astype(np.float32)


def _nchw(a, dtype=torch.float32):
    """NHWC numpy -> NCHW tensor in the channels_last memory format (the port's layout)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", NAMES)
def test_encode_image_fp32_matches_jax(name):
    jcfg, tcfg, jp, tp = _params(name, 0)
    for seed in (0, 1):
        x = _images(seed)
        want = np.asarray(JC.encode_image(jp, jcfg, jnp.asarray(x)))
        got = TC.encode_image(tp, tcfg, torch.from_numpy(x))
        assert got.shape == (3, jcfg.embed_dim)
        np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("name", NAMES)
def test_encode_image_bf16_matches_jax(name):
    jcfg, tcfg, jp, tp = _params(name, 1, dtype=jnp.bfloat16)
    assert tp["visual"]["stem"]["conv1_w"].dtype == torch.bfloat16
    assert tp["visual"]["stem"]["bn1"]["mean"].dtype == torch.float32   # running statistics stay fp32
    for seed in (0, 1, 2):
        x = _images(seed)
        want = np.asarray(JC.encode_image(jp, jcfg, jnp.asarray(x)).astype(jnp.float32))
        got = TC.encode_image(tp, tcfg, torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
        assert _rel_l2(got.float().numpy(), want) <= BF16_REL_L2


@pytest.mark.parametrize("size", [8, 9])
def test_avg_pool_bf16_bit_equal_to_jax(size):
    """The window's sum in fp32, cast to bf16, then divided in bf16 (two
    roundings), as JAX's ``avg_pool``; an odd size drops the last row and
    column (VALID)."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 16)).astype(np.float32) * 7
    want = np.asarray(JL.avg_pool(jnp.asarray(x, jnp.bfloat16), 2).astype(jnp.float32))
    got = TL.avg_pool(_nchw(x, torch.bfloat16), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_allclose(_nhwc(TL.avg_pool(_nchw(x), 2)), np.asarray(JL.avg_pool(jnp.asarray(x), 2)), **FP32)


def _bn_params(rng, c):
    return {"w": (1 + 0.1 * rng.normal(size=c)).astype(np.float32), "b": (0.1 * rng.normal(size=c)).astype(np.float32),
            "mean": rng.normal(size=c).astype(np.float32), "var": (0.5 + rng.random(c)).astype(np.float32)}


@pytest.mark.parametrize("prior", [None, 0.5, 0.9])
def test_batch_norm_2d_matches_jax(prior):
    """Running statistics, or with ``prior`` mixed with the batch's own
    (population variance)."""
    rng = np.random.default_rng(3)
    p = _bn_params(rng, 16)
    x = (2 + 3 * rng.normal(size=(4, 5, 5, 16))).astype(np.float32)
    want = np.asarray(JL.batch_norm_2d(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, prior=prior))
    got = TL.batch_norm_2d(_nchw(x), {k: torch.from_numpy(v) for k, v in p.items()}, prior=prior)
    np.testing.assert_allclose(_nhwc(got), want, **FP32)


def test_batch_norm_2d_prior_uses_population_variance():
    """``prior=0`` is the batch's own statistics, with ddof 0: zero mean and
    unit population variance per channel."""
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v) for k, v in _bn_params(rng, 8).items()}
    p["w"], p["b"] = torch.ones(8), torch.zeros(8)
    y = TL.batch_norm_2d(_nchw((1 + 2 * rng.normal(size=(3, 4, 4, 8))).astype(np.float32)), p, prior=0.0)
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(8), rtol=0, atol=1e-5)
    torch.testing.assert_close(y.var(dim=(0, 2, 3), correction=0), torch.ones(8), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_pool_matches_jax(dtype):
    """The dense attention pool on one feature map: fp32 within FP32; bf16
    on equal inputs within one bf16 rounding of the output (2**-7)."""
    jcfg, tcfg, jp, tp = _params("test-tiny-rn", 2, dtype=getattr(jnp, dtype))
    x = np.random.default_rng(5).normal(size=(3, 2, 2, 512)).astype(np.float32)
    want = np.asarray(JC._attention_pool(jnp.asarray(x, getattr(jnp, dtype)), jp["visual"]["attnpool"],
                                         jcfg.vision_heads).astype(jnp.float32))
    got = TC._attention_pool(_nchw(x, getattr(torch, dtype)), tp["visual"]["attnpool"], tcfg.vision_heads)
    tol = FP32 if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("g,stride", [(0, 1), (1, 2)])
def test_bottleneck_matches_jax(g, stride):
    """A group's first bottleneck: the downsampling shortcut, and the average
    pool where it strides (``stride = 1 if b > 0 or g == 0 else 2``)."""
    jcfg, tcfg, jp, tp = _params("test-tiny-rn", 4)
    width = 16 if g == 0 else 64
    x = np.random.default_rng(g).normal(size=(2, 8, 8, width)).astype(np.float32)
    want = np.asarray(JC._bottleneck(jnp.asarray(x), jp["visual"]["groups"][g][0], stride))
    got = TC._bottleneck(_nchw(x), tp["visual"]["groups"][g][0], stride)
    assert got.shape[2] == 8 // stride
    np.testing.assert_allclose(_nhwc(got), want, **FP32)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_converter_and_arch_inference(name):
    """One OpenAI-format ResNet state dict through both converters: the same
    inferred config, the port's params equal to the JAX params carried across
    (kernels OIHW channels_last, running statistics fp32), equal features."""
    _, tcfg = _cfgs(name)
    sd = openai_state_dict(tcfg, seed=7)
    jp, jcfg = JV.convert_clip_state_dict(sd)
    tp, got_cfg = TV.convert_clip_state_dict(sd)
    for field in ("embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
                  "text_width", "text_layers", "context_length", "vocab_size"):
        assert getattr(got_cfg, field) == getattr(jcfg, field) == getattr(tcfg, field), field
    assert TC.infer_arch_from_state_dict({k: tuple(v.shape) for k, v in sd.items()}) == got_cfg
    carried = TV.from_jax_params(jax_params_numpy(jp), got_cfg)
    w = tp["visual"]["groups"][0][0]["conv2_w"]
    assert w.shape == carried["visual"]["groups"][0][0]["conv2_w"].shape == (tcfg.vision_width,) * 2 + (3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(carried)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    x = _images(8)
    np.testing.assert_allclose(TC.encode_image(tp, got_cfg, torch.from_numpy(x)).numpy(),
                               np.asarray(JC.encode_image(jp, jcfg, jnp.asarray(x))), **FP32)


def test_random_init_has_the_jax_tree():
    """The port's random ResNet parameters have the JAX package's tree, every
    kernel in the port's layout (HWIO -> OIHW), BatchNorm at the identity."""
    jcfg, tcfg = _cfgs("rn-deeper")
    jp = jax.eval_shape(lambda k: JC.init_clip_params(k, jcfg), jax.random.PRNGKey(0))
    tp = TC.init_clip_params(tcfg, seed=0)
    jl, jdef = jax.tree_util.tree_flatten_with_path(jp["visual"])
    tl, tdef = jax.tree_util.tree_flatten_with_path(tp["visual"])
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        key = jax.tree_util.keystr(path)
        want = (j.shape[3], j.shape[2], j.shape[0], j.shape[1]) if "conv" in key and key.endswith("_w']") else j.shape
        assert tuple(t.shape) == tuple(want), key
    bn = tp["visual"]["stem"]["bn1"]
    assert bool((bn["var"] == 1).all()) and bool((bn["mean"] == 0).all()) and bn["var"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64", "test-tiny-rn"])
def test_resnet_configs_match_jax(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert j == JC.ClipConfig(*[getattr(t, f) for f in t.__dataclass_fields__])
    assert t.vision_heads == t.vision_width * 32 // 64 and not t.is_vit
