"""The CLIP block's fused pointwise ops (``rlcf_torch/ops/block_ops.py``).

On the CPU: each op's plain path and the CPU implementation of its custom op
equal, bit for bit, the composition of stock ops the port ran before the
kernels (bf16 and fp32), forward and gradients, for a whole residual block
too; the backward formulas the kernels mirror agree with autograd in float64
(``gradcheck``) with shared, per-episode and stride-0 expanded weights; weight
gradients are computed only where asked for; the ops' fake implementations
survive a capture (``utils/export.py``) and the capture runs.

On the card (marked ``cuda``; they skip where there is none; run with
``python -m pytest --noconftest tests/test_torch_block_ops.py -m cuda -q``):
each kernel against its plain version at the prompt-TTA cell's shapes in the
working dtype, and the launch counters. Tolerances there (``_within``,
``_close_sums``): a few roundings, in the working dtype, of the magnitudes a
value is computed from; the kernels round once where the plain block also
rounds its intermediate sums.
"""

import pytest
import torch

from rlcf_torch.models import layers as L
from rlcf_torch.ops import block_ops as B

D, N, ROWS = 64, 3, 5


# ---------------------------------------------------------------------------
# The port's block before the kernels: stock ops, as ``models/layers.py`` had them
# ---------------------------------------------------------------------------


def _per_episode0(v, x):
    return v.reshape(v.shape[:1] + (1,) * (x.dim() - v.dim()) + v.shape[1:])


def layer_norm0(x, weight, bias, eps: float = 1e-5):
    if weight.dim() == 2:
        weight, bias = _per_episode0(weight, x), _per_episode0(bias, x)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def quick_gelu0(x):
    return x * torch.sigmoid(1.702 * x)


def linear0(x, w, b=None):
    dt = torch.promote_types(x.dtype, w.dtype)
    if w.dim() == 3 and w.stride(0) != 0:
        y = torch.matmul(x.to(dt).reshape(x.shape[0], -1, x.shape[-1]), w.to(dt))
        y = y.reshape(x.shape[:-1] + w.shape[-1:]).to(x.dtype)
    else:
        y = torch.matmul(x.to(dt), (w[0] if w.dim() == 3 else w).to(dt)).to(x.dtype)
    if b is not None:
        y = y + (_per_episode0(b, y) if b.dim() == 2 else b).to(x.dtype)
    return y


def residual_block0(x, p, n_heads):
    o = L.attention_core(linear0(layer_norm0(x, p["ln1_w"], p["ln1_b"]), p["qkv_w"], p["qkv_b"]), n_heads)
    x = x + linear0(o, p["out_w"], p["out_b"])
    h = layer_norm0(x, p["ln2_w"], p["ln2_b"])
    return x + linear0(quick_gelu0(linear0(h, p["fc_w"], p["fc_b"])), p["proj_w"], p["proj_b"])


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _weights(kind, gen, dtype, *shift, grad=False):
    """A weight ``[D]`` (``shared``), ``[N, D]`` (``per_episode``) or ``[D]``
    expanded to ``[N, D]`` (``expanded``, stride 0); the leaf and the tensor
    passed."""
    shape = (N, D) if kind == "per_episode" else (D,)
    leaf = (torch.randn(shape, generator=gen) * 0.5 + (shift[0] if shift else 0)).to(dtype).requires_grad_(grad)
    return leaf, (leaf.expand(N, D) if kind == "expanded" else leaf)


def _acts(gen, dtype, *, grad=False, n=3):
    return [torch.randn(N, ROWS, D, generator=gen).to(dtype).requires_grad_(grad) for _ in range(n)]


DTYPES = [torch.bfloat16, torch.float32]
KINDS = ["shared", "per_episode", "expanded"]


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# CPU: the plain path is the stock composition, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_ops_equal_the_stock_composition(dtype, kind):
    gen = torch.Generator().manual_seed(1)
    x, a, _ = _acts(gen, dtype)
    (_, w), (_, b), (_, ab) = (_weights(kind, gen, dtype, s) for s in (1.0, 0.0, 0.0))
    want_ln = layer_norm0(x, w, b)
    _bits_equal(B.layer_norm(x, w, b), want_ln)
    _bits_equal(torch.ops.rlcf.layer_norm(x, w, b, 1e-5)[0], want_ln)
    y0 = x + (a + (_per_episode0(ab, a) if ab.dim() == 2 else ab).to(dtype))
    for got in (B.add_layer_norm(x, a, ab, w, b), torch.ops.rlcf.add_layer_norm(x, a, ab, w, b, 1e-5)[:2]):
        _bits_equal(got[0], y0)
        _bits_equal(got[1], layer_norm0(y0, w, b))
    u0 = a + (_per_episode0(ab, a) if ab.dim() == 2 else ab).to(dtype)
    _bits_equal(B.bias_quick_gelu(a, ab), quick_gelu0(u0))
    _bits_equal(torch.ops.rlcf.bias_quick_gelu(a, ab), quick_gelu0(u0))
    _bits_equal(B.bias_residual(x, a, ab), x + u0)
    _bits_equal(torch.ops.rlcf.bias_residual(x, a, ab), x + u0)


def _block_params(gen, dtype, per_episode, grad):
    p = {k: v[0] for k, v in L.init_transformer_blocks(gen, 1, D).items()}
    p = {k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in p.items()}   # no zero biases, no unit weights
    if per_episode:
        p = {k: v.expand(N, *v.shape) + 0.05 * torch.randn((N,) + v.shape, generator=gen) for k, v in p.items()}
    return {k: v.to(dtype).requires_grad_(grad) for k, v in p.items()}


@pytest.mark.parametrize("per_episode", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_block_equals_the_stock_composition(dtype, per_episode):
    """The block's CPU forward and every gradient (input and weights) are the
    stock composition's, bit for bit."""
    gen = torch.Generator().manual_seed(2)
    p = _block_params(gen, dtype, per_episode, grad=True)
    x = torch.randn(N, 7, D, generator=gen).to(dtype).requires_grad_(True)
    r = torch.randn(N, 7, D, generator=gen)
    outs, grads = [], []
    for block in (lambda x, p: L.residual_block(x, p, 2), lambda x, p: residual_block0(x, p, 2)):
        out = block(x, p)
        outs.append(out)
        grads.append(torch.autograd.grad((out.float() * r).sum(), [x, *p.values()]))
    _bits_equal(outs[0], outs[1])
    for g0, g1 in zip(*grads):
        _bits_equal(g0, g1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_with_remat_equals_the_stock_composition(dtype):
    gen = torch.Generator().manual_seed(3)
    blocks = {k: v.to(dtype).requires_grad_(True) for k, v in L.init_transformer_blocks(gen, 2, D).items()}
    x = torch.randn(4, 6, D, generator=gen).to(dtype).requires_grad_(True)
    want = x
    for layer in range(2):
        want = residual_block0(want, {k: v[layer] for k, v in blocks.items()}, 2)
    gw = torch.autograd.grad(want.float().sum(), [x, blocks["ln1_w"], blocks["fc_b"]])
    for remat in (False, True, "save_attn"):
        got = L.transformer(x, blocks, 2, remat=remat)
        _bits_equal(got, want)
        for g0, g1 in zip(torch.autograd.grad(got.float().sum(), [x, blocks["ln1_w"], blocks["fc_b"]]), gw):
            _bits_equal(g0, g1)


# ---------------------------------------------------------------------------
# CPU: the backward formulas the kernels mirror, against autograd in float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_layer_norm_backward_gradcheck(kind):
    gen = torch.Generator().manual_seed(4)
    (x,) = _acts(gen, torch.float64, grad=True, n=1)
    (w0, _), (b0, _) = _weights(kind, gen, torch.float64, 1.0, grad=True), _weights(kind, gen, torch.float64, grad=True)
    expand = (lambda t: t.expand(N, D)) if kind == "expanded" else (lambda t: t)
    fn = lambda x, w, b: torch.ops.rlcf.layer_norm(x, expand(w), expand(b), 1e-5)[0]
    assert torch.autograd.gradcheck(fn, (x, w0, b0))


@pytest.mark.parametrize("kind", KINDS)
def test_add_layer_norm_backward_gradcheck(kind):
    """Both outputs' gradients: ``y`` (the residual stream) and ``LN(y)``."""
    gen = torch.Generator().manual_seed(5)
    x, a = _acts(gen, torch.float64, grad=True, n=2)
    w0, b0, ab0 = (_weights(kind, gen, torch.float64, s, grad=True)[0] for s in (1.0, 0.0, 0.0))
    expand = (lambda t: t.expand(N, D)) if kind == "expanded" else (lambda t: t)
    fn = lambda x, a, ab, w, b: torch.ops.rlcf.add_layer_norm(x, a, expand(ab), expand(w), expand(b), 1e-5)[:2]
    assert torch.autograd.gradcheck(fn, (x, a, ab0, w0, b0))


@pytest.mark.parametrize("kind", KINDS)
def test_bias_ops_backward_gradcheck(kind):
    gen = torch.Generator().manual_seed(6)
    x, a = _acts(gen, torch.float64, grad=True, n=2)
    (bias0, _) = _weights(kind, gen, torch.float64, grad=True)
    expand = (lambda t: t.expand(N, D)) if kind == "expanded" else (lambda t: t)
    assert torch.autograd.gradcheck(lambda a, b: torch.ops.rlcf.bias_quick_gelu(a, expand(b)), (a, bias0))
    assert torch.autograd.gradcheck(lambda x, a, b: torch.ops.rlcf.bias_residual(x, a, expand(b)), (x, a, bias0))


def test_weight_gradients_only_where_asked():
    """The backward ops return the weight gradients only when asked, and
    autograd asks only for weights that need them."""
    gen = torch.Generator().manual_seed(7)
    x, g, gy = _acts(gen, torch.float32)
    (_, w), (_, ab) = _weights("per_episode", gen, torch.float32, 1.0), _weights("shared", gen, torch.float32)
    out, stats = torch.ops.rlcf.layer_norm(x, w, w, 1e-5)
    assert stats.shape == (2,) + x.shape[:-1] and stats.dtype == torch.float32
    assert len(torch.ops.rlcf.layer_norm_bwd(x, g, None, stats, w, None, False)) == 1
    assert len(torch.ops.rlcf.layer_norm_bwd(x, g, gy, stats, w, None, True)) == 3
    got = torch.ops.rlcf.layer_norm_bwd(x, g, gy, stats, w, ab, True)
    assert [t.shape for t in got] == [x.shape, w.shape, w.shape, ab.shape]
    assert len(torch.ops.rlcf.bias_quick_gelu_bwd(x, ab, g, False)) == 1
    assert [t.shape for t in torch.ops.rlcf.bias_quick_gelu_bwd(x, ab, g, True)] == [x.shape, ab.shape]

    calls = []
    real = B._layer_norm_bwd_op

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    B._layer_norm_bwd_op = spy
    try:
        for w_grad in (False, True):
            x1 = x.clone().requires_grad_(True)
            w1, b1 = w.clone().requires_grad_(w_grad), torch.zeros_like(w).requires_grad_(w_grad)
            torch.ops.rlcf.layer_norm(x1, w1, b1, 1e-5)[0].sum().backward()
            assert (w1.grad is not None) == w_grad and (b1.grad is not None) == w_grad and x1.grad is not None
    finally:
        B._layer_norm_bwd_op = real
    assert calls == [False, True]


def test_plain_weight_gradients_match_autograd_in_fp32():
    """The column sums of the plain backward (what the kernels' partial sums
    and ordered reduction compute) are autograd's weight gradients."""
    gen = torch.Generator().manual_seed(8)
    x, a = _acts(gen, torch.float32, grad=True, n=2)
    w, b, ab = (_weights("per_episode", gen, torch.float32, s, grad=True)[1] for s in (1.0, 0.0, 0.0))
    y, h = B.add_layer_norm_plain(x, a, ab, w, b)
    r1, r2 = torch.randn(y.shape, generator=gen), torch.randn(h.shape, generator=gen)
    want = torch.autograd.grad((y * r1).sum() + (h * r2).sum(), [x, w, b, ab])
    _, stats = B.layer_norm_stats_plain(y, w, b)
    dx, dw, db, dab = B.layer_norm_bwd_plain(y.detach(), r2, r1, stats, w, ab, True)
    for got, ref in zip((dx, dw, db, dab), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_fake_implementations_survive_export():
    """A forward and backward through every op captured by the serving export
    (``make_fx`` over fake tensors, then ``torch.export``): the ops are nodes
    of the program, which runs and equals the eager call."""
    from rlcf_torch.utils.export import deserialize_call, export_serving

    def fn(x, a, w, b, bias):
        y, h, _ = torch.ops.rlcf.add_layer_norm(x, a, bias, w, b, 1e-5)
        out = torch.ops.rlcf.bias_residual(y, torch.ops.rlcf.bias_quick_gelu(h, bias), bias)
        out = torch.ops.rlcf.layer_norm(out, w, b, 1e-5)[0]
        return (out,) + torch.autograd.grad(out.sum(), [x, a, w, bias])

    gen = torch.Generator().manual_seed(9)
    x, a = _acts(gen, torch.float32, grad=True, n=2)
    w, b, bias = (_weights("per_episode", gen, torch.float32, s, grad=True)[1] for s in (1.0, 0.0, 0.0))
    args = (x, a, w, b, bias)
    data = export_serving(fn, args)
    from rlcf_torch.utils.export import deserialize_program

    code = deserialize_program(data).graph_module.code
    for op in ("layer_norm", "add_layer_norm", "bias_quick_gelu", "bias_residual", "layer_norm_bwd",
               "bias_quick_gelu_bwd", "bias_grad"):
        assert f"rlcf.{op}." in code, op
    got = deserialize_call(data)(*[t.detach() for t in args])
    for g0, g1 in zip(got, fn(*args)):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)


def test_column_layout_covers_every_row_and_column():
    for d, v, rpe, n in ((512, 8, 12800, 1), (2048, 8, 12800, 1), (768, 8, 50432, 1), (1024, 8, 6168, 1),
                         (3072, 4, 6, 64), (4096, 8, 3, 24), (64, 1, 7, 3), (5, 1, 1, 1)):
        bx, by, tiles, ctas, chunk = B.column_layout(d, v, rpe, n)
        assert bx % 32 == 0 and bx * by <= B.COL_THREADS and tiles * bx * v >= d > (tiles - 1) * bx * v
        assert ctas * chunk >= rpe > (ctas - 1) * chunk and chunk >= by
        assert ctas <= 65535


def test_launchers_refuse_tensors_off_the_card():
    """The kernels' launchers raise on tensors off the card, before any
    build (the plain versions serve those through the public functions)."""
    x = torch.zeros(2, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        B.launch_layer_norm(x, torch.ones(D), torch.zeros(D), 1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        B.launch_bias_residual(x, x, torch.zeros(D))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (what, leading shape, D, hidden): the prompt-TTA cell's text, policy and reward towers
CELL_SHAPES = [("text", (800, 16), 512, 2048), ("policy", (256, 197), 768, 3072), ("reward", (24, 257), 1024, 4096)]


def _within(got, want, scale, dtype, terms):
    """``|got - want| <= terms * u * scale`` elementwise, ``scale`` the
    magnitude of the terms a value is computed from and ``u`` the working
    dtype's rounding unit (bf16 2**-8; fp32 2**-20, the fp32 sums' order):
    ``terms`` roundings of values of that size apart."""
    u = 2**-8 if dtype == torch.bfloat16 else 2**-20
    err = (got.float() - want.float()).abs()
    bound = terms * u * scale.float() + 1e-6
    assert bool(torch.isfinite(got).all()) and bool((err <= bound).all()), float((err / bound).max())


def _close_sums(got, want, dtype):
    """Column sums over up to 50k rows: 2**-6 (bf16: each summed term and the
    result rounded) or 1e-3 (fp32: the order of the sums) of the largest."""
    scale = float(want.float().abs().max()) or 1.0
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= (2**-6 if dtype == torch.bfloat16 else 1e-3), err


def _ln_scale(x, w, b, stats):
    """The size of the terms of LN(x): ``|xhat w| + |b|``."""
    per = (lambda t: B.per_episode(t, x)) if w.dim() == 2 else (lambda t: t)
    xh = (x.float() - stats[0].unsqueeze(-1)) * stats[1].unsqueeze(-1)
    return (xh * per(w).float()).abs() + per(b).float().abs()


def _check_ops(x, a, g, gy, w, b, ab, u, gu, fb, dtype):
    """Every kernel against its plain version on these inputs. The plain
    block rounds its intermediate sums (a bias of another dtype, ``a +
    bias``, QuickGELU's three steps) where the kernels keep fp32, so those
    checks allow a rounding of the terms' size on each and one for the
    kernel's result; the LayerNorms and the backward formulas round once on
    both sides and are held to two."""
    y, h, stats = B.launch_layer_norm(x, w, b, 1e-5, a, ab)
    y0, _ = B.add_layer_norm_plain(x, a, ab, w, b)
    sum_scale = x.float().abs() + a.float().abs() + (B.per_episode(ab, a) if ab.dim() == 2 else ab).float().abs()
    _within(y, y0, sum_scale, dtype, 4)
    h0, stats0 = B.layer_norm_stats_plain(y, w, b)
    _within(h, h0, _ln_scale(y, w, b, stats0), dtype, 2)
    torch.testing.assert_close(stats, stats0, rtol=1e-5, atol=1e-5)
    hx0, statsx = B.layer_norm_stats_plain(x, w, b)
    _within(B.launch_layer_norm(x, w, b, 1e-5)[1], hx0, _ln_scale(x, w, b, statsx), dtype, 2)
    got = B.launch_layer_norm_bwd(y, g, gy, stats, w, ab, True)
    want = B.layer_norm_bwd_plain(y, g, gy, stats, w, ab, True)
    w32 = (B.per_episode(w, y) if w.dim() == 2 else w).float()
    xh = (y.float() - stats[0].unsqueeze(-1)) * stats[1].unsqueeze(-1)
    gw = g.float() * w32
    dx_scale = stats[1].unsqueeze(-1) * (gw.abs() + gw.mean(-1, keepdim=True).abs()
                                         + xh.abs() * (gw * xh).mean(-1, keepdim=True).abs()) + gy.float().abs()
    _within(got[0], want[0], dx_scale, dtype, 2)
    for s0, s1 in zip(got[1:], want[1:]):
        assert s0.shape == s1.shape and s0.dtype == s1.dtype
        _close_sums(s0, s1, dtype)
    fb32 = (B.per_episode(fb, u) if fb.dim() == 2 else fb).float()
    u32 = u.float() + fb32
    _within(B.launch_bias_quick_gelu(u, fb), B.bias_quick_gelu_plain(u, fb), u.float().abs() + fb32.abs(), dtype, 4)
    got = B.launch_bias_quick_gelu_bwd(u, fb, gu, True)
    want = B.bias_quick_gelu_bwd_plain(u, fb, gu, True)
    _within(got[0], want[0], gu.float().abs() * (1 + u32.abs()), dtype, 2)
    _close_sums(got[1], want[1], dtype)
    _within(B.launch_bias_residual(x, a, ab), B.bias_residual_plain(x, a, ab), sum_scale, dtype, 4)
    _close_sums(B.launch_bias_grad(g, ab), B.column_sum_plain(g, ab), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what,lead,d,hidden", CELL_SHAPES)
def test_kernels_match_plain_at_cell_shapes(dev, what, lead, d, hidden, dtype):
    gen = torch.Generator(device=dev).manual_seed(d)
    x, a, g, gy = (torch.randn(*lead, d, device=dev, generator=gen).to(dtype) for _ in range(4))
    w, b, ab = (torch.randn(d, device=dev, generator=gen).to(dtype) * 0.5 + s for s in (1.0, 0.0, 0.0))
    u, gu = (torch.randn(*lead, hidden, device=dev, generator=gen).to(dtype) for _ in range(2))
    fb = torch.randn(hidden, device=dev, generator=gen).to(dtype) * 0.1
    _check_ops(x, a, g, gy, w, b, ab, u, gu, fb, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("d", [64, 40, 768, 1600])
def test_kernels_match_plain_per_episode_and_odd_widths(dev, kind, dtype, wdtype, d):
    """Per-episode and expanded weights, weights in another dtype, a width
    the 16-byte vectors do not divide (40: one element a thread) and one
    above 1024 (GPT-2 XL's 1600)."""
    gen = torch.Generator(device=dev).manual_seed(d + 7)
    x, a, g, gy = (torch.randn(N, 9, d, device=dev, generator=gen).to(dtype) for _ in range(4))
    shape = (N, d) if kind == "per_episode" else (d,)
    w, b, ab = (torch.randn(shape, device=dev, generator=gen).to(wdtype) * 0.5 + s for s in (1.0, 0.0, 0.0))
    if kind == "expanded":
        w, b, ab = (t.expand(N, d) for t in (w, b, ab))
    _check_ops(x, a, g, gy, w, b, ab, x, g, ab, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["shared", "per_episode"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [2560, 4096, 9216, 2050])
def test_kernels_match_plain_at_opt_widths(dev, kind, dtype, d):
    """LayerNorm rows wider than a warp holds (one CTA a row): OPT-2.7b's
    2560, OPT-6.7b's 4096, OPT-66b's 9216, and 2050, which the 16-byte vectors
    do not divide."""
    gen = torch.Generator(device=dev).manual_seed(d + 11)
    x, a, g, gy = (torch.randn(N, 5, d, device=dev, generator=gen).to(dtype) for _ in range(4))
    shape = (N, d) if kind == "per_episode" else (d,)
    w, b, ab = (torch.randn(shape, device=dev, generator=gen).to(dtype) * 0.5 + s for s in (1.0, 0.0, 0.0))
    before = dict(B.LAUNCHES)
    _check_ops(x, a, g, gy, w, b, ab, x, g, ab, dtype)
    assert B.LAUNCHES["ln_fwd"] > before["ln_fwd"] and B.LAUNCHES["ln_bwd"] > before["ln_bwd"]


@pytest.mark.cuda
def test_block_on_the_card_counts_launches_and_matches_the_cpu(dev):
    """A residual block's forward and backward on the card go through the
    kernels (every launch counted, ``block_ops`` too) and agree with the
    stock composition run on the CPU."""
    from rlcf_torch.utils import profiling

    gen = torch.Generator().manual_seed(10)
    p = _block_params(gen, torch.float32, True, grad=True)
    x = torch.randn(N, 7, D, generator=gen).requires_grad_(True)
    want = residual_block0(x, p, 2)
    want_g = torch.autograd.grad(want.sum(), [x, p["ln1_w"], p["fc_b"], p["out_b"]])
    pc = {k: v.detach().to(dev).requires_grad_(True) for k, v in p.items()}
    xc = x.detach().to(dev).requires_grad_(True)
    B.reset_launch_counts()
    profiling.enable()
    try:
        with profiling.span("probe"):
            got = L.residual_block(xc, pc, 2)
            got_g = torch.autograd.grad(got.sum(), [xc, pc["ln1_w"], pc["fc_b"], pc["out_b"]])
            torch.cuda.synchronize()
    finally:
        profiling.disable()
    counted = profiling.summary(profiling.recorded())["probe"].get("block_ops", 0)
    profiling.clear()
    assert B.LAUNCHES["ln_fwd"] == 1 and B.LAUNCHES["add_ln_fwd"] == 1 and B.LAUNCHES["ln_bwd"] == 2
    assert B.LAUNCHES["bias_gelu_fwd"] == 1 and B.LAUNCHES["bias_residual_fwd"] == 1
    assert B.LAUNCHES["bias_gelu_bwd"] == 1 and B.LAUNCHES["col_sums"] == 3 and B.LAUNCHES["reduce"] >= 3
    assert counted == sum(B.LAUNCHES.values())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for g0, g1 in zip(got_g, want_g):
        torch.testing.assert_close(g0.cpu(), g1, rtol=1e-4, atol=1e-4)
