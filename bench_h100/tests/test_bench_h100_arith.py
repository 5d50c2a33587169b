"""The benchmark's arithmetic against ``torch.utils.flop_counter`` on the
plain reference at a small size, and the kernels' bounds against PERF.md's
kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100 import arith
from bench_h100.reference import clip, views
from bench_h100.tests import tiny
from bench_h100.weights import make_state_dict


def counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("tower", [tiny.tower("vit", 32, 32, 2, 64, 8), tiny.tower("vit14", 48, 56, 3, 128, 14),
                                   tiny.tower("rn", 32, 64, [1, 1, 1, 1], 16, None),
                                   tiny.tower("rn2", 48, 96, [2, 1, 3, 1], 16, None)])
def test_image_tower_flops_are_what_the_reference_computes(tower):
    sd = make_state_dict(tower, 0, dtype=torch.float32, device="cpu")
    res = tower["image_resolution"]
    x = torch.randn(3, 3, res, res)
    got = counted(lambda: clip.encode_image(sd, tower, x, clip.Prec()))
    assert got == 3 * arith.image_tower_flops(tower, res)


def test_text_tower_flops_forward_and_input_gradient():
    """Forward, and the backward for the inputs only (no weight gradient),
    at the full square of scores the reference computes (its causal mask
    leaves half of them unused: the benchmark counts that half out)."""
    tower = tiny.tower("vit", 32, 32, 2, 64, 8)
    sd = make_state_dict(tower, 0, dtype=torch.float32, device="cpu")
    emb = torch.randn(5, 9, 64, requires_grad=True)
    eot = torch.full((5,), 8)
    fwd = counted(lambda: clip.encode_text_embeds(sd, tower, emb, eot, clip.Prec()))
    assert fwd == arith.text_tower_flops(tower, [9] * 5, causal=False)
    feats = clip.encode_text_embeds(sd, tower, emb, eot, clip.Prec())
    bwd = counted(lambda: torch.autograd.grad(feats.sum(), emb))
    assert bwd == arith.text_tower_input_grad_flops(tower, [9] * 5, causal=False)
    assert arith.text_tower_flops(tower, [9] * 5) < fwd


@pytest.mark.parametrize("direction, B, T, H, bound_ms", [
    ("fwd", 256, 197, 12, 0.0925),   # the flagship policy's forward (bytes)
    ("fwd", 24, 257, 16, 0.0151),    # the ViT-L/14 reward's forward (bytes)
    ("bwd", 800, 16, 8, 0.0274),     # the text tower's backward (bytes)
    ("bwd", 6, 577, 16, 0.0207),     # the xlong backward at 336 px (operations)
])
def test_attention_bounds_are_the_kernel_tables(direction, B, T, H, bound_ms):
    ops, nbytes = arith.attention_cost(direction, B, T, H)
    assert round(arith.least_seconds(ops, nbytes, arith.PEAK["bf16"]) * 1e3, 4) == bound_ms


@pytest.mark.parametrize("N, bound_ms", [(4, 0.0249), (1, 0.0063)])
def test_augmix_bound_is_the_kernel_tables(N, bound_ms):
    """The AugMix launch of a group of N sources, 64 views of 256 -> 224 px,
    bound by its operations: within 5% of the table's bound, whose view
    parameters were drawn on the card (these are drawn on the CPU)."""
    params = views.group_view_params(1234 + N, N, 64, 256, 224, "cpu")
    ops, nbytes = arith.augmix_cost(params, 64, 224, 256, views.resize_weights, views.bicubic_matrix)
    assert ops / arith.PEAK["fp32"] > nbytes / arith.HBM_BYTES_PER_S
    assert arith.least_seconds(ops, nbytes, arith.PEAK["fp32"]) * 1e3 == pytest.approx(bound_ms, rel=0.05)
    assert nbytes == N * 3 * 256 * 256 + N * 64 * 3 * 224 * 224


def test_flagship_flops_per_item():
    """ViT-B/16 over 64 views, ViT-L/14 over the 6 kept, and the text tower
    over ImageNet-A's 200 prompts: 4.9 TFLOP an image."""
    from bench_h100 import harness
    from bench_h100.drivers.prompt_tta import flops_per_item

    config = harness.load_json(harness.ROOT, "bench_h100", "configs", "clip-b16-l14.json")
    traffic = harness.load_json(harness.ROOT, "bench_h100", "traffic", "prompt-g4.json")
    f = flops_per_item(config, traffic)
    vit = arith.vit_tower_flops
    assert 64 * vit(config["policy"], 224) + 6 * vit(config["rewards"][0], 224) < f < 5.0e12
