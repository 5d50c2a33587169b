"""AugMix constants and the RandomResizedCrop box sampler of the view
generator (the port of what ``rlcf_tpu/data/augment.py`` gives the fused
AugMix sampler).

The sampler is split in two: ``draw_rrc`` makes the random draws with an
explicit ``torch.Generator``, and ``rrc_boxes`` is a deterministic function
of those draws (torchvision's 10 attempts, then the clamped-aspect center
crop). Fed the numbers that JAX drew, ``rrc_boxes`` gives JAX's boxes.
"""

from __future__ import annotations

import math

import torch

N_AUGMIX_OPS = 9
MAX_CHAIN_DEPTH = 3
N_CHAINS = 3
RRC_ATTEMPTS = 10
RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)


def draw_rrc(generator, shape, crop_min: float, ratio=RRC_RATIO, device="cpu"):
    """Random draws of ``rrc_boxes`` for boxes of leading shape ``shape``:
    ``ta`` (area fraction, U[crop_min, 1)), ``lr`` (log aspect,
    U[log r0, log r1))  with a trailing attempts axis, and ``u_top``, ``u_left``."""
    shape = tuple(shape)
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    return {
        "ta": u(*shape, RRC_ATTEMPTS) * (1.0 - crop_min) + crop_min,
        "lr": u(*shape, RRC_ATTEMPTS) * (hi - lo) + lo,
        "u_top": u(*shape),
        "u_left": u(*shape),
    }


def rrc_boxes(ta, lr, u_top, u_left, H: int, W: int, ratio=RRC_RATIO):
    """Crop boxes (top, left, h, w), float32 and integer-valued, from the
    draws of ``draw_rrc``: the first of the attempts that fits, else the
    clamped-aspect center crop (``rlcf_tpu/data/augment.py::_rrc_boxes``)."""
    area = H * W
    t = ta * area
    aspect = torch.exp(lr)
    ws = torch.floor(torch.sqrt(t * aspect))
    hs = torch.floor(torch.sqrt(t / aspect))
    valid = (ws <= W) & (hs <= H) & (ws > 0) & (hs > 0)
    first = valid.to(torch.uint8).argmax(dim=-1, keepdim=True)  # first fitting attempt (0 if none)
    any_valid = valid.any(dim=-1)
    w = torch.gather(ws, -1, first)[..., 0]
    h = torch.gather(hs, -1, first)[..., 0]
    top = torch.floor(u_top * (H - h + 1))
    left = torch.floor(u_left * (W - w + 1))
    in_ratio = W / H
    fb_w = float(W) if in_ratio < ratio[0] else (float(round(H * ratio[1])) if in_ratio > ratio[1] else float(W))
    fb_h = float(round(W / ratio[0])) if in_ratio < ratio[0] else float(H)
    fb_top, fb_left = float(round((H - fb_h) / 2.0)), float(round((W - fb_w) / 2.0))
    pick = lambda a, b: torch.where(any_valid, a, torch.full_like(a, b))
    return pick(top, fb_top), pick(left, fb_left), pick(h, fb_h), pick(w, fb_w)
