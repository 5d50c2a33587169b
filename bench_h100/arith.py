"""The benchmark's own arithmetic: peaks of the card, the operations an item
needs, and each kernel's operations and bytes. Two operations a multiply-add;
only products count (matrix products, convolutions, attention), as in
``torch.utils.flop_counter``.

Conventions:
- a ViT block: ``24·T·W²`` (qkv, output projection, MLP) plus ``4·T²·W``
  (the two attention products); causal attention needs ``T·(T+1)/2`` of the
  ``T²`` score pairs;
- a backward taken for the inputs only (the prompt's context is the only
  leaf that wants a gradient, so no weight gradient is formed): the dense
  products once more, the attention products twice more;
- a ModifiedResNet: every convolution ``2·Cin·Cout·k²·Hout·Wout``, the
  attention pool's projections and its one query's two products.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
# 700 W power limit): a card set to a lower limit runs below them.
PEAK = {"bf16": 989e12, "fp32": 67e12}
# the attention kernels' rate by type: bf16 on the tensor cores; fp32 as three
# TF32 passes a product (495 TFLOP/s over 3)
PEAK_ATTENTION = {"bf16": 989e12, "fp32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
HEAD_DIM = 64


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def vit_block_flops(tokens: int, width: int, causal: bool = False) -> float:
    pairs = tokens * (tokens + 1) / 2 if causal else tokens * tokens
    return 24 * tokens * width * width + 4 * pairs * width


def vit_tower_flops(cfg, resolution: int) -> float:
    """One image through a ViT tower: patch embedding, blocks, projection."""
    W, P = cfg["vision_width"], cfg["vision_patch_size"]
    tokens = (resolution // P) ** 2 + 1
    return (cfg["vision_layers"] * vit_block_flops(tokens, W) + 2 * (tokens - 1) * P * P * 3 * W
            + 2 * W * cfg["embed_dim"])


def resnet_tower_flops(cfg, resolution: int) -> float:
    """One image through a ModifiedResNet tower at ``resolution``."""
    W = cfg["vision_width"]
    conv = lambda cin, cout, k, hw: 2 * cin * cout * k * k * hw * hw
    hw = resolution // 2
    total = conv(3, W // 2, 3, hw) + conv(W // 2, W // 2, 3, hw) + conv(W // 2, W, 3, hw)
    hw //= 2
    inplanes = W
    for g, n_blocks in enumerate(cfg["vision_layers"]):
        planes = W * 2 ** g
        for b in range(n_blocks):
            out_hw = hw // 2 if (b == 0 and g > 0) else hw
            total += conv(inplanes, planes, 1, hw) + conv(planes, planes, 3, hw) + conv(planes, planes * 4, 1, out_hw)
            if b == 0:
                total += conv(inplanes, planes * 4, 1, out_hw)
            inplanes, hw = planes * 4, out_hw
    C, T = W * 32, hw * hw + 1
    return total + 2 * C * C + 2 * 2 * T * C * C + 2 * 2 * T * C + 2 * C * cfg["embed_dim"]


def image_tower_flops(cfg, resolution: int) -> float:
    return vit_tower_flops(cfg, resolution) if cfg.get("vision_patch_size") else resnet_tower_flops(cfg, resolution)


def text_tower_flops(cfg, lengths, causal: bool = True) -> float:
    """Sequences of ``lengths`` tokens through the text tower (causal
    attention: each length its own), and the projection of each one's pooled
    token."""
    W = cfg["text_width"]
    return sum(cfg["text_layers"] * vit_block_flops(t, W, causal) + 2 * W * cfg["embed_dim"] for t in lengths)


def text_tower_input_grad_flops(cfg, lengths, causal: bool = True) -> float:
    """The backward of ``text_tower_flops`` for the inputs only."""
    W = cfg["text_width"]

    def one(t):
        pairs = t * (t + 1) / 2 if causal else t * t
        return cfg["text_layers"] * (24 * t * W * W + 2 * 4 * pairs * W) + 2 * W * cfg["embed_dim"]

    return sum(one(t) for t in lengths)


def prompt_tta_flops_per_item(policy, rewards, ep, text_lengths, resolution: int) -> float:
    """One image's RLCF prompt TTA: every view through the policy tower, the
    kept views through each reward tower at its own resolution, and each step
    the text tower over every class's prompt (``text_lengths``: each one's
    tokens up to its EOT), forward and backward for the context, then once
    forward for the prediction."""
    n_views = ep["n_views"]
    n_keep = max(1, int(n_views * ep["selection_p"]))
    f = n_views * image_tower_flops(policy, resolution)
    f += sum(n_keep * image_tower_flops(r, r["image_resolution"]) for r in rewards)
    fwd = text_tower_flops(policy, text_lengths)
    bwd = text_tower_input_grad_flops(policy, text_lengths)
    return f + ep["tta_steps"] * (fwd + bwd) + fwd


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def attention_cost(direction: str, B: int, T: int, H: int, elem_bytes: int = 2):
    """(operations, bytes) of one fused attention launch on ``qkv [B, T,
    3·H·64]``. Forward: the scores and ``P·V``, ``4·B·H·T²·D``, reading qkv
    and writing the output. Backward (``P`` recomputed from qkv): five
    products, ``10·B·H·T²·D``, reading qkv and the output's gradient and
    writing qkv's."""
    D = HEAD_DIM
    square = B * H * T * T * D
    elems = B * T * H * D
    if direction == "fwd":
        return 4 * square, (3 + 1) * elems * elem_bytes
    if direction == "bwd":
        return 10 * square, (3 + 1 + 3) * elems * elem_bytes
    raise ValueError(direction)


def least_seconds(ops: float, nbytes: float, peak: float) -> float:
    """The least time a launch can take: the larger of its operations at the
    peak rate and its bytes at the memory's bandwidth."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


# Operations a pixel of a plane costs in the AugMix kernel, by op:
# autocontrast, equalize, posterize, rotate, solarize, shear x/y, translate x/y.
AUGMIX_OP_COST = {0: 7, 1: 2, 2: 1, 3: 12, 4: 2, 5: 4, 6: 4, 7: 4, 8: 4}
AUGMIX_MIX_COST, AUGMIX_FINAL_COST = 2, 4


def augmix_cost(params, n_views: int, R: int, S: int, resize_weights, bicubic_matrix):
    """(fp32 operations, bytes) of one AugMix launch whose per-view
    parameters are ``params`` (rows ``[N*V, ...]``): the crop's taps over the
    rows and columns each view's weights cover; where ``m < 1``, each sampled
    op, the three-chain mix and the final blend, per pixel of each of the 3
    planes. Bytes: the u8 sources read once and the u8 views written once."""
    host = {k: v.cpu() for k, v in params.items()}
    rows = host["m"].shape[0]
    basew = bicubic_matrix(S, R)
    total = 0
    for i in range(rows):
        box = host["rrc"][i]
        base = i % n_views == 0
        wy = basew if base else resize_weights(box[0], box[2], 0, R, S)
        wx = basew if base else resize_weights(box[1], box[3], int(host["flip"][i]), R, S)
        cols = (wx.abs().sum(0) != 0).nonzero().flatten()
        width = int(cols.max() - cols.min() + 1) if cols.numel() else 0
        total += 2 * int((wy != 0).sum()) * width + 2 * int((wx != 0).sum()) * R
        if float(host["m"][i]) != 1.0:
            steps = [int(host["ops"][i, c * 3 + t]) for c in range(3) for t in range(int(host["depth"][i, c]))]
            total += R * R * (sum(AUGMIX_OP_COST.get(op, 0) for op in steps) + 3 * AUGMIX_MIX_COST + AUGMIX_FINAL_COST)
    n_sources = rows // n_views
    return 3 * total, n_sources * 3 * S * S + rows * 3 * R * R
