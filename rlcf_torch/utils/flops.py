"""Analytic FLOP accounting (2 FLOPs a multiply-add, backward = 2x forward):
a copy of ``rlcf_tpu/utils/flops.py``'s four functions, framework-free.
Conventions:
- ViT block: 24·T·W² (qkv/proj/mlp) + 4·T²·W (attention matmuls)
- text block: 24·T·W² (the T² term is small at 77 tokens and dropped)
"""

from __future__ import annotations

# dense bf16 tensor-core peak of an NVIDIA H100 SXM (NVIDIA's data sheet, at
# its 700 W power limit); a card set to a lower limit runs below it
H100_SXM_BF16_PEAK = 989e12


def vit_flops(width: int, layers: int, tokens: int, patch_dim: int, embed: int) -> float:
    """One image forward through a ViT tower (patch embed + blocks + proj)."""
    per_layer = 24 * tokens * width * width + 4 * tokens * tokens * width
    return layers * per_layer + 2 * tokens * patch_dim * width + 2 * width * embed


def vit_tower_flops(cfg, n_images: int = 1, resolution: int | None = None) -> float:
    """Forward FLOPs for ``n_images`` through a ClipConfig's ViT tower."""
    res = resolution or cfg.image_resolution
    tokens = (res // cfg.vision_patch_size) ** 2 + 1
    return n_images * vit_flops(
        cfg.vision_width, cfg.vision_layers, tokens, cfg.vision_patch_size ** 2 * 3, cfg.embed_dim
    )


def text_tower_flops(cfg, n_tokens_total: int) -> float:
    """Forward FLOPs for ``n_tokens_total`` text tokens through the text tower."""
    return cfg.text_layers * 24 * n_tokens_total * cfg.text_width ** 2


def transformer_decode_flops(n_layers: int, width: int, n_tokens: int, context: int) -> float:
    """Autoregressive decode of ``n_tokens`` with KV cache at average
    ``context`` length: per token 24·W² per layer + 4·ctx·W attention."""
    per_token = n_layers * (24 * width * width + 4 * context * width)
    return n_tokens * per_token


def prompt_tta_flops_per_image(pcfg, rcfg, n_views: int, selection_p: float, tta_steps: int, n_classes: int,
                               text_len: int, resolution: int = 224) -> float:
    """A prompt-TTA episode's FLOPs an image, by ``bench.py``'s accounting
    (``bench.py:285-301``): every view through the policy's ViT, the selected
    ones through the reward's, and the text tower over every class's prompt
    forward and backward each step, then once forward."""
    n_keep = max(1, int(n_views * selection_p))
    t_pol = (resolution // pcfg.vision_patch_size) ** 2 + 1
    t_rew = (rcfg.image_resolution // rcfg.vision_patch_size) ** 2 + 1
    f_policy = n_views * vit_flops(pcfg.vision_width, pcfg.vision_layers, t_pol, pcfg.vision_patch_size ** 2 * 3,
                                   pcfg.embed_dim)
    f_reward = n_keep * vit_flops(rcfg.vision_width, rcfg.vision_layers, t_rew, rcfg.vision_patch_size ** 2 * 3,
                                  rcfg.embed_dim)
    return f_policy + f_reward + (3 * tta_steps + 1) * text_tower_flops(pcfg, n_classes * text_len)
