"""Shared inputs for the PyTorch port's parity tests: tiny CLIP configs of
both packages and a random OpenAI-format ViT CLIP state dict."""

import numpy as np
import torch

from rlcf_tpu.models import clip as JC
from rlcf_torch.models import clip as TC


def tiny_cfgs(name="t", embed=16, res=32, layers=2, width=64, patch=16, text_width=64, text_layers=2, heads=2):
    """The same tiny ViT config in both packages."""
    args = (name, embed, res, layers, width, patch, text_width, text_layers)
    kw = dict(vocab_size=49408, vision_heads_override=heads, text_heads_override=heads)
    return JC.ClipConfig(*args, **kw), TC.ClipConfig(*args, **kw)


def jax_params_numpy(params):
    """JAX pytree -> the same pytree with numpy leaves."""
    import jax

    return jax.tree_util.tree_map(np.asarray, params)


def openai_state_dict(cfg, seed=0):
    """A random OpenAI-format CLIP (ViT) state dict for ``cfg``."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=0.05: torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))
    sd = {}
    W, P, E = cfg.vision_width, cfg.vision_patch_size, cfg.embed_dim

    def blocks(prefix, n, w):
        for i in range(n):
            b = f"{prefix}.resblocks.{i}."
            sd[b + "ln_1.weight"] = 1 + t(w)
            sd[b + "ln_1.bias"] = t(w)
            sd[b + "attn.in_proj_weight"] = t(3 * w, w)
            sd[b + "attn.in_proj_bias"] = t(3 * w)
            sd[b + "attn.out_proj.weight"] = t(w, w)
            sd[b + "attn.out_proj.bias"] = t(w)
            sd[b + "ln_2.weight"] = 1 + t(w)
            sd[b + "ln_2.bias"] = t(w)
            sd[b + "mlp.c_fc.weight"] = t(4 * w, w)
            sd[b + "mlp.c_fc.bias"] = t(4 * w)
            sd[b + "mlp.c_proj.weight"] = t(w, 4 * w)
            sd[b + "mlp.c_proj.bias"] = t(w)

    sd["visual.conv1.weight"] = t(W, 3, P, P)
    sd["visual.class_embedding"] = t(W)
    sd["visual.positional_embedding"] = t(cfg.grid_size**2 + 1, W)
    sd["visual.ln_pre.weight"] = 1 + t(W)
    sd["visual.ln_pre.bias"] = t(W)
    blocks("visual.transformer", cfg.vision_layers, W)
    sd["visual.ln_post.weight"] = 1 + t(W)
    sd["visual.ln_post.bias"] = t(W)
    sd["visual.proj"] = t(W, E)
    tw = cfg.text_width
    sd["token_embedding.weight"] = t(cfg.vocab_size, tw, s=0.02)
    sd["positional_embedding"] = t(cfg.context_length, tw, s=0.01)
    blocks("transformer", cfg.text_layers, tw)
    sd["ln_final.weight"] = 1 + t(tw)
    sd["ln_final.bias"] = t(tw)
    sd["text_projection"] = t(tw, E)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd
