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
    """A random OpenAI-format CLIP state dict (ViT or ModifiedResNet) for ``cfg``."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=0.05: torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))
    sd = {}
    W, P, E = cfg.vision_width, cfg.vision_patch_size, cfg.embed_dim

    def bn(prefix, c):
        sd[prefix + ".weight"] = 1 + t(c)
        sd[prefix + ".bias"] = t(c)
        sd[prefix + ".running_mean"] = t(c)
        sd[prefix + ".running_var"] = 1 + t(c).abs()
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    def conv(name, cout, cin, k):
        sd[name] = t(cout, cin, k, k, s=(2.0 / (cin * k * k)) ** 0.5)

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

    if cfg.is_vit:
        sd["visual.conv1.weight"] = t(W, 3, P, P)
        sd["visual.class_embedding"] = t(W)
        sd["visual.positional_embedding"] = t(cfg.grid_size**2 + 1, W)
        sd["visual.ln_pre.weight"] = 1 + t(W)
        sd["visual.ln_pre.bias"] = t(W)
        blocks("visual.transformer", cfg.vision_layers, W)
        sd["visual.ln_post.weight"] = 1 + t(W)
        sd["visual.ln_post.bias"] = t(W)
        sd["visual.proj"] = t(W, E)
    else:
        for i, (cout, cin) in enumerate(((W // 2, 3), (W // 2, W // 2), (W, W // 2)), start=1):
            conv(f"visual.conv{i}.weight", cout, cin, 3)
            bn(f"visual.bn{i}", cout)
        inplanes = W
        for g, n_blocks in enumerate(cfg.vision_layers):
            planes = W * 2**g
            for b in range(n_blocks):
                pre = f"visual.layer{g + 1}.{b}"
                conv(pre + ".conv1.weight", planes, inplanes, 1)
                bn(pre + ".bn1", planes)
                conv(pre + ".conv2.weight", planes, planes, 3)
                bn(pre + ".bn2", planes)
                conv(pre + ".conv3.weight", planes * 4, planes, 1)
                bn(pre + ".bn3", planes * 4)
                if b == 0:
                    conv(pre + ".downsample.0.weight", planes * 4, inplanes, 1)
                    bn(pre + ".downsample.1", planes * 4)
                inplanes = planes * 4
        C = W * 32
        sd["visual.attnpool.positional_embedding"] = t((cfg.image_resolution // 32) ** 2 + 1, C, s=C**-0.5)
        for name, out in (("q", C), ("k", C), ("v", C), ("c", E)):
            sd[f"visual.attnpool.{name}_proj.weight"] = t(out, C, s=C**-0.5)
            sd[f"visual.attnpool.{name}_proj.bias"] = t(out)
    tw = cfg.text_width
    sd["token_embedding.weight"] = t(cfg.vocab_size, tw, s=0.02)
    sd["positional_embedding"] = t(cfg.context_length, tw, s=0.01)
    blocks("transformer", cfg.text_layers, tw)
    sd["ln_final.weight"] = 1 + t(tw)
    sd["ln_final.bias"] = t(tw)
    sd["text_projection"] = t(tw, E)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd
