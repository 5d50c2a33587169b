"""Random CLIP weights as an OpenAI-format state dict, made on the device
from a seed in a few large calls.

Every leaf is a view into one flat buffer: one ``torch.randn`` draws it all,
then one multiply-add gives each leaf its own mean and spread. The spreads
follow CLIP's initialisation (``clip/model.py::initialize_parameters``), with
two departures so that no layer is an identity the comparison could not see
through: LayerNorm and BatchNorm affines and every bias are drawn around their
initial values, and a ResNet block's last BatchNorm scale is drawn around
0.15 (CLIP zeroes it), which keeps the residual stream of RN50x64's 64 blocks
within a few times its input.

Both the program and the reference read the same state dict: the program
through its loader of OpenAI checkpoints, the reference directly.
"""

from __future__ import annotations

import math

import torch


def _transformer_spec(prefix: str, layers: int, width: int):
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    out = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        out += [(f"{p}.ln_1.weight", (width,), 1.0, 0.1), (f"{p}.ln_1.bias", (width,), 0.0, 0.1),
                (f"{p}.attn.in_proj_weight", (3 * width, width), 0.0, attn_std),
                (f"{p}.attn.in_proj_bias", (3 * width,), 0.0, 0.02),
                (f"{p}.attn.out_proj.weight", (width, width), 0.0, proj_std),
                (f"{p}.attn.out_proj.bias", (width,), 0.0, 0.02),
                (f"{p}.ln_2.weight", (width,), 1.0, 0.1), (f"{p}.ln_2.bias", (width,), 0.0, 0.1),
                (f"{p}.mlp.c_fc.weight", (4 * width, width), 0.0, fc_std),
                (f"{p}.mlp.c_fc.bias", (4 * width,), 0.0, 0.02),
                (f"{p}.mlp.c_proj.weight", (width, 4 * width), 0.0, proj_std),
                (f"{p}.mlp.c_proj.bias", (width,), 0.0, 0.02)]
    return out


def _bn_spec(name: str, c: int, scale_mean: float = 1.0):
    return [(f"{name}.weight", (c,), scale_mean, 0.05 if scale_mean != 1.0 else 0.1), (f"{name}.bias", (c,), 0.0, 0.1),
            (f"{name}.running_mean", (c,), 0.0, 0.1), (f"{name}.running_var", (c,), 1.0, 0.05)]


def _conv_spec(name: str, cout: int, cin: int, k: int):
    return [(name, (cout, cin, k, k), 0.0, (2.0 / (cin * k * k)) ** 0.5)]


def _resnet_spec(cfg):
    W, E = cfg["vision_width"], cfg["embed_dim"]
    out = []
    for i, (cout, cin) in enumerate(((W // 2, 3), (W // 2, W // 2), (W, W // 2)), start=1):
        out += _conv_spec(f"visual.conv{i}.weight", cout, cin, 3) + _bn_spec(f"visual.bn{i}", cout)
    inplanes = W
    for g, n_blocks in enumerate(cfg["vision_layers"]):
        planes = W * 2 ** g
        for b in range(n_blocks):
            p = f"visual.layer{g + 1}.{b}"
            out += (_conv_spec(f"{p}.conv1.weight", planes, inplanes, 1) + _bn_spec(f"{p}.bn1", planes)
                    + _conv_spec(f"{p}.conv2.weight", planes, planes, 3) + _bn_spec(f"{p}.bn2", planes)
                    + _conv_spec(f"{p}.conv3.weight", planes * 4, planes, 1) + _bn_spec(f"{p}.bn3", planes * 4, 0.15))
            if b == 0:
                out += (_conv_spec(f"{p}.downsample.0.weight", planes * 4, inplanes, 1)
                        + _bn_spec(f"{p}.downsample.1", planes * 4))
            inplanes = planes * 4
    C = W * 32
    std = C ** -0.5
    ap = "visual.attnpool"
    out.append((f"{ap}.positional_embedding", ((cfg["image_resolution"] // 32) ** 2 + 1, C), 0.0, std))
    for name, dout in (("q", C), ("k", C), ("v", C), ("c", E)):
        out += [(f"{ap}.{name}_proj.weight", (dout, C), 0.0, std), (f"{ap}.{name}_proj.bias", (dout,), 0.0, 0.02)]
    return out


def _vit_spec(cfg):
    W, P, E = cfg["vision_width"], cfg["vision_patch_size"], cfg["embed_dim"]
    std = W ** -0.5
    grid = cfg["image_resolution"] // P
    return ([("visual.conv1.weight", (W, 3, P, P), 0.0, std), ("visual.class_embedding", (W,), 0.0, std),
             ("visual.positional_embedding", (grid * grid + 1, W), 0.0, std),
             ("visual.ln_pre.weight", (W,), 1.0, 0.1), ("visual.ln_pre.bias", (W,), 0.0, 0.1)]
            + _transformer_spec("visual.transformer", cfg["vision_layers"], W)
            + [("visual.ln_post.weight", (W,), 1.0, 0.1), ("visual.ln_post.bias", (W,), 0.0, 0.1),
               ("visual.proj", (W, E), 0.0, std)])


def leaf_spec(cfg):
    """(key, shape, mean, std) of every floating leaf of the state dict of
    the CLIP described by ``cfg`` (a configuration file's tower entry)."""
    tw, E = cfg["text_width"], cfg["embed_dim"]
    text = ([("token_embedding.weight", (cfg["vocab_size"], tw), 0.0, 0.02),
             ("positional_embedding", (cfg["context_length"], tw), 0.0, 0.01)]
            + _transformer_spec("transformer", cfg["text_layers"], tw)
            + [("ln_final.weight", (tw,), 1.0, 0.1), ("ln_final.bias", (tw,), 0.0, 0.1),
               ("text_projection", (tw, E), 0.0, tw ** -0.5)])
    return (_vit_spec(cfg) if cfg.get("vision_patch_size") else _resnet_spec(cfg)) + text


def make_state_dict(cfg, seed: int, dtype=torch.bfloat16, device="cuda"):
    """The OpenAI-format state dict of ``cfg`` with random weights from
    ``seed``, every leaf in ``dtype`` on ``device`` (a view into one buffer),
    and ``logit_scale`` at log(cfg["logit_scale"]) in float32."""
    spec = leaf_spec(cfg)
    device = torch.device(device)
    sizes = torch.tensor([math.prod(shape) for _, shape, _, _ in spec], device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(int(sizes.sum()), generator=gen, device=device, dtype=dtype)
    std = torch.tensor([s for _, _, _, s in spec], device=device, dtype=dtype).repeat_interleave(sizes)
    mean = torch.tensor([m for _, _, m, _ in spec], device=device, dtype=dtype).repeat_interleave(sizes)
    flat = torch.addcmul(mean, flat, std)
    del std, mean
    sd, off = {}, 0
    for (key, shape, _, _), n in zip(spec, sizes.tolist()):
        sd[key] = flat[off:off + n].view(shape)
        off += n
    sd["logit_scale"] = torch.tensor(math.log(cfg["logit_scale"]), dtype=torch.float32, device=device)
    if cfg.get("feature_offset"):
        _share_offset(sd, cfg, gen)
    return sd


def _share_offset(sd, cfg, gen):
    """Give the image and the text features of this CLIP a shared offset
    along one direction ``e`` drawn from the seed: norms ``feature_offset``
    = [image, text]. A ViT's final LayerNorm bias and the text tower's take
    ``norm * P e / |P e|`` (``P`` the projection, whose columns are nearly
    orthonormal, so that the bias adds about ``norm * e`` to every feature);
    a ResNet's attention pool adds its projection's bias, ``norm * e``."""
    image, text = cfg["feature_offset"]
    e = torch.randn(cfg["embed_dim"], generator=gen, device=gen.device)
    e = e / e.norm()

    def along(proj, norm):
        d = proj.float() @ e
        return norm * d / d.norm()

    if cfg.get("vision_patch_size"):
        sd["visual.ln_post.bias"].copy_(along(sd["visual.proj"], image))
    else:
        sd["visual.attnpool.c_proj.bias"].copy_(image * e)
    sd["ln_final.bias"].copy_(along(sd["text_projection"], text))
