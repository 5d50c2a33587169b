"""Shared inputs for the PyTorch port's parity tests: tiny CLIP configs of
both packages, a random OpenAI-format ViT CLIP state dict, and synthetic
dataset trees written by the smoke script's writers."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_torch.models import clip as TC

_SMOKE = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module")
def one_thread():
    """Torch on one thread for a module's tests (restored after): at these
    sizes the intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfgs(name="t", embed=16, res=32, layers=2, width=64, patch=16, text_width=64, text_layers=2, heads=2):
    """The same tiny ViT config in both packages."""
    args = (name, embed, res, layers, width, patch, text_width, text_layers)
    kw = dict(vocab_size=49408, vision_heads_override=heads, text_heads_override=heads)
    return JC.ClipConfig(*args, **kw), TC.ClipConfig(*args, **kw)


def jax_params_numpy(params):
    """JAX pytree -> the same pytree with numpy leaves."""
    import jax

    return jax.tree_util.tree_map(np.asarray, params)


def weights_close(got, want_jax, lr, steps):
    """Adapted weights (the port's nested dicts against JAX's pytree) within
    2.1 * lr a step, all but 0.5% within 1e-5: AdamW moves a weight whose
    gradient is zero in exact arithmetic, like a key bias, by +-lr a step on
    rounding noise in either package (tests/test_torch_encoder_tta.py)."""
    import jax

    diffs = []
    for path, w in jax.tree_util.tree_flatten_with_path(want_jax)[0]:
        t = got
        for p in path:
            t = t[str(getattr(p, "key", p))]
        diffs.append(np.abs(t.detach().numpy() - np.asarray(w)).ravel())
    d = np.concatenate(diffs)
    assert d.max() <= 2.1 * lr * steps, d.max()
    assert (d > 1e-5).mean() <= 0.005, (d > 1e-5).mean()


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


def write_fine_grained_tree(root, set_id, n_classes, per_class=2, seed=0):
    """A synthetic tree of one fine-grained set under ``root`` (the smoke
    script's ``write_fine_grained_tree``): the first ``n_classes`` classes,
    ``per_class`` test images each and one train and one val image each,
    listed out of class order; aircraft's ``variants.txt`` not sorted."""
    names = None
    if set_id == "aircraft":
        names = [f"variant-{(7 * i) % n_classes:03d}" for i in range(n_classes)]   # not sorted
    listed = lambda n: [c for _ in range(n) for c in reversed(range(n_classes))]
    return chip_smoke.write_fine_grained_tree(root, set_id, {"test": listed(per_class), "val": listed(1),
                                                             "train": listed(1)}, names=names, seed=seed)


def hf_opt_state_dict(proj, final_ln=True, seed=0, D=32, E=16, F=64, L=2, V=256, n_pos=130):
    """A random HF-format OPT state dict (numpy) at the tiny configs' sizes:
    ``proj`` OPT-350m's embedding projection, ``final_ln`` the decoder's final LayerNorm."""
    rng = np.random.default_rng(seed)
    t = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)
    pre = "model.decoder."
    sd = {pre + "embed_tokens.weight": t(V, E if proj else D), pre + "embed_positions.weight": t(n_pos, D)}
    for i in range(L):
        b = f"{pre}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[b + f"self_attn.{name}.weight"], sd[b + f"self_attn.{name}.bias"] = t(D, D), t(D)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[b + f"{ln}.weight"], sd[b + f"{ln}.bias"] = 1 + t(D), t(D)
        sd[b + "fc1.weight"], sd[b + "fc1.bias"] = t(F, D), t(F)
        sd[b + "fc2.weight"], sd[b + "fc2.bias"] = t(D, F), t(D)
    if final_ln:
        sd[pre + "final_layer_norm.weight"], sd[pre + "final_layer_norm.bias"] = 1 + t(D), t(D)
    if proj:
        sd[pre + "project_in.weight"], sd[pre + "project_out.weight"] = t(D, E), t(E, D)
    return sd


def hf_mapper_state_dict(cfg, seed=0):
    """A random ClipCap/CapDec mapper state dict (``clip_project.*``, numpy) for a mapper config."""
    rng = np.random.default_rng(seed)
    t = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    p = "clip_project."
    if cfg.kind == "mlp":
        h = cfg.llm_dim * cfg.prefix_length // 2
        return {p + "model.0.weight": t(h, cfg.clip_dim), p + "model.0.bias": t(h),
                p + "model.2.weight": t(cfg.llm_dim * cfg.prefix_length, h), p + "model.2.bias": t(cfg.llm_dim * cfg.prefix_length)}
    D, H = cfg.llm_dim, int(cfg.llm_dim * cfg.mlp_ratio)
    sd = {p + "linear.weight": t(cfg.clip_length * D, cfg.clip_dim), p + "linear.bias": t(cfg.clip_length * D),
          p + "prefix_const": t(cfg.prefix_length, D)}
    for i in range(cfg.num_layers):
        b = f"{p}transformer.layers.{i}."
        sd.update({b + "norm1.weight": 1 + t(D), b + "norm1.bias": t(D), b + "attn.to_queries.weight": t(D, D),
                   b + "attn.to_keys_values.weight": t(2 * D, D), b + "attn.project.weight": t(D, D),
                   b + "attn.project.bias": t(D), b + "norm2.weight": 1 + t(D), b + "norm2.bias": t(D),
                   b + "mlp.fc1.weight": t(H, D), b + "mlp.fc1.bias": t(H), b + "mlp.fc2.weight": t(D, H),
                   b + "mlp.fc2.bias": t(D)})
    return sd
