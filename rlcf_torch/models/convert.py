"""Parameters into the port: from the JAX package's pytree, and from an
OpenAI-format CLIP state dict, ViT or ResNet (the counterpart of
``rlcf_tpu/models/convert.py``).

Layout changes from an OpenAI state dict, as in the JAX package:
- torch Linear weights [out, in] become [in, out];
- the attention in_proj (q; k; v stacked rows) becomes a fused [D, 3D] ``qkv_w``;
- the ViT patch conv goes OIHW -> HWIO;
- per-layer transformer tensors stack on a leading layer axis;
- BatchNorm becomes ``{w, b, mean, var}``, the running statistics in fp32.
A ResNet tower's convolution kernels stay OIHW, in the channels_last memory
format (``models/layers.py``); from a JAX pytree they go HWIO -> OIHW.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict

import numpy as np
import torch

from .clip import ClipConfig, infer_arch_from_state_dict


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _resnet_conv(w):
    """An OIHW kernel in the port's layout (channels_last)."""
    return w.contiguous(memory_format=torch.channels_last)


def from_jax_params(tree, cfg: ClipConfig, dtype=None, device="cpu"):
    """The JAX package's CLIP parameter pytree (numpy leaves, the layout of
    ``init_clip_params``/``convert_clip_state_dict``) -> the port's params.

    ``dtype`` casts floating leaves (``logit_scale`` and BatchNorm's running
    statistics stay fp32). A ResNet tower's HWIO kernels become OIHW."""

    def leaf(a, keep_fp32=False):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch.from_numpy path
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point() and t.dim() > 0 and not keep_fp32:
            t = t.to(dtype)
        return t.to(device)

    def convert(node, key=""):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        t = leaf(node, keep_fp32=key in ("mean", "var"))
        return _resnet_conv(t.permute(3, 2, 0, 1)) if key.startswith("conv") and key.endswith("_w") else t

    if cfg.is_vit:
        return _tree_map(leaf, tree)
    return {k: convert(v) if k == "visual" else _tree_map(leaf, v) for k, v in tree.items()}


def _numpy_leaf(a, device="cpu"):
    """One numpy leaf of a JAX pytree as a tensor of the same dtype (int8 stays int8)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch.from_numpy path
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_numpy_tree(tree, device="cpu"):
    """A JAX parameter tree whose layout the port keeps leaf for leaf (numpy
    leaves: OPT's, int8 ``{"q8", "sc"}`` entries of ``quantize_opt_params``
    included; a mapper's, a per-image stack keeping its leading axis;
    GPT-2's) -> the port's: the same tree of tensors, each of its leaf's dtype."""
    return _tree_map(lambda a: _numpy_leaf(a, device), tree)


# the names the OPT, mapper and GPT-2 trees are carried across by
from_jax_opt_params = from_jax_mapper_params = from_jax_gpt2_params = from_jax_numpy_tree


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint (eager or TorchScript archive) as CPU tensors."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _stack_blocks(sd, prefix: str, n_layers: int, cast):
    get = lambda i, name: cast(sd[f"{prefix}.resblocks.{i}.{name}"])
    stack = lambda name, tr=False: torch.stack([get(i, name).t() if tr else get(i, name) for i in range(n_layers)])
    return {
        "ln1_w": stack("ln_1.weight"), "ln1_b": stack("ln_1.bias"),
        "qkv_w": stack("attn.in_proj_weight", True), "qkv_b": stack("attn.in_proj_bias"),
        "out_w": stack("attn.out_proj.weight", True), "out_b": stack("attn.out_proj.bias"),
        "ln2_w": stack("ln_2.weight"), "ln2_b": stack("ln_2.bias"),
        "fc_w": stack("mlp.c_fc.weight", True), "fc_b": stack("mlp.c_fc.bias"),
        "proj_w": stack("mlp.c_proj.weight", True), "proj_b": stack("mlp.c_proj.bias"),
    }


def _convert_resnet_visual(sd, cfg: ClipConfig, cast, device):
    conv = lambda name: _resnet_conv(cast(sd[name]))
    f32 = lambda name: sd[name].detach().to(device=device, dtype=torch.float32).contiguous()

    def bn(prefix):
        return {"w": cast(sd[f"{prefix}.weight"]), "b": cast(sd[f"{prefix}.bias"]),
                "mean": f32(f"{prefix}.running_mean"), "var": f32(f"{prefix}.running_var")}

    stem = {f"conv{i}_w": conv(f"visual.conv{i}.weight") for i in (1, 2, 3)}
    stem.update({f"bn{i}": bn(f"visual.bn{i}") for i in (1, 2, 3)})
    groups = []
    for g, n_blocks in enumerate(cfg.vision_layers, start=1):
        blocks = []
        for b in range(n_blocks):
            pre = f"visual.layer{g}.{b}"
            block = {f"conv{i}_w": conv(f"{pre}.conv{i}.weight") for i in (1, 2, 3)}
            block.update({f"bn{i}": bn(f"{pre}.bn{i}") for i in (1, 2, 3)})
            if f"{pre}.downsample.0.weight" in sd:
                block["downsample"] = {"conv_w": conv(f"{pre}.downsample.0.weight"), "bn": bn(f"{pre}.downsample.1")}
            blocks.append(block)
        groups.append(blocks)
    ap = "visual.attnpool"
    attnpool = {"pos_emb": cast(sd[f"{ap}.positional_embedding"])}
    for name in ("q", "k", "v", "c"):
        attnpool[f"{name}_w"] = cast(sd[f"{ap}.{name}_proj.weight"]).t().contiguous()
        attnpool[f"{name}_b"] = cast(sd[f"{ap}.{name}_proj.bias"])
    return {"stem": stem, "groups": groups, "attnpool": attnpool}


def convert_clip_state_dict(sd: Dict, dtype=torch.float32, device="cpu"):
    """OpenAI CLIP state dict (ViT or ResNet) -> (params, inferred ClipConfig)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items() if k not in ("input_resolution", "context_length", "vocab_size")}
    cfg = infer_arch_from_state_dict({k: tuple(v.shape) for k, v in sd.items()})
    cast = lambda t: t.detach().to(device=device, dtype=dtype).contiguous()
    visual = _convert_vit_visual(sd, cfg, cast) if cfg.is_vit else _convert_resnet_visual(sd, cfg, cast, device)
    text = {
        "token_embedding": cast(sd["token_embedding.weight"]),
        "positional_embedding": cast(sd["positional_embedding"]),
        "blocks": _stack_blocks(sd, "transformer", cfg.text_layers, cast),
        "ln_final_w": cast(sd["ln_final.weight"]), "ln_final_b": cast(sd["ln_final.bias"]),
        "projection": cast(sd["text_projection"]),
    }
    logit_scale = sd["logit_scale"].detach().to(device=device, dtype=torch.float32)
    return {"visual": visual, "text": text, "logit_scale": logit_scale}, cfg


def _convert_vit_visual(sd, cfg: ClipConfig, cast):
    return {
        "conv_w": cast(sd["visual.conv1.weight"]).permute(2, 3, 1, 0).contiguous(),
        "class_emb": cast(sd["visual.class_embedding"]),
        "pos_emb": cast(sd["visual.positional_embedding"]),
        "ln_pre_w": cast(sd["visual.ln_pre.weight"]), "ln_pre_b": cast(sd["visual.ln_pre.bias"]),
        "blocks": _stack_blocks(sd, "visual.transformer", cfg.vision_layers, cast),
        "ln_post_w": cast(sd["visual.ln_post.weight"]), "ln_post_b": cast(sd["visual.ln_post.bias"]),
        "proj": cast(sd["visual.proj"]),
    }


def load_clip_checkpoint(path: str, dtype=torch.float32, device="cpu"):
    """Load an OpenAI CLIP .pt checkpoint (ViT or ResNet) into (params, config)."""
    return convert_clip_state_dict(load_torch_file(path), dtype=dtype, device=device)


# SHA256 digests of the released OpenAI checkpoints (the JAX package's
# constants, from the download URLs the reference verifies,
# `TPT/clip/clip.py:30-70`).
CLIP_CHECKPOINT_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "RN50x64": "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B/16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
    "ViT-L/14": "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836",
    "ViT-L/14@336px": "3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02",
}


def _sha256_file(path: str) -> str:
    """Chunked SHA256 of a checkpoint (100 MB to 1.7 GB: never read whole),
    memoized in a ``<path>.sha256`` sidecar keyed by (size, mtime_ns): a
    touched or replaced file misses the key and is hashed again; an
    unwritable directory skips the cache."""
    st = os.stat(path)
    sidecar = path + ".sha256"
    try:
        with open(sidecar) as fh:
            cached = json.load(fh)
        if cached.get("size") == st.st_size and cached.get("mtime_ns") == st.st_mtime_ns:
            return cached["sha256"]
    except (OSError, ValueError, KeyError):
        pass
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    try:
        with open(sidecar, "w") as fh:
            json.dump({"size": st.st_size, "mtime_ns": st.st_mtime_ns, "sha256": digest}, fh)
    except OSError:
        pass
    return digest


def check_checkpoint_digest(path: str, arch: str):
    """Classify a checkpoint file's SHA256 for ``arch``: ``("ok", digest)``
    when it is ``arch``'s published digest, ``("wrong-arch", other)`` when it
    is the stock release of another arch (loading it would build the wrong
    tower under ``arch``'s name), ``("unknown", digest)`` otherwise (a
    fine-tuned or converted file: no integrity claim can be made)."""
    digest = _sha256_file(path)
    if digest == CLIP_CHECKPOINT_SHA256.get(arch):
        return "ok", digest
    for other, d in CLIP_CHECKPOINT_SHA256.items():
        if digest == d:
            return "wrong-arch", other
    return "unknown", digest
