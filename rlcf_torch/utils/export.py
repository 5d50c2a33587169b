"""Ahead-of-time export of a TTA episode for serving (``torch.export``), the
counterpart of ``rlcf_tpu/utils/export.py``.

The whole episode (frozen towers, selection, the steps' forward, backward
and AdamW update, the final prediction) is captured once into a graph of
aten ops and the port's ``rlcf::`` attention and block ops, and saved. A serving
process loads it and runs it without the model code. Weights stay call
arguments, so the artifact is small and one export serves any checkpoint of
the same architecture.

Typical flow::

    clf = PromptTTAClassifier(...).setup(classnames)
    blob = export_serving(clf.serving_fn_tokens(), clf.serving_example_args_tokens(tokens_shape))
    save_exported("episode.rlcfx", blob)
    # serving side: a process that imports torch and this module, no model code
    call = load_exported("episode.rlcfx")
    logits = call(cparams, rparams, trainable0, pt_args, tf0, r_feats, tokens)

The loaded program calls ``rlcf::fused_attention`` and
``rlcf::fused_attention_bwd``, which importing ``rlcf_torch.ops.attention``
registers, and, from a capture on the card, the block ops (``rlcf::layer_norm``,
``rlcf::add_layer_norm``, ``rlcf::bias_quick_gelu``, ``rlcf::bias_residual``
and their backward ops), which importing ``rlcf_torch.ops.block_ops``
registers (this module imports both): on a CUDA tensor they launch the
hand-written kernels, which build at first use, on a CPU tensor they run the
plain versions.

The capture is two-stage. ``make_fx`` first traces the function through fake
tensors below autograd, so the steps' backward becomes explicit aten ops and
``rlcf::fused_attention_bwd`` nodes (and the block ops' backward nodes);
``torch.export.export`` (non-strict)
then captures that graph. Exporting the function directly traces at the
pre-dispatch level, where a batched matmul's backward saves a folded view of
its input that the graph never records, and the export fails.
"""

from __future__ import annotations

import io
from typing import Callable, Optional, Sequence

import torch

from ..ops import attention as _attention  # noqa: F401  (registers the rlcf:: ops the programs call)
from ..ops import block_ops as _block_ops  # noqa: F401

MAGIC = b"RLCFT001"
PLATFORMS = ("cuda", "cpu")


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serving(fn: Callable, example_args: Sequence, platforms: Optional[Sequence[str]] = None) -> bytes:
    """Capture ``fn(*example_args)`` and serialize it behind ``MAGIC``.

    ``example_args`` are tensors (or nested dicts, lists and tuples of them)
    of the served shapes, dtypes and device; their values are not kept.
    ``platforms``: the device types the artifact may be served on (a subset
    of ``PLATFORMS``), recorded in it; default, the device type of the
    example arguments. ``deserialize_call`` moves the program to a listed
    device and refuses any other.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    args = tuple(example_args)
    leaves = [a for a in torch.utils._pytree.tree_leaves(args) if isinstance(a, torch.Tensor)]
    platforms = tuple(platforms) if platforms else (leaves[0].device.type,)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown:
        raise ValueError(f"unknown platforms {unknown}; an artifact serves on {list(PLATFORMS)}")
    graph = make_fx(_Fn(fn), tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    program = torch.export.export(graph, args, strict=False)
    program.example_inputs = None   # the weights: not part of the artifact
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={"platforms": ",".join(platforms)})
    return MAGIC + buf.getvalue()


def deserialize_program(data: bytes, device=None):
    """The ``torch.export.ExportedProgram`` of an artifact, moved to
    ``device`` (one of the platforms it was exported for) when given."""
    if not data.startswith(MAGIC):
        raise ValueError("not an rlcf-torch export artifact (bad magic)")
    extra = {"platforms": ""}
    program = torch.export.load(io.BytesIO(data[len(MAGIC):]), extra_files=extra)
    if device is not None:
        device = torch.device(device)
        if device.type not in extra["platforms"].split(","):
            raise ValueError(f"the artifact was exported for {extra['platforms']}, not {device.type}")
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program


def deserialize_call(data: bytes, device=None) -> Callable:
    """Rehydrate an artifact into a callable taking the exported function's
    arguments (``device``: see ``deserialize_program``)."""
    return deserialize_program(data, device).module()


def save_exported(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def load_exported(path: str, device=None) -> Callable:
    with open(path, "rb") as fh:
        return deserialize_call(fh.read(), device)
