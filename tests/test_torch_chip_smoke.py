"""The smoke script's own bookkeeping, on the CPU: what it counts as device
time in a profile."""

import importlib.util
import pathlib
import types

import torch

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_SPEC = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def test_device_busy_counts_kernels_not_annotation_spans():
    """An annotation on the device timeline (``Optimizer.step#AdamW.step``)
    spans kernels that are counted on their own; device busy leaves it out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    event = lambda name, device, annotation=False: types.SimpleNamespace(name=name, device_type=device,
                                                                        is_user_annotation=annotation)
    events = [event("gemm", cuda), event("Optimizer.step#AdamW.step", cuda, annotation=True),
              event("aten::add", cpu), event("mha_bwd_mma_long", cuda)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert [e.name for e in chip_smoke.device_events(prof)] == ["gemm", "mha_bwd_mma_long"]
