"""Device resolution: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> ``torch.device``.

    Asking for the card where there is none raises: no entry point goes on
    running on the CPU unless it was given ``cpu``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available (pass device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def torch_dtype(precision: str) -> torch.dtype:
    """CLI precision name -> dtype."""
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[precision]
