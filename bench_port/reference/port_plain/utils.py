"""Runtime utilities: the device an entry point runs on."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another.  There is no silent CPU run: with ``device=None`` and no
    CUDA device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
