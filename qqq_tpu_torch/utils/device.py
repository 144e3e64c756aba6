"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  With no card, ``None`` and any CUDA
    device raise instead of falling back to the CPU, so a measurement never
    runs on the wrong device unnoticed.  The CPU is used only when the
    caller asks for it.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return device
