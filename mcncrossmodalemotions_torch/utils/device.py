"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str, who: str) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device on a machine without
    one raises, so that an entry point never quietly runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on a CUDA device by default, and none is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return device
