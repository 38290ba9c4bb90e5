"""Where an entry point runs: on the card unless the caller names the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point was asked for; asking for the card on a
    machine without one is an error, never a silent run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() is False; "
            "pass --device cpu (device='cpu') to run on the CPU.")
    return device
