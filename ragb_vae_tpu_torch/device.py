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


# small constant tensors, one per (values, dtype, device): building one from a
# Python sequence on every call is a pageable host-to-device copy, which on
# CUDA makes the host wait for the work queued before it
_CONSTANTS: dict = {}


def _frozen(values):
    """Nested sequences of numbers as nested tuples of floats (a dict key)."""
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return float(values)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, made once and kept.
    Made outside inference mode, so autograd may save it later. Callers must
    not write into it."""
    key = (_frozen(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype, device=key[2])
    return t
