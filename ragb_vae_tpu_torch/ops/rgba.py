"""RGBA value-range primitives (channels-last).

Counterpart of the range functions of `ragb_vae_tpu/ops/rgba.py`. Images
are (..., H, W, C) tensors in [0, 1]; RGBA is C=4 with alpha in channel 3.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def ensure_alpha(x: Tensor) -> Tensor:
    """Append an opaque alpha channel when the input is RGB."""
    if x.shape[-1] == 4:
        return x
    if x.shape[-1] != 3:
        raise ValueError(f"Expected 3 or 4 channels, got {x.shape[-1]}")
    alpha = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([x, alpha], dim=-1)


def to_vae_range(x: Tensor) -> Tensor:
    """[0,1] -> [-1,1]."""
    return x * 2.0 - 1.0


def from_vae_range(x: Tensor) -> Tensor:
    """[-1,1] -> [0,1]."""
    return (x + 1.0) * 0.5
