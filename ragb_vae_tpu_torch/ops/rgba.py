"""RGBA compositing and value-range primitives (channels-last).

Counterpart of `ragb_vae_tpu/ops/rgba.py`. Images are (..., H, W, C)
tensors in [0, 1] unless a function says otherwise; RGBA is C=4 with alpha
in channel 3.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from ragb_vae_tpu_torch.device import constant

Tensor = torch.Tensor
Background = Union[float, int, Sequence[float], Tensor]


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


def _normalize_background(background: Background, reference: Tensor) -> Tensor:
    """Broadcast a background spec against a (..., H, W, 3) RGB reference: a
    scalar, three per-channel values, or a tensor that broadcasts to it."""
    if isinstance(background, (int, float)):
        return torch.full_like(reference, float(background))
    if isinstance(background, (list, tuple)):
        if len(background) != 3:
            raise ValueError("Background color sequence must contain exactly three values.")
        color = constant(background, reference.dtype, reference.device)
        return color.reshape((1,) * (reference.ndim - 1) + (3,)).expand_as(reference)
    bg = torch.as_tensor(background, dtype=reference.dtype, device=reference.device)
    if bg.ndim == reference.ndim and bg.shape[-1] == 1:
        bg = bg.repeat_interleave(3, dim=-1)
    return bg.expand_as(reference)


def composite_over_background(rgba: Tensor, background: Background) -> Tensor:
    """Alpha-composite (..., H, W, 4) over a background -> RGB: rgb*a + bg*(1-a)."""
    rgba = ensure_alpha(rgba)
    rgb, alpha = rgba[..., :3], rgba[..., 3:4]
    return rgb * alpha + _normalize_background(background, rgb) * (1.0 - alpha)


def composite_over_white(rgba: Tensor) -> Tensor:
    return composite_over_background(rgba, 1.0)


def composite_over_black(rgba: Tensor) -> Tensor:
    return composite_over_background(rgba, 0.0)


def blend_to_white(rgba: Tensor) -> Tensor:
    """Blend RGBA onto white and reset alpha to 1 (RGBA -> opaque RGBA)."""
    rgb, alpha = rgba[..., :3], rgba[..., 3:4]
    return torch.cat([rgb * alpha + (1.0 - alpha), torch.ones_like(alpha)], dim=-1)


def checkerboard(height: int, width: int, *, tile: int = 16, dtype=torch.float32, device=None) -> Tensor:
    """Light/dark checkerboard (H, W, 3) in {0.1, 1.0}:
    ((y//tile + x//tile) % 2) * 0.9 + 0.1."""
    y = torch.arange(height, device=device).reshape(-1, 1)
    x = torch.arange(width, device=device).reshape(1, -1)
    pattern = ((y // tile + x // tile) % 2).to(dtype) * 0.9 + 0.1
    return pattern[..., None].expand(height, width, 3)


def composite_over_checkerboard(rgba: Tensor, *, tile: int = 16) -> Tensor:
    """Composite (..., H, W, 4) in [0,1] over a checkerboard (for viz grids)."""
    rgba = ensure_alpha(rgba)
    checker = checkerboard(rgba.shape[-3], rgba.shape[-2], tile=tile, dtype=rgba.dtype,
                           device=rgba.device)
    return composite_over_background(rgba, checker)
