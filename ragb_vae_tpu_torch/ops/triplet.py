"""AlphaVAE detail-augmentation triplet (channels-last).

Counterpart of `ragb_vae_tpu/ops/triplet.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def detail_augmented_triplet(target: Tensor) -> Tensor:
    """Stack (original, black-bg, white-bg) along the batch axis (3B, H, W, 4).

    `target` is RGBA in [-1, 1]. With a = the alpha channel in [-1, 1]:
      fg = (1 + a) / 2,  bg = (1 - a) / 2
      black = target * fg - bg     (RGB composited over black)
      white = target * fg + bg     (RGB composited over white)
    and both composites get alpha := 1.
    """
    if target.shape[-1] < 4:
        raise ValueError("detail augmentation expects RGBA tensors.")
    fg_alpha = (1.0 + target[..., 3:4]) * 0.5
    bg_alpha = (1.0 - target[..., 3:4]) * 0.5
    opaque = torch.ones_like(target[..., 3:4])
    black = torch.cat([(target * fg_alpha - bg_alpha)[..., :3], opaque], dim=-1)
    white = torch.cat([(target * fg_alpha + bg_alpha)[..., :3], opaque], dim=-1)
    return torch.cat([target, black, white], dim=0)


def split_triplet(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Split a (3B, ...) tensor back into (original, black, white) chunks."""
    if x.shape[0] % 3 != 0:
        raise ValueError("Batch dimension must be divisible by 3 for triplet splits.")
    a, b, c = torch.chunk(x, 3, dim=0)
    return a, b, c
