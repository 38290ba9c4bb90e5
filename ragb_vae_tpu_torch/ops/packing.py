"""FLUX latent packing / unpacking and positional-id grids (channels-last).

Counterpart of `ragb_vae_tpu/ops/packing.py`. Packing keeps diffusers'
channel-major token feature order (feature = c*4 + hsub*2 + wsub) so
imported `x_embedder` weights line up.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def pack_latents(latents: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, (H/2)*(W/2), C*4) with 2x2 spatial patching."""
    b, h, w, c = latents.shape
    if h % 2 or w % 2:
        raise ValueError(f"Latent spatial dims must be even, got {(h, w)}")
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, h2, w2, C, hs, ws)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: Tensor, latent_height: int, latent_width: int) -> Tensor:
    """(B, N, C*4) -> (B, latent_height, latent_width, C). Inverse of pack."""
    b, n, f = tokens.shape
    h2, w2 = latent_height // 2, latent_width // 2
    if n != h2 * w2:
        raise ValueError(f"Token count {n} does not match latent dims {(latent_height, latent_width)}")
    c = f // 4
    x = tokens.reshape(b, h2, w2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, h2, hs, w2, ws, C)
    return x.reshape(b, latent_height, latent_width, c)


def latent_dims_for_pixels(pixel_height: int, pixel_width: int, vae_scale_factor: int = 8):
    """Pixel dims -> even latent dims, matching diffusers' rounding."""
    lh = 2 * (int(pixel_height) // (vae_scale_factor * 2))
    lw = 2 * (int(pixel_width) // (vae_scale_factor * 2))
    return lh, lw


def prepare_latent_image_ids(
    height: int, width: int, *, device=None, dtype: torch.dtype = torch.float32
) -> Tensor:
    """RoPE position ids (height*width, 3) for a packed latent grid:
    ids[:, 0] = 0, ids[:, 1] = row, ids[:, 2] = column."""
    row = torch.arange(height, device=device, dtype=dtype)[:, None].expand(height, width)
    col = torch.arange(width, device=device, dtype=dtype)[None, :].expand(height, width)
    ids = torch.stack([torch.zeros_like(row), row, col], dim=-1)
    return ids.reshape(height * width, 3)
