"""Tiled VAE encode and decode (bounded memory for large images).

Counterpart of `ragb_vae_tpu/models/vae_tiling.py`, diffusers' `tiled_encode`
/ `tiled_decode` arithmetic: overlapping spatial tiles run on their own, each
tile's top rows and left columns are ramp-blended with its UNBLENDED
neighbours above and to the left (moments for encode, pixels for decode), and
the tiles are cropped and stitched. Tensors are NHWC. Gradients flow through
the tiles and the blends. The JAX package's batch slicing (`sliced_apply`,
`sharded_sliced_apply`, a `lax.map` over the batch) is not ported.
"""
from __future__ import annotations

from typing import Callable, List

import torch

Tensor = torch.Tensor

DEFAULT_OVERLAP_FACTOR = 0.25


def _ramp(extent: int, like: Tensor, axis: int) -> Tensor:
    shape = [1, 1, 1, 1]
    shape[axis] = extent
    return (torch.arange(extent, dtype=torch.float32, device=like.device) / extent).reshape(shape)


def blend_v(above: Tensor, below: Tensor, blend_extent: int) -> Tensor:
    """Blend the top rows of `below` with the bottom rows of `above` (axis 1)."""
    extent = min(above.shape[1], below.shape[1], blend_extent)
    if extent <= 0:
        return below
    ramp = _ramp(extent, below, 1)
    top = above[:, -extent:].float() * (1.0 - ramp) + below[:, :extent].float() * ramp
    return torch.cat([top.to(below.dtype), below[:, extent:]], dim=1)


def blend_h(left: Tensor, right: Tensor, blend_extent: int) -> Tensor:
    """Blend the left columns of `right` with the right columns of `left` (axis 2)."""
    extent = min(left.shape[2], right.shape[2], blend_extent)
    if extent <= 0:
        return right
    ramp = _ramp(extent, right, 2)
    lead = left[:, :, -extent:].float() * (1.0 - ramp) + right[:, :, :extent].float() * ramp
    return torch.cat([lead.to(right.dtype), right[:, :, extent:]], dim=2)


def _tiled_apply(fn: Callable[[Tensor], Tensor], x: Tensor, *, tile_in: int, scale: float,
                 overlap_factor: float) -> Tensor:
    """diffusers' tiling; `scale` = output size / input size."""
    stride = int(tile_in * (1.0 - overlap_factor))
    tile_out = int(tile_in * scale)
    blend_extent = int(tile_out * overlap_factor)
    limit = tile_out - blend_extent
    h, w = x.shape[1], x.shape[2]
    rows: List[List[Tensor]] = [
        [fn(x[:, i : i + tile_in, j : j + tile_in]) for j in range(0, w, stride)]
        for i in range(0, h, stride)
    ]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_v(rows[i - 1][j], tile, blend_extent)
            if j > 0:
                tile = blend_h(row[j - 1], tile, blend_extent)
            out_row.append(tile[:, :limit, :limit])
        out_rows.append(torch.cat(out_row, dim=2))
    return torch.cat(out_rows, dim=1)


def tiled_encode_moments(
    encode_moments: Callable[[Tensor], Tensor],
    x: Tensor,
    *,
    tile_sample: int,
    spatial_scale: int,
    overlap_factor: float = DEFAULT_OVERLAP_FACTOR,
) -> Tensor:
    """x (B, H, W, C) -> blended Gaussian moments (B, h, w, 2 * latent)."""
    return _tiled_apply(encode_moments, x, tile_in=tile_sample, scale=1.0 / spatial_scale,
                        overlap_factor=overlap_factor)


def tiled_decode(
    decode: Callable[[Tensor], Tensor],
    z: Tensor,
    *,
    tile_latent: int,
    spatial_scale: int,
    overlap_factor: float = DEFAULT_OVERLAP_FACTOR,
) -> Tensor:
    """z (B, h, w, latent) -> blended reconstruction (B, H, W, C)."""
    return _tiled_apply(decode, z, tile_in=tile_latent, scale=float(spatial_scale),
                        overlap_factor=overlap_factor)


def needs_tiling(height: int, width: int, tile_sample: int) -> bool:
    """diffusers' gate: tile only an image larger than the tile."""
    return height > tile_sample or width > tile_sample
