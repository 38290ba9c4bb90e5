"""RgbaVAE: the RGBA-widened AutoencoderKL.

Counterpart of `ragb_vae_tpu/models/rgba_vae.py` (encode, decode, forward,
reconstruct, the fused switch, `remat`, tiling and `from_pretrained_rgb`; the
inline loss and batch slicing are not ported: training uses
`models/losses.py`, as the JAX training loop does). Where the JAX class
passes parameters explicitly, this one owns an `AutoencoderKL` module
(`.module`) whose state dict carries the diffusers keys.

`dtype` is the parameters' dtype and `compute_dtype` (default: the same)
the dtype of activations and kernel operands: serving holds bf16
parameters, training fp32 parameters with bf16 compute.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from ragb_vae_tpu_torch.device import resolve_device
from ragb_vae_tpu_torch.models.vae import AutoencoderKL
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.vae_tiling import needs_tiling, tiled_decode, tiled_encode_moments
from ragb_vae_tpu_torch.models.weights import load_autoencoder_params
from ragb_vae_tpu_torch.ops.gaussian import DiagonalGaussian
from ragb_vae_tpu_torch.ops.rgba import ensure_alpha, from_vae_range, to_vae_range

Tensor = torch.Tensor


class RgbaVAE:
    """Holds the AutoencoderKL module; NHWC images in [0, 1] at the edges."""

    def __init__(
        self,
        config: AutoencoderConfig,
        *,
        dtype: torch.dtype = torch.float32,
        compute_dtype: Optional[torch.dtype] = None,
        fused: bool = False,
        remat: Union[bool, str] = "none",
        device: Union[str, torch.device, None] = None,
    ):
        self.config = config
        self.dtype = dtype
        self.compute_dtype = compute_dtype or dtype
        self.fused = fused
        self.remat = remat
        # diffusers' enable_tiling: encode / decode an image larger than the
        # tile as overlapping tiles blended together (`models/vae_tiling.py`)
        self.use_tiling = False
        self.tile_sample_size: Optional[int] = None
        self.tile_overlap_factor = 0.25
        self.module = AutoencoderKL(config, fused=fused, device=device, dtype=dtype,
                                    compute_dtype=compute_dtype, remat=remat)

    # diffusers-API-parity toggles
    def enable_tiling(self, tile_sample_size: Optional[int] = None) -> None:
        self.use_tiling = True
        if tile_sample_size is not None:
            self.tile_sample_size = tile_sample_size

    def disable_tiling(self) -> None:
        self.use_tiling = False

    def enable_fused(self) -> None:
        """Run ResnetBlocks and Upsamples as the whole-block kernels; the
        parameters do not change, so this can follow `from_pretrained_rgb`."""
        self.fused = True
        self.module.set_fused(True)

    def disable_fused(self) -> None:
        self.fused = False
        self.module.set_fused(False)

    def set_compute_dtype(self, compute_dtype: Optional[torch.dtype]) -> None:
        """Run activations and kernel operands in `compute_dtype` from now on
        (None: the parameters' dtype); the parameters do not change."""
        self.compute_dtype = compute_dtype or self.dtype
        self.module.set_compute_dtype(compute_dtype)

    @classmethod
    def from_pretrained_rgb(
        cls,
        model_name_or_path: Union[str, Path],
        subfolder: Optional[str] = "vae",
        *,
        alpha_bias_init: float = 0.0,
        dtype: torch.dtype = torch.float32,
        compute_dtype: Optional[torch.dtype] = None,
        remat: Union[bool, str] = "none",
        device: Union[str, torch.device] = "cuda",
    ) -> "RgbaVAE":
        """Load an RGB (or already RGBA) diffusers checkpoint, widened to RGBA,
        onto `device`: the card unless the caller names the CPU; a missing
        card raises."""
        device = resolve_device(device)
        config, state = load_autoencoder_params(
            model_name_or_path, subfolder, adapt_to_rgba=True, alpha_bias_init=alpha_bias_init
        )
        model = cls(config, dtype=dtype, compute_dtype=compute_dtype, remat=remat, device="meta")
        model.module.load_state_dict(
            {k: v.to(device=device, dtype=dtype) for k, v in state.items()}, strict=True, assign=True
        )
        return model

    def encode(self, x_vae_range: Tensor) -> DiagonalGaussian:
        """Raw encode of [-1, 1] NHWC inputs -> posterior; with tiling on, an
        image larger than the tile is encoded tile by tile and the moments
        blended."""
        x = x_vae_range.to(self.compute_dtype)
        tile = self.tile_sample_size or self.config.sample_size
        if not (self.use_tiling and needs_tiling(x.shape[1], x.shape[2], tile)):
            return self.module.encode(x)
        moments = tiled_encode_moments(
            lambda v: self.module.encode(v).params, x, tile_sample=tile,
            spatial_scale=self.config.spatial_scale_factor, overlap_factor=self.tile_overlap_factor)
        return DiagonalGaussian.from_params(moments)

    def decode(self, z: Tensor) -> Tensor:
        """Raw decode -> [-1, 1] NHWC output; tiled like `encode`."""
        z = z.to(self.compute_dtype)
        scale = self.config.spatial_scale_factor
        tile_latent = (self.tile_sample_size or self.config.sample_size) // scale
        if not (self.use_tiling and needs_tiling(z.shape[1] * scale, z.shape[2] * scale, tile_latent * scale)):
            return self.module.decode(z)
        return tiled_decode(self.module.decode, z, tile_latent=tile_latent, spatial_scale=scale,
                            overlap_factor=self.tile_overlap_factor)

    def forward(
        self,
        x: Tensor,
        *,
        sample: bool = True,
        eps: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, DiagonalGaussian]:
        """[0,1] RGBA/RGB in -> ([0,1] clamped RGBA reconstruction, posterior)."""
        vae_input = to_vae_range(ensure_alpha(x)).to(self.compute_dtype)
        posterior = self.encode(vae_input)
        if sample:
            z = posterior.sample(eps, generator=generator, dtype=self.compute_dtype)
        else:
            z = posterior.mode().to(self.compute_dtype)
        recon = self.decode(z)
        return torch.clamp(from_vae_range(recon.float()), 0.0, 1.0), posterior

    __call__ = forward

    def reconstruct(self, x: Tensor, **kw) -> Tensor:
        recon, _ = self.forward(x, **kw)
        return recon
