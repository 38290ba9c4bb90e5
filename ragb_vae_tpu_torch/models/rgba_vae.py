"""RgbaVAE: the RGBA-widened AutoencoderKL, inference side.

Counterpart of `ragb_vae_tpu/models/rgba_vae.py` (encode, decode, forward,
reconstruct, the fused switch and `from_pretrained_rgb`; the loss, tiling
and slicing are not ported yet). Where the JAX class passes parameters
explicitly, this one owns an `AutoencoderKL` module (`.module`) whose state
dict carries the diffusers keys.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from ragb_vae_tpu_torch.models.vae import AutoencoderKL
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
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
        fused: bool = False,
        device: Union[str, torch.device, None] = None,
    ):
        self.config = config
        self.dtype = dtype
        self.fused = fused
        self.module = AutoencoderKL(config, fused=fused, device=device, dtype=dtype)

    # diffusers-API-parity toggles
    def enable_fused(self) -> None:
        """Run ResnetBlocks and Upsamples as the whole-block kernels; the
        parameters do not change, so this can follow `from_pretrained_rgb`."""
        self.fused = True
        self.module.set_fused(True)

    def disable_fused(self) -> None:
        self.fused = False
        self.module.set_fused(False)

    @classmethod
    def from_pretrained_rgb(
        cls,
        model_name_or_path: Union[str, Path],
        subfolder: Optional[str] = "vae",
        *,
        alpha_bias_init: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device, None] = None,
    ) -> "RgbaVAE":
        """Load an RGB (or already RGBA) diffusers checkpoint, widened to RGBA."""
        config, state = load_autoencoder_params(
            model_name_or_path, subfolder, adapt_to_rgba=True, alpha_bias_init=alpha_bias_init
        )
        model = cls(config, dtype=dtype, device="meta")
        model.module.load_state_dict(
            {k: v.to(dtype) for k, v in state.items()}, strict=True, assign=True
        )
        if device is not None:
            model.module.to(device)
        return model

    def encode(self, x_vae_range: Tensor) -> DiagonalGaussian:
        """Raw encode of [-1, 1] NHWC inputs -> posterior."""
        return self.module.encode(x_vae_range.to(self.dtype))

    def decode(self, z: Tensor) -> Tensor:
        """Raw decode -> [-1, 1] NHWC output."""
        return self.module.decode(z.to(self.dtype))

    def forward(
        self,
        x: Tensor,
        *,
        sample: bool = True,
        eps: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, DiagonalGaussian]:
        """[0,1] RGBA/RGB in -> ([0,1] clamped RGBA reconstruction, posterior)."""
        vae_input = to_vae_range(ensure_alpha(x)).to(self.dtype)
        posterior = self.encode(vae_input)
        if sample:
            z = posterior.sample(eps, generator=generator, dtype=self.dtype)
        else:
            z = posterior.mode().to(self.dtype)
        recon = self.decode(z)
        return torch.clamp(from_vae_range(recon.float()), 0.0, 1.0), posterior

    __call__ = forward

    def reconstruct(self, x: Tensor, **kw) -> Tensor:
        recon, _ = self.forward(x, **kw)
        return recon
