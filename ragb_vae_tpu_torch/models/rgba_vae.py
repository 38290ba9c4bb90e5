"""RgbaVAE: the RGBA-widened AutoencoderKL with the AlphaVAE inline loss.

Counterpart of `ragb_vae_tpu/models/rgba_vae.py` (encode, decode, forward,
reconstruct, the fused switch, `remat`, tiling, `from_pretrained_rgb`, the
loss weights and `loss`; batch slicing is not ported). The training step
does not call `loss`: it uses `models/losses.py`, as the JAX training loop
does. Where the JAX class passes parameters explicitly, this one owns an
`AutoencoderKL` module (`.module`) whose state dict carries the diffusers
keys.

`dtype` is the parameters' dtype and `compute_dtype` (default: the same)
the dtype of activations and kernel operands: serving holds bf16
parameters, training fp32 parameters with bf16 compute.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch

from ragb_vae_tpu_torch.device import resolve_device
from ragb_vae_tpu_torch.models.losses import (
    DEFAULT_EB,
    DEFAULT_EB2,
    alphavae_reconstruction_loss,
    reduce_loss,
)
from ragb_vae_tpu_torch.models.vae import AutoencoderKL
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.vae_tiling import needs_tiling, tiled_decode, tiled_encode_moments
from ragb_vae_tpu_torch.models.weights import load_autoencoder_params
from ragb_vae_tpu_torch.ops.gaussian import DiagonalGaussian
from ragb_vae_tpu_torch.ops.rgba import (
    composite_over_black,
    composite_over_white,
    ensure_alpha,
    from_vae_range,
    to_vae_range,
)

Tensor = torch.Tensor


class RgbaVAE:
    """Holds the AutoencoderKL module and the weights of `loss`; NHWC images
    in [0, 1] at the edges."""

    def __init__(
        self,
        config: AutoencoderConfig,
        *,
        beta: float = 0.25,
        alpha_loss_weight: float = 1.0,
        alpha_l1_weight: float = 0.0,
        rgb_loss_weight: float = 1.0,
        white_bg_weight: float = 0.0,
        black_bg_weight: float = 0.0,
        loss_reduce_mean: bool = False,
        use_naive_mse: bool = False,
        eb: Sequence[float] = DEFAULT_EB,
        eb2: Sequence[float] = DEFAULT_EB2,
        dtype: torch.dtype = torch.float32,
        compute_dtype: Optional[torch.dtype] = None,
        fused: bool = False,
        remat: Union[bool, str] = "none",
        device: Union[str, torch.device, None] = None,
    ):
        if len(eb) != 3 or len(eb2) != 3:
            raise ValueError("custom_eb and custom_eb2 must each provide three channel weights.")
        self.config = config
        self.beta = beta
        self.alpha_loss_weight = alpha_loss_weight
        self.alpha_l1_weight = alpha_l1_weight
        self.rgb_loss_weight = rgb_loss_weight
        self.white_bg_weight = white_bg_weight
        self.black_bg_weight = black_bg_weight
        self.loss_reduce_mean = loss_reduce_mean
        self.use_naive_mse = use_naive_mse
        self.eb = tuple(eb)
        self.eb2 = tuple(eb2)
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
        beta: float = 0.25,
        alpha_loss_weight: float = 1.0,
        alpha_l1_weight: float = 0.0,
        rgb_loss_weight: float = 1.0,
        white_bg_weight: float = 0.0,
        black_bg_weight: float = 0.0,
        loss_reduce_mean: bool = False,
        use_naive_mse: bool = False,
        custom_eb: Optional[Sequence[float]] = None,
        custom_eb2: Optional[Sequence[float]] = None,
        dtype: torch.dtype = torch.float32,
        compute_dtype: Optional[torch.dtype] = None,
        remat: Union[bool, str] = "none",
        device: Union[str, torch.device] = "cuda",
    ) -> "RgbaVAE":
        """Load an RGB (or already RGBA) diffusers checkpoint, widened to RGBA,
        onto `device`: the card unless the caller names the CPU; a missing
        card raises. The loss weights are `loss`'s (JAX's names and defaults)."""
        device = resolve_device(device)
        config, state = load_autoencoder_params(
            model_name_or_path, subfolder, adapt_to_rgba=True, alpha_bias_init=alpha_bias_init
        )
        model = cls(
            config, beta=beta, alpha_loss_weight=alpha_loss_weight, alpha_l1_weight=alpha_l1_weight,
            rgb_loss_weight=rgb_loss_weight, white_bg_weight=white_bg_weight,
            black_bg_weight=black_bg_weight, loss_reduce_mean=loss_reduce_mean,
            use_naive_mse=use_naive_mse,
            eb=DEFAULT_EB if custom_eb is None else custom_eb,
            eb2=DEFAULT_EB2 if custom_eb2 is None else custom_eb2,
            dtype=dtype, compute_dtype=compute_dtype, remat=remat, device="meta")
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

    def loss(self, recon: Tensor, target: Tensor, posterior: DiagonalGaussian) -> Tensor:
        """Weighted sum of the Eq. 9 reconstruction (or the naive RGB MSE), the
        white / black background composites' MSE, alpha MSE / L1 and
        beta * KL, in fp32. `recon` and `target` are RGB(A) in [0, 1]."""
        target_rgba = ensure_alpha(target).float()
        recon_rgba = ensure_alpha(recon).float()
        total = torch.zeros((), dtype=torch.float32, device=recon_rgba.device)
        if self.rgb_loss_weight > 0.0:
            if self.use_naive_mse:
                base = reduce_loss((recon_rgba[..., :3] - target_rgba[..., :3]) ** 2,
                                   reduce_mean=self.loss_reduce_mean)
            else:
                base = alphavae_reconstruction_loss(
                    recon_rgba * 2.0 - 1.0, target_rgba * 2.0 - 1.0,
                    eb=self.eb, eb2=self.eb2, reduce_mean=self.loss_reduce_mean)
            total = total + self.rgb_loss_weight * base
        if self.white_bg_weight > 0.0:
            total = total + self.white_bg_weight * torch.mean(
                (composite_over_white(recon_rgba) - composite_over_white(target_rgba)) ** 2)
        if self.black_bg_weight > 0.0:
            total = total + self.black_bg_weight * torch.mean(
                (composite_over_black(recon_rgba) - composite_over_black(target_rgba)) ** 2)
        alpha_diff = recon_rgba[..., 3:] - target_rgba[..., 3:]
        if self.alpha_loss_weight > 0.0:
            total = total + self.alpha_loss_weight * torch.mean(alpha_diff**2)
        if self.alpha_l1_weight > 0.0:
            total = total + self.alpha_l1_weight * torch.mean(torch.abs(alpha_diff))
        return total + self.beta * torch.mean(posterior.kl())
