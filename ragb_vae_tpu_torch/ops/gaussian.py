"""Diagonal Gaussian posterior of the KL autoencoder (channels-last).

Counterpart of `ragb_vae_tpu/ops/gaussian.py`: `params` is (..., H, W, 2C),
mean in the first C channels and log-variance in the last C, clamped to
[-30, 20] as diffusers does. Sampling takes the standard-normal draw `eps`
explicitly, so callers decide where the noise comes from (a
`torch.Generator` in the port, numpy in the parity tests).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class DiagonalGaussian(NamedTuple):
    mean: Tensor
    logvar: Tensor

    @classmethod
    def from_params(cls, params: Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(params, 2, dim=-1)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    @property
    def params(self) -> Tensor:
        return torch.cat([self.mean, self.logvar], dim=-1)

    @property
    def std(self) -> Tensor:
        return torch.exp(0.5 * self.logvar)

    def mode(self) -> Tensor:
        return self.mean

    def sample(
        self,
        eps: Optional[Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> Tensor:
        """Reparameterised sample mean + std * eps. Without `eps`, a standard
        normal is drawn from `generator` on the posterior's device."""
        dtype = dtype or self.mean.dtype
        if eps is None:
            eps = torch.randn(
                self.mean.shape, generator=generator, device=self.mean.device, dtype=torch.float32
            )
        return self.mean.to(dtype) + self.std.to(dtype) * eps.to(dtype)
