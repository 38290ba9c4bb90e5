"""Diagonal Gaussian posterior of the KL autoencoder (channels-last).

Counterpart of `ragb_vae_tpu/ops/gaussian.py`: `params` is (..., H, W, 2C),
mean in the first C channels and log-variance in the last C, clamped to
[-30, 20] as diffusers does. Sampling takes the standard-normal draw `eps`
explicitly, so callers decide where the noise comes from (a
`torch.Generator` in the port, numpy in the parity tests).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

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

    @property
    def var(self) -> Tensor:
        return torch.exp(self.logvar)

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

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> Tensor:
        """KL divergence summed over all non-batch axes -> (B,), in fp32:
        against the standard normal, or against `other` (two-Gaussian form)."""
        mean, logvar = self.mean.float(), self.logvar.float()
        var = torch.exp(logvar)
        axes = tuple(range(1, mean.ndim))
        if other is None:
            return 0.5 * torch.sum(mean**2 + var - 1.0 - logvar, dim=axes)
        o_mean, o_logvar = other.mean.float(), other.logvar.float()
        o_var = torch.exp(o_logvar)
        return 0.5 * torch.sum(
            (mean - o_mean) ** 2 / o_var + var / o_var - 1.0 - logvar + o_logvar, dim=axes
        )

    def nll(self, sample: Tensor) -> Tensor:
        """Negative log-likelihood of `sample` per batch element -> (B,), fp32."""
        mean, logvar = self.mean.float(), self.logvar.float()
        axes = tuple(range(1, mean.ndim))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + logvar + (sample.float() - mean) ** 2 / torch.exp(logvar),
            dim=axes,
        )


def split_batch(dist: DiagonalGaussian, parts: int) -> Tuple[DiagonalGaussian, ...]:
    """Split a posterior along the batch axis into `parts` equal chunks."""
    if dist.mean.shape[0] % parts != 0:
        raise ValueError(
            f"Posterior batch dimension {dist.mean.shape[0]} must be divisible by {parts}."
        )
    means = torch.chunk(dist.mean, parts, dim=0)
    logvars = torch.chunk(dist.logvar, parts, dim=0)
    return tuple(DiagonalGaussian(m, lv) for m, lv in zip(means, logvars))
