"""AlphaVAE loss bundle (reconstruction Eq. 9, KL, LPIPS composites).

Counterpart of `ragb_vae_tpu/models/losses.py`: plain functions and a small
config dataclass. Channel priors Eb / Eb^2 default to the AlphaVAE paper's
values. All losses are computed in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ragb_vae_tpu_torch.device import constant
from ragb_vae_tpu_torch.ops.gaussian import DiagonalGaussian

Tensor = torch.Tensor

DEFAULT_EB: Tuple[float, float, float] = (-0.0357, -0.0811, -0.1797)
DEFAULT_EB2: Tuple[float, float, float] = (0.3163, 0.3060, 0.3634)


def weighted_batch_mean(per_sample: Tensor, weights: Optional[Tensor]) -> Tensor:
    """Mean of a (B,) vector, or its weighted mean under (B,) `weights`
    (zeros mark padding samples, which then change nothing)."""
    if weights is None:
        return per_sample.mean()
    w = weights.float()
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1e-8)


def reduce_loss(value: Tensor, *, reduce_mean: bool, weights: Optional[Tensor] = None) -> Tensor:
    """Per-sample mean (reduce_mean) or sum over the non-batch axes, then the
    batch mean, weighted when `weights` (B,) is given."""
    if value.ndim == 0:
        return value
    flat = value.reshape(value.shape[0], -1)
    per_sample = flat.mean(dim=1) if reduce_mean else flat.sum(dim=1)
    return weighted_batch_mean(per_sample, weights)


def alphavae_reconstruction_loss(
    pred: Tensor,
    target: Tensor,
    *,
    eb: Sequence[float] = DEFAULT_EB,
    eb2: Sequence[float] = DEFAULT_EB2,
    reduce_mean: bool = False,
    use_naive_mse: bool = False,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """AlphaVAE Eq. (9) premultiplied reconstruction loss.

    `pred` / `target` are RGBA in [-1, 1], channels-last. With alpha mapped
    to [0, 1]:
      d = t_rgb*t_a - p_rgb*p_a,   da = t_a - p_a
      loss = d^2 - 2*Eb*d*da + Eb^2*da^2    (per-channel priors Eb, Eb^2)
    """
    pred, target = pred.float(), target.float()
    if use_naive_mse:
        return reduce_loss((pred - target) ** 2, reduce_mean=reduce_mean, weights=weights)
    target_alpha = (target[..., 3:] + 1.0) * 0.5
    pred_alpha = (pred[..., 3:] + 1.0) * 0.5
    rgba_diff = target[..., :3] * target_alpha - pred[..., :3] * pred_alpha
    alpha_diff = target_alpha - pred_alpha
    eb_t = constant(eb, torch.float32, pred.device)
    eb2_t = constant(eb2, torch.float32, pred.device)
    loss = rgba_diff**2 - 2.0 * eb_t * rgba_diff * alpha_diff + eb2_t * alpha_diff**2
    return reduce_loss(loss, reduce_mean=reduce_mean, weights=weights)


def kl_loss(
    posterior: DiagonalGaussian,
    reference: Optional[DiagonalGaussian] = None,
    *,
    reduce_mean: bool = False,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """KL (optionally against a frozen reference posterior); `kl()` is
    already per-sample, so both reductions are a batch mean."""
    return reduce_loss(posterior.kl(reference), reduce_mean=reduce_mean, weights=weights)


def perceptual_composites(pred: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Black / white composites fed to LPIPS, inputs in [-1, 1]: (pred_black,
    target_black, pred_white, target_white). They live in the premultiplied
    [0, 1]-ish space and go to LPIPS unnormalised, as the reference does."""
    target_rgb, pred_rgb = target[..., :3].float(), pred[..., :3].float()
    target_alpha = (target[..., 3:] + 1.0) * 0.5
    pred_alpha = (pred[..., 3:] + 1.0) * 0.5
    target_black = target_rgb * target_alpha
    pred_black = pred_rgb * pred_alpha
    target_white = target_black + (1.0 - target_alpha)
    pred_white = pred_black + (1.0 - pred_alpha)
    return pred_black, target_black, pred_white, target_white


@dataclasses.dataclass(frozen=True)
class AlphaVaeLossConfig:
    reduce_mean: bool = False
    use_naive_mse: bool = False
    use_lpips: bool = False
    eb: Tuple[float, float, float] = DEFAULT_EB
    eb2: Tuple[float, float, float] = DEFAULT_EB2

    def __post_init__(self):
        if len(self.eb) != 3 or len(self.eb2) != 3:
            raise ValueError("eb/eb2 must each provide three channel weights.")

    def reconstruction_loss(self, pred: Tensor, target: Tensor, weights: Optional[Tensor] = None) -> Tensor:
        return alphavae_reconstruction_loss(
            pred, target, eb=self.eb, eb2=self.eb2, reduce_mean=self.reduce_mean,
            use_naive_mse=self.use_naive_mse, weights=weights,
        )

    def kl_loss(
        self,
        posterior: DiagonalGaussian,
        reference: Optional[DiagonalGaussian] = None,
        weights: Optional[Tensor] = None,
    ) -> Tensor:
        return kl_loss(posterior, reference, reduce_mean=self.reduce_mean, weights=weights)
