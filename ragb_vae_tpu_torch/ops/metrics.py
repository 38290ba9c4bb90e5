"""Validation metrics (PSNR, alpha MAE), channels-last.

Counterpart of `ragb_vae_tpu/ops/metrics.py`.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def psnr(pred: Tensor, target: Tensor) -> Tensor:
    """Per-sample PSNR in dB over all non-batch axes -> (B,); the mse is
    clamped at 1e-8 so a perfect reconstruction gives 80 dB, not inf."""
    axes = tuple(range(1, pred.ndim))
    mse = torch.mean((pred.float() - target.float()) ** 2, dim=axes).clamp_min(1e-8)
    return -10.0 * torch.log10(mse)


def alpha_mae(pred_rgba: Tensor, target_rgba: Tensor) -> Tensor:
    """Per-sample mean absolute alpha error -> (B,). Channels-last RGBA."""
    diff = torch.abs(pred_rgba[..., 3:].float() - target_rgba[..., 3:].float())
    return torch.mean(diff, dim=tuple(range(1, diff.ndim)))
