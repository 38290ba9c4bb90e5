"""FlowMatchEulerDiscreteScheduler, inference side.

Counterpart of `ragb_vae_tpu/models/scheduler.py` (math copied, the port
must not import the JAX package): sigma schedule t/N with a static shift
s*σ/(1+(s-1)σ) or the dynamic exponential time-shift e^μ/(e^μ + (1/σ - 1)),
timesteps = σ·N, Euler update x + (σ_next - σ)·v. The schedule is built on
the host in numpy; `step` works on tensors.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class FlowMatchEulerConfig:
    """Mirrors scheduler_config.json of FLUX checkpoints."""

    num_train_timesteps: int = 1000
    shift: float = 3.0
    use_dynamic_shifting: bool = True
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> "FlowMatchEulerConfig":
        raw = json.loads(Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def calc_mu(config: FlowMatchEulerConfig, seq_len: Optional[int]) -> Optional[float]:
    """Dynamic-shift μ: linear in the image sequence length between
    (base_seq, base_shift) and (max_seq, max_shift), seq_len clamped."""
    if not config.use_dynamic_shifting:
        return None

    def _cfg(value, default):
        # 0 / 0.0 are legitimate config values a falsy `or` would replace
        return default if value is None else value

    base_seq = _cfg(config.base_image_seq_len, 256)
    max_seq = _cfg(config.max_image_seq_len, 4096)
    base_shift = _cfg(config.base_shift, 0.5)
    max_shift = _cfg(config.max_shift, 1.15)
    if seq_len is None:
        seq_len = base_seq
    seq_len = max(min(int(seq_len), max_seq), base_seq)
    m = (max_shift - base_shift) / (max_seq - base_seq)
    b = base_shift - m * base_seq
    return float(seq_len * m + b)


def _time_shift_exponential(mu: float, sigma_pow: float, t: np.ndarray) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma_pow)


def _static_shift(shift: float, sigmas: np.ndarray) -> np.ndarray:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


class FlowMatchEulerScheduler:
    """Holds the (timesteps, sigmas) schedule; the Euler step takes the step
    index explicitly instead of diffusers' mutable `_step_index`."""

    def __init__(self, config: Optional[FlowMatchEulerConfig] = None):
        self.config = config or FlowMatchEulerConfig()
        n = self.config.num_train_timesteps
        timesteps = np.linspace(1, n, n, dtype=np.float64)[::-1].copy()
        sigmas = timesteps / n
        if not self.config.use_dynamic_shifting:
            sigmas = _static_shift(self.config.shift, sigmas)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.timesteps = (sigmas * n).astype(np.float32)
        self.sigmas = sigmas.astype(np.float32)
        self.num_inference_steps: Optional[int] = None

    def set_timesteps(self, num_inference_steps: int, *, mu: Optional[float] = None) -> None:
        """Parity with diffusers set_timesteps(num, mu=mu); appends sigma 0."""
        cfg = self.config
        n = cfg.num_train_timesteps
        timesteps = np.linspace(
            self.sigma_max * n, self.sigma_min * n, num_inference_steps, dtype=np.float64
        )
        sigmas = timesteps / n
        if cfg.use_dynamic_shifting:
            if mu is None:
                raise ValueError("use_dynamic_shifting requires `mu` in set_timesteps.")
            sigmas = _time_shift_exponential(mu, 1.0, sigmas)
        else:
            sigmas = _static_shift(cfg.shift, sigmas)
        self.timesteps = (sigmas * n).astype(np.float32)
        self.sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        self.num_inference_steps = num_inference_steps

    def step(self, model_output: torch.Tensor, step_index: int, sample: torch.Tensor) -> torch.Tensor:
        """Euler update x_{i+1} = x_i + (σ_{i+1} − σ_i)·v, in fp32."""
        if self.num_inference_steps is None:
            raise ValueError(
                "Call set_timesteps(num_inference_steps, ...) before step(): the "
                "training-side schedule has no trailing sigma=0 to step onto."
            )
        sigma = float(self.sigmas[step_index])
        sigma_next = float(self.sigmas[step_index + 1])
        prev = sample.float() + (sigma_next - sigma) * model_output.float()
        return prev.to(sample.dtype)
