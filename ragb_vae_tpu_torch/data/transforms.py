"""Sample transforms on the host (numpy, explicit RNG).

Counterpart of `ragb_vae_tpu/data/transforms.py`: with probability `prob`,
`RandomBackgroundBlend` composites the selected RGBA arrays over one random
opaque colour and sets their alpha to 1. It draws from a numpy Generator in
the JAX package's order, so the same seed gives the same samples bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class RandomBackgroundBlend:
    def __init__(
        self,
        prob: float = 0.1,
        keys: Sequence[str] = ("component",),
        color_range: Tuple[float, float] = (0.2, 0.9),
        seed: Optional[int] = None,
    ) -> None:
        if color_range[0] >= color_range[1]:
            raise ValueError("color_range lower bound must be < upper bound.")
        self.prob = prob
        self.keys = tuple(keys)
        self.color_range = color_range
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: Dict) -> Dict:
        sample = dict(sample)
        if self.rng.random() >= self.prob:
            sample.setdefault("background_augmented", False)
            return sample
        for key in self.keys:
            if sample.get(key) is not None:
                sample[key] = self._blend(sample[key])
        sample["background_augmented"] = True
        return sample

    def _blend(self, rgba: np.ndarray) -> np.ndarray:
        """(H, W, 4) over a uniform random colour, alpha := 1."""
        alpha = rgba[..., 3:4]
        color = self.rng.uniform(*self.color_range, size=(1, 1, 3)).astype(rgba.dtype)
        blended = rgba[..., :3] * alpha + color * (1.0 - alpha)
        return np.concatenate([blended, np.ones_like(alpha)], axis=-1)
