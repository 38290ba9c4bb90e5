"""Host-side image IO: PIL decode -> numpy HWC float32 in [0, 1].

Counterpart of `ragb_vae_tpu/data/image_io.py` through PIL alone (the
JAX package's optional native PNG codec is not ported yet).
"""
from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
from PIL import Image, UnidentifiedImageError


def pil_to_array(img: Image.Image) -> np.ndarray:
    """PIL image -> (H, W, 4) float32 in [0,1]; grey is tripled, RGB gets alpha 1."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[2] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    return arr


def load_rgba(path: Union[str, Path]) -> np.ndarray:
    """Decode an image file as RGBA -> (H, W, 4) float32 in [0,1]."""
    path = Path(path)
    try:
        with Image.open(path) as img:
            rgba = img.convert("RGBA")
    except (UnidentifiedImageError, OSError, ValueError) as exc:
        raise RuntimeError(f"Failed to load image at {path}: {exc}") from exc
    return pil_to_array(rgba)


def save_rgba(array: np.ndarray, path: Union[str, Path]) -> None:
    """(H, W, 4) float in [0,1] -> image file (PNG by suffix)."""
    arr = np.clip(np.asarray(array, dtype=np.float32), 0.0, 1.0)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((arr * 255).astype(np.uint8), mode="RGBA").save(path)
