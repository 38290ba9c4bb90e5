"""Host-side image IO: PNG / PIL decode -> numpy HWC float32 in [0, 1].

Counterpart of `ragb_vae_tpu/data/image_io.py`. PNGs take the native codec
(`data/native_io.py`, libpng in C++) when it is built; other files, and any
native failure, go through PIL, as in the JAX package.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np
from PIL import Image, PngImagePlugin, UnidentifiedImageError

from ragb_vae_tpu_torch.data import native_io

# PIL refuses a PNG text or iCCP chunk that decompresses past MAX_TEXT_CHUNK
# (1 MiB by default); the datasets' large embedded profiles need more. Raised
# to PNG_MAX_TEXT_CHUNK bytes (64 MiB unless set), as in the JAX package.
PNG_TEXT_CHUNK_LIMIT = int(os.environ.get("PNG_MAX_TEXT_CHUNK", 64 * 1024 * 1024))
if hasattr(PngImagePlugin, "MAX_TEXT_CHUNK"):
    PngImagePlugin.MAX_TEXT_CHUNK = max(PngImagePlugin.MAX_TEXT_CHUNK, PNG_TEXT_CHUNK_LIMIT)


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
    if path.suffix.lower() == ".png" and native_io.available():
        try:
            return native_io.decode_png(path)
        except Exception:
            pass  # PIL below (interlaced or odd PNGs)
    try:
        with Image.open(path) as img:
            rgba = img.convert("RGBA")
    except (UnidentifiedImageError, OSError, ValueError) as exc:
        raise RuntimeError(f"Failed to load image at {path}: {exc}") from exc
    return pil_to_array(rgba)


def save_rgba(array: np.ndarray, path: Union[str, Path]) -> None:
    """(H, W, 4) float in [0,1] -> image file (PNG by suffix); a PNG takes the
    native encode, which writes the bytes PIL's path would quantise to."""
    arr = np.clip(np.asarray(array, dtype=np.float32), 0.0, 1.0)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix.lower() == ".png" and native_io.available():
        try:
            return native_io.encode_png(path, arr)
        except Exception:
            pass  # PIL below
    Image.fromarray((arr * 255).astype(np.uint8), mode="RGBA").save(path)
