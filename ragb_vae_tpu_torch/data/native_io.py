"""ctypes bindings for the port's native PNG codec (`csrc/rgba_io.cpp`).

Counterpart of `ragb_vae_tpu/data/native_io.py`. The decode -> normalise ->
pad -> stack chain of the input pipeline runs in C++ worker threads over
libpng and hands back one ready (B, H, W, 4) float32 batch; `encode_batch`
writes output PNGs the same way. The library is a host library, built with
g++ on first use into `<repo>/build/host/` (`ops/kernels/_build.py`,
`build_rgba_io`), never at import. Where it cannot be built (no g++, no
libpng headers) or `RAGB_NO_NATIVE_IO` is set, `available()` is False and
every call site keeps its PIL path, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_lock = threading.Lock()
load_error: Optional[str] = None    # why the library is not available, when it is not

_P_FLOAT = ctypes.POINTER(ctypes.c_float)
_P_INT = ctypes.POINTER(ctypes.c_int)
_P_STR = ctypes.POINTER(ctypes.c_char_p)
_I = ctypes.c_int
_SIGNATURES = {
    "ragb_decode_png_f32": [ctypes.c_char_p, _P_FLOAT, _I, _I, _P_INT, _P_INT],
    "ragb_png_size": [ctypes.c_char_p, _P_INT, _P_INT],
    "ragb_decode_batch_f32": [_P_STR, _I, _P_FLOAT, _I, _I, _I, _P_INT],
    "ragb_encode_png_f32": [ctypes.c_char_p, _P_FLOAT, _I, _I, _I],
    "ragb_encode_batch_f32": [_P_STR, _I, _P_FLOAT, _I, _I, _I, _I, _P_INT],
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, load_error
    if _lib is not None or _load_attempted:
        return _lib
    with _lock:
        if _load_attempted:
            return _lib
        if os.environ.get("RAGB_NO_NATIVE_IO"):
            load_error = "RAGB_NO_NATIVE_IO is set"
        else:
            from ragb_vae_tpu_torch.ops.kernels._build import build_rgba_io

            try:
                lib = ctypes.CDLL(str(build_rgba_io()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                _lib = lib
            except (OSError, RuntimeError, AttributeError) as exc:
                load_error = str(exc)
        _load_attempted = True
    return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library not available: {load_error}")
    return lib


def available() -> bool:
    return _load() is not None


def _c_paths(paths: Sequence) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def png_size(path) -> Tuple[int, int]:
    """(width, height) without decoding pixels."""
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = _require().ragb_png_size(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"ragb_png_size failed ({rc}) for {path}")
    return w.value, h.value


def decode_png(path, *, max_h: Optional[int] = None, max_w: Optional[int] = None) -> np.ndarray:
    """Decode one PNG -> (H, W, 4) float32 in [0,1] (or zero-padded to
    (max_h, max_w, 4) when given)."""
    lib = _require()
    if max_h is None or max_w is None:
        max_w, max_h = png_size(path)
    buf = np.empty((max_h, max_w, 4), dtype=np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ragb_decode_png_f32(str(path).encode(), buf.ctypes.data_as(_P_FLOAT), max_h, max_w,
                                 ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"ragb_decode_png_f32 failed ({rc}) for {path}")
    return buf


def decode_batch(paths: Sequence, max_h: int, max_w: int, *, num_threads: int = 8) -> np.ndarray:
    """Decode PNGs into one (B, max_h, max_w, 4) float32 batch with C++
    worker threads. Raises on any per-image failure (path named)."""
    lib = _require()
    count = len(paths)
    out = np.empty((count, max_h, max_w, 4), dtype=np.float32)
    status = (ctypes.c_int * count)()
    failures = lib.ragb_decode_batch_f32(_c_paths(paths), count, out.ctypes.data_as(_P_FLOAT), max_h, max_w,
                                         num_threads, status)
    if failures:
        bad: List[str] = [str(paths[i]) for i in range(count) if status[i] != 0]
        raise IOError(f"native decode failed for {len(bad)} images, first: {bad[0]}")
    return out


def encode_png(path, image: np.ndarray, *, compression: int = 6) -> None:
    """Encode one (H, W, 4) float32 [0,1] image to an 8-bit RGBA PNG."""
    lib = _require()
    arr = np.ascontiguousarray(image, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 4:
        raise ValueError(f"encode_png expects (H, W, 4), got {arr.shape}")
    rc = lib.ragb_encode_png_f32(str(path).encode(), arr.ctypes.data_as(_P_FLOAT), arr.shape[0], arr.shape[1],
                                 compression)
    if rc != 0:
        raise IOError(f"ragb_encode_png_f32 failed ({rc}) for {path}")


def encode_batch(paths: Sequence, batch: np.ndarray, *, compression: int = 6, num_threads: int = 8) -> None:
    """Encode a (B, H, W, 4) float32 [0,1] batch to PNGs with C++ worker
    threads."""
    lib = _require()
    arr = np.ascontiguousarray(batch, dtype=np.float32)
    if arr.ndim != 4 or arr.shape[-1] != 4:
        raise ValueError(f"encode_batch expects (B, H, W, 4), got {arr.shape}")
    if len(paths) != arr.shape[0]:
        raise ValueError(f"{len(paths)} paths for batch of {arr.shape[0]}")
    count = len(paths)
    status = (ctypes.c_int * count)()
    failures = lib.ragb_encode_batch_f32(_c_paths(paths), count, arr.ctypes.data_as(_P_FLOAT), arr.shape[1],
                                         arr.shape[2], compression, num_threads, status)
    if failures:
        bad = [str(paths[i]) for i in range(count) if status[i] != 0]
        raise IOError(f"native encode failed for {len(bad)} images, first: {bad[0]}")
