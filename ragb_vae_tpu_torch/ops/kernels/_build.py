"""Build and load the port's CUDA kernels (`ragb_vae_tpu_torch/csrc/*.cu`).

The sources compile with `nvcc` for Hopper (`sm_90a`) into ONE shared
library with a plain C interface, loaded with `ctypes`. Nothing here runs at
import time: `library()` builds on its first call, so the package imports on
a machine with no CUDA toolkit, and only the first kernel launch needs one.

The library lands in `<repo>/build/kernels/`, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused. A
build writes to a temporary name and `os.replace`s it into place, so two
processes building at once never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported launchers (each returns a cudaError_t as int)
_SIGNATURES = {
    "ragb_error_string": [_I],
    "ragb_conv_tile_shape": [_P, _P],
    "ragb_resnet_conv3x3_stats": [_P] * 11 + [_I] * 9 + [_P],
    "ragb_subpixel_upsample_conv3x3_stats": [_P] * 6 + [_I] * 6 + [_P],
    "ragb_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels need the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH)."
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libragb_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of this hash exists; return its path."""
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cu_files = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu_files]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ragb_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = library().ragb_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
