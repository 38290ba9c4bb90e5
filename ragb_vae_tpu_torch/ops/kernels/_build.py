"""Build and load the port's CUDA kernels (`ragb_vae_tpu_torch/csrc/*.cu`).

The sources compile with `nvcc` for Hopper (`sm_90a`), one `nvcc` per `.cu`
file and all of them at once, and link into ONE shared library with a plain
C interface, loaded with `ctypes`. Nothing here runs at
import time: `library()` builds on its first call, so the package imports on
a machine with no CUDA toolkit, and only the first kernel launch needs one.

The library lands in `<repo>/build/kernels/`, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused. A
build writes to a temporary name and `os.replace`s it into place, so two
processes building at once never load a half-written file.

`build_rgba_io()` builds the one host library of the port, the PNG codec of
`csrc/rgba_io.cpp` (C++ over libpng, no CUDA), with `g++` into
`<repo>/build/host/` by the same rules, under a file lock so that
processes starting together build it once.
"""
from __future__ import annotations

import ctypes
import fcntl
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
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
RGBA_IO_SOURCE = CSRC_DIR / "rgba_io.cpp"
HOST_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
HOST_LIBS = ["-lpng", "-lpthread"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported launchers (each returns a cudaError_t as int)
_SIGNATURES = {
    "ragb_error_string": [_I],
    "ragb_resnet_conv3x3_stats": [_P] * 11 + [_I] * 9 + [_P],
    "ragb_wino_tile_shape": [_P, _P],
    "ragb_resnet_conv3x3_stats_wino": [_P] * 12 + [_I] * 9 + [_P],
    "ragb_subpixel_upsample_conv3x3_stats": [_P] * 6 + [_I] * 6 + [_P],
    "ragb_flash_attention_fwd": [_P] * 8 + [_I] * 5 + [_F, _P],
    "ragb_resnet_conv3x3_stats_bwd": [_P] * 21 + [_I] * 12 + [_P],
    "ragb_subpixel_upsample_conv3x3_stats_bwd": [_P] * 11 + [_I] * 7 + [_P],
    "ragb_resnet_skip_grad": [_P] * 3 + [_I] * 5 + [_P],
    "ragb_flash_attention_dq": [_P] * 7 + [_I] * 4 + [_F, _P],
    "ragb_flash_attention_dkv": [_P] * 8 + [_I] * 4 + [_F, _P],
    "ragb_flash_attention_bwd": [_P] * 9 + [_I] * 4 + [_F, _P],
    "ragb_int8_matmul": [_P] * 5 + [_I] * 4 + [_P],
    "ragb_conv_sm90_tile_shape": [_P, _P],
    "ragb_conv3x3_same": [_P] * 3 + [_I] * 5 + [_P],
    "ragb_fused_gn_silu_conv3x3": [_P] * 6 + [_I] * 5 + [_P],
    "ragb_downsample_conv3x3_stats": [_P] * 6 + [_I] * 6 + [_P],
    "ragb_attn_prologue_fwd": [_P] * 15 + [_I] * 7 + [_F, _P],
    "ragb_attn_prologue_bwd": [_P] * 20 + [_I] * 8 + [_F, _P],
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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = str(Path(objdir) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
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


def _stream_ptr(index: int) -> int:
    """The raw cudaStream_t of PyTorch's current stream on CUDA device
    `index`: one call into the extension, where `torch.cuda.current_stream(
    device).cuda_stream` builds a Stream object first."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def launch(export: str, device, *args) -> int:
    """Call the library's launcher `export` on `args` and the current stream
    of the CUDA `device`, with `device` the CUDA runtime's current device for
    the call; returns its cudaError_t (pass it to `check`). Every kernel
    wrapper launches through here.

    The launchers act on the current device: the shared-memory opt-in
    (`cudaFuncSetAttribute`), the SM count and the launch itself. PyTorch's
    own ops guard their tensor's device; this does the same for ours, so a
    tensor on `cuda:1` launches on `cuda:1` whatever device is current (a
    pipeline stage's forward, a caller that never set one). The guard reads
    the current device and switches only when it differs, and switches back
    after the call."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    current = torch._C._cuda_getDevice()
    if current == index:
        return getattr(library(), export)(*args, ctypes.c_void_p(_stream_ptr(index)))
    torch._C._cuda_setDevice(index)
    try:
        return getattr(library(), export)(*args, ctypes.c_void_p(_stream_ptr(index)))
    finally:
        torch._C._cuda_setDevice(current)


def query(export: str, *args) -> int:
    """Call one of the library's host-only exports (a tile shape, no launch)."""
    return getattr(library(), export)(*args)


def rgba_io_path() -> Path:
    h = hashlib.sha256(RGBA_IO_SOURCE.read_bytes())
    h.update(" ".join(HOST_CXX_FLAGS + HOST_LIBS).encode())
    return HOST_BUILD_DIR / f"libragb_io_{h.hexdigest()[:16]}.so"


def build_rgba_io() -> Path:
    """Compile `csrc/rgba_io.cpp` with g++ unless a library of this hash
    exists; return its path. Raises RuntimeError when g++ or libpng's
    headers are missing or the compile fails."""
    target = rgba_io_path()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for csrc/rgba_io.cpp")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(HOST_BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one builder; the others wait and reuse
        if target.exists():
            return target
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=HOST_BUILD_DIR)
        os.close(fd)
        cmd = [cxx, *HOST_CXX_FLAGS, str(RGBA_IO_SOURCE), "-o", tmp, *HOST_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, target)
    return target
