"""Time variants of K1's and K12's activation stage (the conv engine's
`CONV_ACT` mode in `ragb_vae_tpu_torch/csrc/conv_sm90.cuh`) side by side on
one NVIDIA GPU, to see what the stage costs and where.

    python3 scripts/k1_stage_variants.py
    python3 scripts/k1_stage_variants.py --only 'stage a no-op'

Each variant is the package's CUDA sources with some text of
`conv_sm90.cuh` replaced (each replaced text must occur once); the unchanged
sources are the first variant. For each, `conv_kernels.cu` and
`resnet_block.cu` (the K12 and K1 entry points) are compiled with nvcc into a
library of their own under `build/k1_variants/`, all variants at once, and
called through ctypes on the same inputs: K12 at (1,128,128,512)->512 and K1
at (2,128,128,{512,256})->512 and, with an identity skip, at
(1,512,512,{128,256})->128 (SiLU). Prints, per shape and variant, the time
from an idle card (median of 10 CUDA-event-timed calls) and back to back
(mean of 20), and the largest difference of y from the first variant's (a
variant that changes the arithmetic, or skips work, shows it there). The
card's name and power limit come first. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "ragb_vae_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k1_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_SPLIT = "STAGE_ROWS = 9, TAP_ROWS = 9;"
_LOOP = "for (int k = k0; k < k1; ++k) {"
_SIGMOID = "    const float s = __fdividef(1.0f, 1.0f + __expf(-t));"

# (label, [(text of conv_sm90.cuh, its replacement), ...])
VARIANTS = [
    ("as is", []),
    # the stage does no work (wrong results): the rest of the kernel's cost
    ("stage a no-op", [(_LOOP, "for (int k = k0; k < k0; ++k) {")]),
    # the activation without its sigmoid (wrong results): the MUFU part's cost
    ("identity activation", [("  if (silu) {\n    const float s", "  if (false) {\n    const float s")]),
    # one MUFU operation an element instead of two (a different activation)
    ("sigmoid by tanh.approx", [(_SIGMOID, "    float h;\n    asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(h) : \"f\"(0.5f * t));\n"
                                          "    const float s = 0.5f + 0.5f * h;")]),
    # the divide as one rcp.approx.ftz (the same values for 1 + exp(-t) >= 1)
    ("divide by rcp.approx", [(_SIGMOID, "    float s;\n    asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(s) : \"f\"(1.0f + __expf(-t)));")]),
    # who does the rows: 1 row a producer-warp thread and 12 a consumer
    # thread, or 25 and 3 (each covers the 396 slab rows once)
    ("rows 1 / 12", [(_SPLIT, "STAGE_ROWS = 1, TAP_ROWS = 12;")]),
    ("rows 25 / 3", [(_SPLIT, "STAGE_ROWS = 25, TAP_ROWS = 3;")]),
]

SHAPES = [("K12", (1, 128, 128, 512), 512, False), ("K1", (2, 128, 128, 512), 512, False),
          ("K1", (2, 128, 128, 256), 512, False), ("K1", (1, 512, 512, 128), 128, True),
          ("K1", (1, 512, 512, 256), 128, True)]


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# the C entries each variant's library is called through, with their argtypes
ENTRIES = {"ragb_resnet_conv3x3_stats": [_PTR] * 11 + [_I32] * 9 + [_PTR],
           "ragb_fused_gn_silu_conv3x3": [_PTR] * 6 + [_I32] * 5 + [_PTR]}


def start_build(index: int, replacements, *, edited: str = "conv_sm90.cuh",
                sources=("conv_kernels.cu", "resnet_block.cu"), out: Path = OUT):
    """Copy the sources to `out`/v`index`, apply the replacements to
    `edited`, start nvcc on each of `sources`."""
    d = out / f"v{index}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    path = d / edited
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise SystemExit(f"variant {index}: the text to replace occurs {text.count(old)} times")
        text = text.replace(old, new)
    path.write_text(text)
    jobs = []
    for src in sources:
        obj = d / (src + ".o")
        cmd = [NVCC, *FLAGS, "-I", str(d), "-c", "-o", str(obj), str(d / src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return d, jobs


def finish_build(d: Path, jobs, entries=None) -> ctypes.CDLL:
    """Wait for nvcc, link the objects into one library and load it, with
    the argtypes of `entries` (default `ENTRIES`)."""
    for _, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {d.name}:\n{out[-3000:]}")
    lib_path = d / "libvariant.so"
    subprocess.run([NVCC, *FLAGS, "-shared", "-o", str(lib_path), *(str(obj) for obj, _ in jobs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in (entries or ENTRIES).items():
        getattr(lib, name).argtypes = argtypes
    return lib


def idle_ms(fn, runs=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, runs=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="besides the sources as they are, only the variants whose label holds this")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    variants = [v for i, v in enumerate(VARIANTS) if i == 0 or args.only in v[0]]
    builds = [start_build(i, reps) for i, (_, reps) in enumerate(variants)]
    libs = [finish_build(d, jobs) for d, jobs in builds]
    gen = torch.Generator("cuda").manual_seed(0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    for kind, shape, n, skip in SHAPES:
        bsz, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        a = 1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
        b = 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
        wt = (torch.randn((3, 3, c, n), generator=gen, device="cuda") / math.sqrt(9 * c)).to(torch.bfloat16)
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        sk = torch.randn((bsz, h, w, n), generator=gen, device="cuda").to(torch.bfloat16) if skip else None
        y = torch.empty((bsz, h, w, n), device="cuda", dtype=torch.bfloat16)
        tiles = -(-h // 4) * -(-w // 64)                 # the engine's 4 x 64 tile
        partial = torch.empty((bsz, tiles, 2, n), device="cuda")
        stats = torch.empty((bsz, 2, n), device="cuda")
        first, parts = None, []
        for (label, _), lib in zip(variants, libs):
            if kind == "K12":
                fn = lambda: lib.ragb_fused_gn_silu_conv3x3(p(x), p(a), p(b), p(wt), p(bias), p(y), bsz, h, w, c, n,
                                                           stream())
            else:
                fn = lambda: lib.ragb_resnet_conv3x3_stats(p(x), p(a), p(b), p(wt), p(bias), p(sk), None, None, p(y),
                                                          p(partial), p(stats), tiles, bsz, h, w, c, n, 0, 1,
                                                          1 if skip else 0, stream())
            if fn() != 0:
                raise SystemExit(f"{label}: the launch failed")
            torch.cuda.synchronize()
            if first is None:
                first = y.clone()
            diff = (y.float() - first.float()).abs().max().item()
            parts.append(f"{label} {idle_ms(fn):.4f} ({queued_ms(fn):.4f}, y differs by {diff:.3g})")
        print(f"{kind} {shape}->{n}{' identity skip' if skip else ''}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
