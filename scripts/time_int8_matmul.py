"""Time K10, the weight-only int8 matmul (`ragb_vae_tpu_torch/csrc/int8_matmul.cu`),
on one NVIDIA GPU.

    python3 scripts/time_int8_matmul.py                  # this checkout's package
    python3 scripts/time_int8_matmul.py --root DIR       # the package under DIR

`--root` takes any directory that holds a `ragb_vae_tpu_torch/` package, such
as another commit's `git archive` unpacked under `build/`, so that two
designs can be compared on one card in one call (parent, change, change,
parent). At each shape the int8 serving path sends (the token streams of a
512^2 and a 1024^2 request, the fp32 AdaLN modulation at batch 1, 2 and 4) and
at ragged ones, K10 is first held against the exact fp32 product of its
inputs (1e-2 of max |y| for bf16 x, 1e-4 for fp32) and two calls against
each other bit for bit, then timed: from an idle card (median of 10
CUDA-event-timed calls, as chip_smoke.py times), back to back (mean of 20
calls between two events) and beside `F.linear` over a resident bf16 weight
of the same shape (what an unquantised layer pays; twice the weight bytes).
Each line ends with the bound: max(2 M N K at 989 TFLOP/s bf16 or 67 fp32,
the bytes of x, the weights, scale, bias and y at 3.35 TB/s). Last, the
host's time per call of the wrapper at small shapes, where the host sets the
pace (mean of 2000 calls, no synchronisation). Prints the card's name and
power limit first; exits 1 if a case disagrees.
"""
from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# (M, K, N, x dtype, bias)
SHAPES = [
    (2560, 3072, 12288, torch.bfloat16, True),     # single block linear1's MLP part at 512^2
    (2560, 15360, 3072, torch.bfloat16, True),     # single block linear2 at 512^2
    (8704, 3072, 9216, torch.bfloat16, False),     # the 1024^2 request's qkv
    (1, 3072, 18432, torch.float32, True),         # AdaLN modulation, batch 1
    (2, 3072, 18432, torch.float32, True),         # AdaLN modulation, batch 2
    (4, 3072, 18432, torch.float32, True),         # AdaLN modulation, batch 4: two x chunks
    (512, 3072, 3072, torch.bfloat16, True),       # a double block's text stream
    (2048, 3072, 12288, torch.bfloat16, True),     # a double block's image stream (MLP)
    (1001, 80, 136, torch.bfloat16, True),         # every tile edge ragged
    (9, 3072, 64, torch.bfloat16, True),           # just above the skinny kernel's rows
]
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def idle_ms(fn, runs=10):
    for _ in range(2):
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
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def host_us(fn, runs=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="directory holding the ragb_vae_tpu_torch package to time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package {Path(i8.__file__).resolve().parents[2]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    for m, k, n, dtype, with_bias in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        scale = (3.0 / math.sqrt(k) / 127.0) * (0.5 + torch.rand((n,), generator=gen, device="cuda"))
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda") if with_bias else None
        run = lambda: i8.int8_matmul_cuda(x, wq, scale, bias)
        y, again = run(), run()
        exact = (x.float() @ wq.float().t() * scale + (0.0 if bias is None else bias)).to(dtype).float()
        rel = ((y.float() - exact).abs().max() / exact.abs().max()).item()
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        good = rel <= tol and torch.equal(y, again) and y.shape == (m, n)
        ok &= good
        del exact, again
        fp32 = dtype == torch.float32
        nbytes = sum(t.numel() * t.element_size() for t in (x, wq, scale, bias, y) if t is not None)
        bound = 1e3 * max(2 * m * n * k / (PEAK_FP32 if fp32 else PEAK_BF16), nbytes / PEAK_BYTES)
        ms, b2b = idle_ms(run), queued_ms(run)
        w_bf16 = (wq.float() * scale[:, None]).to(torch.bfloat16)
        x_bf16 = x.to(torch.bfloat16)
        b_bf16 = None if bias is None else bias.to(torch.bfloat16)
        linear = lambda: F.linear(x_bf16, w_bf16, b_bf16)
        lin_ms, lin_b2b = idle_ms(linear), queued_ms(linear)
        del w_bf16
        label = f"({m}, {k}) x ({k}, {n}) {'fp32' if fp32 else 'bf16'}{'' if with_bias else ' no bias'}"
        print(f"K10 {label}: vs exact {rel:.3g} (<= {tol}), bitwise repeat {'yes' if good else 'NO'}; kernel "
              f"{ms:.4f} ms, back to back {b2b:.4f} ms; F.linear bf16 {lin_ms:.4f} ms, back to back "
              f"{lin_b2b:.4f} ms; ratio {ms / lin_ms:.3f}; bound {bound:.4f} ms {'ok' if good else 'FAIL'}",
              flush=True)
        del x, wq, y
    # the host's time per call where the host sets the pace: a small GEMM and a small fp32 GEMV
    for m, dtype in ((16, torch.bfloat16), (1, torch.float32)):
        x = torch.randn((m, 64), device="cuda").to(dtype)
        wq = torch.ones((64, 64), device="cuda", dtype=torch.int8)
        scale, bias = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
        print(f"host per call, ({m}, 64) x (64, 64) {str(dtype)[6:]}: "
              f"{host_us(lambda: i8.int8_matmul_cuda(x, wq, scale, bias)):.2f} us", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
