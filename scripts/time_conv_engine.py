"""Time K9 and K11, the two kernels of the Hopper conv engine
(`ragb_vae_tpu_torch/csrc/conv_sm90.cuh`), on one NVIDIA GPU.

    python3 scripts/time_conv_engine.py                  # this checkout's package
    python3 scripts/time_conv_engine.py --root DIR       # the package under DIR

`--root` takes any directory that holds a `ragb_vae_tpu_torch/` package, such
as another commit's `git archive` unpacked under `build/`, so that two
designs can be compared on one card in one call (parent, change, change,
parent). Each kernel is first held against the exact fp32 conv of its bf16
inputs (y to 1e-2 of max |y|; K9's statistics to 1e-4 of H*W*mean(y^2)
against fp64 sums of its own y) and then timed: from an idle card (median of
10 CUDA-event-timed calls, as chip_smoke.py times), back to back (mean of 20
calls between two events) and beside one PyTorch call for the same y
(`F.conv2d`; `F.pad` + `F.conv2d` for K9). The shapes are chip_smoke.py's
and, at C = 256, the pair that splits a kernel's time into a part per k-step
and a part per tile. Last, the host's time per call of each wrapper at a
small shape, where the host sets the pace (mean of 2000 calls, no
synchronisation). Prints the card's name and power limit first; exits 1 if a
kernel disagrees.
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

SHAPES_K11 = [((1, 128, 128, 512), 512), ((2, 512, 512, 128), 128), ((2, 512, 512, 256), 128),
              ((2, 33, 70, 72), 136)]
SHAPES_K9 = [((2, 128, 128, 512), 512), ((4, 512, 512, 128), 128), ((4, 512, 512, 256), 128),
             ((1, 64, 95, 128), 200)]


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
    from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package {Path(c3.__file__).resolve().parents[2]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    ok = True
    for shape, n in SHAPES_K11:
        x = randn(shape)
        w = randn((3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
        y = c3.conv3x3_same_cuda(x, w)
        exact = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
        rel = ((y.float() - exact).abs().max() / exact.abs().max()).item()
        good = rel <= 1e-2 and y.shape == (*shape[:3], n)
        ok &= good
        x_lib, w_lib = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        run = lambda: c3.conv3x3_same_cuda(x, w)
        print(f"K11 {shape}->{n}: vs exact {rel:.3g}; kernel {idle_ms(run):.4f} ms, back to back "
              f"{queued_ms(run):.4f} ms; F.conv2d {idle_ms(lambda: F.conv2d(x_lib, w_lib, padding=1)):.4f} ms "
              f"{'ok' if good else 'FAIL'}", flush=True)
        del x, w, y, exact
    for shape, n in SHAPES_K9:
        x = randn(shape)
        w = randn((3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        y, st = rb.downsample_conv3x3_stats_cuda(x, w, bias)
        xp = F.pad(x.float().permute(0, 3, 1, 2), (0, 1, 0, 1))
        exact = F.conv2d(xp, w.float().permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1) + bias
        rel = ((y.float() - exact).abs().max() / exact.abs().max()).item()
        yd = y.double()
        own = torch.stack([yd.sum(dim=(1, 2)), yd.square().sum(dim=(1, 2))], dim=1)
        s_own = ((st.double() - own).abs().max() / (y.shape[1] * y.shape[2] * yd.square().mean())).item()
        good = rel <= 1e-2 and s_own <= 1e-4 and y.shape == (shape[0], shape[1] // 2, shape[2] // 2, n)
        ok &= good
        x_lib, w_lib = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = bias.to(torch.bfloat16)
        run = lambda: rb.downsample_conv3x3_stats_cuda(x, w, bias)
        lib = lambda: F.conv2d(F.pad(x_lib, (0, 1, 0, 1)), w_lib, b_lib, stride=2)
        print(f"K9 {shape}->{n}: vs exact {rel:.3g}, statistics vs its own y {s_own:.3g}; kernel "
              f"{idle_ms(run):.4f} ms, back to back {queued_ms(run):.4f} ms; F.pad + F.conv2d "
              f"{idle_ms(lib):.4f} ms {'ok' if good else 'FAIL'}", flush=True)
        del x, w, y, exact, xp
    x = randn((1, 16, 16, 64))
    w = randn((3, 3, 64, 64), 0.04)
    bias = torch.zeros((64,), device="cuda")
    print(f"host per call: K11 wrapper {host_us(lambda: c3.conv3x3_same_cuda(x, w)):.2f} us, K9 wrapper "
          f"{host_us(lambda: rb.downsample_conv3x3_stats_cuda(x, w, bias)):.2f} us", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
