"""Time the kernels of the Hopper conv engine
(`ragb_vae_tpu_torch/csrc/conv_sm90.cuh`): K9, K11, K1 and K12 on its
activation mode, K2 (the sub-pixel upsample conv) on its CONV_UP mode;
beside them K8 (K1's function by Winograd), on one NVIDIA GPU.

    python3 scripts/time_conv_engine.py                  # this checkout's package
    python3 scripts/time_conv_engine.py --root DIR       # the package under DIR
    python3 scripts/time_conv_engine.py --only k2        # K2 alone

`--root` takes any directory that holds a `ragb_vae_tpu_torch/` package, such
as another commit's `git archive` unpacked under `build/`, so that two
designs can be compared on one card in one call (parent, change, change,
parent). Each kernel is first held against the exact fp32 conv of its bf16
inputs (y to 1e-2 of max |y|; K9's and K1's statistics to 1e-4 of
H*W*mean(y^2) against fp64 sums of its own y; K1 and K12 over the
activation rounded to bf16, K2 over the folded weights rounded to bf16) and
then timed: from an idle card (median of 10 CUDA-event-timed calls, as
chip_smoke.py times), back to back (mean of 20 calls between two events)
and beside one PyTorch call for the same y (`F.conv2d`; `F.pad` +
`F.conv2d` for K9; for K1 and K12, `F.conv2d` over their activation, a
yardstick for the conv part only). The shapes are chip_smoke.py's and, at
C = 256 (K11, K9), at C = 128 and 512 (K1) and at C = 256 (K2), the pairs
that split a kernel's time into a part per k-step (64-channel chunk) and a
part per tile (from the back-to-back times: an idle-card time also holds the
wrapper's host work). K2 is timed with its folded weights given, as the
Upsample module keeps them, and with the fold in the call; its yardstick is
`F.conv2d` over the nearest-2x upsampled input (2.25x the sub-pixel form's
products). K8 is timed beside K1 on the same inputs. Last, the host's time per
call of each wrapper at a small shape, where the host sets the pace (mean
of 2000 calls, no synchronisation). Prints the card's name and power limit
first; exits 1 if a kernel disagrees.
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
# (shape, N, skip: None, "identity" or the projection's Cs, activation); the
# pairs (2,128,128,{256,512})->512 and (1,512,512,{128,256})->128 run the same
# tiles with twice the chunks
SHAPES_K1 = [((2, 128, 128, 512), 512, None, "silu"), ((2, 128, 128, 256), 512, None, "silu"),
             ((1, 512, 512, 128), 128, "identity", "silu"), ((1, 512, 512, 256), 128, "identity", "silu"),
             ((4, 512, 512, 128), 128, "identity", "silu"), ((4, 256, 256, 256), 256, 128, "silu"),
             ((12, 128, 128, 512), 512, 256, "silu"), ((2, 37, 50, 72), 136, 40, "silu")]
K1_SPLITS = [(((2, 128, 128, 256), 512), ((2, 128, 128, 512), 512)),
             (((1, 512, 512, 128), 128), ((1, 512, 512, 256), 128))]
SHAPES_K12 = [((1, 128, 128, 512), 512), ((2, 512, 512, 128), 128)]
# chip_smoke.py's K2 shapes, a VAE micro-batch's three (b4 512^2) and (2,64,64,256)->512, which
# with (2,64,64,512)->512 runs the same tiles with half the chunks
SHAPES_K2 = [((2, 64, 64, 512), 512), ((1, 256, 256, 256), 256), ((4, 128, 128, 512), 512),
             ((2, 37, 50, 72), 136), ((4, 64, 64, 512), 512), ((4, 256, 256, 256), 256), ((2, 64, 64, 256), 512)]
K2_SPLIT = (((2, 64, 64, 256), 512), ((2, 64, 64, 512), 512))
# chip_smoke.py's K8 shapes: K8 (U's tiles given, as a fused ResnetBlock keeps them) beside K1
SHAPES_K8 = [((2, 128, 128, 512), 512, None), ((1, 512, 512, 128), 128, "identity"), ((2, 128, 128, 256), 512, 256)]
TILE = (4, 64)                  # the conv engine's output tile (rows, columns) and 128 output channels
SMS = 132


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


def conv_exact(t, w):
    """SAME conv3x3 of NHWC fp32 t over HWIO w in fp32 (TF32 off)."""
    return F.conv2d(t.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def k1_inputs(gen, randn, shape, n, skip):
    bsz, h, w, c = shape
    x = randn(shape)
    a = 1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    b = 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    wt = randn((3, 3, c, n), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    sk = ws = wsb = None
    if skip == "identity":
        sk = randn((bsz, h, w, n))
    elif skip is not None:
        sk, ws = randn((bsz, h, w, skip)), randn((skip, n), skip ** -0.5)
        wsb = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    return x, a, b, wt, bias, sk, ws, wsb


def activated(x, a, b, activation):
    """K1's activation as its stage forms it: bf16(act(x*a + b)), NHWC."""
    t = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return (F.silu(t) if activation == "silu" else t).to(torch.bfloat16)


def engine_waves(shape, n):
    """The conv engine's blocks over the card's SMs for an output of `shape` x n."""
    bsz, h, w, _ = shape
    blocks = bsz * -(-h // TILE[0]) * -(-w // TILE[1]) * -(-n // 128)
    return blocks / SMS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="directory holding the ragb_vae_tpu_torch package to time")
    parser.add_argument("--only", choices=("k2",), default=None, help="time K2 alone")
    args = parser.parse_args(argv)
    every = args.only is None
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3
    from ragb_vae_tpu_torch.ops.kernels import fused_gn_silu_conv as fgc
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package {Path(c3.__file__).resolve().parents[2]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    ok = True
    for shape, n in SHAPES_K11 if every else ():
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
    for shape, n in SHAPES_K9 if every else ():
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
    k1_ms = {}
    for shape, n, skip, activation in SHAPES_K1 if every else ():
        x, a, b, w, bias, sk, ws, wsb = k1_inputs(gen, randn, shape, n, skip)
        args = (x, a, b, w, bias, sk, ws, wsb, activation)
        y, st = rb.conv3x3_stats_cuda(*args)
        act = activated(x, a, b, activation)
        exact = conv_exact(act.float(), w) + bias
        if ws is not None:
            exact = exact + sk.float() @ ws.float() + wsb
        elif sk is not None:
            exact = exact + sk.float()
        rel = ((y.float() - exact).abs().max() / exact.abs().max()).item()
        yd = y.double()
        own = torch.stack([yd.sum(dim=(1, 2)), yd.square().sum(dim=(1, 2))], dim=1)
        s_own = ((st.double() - own).abs().max() / (y.shape[1] * y.shape[2] * yd.square().mean())).item()
        y2, st2 = rb.conv3x3_stats_cuda(*args)
        same = torch.equal(y, y2) and torch.equal(st, st2)
        good = rel <= 1e-2 and s_own <= 1e-4 and same and bool(torch.isfinite(y.float()).all())
        ok &= good
        x_lib = act.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        run = lambda: rb.conv3x3_stats_cuda(*args)
        k1_ms[(shape, n)] = back = queued_ms(run)
        print(f"K1 {shape}->{n} {activation} skip={skip}: vs exact {rel:.3g}, statistics vs its own y {s_own:.3g}, "
              f"bit for bit over two calls {same}; kernel {idle_ms(run):.4f} ms, back to back {back:.4f} ms; "
              f"F.conv2d on the activated input (conv part only) "
              f"{idle_ms(lambda: F.conv2d(x_lib, w_lib, padding=1)):.4f} ms {'ok' if good else 'FAIL'}", flush=True)
        del x, y, y2, act, exact, x_lib, sk, args
    for (lo, n_lo), (hi, n_hi) in K1_SPLITS if every else ():
        waves = engine_waves(lo, n_lo)
        steps_lo, steps_hi = -(-lo[3] // 64), -(-hi[3] // 64)
        per_step = (k1_ms[(hi, n_hi)] - k1_ms[(lo, n_lo)]) * 1e3 / waves / (steps_hi - steps_lo)
        per_tile = k1_ms[(lo, n_lo)] * 1e3 / waves - steps_lo * per_step
        print(f"K1 split, back to back, {lo}->{n_lo} against {hi}->{n_hi} ({waves:.2f} waves of blocks): {per_step:.2f} us a "
              f"chunk of a tile, {per_tile:.2f} us fixed a tile (at C = {lo[3]}: {steps_lo} chunks, the fixed "
              f"part {per_tile / (per_tile + steps_lo * per_step):.0%} of a tile)", flush=True)
    for shape, n in SHAPES_K12 if every else ():
        x, a, b, w, bias, *_ = k1_inputs(gen, randn, shape, n, None)
        z = fgc.fused_gn_silu_conv3x3_cuda(x, a, b, w, bias)
        act = activated(x, a, b, "silu")
        exact = conv_exact(act.float(), w) + bias
        rel = ((z.float() - exact).abs().max() / exact.abs().max()).item()
        good = rel <= 1e-2 and torch.equal(z, fgc.fused_gn_silu_conv3x3_cuda(x, a, b, w, bias))
        ok &= good
        x_lib = act.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        run = lambda: fgc.fused_gn_silu_conv3x3_cuda(x, a, b, w, bias)
        print(f"K12 {shape}->{n}: vs exact {rel:.3g}; kernel {idle_ms(run):.4f} ms, back to back "
              f"{queued_ms(run):.4f} ms; F.conv2d on the activated input (conv part only) "
              f"{idle_ms(lambda: F.conv2d(x_lib, w_lib, padding=1)):.4f} ms {'ok' if good else 'FAIL'}", flush=True)
        del x, z, act, exact, x_lib
    k2_ms = {}
    for shape, n in SHAPES_K2:
        x = randn(shape)
        w = randn((3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        w_fold = rb.fold_subpixel_weights(w.float()).to(torch.bfloat16).contiguous()
        y, st = rb.upsample_conv3x3_stats_cuda(x, w, bias, w_fold=w_fold)
        up = F.interpolate(x.float().permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
        exact = conv_exact(up, w) + bias
        rel = ((y.float() - exact).abs().max() / exact.abs().max()).item()
        yd = y.double()
        own = torch.stack([yd.sum(dim=(1, 2)), yd.square().sum(dim=(1, 2))], dim=1)
        s_own = ((st.double() - own).abs().max() / (y.shape[1] * y.shape[2] * yd.square().mean())).item()
        y2, st2 = rb.upsample_conv3x3_stats_cuda(x, w, bias, w_fold=w_fold)
        same = torch.equal(y, y2) and torch.equal(st, st2)
        good = rel <= 2e-2 and s_own <= 1e-4 and same   # the folded weights are rounded to bf16 once more
        ok &= good
        run = lambda: rb.upsample_conv3x3_stats_cuda(x, w, bias, w_fold=w_fold)
        fold = lambda: rb.upsample_conv3x3_stats_cuda(x, w, bias)
        x_lib = up.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        k2_ms[(shape, n)] = back = queued_ms(run)
        print(f"K2 {shape}->{n}: vs the exact upsample + conv {rel:.3g}, statistics vs its own y {s_own:.3g}, bit for "
              f"bit over two calls {same}; kernel (folded weights given) {idle_ms(run):.4f} ms, back to back "
              f"{back:.4f} ms; the fold in the call {idle_ms(fold):.4f} ms, back to back {queued_ms(fold):.4f} ms; "
              f"F.conv2d on the upsampled input (conv part only, 2.25x the products) "
              f"{idle_ms(lambda: F.conv2d(x_lib, w_lib, padding=1)):.4f} ms {'ok' if good else 'FAIL'}", flush=True)
        del x, y, y2, up, exact, x_lib
    (lo, n_lo), (hi, n_hi) = K2_SPLIT
    waves = 4 * engine_waves(lo, n_lo)                  # a block per parity
    steps_lo, steps_hi = -(-lo[3] // 64), -(-hi[3] // 64)
    per_step = (k2_ms[(hi, n_hi)] - k2_ms[(lo, n_lo)]) * 1e3 / waves / (steps_hi - steps_lo)
    per_tile = k2_ms[(lo, n_lo)] * 1e3 / waves - steps_lo * per_step
    print(f"K2 split, back to back, {lo}->{n_lo} against {hi}->{n_hi} ({waves:.2f} waves of blocks): {per_step:.2f} us "
          f"a chunk (4 taps) of a tile, {per_tile:.2f} us fixed a tile", flush=True)
    for shape, n, skip in SHAPES_K8 if every else ():
        x, a, b, w, bias, sk, ws, wsb = k1_inputs(gen, randn, shape, n, skip)
        args = (x, a, b, w, bias, sk, ws, wsb, "silu")
        # U's tiles given, as a fused ResnetBlock keeps them (a package without them folds U in the call)
        kw = {"u": rb.wino_tiles(w, x.dtype)} if hasattr(rb, "wino_tiles") else {}
        run8, run1 = lambda: rb.wino_conv3x3_stats_cuda(*args, **kw), lambda: rb.conv3x3_stats_cuda(*args)
        print(f"K8 against K1 {shape}->{n} silu skip={skip}: K8 {idle_ms(run8):.4f} ms (back to back "
              f"{queued_ms(run8):.4f}), K1 {idle_ms(run1):.4f} ms (back to back {queued_ms(run1):.4f})", flush=True)
        del x, sk, args
    if not every:
        return 0 if ok else 1
    x = randn((1, 16, 16, 64))
    w = randn((3, 3, 64, 64), 0.04)
    bias = torch.zeros((64,), device="cuda")
    ones, zeros = torch.ones((1, 64), device="cuda"), torch.zeros((1, 64), device="cuda")
    print(f"host per call: K11 wrapper {host_us(lambda: c3.conv3x3_same_cuda(x, w)):.2f} us, K9 wrapper "
          f"{host_us(lambda: rb.downsample_conv3x3_stats_cuda(x, w, bias)):.2f} us, K1 wrapper "
          f"{host_us(lambda: rb.conv3x3_stats_cuda(x, ones, zeros, w, bias)):.2f} us", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
