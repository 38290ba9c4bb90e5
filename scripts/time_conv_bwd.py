"""Time K6, the resnet-block conv backward (`conv3x3_stats_bwd_cuda`), and K7,
the sub-pixel upsample conv's backward (`upsample_conv3x3_stats_bwd_cuda`),
on one NVIDIA GPU, whole and kernel by kernel.

    python3 scripts/time_conv_bwd.py                  # this checkout's package
    python3 scripts/time_conv_bwd.py --root DIR       # the package under DIR
    python3 scripts/time_conv_bwd.py --launches       # also list one VAE micro-batch's K6 calls
    python3 scripts/time_conv_bwd.py --only k7        # K7 alone
    python3 scripts/time_conv_bwd.py --only k7 --dx-boxes   # and K7 with dx read as K9 reads, a box per tap

`--root` takes any directory that holds a `ragb_vae_tpu_torch/` package, such
as another commit's `git archive` unpacked under `build/`, so that two
designs can be compared on one card in one call (parent, change, change,
parent). At each shape (chip_smoke.py's five K6 cases and the decoder's top
level at 512^2, C = 128) every cotangent is first held against the exact
fp32 restatement of K6's arithmetic (dx, dskip to 1e-2 of the largest value,
the fp32 sums to 2e-3, chip_smoke.py's bounds), then K6 is timed from an
idle card (median of 10 CUDA-event-timed calls, as chip_smoke.py times) and
back to back (mean of 20 calls between two events), beside its plain
version and, as a yardstick, `torch.ops.aten.convolution_backward` over the
same dye and the bf16 activation A (one cuDNN call for dA, dW and dbias: the
conv part of K6 only, so not K6's function). Then `torch.profiler` splits K6
into its kernels: device time per kernel name and call, for calls separated
by a synchronise (idle-start) and for calls issued back to back. The bound
counts the two GEMMs (2 x 2 * 9 * C * N per pixel, plus the projection's)
against K6's inputs read once and its outputs written once, at 989 TFLOP/s
and 3.35 TB/s. `--launches` first runs one optimizer step of the VAE train
step at 512^2, batch 4, remat half (chip_smoke.py's training objects) and
prints each K6 call's shape with its count. Prints the card's name and power
limit first; exits 1 if a cotangent disagrees. The inputs, the exact
reference, the bound and the timers are chip_smoke.py's.

K7 runs the same way at chip_smoke.py's K7 shapes and (4,64,64,512)->256,
which with (4,64,64,512)->512 splits dx's time into a part per 64-channel
chunk of dye and a part per tile (same tiles, twice the chunks); its
yardstick is `aten.convolution_backward` of the conv over the nearest-2x
upsampled input (2.25x the sub-pixel form's products). `--dx-boxes` then
copies the package to `build/k7_dx_boxes/`, rewrites the conv engine's
CONV_UP_DX mode there by the text replacements of `DX_BOXES` (dx reads one
stride-2 box per tap, 16 a chunk, as K9 reads its A, instead of one slab per
parity plane) and runs K7 from that copy the same way, in a second process.
"""
from __future__ import annotations

import argparse
import collections
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
# (x shape, N, skip, activation)
SHAPES = [((4, 128, 128, 512), 512, None, "silu"), ((4, 256, 256, 512), 256, "proj", "silu"),
          ((12, 64, 64, 512), 512, "identity", "silu"), ((4, 512, 512, 128), 128, None, "silu"),
          ((1, 64, 64, 128), 128, "identity", "identity"), ((2, 37, 50, 128), 256, "proj", "silu")]
# K7: (x shape, N); the first two split dx into a part per chunk and a part per tile
SHAPES_K7 = [((4, 64, 64, 512), 256), ((4, 64, 64, 512), 512), ((4, 128, 128, 512), 512),
             ((4, 256, 256, 256), 256), ((1, 19, 27, 64), 128), ((2, 37, 50, 72), 136)]
# K7's dx with a stride-2 box of dye per tap (r, s) from (2 w0 - 1 + s, 2 h0 - 1 + r),
# landing as the tap's window, and wb's taps in order: (text of conv_sm90.cuh, its
# replacement), each text found once
DX_BOXES = [
    ("A_TAPS = DOWN ? 1 : DX ? 4 : TAPS;", "A_TAPS = DOWN || DX ? 1 : TAPS;"),
    ("AW = DOWN ? TW : SW, AH = DOWN ? TH : SH;", "AW = DOWN || DX ? TW : SW, AH = DOWN || DX ? TH : SH;"),
    ("A_STAGES = DOWN ? 4 : ACT || DX || ONE ? 3 : 2;", "A_STAGES = DOWN || DX ? 4 : ACT || ONE ? 3 : 2;"),
    ("if (DX) return make_int2(2 * w0 - tap / 4 % 2, 2 * h0 - tap / 8);",
     "if (DX) return make_int2(2 * w0 - 1 + tap % 4, 2 * h0 - 1 + tap / 4);"),
    ("if (DOWN) return MB * w * TW;", "if (DOWN || DX) return MB * w * TW;"),
    ("if (DX)                                        // plane (qa, qb)",
     "if (false)                                     // plane (qa, qb)"),
]


def per_kernel_ms(fn, calls=5, queued=False):
    """Device ms per call of each kernel `fn` launches, by kernel name, from
    the profiler's trace."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            if not queued:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    totals = collections.defaultdict(float)
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            totals[name] += float(e.get("dur", 0.0)) / 1e3 / calls
    return dict(totals)


def list_launches(rb):
    """One optimizer step of the VAE train step at 512^2 b4, remat half: each
    K6 call's (x shape, N, skip, activation) and its count."""
    import dataclasses

    from chip_smoke import train_objects
    from ragb_vae_tpu_torch.training.vae_step import make_optimizer, make_train_step, trainable_parameters

    model, ref, lpips_fn, loss_cfg, step_cfg = train_objects("half")
    step_cfg = dataclasses.replace(step_cfg, gradient_accumulation_steps=1)
    step = make_train_step(model, make_optimizer(trainable_parameters(model), 1e-5, max_grad_norm=1.0),
                           loss_cfg, step_cfg, ref_model=ref, lpips_fn=lpips_fn)
    seen = collections.Counter()
    inner = rb.conv3x3_stats_bwd_cuda

    def spy(x, a, b, w, bias, skip, ws, *rest):
        kind = None if skip is None else ("proj" if ws is not None else "identity")
        seen[(tuple(x.shape), w.shape[3], kind, rest[-1])] += 1
        return inner(x, a, b, w, bias, skip, ws, *rest)

    rb.conv3x3_stats_bwd_cuda = spy
    gen = torch.Generator("cuda").manual_seed(0)
    step({"images": torch.rand((4, 512, 512, 4), generator=gen, device="cuda")}, generator=gen)
    torch.cuda.synchronize()
    rb.conv3x3_stats_bwd_cuda = inner
    for (shape, n, kind, act), count in sorted(seen.items(), key=lambda kv: -kv[0][0][1] * kv[0][0][3]):
        print(f"launches: K6 {shape}->{n} skip={kind} {act}: {count} per micro-batch", flush=True)
    print(f"launches: K6 {sum(seen.values())} calls per micro-batch", flush=True)
    del model, ref, step
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(ROOT), help="directory holding the ragb_vae_tpu_torch package to time")
    parser.add_argument("--launches", action="store_true", help="list one VAE micro-batch's K6 calls first")
    parser.add_argument("--out", default="", help="also write every number as JSON to this file")
    parser.add_argument("--only", choices=("k6", "k7"), default=None, help="time one of the two")
    parser.add_argument("--dx-boxes", action="store_true",
                        help="then time K7 again with dx reading a stride-2 box per tap (DX_BOXES)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    # chip_smoke.py's inputs, exact reference, bounds and timers, over the package just imported
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package {Path(rb.__file__).resolve().parents[2]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.launches:
        list_launches(rb)
    gen = torch.Generator("cuda").manual_seed(0)
    ok, rows = True, []
    for shape, n, skip, act in SHAPES if args.only != "k7" else ():
        bsz, h, wd, c = shape
        x, a, b, w, bias, sk, ws, wsb = cs._conv_inputs(gen, shape, n, skip)
        y, _ = rb.conv3x3_stats_cuda(x, a, b, w, bias, sk, ws, wsb, act)
        gy = cs._randn(gen, y.shape)
        gstats = 0.1 * torch.randn((bsz, 2, n), generator=gen, device="cuda")
        ops = (x, a, b, w, bias, sk, ws, wsb, y, gy, gstats, act)
        got = rb.conv3x3_stats_bwd_cuda(*ops)
        parts, good = [], True
        for name, g, r in zip(cs.BWD_NAMES_K6, got, cs.conv3x3_stats_bwd_exact(*ops)):
            if r is None:
                good &= g is None
                continue
            rel = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
            tol = cs.BWD_BF16_EXACT_TOL if g.dtype == torch.bfloat16 else cs.BWD_SUM_EXACT_TOL
            good &= rel <= tol and g.shape == r.shape
            parts.append(f"{name} {rel:.2g}")
        same = all(g is None or torch.equal(g, h) for g, h in zip(got, rb.conv3x3_stats_bwd_cuda(*ops)))
        ok &= good and same
        run = lambda: rb.conv3x3_stats_bwd_cuda(*ops)
        # the yardstick: one cuDNN call for dA, dW and dbias over the same dye and bf16 A
        dye = cs._dye_exact(y, gy, gstats).to(torch.bfloat16).permute(0, 3, 1, 2)
        t = x.float() * a[:, None, None, :] + b[:, None, None, :]
        act_a = (F.silu(t) if act == "silu" else t).to(torch.bfloat16).permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: torch.ops.aten.convolution_backward(dye, act_a, w_lib, [n], [1, 1], [1, 1], [1, 1], False,
                                                          [0, 0], 1, [True, True, True])
        c_skip = c if skip == "proj" else 0
        flops = 2 * (2 * 9 * c + 2 * c_skip) * bsz * h * wd * n
        nbytes = (cs._nbytes(x, a, b, w, y, gy, gstats, ws) + (cs._nbytes(sk) if ws is not None else 0)
                  + cs._nbytes(x) + 4 * (w.numel() + 2 * a.numel() + n) + cs._nbytes(sk)
                  + 4 * (0 if ws is None else ws.numel() + n))
        row = {"shape": list(shape), "n": n, "skip": skip, "activation": act, "errors": parts, "bitwise": same,
               "ms": cs.time_ms(run), "queued_ms": cs.time_queued_ms(run, runs=20),
               "plain_ms": cs.time_ms(lambda: rb.conv3x3_stats_bwd_plain(*ops)),
               "convolution_backward_ms": cs.time_ms(lib), **cs.bound(flops, nbytes),
               "kernels_idle_ms": per_kernel_ms(run), "kernels_queued_ms": per_kernel_ms(run, queued=True)}
        rows.append(row)
        print(f"K6 {shape}->{n} skip={skip} {act}: vs exact {', '.join(parts)}; bitwise over two calls {same}; "
              f"kernel {row['ms']:.4f} ms, back to back {row['queued_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms; "
              f"aten.convolution_backward (yardstick) {row['convolution_backward_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) {'ok' if good and same else 'FAIL'}", flush=True)
        for label, key in (("idle-start", "kernels_idle_ms"), ("back to back", "kernels_queued_ms")):
            print(f"  kernels, {label}: " + "; ".join(f"{k} {v:.4f}" for k, v in sorted(row[key].items())),
                  flush=True)
        del ops, got, dye, act_a, t, x, y, gy, sk
        torch.cuda.empty_cache()
    if args.only != "k6":
        k7_ok, k7_rows = time_k7(rb, cs, gen)
        ok &= k7_ok
        rows += k7_rows
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    if args.dx_boxes:
        ok &= dx_boxes(Path(args.root), args.out) == 0
    return 0 if ok else 1


def time_k7(rb, cs, gen):
    """K7 at SHAPES_K7, each cotangent against chip_smoke.py's exact
    restatement, bit for bit over two calls, timed whole and by kernel ->
    (all held, rows)."""
    ok, rows, dx_ms = True, [], {}
    for shape, n in SHAPES_K7:
        bsz, h, wd, c = shape
        x = cs._randn(gen, shape)
        w = cs._randn(gen, (3, 3, c, n), c ** -0.5 / 3)
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        y, _ = rb.upsample_conv3x3_stats_cuda(x, w, bias)
        gy = cs._randn(gen, y.shape)
        gstats = 0.1 * torch.randn((bsz, 2, n), generator=gen, device="cuda")
        ops = (x, w, bias, y, gy, gstats)
        got = rb.upsample_conv3x3_stats_bwd_cuda(*ops)
        parts, good = [], True
        for name, g, r in zip(cs.BWD_NAMES_K7, got, cs.upsample_conv3x3_stats_bwd_exact(*ops)):
            rel = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
            tol = cs.BWD_BF16_EXACT_TOL if g.dtype == torch.bfloat16 else cs.BWD_SUM_EXACT_TOL
            good &= rel <= tol and g.shape == r.shape
            parts.append(f"{name} {rel:.2g}")
        same = all(torch.equal(g, h) for g, h in zip(got, rb.upsample_conv3x3_stats_bwd_cuda(*ops)))
        ok &= good and same
        run = lambda: rb.upsample_conv3x3_stats_bwd_cuda(*ops)
        dye = cs._dye_exact(y, gy, gstats).to(torch.bfloat16).permute(0, 3, 1, 2)
        up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).permute(0, 3, 1, 2)   # nearest-2x, NCHW view
        lib = lambda: torch.ops.aten.convolution_backward(dye, up, cs._oihw(w), [n], [1, 1], [1, 1], [1, 1], False,
                                                          [0, 0], 1, [True, True, True])
        flops = 2 * 2 * 16 * bsz * h * wd * c * n
        nbytes = cs._nbytes(x, w, y, gy, gstats) + cs._nbytes(x) + 4 * (w.numel() + n)
        row = {"kernel": "K7", "shape": list(shape), "n": n, "errors": parts, "bitwise": same,
               "ms": cs.time_ms(run), "queued_ms": cs.time_queued_ms(run, runs=20),
               "plain_ms": cs.time_ms(lambda: rb.upsample_conv3x3_stats_bwd_plain(*ops)),
               "convolution_backward_ms": cs.time_ms(lib), **cs.bound(flops, nbytes),
               "kernels_idle_ms": per_kernel_ms(run), "kernels_queued_ms": per_kernel_ms(run, queued=True)}
        rows.append(row)
        dx_ms[(shape, n)] = sum(v for k, v in row["kernels_queued_ms"].items() if "conv_sm90_kernel" in k)
        print(f"K7 {shape}->{n}: vs exact {', '.join(parts)}; bitwise over two calls {same}; kernel "
              f"{row['ms']:.4f} ms, back to back {row['queued_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms; "
              f"aten.convolution_backward over the upsampled input (yardstick, 2.25x the products) "
              f"{row['convolution_backward_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); device "
              f"time back to back {sum(row['kernels_queued_ms'].values()):.4f} ms {'ok' if good and same else 'FAIL'}",
              flush=True)
        for label, key in (("idle-start", "kernels_idle_ms"), ("back to back", "kernels_queued_ms")):
            print(f"  kernels, {label}: " + "; ".join(f"{k} {v:.4f}" for k, v in sorted(row[key].items())),
                  flush=True)
        del ops, got, dye, up, x, y, gy
        torch.cuda.empty_cache()
    lo, hi = ((4, 64, 64, 512), 256), ((4, 64, 64, 512), 512)
    if dx_ms.get(lo) and dx_ms.get(hi):                 # the engine's dx (not the first design's)
        # dx: (4, 64, 64) x 512 output channels, 64 tiles of an image x 4 N tiles = 256 blocks either way
        waves = 4 * 16 * 4 / 132
        per_chunk = (dx_ms[hi] - dx_ms[lo]) * 1e3 / waves / 4
        per_tile = dx_ms[lo] * 1e3 / waves - 4 * per_chunk
        print(f"K7 dx split (device, back to back), dye 256 against 512 channels into 512: {per_chunk:.2f} us a "
              f"64-channel chunk of a tile (16 taps), {per_tile:.2f} us fixed a tile ({waves:.2f} waves)", flush=True)
    return ok, rows


def dx_boxes(root: Path, out: str) -> int:
    """K7 from a copy of the package whose dx reads a box per tap."""
    work = ROOT / "build" / "k7_dx_boxes"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(root / "ragb_vae_tpu_torch", work / "ragb_vae_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    engine = work / "ragb_vae_tpu_torch" / "csrc" / "conv_sm90.cuh"
    text = engine.read_text()
    for old, new in DX_BOXES:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} must occur once in {engine}")
        text = text.replace(old, new)
    engine.write_text(text)
    print("K7 with dx as a box per tap (DX_BOXES):", flush=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--root", str(work), "--only", "k7"]
    if out:
        cmd += ["--out", str(Path(out).with_name(Path(out).stem + "_dx_boxes.json"))]
    return subprocess.run(cmd).returncode


if __name__ == "__main__":
    sys.exit(main())
