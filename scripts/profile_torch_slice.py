"""Per-phase times, peak memory and a device-time breakdown of the PyTorch
port's serving path on one NVIDIA GPU.

    python3 scripts/profile_torch_slice.py [--out chiprun_out/profile_slice.json]

The model is the one `chip_smoke.py` serves: FLUX.1-Kontext transformer
(`FluxTransformerConfig()` defaults) and the FLUX `ae` VAE widened to RGBA,
bf16, fused kernels, random weights and prompt embeddings from seed 0.

For each cell (batch x image size): one warm-up request, then three
timed requests of 4 sampler steps, each split by CUDA events into encode, sampler (reported per
step) and decode; peak device memory over the cell. Then one b1 512x512
request under `torch.profiler`: device time by kernel class, and the idle
share of the device between its first and last kernel. Prints one line per
measurement and writes every number, unrounded, to `--out` as JSON.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel  # noqa: E402
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig  # noqa: E402
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig  # noqa: E402

SEED = 0
STEPS = 4
REPEATS = 3
CELLS = [(1, 512, 512), (2, 512, 512), (1, 1024, 1024)]
PROFILE_CELL = (1, 512, 512)

# kernel classes of the device-time breakdown, first match wins
KERNEL_CLASSES = [
    ("K1 resnet conv (conv_taps_kernel<0>)", re.compile(r"conv_taps_kernel<[^>]*0>")),
    ("K2 sub-pixel upsample (conv_taps_kernel<1>)", re.compile(r"conv_taps_kernel<[^>]*1>")),
    ("K1/K2 stats reduce", re.compile(r"stats_reduce_kernel")),
    ("K3 flash attention", re.compile(r"flash_fwd")),
    ("cuDNN conv", re.compile(r"fprop|dgrad|wgrad|cudnn|convolve|winograd", re.I)),
    ("cuBLAS GEMM/GEMV", re.compile(r"gemm|gemv|xmma|cutlass|nvjet|cublas", re.I)),
    ("PyTorch elementwise/copy/reduce", re.compile(r".")),
]


def run_request(model, x, steps, gen):
    """One request, split into (encode ms, sampler ms per step, decode ms)."""
    bsz, h, w, _ = x.shape
    lat = (bsz,) + model.latent_shape(h, w)
    kw = {"generator": gen, "device": x.device}
    eps, init = torch.randn(lat, **kw), torch.randn(lat, **kw)
    noises = torch.randn((steps,) + lat, **kw)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    cond = model.encode_latents(x, eps)
    ev[1].record()
    latents = model.sample_latents_from_noise(cond, init, noises)
    ev[2].record()
    out = model.decode_latents(latents)
    ev[3].record()
    ev[3].synchronize()
    if not torch.isfinite(out).all():
        raise SystemExit("[profile] non-finite output")
    return (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]) / steps, ev[2].elapsed_time(ev[3]))


def measure_cell(model, cell, steps, repeats, gen):
    bsz, h, w = cell
    x = torch.rand((bsz, h, w, 4), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run_request(model, x, steps, gen)  # warm-up: cuDNN/cuBLAS plans, allocator
    runs = [run_request(model, x, steps, gen) for _ in range(repeats)]
    peak = torch.cuda.max_memory_allocated()
    cols = list(zip(*runs))
    row = {
        "cell": f"b{bsz} {h}x{w}",
        "runs": [{"encode_ms": e, "sampler_ms_per_step": s, "decode_ms": d} for e, s, d in runs],
        "median": {k: statistics.median(c) for k, c in
                   zip(("encode_ms", "sampler_ms_per_step", "decode_ms"), cols)},
        "peak_memory_bytes": peak,
    }
    spread = ", ".join(f"{k} {min(c)}..{max(c)}" for k, c in
                       zip(("encode", "sampler/step", "decode"), cols))
    print(f"[cell] {row['cell']}: median {row['median']} over {repeats} runs ({spread} ms); "
          f"peak {peak / 2**30} GiB", flush=True)
    return row


def kernel_breakdown(events):
    """Device time by kernel class, and the idle share of the device span."""
    totals = {name: [0.0, 0] for name, _ in KERNEL_CLASSES}
    spans = []
    for e in events:
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((start, start + dur))
        for name, pattern in KERNEL_CLASSES:
            if pattern.search(e["name"]):
                totals[name][0] += dur
                totals[name][1] += 1
                break
    spans.sort()
    busy, cur_start, cur_end = 0.0, None, None
    for s, t in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    if cur_end is not None:
        busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    kernel_total = sum(t for t, _ in totals.values())
    classes = [{"class": name, "device_ms": t / 1e3, "share": t / kernel_total if kernel_total else 0.0,
                "launches": n} for name, (t, n) in totals.items()]
    classes.sort(key=lambda c: -c["device_ms"])
    return {"kernel_ms": kernel_total / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span if span else None, "classes": classes}


def profile_request(model, steps, gen, out_dir):
    from torch.profiler import ProfilerActivity, profile

    bsz, h, w = PROFILE_CELL
    x = torch.rand((bsz, h, w, 4), generator=gen, device="cuda")
    run_request(model, x, steps, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_request(model, x, steps, gen)
        torch.cuda.synchronize()
    trace = out_dir / "profile_slice_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if str(e.get("cat", "")).lower() == "kernel"]
    trace.unlink()
    if not events:
        print("[profile] the profiler recorded no device kernels: breakdown not measured", flush=True)
        return None
    result = {"cell": f"b{bsz} {h}x{w}", **kernel_breakdown(events)}
    print(f"[profile] {result['cell']}: {result['kernel_ms']} ms of kernels in a "
          f"{result['span_ms']} ms device span, idle share {result['idle_share']}", flush=True)
    for c in result["classes"]:
        print(f"[profile]   {c['class']}: {c['device_ms']} ms, {c['share']}, {c['launches']} launches",
              flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_slice.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("[profile] no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    t0 = time.perf_counter()
    model = FluxTextAlphaModel.random(FluxTransformerConfig(), vae_cfg, seed=SEED, device="cuda",
                                      dtype=torch.bfloat16, fused=True)
    torch.cuda.synchronize()
    print(f"[build] model ready in {time.perf_counter() - t0} s", flush=True)
    gen = torch.Generator("cuda").manual_seed(SEED)
    with torch.inference_mode():
        cells = [measure_cell(model, cell, STEPS, REPEATS, gen) for cell in CELLS]
        breakdown = profile_request(model, STEPS, gen, out.parent)
    out.write_text(json.dumps({"device": smi, "torch": torch.__version__, "steps": STEPS,
                               "repeats": REPEATS, "cells": cells, "profile": breakdown},
                              indent=1))
    print(f"[done] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
