"""Per-phase times, peak memory and a device-time breakdown of the PyTorch
port's serving path, of its RGBA-VAE training step and of its LoRA training
step on one NVIDIA GPU.

    python3 scripts/profile_torch_slice.py [--what serve,train,lora] [--quant none|int8]
        [--conv-algo direct,winograd] [--out FILE]

The model is the one `chip_smoke.py` serves: FLUX.1-Kontext transformer
(`FluxTransformerConfig()` defaults) and the FLUX `ae` VAE widened to RGBA,
bf16, fused kernels, random weights and prompt embeddings from seed 0.

For each cell (batch x image size): one warm-up request, then three
timed requests of 4 sampler steps, each split by CUDA events into encode, sampler (reported per
step) and decode; peak device memory over the cell. Then one b1 512x512
request under `torch.profiler`: device time by kernel class, and the idle
share of the device between its first and last kernel; and the same for
each cell's encode alone. Prints one line per
measurement and writes every number, unrounded, to `--out` as JSON.

The training cells take the objects `chip_smoke.py` trains (the FLUX `ae`
RGBA VAE with fp32 parameters and bf16 compute, fused kernels, a frozen
reference, LPIPS over seeded weights, the loss scales of
configs/flux_vae.yaml): 4 images of 512x512 per step in one micro-batch,
for `remat` all / half / none, one warm-up step and three timed steps each
(CUDA events around the step), peak memory per cell, then one remat="half"
step under `torch.profiler`; all of it once per resnet-conv route named in
`--conv-algo` (`ops.kernels.resnet_block.CONV_ALGO`: "direct" is K1 and its
backward K6, "winograd" puts the forward convs on K8).

The LoRA cells train the serving model: rank-128 adapters (alpha 192, fp32)
on the frozen bf16 FLUX.1-Kontext transformer, per-block recompute, the
optimizer of configs/flux_kontext_textalpha_lora.yaml, one micro-batch per
step; 2 pairs at 512x512 and 1 pair at 1024x1024, one warm-up step and three
timed steps each (CUDA events around the step, the two frozen VAE encodes
included), peak memory per cell, then one b2 512x512 step under
`torch.profiler`.

`--quant int8` runs the serving and LoRA cells over the same model with every
linear of the transformer quantised to weight-only int8 on the card
(`quantize_module_`), so the linears go through the int8 matmul kernel: int8
serving and QLoRA beside the bf16 numbers. The VAE-training cells have no
int8 form.
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
TRAIN_CELL = (4, 512)           # images per step (one micro-batch), image size
LORA_CELLS = [(2, 512), (1, 1024)]   # (gt, text_alpha) pairs per step, image size
LORA_RANK, LORA_ALPHA, LORA_LR = 128, 192.0, 3e-5

# kernel classes of the device-time breakdown, first match wins
def _conv_engine(mode: int):
    """`conv_sm90_kernel<MODE>` (csrc/conv_sm90.cuh): 0 K11, 1 K9, 2 K6's data gradient, 3 K1 and K12, 4 K2,
    5 K7's data gradient, 6 K6's dskip."""
    return re.compile(rf"conv_sm90_kernel<(\(int\))?{mode}>")


KERNEL_CLASSES = [
    ("K1/K12 resnet conv on the conv engine (conv_sm90_kernel<3>)", _conv_engine(3)),
    ("K2 sub-pixel upsample on the conv engine (conv_sm90_kernel<4>)", _conv_engine(4)),
    ("K6 data gradient (conv_sm90_kernel<2>)", _conv_engine(2)),
    ("K7 data gradient on the conv engine (conv_sm90_kernel<5>)", _conv_engine(5)),
    ("K7 weight gradient (wgrad_sm90_kernel<2>)", re.compile(r"wgrad_sm90_kernel<(\(int\))?2>")),
    ("K6 weight gradient (wgrad_sm90_kernel)", re.compile(r"wgrad_sm90_kernel")),
    ("K6 weight-gradient slice sum, K7's too (sum_slices_kernel)", re.compile(r"sum_slices_kernel")),
    ("K6 dskip on the conv engine (conv_sm90_kernel<6>)", _conv_engine(6)),
    ("K6/K7 dye pass and partial reduces", re.compile(r"dye_kernel|reduce_rows_kernel")),
    ("K1/K2/K6/K8/K9 stats reduce", re.compile(r"stats_reduce_kernel")),
    ("K8 Winograd conv (wino_conv_kernel)", re.compile(r"wino_conv_kernel")),
    ("K8 activation pass (wino_act_kernel)", re.compile(r"wino_act_kernel")),
    ("K9/K11 Hopper conv engine (conv_sm90_kernel)", re.compile(r"conv_sm90_kernel")),
    ("K3 flash attention (flash_fwd_wgmma_kernel)", re.compile(r"flash_fwd")),
    ("K3 key-split merge (flash_merge_kernel)", re.compile(r"flash_merge_kernel")),
    ("K4 attention dQ", re.compile(r"flash_dq_kernel")),
    ("K5 attention dK/dV", re.compile(r"flash_dkv_kernel")),
    ("K10 int8 matmul (int8_wgmma_kernel)", re.compile(r"int8_wgmma_kernel")),
    ("K10 int8 matmul, skinny (int8_gemv_kernel)", re.compile(r"int8_gemv_kernel")),
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


def profile_call(label, fn, out_dir):
    """One call of `fn` (after one untraced call) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = out_dir / "profile_slice_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if str(e.get("cat", "")).lower() == "kernel"]
    trace.unlink()
    if not events:
        print("[profile] the profiler recorded no device kernels: breakdown not measured", flush=True)
        return None
    result = {"cell": label, **kernel_breakdown(events)}
    print(f"[profile] {result['cell']}: {result['kernel_ms']} ms of kernels in a "
          f"{result['span_ms']} ms device span, idle share {result['idle_share']}", flush=True)
    for c in result["classes"]:
        print(f"[profile]   {c['class']}: {c['device_ms']} ms, {c['share']}, {c['launches']} launches",
              flush=True)
    return result


def profile_request(model, steps, gen, out_dir):
    bsz, h, w = PROFILE_CELL
    x = torch.rand((bsz, h, w, 4), generator=gen, device="cuda")
    return profile_call(f"b{bsz} {h}x{w}", lambda: run_request(model, x, steps, gen), out_dir)


def profile_encodes(model, gen, out_dir):
    """Each serving cell's encode alone under torch.profiler."""
    out = []
    for bsz, h, w in CELLS:
        x = torch.rand((bsz, h, w, 4), generator=gen, device="cuda")
        eps = torch.randn((bsz,) + model.latent_shape(h, w), generator=gen, device="cuda")
        out.append(profile_call(f"encode b{bsz} {h}x{w}", lambda: model.encode_latents(x, eps), out_dir))
    return out


def build_model(quant: str):
    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    t0 = time.perf_counter()
    model = FluxTextAlphaModel.random(FluxTransformerConfig(), vae_cfg, seed=SEED, device="cuda",
                                      dtype=torch.bfloat16, fused=True)
    if quant == "int8":
        from ragb_vae_tpu_torch.models.quantize import quantize_module_

        quantize_module_(model.transformer)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"[build] model ready in {time.perf_counter() - t0} s (quant={quant}, "
          f"{torch.cuda.memory_allocated() / 2**30} GiB allocated)", flush=True)
    return model


def measure_serving(model, out_dir):
    gen = torch.Generator("cuda").manual_seed(SEED)
    with torch.inference_mode():
        cells = [measure_cell(model, cell, STEPS, REPEATS, gen) for cell in CELLS]
        breakdown = profile_request(model, STEPS, gen, out_dir)
        encodes = profile_encodes(model, gen, out_dir)
    return {"steps": STEPS, "cells": cells, "profile": breakdown, "encode_profiles": encodes}


def measure_lora(model, out_dir):
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import (
        cosine_decay_schedule, make_lora_optimizer, make_lora_train_step)

    gen = torch.Generator("cuda").manual_seed(SEED)
    model.lora_rank, model.lora_alpha = LORA_RANK, LORA_ALPHA
    model.init_lora(gen)
    lora = lora_parameters(model.transformer)
    with torch.no_grad():
        for name, p in lora.items():      # B = 0 would leave A without a gradient
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.01, generator=gen)
    optimizer = make_lora_optimizer(list(lora.values()), LORA_LR)
    step = make_lora_train_step(model, optimizer, 1, cosine_decay_schedule(LORA_LR, 100000))
    cells, breakdown = [], None
    for bsz, size in LORA_CELLS:
        batch = {k: torch.rand((bsz, size, size, 4), generator=gen, device="cuda") for k in ("gt", "text_alpha")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch, gen, 0)  # warm-up: cuBLAS plans, allocator, optimizer state
        times = []
        for i in range(REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, _, grad_norm = step(batch, gen, 1 + i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        if not (torch.isfinite(loss) and torch.isfinite(grad_norm)):
            raise SystemExit(f"[profile] non-finite LoRA loss {loss} or gradient norm {grad_norm}")
        peak = torch.cuda.max_memory_allocated()
        median = statistics.median(times)
        cells.append({"cell": f"lora b{bsz} {size}x{size} rank={LORA_RANK} recompute", "step_ms": times,
                      "median_step_ms": median, "pairs_per_s": bsz / median * 1e3, "peak_memory_bytes": peak})
        print(f"[cell] {cells[-1]['cell']}: median {median} ms/step over {REPEATS} steps "
              f"({min(times)}..{max(times)} ms), {bsz / median * 1e3} pairs/s; peak {peak / 2**30} GiB",
              flush=True)
        if (bsz, size) == LORA_CELLS[0]:
            breakdown = profile_call(f"lora b{bsz} {size}x{size}", lambda: step(batch, gen, 10), out_dir)
    return {"rank": LORA_RANK, "lora_alpha": LORA_ALPHA,
            "adapter_parameters": sum(p.numel() for p in lora.values()), "cells": cells, "profile": breakdown}


def _train_step_for(remat):
    import dataclasses

    from chip_smoke import train_objects
    from ragb_vae_tpu_torch.training.vae_step import make_optimizer, make_train_step, trainable_parameters

    model, ref, lpips_fn, loss_cfg, step_cfg = train_objects(remat)
    step_cfg = dataclasses.replace(step_cfg, gradient_accumulation_steps=1)
    optimizer = make_optimizer(trainable_parameters(model), 1e-5, max_grad_norm=1.0)
    return make_train_step(model, optimizer, loss_cfg, step_cfg, ref_model=ref, lpips_fn=lpips_fn)


def measure_training(out_dir, conv_algo):
    from ragb_vae_tpu_torch.ops.kernels import resnet_block

    bsz, size = TRAIN_CELL
    gen = torch.Generator("cuda").manual_seed(SEED)
    batch = {"images": torch.rand((bsz, size, size, 4), generator=gen, device="cuda")}
    resnet_block.CONV_ALGO = conv_algo
    cells, breakdown = [], None
    for remat in ("all", "half", "none"):
        step = _train_step_for(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch, generator=gen)  # warm-up: cuDNN plans, allocator, optimizer state
        times = []
        for _ in range(REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(batch, generator=gen)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise SystemExit(f"[profile] non-finite training metrics {metrics}")
        peak = torch.cuda.max_memory_allocated()
        median = statistics.median(times)
        cells.append({"cell": f"train b{bsz} {size}x{size} remat={remat} conv={conv_algo}", "step_ms": times,
                      "median_step_ms": median, "images_per_s": bsz / median * 1e3,
                      "peak_memory_bytes": peak})
        print(f"[cell] {cells[-1]['cell']}: median {median} ms/step over {REPEATS} steps "
              f"({min(times)}..{max(times)} ms), {bsz / median * 1e3} img/s; peak {peak / 2**30} GiB",
              flush=True)
        if remat == "half":
            breakdown = profile_call(f"train b{bsz} {size}x{size} remat=half conv={conv_algo}",
                                     lambda: step(batch, generator=gen), out_dir)
        del step
    resnet_block.CONV_ALGO = "direct"
    return {"conv_algo": conv_algo, "cells": cells, "profile": breakdown}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_slice.json")
    ap.add_argument("--what", default="serve,train,lora", help="comma-separated subset of serve,train,lora")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="int8: the serving and lora cells over the weight-only int8 transformer")
    ap.add_argument("--conv-algo", default="direct",
                    help="comma-separated resnet-conv routes of the training cells: direct, winograd")
    args = ap.parse_args()
    what = set(args.what.split(","))
    algos = args.conv_algo.split(",")
    if set(algos) - {"direct", "winograd"}:
        ap.error(f"--conv-algo takes direct and winograd, got {args.conv_algo}")
    if args.quant == "int8" and "train" in what:
        ap.error("--quant int8 has no VAE-training cells: pass --what serve,lora")
    if not torch.cuda.is_available():
        raise SystemExit("[profile] no CUDA device: this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    result = {"device": smi, "torch": torch.__version__, "repeats": REPEATS, "quant": args.quant}
    if what & {"serve", "lora"}:
        model = build_model(args.quant)
        if "serve" in what:
            result["serving"] = measure_serving(model, out.parent)
        if "lora" in what:
            result["lora"] = measure_lora(model, out.parent)
        del model
        torch.cuda.empty_cache()
    if "train" in what:
        result["training"] = [measure_training(out.parent, algo) for algo in algos]
    out.write_text(json.dumps(result, indent=1))
    print(f"[done] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
