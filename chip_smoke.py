"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero without the
final line):

1. device  - a CUDA device must exist; prints the card's name and power limit
             and turns TF32 off.
2. build   - compiles the hand-written kernels from `ragb_vae_tpu_torch/csrc`.
3. kernels - each kernel against its plain PyTorch version and against an
             exact fp32 reference (the attention's log-sum-exp included), in
             bf16 at the shapes the serving path gives it plus short ragged
             lengths: errors, tolerances, and the median of 10
             CUDA-event-timed runs of kernel and plain version.
4. slice   - builds FluxTextAlphaModel at full published width (FLUX.1-Kontext
             transformer, FLUX `ae` RGBA VAE) with random weights from a seed,
             serves 3 requests through InferenceServer, checks each answer and
             that every kernel launched during that run.

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ragb_vae_tpu_torch.ops.kernels import _build  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb  # noqa: E402

SEED = 0

KERNELS = {
    "resnet_conv3x3_stats": {
        "source": "ragb_vae_tpu_torch/csrc/resnet_block.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:69",
    },
    "subpixel_upsample_conv3x3_stats": {
        "source": "ragb_vae_tpu_torch/csrc/resnet_block.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:231",
    },
    "flash_attention_fwd": {
        "source": "ragb_vae_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/flash_attention.py:46",
    },
}

# Each kernel is held against two references on the same bf16 inputs:
# - its plain version (the counterpart of the JAX package's XLA path), which
#   rounds the conv output to bf16 before it adds the fp32 bias and rounds
#   again, and rounds the attention logits to bf16;
# - an exact reference: the kernel's own arithmetic (bf16 products, fp32
#   sums, one final rounding) in fp32 PyTorch, which differs from the kernel
#   only in the order of fp32 sums. This is the sharp check: a dropped tile,
#   a lost partial sum or an unmasked key tail moves it far past its bound.
# Conv y errors are relative to max|y|; statistics are normalised by
# H*W*mean(y^2), the size of one channel's sum of squares, so one missing
# output tile among T moves them by about 1/T (T <= 4096 here: >= 2.4e-4).
CONV_Y_REL_TOL = 3e-2          # vs plain: two roundings of 2^-8 each
# vs plain: the bias added between the plain version's two roundings is the
# same for every pixel of a channel, so the second rounding's error has one
# sign across the channel and its sums drift by up to ~6e-3
CONV_STATS_PLAIN_TOL = 1e-2
CONV_Y_EXACT_TOL = 1e-2        # vs exact: one bf16 ulp of the largest value
CONV_STATS_EXACT_TOL = 1e-4    # vs exact: fp32 summation order only
# Attention: outputs relative to max|ref|; the LSE in absolute terms. An
# unmasked key tail or a dropped last key tile moves the LSE by 7e-3 or more
# at S = 2600; at S = 300 and S = 120 the tail is 15-20% of the keys.
ATTN_PLAIN_REL_TOL = 5e-2      # vs plain: its logits are rounded to bf16
ATTN_EXACT_REL_TOL = 1e-2      # vs fp32: P and O rounded to bf16 once each
ATTN_LSE_ABS_TOL = 1e-4        # vs fp32 logsumexp of the same logits


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, runs: int = 10) -> float:
    """Median of `runs` CUDA-event-timed calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("[device] no CUDA device: this smoke test runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", f"{name} x{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda} allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    log("build", f"{_build.library_path().name} ready in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions and exact references
# ---------------------------------------------------------------------------
def _randn(gen, shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def conv3x3_stats_exact(x, a, b, w, bias, skip, ws, wsb, activation):
    """K1's arithmetic in fp32: bf16-rounded activation, fp32 conv sums,
    bias and skip in fp32, one rounding of y to bf16."""
    t = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if activation == "silu":
        t = F.silu(t)
    t = t.to(torch.bfloat16).float()
    y = F.conv2d(t.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + bias
    if ws is not None:
        y = y + skip.float() @ ws.float() + wsb
    elif skip is not None:
        y = y + skip.float()
    y = y.to(torch.bfloat16)
    return y, rb.tensor_stats(y)


def upsample_conv3x3_stats_exact(x, w, bias):
    """K2's arithmetic in fp32: the four 2x2 parity convs over the weights
    folded in fp32 and rounded to bf16, fp32 sums, one rounding of y."""
    bsz, h, wd, c = x.shape
    n = w.shape[3]
    w_fold = rb.fold_subpixel_weights(w.float()).to(torch.bfloat16).float()
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    y = torch.empty((bsz, 2 * h, 2 * wd, n), device=x.device)
    for pa in range(2):
        for pb in range(2):
            k = w_fold[pa, pb].reshape(2, 2, c, n).permute(3, 2, 0, 1)  # [u, v, c, n] -> OIHW
            part = F.conv2d(xp[:, :, pa : pa + h + 1, pb : pb + wd + 1], k)
            y[:, pa::2, pb::2] = part.permute(0, 2, 3, 1)
    y = (y + bias).to(torch.bfloat16)
    return y, rb.tensor_stats(y)


def attention_exact(q, k, v, scale):
    """fp32 attention of the same bf16 inputs: (out, lse)."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    out = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    return out, torch.logsumexp(logits, dim=-1)


def _conv_errors(y, stats, y_ref, stats_ref):
    """(max abs y error, its share of max|y_ref|, max abs stats error, that
    error normalised by H*W*mean(y_ref^2))."""
    rf = y_ref.float()
    err_y = (y.float() - rf).abs().max().item()
    err_s = (stats - stats_ref).abs().max().item()
    norm = y.shape[1] * y.shape[2] * rf.square().mean().item()
    return err_y, err_y / rf.abs().max().item(), err_s, err_s / norm


def _check_conv(label, run_k, run_p, run_x):
    y, st = run_k()
    y_p, st_p = run_p()
    y_x, st_x = run_x()
    torch.cuda.synchronize()
    err_y, rel_p, abs_s, s_p = _conv_errors(y, st, y_p, st_p)
    _, rel_x, _, s_x = _conv_errors(y, st, y_x, st_x)
    s_px = _conv_errors(y_p, st_p, y_x, st_x)[3]
    ms, plain_ms = time_ms(run_k), time_ms(run_p)
    ok = (rel_p <= CONV_Y_REL_TOL and s_p <= CONV_STATS_PLAIN_TOL and rel_x <= CONV_Y_EXACT_TOL
          and s_x <= CONV_STATS_EXACT_TOL and bool(torch.isfinite(y.float()).all()))
    log("kernels", f"{label}: vs plain y max_abs_err={err_y:.4g} (rel {rel_p:.3g} <= {CONV_Y_REL_TOL}) "
        f"stats max_abs_err={abs_s:.4g} (normalised {s_p:.3g} <= {CONV_STATS_PLAIN_TOL}); "
        f"vs exact y rel {rel_x:.3g} (<= {CONV_Y_EXACT_TOL}) stats {s_x:.3g} (<= {CONV_STATS_EXACT_TOL}); "
        f"plain vs exact stats {s_px:.3g}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"{'ok' if ok else 'FAIL'}")
    return ok, label, err_y, ms, plain_ms


def check_conv(gen, shape, n_out, *, skip, activation):
    bsz, h, w, c = shape
    x = _randn(gen, shape)
    a = 1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    b = 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    wt = _randn(gen, (3, 3, c, n_out), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")
    sk, ws, wsb = None, None, None
    if skip == "identity":
        sk = _randn(gen, (bsz, h, w, n_out))
    elif skip == "proj":
        sk = x
        ws = _randn(gen, (c, n_out), 1.0 / math.sqrt(c))
        wsb = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")
    args = (x, a, b, wt, bias, sk, ws, wsb, activation)
    return _check_conv(
        f"resnet_conv3x3_stats {shape}->{n_out} {activation} skip={skip}",
        lambda: rb.conv3x3_stats_cuda(*args),
        lambda: rb.conv3x3_stats_plain(*args),
        lambda: conv3x3_stats_exact(*args),
    )


def check_upsample(gen, shape, n_out):
    c = shape[3]
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, c, n_out), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")
    return _check_conv(
        f"subpixel_upsample_conv3x3_stats {shape}->{n_out}",
        lambda: rb.upsample_conv3x3_stats_cuda(x, wt, bias),
        lambda: rb.upsample_conv3x3_stats_plain(x, wt, bias),
        lambda: upsample_conv3x3_stats_exact(x, wt, bias),
    )


def check_attention(gen, shape):
    bsz, heads, seq, d = shape
    q, k, v = (_randn(gen, (bsz * heads, seq, d)) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    run_k = lambda: fa.flash_attention_cuda(q, k, v, sm_scale=scale)
    run_p = lambda: fa.attention_plain(q, k, v, sm_scale=scale)
    out, lse = run_k()
    ref = run_p().float()
    ref_x, lse_x = attention_exact(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    rel_p = err / ref.abs().max().item()
    rel_x = (out.float() - ref_x).abs().max().item() / ref_x.abs().max().item()
    err_lse = (lse - lse_x).abs().max().item()
    ms, plain_ms = time_ms(run_k), time_ms(run_p)
    ok = (rel_p <= ATTN_PLAIN_REL_TOL and rel_x <= ATTN_EXACT_REL_TOL
          and err_lse <= ATTN_LSE_ABS_TOL and bool(torch.isfinite(out.float()).all()))
    log("kernels", f"flash_attention_fwd {shape}: vs plain max_abs_err={err:.4g} "
        f"(rel {rel_p:.3g} <= {ATTN_PLAIN_REL_TOL}); vs fp32 rel {rel_x:.3g} "
        f"(<= {ATTN_EXACT_REL_TOL}) lse {err_lse:.3g} (<= {ATTN_LSE_ABS_TOL}); "
        f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
    return ok, f"{shape}", err, ms, plain_ms


def phase_kernels() -> dict:
    gen = torch.Generator("cuda").manual_seed(SEED)
    cases = {
        "resnet_conv3x3_stats": [
            lambda: check_conv(gen, (2, 128, 128, 512), 512, skip=None, activation="silu"),
            lambda: check_conv(gen, (2, 128, 128, 512), 256, skip="proj", activation="silu"),
            lambda: check_conv(gen, (1, 64, 64, 128), 128, skip="identity", activation="identity"),
        ],
        "subpixel_upsample_conv3x3_stats": [
            lambda: check_upsample(gen, (2, 64, 64, 512), 512),
            lambda: check_upsample(gen, (1, 256, 256, 256), 256),
        ],
        "flash_attention_fwd": [
            lambda: check_attention(gen, (1, 24, 2560, 128)),
            lambda: check_attention(gen, (1, 24, 2600, 128)),   # ragged: 40 keys in the last tile
            lambda: check_attention(gen, (1, 24, 300, 128)),    # ragged: 44 of 300 keys in it
            lambda: check_attention(gen, (1, 1, 4096, 512)),
            lambda: check_attention(gen, (1, 1, 120, 512)),     # ragged: 24 of 120 keys in it
        ],
    }
    results, all_ok = {}, True
    for name, fns in cases.items():
        runs = [fn() for fn in fns]
        all_ok &= all(r[0] for r in runs)
        first = runs[0]
        results[name] = {
            "shape": first[1],
            "max_abs_err": max(r[2] for r in runs),
            "ms": first[3],
            "plain_ms": first[4],
        }
    if not all_ok:
        raise SystemExit("[kernels] a kernel disagrees with its plain version or exact reference")
    return results


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full width
# ---------------------------------------------------------------------------
def phase_slice() -> dict:
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    t0 = time.perf_counter()
    model = FluxTextAlphaModel.random(
        FluxTransformerConfig(), vae_cfg, seed=SEED, device="cuda",
        dtype=torch.bfloat16, fused=True,
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.transformer.parameters())
    log("slice", f"built FLUX.1-Kontext transformer ({n_params / 1e9:.2f} B params) and "
        f"RGBA VAE in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    rng = np.random.default_rng(SEED)
    images = [
        rng.uniform(size=(512, 512, 4)).astype(np.float32),
        rng.uniform(size=(512, 512, 4)).astype(np.float32),
        rng.uniform(size=(600, 400, 4)).astype(np.float32),
    ]
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=4, auto_batch=False))
    torch.cuda.reset_peak_memory_stats()
    rb.reset_launch_counts()
    fa.reset_launch_counts()
    with server:
        t_submit = time.perf_counter()
        futures = [server.submit(img, seed=i) for i, img in enumerate(images)]
        outs, lat = [], []
        for fut in futures:
            outs.append(fut.result(timeout=900))
            lat.append(time.perf_counter() - t_submit)
        drained = server.drain(timeout=60)
    counts = {
        "resnet_conv3x3_stats": rb.CONV_LAUNCHES,
        "subpixel_upsample_conv3x3_stats": rb.UPSAMPLE_LAUNCHES,
        "flash_attention_fwd": fa.LAUNCHES,
    }
    peak = torch.cuda.max_memory_allocated()
    for img, out, t in zip(images, outs, lat):
        if out.shape != img.shape:
            raise SystemExit(f"[slice] output shape {out.shape} != request shape {img.shape}")
        if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
            raise SystemExit("[slice] output not finite or outside [0, 1]")
        log("slice", f"request {img.shape[0]}x{img.shape[1]}: latency {t:.3f} s, "
            f"out range [{out.min():.3f}, {out.max():.3f}] mean {out.mean():.4f}")
    log("slice", f"server stats {server.stats} drained={drained}")
    log("slice", f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    if not all(n > 0 for n in counts.values()):
        raise SystemExit(f"[slice] a kernel of the path never launched: {counts}")
    return counts


def main() -> int:
    name = phase_device()
    phase_build()
    results = phase_kernels()
    counts = phase_slice()
    summary = {"kernels": [
        {"name": k, "route": "cuda", **KERNELS[k], "launches": counts[k], **results[k]}
        for k in KERNELS
    ]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
