"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its own lines and, as `[time]`, what it took on the wall
clock; any failure exits non-zero without the final line):

1. device  - a CUDA device must exist; prints the card's name and power limit
             and turns TF32 off.
2. build   - compiles the hand-written kernels from `ragb_vae_tpu_torch/csrc`
             and, beside them with g++, the native PNG codec
             (`csrc/rgba_io.cpp`, libpng); prints whether the codec built and
             the host ms of a 512^2 RGBA PNG decode and encode, native against
             PIL (a missing libpng is reported, not a failure: the loaders
             then keep PIL, as the JAX package does).
3. kernels - each kernel against its plain PyTorch version and against an
             exact fp32 reference (the attention's log-sum-exp included; the
             Winograd conv against the exact direct conv), in
             bf16 at the shapes the serving path and the training step give it
             (the attention also at a sequence-parallel rank's queries
             against the gathered keys) plus short ragged ones: errors, tolerances, the median of 10
             CUDA-event-timed runs of kernel and plain version, and the bound
             (the least time the card could take for the same work); K6's
             dskip also alone, at the four shapes of a VAE micro-batch,
             beside `torch.matmul` of the same product; the attention
             prologue (K13) forward against its plain version in ulps of
             each rotated pair and backward against fp32 autograd through
             the plain chain, timed beside that chain.
4. slice   - builds FluxTextAlphaModel at full published width (FLUX.1-Kontext
             transformer, FLUX `ae` RGBA VAE) with random weights from a seed,
             serves 3 requests as uint8 PNGs over HTTP through the serving
             daemon (`serving_daemon.make_httpd` on 127.0.0.1 over an
             InferenceServer), reads /healthz before and after, checks each
             answer and that every kernel launched during that run, then
             shuts the daemon down and drains it.
12. pp     - (right after phase 4, on its model) pipeline parallelism with
             every stage on the one card: prints the plan's per-stage bytes
             of full-depth FLUX.1-Kontext at pp 2, 4 and 8 and the device
             guard's host cost per launch, serves the slice phase's 512^2
             request at pp 4 through `InferenceServer(pipeline=)` (bit-equal
             to the slice phase's answer, each stage's K3 launches counted),
             holds a b2 forward at microbatch 2 and 1 against the monolithic
             one, takes one `PipelineLoraTrainer` step at 2 stages on a
             full-width 2 + 4 block transformer (512^2 b2, microbatch 1) and
             holds its loss and adapter gradients against the monolithic
             step's; four planted faults (a dropped block, txt and img
             swapped, temb not carried, a microbatch divided by its own
             weight sum) must fail the bounds. The int8 phase also runs its
             forward at pp 4, bit-equal, K10 counted per stage.
6. lora    - (runs before phase 5, on the serving phase's model) attaches
             rank-128 LoRA adapters to the full-width FLUX.1-Kontext
             transformer (frozen bf16 base, fp32 adapters, per-block
             recompute), writes a small (gt, text_alpha) PNG tree at 512^2 and
             runs the LoRA stage's own loop through `train_from_config` for 2
             optimizer steps of 2 pairs in 2 micro-batches, saves, reloads the
             adapters, checks losses, gradients, what moved and that the
             attention forward and both backward kernels launched, then holds
             the adapters' gradient tree through the kernels against the plain
             attention route at 256^2, and through K13 against the plain
             prologue chain.
8. int8    - (on the same model, after the LoRA phase) quantises every linear
             of the transformer to weight-only int8 on the card, holds one
             forward against the bf16 one from the same weights, serves 3
             requests through InferenceServer with every linear going through
             the int8 matmul kernel, takes 2 QLoRA optimizer steps through
             `train_from_config(weight_quant="int8")` (fp32 adapters over the
             frozen int8 base, the LoRA phase's PNG tree; its final save is
             stubbed out, since the LoRA phase already writes and reloads one
             through the same code), checks
             the probe loss, the gradients, the unchanged base and the launch
             counts, then holds the adapters' gradient tree through the int8
             matmul kernel against its plain version at 256^2.
10. tp     - (after the int8 phase, once the serving model is freed) tensor
             parallelism over two processes on the one card, joined in a gloo
             group (NCCL refuses two ranks on one device; the collectives'
             times are gloo's through host memory): each rank draws its shard
             of the full-width FLUX.1-Kontext from the slice phase's seed,
             rank 0 serves one 512^2 request through
             `InferenceServer(tp_group=)` while rank 1 follows in
             `serve_worker`, and its float answer, one bf16 forward and (each
             rank quantising its shard with the whole layers' scales) one int8
             forward are held against the slice and int8 phases' answers to
             the same inputs; then one `make_lora_train_step` step at
             tensor_parallel 2 over a full-width 2 + 4 block transformer with
             non-zero biases, its summed adapter gradients held against the
             same model unsharded, the two ranks' adapters equal bit for bit
             after the update. Three planted faults (a row all-reduce
             dropped, a row bias added twice, proj_out's rows in JAX's
             contiguous order) must fail the same bounds. Prints each rank's
             memory beside the slice phase's, the collectives per forward and
             the s/step.
11. axes   - (after tp; needs no other phase) the LoRA stage's FSDP and
             sequence-parallel axes over two processes on the one card in a
             gloo group, on a full-width 2 + 4 block FLUX.1-Kontext
             transformer from a seed: at data 2 each rank draws only its
             FSDP part of the frozen base and takes one
             `make_lora_train_step` step of its own 512^2 pair, the two
             ranks' mean adapter gradients held against the whole model's
             over both pairs, and an int8 base drawn split runs one forward
             through K10 on gathered weights against the whole int8
             model's; at sequence_parallel 2 one step on one 512^2 pair with
             K3, K4 and K5 at 1280 queries x 2560 gathered keys, its summed
             gradients against the unsharded run, and a 4-step sample
             against the whole model's. Prints each rank's resident and
             peak memory, the base bytes a rank holds (also full-depth, from
             the plan), the collectives a step; four planted faults (dK / dV
             not summed, the prediction's gradient summed, RoPE ids cut
             strided, FSDP's shards in reversed rank order) must fail the
             gradients' bound.
7. convs   - the three stand-alone VAE convs through their entry points
             (`Downsample(fused=True)` feeding a fused resnet block,
             `Conv3x3`, `fused_gn_silu_conv3x3_batched`) at the FLUX `ae`
             widths, each against its unfused counterpart.
5. train   - builds the RGBA VAE at full FLUX `ae` width (fp32 parameters, bf16
             compute, fused kernels, remat="half") with a frozen reference and
             an LPIPS term over seeded weights, takes 1 optimizer step at
             512^2 (8 images in 2 micro-batches of 4) and one eval step, checks
             losses, gradients, parameter movement and that the forward and
             backward kernels launched, then holds the whole gradient tree
             through the kernels against the plain route at 128^2. Then the
             optimizer offload at the same width: two ZeRO-2 steps
             (`make_train_step(mesh=)` on a 1-process data axis) with the
             AdamW moments in pinned host memory between steps, against two
             `ClippedAdamW` steps and two ZeRO-2 steps without offload from
             the same start on the same 128^2 images and noise; the moments
             must lie in pinned host memory between steps, and the device
             memory (peak and resident) with and without offload is printed.
9. stage1  - the stage-1 loop through `run_stage` on configs/flux_vae.yaml,
             overlaid at full FLUX `ae` width (a seeded random RGB checkpoint
             and LPIPS weights written as files, a PNG tree with a w512-h512
             train bucket and a w768-h512 val bucket, 512-pixel tiles, batch 2)
             with every resnet conv on the Winograd route (K8): first one
             forward through both conv routes, then 2 steps, validation
             through the tiled encode and decode, the periodic and the final
             save, the step-2 checkpoint's weights reloaded bit for bit, and
             `resume_from: auto` for step 3 from the saved AdamW state. The
             loop runs inside a real NCCL process group of world size 1 (a
             FileStore in the phase's temp dir), so its step is the ZeRO-2
             step and its checkpoints go through the gathered optimizer
             state; NCCL's reduce-scatter, all-gather and all-reduce are
             first run once on the card and checked.
13. textenc - the empty prompt's text encoders (no kernel: plain PyTorch in
             fp32, TF32 off): CLIP-L and the T5-v1.1-XXL encoder at full
             published width and depth from a seed encode FLUX's empty-prompt
             token ids (77 and 512 positions, read from FLUX-style tokenizer
             files); prints the shapes, each encoder's ms and the peak
             memory beside the card's name and power limit. Then both at
             depth 2 and full width on the card against the CPU on the same
             weights (bound TEXTENC_HOLD_TOL), and the card's run with the
             padding mask dropped (a planted fault) must fail that bound.
             Last, `from_pretrained` on the card on a narrow checkpoint with
             tokenizer files and both encoders but no npz writes
             empty_prompt_embeds.npz, a second load reads it back bit for bit,
             and the embeddings agree with the CPU's.
14. weights - a FLUX.1-Kontext-dev checkpoint directory in the published
             layout (`transformer/`: full width, depth 1 + 2, random bf16 values
             from a seed, 3 shards + index; `scheduler/`; the empty prompt's
             npz) and the FLUX `ae` in RGB, written from the same seed's model
             built in memory, through `from_pretrained`: load seconds, GiB on
             disk, host peak RSS and device memory; weights bit-equal to the
             model in memory, and a 4-step 512^2 sample (K1, K2, K3) against
             that model's on the same noise; int8 at load (K10) against the
             bf16 sample; the widened VAE's 256^2 encode and decode against the
             CPU's fp32 plain route and `scripts/record_goldens_torch.py`'s
             goldens; LPIPS from lpips' and torchvision's keys, identical; two
             planted faults (a square tensor written transposed, an index that
             names a key's shard wrongly) must fail.

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))

from ragb_vae_tpu_torch.ops.kernels import _build  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import attn_prologue as ap  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import fused_gn_silu_conv as fgc  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb  # noqa: E402
from rehearse_aux_assets_torch import write_flux_tokenizers  # noqa: E402

SEED = 0

KERNELS = {
    "resnet_conv3x3_stats": {
        "source": "ragb_vae_tpu_torch/csrc/conv_sm90.cuh",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:69",
    },
    "subpixel_upsample_conv3x3_stats": {
        "source": "ragb_vae_tpu_torch/csrc/conv_sm90.cuh",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:231",
    },
    "flash_attention_fwd": {
        "source": "ragb_vae_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/flash_attention.py:46",
    },
    "resnet_conv3x3_stats_bwd": {
        "source": "ragb_vae_tpu_torch/csrc/resnet_block_bwd.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:952",
    },
    "subpixel_upsample_conv3x3_stats_bwd": {
        "source": "ragb_vae_tpu_torch/csrc/resnet_block_bwd.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:2003",
    },
    "flash_attention_dq": {
        "source": "ragb_vae_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/flash_attention.py:198",
    },
    "flash_attention_dkv": {
        "source": "ragb_vae_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/flash_attention.py:237",
    },
    "downsample_conv3x3_stats": {
        "source": "ragb_vae_tpu_torch/csrc/conv_sm90.cuh",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:1622",
    },
    "int8_matmul": {
        "source": "ragb_vae_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/int8_matmul.py:65",
    },
    "conv3x3_same": {
        "source": "ragb_vae_tpu_torch/csrc/conv_sm90.cuh",
        "replaces": "ragb_vae_tpu/ops/pallas/conv3x3.py:39",
    },
    "fused_gn_silu_conv3x3": {
        "source": "ragb_vae_tpu_torch/csrc/conv_sm90.cuh",
        "replaces": "ragb_vae_tpu/ops/pallas/fused_gn_silu_conv.py:45",
    },
    "resnet_conv3x3_stats_wino": {
        "source": "ragb_vae_tpu_torch/csrc/resnet_block_wino.cu",
        "replaces": "ragb_vae_tpu/ops/pallas/resnet_block.py:383",
    },
}

# Published peaks of one H100 SXM (dense bf16 tensor-core rate, fp32 rate
# outside the tensor cores, HBM3 rate): a kernel's bound is the larger of its
# operations over the peak for their type and the bytes it must move (each
# input read once, each output written once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS, fp32_ops: float = 0.0) -> dict:
    """`flops` at `peak_flops` plus `fp32_ops` (adds outside the tensor cores)
    at the fp32 rate, against `nbytes` at the memory rate."""
    t_ops = flops / peak_flops + fp32_ops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)

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
# A conv kernel's statistics are held against the plain version's and against
# the fp64 (sum, sum of squares) of the kernel's OWN rounded y: the exact
# reference rounds its own y, which can differ from the kernel's by one ulp
# where the fp32 sums' order flips a rounding, and those flips are no fault
# of the statistics.
CONV_Y_REL_TOL = 3e-2          # vs plain: two roundings of 2^-8 each
# vs plain: the bias added between the plain version's two roundings is the
# same for every pixel of a channel, so the second rounding's error has one
# sign across the channel and its sums drift by up to ~6e-3
CONV_STATS_PLAIN_TOL = 1e-2
CONV_Y_EXACT_TOL = 1e-2        # vs exact: one bf16 ulp of the largest value
CONV_STATS_EXACT_TOL = 1e-4    # vs fp64 sums of the kernel's own y: fp32 summation order only
# Attention: outputs relative to max|ref|; the LSE in absolute terms. An
# unmasked key tail or a dropped last key tile moves the LSE by 7e-3 or more
# at S = 2600; at S = 300 and S = 120 the tail is 15-20% of the keys.
ATTN_PLAIN_REL_TOL = 5e-2      # vs plain: its logits are rounded to bf16
ATTN_EXACT_REL_TOL = 1e-2      # vs fp32: P and O rounded to bf16 once each
ATTN_LSE_ABS_TOL = 1e-4        # vs fp32 logsumexp of the same logits
# Backward kernels (K6, K7): every cotangent's max abs error relative to
# max|reference|. The exact reference repeats the kernel's rounding points
# (dye and the recomputed activation rounded to bf16, fp32 sums, dx and dskip
# rounded once), so the bf16 outputs differ by one ulp of the largest value
# and the fp32 sums by summation order, plus the rare element whose bf16
# rounding flips on the last bit of expf. A weight-gradient partial left out
# drops 1/S of the pixels (S <= 64 slices: >= 1.5e-2 of the sum), a halo row
# left out of the data gradient is wrong by the size of the value itself on
# every tile's edge rows, and the statistics cotangent (drawn at 0.1) moves
# dye by ~10%: each is far past these bounds.
BWD_BF16_EXACT_TOL = 1e-2      # dx, dskip vs exact
BWD_SUM_EXACT_TOL = 2e-3       # da, db, dW, dbias, dws, dwsb vs exact
# vs plain: autograd through the plain forward rounds dye's terms, dA and the
# activation's cotangent to bf16 at other places, 2^-8 relative each
BWD_BF16_PLAIN_TOL = 4e-2
BWD_SUM_PLAIN_TOL = 2e-2
# Attention backward (K4 dQ, K5 dK/dV): each output's max abs error relative
# to max|reference|. The exact reference repeats the kernels' rounding points
# (P and dS rounded to bf16, fp32 sums, one final rounding), so the outputs
# differ by one bf16 ulp of the largest value (2^-8 = 3.9e-3) and by the rare
# P or dS element whose rounding flips on the last bit of exp2f. The plain
# version rounds the logits and dP to bf16 as well (2^-8 of values up to ~5,
# inside an exponential). An unmasked key tail adds up to 24 copies of the
# last key to every dQ row, and a query tile left out drops 64 of S terms
# from every dK and dV entry (>= 8% of a typical entry at S = 8704): each is
# far past the exact bound.
ATTN_BWD_EXACT_TOL = 1e-2
ATTN_BWD_PLAIN_TOL = 5e-2
# Attention prologue (K13): the forward against its plain version in ulps of
# each rotated pair's length (the mean square summed in another order can
# flip the normed pair's bf16 rounding, which RoPE spreads over the pair; one
# flip per element of the pair at most); the backward's bf16 gradients
# against autograd through the plain chain in fp32, relative to max|ref| (one
# bf16 rounding, 2^-8). A row read with another row's rstd, a pair rotated
# the wrong way or a stream's weights swapped moves an element by its own
# size: far past both.
PROLOGUE_PAIR_ULPS = 2.0
PROLOGUE_BWD_REL_TOL = 1e-2
# Winograd conv (K8): y relative to max|y|, statistics normalised as K1's.
# Against its plain version, which rounds V, U and y where the kernel does, y
# differs by one bf16 ulp of the largest value and the statistics by the order
# of fp32 sums (CONV_Y_EXACT_TOL, CONV_STATS_EXACT_TOL). Against the exact
# direct conv of the same bf16 inputs, V (the transformed input) and U (the
# transformed weights) are each rounded to bf16 once more: every output
# carries ~2^-9 relative noise from each, and U's rounding is the same for
# every pixel of a channel, so the channel sums drift with it. A CPU
# restatement of the same arithmetic at (1,32,32,512)->512, (1,64,64,128)->128
# and (1,32,32,256)->512 with chip_smoke's input distributions reads y
# 5.0e-3..5.8e-3 and statistics 7.6e-4..3.1e-3: the bounds leave that twice
# to three times its size. A column variant's products left out or a sign
# flipped in a transform moves y by the size of a whole term: far past both.
WINO_Y_DIRECT_TOL = 1.5e-2
WINO_STATS_DIRECT_TOL = 1e-2
# A rounding the plain version does not make (the folded products Z rounded
# to bf16 before the column transform) moves every y by ~2^-9 of its Z terms,
# less than one ulp of the largest y: the max-based bounds cannot see it. Over
# the whole tensor it can be seen: ||y - y_plain|| / ||y_plain||, where the two
# differ only where the fp32 sums' order flips a rounding of y. On an H100 the
# three K8 cases read 7.2e-5..1.23e-4, and 1.98e-3..2.96e-3 with Z rounded.
WINO_Y_PLAIN_NORM_TOL = 3e-4


# Weight-only int8 matmul (K10): max abs error relative to max|reference|. The
# exact reference is the kernel's own arithmetic in fp32 (the integers cast
# exactly, fp32 sums, scale and bias once, one rounding to x's dtype): with
# bf16 x the results differ by one bf16 ulp of the largest value, with fp32 x
# by the order of an fp32 sum over K <= 15360 terms. The plain version rounds
# the unscaled product to bf16 before it scales it and rounds again. A K tile
# of 64 left out moves every output by ~sqrt(64 / K) of its size (>= 6e-2 at
# K = 15360), a scale left out of a tile multiplies it by ~1 / scale
# (> 1000), and a weight fragment read from another k-step (or, in the
# skinny kernel, x's second chunk of 2048 k taken from its first) makes the
# terms it touches uncorrelated, errors of the output's own size: each is far
# past the exact bound.
INT8_BF16_EXACT_TOL = 1e-2
INT8_FP32_EXACT_TOL = 1e-4
INT8_PLAIN_TOL = 3e-2
# The int8 transformer against the bf16 one it was quantised from, one forward
# at 512^2 on the same inputs: the whole output's ||int8 - bf16|| / ||bf16||
# and cosine. Per-output-channel int8 of a lecun-normal weight carries ~1% of
# noise per linear ((4.5 sigma / 127) / sqrt(12)), which adds up over 57 blocks
# beside the bf16 rounding both models share; a linear whose scale or layout
# is wrong decorrelates the output (relative error ~1.4, cosine ~0). On an
# H100 the run reads 0.051 and 0.9987: the bounds leave three times that.
INT8_TRACK_REL_TOL = 0.15
INT8_TRACK_COS_TOL = 0.99


SERVE_STEPS = 4                # sampler steps of a served request


def reset_all_counts() -> None:
    for module in (rb, fa, i8, c3, fgc, ap):
        module.reset_launch_counts()


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, runs: int = 10, warmups: int = 2) -> float:
    """Median of `runs` CUDA-event-timed calls, after `warmups` warm-up calls."""
    for _ in range(warmups):
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


def log_tflops(phase: str, what: str, flops: float, seconds: float) -> None:
    """One line of model TFLOP/s (`ops/flops.py`'s count of the work over the
    time) and its share of the card's bf16 peak."""
    from ragb_vae_tpu_torch.ops.flops import peak_flops_for

    peak = peak_flops_for(torch.cuda.get_device_name(0))
    rate = flops / seconds / 1e12
    log(phase, f"model TFLOP/s, {what}: {flops / 1e12:.3f} TFLOP in {seconds * 1e3:.1f} ms -> {rate:.2f} TFLOP/s, "
        + (f"{rate * 1e12 / peak:.2%} of the card's {peak / 1e12:.0f} TFLOP/s bf16 peak" if peak
           else "no peak known for this card"))


def time_queued_ms(fn, runs: int = 10) -> float:
    """Mean time of `runs` calls issued back to back between two CUDA events,
    after two warm-up calls: the host's work per call overlaps the card's, as
    on a path that keeps the card fed. `time_ms` starts each call on an idle
    card, so it also counts the host's work before the last launch."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


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
    """nvcc for the kernels and, on a thread beside it, g++ for the codec."""
    from ragb_vae_tpu_torch.data import native_io

    t0 = time.perf_counter()
    codec = {}

    def build_codec():
        codec["available"] = native_io.available()
        codec["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=build_codec)
    thread.start()
    _build.build()
    _build.library()
    log("build", f"{_build.library_path().name} ready in {time.perf_counter() - t0:.1f} s")
    thread.join()
    if not codec["available"]:
        why = [line for line in str(native_io.load_error).splitlines() if "error" in line] or [native_io.load_error]
        log("build", f"native PNG codec NOT available on this host (the loaders keep PIL): {why[0].strip()}")
        return
    log("build", f"native PNG codec {_build.rgba_io_path().name} ready in {codec['s']:.1f} s")
    _codec_times(native_io)


def _codec_times(native_io) -> None:
    """Host ms (median of 5) of one 512^2 RGBA PNG decoded to float32 and
    encoded from it, by the native codec and by the PIL path of
    `data/image_io.py`; the two decodes must agree to one 8-bit level."""
    from PIL import Image

    from ragb_vae_tpu_torch.data.image_io import pil_to_array

    rng = np.random.default_rng(SEED + 13)
    low = (rng.uniform(size=(16, 16, 4)) * 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "in.png"
        Image.fromarray(low, mode="RGBA").resize((512, 512), resample=3).save(path)

        def pil_decode():
            with Image.open(path) as img:
                return pil_to_array(img.convert("RGBA"))

        def pil_encode(arr):
            Image.fromarray((np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8), mode="RGBA").save(Path(tmp) / "p.png")

        def median_ms(fn, *args):
            times = []
            for _ in range(5):
                t = time.perf_counter()
                fn(*args)
                times.append(1e3 * (time.perf_counter() - t))
            return statistics.median(times)

        native, pil = native_io.decode_png(path), pil_decode()
        if np.abs(native - pil).max() > 1.0 / 255:
            raise SystemExit("[build] the native PNG decode disagrees with PIL's")
        encode_native = median_ms(native_io.encode_png, Path(tmp) / "n.png", native)
        log("build", f"512^2 RGBA PNG ({path.stat().st_size} bytes), host ms: decode native "
            f"{median_ms(native_io.decode_png, path):.2f} / PIL {median_ms(pil_decode):.2f}; encode native "
            f"{encode_native:.2f} / PIL {median_ms(pil_encode, native):.2f}")


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


def upsample_conv3x3_exact(x, w, bias):
    """K2's y in fp32 arithmetic: the four 2x2 parity convs over the weights
    folded in fp32 and rounded to bf16, fp32 sums, one rounding."""
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
    return (y + bias).to(torch.bfloat16)


def _dye_exact(y, gy, gstats):
    """The cotangent of the conv output once the statistics' share is added:
    fp32 from bf16 g, bf16 y and fp32 ds, rounded to bf16 (kept as fp32)."""
    dye = gy.float() + gstats[:, 0, None, None, :] + 2.0 * y.float() * gstats[:, 1, None, None, :]
    return dye.to(torch.bfloat16).float()


def _pixel_outer(lhs, rhs):
    """sum over (b, h, w) of lhs[b,h,w,:]^T rhs[b,h,w,:] -> (C, N) in fp32."""
    return lhs.reshape(-1, lhs.shape[-1]).t() @ rhs.reshape(-1, rhs.shape[-1])


def conv3x3_stats_bwd_exact(x, a, b, w, bias, skip, ws, wsb, y, gy, gstats, activation):
    """K6's arithmetic in fp32 PyTorch with its rounding points."""
    _, h, wd, _ = x.shape
    dye = _dye_exact(y, gy, gstats)
    wf = w.to(torch.bfloat16).float()
    wt = wf.flip(0, 1).permute(0, 1, 3, 2)                      # (3, 3, N, C)
    d_act = F.conv2d(dye.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    xf = x.float()
    t = xf * a[:, None, None, :] + b[:, None, None, :]
    if activation == "silu":
        sg = torch.sigmoid(t)
        d_t = d_act * (sg * (1.0 + t * (1.0 - sg)))
        act = t * sg
    else:
        d_t, act = d_act, t
    dx = (d_t * a[:, None, None, :]).to(torch.bfloat16)
    da, db = (d_t * xf).sum(dim=(1, 2)), d_t.sum(dim=(1, 2))
    ap = F.pad(act.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))  # zero AFTER the activation
    dw = torch.stack([
        torch.stack([_pixel_outer(ap[:, u : u + h, v : v + wd], dye) for v in range(3)])
        for u in range(3)
    ])
    dbias = dye.sum(dim=(0, 1, 2))
    dskip = dws = dwsb = None
    if ws is not None:
        dskip = (dye @ ws.to(torch.bfloat16).float().t()).to(torch.bfloat16)
        dws, dwsb = _pixel_outer(skip.float(), dye), dbias
    elif skip is not None:
        dskip = dye.to(torch.bfloat16)
    return dx, da, db, dw, dbias, dskip, dws, dwsb


def upsample_conv3x3_stats_bwd_exact(x, w, bias, y, gy, gstats):
    """K7's arithmetic in fp32 PyTorch: dx as the stride-2 conv4x4 of dye over
    the doubly folded weights rounded to bf16; the folded weights' gradient
    tap by tap (small-grid pixel (r+a+u-1, c+b+v-1) against large-grid pixel
    (2r+a, 2c+b)), unfolded in fp32."""
    _, h, wd, c = x.shape
    dye = _dye_exact(y, gy, gstats)
    wb = rb.fold_subpixel_bwd_weights(w.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    dx = F.conv2d(dye.permute(0, 3, 1, 2), wb.permute(3, 2, 0, 1), stride=2, padding=1)
    dx = dx.permute(0, 2, 3, 1).to(torch.bfloat16)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dw_fold = torch.stack([
        torch.stack([
            torch.stack([
                torch.cat([_pixel_outer(xp[:, pa + u : pa + u + h, pb + v : pb + v + wd],
                                        dye[:, pa::2, pb::2]) for v in range(2)])
                for u in range(2)])
            for pb in range(2)])
        for pa in range(2)])
    return dx, rb.unfold_subpixel_weight_grad(dw_fold), dye.sum(dim=(0, 1, 2))


def attention_exact(q, k, v, scale):
    """fp32 attention of the same bf16 inputs: (out, lse)."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    out = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    return out, torch.logsumexp(logits, dim=-1)


def _conv_errors(y, stats, y_ref, stats_ref):
    """(max abs y error, its share of max|y_ref|, max abs stats error, that
    error normalised by H*W*mean(y_ref^2)); zeros for a kernel without
    statistics."""
    rf = y_ref.float()
    err_y = (y.float() - rf).abs().max().item()
    if stats is None:
        return err_y, err_y / rf.abs().max().item(), 0.0, 0.0
    err_s = (stats - stats_ref).abs().max().item()
    norm = y.shape[1] * y.shape[2] * rf.square().mean().item()
    return err_y, err_y / rf.abs().max().item(), err_s, err_s / norm


def _with_stats(out):
    return out if isinstance(out, tuple) else (out, None)


def _own_stats(y):
    """The fp64 (sum, sum of squares) over H and W of y as it is: (B, 2, N)."""
    yd = y.double()
    return torch.stack([yd.sum(dim=(1, 2)), yd.square().sum(dim=(1, 2))], dim=1)


def _launch_or_fail(label, run_k):
    """run_k() and a synchronise; a launch that fails (a ring wait that
    traps), on a kernel's first call or while it is timed, fails this
    kernel's line and the phase."""
    try:
        out = run_k()
        torch.cuda.synchronize()
    except RuntimeError as err:
        first = str(err).strip().splitlines()[0] if str(err).strip() else type(err).__name__
        log("kernels", f"{label}: the kernel failed ({first[:200]}) FAIL")
        raise SystemExit(f"[kernels] {label}: the kernel failed") from err
    return out


def _check_conv(label, run_k, run_p, run_x, flops, nbytes, run_lib=None, lib_name="", queued=False,
                part_only=False, variant=None):
    """A conv kernel (y, or y and statistics) against its plain version, y
    against its exact reference and the statistics against fp64 sums of the
    kernel's own y; `run_lib`: the one PyTorch call that computes the same y,
    timed as a yardstick (`part_only`: a call for a part of the function
    only, printed and not reported as the library's time); `queued`: also
    timed back to back; `variant`: (what, call), another way of calling the
    same kernel, timed the same way and printed beside `run_k`'s time. A
    launch that fails fails this kernel's line and the phase."""
    y, st = _with_stats(_launch_or_fail(label, run_k))
    y_p, st_p = _with_stats(run_p())
    y_x, _ = _with_stats(run_x())
    torch.cuda.synchronize()
    err_y, rel_p, abs_s, s_p = _conv_errors(y, st, y_p, st_p)
    _, rel_x, _, _ = _conv_errors(y, None, y_x, None)
    s_own = 0.0 if st is None else _conv_errors(y, st.double(), y, _own_stats(y))[3]
    ms, plain_ms = _launch_or_fail(label, lambda: (time_ms(run_k), time_ms(run_p)))
    queued_ms = _launch_or_fail(label, lambda: time_queued_ms(run_k)) if queued else None
    if variant is not None:
        v_ms, v_queued = _launch_or_fail(label, lambda: (time_ms(variant[1]), time_queued_ms(variant[1])))
    library_ms = None if run_lib is None else time_ms(run_lib)
    ok = (rel_p <= CONV_Y_REL_TOL and s_p <= CONV_STATS_PLAIN_TOL and rel_x <= CONV_Y_EXACT_TOL
          and s_own <= CONV_STATS_EXACT_TOL and bool(torch.isfinite(y.float()).all())
          and y.shape == y_x.shape)
    lim = bound(flops, nbytes)
    log("kernels", f"{label}: vs plain y max_abs_err={err_y:.4g} (rel {rel_p:.3g} <= {CONV_Y_REL_TOL}) "
        f"stats max_abs_err={abs_s:.4g} (normalised {s_p:.3g} <= {CONV_STATS_PLAIN_TOL}); "
        f"vs exact y rel {rel_x:.3g} (<= {CONV_Y_EXACT_TOL}); stats vs fp64 sums of its own y {s_own:.3g} "
        f"(<= {CONV_STATS_EXACT_TOL}); kernel {ms:.3f} ms "
        + (f"(back to back {queued_ms:.3f}) " if queued else "")
        + (f"{variant[0]} {v_ms:.3f} ms (back to back {v_queued:.3f}) " if variant is not None else "")
        + f"plain {plain_ms:.3f} ms "
        + (f"{lib_name} {library_ms:.3f} ms " if run_lib is not None else "")
        + f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}) {'ok' if ok else 'FAIL'}")
    return ok, label, err_y, ms, plain_ms, None if part_only else library_ms, lim


def _conv_inputs(gen, shape, n_out, skip, c_skip=None):
    """K1's operands; skip "proj" projects x itself (Cs = C) unless `c_skip`
    gives the skip a width of its own, as the model's fused blocks do."""
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
        sk = x if c_skip is None else _randn(gen, (bsz, h, w, c_skip))
        ws = _randn(gen, (sk.shape[3], n_out), 1.0 / math.sqrt(sk.shape[3]))
        wsb = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")
    return x, a, b, wt, bias, sk, ws, wsb


def _nan_guarded(t):
    """t (B, C) fp32 in memory followed by 64 NaN: a kernel that reads past
    channel C of its coefficients turns y into NaN."""
    flat = torch.full((t.numel() + 64,), float("nan"), device=t.device)
    flat[: t.numel()] = t.reshape(-1)
    return flat[: t.numel()].view(t.shape)


def _activated_nchw(x, a, b, activation):
    """bf16(act(x*a + b)) as NCHW: the input of K1's and K8's `F.conv2d` yardstick."""
    t = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return (F.silu(t) if activation == "silu" else t).to(torch.bfloat16).permute(0, 3, 1, 2)


def check_conv(gen, shape, n_out, *, skip, activation, c_skip=None):
    """K1; beside its time, `F.conv2d` over the activation it forms in shared
    memory (a yardstick for its conv part only: no one PyTorch call computes
    the whole function)."""
    bsz, h, w, c = shape
    x, a, b, wt, bias, sk, ws, wsb = _conv_inputs(gen, shape, n_out, skip, c_skip)
    a, b = _nan_guarded(a), _nan_guarded(b)
    args = (x, a, b, wt, bias, sk, ws, wsb, activation)
    c_skip = 0 if ws is None else sk.shape[3]
    flops = 2 * (9 * c + c_skip) * bsz * h * w * n_out
    nbytes = (_nbytes(x, a, b, wt, bias, ws, wsb) + (0 if sk is None or sk is x else _nbytes(sk))
              + 2 * bsz * h * w * n_out + 4 * bsz * 2 * n_out)       # y, stats
    t_lib, w_lib = _activated_nchw(x, a, b, activation), _oihw(wt)
    return _check_conv(
        f"resnet_conv3x3_stats {shape}->{n_out} {activation} skip={skip}"
        + (f" Cs={c_skip}" if c_skip and sk is not x else ""),
        lambda: rb.conv3x3_stats_cuda(*args),
        lambda: rb.conv3x3_stats_plain(*args),
        lambda: conv3x3_stats_exact(*args), flops, nbytes,
        lambda: F.conv2d(t_lib, w_lib, padding=1), "F.conv2d on the activated input (conv part only)",
        queued=True, part_only=True,
    )


def check_wino(gen, shape, n_out, *, skip, activation):
    """K8 against its plain version (the same Winograd arithmetic) and against
    the exact direct conv. K8's time is its wrapper's as the path calls it,
    U's tiles given (a fused ResnetBlock keeps them per weight); beside it,
    with U folded in the call, the fold alone and K1 on the same inputs, each
    from an idle card and back to back, and K1's yardstick: `F.conv2d` over
    the activated input (the conv part only)."""
    bsz, h, w, c = shape
    x, a, b, wt, bias, sk, ws, wsb = _conv_inputs(gen, shape, n_out, skip)
    args = (x, a, b, wt, bias, sk, ws, wsb, activation)
    u = rb.wino_tiles(wt, torch.bfloat16)
    run_k = lambda: rb.wino_conv3x3_stats_cuda(*args, u=u)
    run_f = lambda: rb.wino_conv3x3_stats_cuda(*args)
    y, st = _launch_or_fail(f"resnet_conv3x3_stats_wino {shape}", run_k)
    same_folded = torch.equal(y, run_f()[0])
    y_p, st_p = rb.wino_conv3x3_stats_plain(*args)
    y_x, st_x = conv3x3_stats_exact(*args)
    torch.cuda.synchronize()
    err_y, rel_p, _, s_p = _conv_errors(y, st, y_p, st_p)
    _, rel_x, _, s_x = _conv_errors(y, st, y_x, st_x)
    norm_p = ((y.float() - y_p.float()).norm() / y_p.float().norm()).item()
    del y_p, st_p, y_x, st_x
    run_k1 = lambda: rb.conv3x3_stats_cuda(*args)
    ms, plain_ms = time_ms(run_k), time_ms(lambda: rb.wino_conv3x3_stats_plain(*args))
    f_ms, k1_ms, fold_ms = time_ms(run_f), time_ms(run_k1), time_ms(lambda: rb.wino_tiles(wt, torch.bfloat16))
    queued_ms, f_queued_ms, k1_queued_ms = time_queued_ms(run_k), time_queued_ms(run_f), time_queued_ms(run_k1)
    t_lib, w_lib = _activated_nchw(x, a, b, activation), _oihw(wt)
    lib_ms = time_ms(lambda: F.conv2d(t_lib, w_lib, padding=1))
    del t_lib
    c_skip = 0 if ws is None else sk.shape[3]
    pixels = bsz * h * w
    # the function's work: F(2x2, 3x3)'s 16 products a tile (4/9 of the
    # direct MACs) and the projection on the tensor cores; the transforms'
    # fp32 adds (32 per 2x2 tile and input channel, 24 per tile and output
    # channel) on the CUDA cores
    flops = 2 * (4 * c + c_skip) * pixels * n_out
    fp32_ops = (32 * c + 24 * n_out) * pixels // 4
    nbytes = (_nbytes(x, a, b, wt, bias, ws, wsb) + (_nbytes(sk) if skip == "identity" else 0)
              + 2 * pixels * n_out + 4 * bsz * 2 * n_out)
    limit = bound(flops, nbytes, fp32_ops=fp32_ops)
    # this design's own floor: the row fold's 24 products a tile (6/9 of the
    # direct MACs), its output transform's 8 adds a tile and output channel
    floor = bound(2 * (6 * c + c_skip) * pixels * n_out, nbytes, fp32_ops=(32 * c + 8 * n_out) * pixels // 4)
    direct = bound(2 * (9 * c + c_skip) * pixels * n_out, nbytes)
    ok = (rel_p <= CONV_Y_EXACT_TOL and norm_p <= WINO_Y_PLAIN_NORM_TOL and s_p <= CONV_STATS_EXACT_TOL
          and rel_x <= WINO_Y_DIRECT_TOL
          and s_x <= WINO_STATS_DIRECT_TOL and same_folded and bool(torch.isfinite(y.float()).all()))
    log("kernels", f"resnet_conv3x3_stats_wino {shape}->{n_out} {activation} skip={skip}: vs plain y "
        f"max_abs_err={err_y:.4g} (rel {rel_p:.3g} <= {CONV_Y_EXACT_TOL}), over the tensor {norm_p:.3g} (<= "
        f"{WINO_Y_PLAIN_NORM_TOL}) stats {s_p:.3g} (<= "
        f"{CONV_STATS_EXACT_TOL}); vs exact direct conv y rel {rel_x:.3g} (<= {WINO_Y_DIRECT_TOL}) stats "
        f"{s_x:.3g} (<= {WINO_STATS_DIRECT_TOL}); K8 as the blocks call it (U given) {ms:.3f} ms "
        f"(back to back {queued_ms:.3f}), U folded in the call {f_ms:.3f} ms ({f_queued_ms:.3f}; y the same: "
        f"{same_folded}), the U fold alone {fold_ms:.3f} ms, K1 "
        f"on the same inputs {k1_ms:.3f} ms ({k1_queued_ms:.3f}), plain {plain_ms:.3f} ms, F.conv2d on the "
        f"activated input (conv part only) {lib_ms:.3f} ms; bound "
        f"{limit['bound_ms']:.4f} ms ({limit['bound_by']}; Winograd's operations), the row fold's floor "
        f"{floor['bound_ms']:.4f} ms, a direct conv's {direct['bound_ms']:.4f} ms {'ok' if ok else 'FAIL'}")
    return ok, f"{shape}->{n_out} {activation} skip={skip}", err_y, ms, plain_ms, None, limit


# K6's dskip at the four projection blocks of a VAE micro-batch of 4 at 512^2
# (ch 128, mult (1, 2, 4, 4); the encoder's run at the triplet's batch 12):
# (dye shape, Cs), one launch each a micro-batch
DSKIP_SHAPES = [((12, 256, 256, 256), 128), ((12, 128, 128, 512), 256), ((4, 256, 256, 256), 512),
                ((4, 512, 512, 128), 256)]


def check_skip_grad(gen, shape, c_skip):
    """K6's dskip alone (the conv engine's one-tap mode) against its plain
    version, the exact fp32 dye @ ws^T rounded once, timed beside
    `torch.matmul` of the same product; its bound is the bytes it must
    move."""
    dye = _randn(gen, shape)
    ws = _randn(gen, (c_skip, shape[3]), 1.0 / math.sqrt(shape[3]))
    label = f"dskip {shape} @ ws^T -> Cs {c_skip}"
    got = _launch_or_fail(label, lambda: rb.skip_grad_cuda(dye, ws))
    want = rb.skip_grad_plain(dye, ws)                 # fp32 products and sums, one rounding: exact
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    del want
    ms, queued_ms = time_ms(lambda: rb.skip_grad_cuda(dye, ws)), time_queued_ms(lambda: rb.skip_grad_cuda(dye, ws))
    lib_ms = time_ms(lambda: torch.matmul(dye.view(-1, shape[3]), ws.t()))
    pixels = math.prod(shape[:3])
    limit = bound(2 * pixels * shape[3] * c_skip, _nbytes(dye, ws) + 2 * pixels * c_skip)
    ok = rel <= BWD_BF16_EXACT_TOL and bool(torch.isfinite(got.float()).all())
    log("kernels", f"{label}: vs exact {rel:.3g} (<= {BWD_BF16_EXACT_TOL}); kernel {ms:.3f} ms (back to back "
        f"{queued_ms:.3f}) torch.matmul {lib_ms:.3f} ms bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, ms, limit["bound_ms"]


def _upsampled_nchw(x):
    """Nearest-2x upsample of NHWC x as an NCHW view of channels-last memory,
    as a caller of F.conv2d over NHWC data keeps it."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).permute(0, 3, 1, 2)


def check_upsample(gen, shape, n_out):
    """K2 as the training step calls it, the weight fold in the call; beside
    its time, K2 with the folded weights given, as the Upsample module calls
    it when no gradient is recorded, and `F.conv2d` over the nearest-2x
    upsampled input (a yardstick for its conv part only, which does 2.25x
    the sub-pixel form's products: 9 taps a large-grid pixel against 4)."""
    c = shape[3]
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, c, n_out), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")
    w_fold = rb.fold_subpixel_weights(wt.float()).to(torch.bfloat16).contiguous()
    bsz, h, w, _ = shape
    flops = 2 * 16 * bsz * h * w * c * n_out            # four parities of four taps each
    nbytes = _nbytes(x, wt, bias) + 2 * 4 * bsz * h * w * n_out + 4 * bsz * 2 * n_out
    x_lib, w_lib = _upsampled_nchw(x), _oihw(wt)
    return _check_conv(
        f"subpixel_upsample_conv3x3_stats {shape}->{n_out}",
        lambda: rb.upsample_conv3x3_stats_cuda(x, wt, bias),
        lambda: rb.upsample_conv3x3_stats_plain(x, wt, bias),
        lambda: upsample_conv3x3_exact(x, wt, bias), flops, nbytes,
        lambda: F.conv2d(x_lib, w_lib, padding=1),
        "F.conv2d on the upsampled input (conv part only, 2.25x the products)", queued=True, part_only=True,
        variant=("folded weights given", lambda: rb.upsample_conv3x3_stats_cuda(x, wt, bias, w_fold=w_fold)),
    )


def _oihw(w):
    """HWIO -> OIHW in channels-last memory, as a caller of F.conv2d over NHWC data keeps it."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def check_downsample(gen, shape, n_out):
    """K9: conv3x3 stride 2, bottom row and right column zero-padded, + bias, with statistics."""
    bsz, h, w, c = shape
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, c, n_out), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")

    def exact():
        xp = F.pad(x.float().permute(0, 3, 1, 2), (0, 1, 0, 1))
        y = F.conv2d(xp, wt.float().permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1) + bias
        return y.to(torch.bfloat16)

    w_lib, b_lib, x_lib = _oihw(wt), bias.to(torch.bfloat16), x.permute(0, 3, 1, 2)
    h_out, w_out = h // 2, w // 2
    flops = 2 * 9 * c * bsz * h_out * w_out * n_out
    nbytes = _nbytes(x, wt, bias) + 2 * bsz * h_out * w_out * n_out + 4 * bsz * 2 * n_out
    return _check_conv(
        f"downsample_conv3x3_stats {shape}->{n_out}",
        lambda: rb.downsample_conv3x3_stats_cuda(x, wt, bias),
        lambda: rb.downsample_conv3x3_stats_plain(x, wt, bias), exact, flops, nbytes,
        # y only (no statistics): the pad is a second call, there is no asymmetric padding in conv2d
        lambda: F.conv2d(F.pad(x_lib, (0, 1, 0, 1)), w_lib, b_lib, stride=2), "F.pad + F.conv2d (y only)",
        queued=True)


def check_conv_same(gen, shape, n_out):
    """K11: bare conv3x3 SAME, no bias, no statistics."""
    bsz, h, w, c = shape
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, c, n_out), 1.0 / math.sqrt(9 * c))
    exact = lambda: F.conv2d(x.float().permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1),
                             padding=1).permute(0, 2, 3, 1).to(torch.bfloat16)
    w_lib, x_lib = _oihw(wt), x.permute(0, 3, 1, 2)
    flops = 2 * 9 * c * bsz * h * w * n_out
    nbytes = _nbytes(x, wt) + 2 * bsz * h * w * n_out
    return _check_conv(
        f"conv3x3_same {shape}->{n_out}",
        lambda: c3.conv3x3_same_cuda(x, wt), lambda: c3.conv3x3_same_plain(x, wt), exact, flops, nbytes,
        lambda: F.conv2d(x_lib, w_lib, padding=1), "F.conv2d", queued=True)


def check_fused_gn_silu_conv(gen, shape, n_out):
    """K12: silu(x*a + b) -> conv3x3 SAME -> + bias, no statistics; no one
    PyTorch call computes it."""
    bsz, h, w, c = shape
    x, a, b, wt, bias, *_ = _conv_inputs(gen, shape, n_out, None)
    flops = 2 * 9 * c * bsz * h * w * n_out
    nbytes = _nbytes(x, a, b, wt, bias) + 2 * bsz * h * w * n_out
    return _check_conv(
        f"fused_gn_silu_conv3x3 {shape}->{n_out}",
        lambda: fgc.fused_gn_silu_conv3x3_cuda(x, a, b, wt, bias),
        lambda: fgc.fused_gn_silu_conv3x3_plain(x, a, b, wt, bias),
        lambda: conv3x3_stats_exact(x, a, b, wt, bias, None, None, None, "silu")[0], flops, nbytes)


def check_int8_matmul(gen, m, k, n, dtype=torch.bfloat16, with_bias=True):
    """K10 at x (m, k) @ int8 (n, k)^T: against the plain version and the
    exact fp32 restatement; beside its time, F.linear over a resident bf16
    weight of the same shape (not the same function: twice the weight bytes)."""
    x = _randn(gen, (m, k), dtype=dtype)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    scale = (3.0 / math.sqrt(k) / 127.0) * (0.5 + torch.rand((n,), generator=gen, device="cuda"))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda") if with_bias else None
    run_k = lambda: i8.int8_matmul_cuda(x, wq, scale, bias)
    run_p = lambda: i8.int8_matmul_plain(x, wq, scale, bias)
    fp32 = dtype == torch.float32
    label = f"({m}, {k}) x ({k}, {n}) {'fp32' if fp32 else 'bf16'}{'' if with_bias else ' no bias'}"
    out = _launch_or_fail(f"int8_matmul {label}", run_k)
    plain = run_p()
    exact = x.float() @ wq.float().t() * scale + (0.0 if bias is None else bias)
    exact = exact.to(dtype).float()
    torch.cuda.synchronize()
    top = exact.abs().max().item()
    err_x = (out.float() - exact).abs().max().item()
    rel_x, rel_p = err_x / top, (out.float() - plain.float()).abs().max().item() / top
    tol_x = INT8_BF16_EXACT_TOL if dtype == torch.bfloat16 else INT8_FP32_EXACT_TOL
    ms, queued_ms, plain_ms = time_ms(run_k), time_queued_ms(run_k), time_ms(run_p)
    w_bf16 = (wq.float() * scale[:, None]).to(torch.bfloat16)
    x_bf16 = x.to(torch.bfloat16)
    b_bf16 = None if bias is None else bias.to(torch.bfloat16)
    linear = lambda: F.linear(x_bf16, w_bf16, b_bf16)
    linear_ms, linear_queued_ms = time_ms(linear), time_queued_ms(linear)
    del w_bf16
    library_ms = int8pack_mm_ms(x, wq, scale)
    limit = bound(2 * m * n * k, _nbytes(x, wq, scale, bias, out), PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    ok = (out.shape == (m, n) and out.dtype == dtype and bool(torch.isfinite(out.float()).all())
          and rel_x <= tol_x and rel_p <= INT8_PLAIN_TOL)
    log("kernels", f"int8_matmul {label}: vs exact max_abs_err={err_x:.4g} (rel {rel_x:.3g} <= {tol_x}); "
        f"vs plain rel {rel_p:.3g} (<= {INT8_PLAIN_TOL}); kernel {ms:.3f} ms (back to back {queued_ms:.3f}) "
        f"plain {plain_ms:.3f} ms bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}) {'ok' if ok else 'FAIL'}")
    log("kernels", f"int8_matmul {label}: F.linear over a resident bf16 weight (not the same function: "
        f"twice the weight bytes; what an unquantised layer pays) {linear_ms:.3f} ms (back to back "
        f"{linear_queued_ms:.3f}); K10 / F.linear {ms / linear_ms:.3f} (back to back "
        f"{queued_ms / linear_queued_ms:.3f})")
    return ok, label, err_x, ms, plain_ms, library_ms, limit


def int8pack_mm_ms(x, wq, scale):
    """The time of `torch._weight_int8pack_mm(x, wq, scale)`, PyTorch's one
    call for a weight-only int8 product (x @ wq^T * scale, without K10's bias
    add), on K10's inputs; None where the installed torch has no CUDA kernel
    for it. Its error against the exact fp32 product is printed beside it. A
    yardstick here, called nowhere in the port."""
    fn = lambda: torch._weight_int8pack_mm(x, wq, scale.to(x.dtype))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as err:
        first = str(err).strip().splitlines()[0] if str(err).strip() else type(err).__name__
        log("kernels", f"int8_matmul: torch._weight_int8pack_mm has no CUDA kernel in torch "
            f"{torch.__version__} ({first[:160]})")
        return None
    want = x.float() @ wq.float().t() * scale
    rel = (got.float() - want).abs().max().item() / want.abs().max().item()
    del want
    # a call that takes more than 10 ms (the torch 2.11 CUDA kernel takes
    # 200-550 ms at K10's large shapes on an H100) is timed once more, the
    # call above serving as its warm-up, to keep the phase inside its budget
    slow = start.elapsed_time(end) > 10.0
    ms = time_ms(fn, runs=1, warmups=0) if slow else time_ms(fn)
    log("kernels", f"int8_matmul: torch._weight_int8pack_mm (no bias) {ms:.3f} ms, vs exact rel {rel:.3g}")
    return ms


BWD_NAMES_K6 = ("dx", "da", "db", "dW", "dbias", "dskip", "dws", "dwsb")
BWD_NAMES_K7 = ("dx", "dW", "dbias")


def _check_bwd(label, names, run_k, run_p, run_x, flops, nbytes, queued=False, run_lib=None, lib_name=""):
    """Every cotangent of a backward kernel against the plain version and the
    exact reference, each relative to max|reference|; `queued`: also timed
    back to back; `run_lib`: a PyTorch call for the conv part only, timed as
    a yardstick and printed, not reported as the library's time. A launch
    that fails fails this kernel's line and the phase."""
    got = _launch_or_fail(label, run_k)
    plain, exact = run_p(), run_x()
    torch.cuda.synchronize()
    ok, worst_abs, parts = True, 0.0, []
    for name, g, p_ref, x_ref in zip(names, got, plain, exact):
        if x_ref is None:
            ok &= g is None and p_ref is None
            continue
        bf16_out = g.dtype == torch.bfloat16
        tol_x = BWD_BF16_EXACT_TOL if bf16_out else BWD_SUM_EXACT_TOL
        tol_p = BWD_BF16_PLAIN_TOL if bf16_out else BWD_SUM_PLAIN_TOL
        err_x = (g.float() - x_ref.float()).abs().max().item()
        rel_x = err_x / x_ref.float().abs().max().item()
        rel_p = (g.float() - p_ref.float()).abs().max().item() / p_ref.float().abs().max().item()
        fine = (g.shape == x_ref.shape and bool(torch.isfinite(g.float()).all())
                and rel_x <= tol_x and rel_p <= tol_p)
        ok &= fine
        worst_abs = max(worst_abs, err_x)
        parts.append(f"{name} exact {rel_x:.2g}<={tol_x} plain {rel_p:.2g}<={tol_p}"
                     f"{'' if fine else ' FAIL'}")
    ms, plain_ms = _launch_or_fail(label, lambda: (time_ms(run_k), time_ms(run_p)))
    queued_ms = _launch_or_fail(label, lambda: time_queued_ms(run_k)) if queued else None
    lib_ms = None if run_lib is None else time_ms(run_lib)
    log("kernels", f"{label}: " + "; ".join(parts) + f"; kernel {ms:.3f} ms "
        + (f"(back to back {queued_ms:.3f}) " if queued else "") + f"plain {plain_ms:.3f} ms "
        + (f"{lib_name} {lib_ms:.3f} ms " if run_lib is not None else "")
        + f"bound {bound(flops, nbytes)['bound_ms']:.4f} ms ({bound(flops, nbytes)['bound_by']}) {'ok' if ok else 'FAIL'}")
    return ok, label, worst_abs, ms, plain_ms, None, bound(flops, nbytes)


def check_conv_bwd(gen, shape, n_out, *, skip, activation, c_skip=None):
    bsz, h, w, c = shape
    x, a, b, wt, bias, sk, ws, wsb = _conv_inputs(gen, shape, n_out, skip, c_skip)
    y, _ = rb.conv3x3_stats_cuda(x, a, b, wt, bias, sk, ws, wsb, activation)
    gy = _randn(gen, y.shape)
    gstats = 0.1 * torch.randn((bsz, 2, n_out), generator=gen, device="cuda")
    args = (x, a, b, wt, bias, sk, ws, wsb, y, gy, gstats, activation)
    c_skip = 0 if ws is None else sk.shape[3]
    flops = 2 * (2 * 9 * c + 2 * c_skip) * bsz * h * w * n_out
    nbytes = (_nbytes(x, a, b, wt, y, gy, gstats, ws) + (_nbytes(sk) if ws is not None else 0)
              + _nbytes(x) + 4 * (wt.numel() + 2 * a.numel() + n_out)            # dx, dW, da, db, dbias
              + (0 if sk is None else _nbytes(sk)) + 4 * (0 if ws is None else ws.numel() + n_out))
    return _check_bwd(
        f"resnet_conv3x3_stats_bwd {shape}->{n_out} {activation} skip={skip}"
        + (f" Cs={c_skip}" if c_skip else ""), BWD_NAMES_K6,
        lambda: rb.conv3x3_stats_bwd_cuda(*args),
        lambda: rb.conv3x3_stats_bwd_plain(*args),
        lambda: conv3x3_stats_bwd_exact(*args), flops, nbytes, queued=True)


def check_upsample_bwd(gen, shape, n_out):
    """K7; beside its time, `aten.convolution_backward` of the conv over the
    upsampled input (dx on the large grid, dW, dbias: a yardstick for the
    conv part only, 2.25x the sub-pixel form's products)."""
    bsz, h, w, c = shape
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, c, n_out), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n_out,), generator=gen, device="cuda")
    y, _ = rb.upsample_conv3x3_stats_cuda(x, wt, bias)
    gy = _randn(gen, y.shape)
    gstats = 0.1 * torch.randn((bsz, 2, n_out), generator=gen, device="cuda")
    args = (x, wt, bias, y, gy, gstats)
    flops = 2 * 2 * 16 * bsz * h * w * c * n_out
    nbytes = _nbytes(x, wt, y, gy, gstats) + _nbytes(x) + 4 * (wt.numel() + n_out)
    dye_lib = _dye_exact(y, gy, gstats).to(torch.bfloat16).permute(0, 3, 1, 2)
    x_lib, w_lib = _upsampled_nchw(x), _oihw(wt)
    lib = lambda: torch.ops.aten.convolution_backward(dye_lib, x_lib, w_lib, [n_out], [1, 1], [1, 1], [1, 1], False,
                                                      [0, 0], 1, [True, True, True])
    return _check_bwd(
        f"subpixel_upsample_conv3x3_stats_bwd {shape}->{n_out}", BWD_NAMES_K7,
        lambda: rb.upsample_conv3x3_stats_bwd_cuda(*args),
        lambda: rb.upsample_conv3x3_stats_bwd_plain(*args),
        lambda: upsample_conv3x3_stats_bwd_exact(*args), flops, nbytes, queued=True, run_lib=lib,
        lib_name="aten.convolution_backward over the upsampled input (conv part only, 2.25x the products)")


def check_attention(gen, shape, seq_k=None):
    """K3 on (B, H, S, D) queries and `seq_k` keys (default S: a sequence
    parallel rank's queries against the gathered keys otherwise)."""
    bsz, heads, seq, d = shape
    seq_k = seq_k or seq
    q = _randn(gen, (bsz * heads, seq, d))
    k, v = (_randn(gen, (bsz * heads, seq_k, d)) for _ in range(2))
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
    ms, plain_ms, queued_ms = time_ms(run_k), time_ms(run_p), time_queued_ms(run_k)
    # the one PyTorch call that computes the same function: a yardstick here,
    # called nowhere in the port
    q4, k4, v4 = (t.reshape(bsz, heads, -1, d) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    limit = bound(4 * bsz * heads * seq * seq_k * d, _nbytes(q, k, v, out, lse))
    label = f"{shape}" if seq_k == seq else f"{shape} keys {seq_k}"
    ok = (rel_p <= ATTN_PLAIN_REL_TOL and rel_x <= ATTN_EXACT_REL_TOL
          and err_lse <= ATTN_LSE_ABS_TOL and bool(torch.isfinite(out.float()).all()))
    log("kernels", f"flash_attention_fwd {label}: vs plain max_abs_err={err:.4g} "
        f"(rel {rel_p:.3g} <= {ATTN_PLAIN_REL_TOL}); vs fp32 rel {rel_x:.3g} "
        f"(<= {ATTN_EXACT_REL_TOL}) lse {err_lse:.3g} (<= {ATTN_LSE_ABS_TOL}); "
        f"kernel {ms:.3f} ms (back to back {queued_ms:.3f}) plain {plain_ms:.3f} ms scaled_dot_product_attention "
        f"{library_ms:.3f} ms bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}) {'ok' if ok else 'FAIL'}")
    return ok, label, err, ms, plain_ms, library_ms, limit


def _pair_ulps(got, ref) -> float:
    """Largest |got - ref| in bf16 ulps of each element's rotated pair's length."""
    pairs = ref.float().reshape(*ref.shape[:-1], -1, 2)
    length = pairs.square().sum(dim=-1, keepdim=True).sqrt().expand_as(pairs).reshape(ref.shape)
    ulp = torch.exp2(torch.floor(torch.log2(length.clamp_min(2.0 ** -126))) - 7)
    return ((got.float() - ref.float()).abs() / ulp).max().item()


def check_attn_prologue(gen, bsz, s_img, s_txt, heads, d=128):
    """K13 forward and backward on the projection outputs of `bsz` rows of
    `s_img` image and `s_txt` text tokens (0: a single-stream block), held
    against the plain chain, and timed beside it."""
    from ragb_vae_tpu_torch.models.flux_transformer import rope_frequencies

    width = heads * d
    img = [_randn(gen, (bsz, s_img, width), 2.0) for _ in range(3)]
    txt = [_randn(gen, (bsz, s_txt, width), 2.0) for _ in range(3)] if s_txt else [None] * 3
    w = [(1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16) for _ in range(4)]
    w_txt = w[2:] if s_txt else [None, None]
    ids = torch.randint(0, 64, (s_txt + s_img, 3), generator=gen, device="cuda")
    cos, sin = rope_frequencies(ids, (16, 56, 56))
    args = (*img, *txt, *w[:2], *w_txt, cos, sin)
    kw = {"heads": heads, "eps": 1e-6}
    run_k = lambda: ap.attn_prologue_cuda(*args, **kw)
    run_p = lambda: ap.attn_prologue_plain(*args, **kw)
    got, ref = run_k(), run_p()
    fwd_ulps = max(_pair_ulps(got[0], ref[0]), _pair_ulps(got[1], ref[1]))
    same_v = torch.equal(got[2], ref[2])
    grads = [_randn(gen, tuple(got[0].shape)) for _ in range(3)]
    saved = (img[0], img[1], txt[0], txt[1], *w[:2], *w_txt, cos, sin)
    run_b = lambda: ap.attn_prologue_bwd_cuda(*grads, *saved, **kw)
    dk = [t for t in run_b() if t is not None]
    leaves = [t.float().requires_grad_() for t in [*img, *(txt if s_txt else [])]]
    t_img, t_txt = leaves[:3], leaves[3:] if s_txt else [None] * 3
    out = ap.attn_prologue_plain(*t_img, *t_txt, *[x.float() for x in w[:2]],
                                 *[None if x is None else x.float() for x in w_txt], cos, sin, **kw)
    torch.autograd.backward(out, [g.float() for g in grads])
    order = [0, 1, 2, 3, 4, 5] if s_txt else [0, 1, 2]
    bwd_rel = max((dk[i].float() - leaves[i].grad).abs().max().item() / leaves[i].grad.abs().max().item()
                  for i in order)
    torch.cuda.synchronize()
    ms, queued_ms, plain_ms = time_ms(run_k), time_queued_ms(run_k), time_ms(run_p)
    bwd_ms, bwd_queued_ms = time_ms(run_b), time_queued_ms(run_b)
    # the plain chain's backward as the model ran it: autograd through the
    # plain forward on the bf16 projections
    b_leaves = [t.detach().requires_grad_() for t in [*img, *(txt if s_txt else [])]]
    b_txt = b_leaves[3:] if s_txt else [None] * 3

    def plain_fwd_bwd():
        torch.autograd.backward(ap.attn_prologue_plain(*b_leaves[:3], *b_txt, *w[:2], *w_txt, cos, sin, **kw),
                                grads)

    plain_fb_ms = time_ms(plain_fwd_bwd)
    fwd_bytes = 2 * _nbytes(*img, *(txt if s_txt else []))
    bwd_bytes = _nbytes(*grads, img[0], img[1], *(txt[:2] if s_txt else []), *dk)
    limit, bwd_limit = bound(0, fwd_bytes), bound(0, bwd_bytes)
    ok = (fwd_ulps <= PROLOGUE_PAIR_ULPS and same_v and bwd_rel <= PROLOGUE_BWD_REL_TOL
          and all(bool(torch.isfinite(t.float()).all()) for t in [*got, *dk]))
    label = f"({bsz}, {s_img} + {s_txt} tokens, {heads} x {d})"
    log("kernels", f"attn_prologue {label}: forward vs plain {fwd_ulps:.3g} pair ulps (<= {PROLOGUE_PAIR_ULPS}), "
        f"v {'equal' if same_v else 'DIFFERS'}; backward vs fp32 autograd rel {bwd_rel:.3g} "
        f"(<= {PROLOGUE_BWD_REL_TOL}); forward {ms:.3f} ms (back to back {queued_ms:.3f}) plain {plain_ms:.3f} ms "
        f"bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}); backward {bwd_ms:.3f} ms (back to back "
        f"{bwd_queued_ms:.3f}) bound {bwd_limit['bound_ms']:.4f} ms; plain forward + autograd backward "
        f"{plain_fb_ms:.3f} ms {'ok' if ok else 'FAIL'}")
    return ok, label, fwd_ulps, ms, plain_ms, None, limit


def attention_bwd_exact(q, k, v, out, lse, g, scale, heads_per_pass=4):
    """K4's and K5's arithmetic in fp32 PyTorch with their rounding points: P
    and dS rounded to bf16 before their products, fp32 sums. A few heads at a
    time, so the (S, S) blocks of a long sequence stay small."""
    dq, dk, dv = [], [], []
    for lo in range(0, q.shape[0], heads_per_pass):
        sl = slice(lo, lo + heads_per_pass)
        qf, kf, vf, gf = (x[sl].float() for x in (q, k, v, g))
        p = torch.exp(torch.matmul(qf, kf.transpose(1, 2)) * scale - lse[sl, :, None])
        delta = (gf * out[sl].float()).sum(dim=-1, keepdim=True)
        ds = (p * (torch.matmul(gf, vf.transpose(1, 2)) - delta) * scale).to(torch.bfloat16).float()
        dq.append(torch.matmul(ds, kf))
        dk.append(torch.matmul(ds.transpose(1, 2), qf))
        dv.append(torch.matmul(p.to(torch.bfloat16).float().transpose(1, 2), gf))
    return torch.cat(dq), torch.cat(dk), torch.cat(dv)


def check_attention_bwd(gen, bh, seq_q, seq_k):
    """K4 and K5 on one set of operands -> {kernel name: result tuple}. The
    plain version and the library call compute dq, dk and dv in one pass, so
    their times stand beside both kernels. The path's own call (one ctypes
    call that launches both) runs twice and must give what the separate
    wrappers gave, bit for bit: every accumulator has one owner."""
    d = 128
    q, g = _randn(gen, (bh, seq_q, d)), _randn(gen, (bh, seq_q, d))
    k, v = _randn(gen, (bh, seq_k, d)), _randn(gen, (bh, seq_k, d))
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_attention_cuda(q, k, v, sm_scale=scale)
    delta = fa.attention_delta(out, g)
    run_dq = lambda: fa.flash_attention_dq_cuda(q, k, v, g, lse, delta, sm_scale=scale)
    run_dkv = lambda: fa.flash_attention_dkv_cuda(q, k, v, g, lse, delta, sm_scale=scale)
    run_pair = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, sm_scale=scale)
    run_p = lambda: fa.attention_bwd_plain(q, k, v, out, lse, g, sm_scale=scale)
    got = (run_dq(), *run_dkv())
    pairs = (run_pair(), run_pair())
    same = [all(torch.equal(a, p[i]) for p in pairs) for i, a in enumerate(got)]
    del pairs
    plain, exact = run_p(), attention_bwd_exact(q, k, v, out, lse, g, scale)
    torch.cuda.synchronize()
    rel_x, rel_p, err_x = [], [], []
    for a, pl, ex in zip(got, plain, exact):
        err_x.append((a.float() - ex).abs().max().item())
        rel_x.append(err_x[-1] / ex.abs().max().item())
        rel_p.append((a.float() - pl.float()).abs().max().item() / pl.float().abs().max().item())
    del exact, plain
    dq_ms, dkv_ms, plain_ms = time_ms(run_dq), time_ms(run_dkv), time_ms(run_p)
    dq_queued, dkv_queued = time_queued_ms(run_dq), time_queued_ms(run_dkv)
    pair_ms, pair_queued = time_ms(run_pair), time_queued_ms(run_pair)
    # the one PyTorch call that computes the same gradients: forward + backward
    # minus the forward, a yardstick here and called nowhere in the port
    q4, k4, v4 = (x.reshape(1, bh, -1, d).clone().requires_grad_(True) for x in (q, k, v))
    g4 = g.reshape(1, bh, seq_q, d)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        torch.autograd.grad(o, (q4, k4, v4), g4)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    library_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
    io = _nbytes(q, k, v, g, lse, delta)
    limits = {"flash_attention_dq": bound(6 * bh * seq_q * seq_k * d, io + _nbytes(q)),
              "flash_attention_dkv": bound(8 * bh * seq_q * seq_k * d, io + _nbytes(k, v))}
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    results = {}
    for name, idx, ms, queued in (("flash_attention_dq", (0,), dq_ms, dq_queued),
                                  ("flash_attention_dkv", (1, 2), dkv_ms, dkv_queued)):
        held = [rel_x[i] <= ATTN_BWD_EXACT_TOL and rel_p[i] <= ATTN_BWD_PLAIN_TOL and same[i] for i in idx]
        ok = finite and all(held)
        parts = "; ".join(
            f"{('dq', 'dk', 'dv')[i]} exact {rel_x[i]:.2g}<={ATTN_BWD_EXACT_TOL} plain {rel_p[i]:.2g}<={ATTN_BWD_PLAIN_TOL}"
            f" {'bitwise equal over two pair calls' if same[i] else 'NOT bitwise equal over two pair calls'}"
            + ("" if h else " FAIL") for i, h in zip(idx, held))
        lim = limits[name]
        log("kernels", f"{name} ({bh}, {seq_q}, {d}) keys {seq_k}: {parts}; kernel {ms:.3f} ms "
            f"(back to back {queued:.3f}) plain (dq, dk, dv together) {plain_ms:.3f} ms "
            f"scaled_dot_product_attention backward (all three) {library_ms:.3f} ms bound "
            f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}) {'ok' if ok else 'FAIL'}")
        results[name] = (ok, f"({bh}, {seq_q}, {d}) keys {seq_k}", max(err_x[i] for i in idx), ms,
                         plain_ms, library_ms, lim)
    log("kernels", f"flash_attention_bwd pair ({bh}, {seq_q}, {d}) keys {seq_k}: K4 + K5 in one call "
        f"{pair_ms:.3f} ms (back to back {pair_queued:.3f}) bound "
        f"{limits['flash_attention_dq']['bound_ms'] + limits['flash_attention_dkv']['bound_ms']:.4f} ms")
    return results


def phase_kernels() -> dict:
    gen = torch.Generator("cuda").manual_seed(SEED)
    cases = {
        # the encoder's and decoder's convs at 512^2 (batch 2, and the
        # decoder's last level at batch 4), the projections the model's fused
        # blocks run (conv2: C = N, a skip of Cin channels; the encoder sees
        # the triplet, batch 12), and a shape with every edge ragged
        "resnet_conv3x3_stats": [
            lambda: check_conv(gen, (2, 128, 128, 512), 512, skip=None, activation="silu"),
            lambda: check_conv(gen, (2, 128, 128, 512), 256, skip="proj", activation="silu"),
            lambda: check_conv(gen, (1, 64, 64, 128), 128, skip="identity", activation="identity"),
            lambda: check_conv(gen, (4, 256, 256, 256), 256, skip="proj", activation="silu", c_skip=128),
            lambda: check_conv(gen, (12, 128, 128, 512), 512, skip="proj", activation="silu", c_skip=256),
            lambda: check_conv(gen, (4, 512, 512, 128), 128, skip="identity", activation="silu"),
            lambda: check_conv(gen, (2, 37, 50, 72), 136, skip="proj", activation="silu", c_skip=40),
        ],
        # the decoder's first upsampler at 512^2 b2 and its last at b1, its
        # middle one at the training micro-batch (b4), and a shape with every
        # edge ragged (C % 64 != 0, N % 128 != 0, H, W off the 4 x 64 tile)
        "subpixel_upsample_conv3x3_stats": [
            lambda: check_upsample(gen, (2, 64, 64, 512), 512),
            lambda: check_upsample(gen, (1, 256, 256, 256), 256),
            lambda: check_upsample(gen, (4, 128, 128, 512), 512),
            lambda: check_upsample(gen, (2, 37, 50, 72), 136),
        ],
        # the 512^2 and 1024^2 requests' FLUX blocks and VAE mid-block (the
        # d = 512 kernel splits one head of 4096 keys in two and merges)
        "flash_attention_fwd": [
            lambda: check_attention(gen, (1, 24, 2560, 128)),
            lambda: check_attention(gen, (1, 24, 2600, 128)),   # ragged: 40 keys in the last tile of 128
            lambda: check_attention(gen, (1, 24, 300, 128)),    # ragged: 44 of 300 keys in it
            lambda: check_attention(gen, (1, 24, 8704, 128)),
            lambda: check_attention(gen, (1, 1, 4096, 512)),
            lambda: check_attention(gen, (1, 1, 120, 512)),     # ragged: 24 keys in the last tile of 32
            lambda: check_attention(gen, (1, 1, 16384, 512)),
            lambda: check_attention(gen, (1, 12, 2560, 128)),   # one rank's 12 heads at tensor_parallel 2
            # one rank's queries at sequence_parallel 2 against the gathered
            # keys: a 512^2 pair (512 + 2048 tokens) and a 1024^2 one (512 + 8192)
            lambda: check_attention(gen, (1, 24, 1280, 128), 2560),
            lambda: check_attention(gen, (1, 24, 4352, 128), 8704),
        ],
        # the shapes one training micro-batch of 4 at 512^2 gives them (the
        # encoder sees the triplet, batch 12; the decoder's last level runs at
        # 512^2 x 128), and a ragged one
        "resnet_conv3x3_stats_bwd": [
            lambda: check_conv_bwd(gen, (4, 128, 128, 512), 512, skip=None, activation="silu"),
            lambda: check_conv_bwd(gen, (4, 512, 512, 128), 128, skip="identity", activation="silu"),
            lambda: check_conv_bwd(gen, (4, 256, 256, 512), 256, skip="proj", activation="silu"),
            lambda: check_conv_bwd(gen, (12, 64, 64, 512), 512, skip="identity", activation="silu"),
            lambda: check_conv_bwd(gen, (1, 64, 64, 128), 128, skip="identity", activation="identity"),
            # ragged, dskip's Cs too (against its 128-channel tile and 64-channel chunk)
            lambda: check_conv_bwd(gen, (2, 37, 50, 128), 256, skip="proj", activation="silu", c_skip=40),
        ],
        "subpixel_upsample_conv3x3_stats_bwd": [
            lambda: check_upsample_bwd(gen, (4, 64, 64, 512), 512),
            lambda: check_upsample_bwd(gen, (4, 256, 256, 256), 256),
            lambda: check_upsample_bwd(gen, (1, 19, 27, 64), 128),
            lambda: check_upsample_bwd(gen, (4, 128, 128, 512), 512),
            lambda: check_upsample_bwd(gen, (2, 37, 50, 72), 136),
        ],
        # the encoder's first and last downsamplers at 512^2, and ragged ones
        # (odd height, N not a multiple of the 64-channel box; odd width)
        "downsample_conv3x3_stats": [
            lambda: check_downsample(gen, (4, 512, 512, 128), 128),
            lambda: check_downsample(gen, (2, 128, 128, 512), 512),
            lambda: check_downsample(gen, (2, 37, 50, 64), 96),
            lambda: check_downsample(gen, (1, 64, 95, 128), 200),
        ],
        # the token streams of a 512^2 request (text 512 + 2 x 1024 image
        # tokens: the single blocks' 2560, a double block's text 512 and
        # image 2048) and of a 1024^2 one, the fp32 AdaLN modulation at batch
        # 1 and 4, and the ragged ends of the path: x_embedder (K = 64) and proj_out
        # (N = 64, M = batch)
        "int8_matmul": [
            lambda: check_int8_matmul(gen, 2560, 3072, 12288),
            lambda: check_int8_matmul(gen, 2560, 15360, 3072),
            lambda: check_int8_matmul(gen, 8704, 3072, 9216, with_bias=False),
            lambda: check_int8_matmul(gen, 1, 3072, 18432, dtype=torch.float32),
            lambda: check_int8_matmul(gen, 4, 3072, 18432, dtype=torch.float32),   # batch 4: two x chunks
            lambda: check_int8_matmul(gen, 512, 3072, 3072),
            lambda: check_int8_matmul(gen, 2048, 3072, 12288),
            lambda: check_int8_matmul(gen, 300, 64, 3072),
            lambda: check_int8_matmul(gen, 2, 3072, 64, with_bias=False),
            lambda: check_int8_matmul(gen, 2, 3072, 64),
            lambda: check_int8_matmul(gen, 1001, 80, 136),      # every tile edge ragged
            # one rank's shards at tensor_parallel 2: column q / k / v, column
            # proj_mlp, the single blocks' row proj_out (K = (3072 + 12288) / 2),
            # and a double block's column AdaLN GEMV
            lambda: check_int8_matmul(gen, 2560, 3072, 1536),
            lambda: check_int8_matmul(gen, 2560, 3072, 6144),
            lambda: check_int8_matmul(gen, 2560, 7680, 3072, with_bias=False),
            lambda: check_int8_matmul(gen, 1, 3072, 9216, dtype=torch.float32),
        ],
        # the decoder's mid width and last level, ragged tiles, and C not a
        # multiple of the 64-channel K chunk
        "conv3x3_same": [
            lambda: check_conv_same(gen, (1, 128, 128, 512), 512),
            lambda: check_conv_same(gen, (2, 512, 512, 128), 128),
            lambda: check_conv_same(gen, (1, 19, 27, 64), 40),
            lambda: check_conv_same(gen, (2, 33, 70, 72), 136),
        ],
        "fused_gn_silu_conv3x3": [
            lambda: check_fused_gn_silu_conv(gen, (1, 128, 128, 512), 512),
            lambda: check_fused_gn_silu_conv(gen, (2, 512, 512, 128), 128),
            lambda: check_fused_gn_silu_conv(gen, (2, 19, 27, 64), 40),
        ],
        # K1's first row (so the two compare), the decoder's last level with an
        # identity skip, and a projection (the ae's 256 -> 512 block)
        # the serve cell's joint and single blocks (4 x 2,048 image + 512
        # text tokens), the LoRA cell's (8 rows), one TP-2 rank's 12 heads,
        # and odd token counts
        "attn_prologue": [
            lambda: check_attn_prologue(gen, 4, 2048, 512, 24),
            lambda: check_attn_prologue(gen, 4, 2560, 0, 24),
            lambda: check_attn_prologue(gen, 8, 2048, 512, 24),
            lambda: check_attn_prologue(gen, 4, 2048, 512, 12),
            lambda: check_attn_prologue(gen, 1, 77, 13, 24),
        ],
        "resnet_conv3x3_stats_wino": [
            lambda: check_wino(gen, (2, 128, 128, 512), 512, skip=None, activation="silu"),
            lambda: check_wino(gen, (1, 512, 512, 128), 128, skip="identity", activation="silu"),
            lambda: check_wino(gen, (2, 128, 128, 256), 512, skip="proj", activation="silu"),
        ],
    }

    def summarise(name, runs):
        first = runs[0]
        results[name] = {
            "shape": first[1],
            "max_abs_err": max(r[2] for r in runs),
            "ms": first[3],
            "plain_ms": first[4],
            "library_ms": first[5],
            **first[6],
        }
        return all(r[0] for r in runs)

    results, all_ok = {}, True
    for name, fns in cases.items():
        all_ok &= summarise(name, [fn() for fn in fns])
    # K6's dskip alone at the shapes a micro-batch gives it (K6's line above
    # holds it inside the whole backward)
    dskip = [check_skip_grad(gen, shape, c_skip) for shape, c_skip in DSKIP_SHAPES]
    all_ok &= all(ok for ok, _, _ in dskip) & check_skip_grad(gen, (2, 37, 50, 136), 200)[0]   # ragged Cs and N
    log("kernels", f"dskip a VAE micro-batch: {sum(ms for _, ms, _ in dskip):.3f} ms (bound "
        f"{sum(b for _, _, b in dskip):.4f} ms)")
    # K4 and K5 at the shapes a LoRA micro-batch gives them (24 heads x batch 2
    # at 512^2, batch 1 at 1024^2), ragged lengths, and Sq != Sk
    bwd_runs = [check_attention_bwd(gen, *shape) for shape in
                ((48, 2560, 2560), (24, 8704, 8704), (24, 2600, 2600), (24, 300, 300), (24, 333, 777),
                 (12, 2560, 2560),       # one rank's 12 heads of one 512^2 pair at tensor_parallel 2
                 (24, 1280, 2560), (24, 4352, 8704))]    # one rank's queries at sequence_parallel 2
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        all_ok &= summarise(name, [run[name] for run in bwd_runs])
    if not all_ok:
        raise SystemExit("[kernels] a kernel disagrees with its plain version or exact reference")
    return results


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full width
# ---------------------------------------------------------------------------
def _serve_three(phase: str, model, counters: dict, sizes=((512, 512), (512, 512), (600, 400))):
    """Three requests of `sizes` through an InferenceServer of 4 sampler
    steps; `counters` maps a kernel's name to a function that reads its launch
    count. -> (counts, peak bytes, batches)."""
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    rng = np.random.default_rng(SEED)
    images = [rng.uniform(size=(*size, 4)).astype(np.float32) for size in sizes]
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=SERVE_STEPS, auto_batch=False))
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    with server:
        t_submit = time.perf_counter()
        futures = [server.submit(img, seed=i) for i, img in enumerate(images)]
        outs, lat = [], []
        for fut in futures:
            outs.append(fut.result(timeout=900))
            lat.append(time.perf_counter() - t_submit)
        drained = server.drain(timeout=60)
    counts = {name: read() for name, read in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for img, out, t in zip(images, outs, lat):
        if out.shape != img.shape:
            raise SystemExit(f"[{phase}] output shape {out.shape} != request shape {img.shape}")
        if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
            raise SystemExit(f"[{phase}] output not finite or outside [0, 1]")
        log(phase, f"request {img.shape[0]}x{img.shape[1]}: latency {t:.3f} s, "
            f"out range [{out.min():.3f}, {out.max():.3f}] mean {out.mean():.4f}")
    log(phase, f"server stats {server.stats} drained={drained}")
    log(phase, f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    if not all(n > 0 for n in counts.values()):
        raise SystemExit(f"[{phase}] a kernel of the path never launched: {counts}")
    return counts, peak, server.stats["batches"]


def _serve_three_http(phase: str, model, counters: dict, sizes=((512, 512), (512, 512), (600, 400))):
    """`_serve_three` through the serving daemon: the three requests, seeds
    0-2, are sent at once as uint8 PNGs to `/predict` of the daemon's own HTTP
    server (`serving_daemon.make_httpd`, 127.0.0.1, a free port) over an
    InferenceServer of 4 sampler steps; `/healthz` is read before and after;
    the daemon is shut down and drained before the checks.
    -> (counts, peak bytes, batches)."""
    import io
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from ragb_vae_tpu_torch import serving_daemon
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr, "RGBA").save(buf, format="PNG")
        return buf.getvalue()

    def call(url, data=None):
        """-> (status, body, seconds) of a GET (no data) or POST."""
        t = time.perf_counter()
        req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=900) as resp:
                return resp.status, resp.read(), time.perf_counter() - t
        except urllib.error.HTTPError as err:
            return err.code, err.read(), time.perf_counter() - t

    rng = np.random.default_rng(SEED)
    images = [(rng.uniform(size=(*size, 4)) * 255.0 + 0.5).astype(np.uint8) for size in sizes]
    bodies = [png(img) for img in images]
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=SERVE_STEPS, auto_batch=False)).start()
    httpd = serving_daemon.make_httpd(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    # a short poll: shutdown() waits for the serving loop's next poll
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                              name="chip-smoke-httpd", daemon=True)
    thread.start()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    try:
        before = call(f"{base}/healthz")
        with ThreadPoolExecutor(len(bodies)) as pool:
            answers = list(pool.map(lambda i: call(f"{base}/predict?seed={i}", bodies[i]), range(len(bodies))))
        after = call(f"{base}/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        drained = server.drain(timeout=60)
    counts = {name: read() for name, read in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if thread.is_alive() or not drained:
        raise SystemExit(f"[{phase}] the daemon did not shut down and drain (drained={drained})")
    health = [json.loads(b) if code == 200 else {"status": code} for code, b, _ in (before, after)]
    for img, (code, body, t) in zip(images, answers):
        if code != 200:
            raise SystemExit(f"[{phase}] request {img.shape[0]}x{img.shape[1]} failed: {code} {body[:300]!r}")
        got = Image.open(io.BytesIO(body))
        if got.mode != "RGBA" or got.size != (img.shape[1], img.shape[0]):
            raise SystemExit(f"[{phase}] answer {got.mode} {got.size} for a {img.shape[1]}x{img.shape[0]} request")
        out = np.asarray(got, np.float32) / 255.0
        if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
            raise SystemExit(f"[{phase}] output not finite or outside [0, 1]")
        log(phase, f"request {img.shape[0]}x{img.shape[1]} over HTTP: client latency {t:.3f} s, "
            f"{len(body)} B PNG, out range [{out.min():.3f}, {out.max():.3f}] mean {out.mean():.4f}")
    log(phase, f"/healthz before {health[0]}")
    log(phase, f"/healthz after {health[1]} drained={drained}")
    log(phase, f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    if health[0].get("served") != 0 or health[1].get("served") != len(images):
        raise SystemExit(f"[{phase}] /healthz served {health[0].get('served')} -> {health[1].get('served')}, "
                         f"expected 0 -> {len(images)}")
    if not all(n > 0 for n in counts.values()):
        raise SystemExit(f"[{phase}] a kernel of the path never launched: {counts}")
    return counts, peak, health[1]["batches"]


def phase_slice(refs: dict):
    """-> (launch counts, the model, for the later phases to train and to
    quantise, its peak memory). Into `refs`, on the host, for the tp phase:
    one 512^2 request's float answer through the serving program, one bf16
    transformer forward (`_probe_forward`) and the memory it held."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

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

    resident = torch.cuda.memory_allocated()
    counts, peak, _ = _serve_three_http("slice", model, {
        "resnet_conv3x3_stats": lambda: rb.CONV_LAUNCHES,
        "subpixel_upsample_conv3x3_stats": lambda: rb.UPSAMPLE_LAUNCHES,
        "flash_attention_fwd": lambda: fa.LAUNCHES,
        "attn_prologue": lambda: ap.LAUNCHES,
    })
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    from ragb_vae_tpu_torch.ops.flops import textalpha_sample_flops

    image = _tp_request()
    with torch.inference_mode():
        t = time.perf_counter()
        refs["answer"] = InferenceServer(model, ServeConfig(steps=SERVE_STEPS))._run_batch(
            image[None], np.array([TP_SEED], np.uint32))[0]      # host arrays back: synchronised
        seconds = time.perf_counter() - t
    log_tflops("slice", f"one 512^2 request, {SERVE_STEPS} sampler steps, b1, through the serving program",
               textalpha_sample_flops(model.transformer_config, vae_cfg, 512, SERVE_STEPS,
                                      model.prompt_embeds.shape[1]), seconds)
    refs["forward"] = _probe_forward(model, SEED + 4).cpu()
    refs["peak"], refs["resident"] = peak, resident
    return counts, model, peak


# ---------------------------------------------------------------------------
# phase 5: the RGBA-VAE training step at full width
# ---------------------------------------------------------------------------
# The whole backward through the kernels, held against two references on the
# same weights, batch and noise: the plain route in bf16 (fused=False: cuDNN
# convs and PyTorch autograd) and the plain route in fp32. The bf16 routes
# round at different places (the plain route rounds GroupNorm's output,
# SiLU's output and every conv's output to bf16, the kernels keep them in
# fp32 up to one rounding), so each leaf's gradient carries accumulated bf16
# noise, largest in the encoder's first block, which sits below ~60 convs. On
# an H100 the worst leaf reads 0.12 (cosine 0.994) for the kernels against
# fp32 and 0.14 (0.991) for the plain bf16 route against fp32, so the bounds
# leave that noise half again as much room. A wrong cotangent (a missing skip
# gradient, a transposed weight gradient) moves the leaves below it by the
# size of the gradient itself: relative error ~1, cosine near 0.
GRAD_REL_TOL = 0.2             # worst leaf's ||g_kernel - g_ref|| / ||g_ref||, each reference
GRAD_COS_TOL = 0.98            # worst leaf's cosine, each reference


def worst_leaf(phase, named, got, want):
    """Over the leaves of two gradient trees (flattened fp64 vectors): the
    largest ||a - b|| / ||b|| and the smallest cosine, each with its leaf's name."""
    rel, cos = (0.0, ""), (1.0, "")
    for (name, _), a, b in zip(named, got, want):
        r = ((a - b).norm() / b.norm()).item()
        c = (torch.dot(a, b) / (a.norm() * b.norm())).item()
        if not (math.isfinite(r) and math.isfinite(c)):
            raise SystemExit(f"[{phase}] gradient of {name} is zero or not finite on one route")
        rel, cos = max(rel, (r, name)), min(cos, (c, name))
    return rel, cos


def train_objects(remat, seed=SEED):
    """The flux-`ae`-width RGBA VAE with fp32 parameters and bf16 compute, its
    frozen reference (bf16 copy of the initial weights), the perceptual term
    over seeded VGG16 weights, and the step configuration of
    configs/flux_vae.yaml."""
    from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
    from ragb_vae_tpu_torch.models.lpips import make_perceptual_loss, random_lpips
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.training.vae_step import VaeStepConfig

    cfg = AutoencoderConfig.flux()
    cfg.in_channels = cfg.out_channels = 4
    torch.manual_seed(seed)
    model = RgbaVAE(cfg, dtype=torch.float32, compute_dtype=torch.bfloat16, fused=True,
                    remat=remat, device="cuda")
    ref = RgbaVAE(cfg, dtype=torch.bfloat16, fused=True, device="cuda")
    ref.module.load_state_dict(model.module.state_dict())
    ref.module.requires_grad_(False)
    lpips_fn = make_perceptual_loss(random_lpips(seed, device="cuda"), compute_dtype=torch.bfloat16)
    loss_cfg = AlphaVaeLossConfig(reduce_mean=True, use_lpips=True)
    step_cfg = VaeStepConfig(kl_scale=1e-6, ref_kl_scale=1e-16, lpips_scale=0.5,
                             gradient_accumulation_steps=2)
    return model, ref, lpips_fn, loss_cfg, step_cfg


def _bwd_counts() -> dict:
    return {
        "resnet_conv3x3_stats": rb.CONV_LAUNCHES,
        "subpixel_upsample_conv3x3_stats": rb.UPSAMPLE_LAUNCHES,
        "flash_attention_fwd": fa.LAUNCHES,
        "resnet_conv3x3_stats_bwd": rb.CONV_BWD_LAUNCHES,
        "subpixel_upsample_conv3x3_stats_bwd": rb.UPSAMPLE_BWD_LAUNCHES,
    }


def _grad_tree_check(model, ref, lpips_fn, loss_cfg, step_cfg) -> None:
    """One microbatch's gradient tree through the kernels and through the
    plain route, leaf by leaf."""
    from ragb_vae_tpu_torch.models import vae as vae_module
    from ragb_vae_tpu_torch.training.vae_step import vae_loss_fn

    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    batch = {"images": torch.rand((2, 128, 128, 4), generator=gen, device="cuda")}
    eps = torch.randn((2, 16, 16, model.config.latent_channels), generator=gen, device="cuda")
    # the key bias is left out: a constant added to every key changes no
    # softmax, so its true gradient is zero and both routes hold only noise
    named = [(n, p) for n, p in model.module.named_parameters()
             if p.requires_grad and not n.endswith("to_k.bias")]

    def grads(fused: bool, dtype: torch.dtype):
        model.module.set_fused(fused)
        model.set_compute_dtype(dtype)
        for _, p in named:
            p.grad = None
        loss, _ = vae_loss_fn(model, batch, loss_cfg=loss_cfg, step_cfg=step_cfg, ref_model=ref,
                              lpips_fn=lpips_fn, eps=eps)
        loss.backward()
        return loss.item(), [p.grad.detach().double().flatten() for _, p in named]

    def attention_fp32(q, k, v):
        # the fp32 reference's mid-block attention: the kernel takes bf16 only
        b, h, s, d = q.shape
        out = fa.attention_plain(q.reshape(b * h, s, d), k.reshape(b * h, s, d), v.reshape(b * h, s, d),
                                 sm_scale=1.0 / math.sqrt(d))
        return out.reshape(b, h, s, d)

    try:
        loss_k, g_k = grads(True, torch.bfloat16)
        loss_p, g_p = grads(False, torch.bfloat16)
        vae_module.attention = attention_fp32
        loss_f, g_f = grads(False, torch.float32)
    finally:
        vae_module.attention = fa.attention
        model.module.set_fused(True)
        model.set_compute_dtype(torch.bfloat16)
    torch.cuda.synchronize()

    ok = True
    log("train", f"gradient tree at 128^2 micro-batch 2, {len(named)} leaves: loss kernels "
        f"{loss_k:.6f}, plain bf16 {loss_p:.6f}, plain fp32 {loss_f:.6f}")
    for label, got, want, held in (("kernels vs plain bf16", g_k, g_p, True),
                                   ("kernels vs plain fp32", g_k, g_f, True),
                                   ("plain bf16 vs plain fp32", g_p, g_f, False)):
        rel, cos = worst_leaf("train", named, got, want)
        fine = not held or (rel[0] <= GRAD_REL_TOL and cos[0] >= GRAD_COS_TOL)
        ok &= fine
        bounds = f" (<= {GRAD_REL_TOL}, >= {GRAD_COS_TOL})" if held else " (for information)"
        log("train", f"  {label}: worst relative error {rel[0]:.4f} ({rel[1]}), worst cosine "
            f"{cos[0]:.5f} ({cos[1]}){bounds} {'ok' if fine else 'FAIL'}")
    if not ok:
        raise SystemExit("[train] the kernels' gradient tree disagrees with the plain route's")


def phase_train() -> dict:
    from ragb_vae_tpu_torch.training.vae_step import (
        init_train_state, make_eval_step, make_optimizer, make_train_step, trainable_parameters)

    t0 = time.perf_counter()
    model, ref, lpips_fn, loss_cfg, step_cfg = train_objects("half")
    params = trainable_parameters(model)
    optimizer = make_optimizer(params, 1e-5, max_grad_norm=1.0)
    init_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer, loss_cfg, step_cfg, ref_model=ref, lpips_fn=lpips_fn)
    eval_step = make_eval_step(model)
    torch.cuda.synchronize()
    log("train", f"built RGBA VAE ({sum(p.numel() for p in params) / 1e6:.1f} M params, fp32) + bf16 "
        f"reference + LPIPS in {time.perf_counter() - t0:.1f} s; remat=half, 8 images per step in "
        f"2 micro-batches of 4 at 512^2")

    gen = torch.Generator("cuda").manual_seed(SEED)
    before = [p.detach().clone() for p in params]
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    for i in range(TRAIN_STEPS):
        batch = {"images": torch.rand((8, 512, 512, 4), generator=gen, device="cuda")}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = train_step(batch, generator=gen)
        end.record()
        end.synchronize()
        values = {k: v.item() for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise SystemExit(f"[train] step {i}: a loss or metric is not finite: {values}")
        bad = [n for n, p in model.module.named_parameters()
               if p.requires_grad and (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
        if bad or not values["train/grad_norm"] > 0.0:
            raise SystemExit(f"[train] step {i}: missing or non-finite gradients {bad[:5]}, "
                             f"grad norm {values['train/grad_norm']}")
        log("train", f"step {i}: " + " ".join(f"{k.split('/')[1]}={v:.6g}" for k, v in values.items())
            + f"; {start.elapsed_time(end):.1f} ms")
    from ragb_vae_tpu_torch.ops.flops import vae_train_step_flops

    log_tflops("train", f"step {TRAIN_STEPS - 1} (the phase's first and only: first-call costs included), "
               "8 images at 512^2", 8 * vae_train_step_flops(model.config, 512, lpips=True),
               start.elapsed_time(end) / 1e3)
    images = torch.rand((4, 512, 512, 4), generator=gen, device="cuda")
    out = eval_step(images, generator=gen)
    torch.cuda.synchronize()
    counts = _bwd_counts()
    peak = torch.cuda.max_memory_allocated()
    ev = {k: v.float().mean().item() for k, v in out.items() if k != "recon"}
    if out["recon"].shape != images.shape or not all(math.isfinite(v) for v in ev.values()):
        raise SystemExit(f"[train] eval step: wrong shape or non-finite metrics {ev}")
    unchanged = sum(int(torch.equal(a, p.detach())) for a, p in zip(before, params))
    log("train", f"eval: " + " ".join(f"{k}={v:.4f}" for k, v in ev.items())
        + f"; peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    if unchanged:
        raise SystemExit(f"[train] {unchanged} of {len(params)} parameters did not change in {TRAIN_STEPS} steps")
    if not all(n > 0 for n in counts.values()):
        raise SystemExit(f"[train] a kernel of the path never launched: {counts}")
    del before, optimizer, train_step
    _grad_tree_check(model, ref, lpips_fn, loss_cfg, step_cfg)
    del model, ref, lpips_fn
    torch.cuda.empty_cache()
    _offload_check()
    return counts


# The optimizer offload: two ZeRO-2 steps with the moments in pinned host
# memory against two ClippedAdamW steps from the same start. The gradients
# are the same computation on both routes; the routes differ in the global
# norm's summation order (one flat buffer against a norm of norms), which
# moves the clip scale by ~1e-7 relative, and AdamW is elementwise. Each
# parameter tensor is held as the CPU tests hold world 2 against world 1:
# mean error within OFFLOAD_RTOL of its largest entry plus 1e-3 of one
# update (lr), no entry beyond one update.
OFFLOAD_RTOL = 1e-5
OFFLOAD_LR = 1e-4


def _offload_check() -> None:
    from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.parallel.mesh import Mesh
    from ragb_vae_tpu_torch.training.vae_step import (
        VaeStepConfig, init_train_state, make_optimizer, make_train_step, trainable_parameters)

    cfg = AutoencoderConfig.flux()
    cfg.in_channels = cfg.out_channels = 4
    torch.manual_seed(SEED + 11)
    model = RgbaVAE(cfg, dtype=torch.float32, compute_dtype=torch.bfloat16, fused=True, remat="half",
                    device="cuda")
    start = {k: v.detach().cpu() for k, v in model.module.state_dict().items()}
    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    batches = [({"images": torch.rand((2, 128, 128, 4), generator=gen, device="cuda")},
                torch.randn((2, 16, 16, cfg.latent_channels), generator=gen, device="cuda")) for _ in range(2)]
    routes = {}
    for label, mesh, offload in (("ClippedAdamW", None, False), ("ZeRO-2", Mesh(), False),
                                 ("ZeRO-2 offload", Mesh(), True)):
        model.module.load_state_dict(start)
        optimizer = make_optimizer(trainable_parameters(model), OFFLOAD_LR, max_grad_norm=1.0)
        state = init_train_state(model, optimizer, mesh=mesh, offload=offload)
        step = make_train_step(model, optimizer if mesh is None else state, AlphaVaeLossConfig(reduce_mean=True),
                               VaeStepConfig(kl_scale=1e-6), mesh=mesh, offload_opt_state=offload)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pinned = []
        for batch, eps in batches:
            metrics = step(batch, eps=eps)
            torch.cuda.synchronize()
            if mesh is not None:
                pinned.append(all(t.device.type == "cpu" and t.is_pinned() for t in state.moments().values()))
        peak, resident = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        routes[label] = {"params": {k: v.detach().cpu() for k, v in model.module.state_dict().items()},
                         "loss": metrics["train/loss"].item(), "pinned": pinned, "peak": peak, "resident": resident}
        del optimizer, state, step
        torch.cuda.empty_cache()
    want = routes["ClippedAdamW"]
    worst = (0.0, "")
    for k, w in want["params"].items():
        err = (routes["ZeRO-2 offload"]["params"][k].double() - w.double()).abs()
        ratio = max(err.mean().item() / (OFFLOAD_RTOL * w.abs().max().item() + 1e-3 * OFFLOAD_LR),
                    err.max().item() / OFFLOAD_LR)
        worst = max(worst, (ratio, k))
    on, off = routes["ZeRO-2 offload"], routes["ZeRO-2"]
    log("train", f"offload at full ae width ({sum(v.numel() for v in start.values()) / 1e6:.1f} M params), 2 steps "
        f"of 2 images at 128^2: losses ClippedAdamW {want['loss']:.6f}, ZeRO-2 {off['loss']:.6f}, ZeRO-2 offload "
        f"{on['loss']:.6f}; worst parameter against ClippedAdamW {worst[0]:.3g} x its bound ({worst[1]}; mean "
        f"error <= {OFFLOAD_RTOL} of the largest entry + 1e-3 lr, max <= lr); moments pinned on the host between "
        f"steps {on['pinned']}")
    log("train", f"device memory, ZeRO-2 without / with offload: peak {off['peak'] / 2**30:.3f} / "
        f"{on['peak'] / 2**30:.3f} GiB, resident after the step {off['resident'] / 2**30:.3f} / "
        f"{on['resident'] / 2**30:.3f} GiB (moments 2 x {sum(v.numel() for v in start.values()) * 4 / 2**30:.3f} GiB)")
    if worst[0] > 1.0 or not (all(on["pinned"]) and on["pinned"]) or any(off["pinned"]):
        raise SystemExit("[train] the offloaded ZeRO-2 steps disagree with ClippedAdamW's, or the moments were "
                         "not in pinned host memory between steps")


# ---------------------------------------------------------------------------
# phase 6: the LoRA stage at full width
# ---------------------------------------------------------------------------
# The adapters' whole gradient tree through K3 + K4 + K5, held against the
# same step with the attention forced to its plain route (plain forward under
# PyTorch autograd), same weights, latents, noise and timestep. Both routes
# compute in bf16 and differ only inside the attention: the kernels round P and
# dS once, the plain route rounds the logits, the probabilities and every
# intermediate cotangent. That difference passes through up to 57 blocks of
# bf16 residual stream on the way down, so a leaf's gradient carries
# accumulated rounding noise; a third route (the plain attention computed in
# fp32 from the same bf16 q, k, v) shows how large that noise is between two
# plain routes. On an H100 the worst leaf reads 0.009 (cosine 0.99996) on all
# three comparisons, so the bounds leave that noise five times its size. A
# wrong cotangent (dQ and dK swapped, a missing scale) moves every leaf below
# the first attention by the size of the gradient itself: relative error ~1,
# cosine near 0.
LORA_GRAD_REL_TOL = 0.05       # worst leaf's ||g_kernel - g_plain|| / ||g_plain||
LORA_GRAD_COS_TOL = 0.995      # worst leaf's cosine
LORA_CONFIG = {                # configs/flux_kontext_textalpha_lora.yaml
    "mixed_precision": "bf16", "learning_rate": 3e-5, "weight_decay": 0.01,
    "adam_beta1": 0.9, "adam_beta2": 0.95, "rank": 128, "lora_alpha": 192,
    "max_grad_norm": 1.0, "seed": 1337,
}
BLOCKS = 19 + 38               # attention calls per transformer forward
TRAIN_STEPS = 1                # optimizer steps of the VAE phase (the stage1 phase takes 3 more)
STAGE_STEPS, STAGE_PAIRS, STAGE_MICRO = 2, 4, 2     # of the LoRA and the QLoRA phase: steps, pairs per step, micro-batches
LORA_PAIRS = 2                 # the LoRA phase's pairs per step (the QLoRA phase's probe loss needs 4 to fall)
ALL_PHASES = ("kernels", "slice", "pp", "lora", "int8", "tp", "axes", "convs", "train", "stage1", "textenc",
              "weights")


def _lora_counts() -> dict:
    return {
        "resnet_conv3x3_stats": rb.CONV_LAUNCHES,
        "flash_attention_fwd": fa.LAUNCHES,
        "flash_attention_dq": fa.DQ_LAUNCHES,
        "flash_attention_dkv": fa.DKV_LAUNCHES,
    }


class _GradRecord:
    """Wraps `ZeroAdamW.step` for a `with` block: before each step reduces
    and frees the gradients, notes which of its parameters have none or a
    non-finite one (the stage's optimizer lives inside `train_from_config`)."""

    def __enter__(self):
        from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW

        self.cls, self.real, self.bad = ZeroAdamW, ZeroAdamW.step, []
        record = self

        def step(opt, *args, **kwargs):
            record.bad.append({id(p) for p in opt.params
                               if p.grad is None or not bool(torch.isfinite(p.grad).all())})
            return record.real(opt, *args, **kwargs)

        ZeroAdamW.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.real

    def without_gradient(self, named) -> list:
        return [n for n, p in named.items() if not self.bad or id(p) in self.bad[-1]]


def _write_pair_tree(root: Path, n: int, size: int) -> None:
    """n (gt, text_alpha) RGBA PNG pairs of size^2 in one bucket, from a seed."""
    from PIL import Image

    rng = np.random.default_rng(SEED)
    bucket = root / "train" / f"w{size}-h{size}"
    for kind in ("gt", "text_alpha"):
        (bucket / kind).mkdir(parents=True)
        for i in range(n):
            # smooth colour fields with a soft alpha: PNGs of noise would not compress
            low = rng.uniform(size=(8, 8, 4)).astype(np.float32)
            img = Image.fromarray((low * 255).astype(np.uint8), mode="RGBA").resize((size, size), resample=3)
            img.save(bucket / kind / f"pair{i:02d}.png")


def _adapter_grad_routes(model, attr: str, routes, seed: int, after_route=None):
    """The adapters' gradient tree of one loss at 256^2, batch 1, once per
    route: each `fn` of `routes` ((label, fn) pairs) stands in for
    `flux_transformer.<attr>` while its route runs; same weights, latents,
    noise and timestep. -> (named adapter leaves, {label: (loss, gradients)})."""
    from ragb_vae_tpu_torch.models import flux_transformer as ft
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters

    named = list(lora_parameters(model.transformer).items())
    gen = torch.Generator("cuda").manual_seed(seed)
    lat = (1, 32, 32, model.vae.config.latent_channels)   # 256^2
    cond, target, noise = (torch.randn(lat, generator=gen, device="cuda") for _ in range(3))
    u = torch.full((1,), 0.5, device="cuda")
    original = getattr(ft, attr)
    out = {}
    for label, fn in routes:
        setattr(ft, attr, fn)
        try:
            for _, p in named:
                p.grad = None
            loss, _ = model.compute_loss_from_latents(cond, target, noise, u)
            loss.backward()
        finally:
            setattr(ft, attr, original)
        out[label] = (loss.item(), [p.grad.detach().double().flatten() for _, p in named])
        if after_route is not None:
            after_route(label)
    torch.cuda.synchronize()
    return named, out


def _hold_grad_routes(phase, named, out, comparisons, rel_tol, cos_tol) -> bool:
    """Log the worst leaf of each (got, want, held) comparison between routes;
    -> whether every held one is inside the bounds."""
    ok = True
    for got, want, held in comparisons:
        rel, cos = worst_leaf(phase, named, out[got][1], out[want][1])
        fine = not held or (rel[0] <= rel_tol and cos[0] >= cos_tol)
        ok &= fine
        bounds = f" (<= {rel_tol}, >= {cos_tol})" if held else " (for information)"
        log(phase, f"  {got} vs {want}: worst relative error {rel[0]:.4f} ({rel[1]}), worst cosine "
            f"{cos[0]:.5f} ({cos[1]}){bounds} {'ok' if fine else 'FAIL'}")
    return ok


def _lora_grad_tree_check(model) -> None:
    def plain_route(compute_dtype):
        def attention(q, k, v, seq=None, segments=None):      # the phase runs no sequence axis
            b, h, s, d = q.shape
            out = fa.attention_plain(*(x.reshape(b * h, s, d).to(compute_dtype) for x in (q, k, v)),
                                     sm_scale=1.0 / math.sqrt(d))
            return out.to(q.dtype).reshape(b, h, s, d)
        return attention

    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)

    def after_route(label):
        # the kernel route runs first: K4 and K5 once per block there, never on a plain route
        if (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) != (before[0] + BLOCKS, before[1] + BLOCKS):
            raise SystemExit(f"[lora] after the route {label!r}: K4 and K5 must have launched once per block "
                             "on the kernel route and never on a plain one")

    named, out = _adapter_grad_routes(
        model, "attention",
        [("kernels", fa.attention), ("plain bf16 attention", plain_route(torch.bfloat16)),
         ("plain fp32 attention", plain_route(torch.float32))], SEED + 2, after_route)
    log("lora", f"adapter gradient tree at 256^2 batch 1, {len(named)} leaves: "
        + ", ".join(f"loss {label} {loss:.6f}" for label, (loss, _) in out.items()))
    if not _hold_grad_routes("lora", named, out, (("kernels", "plain bf16 attention", True),
                                                  ("kernels", "plain fp32 attention", True),
                                                  ("plain bf16 attention", "plain fp32 attention", False)),
                             LORA_GRAD_REL_TOL, LORA_GRAD_COS_TOL):
        raise SystemExit("[lora] the kernels' adapter gradients disagree with the plain route's")

    # the attention prologue (K13) against the plain chain it replaced, with
    # autograd through it (which rounds RoPE's cotangent to bf16 where K13
    # keeps fp32)
    def plain_prologue(img, weights, rope, *, heads, eps, txt=None, txt_weights=None):
        return ap.attn_prologue_plain(*img, *(txt or (None,) * 3), *weights, *(txt_weights or (None, None)),
                                      *rope, heads=heads, eps=eps)

    before_bwd = ap.BWD_LAUNCHES

    def after_prologue_route(label):
        if ap.BWD_LAUNCHES != before_bwd + BLOCKS:
            raise SystemExit(f"[lora] after the route {label!r}: K13's backward must have launched once per "
                             "block on the kernel route and never on the plain one")

    named, out = _adapter_grad_routes(
        model, "attn_prologue", [("K13", ap.attn_prologue), ("plain prologue chain", plain_prologue)], SEED + 2,
        after_prologue_route)
    if not _hold_grad_routes("lora", named, out, (("K13", "plain prologue chain", True),),
                             LORA_GRAD_REL_TOL, LORA_GRAD_COS_TOL):
        raise SystemExit("[lora] the adapter gradients through K13 disagree with the plain prologue chain's")


def _stage_config(data_root: Path, ckpt_dir: Path, pairs: int = STAGE_PAIRS, **training) -> dict:
    """The LoRA stage's configuration for `train_from_config` over the PNG tree at `data_root`."""
    return {
        "model": {"pretrained_model_name_or_path": f"random weights, seed {SEED}",
                  "rgba_vae_path": f"random weights, seed {SEED}"},
        "data": {"root": str(data_root), "batch_size": pairs, "num_workers": 4},
        "training": {**LORA_CONFIG, **training, "max_train_steps": STAGE_STEPS, "grad_accum_steps": STAGE_MICRO,
                     "log_every": 1, "ckpt_every_steps": 1000, "val_every_steps": 1000, "ckpt_dir": str(ckpt_dir)},
    }


def phase_lora(model, work: Path) -> dict:
    """`work` holds the PNG tree (`data`) and takes this phase's checkpoints."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters, lora_state
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import train_from_config

    t0 = time.perf_counter()
    model.lora_rank, model.lora_alpha = LORA_CONFIG["rank"], float(LORA_CONFIG["lora_alpha"])
    gen = torch.Generator("cuda").manual_seed(SEED)
    model.init_lora(gen)
    lora = lora_parameters(model.transformer)
    with torch.no_grad():
        # B starts at zero in training proper; drawn non-zero here so that A
        # has a gradient from the first step
        for name, p in lora.items():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.01, generator=gen)
    base = [(n, p) for n, p in model.transformer.named_parameters() if not p.requires_grad]
    if any(p.dtype != torch.float32 for p in lora.values()) or any(p.requires_grad for _, p in base):
        raise SystemExit("[lora] adapters must be fp32 and the base frozen")

    def checksums(params):
        return [(p.detach().double().sum().item(), p.detach().double().square().sum().item())
                for _, p in params]

    base_before = checksums(base)
    lora_before = {n: p.detach().clone() for n, p in lora.items()}
    log("lora", f"attached rank-{model.lora_rank} adapters ({sum(p.numel() for p in lora.values()) / 1e6:.1f} M "
        f"fp32 parameters on {len(lora) // 2} linears) to the frozen bf16 base in "
        f"{time.perf_counter() - t0:.1f} s; recompute={model.transformer.remat}")

    steps, pairs, n_micro = STAGE_STEPS, LORA_PAIRS, STAGE_MICRO
    marks, logged = [], []

    def log_fn(step, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        logged.append(metrics)

    ckpt = work / "ckpt_lora"
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    marks.append(time.perf_counter())
    with _GradRecord() as grads:
        result = train_from_config(_stage_config(work / "data", ckpt, LORA_PAIRS), model=model, log_fn=log_fn)
    torch.cuda.synchronize()
    counts = _lora_counts()
    peak = torch.cuda.max_memory_allocated()

    for i, metrics in enumerate(logged):
        log("lora", f"step {i}: loss={metrics['train/loss']:.6f} grad_norm={metrics['train/grad_norm']:.4f} "
            f"lr={metrics['lr']:.3g}; {1e3 * (marks[i + 1] - marks[i]):.1f} ms (wall, with data"
            f"{' and start-up' if i == 0 else ''})")
    if len(logged) != steps or result["global_step"] != steps:
        raise SystemExit(f"[lora] {len(logged)} steps logged, {result['global_step']} taken, {steps} asked")
    if not all(math.isfinite(m["train/loss"]) and m["train/grad_norm"] > 0.0 for m in logged):
        raise SystemExit(f"[lora] a loss is not finite or a gradient norm is zero: {logged}")
    bad = grads.without_gradient(lora)
    if bad:
        raise SystemExit(f"[lora] adapters without a finite gradient: {bad[:5]}")
    still = [n for n, p in lora.items() if n.endswith("lora_B") and torch.equal(p.detach(), lora_before[n])]
    moved_base = [n for (n, _), a, b in zip(base, base_before, checksums(base)) if a != b]
    if still or moved_base:
        raise SystemExit(f"[lora] lora_B that did not move: {still[:5]}; base parameters that did: {moved_base[:5]}")

    # the inference CLI's reading of the final save's metadata.json, over its default flags
    from ragb_vae_tpu_torch.inference import apply_lora_metadata, parse_args

    cli = parse_args(["--pretrained_model_name_or_path", "-", "--rgba_vae_path", "-", "--input_image", "-",
                      "--output_path", "-", "--lora_path", str(ckpt / "final")])
    flags = (cli.rank, cli.lora_alpha)
    apply_lora_metadata(cli)
    log("lora", f"the inference CLI reads rank {cli.rank} and alpha {cli.lora_alpha} from final/metadata.json "
        f"over its flags' {flags}")
    if (cli.rank, cli.lora_alpha) != (LORA_CONFIG["rank"], LORA_CONFIG["lora_alpha"]):
        raise SystemExit(f"[lora] the CLI read ({cli.rank}, {cli.lora_alpha}) from the metadata, not "
                         f"({LORA_CONFIG['rank']}, {LORA_CONFIG['lora_alpha']})")

    # the final save, read back into zeroed adapters
    trained = lora_state(model.transformer)
    with torch.no_grad():
        for p in lora.values():
            p.zero_()
    model.load_lora(ckpt / "final")
    reloaded = lora_state(model.transformer)
    if not all(torch.equal(trained[n], reloaded[n]) for n in trained):
        raise SystemExit("[lora] the reloaded adapters differ from the trained ones")
    del lora_before

    from ragb_vae_tpu_torch.ops.flops import lora_train_step_flops

    log_tflops("lora", f"step {steps - 1} ({pairs} pairs at 512^2 in {n_micro} micro-batches; wall clock, data "
               "included)", pairs * lora_train_step_flops(model.transformer_config, 2 * (512 // 16) ** 2,
                                                          model.prompt_embeds.shape[1]),
               marks[steps] - marks[steps - 1])
    micro = steps * n_micro
    log("lora", f"{steps} steps of {pairs} pairs at 512^2 in {n_micro} micro-batches; final loss {result['train/loss']:.6f}; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}; adapters saved and reloaded bit for bit; "
        f"{len(base)} base parameters unchanged")
    if counts["flash_attention_dq"] != BLOCKS * micro or counts["flash_attention_dkv"] != BLOCKS * micro:
        raise SystemExit(f"[lora] K4 / K5 must launch {BLOCKS} times per micro-batch ({BLOCKS * micro}): {counts}")
    if counts["flash_attention_fwd"] < 2 * BLOCKS * micro or counts["resnet_conv3x3_stats"] <= 0:
        raise SystemExit(f"[lora] K3 (forward and recompute) or K1 (the frozen encodes) did not launch: {counts}")
    _lora_grad_tree_check(model)
    return counts


# ---------------------------------------------------------------------------
# phase 7: the stand-alone VAE convs through their modules
# ---------------------------------------------------------------------------
def phase_convs() -> dict:
    """K9, K11 and K12 through the entry points a user calls, at the widths
    and sizes the FLUX `ae` encoder and decoder give a conv at 512^2: the
    three `Downsample(fused=True)` of the encoder chained with a fused resnet
    block after each (which takes the kernel's statistics), the `Conv3x3`
    module, and `fused_gn_silu_conv3x3_batched` over `group_norm_coeffs`. Each
    is held against the unfused module or the plain composition on the same
    weights."""
    from ragb_vae_tpu_torch.models import vae as vae_module

    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    kw = {"device": "cuda", "dtype": torch.bfloat16}
    torch.manual_seed(SEED + 3)
    reset_all_counts()
    ok = True
    with torch.no_grad():
        # the encoder's three downsamplers at a 512^2 batch of 4
        for c_in, c_out, size in ((128, 256, 512), (256, 512, 256), (512, 512, 128)):
            down = vae_module.Downsample(c_in, fused=True, **kw)
            block = vae_module.ResnetBlock(c_in, c_out, 32, fused=True, **kw)
            x = _randn(gen, (4, size, size, c_in))
            y, stats = down(x)
            down.fused = False
            y_ref, _ = down(x)
            out, _ = block(y, stats)
            out_ref, _ = block(y)                     # statistics recomputed from y
            rel_y = ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item()
            rel_o = ((out.float() - out_ref.float()).abs().max() / out_ref.float().abs().max()).item()
            fine = (y.shape == (4, size // 2, size // 2, c_in) and rel_y <= CONV_Y_REL_TOL
                    and rel_o <= CONV_Y_REL_TOL and bool(torch.isfinite(out.float()).all()))
            ok &= fine
            log("convs", f"Downsample(fused=True) {tuple(x.shape)} -> {tuple(y.shape)} then a fused ResnetBlock "
                f"-> {c_out} on its statistics: y vs the unfused module rel {rel_y:.3g}, block output vs the one "
                f"on recomputed statistics rel {rel_o:.3g} (<= {CONV_Y_REL_TOL}) {'ok' if fine else 'FAIL'}")
            del down, block, x, y, y_ref, out, out_ref
        # Conv3x3 at the decoder's mid width and at its last level
        for c_in, c_out, shape in ((512, 512, (1, 128, 128)), (128, 128, (2, 512, 512))):
            conv = vae_module.Conv3x3(c_in, c_out, **kw)
            x = _randn(gen, (*shape, c_in))
            y = conv(x)
            y_ref = vae_module.conv_nhwc(conv.conv, x)
            rel = ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item()
            fine = y.shape == (*shape, c_out) and rel <= CONV_Y_REL_TOL
            ok &= fine
            log("convs", f"Conv3x3 {tuple(x.shape)} -> {c_out}: vs nn.Conv2d on the same weights rel {rel:.3g} "
                f"(<= {CONV_Y_REL_TOL}) {'ok' if fine else 'FAIL'}")
            del conv, x, y, y_ref
        # GroupNorm -> SiLU -> conv3x3 in one launch, per-sample coefficients
        for c_in, c_out, shape in ((512, 512, (2, 128, 128)), (128, 128, (2, 512, 512))):
            norm = vae_module.FastGroupNorm(32, c_in, **kw)
            conv = torch.nn.Conv2d(c_in, c_out, 3, padding=1, **kw)
            norm.weight.normal_(1.0, 0.1, generator=gen)
            norm.bias.normal_(0.0, 0.1, generator=gen)
            x = _randn(gen, (*shape, c_in))
            a, b = fgc.group_norm_coeffs(x, norm.weight, norm.bias, 32)
            y = fgc.fused_gn_silu_conv3x3_batched(x, a, b, conv.weight.permute(2, 3, 1, 0).contiguous(), conv.bias)
            y_ref = vae_module.conv_nhwc(conv, F.silu(norm(x)).to(torch.bfloat16))
            rel = ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item()
            fine = y.shape == (*shape, c_out) and rel <= CONV_Y_REL_TOL
            ok &= fine
            log("convs", f"fused_gn_silu_conv3x3_batched {tuple(x.shape)} -> {c_out}: vs FastGroupNorm + SiLU + "
                f"nn.Conv2d rel {rel:.3g} (<= {CONV_Y_REL_TOL}) {'ok' if fine else 'FAIL'}")
            del norm, conv, x, y, y_ref
    torch.cuda.synchronize()
    counts = {"downsample_conv3x3_stats": rb.DOWNSAMPLE_LAUNCHES, "conv3x3_same": c3.LAUNCHES,
              "fused_gn_silu_conv3x3": fgc.LAUNCHES}
    log("convs", f"launches {counts}")
    if not ok:
        raise SystemExit("[convs] a fused module disagrees with its unfused counterpart")
    if counts != {"downsample_conv3x3_stats": 3, "conv3x3_same": 2, "fused_gn_silu_conv3x3": 2}:
        raise SystemExit(f"[convs] each module must launch its kernel once per call: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 8: weight-only int8 serving and QLoRA at full width
# ---------------------------------------------------------------------------
def _probe_forward(model, gen_seed: int, transformer=None):
    """One transformer forward at 512^2, batch 1, on seeded inputs (through
    `transformer`, a pipeline, when given)."""
    from ragb_vae_tpu_torch.ops.packing import prepare_latent_image_ids

    gen = torch.Generator("cuda").manual_seed(gen_seed)
    packed = torch.randn((1, 2048, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ids = prepare_latent_image_ids(32, 32, device="cuda")
    with torch.no_grad():
        return model._transformer_pred(packed, torch.full((1,), 0.5, device="cuda"),
                                       torch.cat([ids, ids], dim=0), 1, transformer).float()


# The adapters' gradient tree through K10 (every base linear of the forward and
# of the per-block recompute; its backward is `torch.matmul` on every route),
# held against the same step with every int8 linear forced to the plain
# version under PyTorch autograd: same weights, latents, noise and timestep.
# The plain version rounds the unscaled product to bf16 before it scales it and
# rounds again, the kernel rounds once, and that difference passes through up
# to 57 blocks of bf16 residual stream in both directions; a third route (the
# product, scale and bias in fp32 from the same bf16 x, one rounding: the
# kernel's own arithmetic) shows how large that noise is between two plain
# routes. On an H100 the worst leaf reads 0.0095 (cosine 0.99996) for K10
# against the fp32 route and 0.048 (0.9990) against the plain bf16 route, which
# is itself 0.047 (0.9990) from the fp32 one: the double rounding is the plain
# version's, not the kernel's. The bounds leave each reading two to three times
# its size. A K10 fault that only shows through the depth of the stack (a wrong
# tile at one shape of the path, a scale off in one layer) moves the leaves
# below it by the size of the gradient itself.
QLORA_GRAD_PLAIN_TOL = (0.1, 0.99)      # vs the plain version: worst leaf's relative error, worst cosine
QLORA_GRAD_EXACT_TOL = (0.03, 0.999)    # vs the fp32 route


def _qlora_grad_tree_check(model, n_linears: int, in_blocks: int) -> None:
    def exact_route(x, weight_q, scale, bias=None):
        y = torch.matmul(x.float(), weight_q.float().t()) * scale
        return (y if bias is None else y + bias).to(x.dtype)

    before = i8.LAUNCHES

    def after_route(label):
        # the kernel route runs first: once per linear, the blocks' twice (recompute); never on a plain route
        if i8.LAUNCHES != before + n_linears + in_blocks:
            raise SystemExit(f"[int8] after the route {label!r}: K10 must have launched {n_linears + in_blocks} "
                             f"times on the kernel route and never on a plain one, counted {i8.LAUNCHES - before}")

    named, out = _adapter_grad_routes(
        model, "int8_matmul",
        [("K10", i8.int8_matmul), ("plain bf16 matmul", i8.int8_matmul_plain), ("plain fp32 matmul", exact_route)],
        SEED + 6, after_route)
    log("int8", f"adapter gradient tree over the int8 base at 256^2 batch 1, {len(named)} leaves: "
        + ", ".join(f"loss {label} {loss:.6f}" for label, (loss, _) in out.items()))
    ok = _hold_grad_routes("int8", named, out, (("K10", "plain bf16 matmul", True),
                                                ("plain bf16 matmul", "plain fp32 matmul", False)),
                           *QLORA_GRAD_PLAIN_TOL)
    ok &= _hold_grad_routes("int8", named, out, (("K10", "plain fp32 matmul", True),), *QLORA_GRAD_EXACT_TOL)
    if not ok:
        raise SystemExit("[int8] the adapter gradients through K10 disagree with the plain route's")


def _train_without_saving(model, cfg: dict, log_fn) -> tuple:
    """`train_from_config(cfg, model=model, log_fn=log_fn)` with the stage's
    saves stubbed out: the adapters' safetensors, the metadata and the AdamW
    state (4.3 GB at full width), which the LoRA phase writes and reloads
    through the same code. -> (its result, the directories it would have
    saved to)."""
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as stage

    skipped = []
    metadata, save = stage.write_lora_metadata, torch.save
    model.save_lora_weights = lambda output_dir: skipped.append(Path(output_dir))
    stage.write_lora_metadata = lambda *args, **kwargs: None
    torch.save = lambda *args, **kwargs: None
    try:
        return stage.train_from_config(cfg, model=model, log_fn=log_fn), skipped
    finally:
        del model.save_lora_weights
        stage.write_lora_metadata, torch.save = metadata, save


def phase_int8(model, bf16_peak: int, work: Path, refs: dict) -> dict:
    """Quantises the serving phase's transformer where it lives, holds one
    forward against the bf16 one from the same weights, serves 3 requests
    through InferenceServer, takes 2 QLoRA optimizer steps through
    `train_from_config(weight_quant="int8")` on the PNG tree in `work`
    (without its final save), then holds the adapters' gradient tree through
    K10 against the plain route. Into `refs`: the int8 forward without
    the LoRA phase's adapters, for the tp phase."""
    from ragb_vae_tpu_torch.models.flux_transformer import LoraDense, QLinear
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.models.quantize import quantize_module_

    for p in model.transformer.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = _probe_forward(model, SEED + 4)
    before = torch.cuda.memory_allocated()
    quantize_module_(model.transformer)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    linears = [m for m in model.transformer.modules() if isinstance(m, QLinear)]
    in_blocks = sum(1 for n, m in model.transformer.named_modules() if isinstance(m, QLinear)
                    and n.startswith(("transformer_blocks.", "single_transformer_blocks.")))
    if not all(m.weight_quant == "int8" and m.weight_q.dtype == torch.int8 for m in linears):
        raise SystemExit("[int8] a linear was left unquantised")
    log("int8", f"quantised {len(linears)} linears ({sum(m.weight_q.numel() for m in linears) / 1e9:.2f} B weights) "
        f"on the card in {time.perf_counter() - t0:.1f} s: {before / 2**30:.2f} -> "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    reset_all_counts()
    out = _probe_forward(model, SEED + 4)
    torch.cuda.synchronize()
    per_forward = i8.LAUNCHES
    rel = ((out - ref).norm() / ref.norm()).item()
    cos = (torch.dot(out.flatten(), ref.flatten()) / (out.norm() * ref.norm())).item()
    fine = (bool(torch.isfinite(out).all()) and rel <= INT8_TRACK_REL_TOL and cos >= INT8_TRACK_COS_TOL
            and per_forward == len(linears))
    log("int8", f"one forward at 512^2: {per_forward} K10 launches for {len(linears)} linears; int8 vs bf16 output "
        f"relative error {rel:.4f} (<= {INT8_TRACK_REL_TOL}) cosine {cos:.5f} (>= {INT8_TRACK_COS_TOL}) "
        f"{'ok' if fine else 'FAIL'}")
    if not fine:
        raise SystemExit("[int8] the int8 transformer does not track the bf16 one, or a linear missed the kernel")
    # the same forward through a pipeline of PP stages on the card: the same bits, the same K10 launches
    from ragb_vae_tpu_torch.parallel.pipeline import PipelinedFluxTransformer

    pipe = PipelinedFluxTransformer(model.transformer_config, ["cuda:0"] * PP).place_(model.transformer)
    reset_all_counts()
    with _StageCounts(pipe) as stage_launches:
        staged = _probe_forward(model, SEED + 4, transformer=pipe)
    torch.cuda.synchronize()
    same = torch.equal(staged, out) and i8.LAUNCHES == per_forward
    log("int8", f"the same forward at pp {PP}: {'bit-equal' if torch.equal(staged, out) else 'DIFFERS'}, "
        f"{i8.LAUNCHES} K10 launches, per stage {[c['int8_matmul'] for c in stage_launches]} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("[int8] the pipelined int8 forward differs from the monolithic one")
    del ref, out, staged, pipe
    # the same forward without the LoRA phase's adapters, for the tp phase
    ranks = {m: m.lora_rank for m in model.transformer.modules() if isinstance(m, LoraDense)}
    for m in ranks:
        m.lora_rank = 0
    refs["int8_forward"] = _probe_forward(model, SEED + 4).cpu()
    for m, r in ranks.items():
        m.lora_rank = r

    counts, peak, batches = _serve_three("int8", model, {
        "int8_matmul": lambda: i8.LAUNCHES,
        "resnet_conv3x3_stats": lambda: rb.CONV_LAUNCHES,
        "subpixel_upsample_conv3x3_stats": lambda: rb.UPSAMPLE_LAUNCHES,
        "flash_attention_fwd": lambda: fa.LAUNCHES,
    }, sizes=((512, 512),) * 3)       # the resize of a 600x400 request is the bf16 phase's to drive
    log("int8", f"serving peak memory {peak / 2**30:.2f} GiB (bf16 serving phase: {bf16_peak / 2**30:.2f} GiB)")
    if counts["int8_matmul"] != len(linears) * SERVE_STEPS * batches:
        raise SystemExit(f"[int8] K10 must launch once per linear, step and batch "
                         f"({len(linears)} x {SERVE_STEPS} x {batches}): {counts}")

    # QLoRA: the adapters (attached here when the LoRA phase did not run) over the int8 base
    steps, pairs, n_micro = STAGE_STEPS, STAGE_PAIRS, STAGE_MICRO
    if not lora_parameters(model.transformer):
        model.lora_rank, model.lora_alpha = LORA_CONFIG["rank"], float(LORA_CONFIG["lora_alpha"])
        gen = torch.Generator("cuda").manual_seed(SEED)
        model.init_lora(gen)
        with torch.no_grad():
            for name, p in lora_parameters(model.transformer).items():
                if name.endswith("lora_B"):
                    p.normal_(0.0, 0.01, generator=gen)
    lora = lora_parameters(model.transformer)
    base = {k: v for k, v in model.transformer.state_dict().items() if k not in lora}
    checks = lambda: [(v.double().sum().item(), v.double().square().sum().item()) for v in base.values()]
    base_before = checks()
    probe_gen = torch.Generator("cuda").manual_seed(SEED + 5)
    lat = (2, 64, 64, model.vae.config.latent_channels)
    probe = [torch.randn(lat, generator=probe_gen, device="cuda") for _ in range(3)]
    probe_u = torch.tensor([0.3, 0.7], device="cuda")

    def probe_loss():
        with torch.no_grad():
            return model.compute_loss_from_latents(*probe, probe_u)[0].item()

    # the probe draws nothing and the kernels are bitwise reproducible: run twice
    # it gives the same number, so whatever it moves by is the adapters' doing
    loss_before, loss_again = probe_loss(), probe_loss()
    logged = []
    ckpt = work / "ckpt_qlora"
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    with _GradRecord() as grads:
        result, skipped = _train_without_saving(model, _stage_config(work / "data", ckpt, weight_quant="int8"),
                                                lambda step, m: logged.append(m))
    torch.cuda.synchronize()
    q_counts = {"int8_matmul": i8.LAUNCHES, **_lora_counts()}
    q_peak = torch.cuda.max_memory_allocated()
    if skipped != [ckpt / "final"]:
        raise SystemExit(f"[int8] the QLoRA stage must reach its final save and no other: {skipped}")
    loss_after = probe_loss()
    for i, m in enumerate(logged):
        log("int8", f"QLoRA step {i}: loss={m['train/loss']:.6f} grad_norm={m['train/grad_norm']:.4f} lr={m['lr']:.3g}")
    bad = grads.without_gradient(lora)
    moved = [k for k, a, b in zip(base, base_before, checks()) if a != b]
    micro = steps * n_micro
    want_k10 = (2 * in_blocks + len(linears) - in_blocks) * micro    # the blocks run again in the backward
    fine = (len(logged) == steps and result["global_step"] == steps and not bad and not moved
            and all(math.isfinite(m["train/loss"]) and m["train/grad_norm"] > 0.0 for m in logged)
            and math.isfinite(loss_after) and loss_again == loss_before and loss_after < loss_before)
    log("int8", f"{steps} QLoRA steps of {pairs} pairs at 512^2 in {n_micro} micro-batches over the int8 base "
        f"(train_from_config, its final save stubbed out): "
        f"probe loss {loss_before:.6f} (run again: {loss_again:.6f}) -> {loss_after:.6f}; {len(lora)} adapter leaves, {len(bad)} without a finite "
        f"gradient; {len(base)} base tensors, {len(moved)} changed; peak memory {q_peak / 2**30:.2f} GiB; "
        f"launches {q_counts} {'ok' if fine else 'FAIL'}")
    if not fine:
        raise SystemExit("[int8] QLoRA: a loss is not finite or did not fall, the probe does not repeat, "
                         "an adapter has no gradient, or the base changed")
    if (q_counts["int8_matmul"] != want_k10 or q_counts["flash_attention_dq"] != BLOCKS * micro
            or q_counts["flash_attention_dkv"] != BLOCKS * micro
            or q_counts["flash_attention_fwd"] < 2 * BLOCKS * micro):
        raise SystemExit(f"[int8] QLoRA launch counts: K10 must be {want_k10}, K4 / K5 {BLOCKS * micro}, "
                         f"K3 at least {2 * BLOCKS * micro}: {q_counts}")
    for key, n in q_counts.items():
        counts[key] = counts.get(key, 0) + n
    _qlora_grad_tree_check(model, len(linears), in_blocks)
    return counts


# ---------------------------------------------------------------------------
# phase 12: pipeline parallel, every stage on the one card
# ---------------------------------------------------------------------------
# One process drives the stages (`parallel/pipeline.py`); on one card every
# stage sits on cuda:0, so the split, the stage boundaries and the carrier run
# as they would across cards, and the answers can be held bit for bit. At
# microbatch = batch a stage runs the same kernels on the same shapes as the
# monolithic forward: the same bits. At microbatch 1 of a batch of 2 the
# GEMMs see M = S instead of 2 S and cuBLAS may pick another tiling, so the
# output is held to a bound beside the bit equality of each row's own
# monolithic forward (the same shapes again). The bounds: the b2 forward at
# microbatch 1 against the b2 monolithic one, and the adapters' gradients of
# the 2-stage GPipe step (microbatch 1 of 2) against the monolithic step's,
# both as the tp phase's (bf16 noise of one more rounding through the stack).
# The forward's planted faults run at microbatch 2, where the sound pipeline
# is the monolithic forward bit for bit, and must break that equality: on
# random weights attention is near uniform, so txt and img swapped at a
# single-range boundary (a reordered joint stream) moves the output by 0.044
# only, inside the microbatch-1 bound (an H100 80GB HBM3 at 700 W). The
# gradient fault must fail the gradients' bound.
PP = 4                         # stages of the serving pipeline
PP_TRAIN_STAGES = 2            # stages of the training pipeline
PP_TRAIN_DEPTH = (2, 4)        # its transformer's double and single blocks (full width)
PP_FORWARD_TOL = (0.05, 0.998)         # b2 at microbatch 1 vs the monolithic b2 forward (as TP_FORWARD_TOL)
PP_GRAD_TOL = (LORA_GRAD_REL_TOL, LORA_GRAD_COS_TOL)   # GPipe adapter gradients vs the monolithic step's
PP_WEIGHTS = (1.0, 0.5)        # the training step's sample weights
GUARD_CALLS = 100_000          # calls timed for the device guard's host cost


def _pp_faults(pp) -> dict:
    """The planted faults of the pp phase: label -> (owner, attribute,
    replacement). The first three must fail the forward's bound, the last the
    gradients'."""
    real_ranges, real_carry, real_numerator = pp.stage_ranges, pp.PipelinedFluxTransformer.carry, pp.loss_numerator

    def dropped(config, n):
        ranges = real_ranges(config, n)
        dr, sr = ranges[1]
        ranges[1] = (dr, range(sr.start, sr.stop - 1)) if len(sr) else (range(dr.start, dr.stop - 1), sr)
        return ranges

    def no_temb(carrier, device):
        return real_carry((*carrier[:2], None if carrier[2] is None else torch.zeros_like(carrier[2])), device)

    return {
        "a stage range drops a block": [(pp, "stage_ranges", dropped)],
        "txt and img swapped at a single-range boundary": [
            (pp.PipelineStage, "join", staticmethod(lambda txt, img: torch.cat([img, txt], dim=1))),
            (pp.PipelineStage, "split",
             staticmethod(lambda x, n_txt: (x[:, x.shape[1] - n_txt:], x[:, :x.shape[1] - n_txt])))],
        "temb not carried": [(pp.PipelinedFluxTransformer, "carry", staticmethod(no_temb))],
        "each microbatch divided by its own weight sum": [
            (pp, "loss_numerator", lambda pred, lt, wt, w, *a: real_numerator(pred, lt, wt, w, *a) / w.sum())],
    }


class _Planted:
    """Plant a fault's replacements for a `with` block."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in self.patches]
        for owner, attr, fn in self.patches:
            setattr(owner, attr, fn)

    def __exit__(self, *exc):
        for owner, attr, real in self.saved:
            setattr(owner, attr, real)


class _StageCounts:
    """For a `with` block: each stage's K3 and K10 launches in `pipe`, one
    dict a stage (`PipelineStage.forward` wrapped)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.counts = [{} for _ in pipe.stages]

    def __enter__(self):
        from ragb_vae_tpu_torch.parallel.pipeline import PipelineStage

        self.real = real = PipelineStage.forward
        counters = {"flash_attention_fwd": lambda: fa.LAUNCHES, "int8_matmul": lambda: i8.LAUNCHES}
        pipe, counts = self.pipe, self.counts

        def counted(stage, *args):
            before = {k: read() for k, read in counters.items()}
            out = real(stage, *args)
            mine = counts[pipe.stages.index(stage)]
            for k, read in counters.items():
                mine[k] = mine.get(k, 0) + read() - before[k]
            return out

        PipelineStage.forward = counted
        return counts

    def __exit__(self, *exc):
        from ragb_vae_tpu_torch.parallel.pipeline import PipelineStage

        PipelineStage.forward = self.real


def _guard_host_cost() -> dict:
    """Host ns per launch of the device guard in `_build.launch`: reading the
    current device and comparing (every launch), and switching there and back
    (a launch for another device than the current one; on one card both
    switches are to the current device, which costs what a real switch costs
    in the runtime call)."""
    get, set_ = torch._C._cuda_getDevice, torch._C._cuda_setDevice
    t0 = time.perf_counter()
    for _ in range(GUARD_CALLS):
        if get() != 0:
            pass
    read = (time.perf_counter() - t0) / GUARD_CALLS * 1e9
    t0 = time.perf_counter()
    for _ in range(GUARD_CALLS):
        set_(0)
        set_(0)
    switch = (time.perf_counter() - t0) / GUARD_CALLS * 1e9
    return {"read_ns": read, "switch_ns": switch}


def phase_pp(model, refs: dict) -> dict:
    """(After slice, on its model.) The plan's per-stage bytes at full depth;
    the slice phase's 512^2 request served at pp 4 through
    `InferenceServer(pipeline=)` against the slice phase's answer; a b2
    forward at microbatch 1 and 2 against the monolithic one; one
    `PipelineLoraTrainer` step at 2 stages on a full-width 2 + 4 block
    transformer; the planted faults; the device guard's host cost."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig, QLinear
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.ops.packing import prepare_latent_image_ids
    from ragb_vae_tpu_torch.parallel import pipeline as pp
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    # the plan: what each card would hold of the full-depth transformer
    meta = FluxTransformer2D(FluxTransformerConfig(), device="meta", dtype=torch.bfloat16)
    whole = sum(t.numel() * t.element_size() for t in (*meta.parameters(), *meta.buffers()))
    for n in (2, 4, 8):
        per = pp.stage_bytes(meta, n)
        log("pp", f"plan at pp {n} (bf16, fp32 AdaLN modulation): "
            + ", ".join(f"stage {i} {b / 2**30:.3f} GiB" for i, b in enumerate(per))
            + f" of {whole / 2**30:.3f} GiB whole; ranges {pp.stage_ranges(FluxTransformerConfig(), n)}")
    del meta
    guard = _guard_host_cost()
    log("pp", f"device guard host cost per launch: {guard['read_ns']:.1f} ns to read and compare the current "
        f"device, {guard['switch_ns']:.1f} ns more to switch there and back ({GUARD_CALLS} calls each)")

    # serving at pp 4, the launches of each stage counted
    pipe = pp.PipelinedFluxTransformer(model.transformer_config, ["cuda:0"] * PP).place_(model.transformer)
    image = _tp_request()
    reset_all_counts()
    with _StageCounts(pipe) as stage_launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            answer = InferenceServer(model, ServeConfig(steps=SERVE_STEPS), pipeline=pipe)._run_batch(
                image[None], np.array([TP_SEED], np.uint32))[0]
        serve_s = time.perf_counter() - t0
    counts = {"flash_attention_fwd": fa.LAUNCHES, "resnet_conv3x3_stats": rb.CONV_LAUNCHES,
              "subpixel_upsample_conv3x3_stats": rb.UPSAMPLE_LAUNCHES}
    same = bool(np.array_equal(answer, refs["answer"]))
    per_step = [{k: n // SERVE_STEPS for k, n in c.items()} for c in stage_launches]
    want_k3 = [len(dr) + len(sr) for dr, sr in pipe.ranges]
    log("pp", f"one 512^2 request at pp {PP} (stages {[(len(d), len(s)) for d, s in pipe.ranges]} double, single "
        f"blocks), {SERVE_STEPS} steps, through InferenceServer(pipeline=) in {serve_s:.3f} s: "
        f"{'bit-equal to' if same else 'DIFFERS from'} the slice phase's answer; launches of each stage per "
        f"denoising step {per_step}; whole request {counts}")
    if not same or [c["flash_attention_fwd"] for c in per_step] != want_k3 or min(counts.values()) == 0:
        raise SystemExit(f"[pp] the pipelined answer differs from the slice phase's, or a stage's K3 launches "
                         f"are not its block count {want_k3}")

    # a b2 forward: microbatch 2 (= batch) and 1 against the monolithic one
    gen = torch.Generator("cuda").manual_seed(SEED + 14)
    packed = torch.randn((2, 2048, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ids = prepare_latent_image_ids(32, 32, device="cuda")
    ids = torch.cat([ids, ids], dim=0)
    t = torch.full((2,), 0.5, device="cuda")

    def forward(microbatch=None, rows=slice(None)):
        run = None if microbatch is None else (lambda **kw: pipe(**kw, microbatch=microbatch))
        with torch.no_grad():
            return model._transformer_pred(packed[rows], t[rows], ids, packed[rows].shape[0], transformer=run)

    mono = forward()
    whole_mb = forward(2)
    mb1 = forward(1)
    per_row = torch.cat([forward(None, slice(r, r + 1)) for r in range(2)])
    track = _tracks(mb1.float(), mono.float())
    sound = torch.equal(whole_mb, mono) and torch.equal(mb1, per_row) and _within(track, PP_FORWARD_TOL)
    log("pp", f"b2 forward at 512^2: microbatch 2 {'bit-equal' if torch.equal(whole_mb, mono) else 'DIFFERS'}; "
        f"microbatch 1 {'bit-equal' if torch.equal(mb1, per_row) else 'DIFFERS'} to each row's monolithic forward, "
        f"relative error {track[0]:.4g} cosine {track[1]:.6f} against the b2 monolithic one "
        f"(<= {PP_FORWARD_TOL[0]}, >= {PP_FORWARD_TOL[1]}) {'ok' if sound else 'FAIL'}")
    if not sound:
        raise SystemExit("[pp] the pipelined forward does not equal or track the monolithic one")
    faults = _pp_faults(pp)
    caught = True
    for label in list(faults)[:3]:
        with _Planted(faults[label]):
            faulty = pp.PipelinedFluxTransformer(model.transformer_config, ["cuda:0"] * PP).place_(model.transformer)
            with torch.no_grad():
                out = model._transformer_pred(packed, t, ids, 2, transformer=lambda **kw: faulty(**kw, microbatch=2))
        ft = _tracks(out.float(), mono.float())
        failed = not torch.equal(out, mono)
        caught &= failed
        log("pp", f"planted fault '{label}': the b2 forward at microbatch 2 "
            f"{'differs from' if failed else 'IS BIT-EQUAL TO'} the monolithic one (the sound run's bound), "
            f"relative error {ft[0]:.4g} cosine {ft[1]:.6f} "
            f"({'outside' if not _within(ft, PP_FORWARD_TOL) else 'inside'} the microbatch-1 bound)")
    del mono, whole_mb, mb1, per_row, out, pipe, faulty
    torch.cuda.empty_cache()

    # one GPipe LoRA step at 2 stages on a full-width 2 + 4 block transformer
    cfg = FluxTransformerConfig(num_layers=PP_TRAIN_DEPTH[0], num_single_layers=PP_TRAIN_DEPTH[1])
    tpipe = pp.PipelinedFluxTransformer(cfg, ["cuda:0"] * PP_TRAIN_STAGES)
    m = FluxTextAlphaModel.random(cfg, model.vae.config, seed=SEED + 15, dtype=torch.bfloat16, fused=True,
                                  lora_rank=LORA_CONFIG["rank"], lora_alpha=float(LORA_CONFIG["lora_alpha"]),
                                  use_gradient_checkpointing=True, pipeline=tpipe)
    gen = torch.Generator("cuda").manual_seed(SEED + 16)
    with torch.no_grad():
        for mod in m.transformer.modules():
            if isinstance(mod, QLinear) and mod.bias is not None:
                mod.bias.normal_(0.0, 0.1, generator=gen)
        for name, p in lora_parameters(m.transformer).items():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.01, generator=gen)
    lat = (2, 64, 64, m.vae.config.latent_channels)      # 512^2, batch 2
    cond, target, noise = (torch.randn(lat, generator=gen, device="cuda") for _ in range(3))
    u = torch.tensor([0.3, 0.7], device="cuda")
    w = torch.tensor(PP_WEIGHTS, device="cuda")
    named = lora_parameters(m.transformer)
    for p in named.values():
        p.grad = None
    ref_loss, _ = m.compute_loss_from_latents(cond, target, noise, u, weights=w)
    ref_loss.backward()
    ref = {n: p.grad.detach().float().clone() for n, p in named.items()}
    trainer = pp.PipelineLoraTrainer(m, tpipe, lambda ps: torch.optim.AdamW(
        ps, lr=LORA_CONFIG["learning_rate"], betas=(LORA_CONFIG["adam_beta1"], LORA_CONFIG["adam_beta2"]),
        weight_decay=LORA_CONFIG["weight_decay"]))

    def gpipe_grads():
        loss, grads, _ = trainer.loss_and_grads(cond, target, noise, u, weights=w, microbatch=1)
        flat = {k: g.float() for stage in grads for k, g in stage.items()}
        rel = max((_tracks(flat[n], ref[n])[0], n) for n in ref)
        cos = min((_tracks(flat[n], ref[n])[1], n) for n in ref)
        return loss, rel, cos

    label = list(faults)[3]          # planted first: the sound run then leaves its gradients for the update
    with _Planted(faults[label]):
        _, frel, fcos = gpipe_grads()
    caught &= not _within((frel[0], fcos[0]), PP_GRAD_TOL)
    log("pp", f"planted fault '{label}': worst gradient relative error {frel[0]:.4g} cosine {fcos[0]:.6f} "
        f"{'fails the bound' if not _within((frel[0], fcos[0]), PP_GRAD_TOL) else 'PASSES THE BOUND'}")
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, rel, cos = gpipe_grads()
    before = {n: p.detach().clone() for n, p in named.items()}
    for opt in trainer.optimizers:
        opt.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    train_counts = _lora_counts()
    moved = sum(not torch.equal(before[n], p) for n, p in named.items())
    blocks = sum(PP_TRAIN_DEPTH)
    sound = (_within((rel[0], cos[0]), PP_GRAD_TOL) and math.isfinite(loss.item())
             and abs(loss.item() - ref_loss.item()) <= 1e-2 * abs(ref_loss.item()) and moved == len(named)
             and len(trainer.optimizers) == PP_TRAIN_STAGES)
    log("pp", f"one PipelineLoraTrainer step at {PP_TRAIN_STAGES} stages {[(len(d), len(s)) for d, s in tpipe.ranges]}, "
        f"512^2 batch 2 at microbatch 1, weights {PP_WEIGHTS}, in {step_s:.3f} s: loss {loss.item():.6f} "
        f"(monolithic {ref_loss.item():.6f}); {len(ref)} adapter leaves, worst relative error {rel[0]:.4g} "
        f"({rel[1]}), worst cosine {cos[0]:.6f} ({cos[1]}) (<= {PP_GRAD_TOL[0]}, >= {PP_GRAD_TOL[1]}); "
        f"{moved} adapters moved; launches {train_counts} {'ok' if sound else 'FAIL'}")
    if not sound:
        raise SystemExit("[pp] the GPipe step's loss or gradients disagree with the monolithic step's")
    if (train_counts["flash_attention_dq"] != blocks * 2 or train_counts["flash_attention_dkv"] != blocks * 2
            or train_counts["flash_attention_fwd"] != 2 * blocks * 2):
        raise SystemExit(f"[pp] launches of the GPipe step: K4 / K5 must be {blocks * 2} (a block per "
                         f"microbatch), K3 {4 * blocks} (the forward and its recompute): {train_counts}")
    if not caught:
        raise SystemExit("[pp] a planted fault passed its bound")
    for key, n in train_counts.items():
        counts[key] = counts.get(key, 0) + n
    del m, trainer, tpipe, ref, before
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: tensor parallel, two processes on the one card
# ---------------------------------------------------------------------------
# Two processes on cuda:0 join a gloo group (NCCL refuses two ranks on one
# device; on a node of several cards the port's code takes the NCCL group it
# is given): the collectives here go through host memory, and their times are
# gloo's, not NCCL's. Each rank draws its shard of FLUX.1-Kontext from seed
# 0's stream as `FluxTextAlphaModel.random(tp=)` does, so the two ranks hold
# the slice phase's model between them, and their answers are held against
# the slice and int8 phases' answers to the same inputs.
#
# The sharded model differs from the whole one in its rounding only: each
# row layer's two partial sums are rounded to bf16 before the all-reduce, so
# every output carries one or two more bf16 roundings, and that noise rides
# through 57 blocks of a random-init residual stream. A planted fault is of
# another size: a row all-reduce left out drops half of every row layer's sum
# (relative error ~0.5 and more, compounding), a row bias added twice shifts
# every such output by its bias, and the single blocks' proj_out over JAX's
# contiguous rows multiplies half of each rank's activations with weights of
# other channels. Each fault is planted in the same run and must fail the
# bound it is listed under: the forward's bound (a row all-reduce left out;
# the random-init biases are zero, so a bias added twice cannot show there)
# and the LoRA gradients' bound (all three, over non-zero biases). On an
# H100 the sound run reads 0.0177 (forward), 0.0082 (answer), 0.0173 (int8)
# and 0.0183 (worst gradient leaf); the faults 0.83-1.35.
TP = 2                         # ranks of the model group
TP_SEED = 7                    # the request's seed
TP_LORA_DEPTH = (2, 4)         # the LoRA part's double and single blocks (full width)
TP_FORWARD_TOL = (0.05, 0.998)         # bf16 forward vs the slice phase's: relative error, cosine
TP_ANSWER_TOL = (0.02, 0.999)          # the served 512^2 answer vs the slice phase's
TP_INT8_TOL = (0.05, 0.998)            # int8 forward vs the int8 phase's (same int8 weights)
TP_GRAD_TOL = (LORA_GRAD_REL_TOL, LORA_GRAD_COS_TOL)   # LoRA gradients vs the unsharded model's
TP_JOIN_SECONDS = 600


def _tp_request() -> np.ndarray:
    """The 512^2 request the slice and tp phases both answer."""
    return np.random.default_rng(SEED + 9).uniform(size=(512, 512, 4)).astype(np.float32)


def _tracks(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(||got - want|| / ||want||, cosine) over the whole tensors, in fp64."""
    got, want = got.double().flatten(), want.double().flatten()
    return ((got - want).norm() / want.norm()).item(), (torch.dot(got, want) / (got.norm() * want.norm())).item()


def _within(track: tuple, tol: tuple) -> bool:
    return math.isfinite(track[0]) and track[0] <= tol[0] and track[1] >= tol[1]


def _tp_child(rank: int, work: str) -> None:
    """One rank of the tp phase: its results, or its traceback, into `work`."""
    import traceback

    try:
        torch.save(_tp_rank(rank, Path(work)), Path(work) / f"tp_result_{rank}.pt")
    except BaseException:
        (Path(work) / f"tp_error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _tp_rank(rank: int, work: Path) -> dict:
    import torch.distributed as dist

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig, QLinear
    from ragb_vae_tpu_torch.models.quantize import quantize_module_
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.parallel import tensor_parallel as tpm
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{work / 'tp_rendezvous'}", world_size=TP, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_JOIN_SECONDS))
    _, tp, _ = create_training_mesh(tp=TP)
    out: dict = {}

    # the serving path at full width and depth: rank 0 serves, rank 1 follows
    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    t0 = time.perf_counter()
    model = FluxTextAlphaModel.random(FluxTransformerConfig(), vae_cfg, seed=SEED, device="cuda",
                                      dtype=torch.bfloat16, fused=True, tp=tp)
    torch.cuda.synchronize()
    out["build_s"], out["resident"] = time.perf_counter() - t0, torch.cuda.memory_allocated()
    out["transformer_bytes"] = tpm.shard_bytes(model.transformer)
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    tpm.reset_counts()
    server = InferenceServer(model, ServeConfig(max_batch=1, steps=SERVE_STEPS, auto_batch=False), tp_group=tp)
    t0 = time.perf_counter()
    if rank == 0:
        with server:
            out["answer"] = server.submit(_tp_request(), seed=TP_SEED).result(timeout=TP_JOIN_SECONDS)
    else:
        out["batches"] = server.serve_worker()
    torch.cuda.synchronize()
    out["request_s"] = time.perf_counter() - t0
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    out["serve_launches"] = {"resnet_conv3x3_stats": rb.CONV_LAUNCHES,
                             "subpixel_upsample_conv3x3_stats": rb.UPSAMPLE_LAUNCHES,
                             "flash_attention_fwd": fa.LAUNCHES}
    out["serve_collectives"] = dict(tpm.COUNTS)

    # one transformer forward: the collectives, s/step, a dropped row all-reduce
    from ragb_vae_tpu_torch.models import flux_transformer as ft

    tpm.reset_counts()
    out["forward"] = _probe_forward(model, SEED + 4).cpu()
    out["forward_collectives"] = dict(tpm.COUNTS)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _probe_forward(model, SEED + 4)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["forward_s"] = times
    x = torch.randn((2560, 3072), device="cuda").to(torch.bfloat16)   # a single block's all-reduce
    out["allreduce_ms"] = time_ms(lambda: dist.all_reduce(x), runs=5, warmups=1)
    real = ft.region_out
    ft.region_out = lambda y, mesh: y
    try:
        out["fault_forward"] = _probe_forward(model, SEED + 4).cpu()
    finally:
        ft.region_out = real

    # int8: each rank quantises its shard, a row shard with the whole layer's scales
    quantize_module_(model.transformer)
    torch.cuda.synchronize()
    reset_all_counts()
    out["int8_forward"] = _probe_forward(model, SEED + 4).cpu()
    out["int8_launches"] = i8.LAUNCHES
    out["int8_linears"] = sum(1 for m in model.transformer.modules() if isinstance(m, QLinear))
    del model, server
    torch.cuda.empty_cache()
    out.update(_tp_lora(rank, tp, vae_cfg))
    dist.barrier()
    dist.destroy_process_group()
    return out


def _tp_lora(rank: int, tp, vae_cfg) -> dict:
    """One `make_lora_train_step` step of one 512^2 pair at tensor_parallel 2
    over a full-width transformer of TP_LORA_DEPTH blocks with non-zero
    biases, rank-128 adapters (B non-zero); rank 0 holds the summed adapter
    gradients against the same model unsharded, and against each planted
    fault's."""
    import torch.distributed as dist

    from ragb_vae_tpu_torch.models import flux_transformer as ft
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig, QLinear
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.parallel import tensor_parallel as tpm
    from ragb_vae_tpu_torch.parallel.mesh import Mesh
    from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import make_lora_optimizer, make_lora_train_step

    cfg = FluxTransformerConfig(num_layers=TP_LORA_DEPTH[0], num_single_layers=TP_LORA_DEPTH[1])
    rng = np.random.default_rng(SEED + 11)
    pair = {k: torch.from_numpy(rng.uniform(size=(1, 512, 512, 4)).astype(np.float32)) for k in ("gt", "text_alpha")}

    def build(mesh):
        m = FluxTextAlphaModel.random(cfg, vae_cfg, seed=SEED + 10, device="cuda", dtype=torch.bfloat16, fused=True,
                                      lora_rank=LORA_CONFIG["rank"], lora_alpha=float(LORA_CONFIG["lora_alpha"]),
                                      use_gradient_checkpointing=True, tp=mesh)
        gen = torch.Generator("cuda").manual_seed(SEED + 12)
        with torch.no_grad():
            for mod in m.transformer.modules():
                if isinstance(mod, QLinear) and mod.bias is not None:
                    full = torch.empty(mod.out_features, device="cuda", dtype=mod.bias.dtype)
                    mod.bias.copy_(mod.shard_of("bias", full.normal_(0.0, 0.1, generator=gen)))
            for name, p in lora_parameters(m.transformer).items():
                if name.endswith("lora_B"):
                    p.normal_(0.0, 0.01, generator=gen)
        return m

    def grads_of(m, mesh):
        params = lora_parameters(m.transformer)
        loss, _ = m.compute_loss(pair["gt"], pair["text_alpha"], torch.Generator("cuda").manual_seed(SEED + 13))
        loss.backward()
        tpm.sum_grads_over(list(params.values()), mesh)
        return loss.item(), {n: p.grad.detach().float().cpu() for n, p in params.items()}

    def held(got: dict, want: dict) -> tuple:
        """(worst leaf's relative error, its name, worst cosine, its name)."""
        rel = max((_tracks(got[n], want[n])[0], n) for n in want)
        cos = min((_tracks(got[n], want[n])[1], n) for n in want)
        return (*rel, *cos)

    out: dict = {}
    if rank == 0:
        whole = build(Mesh())
        out["lora_ref_loss"], ref = grads_of(whole, Mesh())
        del whole
        torch.cuda.empty_cache()
    dist.barrier()

    # the sound step, through make_lora_train_step with ZeroAdamW
    model = build(tp)
    params = lora_parameters(model.transformer)
    optimizer = ZeroAdamW(make_lora_optimizer(list(params.values()), LORA_CONFIG["learning_rate"],
                                              betas=(LORA_CONFIG["adam_beta1"], LORA_CONFIG["adam_beta2"]),
                                              weight_decay=LORA_CONFIG["weight_decay"],
                                              max_grad_norm=LORA_CONFIG["max_grad_norm"]), Mesh())
    summed, real_step = {}, optimizer.step

    def recording_step(*args, **kwargs):
        summed.update({n: p.grad.detach().float().cpu() for n, p in params.items()})
        return real_step(*args, **kwargs)

    optimizer.step = recording_step
    heads, real_attention = set(), ft.attention

    def attention(q, k, v, **kw):
        heads.add(q.shape[1])
        return real_attention(q, k, v, **kw)

    step = make_lora_train_step(model, optimizer, 1, mesh=Mesh(), model_mesh=tp)
    reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    ft.attention = attention
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grad_norm = step(pair, torch.Generator("cuda").manual_seed(SEED + 13))
        torch.cuda.synchronize()
        out["lora_step_s"] = time.perf_counter() - t0
    finally:
        ft.attention = real_attention
    out["lora_peak"] = torch.cuda.max_memory_allocated()
    out["lora_launches"] = {"flash_attention_fwd": fa.LAUNCHES, "flash_attention_dq": fa.DQ_LAUNCHES,
                            "flash_attention_dkv": fa.DKV_LAUNCHES, "resnet_conv3x3_stats": rb.CONV_LAUNCHES}
    out["lora_heads"], out["lora_loss"], out["lora_grad_norm"] = sorted(heads), loss.item(), grad_norm.item()
    flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
    parts = [torch.empty_like(flat) for _ in range(TP)]
    dist.all_gather(parts, flat)
    out["lora_replicas_equal"] = all(torch.equal(parts[0], q) for q in parts[1:])
    if rank == 0:
        out["lora_held"] = held(summed, ref)
    del model, optimizer, step, summed
    torch.cuda.empty_cache()

    # the planted faults, each on a model built with it
    real_shard_ranges, real_finish = tpm.shard_ranges, QLinear.finish

    def contiguous(name, kind, full, dim, size, rank_):
        per = full // size
        return ((rank_ * per, per),)

    def bias_twice(self, y):
        y = real_finish(self, y)
        return y if self.tp_kind != "row" or self.bias is None else (y.float() + self.bias.float()).to(y.dtype)

    faults = {"row all-reduce dropped": (ft, "region_out", lambda y, mesh: y),
              "row bias added twice": (QLinear, "finish", bias_twice),
              "proj_out rows in JAX's contiguous order": (tpm, "shard_ranges", contiguous)}
    out["lora_faults"] = {}
    for label, (owner, attr, fn) in faults.items():
        real = getattr(owner, attr)
        setattr(owner, attr, fn)
        try:
            _, got = grads_of(build(tp), tp)
        finally:
            setattr(owner, attr, real)
        if rank == 0:
            out["lora_faults"][label] = held(got, ref)
        torch.cuda.empty_cache()
    assert tpm.shard_ranges is real_shard_ranges and QLinear.finish is real_finish
    return out


def phase_tp(refs: dict, work: Path) -> dict:
    """Two ranks on the card (`_tp_rank`), then their results held against
    the slice and int8 phases' answers in `refs`. -> launch counts of both."""
    import multiprocessing

    torch.save(refs, work / "tp_refs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tp_child, args=(r, str(work)), name=f"tp-rank-{r}") for r in range(TP)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_JOIN_SECONDS
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(work / f"tp_error_{r}.txt") for r in range(TP)]
    messages = [f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errors) if e.exists()]
    if hung or messages or any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"[tp] ranks still running {hung}, exit codes {[p.exitcode for p in procs]}\n"
                         + "\n".join(messages))
    res = [torch.load(work / f"tp_result_{r}.pt", weights_only=False) for r in range(TP)]
    r0 = res[0]
    ok = True
    for r, x in enumerate(res):
        log("tp", f"rank {r}: built its shard in {x['build_s']:.1f} s; transformer {x['transformer_bytes'] / 1e9:.2f} GB; "
            f"resident {x['resident'] / 2**30:.2f} GiB, serving peak {x['serve_peak'] / 2**30:.2f} GiB, LoRA peak "
            f"{x['lora_peak'] / 2**30:.2f} GiB (the slice phase's whole model: resident {refs['resident'] / 2**30:.2f} "
            f"GiB, serving peak {refs['peak'] / 2**30:.2f} GiB)")
    fwd = r0["forward_collectives"]
    want_fwd = {"all_reduce": 4 * 19 + 38 + 3, "all_gather": 2 * 19 + 38 + 1}
    ok &= fwd == want_fwd and all(x["forward_collectives"] == fwd for x in res)
    log("tp", f"one transformer forward at 512^2 (b1): {fwd['all_reduce']} all-reduces and {fwd['all_gather']} "
        f"all-gathers per rank (the plan: {want_fwd}); serving's 4-step request made {r0['serve_collectives']}; "
        f"gloo through host memory (not NCCL): one bf16 all-reduce of (2560, 3072) {r0['allreduce_ms']:.3f} ms; "
        f"forward {', '.join(f'{t:.3f}' for t in r0['forward_s'])} s (s/step); request {r0['request_s']:.3f} s "
        f"for {SERVE_STEPS} steps; rank 1 ran {res[1]['batches']} batch(es)")
    answer = _tracks(torch.from_numpy(r0["answer"]), torch.from_numpy(refs["answer"]))
    err = float(np.abs(r0["answer"] - refs["answer"]).max())
    forward = _tracks(r0["forward"], refs["forward"])
    fault = _tracks(r0["fault_forward"], refs["forward"])
    int8 = _tracks(r0["int8_forward"], refs["int8_forward"])
    same = torch.equal(res[0]["forward"], res[1]["forward"]) and torch.equal(res[0]["int8_forward"], res[1]["int8_forward"])
    checks = [
        (f"served 512^2 answer vs the slice phase's: relative error {answer[0]:.5f} cosine {answer[1]:.6f} "
         f"max abs {err:.4f}", _within(answer, TP_ANSWER_TOL), TP_ANSWER_TOL),
        (f"bf16 forward vs the slice phase's: relative error {forward[0]:.5f} cosine {forward[1]:.6f}",
         _within(forward, TP_FORWARD_TOL), TP_FORWARD_TOL),
        (f"planted fault (row all-reduce dropped) forward: relative error {fault[0]:.4f} cosine {fault[1]:.5f}, "
         "must fail", not _within(fault, TP_FORWARD_TOL), TP_FORWARD_TOL),
        (f"int8 forward vs the int8 phase's: relative error {int8[0]:.5f} cosine {int8[1]:.6f}; K10 launched "
         f"{r0['int8_launches']} times for {r0['int8_linears']} linears",
         _within(int8, TP_INT8_TOL) and r0["int8_launches"] == r0["int8_linears"], TP_INT8_TOL),
        ("both ranks' forwards (bf16 and int8) bit for bit equal", same, None),
    ]
    lora_ok = (r0["lora_heads"] == [24 // TP] and r0["lora_replicas_equal"] and res[1]["lora_replicas_equal"]
               and all(n > 0 for n in r0["lora_launches"].values()))
    checks.append((f"LoRA step ({TP_LORA_DEPTH[0]} + {TP_LORA_DEPTH[1]} blocks at full width, one 512^2 pair): loss "
                   f"{r0['lora_loss']:.6f} (unsharded {r0['lora_ref_loss']:.6f}) grad_norm {r0['lora_grad_norm']:.4f} "
                   f"in {r0['lora_step_s']:.2f} s; attention heads {r0['lora_heads']}; launches {r0['lora_launches']}; "
                   f"adapters bit for bit equal on both ranks after the update: {r0['lora_replicas_equal']}",
                   lora_ok, None))
    rel, rel_at, cos, cos_at = r0["lora_held"]
    checks.append((f"summed adapter gradients vs the unsharded model's: worst relative error {rel:.4f} ({rel_at}), "
                   f"worst cosine {cos:.5f} ({cos_at})", _within((rel, cos), TP_GRAD_TOL), TP_GRAD_TOL))
    for label, (rel, rel_at, cos, cos_at) in r0["lora_faults"].items():
        checks.append((f"planted fault ({label}) gradients: worst relative error {rel:.4f} ({rel_at}), worst cosine "
                       f"{cos:.5f}, must fail", not _within((rel, cos), TP_GRAD_TOL), TP_GRAD_TOL))
    for text, fine, tol in checks:
        ok &= fine
        log("tp", f"{text}{'' if tol is None else f' (bound <= {tol[0]}, >= {tol[1]})'} {'ok' if fine else 'FAIL'}")
    if not ok:
        raise SystemExit("[tp] the tensor-parallel run disagrees with the whole model's, or a planted fault passed")
    counts: dict = {}
    for x in res:
        for part in (x["serve_launches"], x["lora_launches"], {"int8_matmul": x["int8_launches"]}):
            for k, n in part.items():
                counts[k] = counts.get(k, 0) + n
    return counts


# ---------------------------------------------------------------------------
# phase 11: the LoRA stage's FSDP and sequence-parallel axes
# ---------------------------------------------------------------------------
# Two ranks on the one card in a gloo group, as the tp phase (NCCL refuses two
# ranks on one device; the collectives go through host memory and their times
# are gloo's). Both axes run on a full-width FLUX.1-Kontext transformer cut to
# AXES_DEPTH blocks, rank-128 adapters with B non-zero, drawn from one seed:
#
# - FSDP at data 2: each rank draws only its part of the frozen base
#   (`random(fsdp=)`), takes one `make_lora_train_step` step of its own 512^2
#   pair (ZeroAdamW over the data group), and the mean of the two ranks'
#   adapter gradients is held against the whole model's over both pairs with
#   the same noise. An int8 base drawn the same way runs one forward through
#   K10 on gathered weights, held against the whole int8 model's.
# - SP 2: both ranks hold the whole model and take one step on one 512^2 pair
#   with the streams split: K3 runs at 1280 queries x 2560 gathered keys, K4
#   and K5 at the same shapes; the summed adapter gradients are held against
#   the unsharded run, and a 4-step sample against the whole model's.
# - Four planted faults must fail the gradients' bound: dK / dV kept local
#   instead of summed over the ranks, the prediction's gather summing its
#   gradient (every adapter gradient doubled), the RoPE ids cut strided while
#   the tokens are cut contiguous, and FSDP's shards concatenated in reversed
#   rank order. (Rank 0's ids on both ranks cannot show at sp 2: the cond and
#   target halves of the image stream share one id grid and the prompt's ids
#   are all zero, so the two ranks' ids are equal.)
#
# The sound runs differ from the whole model in rounding only: FSDP gathers
# the weights exactly, and SP keeps each token's sums (the keys are gathered
# back into the unsharded order) except that dK and dV add two ranks' partial
# sums, in bf16 at the gather's reduce.
AXES_DEPTH = TP_LORA_DEPTH             # double and single blocks (full width)
AXES_SEED = SEED + 20
AXES_GRAD_TOL = TP_GRAD_TOL            # the tp phase's bound: worst leaf's relative error, cosine
AXES_SAMPLE_TOL = TP_ANSWER_TOL        # the 4-step sample vs the whole model's
AXES_INT8_TOL = (1e-3, 0.99999)        # the int8 FSDP forward vs the whole int8 model's
AXES_JOIN_SECONDS = 600


def _axes_child(rank: int, work: str) -> None:
    """One rank of the axes phase: its results, or its traceback, into `work`."""
    import traceback

    try:
        torch.save(_axes_rank(rank, Path(work)), Path(work) / f"axes_result_{rank}.pt")
    except BaseException:
        (Path(work) / f"axes_error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _axes_rank(rank: int, work: Path) -> dict:
    import torch.distributed as dist

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.parallel import fsdp as fsdpm
    from ragb_vae_tpu_torch.parallel import sequence_parallel as spm
    from ragb_vae_tpu_torch.parallel.mesh import Mesh, create_training_mesh
    from ragb_vae_tpu_torch.parallel.tensor_parallel import sum_grads_over
    from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import make_lora_optimizer, make_lora_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{work / 'axes_rendezvous'}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=AXES_JOIN_SECONDS))
    data, _, _ = create_training_mesh()            # the data axis: both ranks
    _, _, seq = create_training_mesh(sp=2)         # the sequence axis: both ranks
    cfg = FluxTransformerConfig(num_layers=AXES_DEPTH[0], num_single_layers=AXES_DEPTH[1])
    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    rng = np.random.default_rng(SEED + 21)
    pairs = {k: torch.from_numpy(rng.uniform(size=(2, 512, 512, 4)).astype(np.float32)) for k in ("gt", "text_alpha")}
    out: dict = {}

    def build(**kw):
        t0 = time.perf_counter()
        m = FluxTextAlphaModel.random(cfg, vae_cfg, seed=AXES_SEED, device="cuda", dtype=torch.bfloat16, fused=True,
                                      lora_rank=LORA_CONFIG["rank"], lora_alpha=float(LORA_CONFIG["lora_alpha"]),
                                      use_gradient_checkpointing=True, **kw)
        gen = torch.Generator("cuda").manual_seed(SEED + 22)
        with torch.no_grad():
            for name, p in lora_parameters(m.transformer).items():
                if name.endswith("lora_B"):
                    p.normal_(0.0, 0.01, generator=gen)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    def loss_of(m, rows, mesh=None):
        for p in lora_parameters(m.transformer).values():
            p.grad = None
        loss, _ = m.compute_loss(pairs["gt"][rows], pairs["text_alpha"][rows],
                                 torch.Generator("cuda").manual_seed(SEED + 23), mesh=mesh)
        loss.backward()
        return loss.detach()

    def grads(m) -> dict:
        return {n: p.grad.detach().float().cpu() for n, p in lora_parameters(m.transformer).items()}

    def data_mean(named: dict) -> dict:
        """The mean over the data axis of each rank's gradients (one all-reduce)."""
        flat = torch.cat([g.reshape(-1) for g in named.values()]).cuda()
        dist.all_reduce(flat)
        flat = (flat / data.size).cpu()
        got, start = {}, 0
        for n, g in named.items():
            got[n] = flat[start : start + g.numel()].view(g.shape)
            start += g.numel()
        return got

    def held(got: dict, want: dict) -> tuple:
        rel = max((_tracks(got[n], want[n])[0], n) for n in want)
        cos = min((_tracks(got[n], want[n])[1], n) for n in want)
        return (*rel, *cos)

    def sp_grads(m) -> dict:
        loss_of(m, slice(0, 1))
        sum_grads_over(list(lora_parameters(m.transformer).values()), seq)
        return grads(m)

    # the whole model on both ranks: the references (rank 0), then SP over it
    model, out["whole_build_s"] = build()
    out["whole_resident"] = torch.cuda.memory_allocated()
    out["whole_bytes"] = fsdpm.shard_bytes(model.transformer)
    if rank == 0:
        ref_loss_a = loss_of(model, slice(0, 1)).item()
        ref_a = grads(model)
        out["ref_loss_ab"] = loss_of(model, slice(0, 2)).item()
        ref_ab = grads(model)
    dist.barrier()

    # planted SP faults, each on the sound model's adapters (before its step)
    real_gather_bwd, real_out_bwd, real_local = spm._GatherSeq.backward, spm._GatherOut.backward, spm.local_part

    def dkv_local(ctx, g):
        return spm._reshard(g, ctx.dim, ctx.segments, ctx.mesh.size)[ctx.mesh.rank].contiguous(), None, None, None

    def pred_summed(ctx, g):
        return spm._reduce_scatter(spm._reshard(g, ctx.dim, (ctx.length,), ctx.mesh.size), ctx.mesh), None, None

    def ids_strided(t, mesh, dim=1):
        return t[mesh.rank :: mesh.size] if dim == 0 else real_local(t, mesh, dim)

    sp_faults = {"dK / dV kept local, not summed over the ranks": (spm._GatherSeq, "backward", staticmethod(dkv_local)),
                 "the prediction's gather summing its gradient": (spm._GatherOut, "backward",
                                                                  staticmethod(pred_summed)),
                 "RoPE ids cut strided, the tokens contiguous": (spm, "local_part", ids_strided)}
    model.seq = seq
    out["faults"] = {}
    for label, (owner, attr, fn) in sp_faults.items():
        real = owner.__dict__[attr]
        setattr(owner, attr, fn)
        try:
            got = sp_grads(model)
        finally:
            setattr(owner, attr, real)
        if rank == 0:
            out["faults"][label] = held(got, ref_a)
    assert (spm._GatherSeq.backward, spm._GatherOut.backward, spm.local_part) == (
        real_gather_bwd, real_out_bwd, real_local)

    # the sound SP step through make_lora_train_step
    params = lora_parameters(model.transformer)
    optimizer = ZeroAdamW(make_lora_optimizer(list(params.values()), LORA_CONFIG["learning_rate"],
                                              betas=(LORA_CONFIG["adam_beta1"], LORA_CONFIG["adam_beta2"]),
                                              weight_decay=LORA_CONFIG["weight_decay"],
                                              max_grad_norm=LORA_CONFIG["max_grad_norm"]), Mesh())
    summed, real_step = {}, optimizer.step

    def recording_step(*args, **kwargs):
        summed.update(grads(model))
        return real_step(*args, **kwargs)

    optimizer.step = recording_step
    shapes, real_fwd, real_bwd = set(), fa.flash_attention_cuda, fa.flash_attention_bwd_cuda

    def fwd(q, k, v, **kw):
        shapes.add(("K3", tuple(q.shape), k.shape[1]))
        return real_fwd(q, k, v, **kw)

    def bwd(q, k, v, o, lse, g, **kw):
        shapes.add(("K4 + K5", tuple(q.shape), k.shape[1]))
        return real_bwd(q, k, v, o, lse, g, **kw)

    step = make_lora_train_step(model, optimizer, 1, mesh=Mesh(), seq_mesh=seq)
    reset_all_counts()
    spm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = fwd, bwd
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = step({k: v[0:1] for k, v in pairs.items()}, torch.Generator("cuda").manual_seed(SEED + 23))
        torch.cuda.synchronize()
        out["sp_step_s"] = time.perf_counter() - t0
    finally:
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = real_fwd, real_bwd
    out["sp_peak"] = torch.cuda.max_memory_allocated()
    out["sp_launches"] = _lora_counts()
    out["sp_collectives"] = dict(spm.COUNTS)
    out["sp_shapes"] = sorted(x for x in shapes if x[1][-1] == 128)
    out["sp_loss"] = loss.item()
    if rank == 0:
        out["ref_loss_a"] = ref_loss_a
        out["sp_held"] = held(summed, ref_a)

    # a 4-step sample split over the sequence axis, and the whole model's
    def sample(m):
        return m.sample(pairs["gt"][0:1], num_inference_steps=SERVE_STEPS,
                        generator=torch.Generator("cuda").manual_seed(SEED + 24)).cpu()

    spm.reset_counts()
    out["sp_sample"] = sample(model)
    out["sp_sample_gathers"] = spm.COUNTS["all_gather"]
    if rank == 0:
        model.seq = Mesh()
        out["whole_sample"] = sample(model)
    del model, optimizer, step, summed
    torch.cuda.empty_cache()
    dist.barrier()

    # FSDP at data 2: each rank draws only its part of the base
    model, out["fsdp_build_s"] = build(fsdp=data)
    out["fsdp_resident"] = torch.cuda.memory_allocated()
    out["fsdp_bytes"] = fsdpm.shard_bytes(model.transformer)
    mine = slice(rank, rank + 1)

    class Reversed:
        """`torch.distributed` with all_gather's list in reversed rank order."""

        def __getattr__(self, name):
            return getattr(dist, name)

        @staticmethod
        def all_gather(parts, t, group=None):
            dist.all_gather(parts, t, group=group)
            parts.reverse()

    fsdpm.dist = Reversed()
    try:
        loss_of(model, mine, data)
        got = data_mean(grads(model))
    finally:
        fsdpm.dist = dist
    if rank == 0:
        out["faults"]["FSDP shards gathered in reversed rank order"] = held(got, ref_ab)

    params = lora_parameters(model.transformer)
    optimizer = ZeroAdamW(make_lora_optimizer(list(params.values()), LORA_CONFIG["learning_rate"],
                                              betas=(LORA_CONFIG["adam_beta1"], LORA_CONFIG["adam_beta2"]),
                                              weight_decay=LORA_CONFIG["weight_decay"],
                                              max_grad_norm=LORA_CONFIG["max_grad_norm"]), data)
    local, real_step = {}, optimizer.step

    def recording_step(*args, **kwargs):
        local.update(grads(model))
        return real_step(*args, **kwargs)

    optimizer.step = recording_step
    step = make_lora_train_step(model, optimizer, 1, mesh=data)
    reset_all_counts()
    fsdpm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, _ = step({k: v[mine] for k, v in pairs.items()}, torch.Generator("cuda").manual_seed(SEED + 23))
    torch.cuda.synchronize()
    out["fsdp_step_s"] = time.perf_counter() - t0
    out["fsdp_peak"] = torch.cuda.max_memory_allocated()
    out["fsdp_launches"] = _lora_counts()
    out["fsdp_collectives"] = dict(fsdpm.COUNTS)
    out["fsdp_loss"] = loss.item()
    mean = data_mean(local)
    if rank == 0:
        out["fsdp_held"] = held(mean, ref_ab)
    del model, optimizer, step
    torch.cuda.empty_cache()

    # an int8 base drawn split, one forward through K10 on gathered weights
    def build_int8(**kw):
        return FluxTextAlphaModel.random(cfg, vae_cfg, seed=AXES_SEED, device="cuda", dtype=torch.bfloat16,
                                         fused=True, weight_quant="int8", **kw)

    model = build_int8(fsdp=data)
    reset_all_counts()
    fsdpm.reset_counts()
    out["int8_forward"] = _probe_forward(model, SEED + 25).cpu()
    out["int8_launches"] = i8.LAUNCHES
    out["int8_gathers"] = dict(fsdpm.COUNTS)
    del model
    torch.cuda.empty_cache()
    if rank == 0:
        whole = build_int8()
        out["int8_whole_forward"] = _probe_forward(whole, SEED + 25).cpu()
        del whole
        torch.cuda.empty_cache()
        # a rank's part of the full-depth FLUX.1-Kontext base, from the plan alone
        plans = {}
        for n in (1, 2, 4, 8):
            meta = FluxTransformer2D(FluxTransformerConfig(), device="meta", dtype=torch.bfloat16)
            plans[n] = fsdpm.shard_bytes(fsdpm.shard_base_(meta, Mesh(n, 0)))
        out["plans"] = plans
    dist.barrier()
    dist.destroy_process_group()
    return out


def phase_axes(work: Path) -> dict:
    """Two ranks on the card (`_axes_rank`), their results held against the
    whole model's. -> launch counts of both."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_axes_child, args=(r, str(work)), name=f"axes-rank-{r}") for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + AXES_JOIN_SECONDS
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(work / f"axes_error_{r}.txt") for r in range(2)]
    messages = [f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errors) if e.exists()]
    if hung or messages or any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"[axes] ranks still running {hung}, exit codes {[p.exitcode for p in procs]}\n"
                         + "\n".join(messages))
    res = [torch.load(work / f"axes_result_{r}.pt", weights_only=False) for r in range(2)]
    r0 = res[0]
    gib = 2**30
    for r, x in enumerate(res):
        log("axes", f"rank {r}: whole {AXES_DEPTH[0]} + {AXES_DEPTH[1]} block model built in {x['whole_build_s']:.1f} s, "
            f"resident {x['whole_resident'] / gib:.3f} GiB, SP step peak {x['sp_peak'] / gib:.3f} GiB; FSDP part built "
            f"in {x['fsdp_build_s']:.1f} s, resident {x['fsdp_resident'] / gib:.3f} GiB, step peak "
            f"{x['fsdp_peak'] / gib:.3f} GiB; base held: split {x['fsdp_bytes']['split'] / gib:.3f} GiB, whole "
            f"{x['fsdp_bytes']['whole'] / gib:.3f} GiB, adapters {x['fsdp_bytes']['adapters'] / gib:.3f} GiB")
    whole = r0["plans"][1]["whole"]
    log("axes", "full-depth FLUX.1-Kontext transformer (bf16, fp32 AdaLN), a rank's base by the plan: " + "; ".join(
        f"data {n}: {p['split'] / gib:.3f} GiB split + {p['whole'] / gib:.3f} GiB whole" for n, p in r0["plans"].items()
        if n > 1) + f" (whole: {whole / gib:.3f} GiB)")
    fwd_gathers = 2 * sum(AXES_DEPTH) + 1
    log("axes", f"SP step: {r0['sp_collectives']} sequence collectives (a forward {fwd_gathers} all-gathers, the "
        f"recompute {2 * sum(AXES_DEPTH)} more, {2 * sum(AXES_DEPTH)} reduce-scatters of dK / dV), launches "
        f"{r0['sp_launches']}, {r0['sp_step_s']:.2f} s; kernels at {r0['sp_shapes']}; FSDP step: "
        f"{r0['fsdp_collectives']['all_gather']} all-gathers of {r0['fsdp_collectives']['gathered_bytes'] / gib:.3f} "
        f"GiB, launches {r0['fsdp_launches']}, {r0['fsdp_step_s']:.2f} s (gloo through host memory, not NCCL)")
    ok = True
    sample = _tracks(r0["sp_sample"], r0["whole_sample"])
    int8 = _tracks(r0["int8_forward"], r0["int8_whole_forward"])
    want_shapes = {("K3", (24, 1280, 128), 2560), ("K4 + K5", (24, 1280, 128), 2560)}
    rel, rel_at, cos, cos_at = r0["sp_held"]
    frel, frel_at, fcos, fcos_at = r0["fsdp_held"]
    checks = [
        (f"SP 2 step on one 512^2 pair: loss {r0['sp_loss']:.6f} (unsharded {r0['ref_loss_a']:.6f}); summed adapter "
         f"gradients vs the unsharded model's: worst relative error {rel:.4f} ({rel_at}), worst cosine {cos:.5f} "
         f"({cos_at})", _within((rel, cos), AXES_GRAD_TOL), AXES_GRAD_TOL),
        (f"K3 and K4 + K5 ran at the shard's shapes {sorted(want_shapes)} and launched "
         f"{r0['sp_launches']}", set(r0["sp_shapes"]) == want_shapes and all(
             r0["sp_launches"][k] > 0 for k in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"))
         and r0["sp_collectives"] == {"all_gather": fwd_gathers + 2 * sum(AXES_DEPTH),
                                      "reduce_scatter": 2 * sum(AXES_DEPTH)}, None),
        (f"SP 2 {SERVE_STEPS}-step sample vs the whole model's: relative error {sample[0]:.5f} cosine "
         f"{sample[1]:.6f}; {r0['sp_sample_gathers']} all-gathers ({fwd_gathers} a forward)",
         _within(sample, AXES_SAMPLE_TOL) and torch.equal(res[0]["sp_sample"], res[1]["sp_sample"])
         and r0["sp_sample_gathers"] == SERVE_STEPS * fwd_gathers, AXES_SAMPLE_TOL),
        (f"FSDP data 2 step, one 512^2 pair a rank: loss {r0['fsdp_loss']:.6f} (whole model over both "
         f"{r0['ref_loss_ab']:.6f}); mean adapter gradients vs the whole model's: worst relative error {frel:.4f} "
         f"({frel_at}), worst cosine {fcos:.5f} ({fcos_at})", _within((frel, fcos), AXES_GRAD_TOL), AXES_GRAD_TOL),
        (f"FSDP int8 forward on gathered weights vs the whole int8 model's: relative error {int8[0]:.3g} cosine "
         f"{int8[1]:.7f} (bit for bit: {torch.equal(r0['int8_forward'], r0['int8_whole_forward'])}); K10 launched "
         f"{r0['int8_launches']} times; {r0['int8_gathers']['all_gather']} all-gathers of "
         f"{r0['int8_gathers']['gathered_bytes'] / gib:.3f} GiB",
         _within(int8, AXES_INT8_TOL) and r0["int8_launches"] > 0, AXES_INT8_TOL),
        ("each rank holds at most half of the base plus the leaves kept whole: " + ", ".join(
            f"{(x['fsdp_bytes']['split'] + x['fsdp_bytes']['whole']) / gib:.3f}" for x in res)
         + f" GiB of the whole model's {r0['whole_bytes']['whole'] / gib:.3f} GiB",
         all(2 * x["fsdp_bytes"]["split"] <= r0["whole_bytes"]["whole"] - x["fsdp_bytes"]["whole"] for x in res),
         None),
    ]
    for label, (frel, frel_at, fcos, _) in r0["faults"].items():
        checks.append((f"planted fault ({label}) gradients: worst relative error {frel:.4f} ({frel_at}), worst cosine "
                       f"{fcos:.5f}, must fail", not _within((frel, fcos), AXES_GRAD_TOL), AXES_GRAD_TOL))
    ok &= len(r0["faults"]) == 4
    for text, fine, tol in checks:
        ok &= fine
        log("axes", f"{text}{'' if tol is None else f' (bound <= {tol[0]}, >= {tol[1]})'} {'ok' if fine else 'FAIL'}")
    if not ok:
        raise SystemExit("[axes] an axis disagrees with the whole model, or a planted fault passed")
    counts: dict = {}
    for x in res:
        for part in (x["sp_launches"], x["fsdp_launches"], {"int8_matmul": x["int8_launches"]}):
            for k, n in part.items():
                counts[k] = counts.get(k, 0) + n
    return counts


# ---------------------------------------------------------------------------
# phase 9: the stage-1 loop at full width, every resnet conv through K8
# ---------------------------------------------------------------------------
# Before the loop: one forward of the stage's model (encode, posterior mode,
# decode) on a fixed batch at 512^2 through the Winograd route, the direct
# route and the plain route in fp32 (unfused, fp32 compute, the attention's
# plain version): the same function, rounded differently. K8 rounds the
# transformed input and weights to bf16 on top of what K1 rounds, and a
# random-init VAE carries every conv's bf16 rounding through ~60 layers: on an
# H100 the Winograd and direct decoder outputs read 0.058 relative error,
# cosine 0.9983 (PERF.md). So each bf16 route is held against the fp32 one,
# and the Winograd route's distance to either reference against the direct
# route's own distance to fp32 (the noise floor of this model in bf16): at
# most STAGE1_NOISE_RATIO times it. On the card the sound route reads 1.27x
# (vs fp32) and 1.34x (vs direct) the floor; a variant's product left out
# 27.9x, a transform sign flipped 24.7x, both at cosines of 0.25-0.40. An
# extra bf16 rounding of the products reads 1.40x: too close to the sound
# route to be told apart here; phase 3's WINO_Y_PLAIN_NORM_TOL is its check.
STAGE1_NOISE_RATIO = 2.0
STAGE1_RECON_COS_TOL = 0.99
STAGE1_STEPS = 2


def _write_stage1_tree(root: Path) -> None:
    """A components tree (the schema prepare_rgba_buckets writes): two
    (component, composite) RGBA pairs in a train bucket w512-h512 and two in a
    val bucket w768-h512, smooth colour fields from a seed."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 7)
    manifest = []
    for split, bucket, (w, h) in (("train", "w512-h512", (512, 512)), ("val", "w768-h512", (768, 512))):
        for i in range(2):
            rels = {kind: f"{split}/{bucket}/pair{i}_{kind}.png" for kind in ("component", "composite")}
            for rel in rels.values():
                (root / rel).parent.mkdir(parents=True, exist_ok=True)
                low = rng.uniform(size=(8, 12, 4)).astype(np.float32)
                Image.fromarray((low * 255).astype(np.uint8), mode="RGBA").resize((w, h), resample=3).save(root / rel)
            manifest.append({"split": split, "bucket": bucket, "bucket_dims": [w, h],
                             "component_path": rels["component"], "composite_path": rels["composite"],
                             "source_sample": f"pair{i}", "component_index": 0, "original_size": [w, h]})
    (root / "metadata").mkdir(parents=True)
    (root / "metadata" / "manifest.json").write_text(json.dumps(manifest))


def _stage1_config(work: Path) -> dict:
    """configs/flux_vae.yaml, overlaid in memory: the seeded random RGB `ae`
    checkpoint, seeded LPIPS weights, the PNG tree in `work`, 512-pixel tiles
    (the 768 x 512 validation images go through the tiled encode and decode),
    batch 2, 2 steps, everything logged, saved and validated at step 2."""
    from ragb_vae_tpu_torch.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / "configs" / "flux_vae.yaml")
    data = work / "data"
    cfg["data"].update(bucket_root=str(data), batch_size=2, num_workers=4, bucket_datasets=[
        {"type": "components", "root": str(data), "manifest": str(data / "metadata" / "manifest.json")}])
    cfg["training"].update(
        ckpt_dir=str(work / "ckpt"), max_steps=STAGE1_STEPS, log_every=1, ckpt_every_steps=2, val_every_steps=2,
        val_max_batches=1, val_output_dir=str(work / "val"), sample_vis_dir=str(work / "vis"),
        lpips_weights=str(work / "lpips.pt"), vae_tile_sample_size=512)
    cfg["model"]["rgb_checkpoint"] = str(work / "ae_rgb")
    return cfg


def _stage1_assets(work: Path) -> None:
    """The RGB FLUX `ae` (torch's default init from SEED) and VGG16 LPIPS
    weights (`random_lpips(SEED)`) in the files a user would point the config
    at, and the PNG tree."""
    from ragb_vae_tpu_torch.models.lpips import random_lpips
    from ragb_vae_tpu_torch.models.vae import AutoencoderKL
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    cfg = AutoencoderConfig.flux()
    torch.manual_seed(SEED)
    save_autoencoder_params(cfg, AutoencoderKL(cfg, device="cuda").state_dict(), work / "ae_rgb")
    state = {}
    for name, value in random_lpips(SEED).state_dict().items():
        if name.startswith("conv"):                 # conv{idx}_{weight,bias} -> the vgg Sequential key
            idx, kind = name[4:].split("_")
            state[f"features.{idx}.{kind}"] = value
        elif name.startswith("lin"):
            state[f"{name}.model.1.weight"] = value.reshape(1, -1, 1, 1)
    torch.save(state, work / "lpips.pt")
    _write_stage1_tree(work / "data")


def _routes_agree(cfg: dict) -> None:
    """One forward of the stage's model through the Winograd, the direct and
    the plain fp32 route, same weights and batch."""
    from ragb_vae_tpu_torch.models import vae as vae_module
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE

    model = RgbaVAE.from_pretrained_rgb(cfg["model"]["rgb_checkpoint"], "", dtype=torch.float32,
                                        compute_dtype=torch.bfloat16, device="cuda")
    model.enable_fused()
    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    x = torch.rand((1, 512, 512, 4), generator=gen, device="cuda") * 2.0 - 1.0
    outs = {}

    def attention_fp32(q, k, v):
        b, h, n, d = q.shape
        return fa.attention_plain(*(t.reshape(b * h, n, d) for t in (q, k, v)),
                                  sm_scale=1.0 / math.sqrt(d)).reshape(b, h, n, d)

    with torch.no_grad():
        for algo in ("winograd", "direct"):
            rb.CONV_ALGO = algo
            reset_all_counts()
            outs[algo] = model.decode(model.encode(x).mode()).float().flatten()
            torch.cuda.synchronize()
            log("stage1", f"forward through the {algo} route: K8 {rb.WINO_LAUNCHES}, K1 {rb.CONV_LAUNCHES} launches")
            if (rb.WINO_LAUNCHES > 0) != (algo == "winograd") or (rb.CONV_LAUNCHES > 0) != (algo == "direct"):
                raise SystemExit(f"[stage1] the {algo} route did not take its own kernel")
        model.disable_fused()
        model.set_compute_dtype(torch.float32)
        vae_module.attention = attention_fp32
        try:
            outs["fp32"] = model.decode(model.encode(x).mode()).flatten()
        finally:
            vae_module.attention = fa.attention

    def distance(a, b):
        return ((outs[a] - outs[b]).norm() / outs[b].norm()).item(), \
            (torch.dot(outs[a], outs[b]) / (outs[a].norm() * outs[b].norm())).item()

    floor = distance("direct", "fp32")[0]
    ok = math.isfinite(floor)
    for a, b in (("winograd", "fp32"), ("winograd", "direct"), ("direct", "fp32")):
        rel, cos = distance(a, b)
        held = a == "winograd"
        fine = not held or (rel <= STAGE1_NOISE_RATIO * floor and cos >= STAGE1_RECON_COS_TOL)
        ok &= fine
        log("stage1", f"decoder output at 512^2 b1, {a} vs {b} route: relative error {rel:.4g}, cosine {cos:.6f}"
            + (f", {rel / floor:.4g} x the noise floor {floor:.4g} (<= {STAGE1_NOISE_RATIO}; cosine >= "
               f"{STAGE1_RECON_COS_TOL}) {'ok' if fine else 'FAIL'}" if held else " (the noise floor)"))
    if not ok:
        raise SystemExit("[stage1] the Winograd route's reconstruction disagrees with the other routes'")


def _nccl_world1(work: Path) -> None:
    """Join a world-1 NCCL group through a FileStore in `work` (as the stage
    would under `torchrun --nproc_per_node 1`), and run NCCL's reduce-scatter,
    all-gather and all-reduce once on the card: the port's collectives return
    their input at world 1 without calling NCCL, so these are the calls they
    make at world 2 and up."""
    import torch.distributed as dist

    from ragb_vae_tpu_torch.parallel.mesh import create_mesh, maybe_init_distributed

    t0 = time.perf_counter()
    maybe_init_distributed("cuda", init_method=f"file://{work / 'rendezvous'}", world_size=1, rank=0,
                           timeout=datetime.timedelta(seconds=120))
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    scattered, gathered, total = torch.empty_like(x), torch.empty_like(x), x.sum()
    dist.reduce_scatter_tensor(scattered, x)
    dist.all_gather_into_tensor(gathered, x)
    dist.all_reduce(total, op=dist.ReduceOp.MAX)
    torch.cuda.synchronize()
    if not (torch.equal(scattered, x) and torch.equal(gathered, x) and total.item() == 28.0):
        raise SystemExit("[stage1] NCCL's collectives at world 1 returned wrong values")
    log("stage1", f"{dist.get_backend()} process group of world size {create_mesh().size} joined, its "
        f"reduce-scatter, all-gather and all-reduce checked on the card in {time.perf_counter() - t0:.1f} s")


def phase_stage1(work: Path) -> dict:
    """`run_stage` on configs/flux_vae.yaml at full FLUX `ae` width with
    `CONV_ALGO = "winograd"`: 2 steps, validation through the tiled path,
    saves, the step-2 checkpoint reloaded bit for bit, then `resume_from:
    auto` for step 3."""
    from ragb_vae_tpu_torch.training import checkpoint as ckpt_lib
    from ragb_vae_tpu_torch.training import rgba_vae_stage as stage
    from ragb_vae_tpu_torch.training import run_stage

    t0 = time.perf_counter()
    _stage1_assets(work)
    cfg = _stage1_config(work)
    log("stage1", f"wrote the random RGB ae checkpoint, LPIPS weights and the PNG tree in "
        f"{time.perf_counter() - t0:.1f} s")
    saved, step_ms, step_k8, fell_through, folded = {}, [], [], set(), []
    make_step, save, direct, fold = stage.make_train_step, stage.save_checkpoints, rb.conv3x3_stats_cuda, rb.wino_tiles

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(batch, **kw):
            torch.cuda.synchronize()
            t, k8 = time.perf_counter(), rb.WINO_LAUNCHES
            out = step(batch, **kw)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            step_k8.append(rb.WINO_LAUNCHES - k8)
            return out
        return timed

    def keep_saved(model, cfg_, *, step=None, **kw):
        saved[step] = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
        return save(model, cfg_, step=step, **kw)

    def direct_named(x, a, b, w, *args):
        fell_through.add((tuple(x.shape), tuple(w.shape)))
        return direct(x, a, b, w, *args)

    def fold_counted(w, *args):                      # K8's wrapper folding U itself: no tiles were passed
        folded.append(tuple(w.shape))
        return fold(w, *args)

    stage.make_train_step, stage.save_checkpoints, rb.conv3x3_stats_cuda = timed_make_step, keep_saved, direct_named
    _nccl_world1(work)
    try:
        _routes_agree(cfg)
        fell_through.clear()
        rb.CONV_ALGO = "winograd"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        rb.wino_tiles = fold_counted
        t_run = time.perf_counter()
        first = run_stage(cfg)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        rb.wino_tiles = fold
        counts = {"resnet_conv3x3_stats_wino": rb.WINO_LAUNCHES, "resnet_conv3x3_stats": rb.CONV_LAUNCHES,
                  "resnet_conv3x3_stats_bwd": rb.CONV_BWD_LAUNCHES,
                  "subpixel_upsample_conv3x3_stats": rb.UPSAMPLE_LAUNCHES,
                  "subpixel_upsample_conv3x3_stats_bwd": rb.UPSAMPLE_BWD_LAUNCHES, "flash_attention_fwd": fa.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        cfg["training"].update(resume_from="auto", max_steps=1)
        t_resume = time.perf_counter()
        second = run_stage(cfg)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t_resume
    finally:
        stage.make_train_step, stage.save_checkpoints, rb.conv3x3_stats_cuda = make_step, save, direct
        rb.wino_tiles = fold
        rb.CONV_ALGO = "direct"
        torch.distributed.destroy_process_group()

    ckpt = Path(cfg["training"]["ckpt_dir"])
    logged = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    for record in logged:
        log("stage1", f"step {record['step']}: " + " ".join(
            f"{k.split('/')[-1]}={v:.6g}" for k, v in record.items() if k.startswith("train/")))
    log("stage1", f"steps: {', '.join(f'{t:.1f}' for t in step_ms)} ms (synchronised; the third after the "
        f"resume); K8 launches per step (one micro-batch of 2 pairs = 4 images, triplets of 12 through the "
        f"encoder, remat all): {step_k8}; peak memory {peak / 2**30:.2f} GiB; run 1 {run_s:.1f} s, resume "
        f"{resume_s:.1f} s (wall, load and saves included); launches in run 1 {counts}")
    val = {k: v for k, v in first.items() if k.startswith("val/")}
    log("stage1", f"validation at step 2 (768 x 512 through 512-pixel tiles): {val}")
    if [r["step"] for r in logged] != [1, 2, 3] or not all(
            math.isfinite(r["train/loss"]) and r["train/grad_norm"] > 0.0 for r in logged):
        raise SystemExit(f"[stage1] steps 1-3 must log a finite loss and a gradient norm above 0: {logged}")
    if len(val) != 3 or not all(math.isfinite(v) for v in val.values()):
        raise SystemExit(f"[stage1] validation metrics missing or not finite: {val}")
    misrouted = [shapes for shapes in fell_through if rb.wino_aligned(*shapes[0][1:3], shapes[0][3], shapes[1][3])]
    if fell_through:
        log("stage1", f"shapes that took the direct route (K1): {sorted(fell_through)}")
    if misrouted:
        raise SystemExit(f"[stage1] aligned shapes took K1: {misrouted}")
    if not all(counts[k] > 0 for k in counts if k != "resnet_conv3x3_stats"):
        raise SystemExit(f"[stage1] a kernel of the path never launched: {counts}")
    log("stage1", f"K8 calls that folded U themselves in run 1: {len(folded)} (the blocks pass the tiles they keep)")
    if folded:
        raise SystemExit(f"[stage1] K8 folded U in the call for weights {sorted(set(folded))}: a block passed no tiles")
    # the step-2 checkpoint: complete, its HF weights those the loop held when it saved
    step2 = ckpt_lib.checkpoint_dir(ckpt, 2)
    _, state, train_state, meta = ckpt_lib.load_train_checkpoint(step2)
    same = all(torch.equal(state[k], v) for k, v in saved[2].items()) and state.keys() == saved[2].keys()
    if not (ckpt_lib.is_complete_checkpoint(step2) and meta["step"] == train_state["step"] == 2 and same):
        raise SystemExit("[stage1] the step-2 checkpoint is incomplete or its weights differ from the loop's")
    _, _, train_state, _ = ckpt_lib.load_train_checkpoint(ckpt_lib.checkpoint_dir(ckpt, 3))
    adam_steps = {float(v["step"]) for v in train_state["optimizer"]["state"].values()}
    if second["global_step"] != 3.0 or adam_steps != {3.0}:
        raise SystemExit(f"[stage1] the resume must take step 3 from the saved optimizer state: global step "
                         f"{second['global_step']}, AdamW step counts {adam_steps}")
    log("stage1", f"step_0000002 complete, rgba_vae_hf reloads bit for bit ({len(state)} tensors); resumed at "
        f"step 2 and took step 3 from the saved AdamW state (its step counts {adam_steps}); loss "
        f"{second['train/loss']:.6f}")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the empty-prompt text encoders
# ---------------------------------------------------------------------------
# The card against the CPU on the same weights, both encoders at depth 2 and
# full width, fp32 with TF32 off on both sides: max |card - CPU| over max
# |CPU| of each output. Summation order alone separates them (~1e-6); a
# dropped padding mask moves every padded position (~1).
TEXTENC_HOLD_TOL = 1e-4
def _text_encoders(clip_cfg, t5_cfg, device, generator):
    """(CLIP, T5) drawn from `generator` with transformers' per-layer stds,
    built on the meta device and materialised on `device` (no default init)."""
    from ragb_vae_tpu_torch.models import text_encoders as te

    out = []
    for cls, cfg in ((te.CLIPTextEncoder, clip_cfg), (te.T5Encoder, t5_cfg)):
        module = cls(cfg, device="meta").to_empty(device=device)
        te.init_text_encoder_(module, generator)
        out.append(module.eval().requires_grad_(False))
    return out


def _truncated(module, depth: int, device):
    """The first `depth` layers of `module` (embeddings and final norm too)
    on `device`, sharing storage when `device` is the module's own."""
    import dataclasses

    field = "num_hidden_layers" if hasattr(module.config, "num_hidden_layers") else "num_layers"
    small = type(module)(dataclasses.replace(module.config, **{field: depth}), device="meta")
    keys = small.state_dict().keys()
    small.load_state_dict({k: v.to(device) for k, v in module.state_dict().items() if k in keys},
                          strict=True, assign=True)
    return small.eval()


def _encode(clip, t5, inputs, masked: bool = True):
    """JAX's `encode_empty_prompt` on built encoders: (CLIP stream, pooled, T5 stream)."""
    (ids1, mask1), (ids2, mask2) = inputs
    dev = next(clip.parameters()).device
    with torch.no_grad():
        h1 = clip(ids1.to(dev), mask1.to(dev) if masked else None)
        pooled = clip.text_model.final_layer_norm(h1)[:, 0]
        h2 = t5(ids2.to(dev), mask2.to(dev) if masked else None)
    return h1, pooled, h2


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _write_narrow_text_checkpoint(root: Path, device) -> None:
    """flux/ (a tiny transformer taking a 128-wide prompt, the two encoders
    at narrow width and published vocabularies, FLUX's tokenizer files, no
    npz) and vae/ae, all from SEED."""
    from ragb_vae_tpu_torch.models import text_encoders as te
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.flux_weights import save_flux_transformer_params
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    clip_cfg = te.CLIPTextConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2)
    t5_cfg = te.T5EncoderConfig(d_model=128, d_kv=32, d_ff=256, num_layers=2, num_heads=4,
                                feed_forward_proj="gated-gelu")
    clip, t5 = _text_encoders(clip_cfg, t5_cfg, device, torch.Generator(device).manual_seed(SEED + 13))
    te.save_text_encoder(clip, root / "flux" / "text_encoder")
    te.save_text_encoder(t5, root / "flux" / "text_encoder_2")
    write_flux_tokenizers(root / "flux")
    t_cfg = FluxTransformerConfig.tiny()
    t_cfg.joint_attention_dim, t_cfg.pooled_projection_dim = t5_cfg.d_model, clip_cfg.hidden_size
    v_cfg = AutoencoderConfig.tiny()
    v_cfg.in_channels = v_cfg.out_channels = 4
    model = FluxTextAlphaModel.random(t_cfg, v_cfg, seed=SEED, device=device, prompt_len=4)
    save_flux_transformer_params(t_cfg, model.transformer.state_dict(), root / "flux" / "transformer")
    save_autoencoder_params(v_cfg, model.vae.module.state_dict(), root / "vae" / "ae")


def phase_textenc(work: Path, device="cuda") -> dict:
    """CLIP-L and the T5-v1.1-XXL encoder at full published width and depth,
    fp32, from a seed: encode the empty prompt, time it, its peak memory;
    hold both at depth 2 against the CPU, and the same run with the padding
    mask dropped must fail that bound; `from_pretrained` on a narrow
    checkpoint without an npz writes one, and a second load reads it back
    bit for bit. Launches no kernel."""
    from ragb_vae_tpu_torch.models import flux_kontext_textalpha as fk
    from ragb_vae_tpu_torch.models import text_encoders as te

    device = torch.device(device)
    on_card = device.type == "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip() if on_card else "cpu"
    write_flux_tokenizers(work / "tok")
    inputs = (te.clip_empty_prompt_ids(work / "tok" / "tokenizer"), te.t5_empty_prompt_ids(work / "tok" / "tokenizer_2"))
    assert inputs[0][0].shape == (1, 77) and inputs[0][1].sum() == 2 and inputs[1][0].shape == (1, 512)
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    clip_cfg, t5_cfg = te.CLIPTextConfig.clip_l(), te.T5EncoderConfig.t5_xxl()
    clip, t5 = _text_encoders(clip_cfg, t5_cfg, device, torch.Generator(device).manual_seed(SEED))
    n_params = sum(p.numel() for m in (clip, t5) for p in m.parameters())
    log("textenc", f"CLIP-L + T5-v1.1-XXL encoder, {n_params / 1e9:.3f} B parameters in fp32, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    h1, pooled, h2 = _encode(clip, t5, inputs)
    prompt = h2 if h1.shape[-1] != h2.shape[-1] else torch.cat([h1, h2], dim=1)
    if not (prompt.shape == (1, 512, t5_cfg.d_model) and pooled.shape == (1, clip_cfg.hidden_size)):
        raise SystemExit(f"[textenc] FAIL: prompt {tuple(prompt.shape)}, pooled {tuple(pooled.shape)}")
    if not (torch.isfinite(h1).all() and torch.isfinite(h2).all() and torch.isfinite(pooled).all()):
        raise SystemExit("[textenc] FAIL: non-finite embeddings at full depth")
    if on_card:
        with torch.no_grad():
            clip_ms = time_ms(lambda: clip(inputs[0][0].to(device), inputs[0][1].to(device)), runs=5, warmups=1)
            t5_ms = time_ms(lambda: t5(inputs[1][0].to(device), inputs[1][1].to(device)), runs=5, warmups=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("textenc", f"{smi}: empty prompt at full size: prompt {tuple(prompt.shape)} (T5 alone), pooled "
            f"{tuple(pooled.shape)}, CLIP stream {tuple(h1.shape)}; CLIP-L {clip_ms:.2f} ms, T5-XXL {t5_ms:.2f} ms "
            f"(median of 5, CUDA events, fp32 without TF32), peak memory {peak:.2f} GiB; |prompt| max "
            f"{float(h2.abs().max()):.3f}, |pooled| max {float(pooled.abs().max()):.3f}")
    # the hold: depth 2, full width, the same weights on the card and the host
    t0 = time.perf_counter()
    pairs = [(_truncated(m, 2, device), _truncated(m, 2, "cpu")) for m in (clip, t5)]
    del clip, t5, h1, h2, prompt, pooled
    if on_card:
        torch.cuda.empty_cache()
    card = _encode(pairs[0][0], pairs[1][0], inputs)
    host = _encode(pairs[0][1], pairs[1][1], inputs)
    fault = _encode(pairs[0][0], pairs[1][0], inputs, masked=False)
    names = ("CLIP stream", "pooled", "T5 stream")
    errs = [_rel_err(a, b) for a, b in zip(card, host)]
    fault_errs = [_rel_err(a, b) for a, b in zip(fault, host)]
    log("textenc", f"depth 2 at full width, card against CPU ({time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)) + f" (bound {TEXTENC_HOLD_TOL:g}); padding mask "
        "dropped on the card (planted fault): " + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, fault_errs)))
    if max(errs) > TEXTENC_HOLD_TOL:
        raise SystemExit("[textenc] FAIL: the card's encoders disagree with the CPU's")
    if min(fault_errs[0], fault_errs[2]) <= TEXTENC_HOLD_TOL:
        raise SystemExit("[textenc] FAIL: dropping the padding mask passed the bound")
    del pairs, card, host, fault
    # the checkpoint path: no npz, from_pretrained on the card writes it
    t0 = time.perf_counter()
    _write_narrow_text_checkpoint(work / "ckpt", device)
    flux = work / "ckpt" / "flux"
    model = fk.FluxTextAlphaModel.from_pretrained(flux, vae_path=work / "ckpt" / "vae", device=device)
    if not (flux / fk.EMPTY_PROMPT_FILE).exists():
        raise SystemExit("[textenc] FAIL: from_pretrained wrote no empty_prompt_embeds.npz")
    again = fk.FluxTextAlphaModel.from_pretrained(flux, vae_path=work / "ckpt" / "vae", device=device)
    if not (torch.equal(again.prompt_embeds, model.prompt_embeds)
            and torch.equal(again.pooled_prompt_embeds, model.pooled_prompt_embeds)):
        raise SystemExit("[textenc] FAIL: the second load did not read the npz back bit for bit")
    host_dir = work / "ckpt" / "flux_host"
    host_dir.mkdir()
    for sub in ("tokenizer", "tokenizer_2", "text_encoder", "text_encoder_2"):
        (host_dir / sub).symlink_to(flux / sub)
    prompt_h, pooled_h, _ = fk.encode_empty_prompt(host_dir, device="cpu")
    errs = (_rel_err(model.prompt_embeds, torch.from_numpy(prompt_h)),
            _rel_err(model.pooled_prompt_embeds, torch.from_numpy(pooled_h)))
    log("textenc", f"from_pretrained on a narrow checkpoint without an npz ({time.perf_counter() - t0:.1f} s): "
        f"wrote {fk.EMPTY_PROMPT_FILE}, prompt {tuple(model.prompt_embeds.shape)}, pooled "
        f"{tuple(model.pooled_prompt_embeds.shape)}, the second load bit-equal; against the CPU: prompt "
        f"{errs[0]:.2e}, pooled {errs[1]:.2e}")
    if max(errs) > TEXTENC_HOLD_TOL:
        raise SystemExit("[textenc] FAIL: the checkpoint's embeddings disagree with the CPU's")
    return {}


# ---------------------------------------------------------------------------
# phase 14: weights, a published-layout checkpoint through the port's loaders
# ---------------------------------------------------------------------------
WEIGHTS_SEED = SEED + 14
WEIGHTS_SAMPLE_PX = 512        # the sample's size
WEIGHTS_VAE_PX = 256           # the widened VAE's hold
# the planted faults: a square tensor written transposed, and a key the index puts in the wrong shard
WEIGHTS_TRANSPOSED_KEY = "single_transformer_blocks.0.attn.to_q.weight"
WEIGHTS_MISPLACED_KEY = "transformer_blocks.0.attn.to_k.weight"
# The widened VAE on the card (bf16, K1, K2 and K3 at head dim 512) against the
# CPU's plain route in fp32 on the same weights, ||card - CPU|| / ||CPU|| of the
# posterior mean and of the decoded image (the CPU's mean decoded on both): bf16
# rounds each of the `ae`'s ~30 convolutions by up to 2^-9, about 1e-2 in all; a
# wrong weight decorrelates what follows it (order 1). The same bound as
# `record_goldens_torch.HOLD_REL_TOL`, which holds the card's VAE against its goldens.
WEIGHTS_VAE_REL_TOL = 5e-2


def _weights_configs():
    """(transformer, RGB VAE) of the phase: FLUX.1-Kontext-dev at its
    published width, depth cut to 1 double and 2 single blocks; the FLUX `ae`."""
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

    return FluxTransformerConfig(num_layers=1, num_single_layers=2), AutoencoderConfig.flux()


def _sample_parts(model, gt: torch.Tensor, seed: int):
    """`model.sample(gt, SERVE_STEPS steps, seed)` of one image, with the
    sampler's final latents beside the image: (latents, image)."""
    gen = torch.Generator(model.device).manual_seed(seed)
    with torch.inference_mode():
        eps, init, steps = model.draw_noise(model.latent_shape(gt.shape[1], gt.shape[2]), SERVE_STEPS, gen)
        cond = model.encode_latents(gt.to(model.device), eps[None])
        latents = model.sample_latents_from_noise(cond, init[None], steps[None].transpose(0, 1))
        return latents.float(), model.decode_latents(latents)


def _modules_differ(a: torch.nn.Module, b: torch.nn.Module) -> list:
    """The state-dict keys whose presence, dtype or bits differ between two modules."""
    sa, sb = a.state_dict(), b.state_dict()
    return sorted(k for k in set(sa) | set(sb) if k not in sa or k not in sb or sa[k].dtype != sb[k].dtype
                  or sa[k].shape != sb[k].shape or not torch.equal(sa[k], sb[k].to(sa[k].device)))


def _planted_copy(src: Path, dst: Path) -> Path:
    """`dst`: a model directory whose every file links to `src`'s, to plant a fault in."""
    for path in src.rglob("*"):
        if path.is_file():
            (dst / path.relative_to(src)).parent.mkdir(parents=True, exist_ok=True)
            (dst / path.relative_to(src)).symlink_to(path)
    return dst


def phase_weights(work: Path, device="cuda") -> dict:
    """A FLUX.1-Kontext-dev checkpoint directory in the published layout
    (`transformer/` in 3 bf16 shards + index at full width, depth 1 + 2,
    random values from a seed; `scheduler/`; the empty prompt's npz) and the
    FLUX `ae` in RGB, written from a model built in memory from the seed
    (its values made bf16, its alpha path zero: what the files hold). Then:
    `from_pretrained` in bf16, its weights bit-equal to that model's, and a
    4-step 512^2 sample against that model's on the same noise; int8 at load
    (K10) against the bf16 sample; the widened VAE's 256^2 encode and decode
    against the CPU's fp32 plain route; `record_goldens_torch` on the `ae` and
    the card's model against its goldens; LPIPS from both key formats; two
    planted faults (a square tensor written transposed, an index naming a
    key's shard wrongly) must fail. -> the launches of the from-disk sample
    and of the int8 sample."""
    import dataclasses

    import record_goldens_torch
    import rehearse_aux_assets_torch as aux
    import rehearse_real_geometry_torch as rehearse

    from ragb_vae_tpu_torch.models import flux_kontext_textalpha as fk
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.models.weights import load_torch_state, save_autoencoder_params, save_torch_state

    device = torch.device(device)
    on_card = device.type == "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip() if on_card else "cpu"
    t_cfg, rgb_cfg = _weights_configs()
    rgba_cfg = dataclasses.replace(rgb_cfg, in_channels=4, out_channels=4)
    t0 = time.perf_counter()
    model = fk.FluxTextAlphaModel.random(t_cfg, rgba_cfg, seed=WEIGHTS_SEED, device=device, dtype=torch.bfloat16,
                                         fused=True)
    with torch.no_grad():
        for module in (model.transformer, model.vae.module):
            for t in module.state_dict().values():     # the fp32 AdaLN modulation: bf16 values
                if t.is_floating_point():
                    t.copy_(t.to(torch.bfloat16))
        vae_state = model.vae.module.state_dict()      # the alpha path a widened RGB `ae` has
        vae_state["encoder.conv_in.weight"][:, 3:] = 0
        vae_state["decoder.conv_out.weight"][3:] = 0
        vae_state["decoder.conv_out.bias"][3:] = 0
    ckpt = work / "flux"
    t_state = model.transformer.state_dict()
    keys = [(k, tuple(v.shape)) for k, v in t_state.items()]
    rehearse.write_transformer_config(t_cfg, ckpt / "transformer")
    rehearse.write_sharded_transformer(keys, ckpt / "transformer", make=lambda k, s: t_state[k].cpu())
    rehearse.write_model_dir(ckpt, model.prompt_embeds.cpu().numpy(), model.pooled_prompt_embeds.cpu().numpy(),
                             model.text_ids.cpu().numpy())
    rgb_state = {k: v.cpu() for k, v in vae_state.items()}
    rgb_state["encoder.conv_in.weight"] = rgb_state["encoder.conv_in.weight"][:, :3]
    rgb_state["decoder.conv_out.weight"] = rgb_state["decoder.conv_out.weight"][:3]
    rgb_state["decoder.conv_out.bias"] = rgb_state["decoder.conv_out.bias"][:3]
    save_autoencoder_params(rgb_cfg, rgb_state, work / "vae" / "ae")
    n_params = sum(int(np.prod(s)) for _, s in keys)
    log("weights", f"wrote {len(keys)} transformer tensors ({n_params / 1e9:.3f} B params, depth "
        f"{t_cfg.num_layers} + {t_cfg.num_single_layers} at width {t_cfg.inner_dim}) in 3 bf16 shards + index and "
        f"the RGB `ae` ({len(rgb_state)} tensors): {rehearse.disk_bytes(work) / 2**30:.3f} GiB on disk, "
        f"{time.perf_counter() - t0:.1f} s")

    def load(path: Path, **kw):
        return fk.FluxTextAlphaModel.from_pretrained(path, vae_path=work / "vae", dtype=torch.bfloat16, fused=True,
                                                     device=device, **kw)

    # the bf16 load: weights bit-equal to the model in memory
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with rehearse.HostPeak() as host:
        loaded = load(ckpt)
        if on_card:
            torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    device_mem = (f"device {(torch.cuda.memory_allocated() - before) / 2**30:.3f} GiB resident, "
                  f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.3f} GiB peak above the model in memory"
                  if on_card else "no device")
    differ = _modules_differ(loaded.transformer, model.transformer) + _modules_differ(loaded.vae.module,
                                                                                      model.vae.module)
    same_prompt = torch.equal(loaded.prompt_embeds, model.prompt_embeds) and torch.equal(
        loaded.pooled_prompt_embeds, model.pooled_prompt_embeds)
    log("weights", f"{smi}: from_pretrained bf16 in {load_s:.2f} s from {rehearse.disk_bytes(ckpt) / 2**30:.3f} GiB "
        f"on disk; host peak RSS {host.peak / 2**30:.2f} GiB during the load (process "
        f"{rehearse.process_peak_bytes() / 2**30:.2f} GiB), {device_mem}; weights "
        f"{'bit-equal to the model in memory' if not differ else f'DIFFER at {differ[:3]}'}, prompt "
        f"{'equal' if same_prompt else 'DIFFERS'}")
    if differ or not same_prompt:
        raise SystemExit("[weights] FAIL: the checkpoint did not load the weights it was written from")

    # a 4-step sample through the entry point, against the model in memory on the same noise
    gt = torch.rand((1, WEIGHTS_SAMPLE_PX, WEIGHTS_SAMPLE_PX, 4), generator=torch.Generator().manual_seed(WEIGHTS_SEED))
    reset_all_counts()
    image = loaded.sample(gt, num_inference_steps=SERVE_STEPS,
                          generator=torch.Generator(device).manual_seed(WEIGHTS_SEED))
    counts = {"resnet_conv3x3_stats": rb.CONV_LAUNCHES, "subpixel_upsample_conv3x3_stats": rb.UPSAMPLE_LAUNCHES,
              "flash_attention_fwd": fa.LAUNCHES}
    latents, parts_image = _sample_parts(loaded, gt, WEIGHTS_SEED)
    want_latents, want_image = _sample_parts(model, gt, WEIGHTS_SEED)
    again_latents, again_image = _sample_parts(model, gt, WEIGHTS_SEED)

    def max_diff(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    # bit-equal, or within the model in memory's own run-to-run spread
    spread = (max_diff(want_latents, again_latents), max_diff(want_image, again_image))
    diffs = (max_diff(latents, want_latents), max_diff(image, want_image), max_diff(image, parts_image))
    fine = (bool(torch.isfinite(image).all()) and diffs[0] <= spread[0] and diffs[1] <= spread[1]
            and diffs[2] <= spread[1])
    log("weights", f"{SERVE_STEPS}-step {WEIGHTS_SAMPLE_PX}^2 sample from disk (`sample`) against the model in memory "
        f"on the same noise: latents max |diff| {diffs[0]:.3e}, image {diffs[1]:.3e} (the model in memory against "
        f"itself: {spread[0]:.3e}, {spread[1]:.3e}; bound: bit-equal, or within that spread); launches {counts} "
        f"{'ok' if fine else 'FAIL'}")
    if not fine:
        raise SystemExit("[weights] FAIL: the model from disk does not sample as the model it was written from")
    if on_card and not all(n > 0 for n in counts.values()):
        raise SystemExit(f"[weights] a kernel of the path never launched: {counts}")

    # int8 at load, against the bf16 sample
    del model, want_image, again_image
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    quantized = load(ckpt, weight_quant="int8")
    q_load_s = time.perf_counter() - t0
    reset_all_counts()
    q_latents, q_image = _sample_parts(quantized, gt, WEIGHTS_SEED)
    counts["int8_matmul"] = i8.LAUNCHES
    rel = ((q_latents - latents).norm() / latents.norm()).item()
    cos = (torch.dot(q_latents.flatten(), latents.flatten()) / (q_latents.norm() * latents.norm())).item()
    fine = (bool(torch.isfinite(q_image).all()) and rel <= INT8_TRACK_REL_TOL and cos >= INT8_TRACK_COS_TOL
            and (i8.LAUNCHES > 0 or not on_card))
    log("weights", f"int8 at load ({q_load_s:.2f} s): the same sample's latents against bf16's: relative error "
        f"{rel:.4f} (<= {INT8_TRACK_REL_TOL}) cosine {cos:.5f} (>= {INT8_TRACK_COS_TOL}), {i8.LAUNCHES} K10 launches "
        f"{'ok' if fine else 'FAIL'}")
    if not fine:
        raise SystemExit("[weights] FAIL: the int8 model loaded from disk does not track the bf16 one")
    del quantized, q_latents, q_image

    # the widened VAE on the card against the CPU's fp32 plain route, and against record_goldens_torch
    cpu_vae = RgbaVAE.from_pretrained_rgb(work / "vae", subfolder="ae", device="cpu")
    x = torch.rand((1, WEIGHTS_VAE_PX, WEIGHTS_VAE_PX, 4), generator=torch.Generator().manual_seed(WEIGHTS_SEED + 1))
    with torch.no_grad():
        ref = cpu_vae.encode(x * 2.0 - 1.0).mean
        ref_decoded = cpu_vae.decode(ref)
        mean = loaded.vae.encode((x * 2.0 - 1.0).to(device)).mean.float().cpu()
        decoded = loaded.vae.decode(ref.to(device)).float().cpu()
    errs = {"mean": float((mean - ref).norm() / ref.norm()),
            "decoded": float((decoded - ref_decoded).norm() / ref_decoded.norm())}
    log("weights", f"widened VAE, {WEIGHTS_VAE_PX}^2 encode and decode in bf16 on {device} against the CPU's fp32 plain "
        f"route: mean {errs['mean']:.3e}, decoded {errs['decoded']:.3e} (bound {WEIGHTS_VAE_REL_TOL:g})")
    if not all(np.isfinite(e) and e <= WEIGHTS_VAE_REL_TOL for e in errs.values()):
        raise SystemExit("[weights] FAIL: the card's VAE does not reproduce the CPU's")
    del cpu_vae
    goldens = work / "goldens"
    goldens.mkdir()
    record_goldens_torch.record_vae(work / "vae", "ae", goldens, False, device)
    rehearse.hold_widened_vae(loaded.vae, goldens / "vae_goldens.npz", device)

    # LPIPS from both key formats (and .pt): identical distances
    dists = aux.lpips_distances(aux.write_lpips_files(work), device)
    same = all(torch.equal(d, dists["safetensors"]) for d in dists.values())
    log("weights", f"LPIPS from lpips' and torchvision's keys and from .pt on {device}: distances "
        f"{[float(d) for d in dists['safetensors']]} {'identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("[weights] FAIL: the LPIPS formats gave other distances")

    # two planted faults, each of which must fail
    index_name = "diffusion_pytorch_model.safetensors.index.json"
    weight_map = json.loads((ckpt / "transformer" / index_name).read_text())["weight_map"]
    bad = _planted_copy(ckpt, work / "transposed")
    shard = bad / "transformer" / weight_map[WEIGHTS_TRANSPOSED_KEY]
    tensors = load_torch_state(shard)
    tensors[WEIGHTS_TRANSPOSED_KEY] = tensors[WEIGHTS_TRANSPOSED_KEY].t().contiguous()
    shard.unlink()
    save_torch_state(tensors, shard)
    del tensors
    differ = _modules_differ(load(bad).transformer, loaded.transformer)
    caught_transposed = differ == [WEIGHTS_TRANSPOSED_KEY]
    bad = _planted_copy(ckpt, work / "misplaced")
    wrong = dict(weight_map)
    wrong[WEIGHTS_MISPLACED_KEY] = next(n for n in sorted(set(weight_map.values()))
                                        if n != weight_map[WEIGHTS_MISPLACED_KEY])
    (bad / "transformer" / index_name).unlink()
    (bad / "transformer" / index_name).write_text(json.dumps({"metadata": {}, "weight_map": wrong}))
    try:
        load(bad)
        caught_misplaced, why = False, "it loaded"
    except ValueError as err:
        caught_misplaced, why = WEIGHTS_MISPLACED_KEY in str(err), str(err)
    log("weights", f"planted faults: {WEIGHTS_TRANSPOSED_KEY} written transposed (shapes pass): the value check "
        f"{'caught it' if caught_transposed else f'FAILED to catch it ({differ[:3]})'}; the index naming the wrong "
        f"shard for {WEIGHTS_MISPLACED_KEY}: {'the load raised naming the key' if caught_misplaced else 'NOT caught'} "
        f"({why[:160]})")
    if not (caught_transposed and caught_misplaced):
        raise SystemExit("[weights] FAIL: a planted fault passed")
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help=f"comma-separated subset of {','.join(ALL_PHASES)} (device and build always "
                             "run; lora, int8 and pp need slice, whose model they train, quantise and "
                             "pipeline; tp needs "
                             "slice and int8, whose answers it is held against; axes needs none); the final "
                             "ok line is printed only when all ran")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(ALL_PHASES):
        parser.error(f"unknown phases {sorted(phases - set(ALL_PHASES))}")
    if phases & {"lora", "int8", "pp"} and "slice" not in phases:
        parser.error("--phases lora, int8 and pp need slice: they work on the serving phase's model")
    if "tp" in phases and not {"slice", "int8"} <= phases:
        parser.error("--phases tp needs slice and int8: it is held against their answers")
    t_start = time.perf_counter()
    counts: dict = {}

    def run(phase: str, fn, *args):
        """Run one phase, add its launch counts (a dict, or the first of a
        tuple) to the totals and log what it took on the wall clock."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        first = out[0] if isinstance(out, tuple) else out
        if phase not in ("device", "build", "kernels"):
            for key, n in first.items():
                counts[key] = counts.get(key, 0) + n
        log("time", f"{phase}: {time.perf_counter() - t0:.1f} s ({time.perf_counter() - t_start:.1f} s since start)")
        return out

    name = run("device", phase_device)
    run("build", phase_build)
    results = run("kernels", phase_kernels) if "kernels" in phases else {}
    if "slice" in phases:
        refs: dict = {}     # the whole model's answers, on the host, for the tp phase
        _, model, bf16_peak = run("slice", phase_slice, refs)
        if "pp" in phases:
            run("pp", phase_pp, model, refs)
        with tempfile.TemporaryDirectory() as tmp:
            if phases & {"lora", "int8"}:
                # one (gt, text_alpha) PNG tree for both stages
                _write_pair_tree(Path(tmp) / "data", STAGE_STEPS * STAGE_PAIRS, 512)
            if "lora" in phases:
                run("lora", phase_lora, model, Path(tmp))
            if "int8" in phases:
                run("int8", phase_int8, model, bf16_peak, Path(tmp), refs)
        del model
        torch.cuda.empty_cache()
        if "tp" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                run("tp", phase_tp, refs, Path(tmp))
    if "axes" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            run("axes", phase_axes, Path(tmp))
    if "convs" in phases:
        run("convs", phase_convs)
    if "train" in phases:
        run("train", phase_train)
    if "stage1" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            run("stage1", phase_stage1, Path(tmp))
    if "textenc" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            run("textenc", phase_textenc, Path(tmp))
    if "weights" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            run("weights", phase_weights, Path(tmp))
    if phases != set(ALL_PHASES):
        log("done", f"ran only {sorted(phases)}: no summary")
        return 0
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
