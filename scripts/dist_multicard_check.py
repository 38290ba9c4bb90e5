"""The port's `torch.distributed` axes across cards over NCCL, each run held
against the same work on one card.

    python3 scripts/dist_multicard_check.py [--nproc 4] [--device cuda] [--runs abcdefghi]
                                            [--out chiprun_out/dist_multicard.json]

It launches three things in turn, each a fresh process tree, and draws every
model from seed 0 in the process (nothing is downloaded; the assets and the
references go to a temporary directory):

1. the reference, one process on `cuda:0` (world 1, no process group): the
   same work as each run below on one card, on the same global inputs, noise
   and seeds;
2. `torchrun --nproc-per-node N` of this script, one rank a card
   (`cuda:LOCAL_RANK` through `mesh.maybe_init_distributed`, NCCL), which
   takes the runs in order and holds each against the reference on rank 0.
   A run that fails ends the launch; the runs after it get a launch of their
   own, so one fault hides no other run;
3. the stage-1 loop at world 1 once more, resuming run (a)'s world-N
   checkpoint for a third step.

The runs (at `--nproc 4`; the layouts shrink with the world size):

- (a) the stage-1 loop (`run_stage` on configs/flux_vae.yaml over a seeded
  RGB FLUX `ae`, K8 on every resnet conv), data N with ZeRO-2, 512^2, a
  global batch of 8: the loss and gradient norm of steps 1-3, the clipped
  gradient tree of step 1 and every parameter's change after step 2; then
  the step-2 checkpoint resumed at world 1 for step 3 (checkpoints are
  layout-free);
- (b)-(g) the LoRA stage (`train_from_config(cfg, model=)`, rank 128 over the
  frozen full-depth FLUX.1-Kontext base, recompute): (b) data N; (c) data
  N/2 x tensor_parallel 2; (d) shard_base_params at data N; (e) the same
  over an int8 base (K10 on gathered int8 weights); (f) data N/2 x
  sequence_parallel 2 at 1024^2; (g) tensor_parallel 2 x sequence_parallel 2
  at 1024^2. Held: the loss, the gradient norm, the clipped gradient tree the
  optimizer steps and each adapter's change in the step;
- (h) `InferenceServer(tp_group=)` at tensor_parallel N: one 512^2 and one
  1024^2 request (4 steps) against the whole model's answers on one card;
- (i) `should_stop(sync=True)` in the LoRA stage at data N (2 + 4 blocks at
  full width): the last rank sends itself SIGTERM after step 1; every rank
  must stop at step 1 and rank 0 alone write `checkpoint-1`.

For each run it prints each card's resident and peak memory, three timed
steps (or requests) after a warm-up and their spread, the collectives a step
from each module's `COUNTS`, one step under `torch.profiler` on every card
(the share of the device span in NCCL kernels, and the idle share), and the
model TFLOP/s a card (`ops/flops.py`) with its share of the card's peak.

`--device cpu` runs the same on tiny configs over gloo (`--nproc 2`: runs
a, b, c, d and h by default) without the card's numbers. Prints one JSON
object last and writes it to `--out`; exits 1 when a run failed or missed
its bound.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 0
ALL_RUNS = "abcdefghi"
CPU_RUNS = "abcdh"
SERVE_SEED = 7
SERVE_STEPS = 4

# Bounds, each run against the reference on one card (the same kernels on
# other batch splits, so only the order of sums and the bf16 roundings of
# the all-reduces differ). The gradient tree's bound is the one the two-rank
# gloo runs of the same axes were held to (chip_smoke's tp and axes phases:
# worst leaf 0.0032-0.0036 at 2 + 4 blocks against 0.05, cosine 0.995); a
# collective that drops, reorders or misroutes a part moves the leaves below
# it by the size of the gradient itself.
GRAD_TOL = (0.05, 0.995)            # worst leaf: relative error, cosine
LOSS_RTOL = 2e-3                    # the loss, each step
GRAD_NORM_RTOL = 1e-2               # the global gradient norm before the clip
# The adapters' (and the VAE parameters') change in a step: AdamW's first
# update is about lr * sign(g) (m / sqrt(v) with one sample), so an entry
# whose gradient lies inside the rounding noise flips its sign, an error of
# two updates. At the gradients' ~0.4% noise about 0.3% of the entries of a
# Gaussian-like leaf flip: relative error ~2 sqrt(0.003) = 0.11, cosine
# ~0.994. The bound leaves the worst leaf three times that; a wrong gradient
# (a sign pattern of its own) reads ~1.4, cosine ~0.
UPDATE_TOL = (0.35, 0.95)
ANSWER_TOL = (0.02, 0.999)          # a served image: chip_smoke's tp phase bound (it read 0.0082 at TP 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Sizes: the published widths on the card, tiny configs on the CPU
# ---------------------------------------------------------------------------
class Scale:
    def __init__(self, device: str):
        import torch

        self.cuda = device != "cpu"
        self.device = device
        self.dtype = torch.bfloat16 if self.cuda else torch.float32
        self.precision = "bf16" if self.cuda else "fp32"
        self.s512, self.s1024 = (512, 1024) if self.cuda else (64, 128)
        self.stage_size = 512 if self.cuda else 32
        self.rank, self.alpha = (128, 192) if self.cuda else (4, 6)
        self.prompt_len = 512 if self.cuda else 4
        self.timed = 3 if self.cuda else 1          # timed steps after the held one
        self.profiled = self.cuda                   # one more step under torch.profiler

    def transformer(self, depth=None):
        from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig

        cfg = FluxTransformerConfig() if self.cuda else FluxTransformerConfig.tiny()
        if depth is not None:
            cfg.num_layers, cfg.num_single_layers = depth
        return cfg

    def vae(self, channels: int = 4):
        from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

        cfg = AutoencoderConfig.flux() if self.cuda else AutoencoderConfig.tiny()
        cfg.in_channels = cfg.out_channels = channels
        return cfg

    def model(self, *, quant="none", depth=None, **axes):
        """FLUX.1-Kontext + the RGBA `ae` from SEED (this rank's shard with
        `tp=` / `fsdp=`), without adapters."""
        from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel

        return FluxTextAlphaModel.random(self.transformer(depth), self.vae(), seed=SEED, device=self.device,
                                         dtype=self.dtype, fused=self.cuda, prompt_len=self.prompt_len,
                                         weight_quant=quant, **axes)


LORA_CONFIG = {                # configs/flux_kontext_textalpha_lora.yaml, as chip_smoke's LoRA phase
    "learning_rate": 3e-5, "weight_decay": 0.01, "adam_beta1": 0.9, "adam_beta2": 0.95,
    "max_grad_norm": 1.0, "seed": 1337,
}
# run: (tensor_parallel, sequence_parallel, shard_base_params, weight_quant, size, pairs a step)
LORA_RUNS = {
    "b": (1, 1, False, "none", "s512", 4),
    "c": (2, 1, False, "none", "s512", 4),
    "d": (1, 1, True, "none", "s512", 4),
    "e": (1, 1, True, "int8", "s512", 4),
    "f": (1, 2, False, "none", "s1024", 2),
    "g": (2, 2, False, "none", "s1024", 1),
}
WHAT = {
    "a": "stage-1 loop, data N, ZeRO-2, K8 on every resnet conv",
    "b": "LoRA stage, data N, ZeRO-2",
    "c": "LoRA stage, data N/2 x tensor_parallel 2",
    "d": "LoRA stage, shard_base_params (FSDP) at data N",
    "e": "LoRA stage, shard_base_params over an int8 base (QLoRA)",
    "f": "LoRA stage, data N/2 x sequence_parallel 2",
    "g": "LoRA stage, tensor_parallel 2 x sequence_parallel 2",
    "h": "serving, InferenceServer(tp_group=) at tensor_parallel N",
    "i": "LoRA stage, should_stop(sync=True) after SIGTERM to one rank",
}


def _ref_key(run: str) -> str:
    _, _, _, quant, size, pairs = LORA_RUNS[run]
    return f"lora_{quant}_{size}_{pairs}"


def _fits(run: str, world: int, scale: "Scale") -> bool:
    """Whether the run's layout divides the world (and its heads)."""
    if run in LORA_RUNS:
        tp, sp, _, _, _, pairs = LORA_RUNS[run]
        return world % (tp * sp) == 0 and pairs % (world // (tp * sp)) == 0
    if run == "h":
        return scale.transformer().num_attention_heads % world == 0
    return world >= 2


# ---------------------------------------------------------------------------
# Assets, written by the reference process
# ---------------------------------------------------------------------------
def _png(path: Path, size, rng) -> None:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    low = rng.uniform(size=(8, 8, 4)).astype(np.float32)   # a smooth field: noise would not compress
    Image.fromarray((low * 255).astype(np.uint8), mode="RGBA").resize(size, resample=3).save(path)


def write_assets(work: Path, scale: Scale) -> None:
    """The RGB `ae` checkpoint and LPIPS weights of the stage-1 loop, its
    components tree (16 train pairs), and the LoRA pair trees."""
    import torch

    from ragb_vae_tpu_torch.models.lpips import random_lpips
    from ragb_vae_tpu_torch.models.vae import AutoencoderKL
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    rng = np.random.default_rng(SEED)
    cfg = scale.vae(3)
    torch.manual_seed(SEED)
    save_autoencoder_params(cfg, AutoencoderKL(cfg, device=scale.device).state_dict(), work / "ae_rgb")
    state = {}
    for name, value in random_lpips(SEED).state_dict().items():
        if name.startswith("conv"):                 # conv{idx}_{weight,bias} -> the vgg Sequential key
            idx, kind = name[4:].split("_")
            state[f"features.{idx}.{kind}"] = value
        elif name.startswith("lin"):
            state[f"{name}.model.1.weight"] = value.reshape(1, -1, 1, 1)
    torch.save(state, work / "lpips.pt")
    s = scale.stage_size
    bucket, manifest = f"w{s}-h{s}", []
    for i in range(16):
        rels = {kind: f"train/{bucket}/pair{i}_{kind}.png" for kind in ("component", "composite")}
        for rel in rels.values():
            _png(work / "stage1" / rel, (s, s), rng)
        manifest.append({"split": "train", "bucket": bucket, "bucket_dims": [s, s],
                         "component_path": rels["component"], "composite_path": rels["composite"],
                         "source_sample": f"pair{i}", "component_index": 0, "original_size": [s, s]})
    (work / "stage1" / "metadata").mkdir(parents=True)
    (work / "stage1" / "metadata" / "manifest.json").write_text(json.dumps(manifest))
    for size, pairs in ((scale.s512, 4), (scale.s1024, 2), (scale.s1024, 1)):
        for kind in ("gt", "text_alpha"):
            for i in range(pairs):
                _png(work / f"pairs_{size}_{pairs}" / "train" / f"w{size}-h{size}" / kind / f"pair{i}.png",
                     (size, size), rng)


def stage1_config(work: Path, scale: Scale, *, ckpt: str, max_steps: int, resume_from=None) -> dict:
    """configs/flux_vae.yaml overlaid: the seeded assets, a global batch of
    8, no validation, no preview, the blend off (its stream is per process)."""
    from ragb_vae_tpu_torch.config import load_config

    cfg = load_config(ROOT / "configs" / "flux_vae.yaml")
    data = work / "stage1"
    cfg["data"].update(bucket_root=str(data), batch_size=8, num_workers=2, background_blend_prob=0.0,
                       drop_last=True, bucket_datasets=[
                           {"type": "components", "root": str(data), "manifest": str(data / "metadata" / "manifest.json")}])
    cfg["training"].update(
        ckpt_dir=str(work / ckpt), max_steps=max_steps, log_every=1, ckpt_every_steps=2, run_validation=False,
        sample_vis_count=0, lpips_weights=str(work / "lpips.pt"), vae_tile_sample_size=scale.stage_size,
        handle_preemption=False, **({} if scale.cuda else {"mixed_precision": "no"}))
    if resume_from is not None:
        cfg["training"]["resume_from"] = str(resume_from)
    cfg["model"]["rgb_checkpoint"] = str(work / "ae_rgb")
    return cfg


def lora_config(work: Path, scale: Scale, size: int, pairs: int, *, steps: int, ckpt: str, **training) -> dict:
    return {
        "model": {"pretrained_model_name_or_path": f"random weights, seed {SEED}",
                  "rgba_vae_path": f"random weights, seed {SEED}"},
        "data": {"root": str(work / f"pairs_{size}_{pairs}"), "batch_size": pairs, "num_workers": 2},
        "training": {**LORA_CONFIG, "mixed_precision": scale.precision, "rank": scale.rank,
                     "lora_alpha": scale.alpha, "max_train_steps": steps, "grad_accum_steps": 1, "log_every": 1,
                     "ckpt_every_steps": 1000, "val_every_steps": 1000, "ckpt_dir": str(work / ckpt), **training},
    }


def attach_adapters(model, scale: Scale) -> None:
    """Rank-`scale.rank` fp32 adapters from SEED on every layout alike (the
    adapters are replicated), B drawn non-zero as chip_smoke draws it, so
    that A has a gradient in the first step."""
    import torch

    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters

    model.lora_rank, model.lora_alpha = scale.rank, float(scale.alpha)
    gen = torch.Generator(model.device).manual_seed(SEED)
    model.init_lora(gen)
    with torch.no_grad():
        for name, p in lora_parameters(model.transformer).items():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.01, generator=gen)


# ---------------------------------------------------------------------------
# Probes: the optimizer's gradient, timed and profiled steps
# ---------------------------------------------------------------------------
class OptimizerTap:
    """Around `ZeroAdamW.step` for a `with` block: the first call's clipped
    global gradient (each rank's shard all-gathered over the data axis),
    per parameter, on the host of `keep` (rank 0)."""

    def __init__(self, keep: bool):
        self.keep, self.grads = keep, None

    def __enter__(self):
        from ragb_vae_tpu_torch.parallel.mesh import all_gather
        from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW

        self.cls, self.real = ZeroAdamW, ZeroAdamW.step
        tap = self

        def step(opt, *args, **kwargs):
            inner = opt.inner.step

            def capture(*a, **k):
                if tap.grads is None:
                    full = all_gather(opt.shard.grad.detach(), opt.mesh)
                    tap.grads = {} if not tap.keep else {
                        id(p): full[off: off + n].view(p.shape).float().cpu()
                        for p, off, n in zip(opt.params, opt.layout.offsets, opt.layout.sizes)}
                return inner(*a, **k)

            opt.inner.step = capture
            try:
                return tap.real(opt, *args, **kwargs)
            finally:
                del opt.inner.step

        ZeroAdamW.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.real

    def named(self, named_params: dict) -> dict:
        return {name: self.grads[id(p)] for name, p in named_params.items() if id(p) in self.grads}


def _counts() -> dict:
    from ragb_vae_tpu_torch.parallel import fsdp, sequence_parallel, tensor_parallel, zero_step

    return {"zero": dict(zero_step.COUNTS), "tensor_parallel": dict(tensor_parallel.COUNTS),
            "fsdp": dict(fsdp.COUNTS), "sequence_parallel": dict(sequence_parallel.COUNTS)}


def _reset_counts() -> None:
    from ragb_vae_tpu_torch.parallel import fsdp, sequence_parallel, tensor_parallel, zero_step

    for module in (zero_step, tensor_parallel, fsdp, sequence_parallel):
        module.reset_counts()


def _launches() -> dict:
    from ragb_vae_tpu_torch.ops.kernels import flash_attention as fa
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    return {"K1": rb.CONV_LAUNCHES, "K2": rb.UPSAMPLE_LAUNCHES, "K3": fa.LAUNCHES, "K4": fa.DQ_LAUNCHES,
            "K5": fa.DKV_LAUNCHES, "K6": rb.CONV_BWD_LAUNCHES, "K7": rb.UPSAMPLE_BWD_LAUNCHES,
            "K8": rb.WINO_LAUNCHES, "K10": i8.LAUNCHES}


def _reset_launches() -> None:
    from ragb_vae_tpu_torch.ops.kernels import flash_attention as fa
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    for module in (rb, fa, i8):
        module.reset_launch_counts()


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_summary(fn, device, trace: Path) -> dict:
    """`fn()` once under torch.profiler (device activity only): the device
    span from the first kernel to the last, the share of it in NCCL kernels
    (their time includes waiting for the other cards) and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_slice import kernel_breakdown

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        _sync(device)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if str(e.get("cat", "")).lower() == "kernel"]
    trace.unlink()
    if not events:
        return {"profile": "not measured: the profiler recorded no kernels"}, out
    split = kernel_breakdown(events)
    nccl = sum(float(e.get("dur", 0.0)) for e in events if "nccl" in e["name"].lower()) / 1e3
    return {"span_ms": split["span_ms"], "kernel_ms": split["kernel_ms"], "nccl_ms": nccl,
            "nccl_share": nccl / split["span_ms"] if split["span_ms"] else None,
            "idle_share": split["idle_share"]}, out


class StepProbe:
    """Wraps a step function: call 0 is the held step (`on_held(out)` after
    it), calls 1..timed are timed on the synchronised wall clock (the
    collectives counted over call 1), the call after them runs under
    torch.profiler when `profiled`."""

    def __init__(self, device, timed: int, profiled: bool, trace: Path, on_held=None):
        self.device, self.timed, self.profiled, self.trace, self.on_held = device, timed, profiled, trace, on_held
        self.calls, self.times, self.counts, self.profile, self.held = 0, [], None, None, None
        self.resident_gib = None

    def wrap(self, step):
        import torch

        def run(*args, **kwargs):
            i = self.calls
            self.calls += 1
            if i == 0:
                if torch.device(self.device).type == "cuda":
                    self.resident_gib = torch.cuda.memory_allocated(self.device) / 2**30
                out = step(*args, **kwargs)
                _sync(self.device)
                if self.on_held is not None:
                    self.held = self.on_held(out)
                return out
            if i <= self.timed:
                if i == 1:
                    _reset_counts()
                _sync(self.device)
                t0 = time.perf_counter()
                out = step(*args, **kwargs)
                _sync(self.device)
                self.times.append(time.perf_counter() - t0)
                if i == 1:
                    self.counts = _counts()
                return out
            if self.profiled and self.profile is None:
                self.profile, out = profile_summary(lambda: step(*args, **kwargs), self.device, self.trace)
                return out
            return step(*args, **kwargs)
        return run


def _times(times) -> dict:
    if not times:
        return {"times_s": [], "median_s": None}
    return {"times_s": times, "median_s": statistics.median(times), "spread_s": max(times) - min(times)}


def _tflops(flops_global: float, world: int, seconds, device_name: str) -> dict:
    from ragb_vae_tpu_torch.ops.flops import peak_flops_for

    if not seconds:
        return {"model_tflops_per_card": None, "peak_share": None}
    per_card = flops_global / world / seconds / 1e12
    peak = peak_flops_for(device_name)
    return {"model_tflops_per_card": per_card, "peak_share": None if peak is None else per_card * 1e12 / peak}


def tree_errors(got: dict, want: dict, device) -> dict:
    """Worst leaf of two trees of the same names: relative error
    ||got - want|| / ||want||, lowest cosine. A leaf whose true gradient is
    zero (the attention key bias: softmax ignores a constant key shift) is
    left out: rounding noise alone decides it."""
    import torch

    assert set(got) == set(want), (sorted(set(got) ^ set(want))[:5])
    worst = {"rel": 0.0, "cos": 1.0, "rel_leaf": None, "cos_leaf": None, "leaves": 0}
    for k in want:
        if "to_k" in k and "bias" in k:
            continue
        g, w = got[k].to(device, torch.float32).flatten(), want[k].to(device, torch.float32).flatten()
        wn, gn = float(w.norm()), float(g.norm())
        if wn == 0.0 and gn == 0.0:
            continue
        rel = float((g - w).norm()) / max(wn, 1e-30)
        cos = float(torch.dot(g, w)) / max(wn * gn, 1e-30)
        worst["leaves"] += 1
        if rel > worst["rel"] or worst["rel_leaf"] is None:
            worst["rel"], worst["rel_leaf"] = rel, k
        if cos < worst["cos"] or worst["cos_leaf"] is None:
            worst["cos"], worst["cos_leaf"] = cos, k
    return worst


def _check(name: str, value, bound, ok: bool) -> dict:
    return {"check": name, "value": value, "bound": bound, "ok": bool(ok)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# The LoRA stage, one run or its reference
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _saves_stubbed(model):
    """The stage's saves stubbed out (chip_smoke's `_train_without_saving`):
    the adapters, the metadata and the AdamW state are 4.3 GB at full width.
    The optimizer's gathered state dict is still made (a collective)."""
    import torch

    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as stage

    metadata, save = stage.write_lora_metadata, torch.save
    model.save_lora_weights = lambda output_dir: None
    stage.write_lora_metadata = lambda *args, **kwargs: None
    torch.save = lambda *args, **kwargs: None
    try:
        yield
    finally:
        del model.save_lora_weights
        stage.write_lora_metadata, torch.save = metadata, save


def lora_step_run(model, cfg: dict, scale: Scale, keep: bool, trace: Path) -> dict:
    """`train_from_config(cfg, model=model)` with the first step held (loss,
    gradient norm, the clipped gradient tree, each adapter's change; on the
    host of `keep`) and the next ones timed and profiled."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters, lora_state
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as stage

    named = lora_parameters(model.transformer)
    before = lora_state(model.transformer) if keep else None

    def on_held(out):
        loss, _, grad_norm = out
        held = {"loss": float(loss), "grad_norm": float(grad_norm)}
        if keep:
            after = lora_state(model.transformer)
            held["update"] = {k: after[k] - before[k] for k in after}
        return held

    probe = StepProbe(model.device, scale.timed, scale.profiled, trace, on_held=on_held)
    real = stage.make_lora_train_step
    stage.make_lora_train_step = lambda *a, **k: probe.wrap(real(*a, **k))
    try:
        with OptimizerTap(keep) as tap, _saves_stubbed(model):
            result = stage.train_from_config(cfg, model=model, device=model.device)
    finally:
        stage.make_lora_train_step = real
    held = probe.held
    if keep:
        held["grads"] = tap.named(named)
    return {"held": held, "result": result, "probe": probe}


# ---------------------------------------------------------------------------
# The reference process (world 1)
# ---------------------------------------------------------------------------
def _serve(server, image: np.ndarray, seed: int) -> np.ndarray:
    return server.submit(image, seed=seed).result(timeout=900)


def _request(size: int) -> np.ndarray:
    rng = np.random.default_rng(SEED + size)
    from PIL import Image

    low = (rng.uniform(size=(8, 8, 4)) * 255).astype(np.uint8)
    return np.asarray(Image.fromarray(low, "RGBA").resize((size, size), resample=3), np.float32) / 255.0


def stage1_run(scale: Scale, cfg: dict, keep: bool, trace: Path) -> dict:
    """`run_stage(cfg)` with its step wrapped: per call the loss and gradient
    norm; the clipped gradient tree of call 0 and every trainable
    parameter's change over calls 0-1 (on the host of `keep`); the calls
    after the first timed and profiled (`StepProbe`)."""
    import torch

    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb
    from ragb_vae_tpu_torch.training import rgba_vae_stage as stage
    from ragb_vae_tpu_torch.training import run_stage

    record = {"losses": [], "grad_norms": []}
    make_step = stage.make_train_step
    probe = None

    def wrapped_make_step(model, *args, **kwargs):
        nonlocal probe
        step = make_step(model, *args, **kwargs)
        named = {n: p for n, p in model.module.named_parameters() if p.requires_grad}
        record["named"] = named
        if keep:
            record["before"] = {n: p.detach().float().cpu().clone() for n, p in named.items()}

        def logged(batch, **kw):
            out = step(batch, **kw)
            record["losses"].append(float(out["train/loss"]))
            record["grad_norms"].append(float(out["train/grad_norm"]))
            if keep and len(record["losses"]) == 2:
                record["update"] = {n: p.detach().float().cpu() - record["before"][n] for n, p in named.items()}
            return out

        probe = StepProbe(scale.device, scale.timed, scale.profiled, trace)
        return probe.wrap(logged)

    stage.make_train_step = wrapped_make_step
    if scale.cuda:
        rb.CONV_ALGO = "winograd"                  # K8 on every aligned resnet conv, as chip_smoke's stage1 phase
    try:
        with OptimizerTap(keep) as tap:
            result = run_stage(cfg, device=scale.device)
    finally:
        stage.make_train_step = make_step
        rb.CONV_ALGO = "direct"
    if keep:
        record["grads"] = tap.named(record["named"])
    record.pop("named", None)
    record.pop("before", None)
    if scale.cuda:
        torch.cuda.empty_cache()
    return {"record": record, "result": result, "probe": probe}


def reference(work: Path, scale: Scale, runs: str) -> None:
    import torch

    from ragb_vae_tpu_torch.models.flux_weights import load_lora_state, lora_state
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    t0 = time.perf_counter()
    write_assets(work, scale)
    print(f"[ref] assets written in {time.perf_counter() - t0:.1f} s", flush=True)
    refs_dir = work / "refs"
    refs_dir.mkdir()
    trace = work / "trace_ref.json"

    def save(name, obj):
        torch.save(obj, refs_dir / f"{name}.pt")

    keys = sorted({_ref_key(r) for r in runs if r in LORA_RUNS})
    bf16_keys = [k for k in keys if "_int8_" not in k]
    if "h" in runs or bf16_keys:
        t0 = time.perf_counter()
        model = scale.model()
        print(f"[ref] built the whole model on {scale.device} in {time.perf_counter() - t0:.1f} s", flush=True)
        if "h" in runs:
            server = InferenceServer(model, ServeConfig(max_batch=1, steps=SERVE_STEPS, auto_batch=False)).start()
            answers = {}
            for size in (scale.s512, scale.s1024):
                answers[size] = _serve(server, _request(size), SERVE_SEED)
                t = time.perf_counter()
                _serve(server, _request(size), SERVE_SEED)
                answers[f"{size}_s"] = time.perf_counter() - t
            server.stop()
            save("serve", answers)
            print(f"[ref] served {scale.s512}^2 and {scale.s1024}^2 on one card "
                  f"({answers[f'{scale.s512}_s']:.3f} / {answers[f'{scale.s1024}_s']:.3f} s)", flush=True)
        if bf16_keys:
            attach_adapters(model, scale)
            start = lora_state(model.transformer)
            for key in bf16_keys:
                _, quant, size, pairs = key.split("_")
                load_lora_state(model.transformer, start)
                size = getattr(scale, size)
                out = lora_step_run(model, lora_config(work, scale, size, int(pairs), steps=1, ckpt=f"ref_{key}"),
                                    scale, True, trace)
                save(key, _stored(out["held"]))
                print(f"[ref] {key}: loss {out['held']['loss']:.6f}, grad norm {out['held']['grad_norm']:.6f}",
                      flush=True)
        del model
        gc.collect()
        if scale.cuda:
            torch.cuda.empty_cache()
    for key in [k for k in keys if "_int8_" in k]:
        _, quant, size, pairs = key.split("_")
        model = scale.model(quant="int8")
        attach_adapters(model, scale)
        out = lora_step_run(model, lora_config(work, scale, getattr(scale, size), int(pairs), steps=1,
                                               ckpt=f"ref_{key}", weight_quant="int8"), scale, True, trace)
        save(key, _stored(out["held"]))
        print(f"[ref] {key}: loss {out['held']['loss']:.6f}, grad norm {out['held']['grad_norm']:.6f}", flush=True)
        del model, out
        gc.collect()
        if scale.cuda:
            torch.cuda.empty_cache()
    if "a" in runs:
        out = stage1_run(scale, stage1_config(work, scale, ckpt="ref_stage1", max_steps=3), True, trace)
        rec = out["record"]
        save("stage1", {"losses": rec["losses"], "grad_norms": rec["grad_norms"],
                        "grads": rec["grads"], "update": rec["update"]})
        print(f"[ref] stage-1 losses {rec['losses']}, gradient norms {rec['grad_norms']}", flush=True)


def _stored(held: dict) -> dict:
    """The held step on disk: the trees in bf16 (their bounds are 0.05 and
    more; bf16 keeps 2^-8), the scalars as they are."""
    import torch

    return {"loss": held["loss"], "grad_norm": held["grad_norm"],
            **{k: {n: t.to(torch.bfloat16) for n, t in held[k].items()} for k in ("grads", "update")}}


# ---------------------------------------------------------------------------
# The ranks (torchrun)
# ---------------------------------------------------------------------------
class Ctx:
    def __init__(self, work: Path, scale: Scale):
        import torch
        import torch.distributed as dist

        from ragb_vae_tpu_torch.parallel.mesh import local_device, maybe_init_distributed

        self.work, self.scale = work, scale
        device = local_device(scale.device)
        if not maybe_init_distributed(device):
            raise SystemExit("no process group: run the ranks under torchrun")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.device = device
        self.backend = dist.get_backend()
        if scale.cuda:
            if self.backend != "nccl" or torch.cuda.current_device() != device.index:
                raise SystemExit(f"rank {self.rank}: backend {self.backend} on cuda:{torch.cuda.current_device()}, "
                                 f"expected nccl on {device}")
            self.name = torch.cuda.get_device_name(device)
        else:
            self.name = "cpu"
            from ragb_vae_tpu_torch.parallel import sharding

            sharding.DEFAULT_MIN_SHARD_SIZE = 2 ** 12   # the tiny model's leaves are under JAX's 2**16
        self.scale.device = str(device)
        self.trace = work / f"trace_r{self.rank}.json"

    def gather(self, obj):
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def memory(self) -> dict:
        import torch

        if not self.scale.cuda:
            return {"resident_gib": "not measured (CPU)", "peak_gib": "not measured (CPU)"}
        return {"resident_gib": torch.cuda.memory_allocated(self.device) / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated(self.device) / 2**30}

    def reset_peak(self) -> None:
        import torch

        gc.collect()
        if self.scale.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def check_launches(self, launches: dict, needed) -> list:
        """On the card every kernel of the path must have launched on every rank."""
        if not self.scale.cuda:
            return []
        per_rank = self.gather(launches)
        missing = [(r, k) for r, counts in enumerate(per_rank) for k in needed if counts[k] <= 0]
        return [_check("kernels launched on every rank: " + ", ".join(needed), per_rank[0], "> 0 each",
                       not missing)]


def _load_ref(ctx: Ctx, name: str):
    import torch

    return torch.load(ctx.work / "refs" / f"{name}.pt", weights_only=False)


def rank_stage1(ctx: Ctx) -> dict:
    from ragb_vae_tpu_torch.ops.flops import vae_train_step_flops

    scale, keep = ctx.scale, ctx.rank == 0
    ctx.reset_peak()
    _reset_launches()
    first = stage1_run(scale, stage1_config(ctx.work, scale, ckpt="stage1", max_steps=2), keep, ctx.trace)
    launches = _launches()
    from ragb_vae_tpu_torch.training import checkpoint as ckpt_lib

    step2 = ckpt_lib.checkpoint_dir(ctx.work / "stage1", 2)
    second = stage1_run(scale, stage1_config(ctx.work, scale, ckpt="stage1_more",
                                             max_steps=1 + scale.timed + int(scale.profiled), resume_from=step2),
                        False, ctx.trace)
    memory = ctx.gather(ctx.memory())
    probe = second["probe"]
    profiles = ctx.gather(probe.profile)
    out = {"memory": memory, "resident_at_step_gib": ctx.gather(first["probe"].resident_gib), **_times(probe.times),
           "collectives_a_step": probe.counts, "profile": profiles,
           **_tflops(8 * vae_train_step_flops(scale.vae(), scale.stage_size, lpips=True), ctx.world,
                     statistics.median(probe.times) if probe.times else None, ctx.name)}
    checks = ctx.check_launches(launches, ["K8", "K6", "K2", "K7", "K3"])
    if keep:
        ref = _load_ref(ctx, "stage1")
        rec = first["record"]
        losses = rec["losses"] + second["record"]["losses"][:1]
        norms = rec["grad_norms"] + second["record"]["grad_norms"][:1]
        for i, (got, want) in enumerate(zip(losses, ref["losses"])):
            checks.append(_check(f"step {i + 1} loss vs one card ({got:.6f} / {want:.6f})", _rel(got, want),
                                 LOSS_RTOL, _rel(got, want) <= LOSS_RTOL))
        # The norm is held at step 1, where both runs have the same weights.
        # After an update the weights differ by AdamW's sign-flip noise (the
        # worst parameter's change below) and the norm of the next gradient
        # moves with them (it swings 5.9 -> 1.4 -> 4.0 over these steps): the
        # later norms are printed, not held.
        out["grad_norms"] = {"run": norms, "one_card": ref["grad_norms"][:len(norms)]}
        got, want = norms[0], ref["grad_norms"][0]
        checks.append(_check(f"step 1 gradient norm vs one card ({got:.6f} / {want:.6f})",
                             _rel(got, want), GRAD_NORM_RTOL, _rel(got, want) <= GRAD_NORM_RTOL))
        g = tree_errors(rec["grads"], ref["grads"], ctx.device)
        checks.append(_check("step 1 clipped gradient tree, worst leaf (relative error, cosine)",
                             [g["rel"], g["cos"], g["rel_leaf"]], list(GRAD_TOL),
                             g["rel"] <= GRAD_TOL[0] and g["cos"] >= GRAD_TOL[1]))
        u = tree_errors(rec["update"], ref["update"], ctx.device)
        checks.append(_check("worst parameter's change after step 2 (relative error, cosine)",
                             [u["rel"], u["cos"], u["rel_leaf"]], list(UPDATE_TOL),
                             u["rel"] <= UPDATE_TOL[0] and u["cos"] >= UPDATE_TOL[1]))
        out["launches"] = launches
    out["checks"] = checks
    return out


def rank_lora(ctx: Ctx, run: str) -> dict:
    from ragb_vae_tpu_torch.ops.flops import lora_train_step_flops
    from ragb_vae_tpu_torch.parallel import fsdp as fsdp_lib
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh

    scale = ctx.scale
    tp, sp, shard, quant, size_key, pairs = LORA_RUNS[run]
    size = getattr(scale, size_key)
    data, model_mesh, _ = create_training_mesh(tp=tp, sp=sp)
    ctx.reset_peak()
    t0 = time.perf_counter()
    model = scale.model(quant=quant, tp=model_mesh if tp > 1 else None, fsdp=data if shard else None)
    attach_adapters(model, scale)
    build_s = time.perf_counter() - t0
    resident = ctx.gather(ctx.memory())
    base = fsdp_lib.shard_bytes(model.transformer)
    training = {"tensor_parallel": tp, "sequence_parallel": sp, "shard_base_params": shard, "weight_quant": quant}
    cfg = lora_config(ctx.work, scale, size, pairs, steps=1 + scale.timed + int(scale.profiled), ckpt=f"lora_{run}",
                      **training)
    _reset_launches()
    keep = ctx.rank == 0
    res = lora_step_run(model, cfg, scale, keep, ctx.trace)
    launches = _launches()
    probe = res["probe"]
    img_seq = 2 * (size // (2 * scale.vae().spatial_scale_factor)) ** 2      # the packed cond + target tokens
    flops = pairs * lora_train_step_flops(scale.transformer(), img_seq, scale.prompt_len)
    out = {"layout": {"data": data.size, "tensor_parallel": tp, "sequence_parallel": sp, "fsdp": shard,
                      "weight_quant": quant, "size": size, "pairs": pairs},
           "build_s": build_s, "resident_after_build": resident, "resident_at_step_gib": ctx.gather(probe.resident_gib),
           "memory": ctx.gather(ctx.memory()),
           "base_bytes_rank0": base, **_times(probe.times), "collectives_a_step": probe.counts,
           "profile": ctx.gather(probe.profile),
           **_tflops(flops, ctx.world, statistics.median(probe.times) if probe.times else None, ctx.name)}
    needed = ["K3", "K4", "K5", "K1"] + (["K10"] if quant == "int8" else [])
    checks = ctx.check_launches(launches, needed)
    if keep:
        ref = _load_ref(ctx, _ref_key(run))
        held = res["held"]
        checks.append(_check(f"loss vs one card ({held['loss']:.6f} / {ref['loss']:.6f})",
                             _rel(held["loss"], ref["loss"]), LOSS_RTOL, _rel(held["loss"], ref["loss"]) <= LOSS_RTOL))
        checks.append(_check(f"gradient norm vs one card ({held['grad_norm']:.6f} / {ref['grad_norm']:.6f})",
                             _rel(held["grad_norm"], ref["grad_norm"]), GRAD_NORM_RTOL,
                             _rel(held["grad_norm"], ref["grad_norm"]) <= GRAD_NORM_RTOL))
        g = tree_errors(held["grads"], ref["grads"], ctx.device)
        checks.append(_check("clipped gradient tree, worst leaf (relative error, cosine)",
                             [g["rel"], g["cos"], g["rel_leaf"]], list(GRAD_TOL),
                             g["rel"] <= GRAD_TOL[0] and g["cos"] >= GRAD_TOL[1]))
        u = tree_errors(held["update"], ref["update"], ctx.device)
        checks.append(_check("adapters' change in the step, worst leaf (relative error, cosine)",
                             [u["rel"], u["cos"], u["rel_leaf"]], list(UPDATE_TOL),
                             u["rel"] <= UPDATE_TOL[0] and u["cos"] >= UPDATE_TOL[1]))
        out["launches"] = launches
    out["checks"] = checks
    del model, res
    return out


def rank_serve(ctx: Ctx) -> dict:
    from ragb_vae_tpu_torch.ops.flops import textalpha_sample_flops
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh, group_timeout
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    scale = ctx.scale
    _, tp, _ = create_training_mesh(tp=ctx.world)
    ctx.reset_peak()
    model = scale.model(tp=tp)
    resident = ctx.gather(ctx.memory())
    server = InferenceServer(model, ServeConfig(max_batch=1, steps=SERVE_STEPS, auto_batch=False), tp_group=tp)
    _reset_launches()
    out = {"group_timeout_s": group_timeout(tp, ctx.device).total_seconds(), "resident_after_build": resident}
    if tp.rank > 0:
        out["batches"] = server.serve_worker()
        launches = _launches()
    else:
        server.start()
        answers, per_size = {}, {}
        for size in (scale.s512, scale.s1024):
            image = _request(size)
            answers[size] = _serve(server, image, SERVE_SEED)          # the held request, and the warm-up
            times = []
            for _ in range(scale.timed):
                t0 = time.perf_counter()
                _serve(server, image, SERVE_SEED)
                times.append(time.perf_counter() - t0)
            per_size[size] = {**_times(times), **_tflops(
                textalpha_sample_flops(scale.transformer(), scale.vae(), size, SERVE_STEPS, scale.prompt_len),
                ctx.world, statistics.median(times) if times else None, ctx.name)}
        if scale.profiled:
            per_size[scale.s512]["profile_rank0"], _ = profile_summary(
                lambda: _serve(server, _request(scale.s512), SERVE_SEED), ctx.device, ctx.trace)
        server.stop()
        launches = _launches()
        out.update(answers=answers, per_size=per_size)
    memory = ctx.gather(ctx.memory())
    checks = ctx.check_launches(launches, ["K1", "K2", "K3"])
    result = {"memory": memory, "group_timeout_s": out["group_timeout_s"],
              "resident_after_build": resident, "checks": checks}
    if ctx.rank == 0:
        ref = _load_ref(ctx, "serve")
        for size in (scale.s512, scale.s1024):
            got, want = out["answers"][size].reshape(-1), ref[size].reshape(-1)
            rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            cos = float(np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want)))
            checks.append(_check(f"{size}^2 answer vs the whole model on one card (relative error, cosine)",
                                 [rel, cos], list(ANSWER_TOL), rel <= ANSWER_TOL[0] and cos >= ANSWER_TOL[1]))
        result["per_size"] = out["per_size"]
        result["one_card_s"] = {size: ref[f"{size}_s"] for size in (scale.s512, scale.s1024)}
        result["launches"] = launches
    result["worker_batches"] = ctx.gather(out.get("batches"))
    del model, server
    return result


def rank_preempt(ctx: Ctx) -> dict:
    import torch.distributed as dist

    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as stage

    scale = ctx.scale
    model = scale.model(depth=(2, 4))
    attach_adapters(model, scale)
    cfg = lora_config(ctx.work, scale, scale.s512, 4, steps=3, ckpt="preempt")
    cfg["data"]["batch_size"] = 4 if 4 % ctx.world == 0 else ctx.world
    killer = ctx.world - 1

    def log_fn(step, metrics):
        if ctx.rank == killer and step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    result = stage.train_from_config(cfg, model=model, device=model.device, log_fn=log_fn)
    results = ctx.gather(result)
    dist.barrier()
    checks = [_check("every rank preempted at step 1", [r.get("global_step") for r in results], 1.0,
                     all(r.get("preempted") == 1.0 and r.get("global_step") == 1.0 for r in results))]
    if ctx.rank == 0:
        entries = sorted(p.name for p in (ctx.work / "preempt").iterdir())
        complete = (ctx.work / "preempt" / "checkpoint-1" / stage.TRAIN_STATE_FILE).exists()
        checks.append(_check("one complete checkpoint-1 and no final", entries,
                             ["checkpoint-1", "metrics.jsonl"], entries == ["checkpoint-1", "metrics.jsonl"]
                             and complete))
    del model
    return {"signalled_rank": killer, "checks": checks}


def ranks(work: Path, scale: Scale, runs: str) -> None:
    import torch.distributed as dist

    ctx = Ctx(work, scale)
    for run in runs:
        if not _fits(run, ctx.world, scale):
            if ctx.rank == 0:
                _record(work, run, {"skipped": f"its layout does not divide world {ctx.world}"}, ctx)
            continue
        t0 = time.perf_counter()
        try:
            if run == "a":
                out = rank_stage1(ctx)
            elif run in LORA_RUNS:
                out = rank_lora(ctx, run)
            elif run == "h":
                out = rank_serve(ctx)
            else:
                out = rank_preempt(ctx)
        except BaseException:
            (work / f"error_{run}_r{ctx.rank}.txt").write_text(traceback.format_exc())
            raise
        ctx.reset_peak()
        dist.barrier()
        if ctx.rank == 0:
            out["wall_s"] = time.perf_counter() - t0
            _record(work, run, out, ctx)
    dist.destroy_process_group()


def _record(work: Path, run: str, out: dict, ctx=None) -> None:
    out = {"run": run, "what": WHAT[run], **({"world": ctx.world, "backend": ctx.backend, "card": ctx.name}
                                            if ctx is not None else {}), **out}
    if "skipped" not in out:
        out["ok"] = all(c["ok"] for c in out.get("checks", [])) and bool(out.get("checks"))
    line = json.dumps(out, default=_plain)
    with open(work / "results.jsonl", "a") as f:
        f.write(line + "\n")
    print(f"[{run}] {line}", flush=True)


def _plain(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    return str(o)


def resume(work: Path, scale: Scale) -> None:
    """Run (a)'s world-N step-2 checkpoint resumed at world 1 for step 3."""
    from ragb_vae_tpu_torch.training import checkpoint as ckpt_lib

    step2 = ckpt_lib.checkpoint_dir(work / "stage1", 2)
    out = stage1_run(scale, stage1_config(work, scale, ckpt="stage1_resumed", max_steps=1, resume_from=step2),
                     False, work / "trace_resume.json")
    got = out["record"]["losses"][0]
    import torch

    want = torch.load(work / "refs" / "stage1.pt", weights_only=False)["losses"][2]
    _record(work, "a", {"resumed_at_world_1": True, "checks": [
        _check(f"step 3 loss, resumed at world 1 from the world-N step-2 checkpoint, vs one card "
               f"({got:.6f} / {want:.6f})", _rel(got, want), LOSS_RTOL, _rel(got, want) <= LOSS_RTOL),
        _check("resumed at global step 3", out["result"].get("global_step"), 3.0,
               out["result"].get("global_step") == 3.0)]})


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def _launch(cmd, log: Path, timeout: float, env) -> int:
    print(f"[launcher] {' '.join(str(c) for c in cmd[-8:])} (log {log})", flush=True)
    t0 = time.perf_counter()
    with open(log, "a") as sink:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, stdout=sink, stderr=subprocess.STDOUT, timeout=timeout, env=env).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    print(f"[launcher] exit {rc} after {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--runs", default=None, help=f"a subset of {ALL_RUNS}, in order (default: all on the card, "
                                                      f"{CPU_RUNS} on the CPU)")
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "dist_multicard.json"))
    parser.add_argument("--timeout", type=float, default=1500.0)
    parser.add_argument("--role", choices=("launcher", "reference", "ranks", "resume"), default="launcher")
    parser.add_argument("--work", default=None)
    args = parser.parse_args(argv)
    runs = args.runs or (ALL_RUNS if args.device != "cpu" else CPU_RUNS)
    if set(runs) - set(ALL_RUNS):
        parser.error(f"unknown runs {sorted(set(runs) - set(ALL_RUNS))}")
    runs = "".join(r for r in ALL_RUNS if r in runs)
    if args.role != "launcher":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.device == "cpu":
            torch.set_num_threads(1)
        scale, work = Scale(args.device), Path(args.work)
        {"reference": lambda: reference(work, scale, runs), "ranks": lambda: ranks(work, scale, runs),
         "resume": lambda: resume(work, scale)}[args.role]()
        return 0

    t_start = time.perf_counter()
    summary: dict = {"nproc": args.nproc, "device": args.device, "runs": {}}
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"needs {args.nproc} CUDA devices, found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(smi, flush=True)
        summary["cards"] = smi.splitlines()
        summary["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    logs = Path(args.out).parent / "dist_multicard_logs"
    logs.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONUNBUFFERED": "1"}
    me = [sys.executable, str(Path(__file__).resolve())]
    common = ["--device", args.device, "--timeout", str(args.timeout)]
    with tempfile.TemporaryDirectory(prefix="dist_multicard_") as tmp:
        work = Path(tmp)
        common += ["--work", str(work)]
        rc = _launch(me + ["--role", "reference", "--runs", runs] + common, logs / "reference.log",
                     args.timeout, env)
        if rc != 0:
            summary["reference"] = f"failed (exit {rc}); see {logs / 'reference.log'}"
            pending = ""
        else:
            pending = runs
        done: set = set()
        while pending:
            torchrun = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(args.nproc),
                        "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
                        str(Path(__file__).resolve())]
            rc = _launch(torchrun + ["--role", "ranks", "--runs", pending] + common, logs / "ranks.log",
                         args.timeout, env)
            finished = _results(work)
            done |= set(finished)
            left = [r for r in pending if r not in done]
            if rc == 0 or not left:
                break
            failed = left[0]
            errors = {p.name: p.read_text()[-3000:] for p in sorted(work.glob(f"error_{failed}_r*.txt"))}
            summary["runs"][failed] = {"ok": False, "failed": f"the launch exited {rc} in this run", "errors": errors}
            print(f"[launcher] run {failed} failed (exit {rc}):\n" + "\n".join(errors.values()), flush=True)
            done.add(failed)
            pending = "".join(left[1:])
        if "a" in runs and "a" in done and "a" not in summary["runs"]:
            _launch(me + ["--role", "resume"] + common, logs / "resume.log", args.timeout, env)
        for run, records in _results(work).items():
            if run in summary["runs"]:
                continue
            merged = records[0] if len(records) == 1 else {**records[0], "resumed": records[1]}
            if len(records) > 1:
                merged["ok"] = records[0].get("ok", False) and records[1].get("ok", False)
            summary["runs"][run] = merged
        for run in runs:
            summary["runs"].setdefault(run, {"ok": False, "failed": "no result (see the logs)"})
    summary["wall_s"] = time.perf_counter() - t_start
    summary["ok"] = all(r.get("ok", False) or "skipped" in r for r in summary["runs"].values()) and bool(runs)
    text = json.dumps(summary, default=_plain)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    for run, r in summary["runs"].items():
        flags = [c for c in r.get("checks", [])] + [c for c in r.get("resumed", {}).get("checks", [])]
        print(f"[{run}] {'ok' if r.get('ok') else ('skipped' if 'skipped' in r else 'FAIL')}: {WHAT[run]}; "
              + "; ".join(f"{c['check']}: {c['value']} (bound {c['bound']}) {'ok' if c['ok'] else 'FAIL'}"
                          for c in flags), flush=True)
    print(json.dumps({"ok": summary["ok"], "wall_s": summary["wall_s"], "out": args.out}), flush=True)
    return 0 if summary["ok"] else 1


def _results(work: Path) -> dict:
    out: dict = {}
    path = work / "results.jsonl"
    if path.exists():
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            out.setdefault(rec["run"], []).append(rec)
    return out


if __name__ == "__main__":
    sys.exit(main())
