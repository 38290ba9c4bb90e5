"""The text-alpha LoRA stage (stage 2): the objects `train` builds, driven
step by step.

Set-up writes a seeded pool of (gt, text_alpha) pairs as PNGs under TMPDIR
in the stage's bucket layout and builds what the stage builds: the frozen
bf16 FLUX.1-Kontext transformer with per-block recompute and the RGBA VAE
(weights drawn from the seed), fp32 adapters of the configured rank on
every target linear, `TextAlphaBucketDataset` behind `BucketBatchSampler`
and the threaded `DataLoader`, `_padded_batches` and `cuda_prefetch`,
ZeRO AdamW over the adapters with the global-norm clip and the cosine
schedule, and `make_lora_train_step`. It takes the first steps through that
same step and feed, then times whole steps for `--seconds`. Afterwards,
with the program freed, the plain fp32 reference follows the first steps on
the same pairs and noise and is compared.
"""
from __future__ import annotations

import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import harness, program
from perfbench.drivers import _train
from perfbench.reference import flux as RF
from perfbench.reference import vae as RV
from perfbench.reference import weights as W
from perfbench.reference.numerics import Numerics, exact_fp32
from perfbench.yardstick import flops as FL


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """(pairs, 2, H, W, 4) uint8: a smooth RGBA design (gt) and its text
    layer (text_alpha: thin opaque strokes on a clear canvas)."""
    n, h, w = traffic["pool_pairs"], traffic["height"], traffic["width"]
    low = W.draw_like(seed, program.STREAM["pairs"], (n, 8, 12, 12), device, kind="uniform")
    img = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False).clamp(0.0, 1.0)
    gt = torch.cat([img[:, :3], torch.clamp((img[:, 3:4] - 0.3) * 6.0 + 0.5, 0.0, 1.0)], dim=1)
    strokes = torch.clamp(1.0 - (img[:, 4:5] - 0.5).abs() * 40.0, 0.0, 1.0)
    text = torch.cat([img[:, 5:8], strokes], dim=1)
    pairs = torch.stack([gt, text], dim=1)
    return (pairs.permute(0, 1, 3, 4, 2) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def write_tree(root: Path, pool: np.ndarray) -> None:
    """`train/w{W}-h{H}/{gt,text_alpha}/s{i}.png`, the stage's layout."""
    from PIL import Image

    h, w = pool.shape[2:4]
    base = root / "train" / f"w{w}-h{h}"
    for kind, k in (("gt", 0), ("text_alpha", 1)):
        (base / kind).mkdir(parents=True)
        for i, pair in enumerate(pool):
            Image.fromarray(pair[k], "RGBA").save(base / kind / f"s{i:04d}.png", compress_level=1)


def check_rows(gt: torch.Tensor, ta: torch.Tensor, pool: torch.Tensor) -> float:
    """The data stage the reference does not redo: each (gt, text_alpha) row
    is one pool pair exactly. Returns the number of rows that are not."""
    bad = 0
    for g, t in zip(gt, ta):
        err = (pool[:, 0] - g).abs().flatten(1).amax(dim=1)
        j = int(torch.argmin(err))
        if float(err[j]) > 1e-6 or float((pool[j, 1] - t).abs().max()) > 1e-6:
            bad += 1
    return float(bad)


def run(record: harness.RunRecord, *, seed: int, device: torch.device) -> None:
    from ragb_vae_tpu_torch.data.loader import DataLoader, cuda_prefetch
    from ragb_vae_tpu_torch.data.sampler import BucketBatchSampler
    from ragb_vae_tpu_torch.data.text_alpha_dataset import TextAlphaBucketDataset
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh, maybe_init_distributed
    from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import (
        _padded_batches,
        cosine_decay_schedule,
        make_lora_optimizer,
        make_lora_train_step,
    )

    cfg, traffic = record.config, record.traffic
    lo = cfg["lora"]
    torch.set_num_threads(traffic.get("torch_threads", 4))
    dtype = program.DTYPES[cfg["dtype"]] if device.type == "cuda" else torch.float32
    root = Path(tempfile.mkdtemp(prefix="perfbench_lora_"))
    try:
        pool = make_pool(traffic, seed, device)
        write_tree(root, pool)
        maybe_init_distributed(device)
        mesh, model_mesh, seq_mesh = create_training_mesh(tp=1, sp=1)
        model = program.build_textalpha_model(
            cfg, seed, device, dtype=dtype, remat=True, lora_rank=lo["rank"], lora_alpha=float(lo["lora_alpha"]))
        model.seq = seq_mesh
        lora = lora_parameters(model.transformer)
        names = list(lora)
        ds = TextAlphaBucketDataset(root, split="train")
        loader = DataLoader(ds, batch_sampler=BucketBatchSampler(
            ds.bucket_to_indices, batch_size=traffic["batch_size"], shuffle=True, drop_last=False,
            interleave=True, seed=seed % 2**32), num_workers=traffic["num_workers"])
        lr_schedule = cosine_decay_schedule(lo["learning_rate"], lo["max_train_steps"])
        optimizer = ZeroAdamW(make_lora_optimizer(
            list(lora.values()), lo["learning_rate"], betas=tuple(lo["betas"]), eps=lo["eps"],
            weight_decay=lo["weight_decay"], max_grad_norm=lo["max_grad_norm"]), mesh)
        n_micro = traffic["micro_batches"]
        train_step = make_lora_train_step(model, optimizer, n_micro, lr_schedule, mesh=mesh, model_mesh=model_mesh,
                                          seq_mesh=seq_mesh)
        generator = torch.Generator(device).manual_seed(seed % 2**63)

        def feed():
            epoch = 0
            while True:
                loader.set_epoch(epoch)
                yield from cuda_prefetch(_padded_batches(loader, n_micro), device)
                epoch += 1

        batches = feed()
        done = {"steps": 0, "loss": None}

        def step(batch):
            loss, _, _ = train_step(batch, generator, done["steps"])
            done["steps"] += 1
            done["loss"] = loss

        first = _train.FirstSteps(names, list(lora.values()), lo["betas"][0])
        for _ in range(traffic["followed_steps"]):
            batch = next(batches)
            first.batches.append({k: batch[k].detach().clone() for k in ("gt", "text_alpha")})
            step(batch)
            first.after_step(float(done["loss"]), optimizer)
        first.finish()

        tracer = harness.Tracer(device) if record.trace_on else None
        w = _train.window(record, batches, step, device, items_per_step=traffic["batch_size"], tracer=tracer,
                          trace_first=traffic["trace_step"], trace_steps=traffic["trace_steps"])
        final_loss = float(done["loss"])
        record.device_kind, record.memory_peak_bytes = harness.device_facts(device)
        record.e2e["lora_train_pairs_per_s"] = w["items"] / w["seconds"]
        record.attempted = w["steps"]
        record.failed = 0 if math.isfinite(final_loss) else 1
        record.trace = tracer.collect() if tracer is not None else None
        t = cfg["transformer"]
        scale = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        img_seq = 2 * (traffic["height"] // (2 * scale)) * (traffic["width"] // (2 * scale))
        record.counters.update({
            "loader_wait_ms": w["loader_wait_ms"], "traced_steps": traffic["trace_steps"],
            "pairs_per_step": traffic["batch_size"], "img_seq": img_seq, "txt_seq": cfg["prompt_len"],
            "flops_per_pair": FL.lora_train_step_flops(FL.as_config(t), img_seq, cfg["prompt_len"])})
        record.notes.append(f"set-up {record.setup_s:.2f} s; {w['steps']} steps of {traffic['batch_size']} pairs "
                            f"in {w['seconds']:.3f} s; first losses {first.losses}; last {final_loss}")

        del model, lora, optimizer, train_step, batches, loader, done
        first.params = []
        harness.free_device_memory(device)
        t_ref = time.time()
        pool_t = torch.from_numpy(pool).to(device).float() / 255.0
        bad = sum(check_rows(b["gt"], b["text_alpha"], pool_t) for b in first.batches)
        del pool_t
        ref = follow(cfg, traffic, seed, device, first, names, Numerics("fp32"))
        record.checks.extend(_train.compare(first, ref, traffic["limits"], traffic["loss_steps"], record.notes))
        record.counters.update({"followed": first, "reference": ref, "names": names})
        record.checks.append(harness.Check("data_rows", bad, 0.0))
        record.notes.append(f"reference over {len(first.batches)} steps: {time.time() - t_ref:.1f} s; "
                            f"losses {ref.losses}; loss gap a step {_train.loss_gaps(first, ref)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def follow(cfg: dict, traffic: dict, seed: int, device, prog: _train.FirstSteps, names: List[str], num: Numerics,
           *, half_batch: bool = False) -> _train.FirstSteps:
    """The plain reference's LoRA steps over the pairs the program stepped,
    with the same draws (the generator seeded as the program's: per step the
    condition's and the target's posterior noise, the flow noise, the
    timestep density), fp32 AdamW with the clip and the cosine schedule.
    `half_batch` plants a fault: the loss over the first half of each batch."""
    lo, v, t = cfg["lora"], cfg["vae"], cfg["transformer"]
    dtype = program.DTYPES[cfg["dtype"]] if device.type == "cuda" else torch.float32
    P = program.flux_state(cfg, seed, device, dtype)
    Pv = program.vae_state(cfg, seed, device, dtype)
    drawn = program.lora_state(cfg, seed, device, lo["rank"])
    adapters = {k: drawn[k].detach().clone().requires_grad_(True) for k in names}
    del drawn
    prompt, pooled = program.prompt_embeddings(cfg, seed, device)
    flux = RF.FluxReference(P, t, num, lora=adapters, lora_scale=lo["lora_alpha"] / lo["rank"], remat=True)
    vae = RV.VaeReference(Pv, v, num)
    opt = torch.optim.AdamW([adapters[k] for k in names], lr=lo["learning_rate"], betas=tuple(lo["betas"]),
                            eps=lo["eps"], weight_decay=lo["weight_decay"])
    out = _train.FirstSteps(names, [adapters[k] for k in names], lo["betas"][0])
    gen = torch.Generator(device).manual_seed(seed % 2**63)
    scale = 2 ** (len(v["block_out_channels"]) - 1)
    mu = RF.schedule_mu(cfg["scheduler"], (v["sample_size"] // scale) ** 2)
    with exact_fp32():
        for k, batch in enumerate(prog.batches):
            gt, ta = batch["gt"].float(), batch["text_alpha"].float()
            b, h, w = gt.shape[:3]
            shape = (b, h // scale, w // scale, v["latent_channels"])
            eps_c = torch.randn(shape, generator=gen, device=device)
            eps_t = torch.randn(shape, generator=gen, device=device)
            with torch.no_grad():
                cond = (RV.sample(*vae.encode(gt * 2.0 - 1.0), eps_c) - v["shift_factor"]) * v["scaling_factor"]
                target = (RV.sample(*vae.encode(ta * 2.0 - 1.0), eps_t) - v["shift_factor"]) * v["scaling_factor"]
            noise = torch.randn(shape, generator=gen, device=device)
            u = torch.sigmoid(torch.randn((b,), generator=gen, device=device))
            rows = b // 2 if half_batch else b
            for p in adapters.values():
                p.grad = None
            total = 0.0
            for s in range(rows):
                loss = RF.flow_matching_loss(flux, cfg["scheduler"], mu, cond[s:s + 1], target[s:s + 1],
                                             noise[s:s + 1], u[s:s + 1], prompt, pooled, cfg["guidance_scale"])
                (loss.sum() / rows).backward()
                total += float(loss.detach().sum()) / rows
            grads = [adapters[n].grad if adapters[n].grad is not None else torch.zeros_like(adapters[n])
                     for n in names]
            for n, g in zip(names, grads):
                adapters[n].grad = g
            _train.clip_(grads, lo["max_grad_norm"])
            if k == 0:
                out.grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
            frac = min(k, lo["max_train_steps"]) / lo["max_train_steps"]
            for group in opt.param_groups:
                group["lr"] = lo["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * frac))
            out.losses.append(total)
            opt.step()
    out.finish()
    return out
