"""The RGBA-VAE training stage (stage 1): the objects `train_rgba_vae`
builds, driven step by step.

Set-up writes a seeded pool of RGBA (component, composite) pairs as PNGs
under TMPDIR in the stage's bucket layout, and builds what the stage builds:
`build_dataloader` (the component loader with the random background blend),
`_step_batches` and `cuda_prefetch`, the RGBA VAE in fp32 with bf16 compute
on the fused kernels and its gradient checkpointing, the frozen bf16
reference `ae`, LPIPS-VGG16, the clipped AdamW and `make_train_step`, over
weights drawn from the seed. It takes the first steps through that same
step and feed (the reference follows them), then times whole steps for
`--seconds`. Afterwards, with the program freed, the plain fp32 reference
runs the first steps on the same rows and noise and is compared.
"""
from __future__ import annotations

import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import harness, program
from perfbench.drivers import _train
from perfbench.reference import vae as RV
from perfbench.reference import weights as W
from perfbench.reference.numerics import Numerics, exact_fp32
from perfbench.yardstick import flops as FL


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """(pairs, 2, H, W, 4) uint8: each pair a component (a smooth layer with
    clear, edge and opaque pixels) and its composite over a smooth opaque
    background."""
    n, h, w = traffic["pool_pairs"], traffic["height"], traffic["width"]
    low = W.draw_like(seed, program.STREAM["images"], (n, 7, 10, 10), device, kind="uniform")
    img = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False).clamp(0.0, 1.0)
    alpha = torch.clamp((img[:, 3:4] - 0.5) * 5.0 + 0.5, 0.0, 1.0)
    comp = torch.cat([img[:, :3], alpha], dim=1)
    bg = img[:, 4:7]
    composite = torch.cat([img[:, :3] * alpha + bg * (1.0 - alpha), torch.ones_like(alpha)], dim=1)
    pairs = torch.stack([comp, composite], dim=1)
    return (pairs.permute(0, 1, 3, 4, 2) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def write_tree(root: Path, pool: np.ndarray) -> None:
    """The stage's component tree: `train/w{W}-h{H}/*.png` and `metadata/manifest.json`."""
    from PIL import Image

    h, w = pool.shape[2:4]
    bucket = f"w{w}-h{h}"
    (root / "train" / bucket).mkdir(parents=True)
    manifest = []
    for i, pair in enumerate(pool):
        rels = {}
        for kind, arr in zip(("component", "composite"), pair):
            rels[kind] = f"train/{bucket}/{i:04d}_{kind}.png"
            Image.fromarray(arr, "RGBA").save(root / rels[kind], compress_level=1)
        manifest.append({"split": "train", "bucket": bucket, "bucket_dims": [w, h],
                         "component_path": rels["component"], "composite_path": rels["composite"],
                         "source_sample": f"s{i}", "component_index": 0, "original_size": [w, h]})
    (root / "metadata").mkdir()
    (root / "metadata" / "manifest.json").write_text(json.dumps(manifest))


def check_rows(rows: torch.Tensor, pool: torch.Tensor) -> float:
    """The data stage the reference does not redo: each of a batch's B/2
    component rows is a pool component exactly, and the composite row B/2
    after it is that pair's composite (opaque, so the random background
    blend leaves it as it is). Returns the number of rows that are not."""
    bad = 0
    half = rows.shape[0] // 2
    for i in range(half):
        err = (pool[:, 0] - rows[i]).abs().flatten(1).amax(dim=1)
        j = int(torch.argmin(err))
        if float(err[j]) > 1e-6:
            bad += 2
        elif float((rows[half + i] - pool[j, 1]).abs().max()) > 1e-6:
            bad += 1
    return float(bad)


def run(record: harness.RunRecord, *, seed: int, device: torch.device) -> None:
    from ragb_vae_tpu_torch.data.loader import cuda_prefetch
    from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
    from ragb_vae_tpu_torch.parallel.mesh import create_mesh
    from ragb_vae_tpu_torch.training.rgba_vae_stage import _step_batches, build_dataloader
    from ragb_vae_tpu_torch.training.vae_step import (
        VaeStepConfig,
        init_train_state,
        make_optimizer,
        make_train_step,
        trainable_parameters,
    )

    cfg, traffic = record.config, record.traffic
    tr = cfg["training"]
    torch.set_num_threads(traffic.get("torch_threads", 4))
    compute = program.DTYPES[tr["mixed_precision"]] if device.type == "cuda" else torch.float32
    fused = device.type == "cuda"
    root = Path(tempfile.mkdtemp(prefix="perfbench_vae_"))
    try:
        pool = make_pool(traffic, seed, device)
        write_tree(root, pool)
        data_cfg = {"data": {
            "source": "bucket", "bucket_root": str(root), "batch_size": traffic["batch_size"],
            "num_workers": traffic["num_workers"], "shuffle": True, "seed": seed % 2**32,
            "background_blend_prob": tr["background_blend_prob"],
            "background_blend_targets": tr["background_blend_targets"],
            "background_color_range": tr["background_color_range"]}}
        loader = build_dataloader(data_cfg, split="train")

        state = program.vae_state(cfg, seed, device, torch.float32)
        model = program.build_rgba_vae(cfg, state, dtype=torch.float32, compute_dtype=compute,
                                       remat=tr["vae_gradient_checkpointing"], fused=fused)
        model.enable_tiling(None)
        ref_model = program.build_rgba_vae(cfg, {k: v.to(compute) for k, v in state.items()}, dtype=compute,
                                           fused=fused)
        ref_model.module.requires_grad_(False)
        ref_model.use_tiling, ref_model.tile_sample_size = model.use_tiling, model.tile_sample_size
        del state
        lpips_fn = program.build_lpips(seed, device, compute if compute != torch.float32 else None)
        loss_cfg = AlphaVaeLossConfig(reduce_mean=tr["loss_reduce_mean"], use_naive_mse=tr["use_naive_mse"])
        step_cfg = VaeStepConfig(kl_scale=tr["kl_scale"], ref_kl_scale=tr["ref_kl_scale"],
                                 lpips_scale=tr["lpips_scale"], gradient_accumulation_steps=1)
        params = trainable_parameters(model)
        names = [n for n, p in model.module.named_parameters() if p.requires_grad]
        mesh = create_mesh()
        optimizer = init_train_state(model, make_optimizer(params, tr["learning_rate"], betas=tuple(tr["betas"]),
                                                           max_grad_norm=tr["max_grad_norm"]), mesh=mesh)
        train_step = make_train_step(model, optimizer, loss_cfg, step_cfg, mesh=mesh, ref_model=ref_model,
                                     lpips_fn=lpips_fn)
        generator = torch.Generator(device).manual_seed(seed % 2**63)
        host_rng = np.random.default_rng(seed % 2**63)

        def feed():
            epoch = 0
            while True:
                loader.set_epoch(epoch)
                yield from cuda_prefetch(_step_batches(loader, skip=0, rng=host_rng, background_sample_prob=0.0,
                                                       n_micro=1, mesh=mesh), device)
                epoch += 1

        batches = feed()
        last: Dict[str, torch.Tensor] = {}

        def step(batch):
            batch.pop("n_real", None)
            last.update(train_step(batch, generator=generator))

        first = _train.FirstSteps(names, params, tr["betas"][0])
        for _ in range(traffic["followed_steps"]):
            batch = next(batches)
            first.batches.append({"images": batch["images"].detach().clone(), "weights": batch["weights"].clone()})
            step(batch)
            first.after_step(float(last["train/loss"]), optimizer)
        first.finish()

        tracer = harness.Tracer(device) if record.trace_on else None
        rows = first.batches[0]["images"].shape[0]
        w = _train.window(record, batches, step, device, items_per_step=rows, tracer=tracer,
                          trace_first=traffic["trace_step"], trace_steps=traffic["trace_steps"])
        final_loss = float(last["train/loss"])
        record.device_kind, record.memory_peak_bytes = harness.device_facts(device)
        record.e2e["vae_train_img_per_s"] = w["items"] / w["seconds"]
        record.attempted = w["steps"]
        record.failed = 0 if np.isfinite(final_loss) else 1
        record.trace = tracer.collect() if tracer is not None else None
        v = cfg["vae"]
        record.counters.update({
            "loader_wait_ms": w["loader_wait_ms"], "traced_steps": traffic["trace_steps"],
            "images_per_step": rows, "image_size": traffic["height"],
            "flops_per_image": FL.vae_train_step_flops(FL.as_config(v), traffic["height"]),
            "remat": tr["vae_gradient_checkpointing"]})
        record.notes.append(f"set-up {record.setup_s:.2f} s; {w['steps']} steps of {rows} images in "
                            f"{w['seconds']:.3f} s; first losses {first.losses}; last {final_loss}")

        del model, ref_model, lpips_fn, optimizer, train_step, params, batches, loader, last
        first.params = []
        harness.free_device_memory(device)
        t_ref = time.time()
        pool_t = torch.from_numpy(pool).to(device).float() / 255.0
        bad = sum(check_rows(b["images"], pool_t) for b in first.batches)
        del pool_t
        ref = follow(cfg, seed, device, first, names, Numerics("fp32"), traffic.get("reference_chunk", 2))
        record.checks.extend(_train.compare(first, ref, traffic["limits"], traffic["loss_steps"], record.notes))
        record.counters.update({"followed": first, "reference": ref, "names": names})
        record.checks.append(harness.Check("data_rows", bad, 0.0))
        record.notes.append(f"reference over {len(first.batches)} steps: {time.time() - t_ref:.1f} s; "
                            f"losses {ref.losses}; loss gap a step {_train.loss_gaps(first, ref)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def follow(cfg: dict, seed: int, device, prog: _train.FirstSteps, names: List[str], num: Numerics, chunk: int,
           *, half_batch: bool = False) -> _train.FirstSteps:
    """The plain reference's steps over the rows the program stepped, with
    the same posterior noise (the generator seeded as the program's), fp32
    AdamW and the global-norm clip. `half_batch` plants a fault: the loss
    over the first half of each batch only."""
    tr, v = cfg["training"], cfg["vae"]
    drawn = program.vae_state(cfg, seed, device, torch.float32)
    params = {k: drawn[k].detach().clone().requires_grad_(True) for k in names}
    frozen = {k: t.detach().clone() for k, t in drawn.items()}
    del drawn
    lp = program.lpips_state(seed, device)
    vae = RV.VaeReference(params, v, num)
    ref = RV.VaeReference(frozen, v, num)
    opt = torch.optim.AdamW([params[k] for k in names], lr=tr["learning_rate"], betas=tuple(tr["betas"]),
                            eps=tr["eps"], weight_decay=tr["weight_decay"])
    out = _train.FirstSteps(names, [params[k] for k in names], tr["betas"][0])
    gen = torch.Generator(device).manual_seed(seed % 2**63)
    scale = 2 ** (len(v["block_out_channels"]) - 1)
    with exact_fp32():
        for k, batch in enumerate(prog.batches):
            images = batch["images"]
            b, h, w = images.shape[:3]
            eps = torch.randn((b, h // scale, w // scale, v["latent_channels"]), generator=gen, device=device)
            rows = b // 2 if half_batch else b
            for p in params.values():
                p.grad = None
            total = 0.0
            for s in range(0, rows, chunk):
                loss, _ = RV.alphavae_loss(vae, ref, lp, images[s:s + chunk], eps[s:s + chunk], tr)
                (loss.sum() / rows).backward()
                total += float(loss.detach().sum()) / rows
            grads = [params[n].grad for n in names]
            _train.clip_(grads, tr["max_grad_norm"])
            if k == 0:
                out.grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
            out.losses.append(total)
            opt.step()
    out.finish()
    return out
