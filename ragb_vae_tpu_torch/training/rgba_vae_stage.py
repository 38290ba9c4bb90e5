"""RGBA-VAE training stage (stage 1), on one process or data-parallel over many.

Counterpart of `ragb_vae_tpu/training/rgba_vae_stage.py`: the loop
`train_rgba_vae(cfg)` over a `{data, training, model}` config. It loads the
RGB checkpoint widened to RGBA (fp32 parameters, compute dtype from
`mixed_precision`), turns on tiling (default) and, on the card, the fused
kernels, builds the bucket / component / multilayer loader, the clipped
AdamW(0.5, 0.9), the LPIPS term and the frozen reference of the ref-KL term,
and then steps: log and NaN-guard on schedule, validate on schedule and at
the end, save periodically (on a worker thread) and at the end, stop at
`max_steps` or on SIGTERM, and resume (`resume_from: auto` included) at the
epoch and batch where the checkpoint was taken.

Where the JAX package threads a PRNG key through the run, the port draws the
posterior noise of the steps and of validation from one `torch.Generator`
seeded with `training.seed`. Its state is saved with each checkpoint and
restored on resume, so a resumed run continues the stream where the saved
run stood instead of replaying it (the JAX package folds the step into its
key for the same end). A checkpoint without that state (one the JAX package
wrote) reseeds the generator from (seed, step).

Under `torchrun` (or any initialised process group) the loop is data
parallel over the processes, one device each: the step is ZeRO-2
(`parallel/zero_step.py`; `zero_impl: gspmd` and `shard_map` both take it,
as their numerics are equal in the JAX package), the bucket loader hands each
process its slice of every batch (`data.shard_by_process`), the other loaders
hand each the whole batch and the loop keeps its rows, validation splits its
batch and gathers the outputs, a SIGTERM on any process stops all at the
same step, and checkpoints are gathered to process 0, which alone writes
them and the metrics log and images. `optimizer_offload` keeps AdamW's
moments in host memory between steps, on one process too. Every process
draws the whole batch's noise from the one seeded generator and keeps its
rows, so N processes compute what one computes on the same global batches.
`vae_slicing` (the JAX package's `lax.map` over the batch) has no
counterpart and is reported once when it is on.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ragb_vae_tpu_torch.config import dtype_from_str
from ragb_vae_tpu_torch.data.bucket_dataset import MixedBucketDataset
from ragb_vae_tpu_torch.data.component_dataset import create_component_dataloader
from ragb_vae_tpu_torch.data.loader import DataLoader, cuda_prefetch, default_collate
from ragb_vae_tpu_torch.data.manifest import build_bucket_entries
from ragb_vae_tpu_torch.data.multilayer_dataset import MultiLayerDataset, multilayer_collate
from ragb_vae_tpu_torch.data.sampler import BucketBatchSampler
from ragb_vae_tpu_torch.data.transforms import RandomBackgroundBlend
from ragb_vae_tpu_torch.device import resolve_device
from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
from ragb_vae_tpu_torch.models.lpips import maybe_build_lpips
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.ops.rgba import composite_over_checkerboard
from ragb_vae_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    create_mesh,
    local_device,
    local_rows,
    maybe_init_distributed,
    process_count,
    process_index,
)
from ragb_vae_tpu_torch.training import checkpoint as ckpt_lib
from ragb_vae_tpu_torch.training.vae_step import (
    VaeStepConfig,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    resolve_background_spec,  # noqa: F401  (JAX keeps it in this module)
    trainable_parameters,
)
from ragb_vae_tpu_torch.utils.metrics_logger import MetricsLogger
from ragb_vae_tpu_torch.utils.preemption import PreemptionGuard, preemption_enabled
from ragb_vae_tpu_torch.utils.profiling import annotate, trace_context


# ---------------------------------------------------------------------------
# Guards and start-up diagnostics
# ---------------------------------------------------------------------------
def ensure_finite(value: float, name: str, *, epoch: int, step: int) -> None:
    """Raise (and end the run) on a NaN or Inf metric."""
    if not np.isfinite(value):
        raise FloatingPointError(f"Non-finite {name}={value!r} at epoch {epoch} step {step}.")


def log_batch_and_buckets(*, batch_size: int, grad_accum: int, num_devices: int,
                          train_loader: Optional[DataLoader]) -> None:
    """One loader batch of `data.batch_size` rows is one optimizer step,
    split into `grad_accum` micro-batches; then the five fullest buckets."""
    per_slice = batch_size / max(grad_accum * num_devices, 1)
    print(f"[RGBA-VAE] effective batch/step = data.batch_size = {batch_size} "
          f"(split into {grad_accum} microbatch(es) over {num_devices} device(s): "
          f"{per_slice:g} rows per device-microbatch)")
    buckets = getattr(getattr(train_loader, "dataset", None), "bucket_to_indices", None)
    if buckets:
        top = sorted(buckets.items(), key=lambda kv: -len(kv[1]))[:5]
        print(f"[RGBA-VAE] top-5 buckets: {', '.join(f'{k}:{len(v)}' for k, v in top)} "
              f"({len(buckets)} buckets total)")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def build_dataloader(cfg: Dict[str, Any], *, split: Optional[str] = None) -> DataLoader:
    """The loader of `split` ("train" by default) from `cfg["data"]`:
    `source: bucket` with `bucket_datasets` (mixed manifests through
    `MixedBucketDataset` and `BucketBatchSampler`) or without (component
    pairs), or the multilayer tree. The train split gets the random
    background blend when `background_blend_prob` > 0.

    Over several processes (`data.shard_by_process`, default on) the train
    loader is sharded as in the JAX package: every process walks the same
    seeded index stream (a missing `data.seed` becomes 0), `batch_size` must
    divide by the processes, drop_last is forced, and the bucket loader
    fetches only this process's slice of each batch; the component and
    multilayer loaders (whose collate pads to the batch's largest image)
    fetch the whole batch and the loop keeps this process's rows."""
    data_cfg = cfg.get("data", {})
    split = split or "train"
    train_mode = split == "train"
    val_shuffle = bool(data_cfg.get("val_shuffle", False))
    seed = data_cfg.get("seed")
    drop_last = bool(data_cfg.get("drop_last", False))
    shard_kwargs: Dict[str, Any] = {}
    if train_mode and bool(data_cfg.get("shard_by_process", True)) and process_count() > 1:
        n_proc = process_count()
        if int(data_cfg.get("batch_size", 4)) % n_proc:
            raise ValueError(f"data.batch_size={data_cfg.get('batch_size')} must divide by "
                             f"{n_proc} processes for multi-host input sharding")
        shard_kwargs = {"process_shard": (process_index(), n_proc)}
        drop_last = True
        if seed is None:
            seed = 0
            print("[data] multi-host input sharding with no data.seed — "
                  "defaulting to seed=0 so all hosts iterate one index stream")

    if data_cfg.get("source", "multilayer") == "bucket":
        dataset_kwargs = data_cfg.get("dataset_kwargs", {"include_metadata": False})
        if train_mode:
            split_name = data_cfg.get("bucket_split", "train")
            shuffle = data_cfg.get("shuffle", True)
            extra_kwargs = dataset_kwargs
        else:
            split_name = data_cfg.get("bucket_val_split", "val")
            shuffle = val_shuffle
            extra_kwargs = data_cfg.get("val_dataset_kwargs", dataset_kwargs)
        transform = None
        blend_prob = float(data_cfg.get("background_blend_prob", 0.0))
        if train_mode and blend_prob > 0.0:
            transform = RandomBackgroundBlend(
                prob=blend_prob, keys=data_cfg.get("background_blend_targets", ["component", "composite"]),
                color_range=tuple(data_cfg.get("background_color_range", [0.2, 0.9])), seed=seed)

        if not data_cfg.get("bucket_datasets"):
            return create_component_dataloader(
                root_dir=data_cfg.get("bucket_root", "data/rgba_layers"),
                manifest_path=data_cfg.get("bucket_manifest"), split=split_name,
                batch_size=data_cfg.get("batch_size", 4), shuffle=shuffle,
                num_workers=data_cfg.get("num_workers", 4), limit=data_cfg.get("limit"),
                transform=transform, dataset_kwargs=extra_kwargs, seed=seed, drop_last=drop_last)

        entries = build_bucket_entries(data_cfg.get("bucket_datasets", []), split=split_name)
        if not entries:
            raise ValueError("No bucket entries found for configured bucket_datasets.")
        if data_cfg.get("limit") is not None:
            entries = entries[: int(data_cfg["limit"])]
        dataset = MixedBucketDataset(
            root_dir=data_cfg.get("bucket_root", "data/rgba_layers"), entries=entries,
            include_metadata=extra_kwargs.get("include_metadata", False),
            include_background=extra_kwargs.get("include_background", False),
            blend_component_to_white=extra_kwargs.get("blend_component_to_white", False),
            transform=transform)
        sampler = BucketBatchSampler(
            dataset.bucket_to_indices, batch_size=data_cfg.get("batch_size", 4), shuffle=shuffle,
            drop_last=drop_last, interleave=bool(data_cfg.get("interleave_buckets", False)), seed=seed)
        return DataLoader(dataset, batch_sampler=sampler, num_workers=data_cfg.get("num_workers", 4),
                          collate_fn=default_collate, **shard_kwargs)

    dataset = MultiLayerDataset(
        rendered_root=Path(data_cfg["rendered_root"]), json_root=Path(data_cfg["json_root"]),
        alpha_threshold=data_cfg.get("alpha_threshold", 100), max_samples=data_cfg.get("max_samples"))
    return DataLoader(dataset, batch_size=data_cfg.get("batch_size", 1),
                      shuffle=train_mode or (split == "val" and val_shuffle),
                      num_workers=data_cfg.get("num_workers", 4), collate_fn=multilayer_collate, seed=seed,
                      drop_last=bool(shard_kwargs))


def build_training_batch(
    batch: Dict[str, Any],
    *,
    background_sample_prob: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """component and composite (or the composite alone), then each
    background with probability `background_sample_prob`, stacked on the
    batch axis -> (N, H, W, 4)."""
    if "component" in batch and "composite" in batch:
        tensors = [batch["component"], batch["composite"]]
    elif "composite" in batch:
        tensors = [batch["composite"]]
    else:
        raise ValueError("Batch must contain 'composite' tensor for training.")
    inputs = np.concatenate([np.asarray(t) for t in tensors], axis=0)
    if background_sample_prob > 0.0 and "background" in batch:
        background = np.asarray(batch["background"])
        if background.ndim == 3:
            background = background[None]
        if background.shape[-1] != 4:
            raise ValueError("Background tensor is expected to have 4 channels (RGBA).")
        mask = (rng or np.random.default_rng()).random(background.shape[0]) < background_sample_prob
        if mask.any():
            inputs = np.concatenate([inputs, background[mask]], axis=0)
    return inputs


def pad_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Cycle-pad the batch axis to a multiple of `multiple` (the
    micro-batches); the step masks the pad out of the loss through
    `padding_weights`."""
    n = arr.shape[0]
    if multiple <= 1 or n % multiple == 0:
        return arr
    pad = multiple - n % multiple
    extra = np.concatenate([arr] * -(-pad // n), axis=0)[:pad]
    return np.concatenate([arr, extra], axis=0)


def padding_weights(n_real: int, n_total: int) -> np.ndarray:
    """(n_total,) loss weights: 1 for real samples, 0 for padding."""
    weights = np.zeros(n_total, dtype=np.float32)
    weights[:n_real] = 1.0
    return weights


def _step_batches(loader: DataLoader, *, skip: int, rng: np.random.Generator,
                  background_sample_prob: float, n_micro: int, mesh: Mesh) -> Iterator[Dict[str, np.ndarray]]:
    """The loader's batches after the first `skip` (which are still drawn,
    so every random stream stands where the uninterrupted run's would),
    padded to the micro-batches with their loss weights, as this process's
    rows, and the count of real rows over all processes. A sharded loader's
    batch (it carries `global_batch_size`) is this process's slice and is
    padded here; any other is the whole batch, padded to the processes'
    micro-batches, of which this process keeps its rows."""
    for index, batch in enumerate(loader):
        if index < skip:
            continue
        inputs = np.asarray(build_training_batch(batch, background_sample_prob=background_sample_prob, rng=rng),
                            dtype=np.float32)
        n_real = inputs.shape[0]
        if "global_batch_size" in batch:
            inputs = pad_to_multiple(inputs, n_micro)
            weights = padding_weights(n_real, inputs.shape[0])
            n_real *= mesh.size
        else:
            inputs = pad_to_multiple(inputs, mesh.size * n_micro)
            weights = local_rows(padding_weights(n_real, inputs.shape[0]), mesh)
            inputs = local_rows(inputs, mesh)
        yield {"images": inputs, "weights": weights, "n_real": n_real}


# ---------------------------------------------------------------------------
# Visuals
# ---------------------------------------------------------------------------
def _to_uint8(img01: np.ndarray) -> np.ndarray:
    return (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _checkerboard(img01: np.ndarray) -> np.ndarray:
    """(N, H, W, 4) -> (N, H, W, 3) over the checkerboard, on the host."""
    return composite_over_checkerboard(torch.from_numpy(np.ascontiguousarray(img01, np.float32))).numpy()


def visualize_dataloader_samples(dataloader: DataLoader, *, limit: int = 150,
                                 output_dir: str = "outputs/sample_vis", nrow: int = 10) -> int:
    """One checkerboard-composited PNG per sample, up to `limit`; returns the count."""
    from PIL import Image

    del nrow  # one file per sample, as the JAX package writes them
    target = Path(output_dir)
    target.mkdir(parents=True, exist_ok=True)
    count = 0
    for batch in dataloader:
        tensor = batch.get("composite", batch.get("component"))
        if tensor is None:
            continue
        arr = np.asarray(tensor)
        arr = arr[None] if arr.ndim == 3 else arr
        if arr.min() < -0.01 or arr.max() > 1.01:
            arr = (arr + 1.0) * 0.5
        for img in _checkerboard(arr):
            Image.fromarray(_to_uint8(img)).save(target / f"sample_{count:04d}.png")
            count += 1
            if count >= limit:
                break
        if count >= limit:
            break
    print(f"[RGBA-VAE] saved checkerboard previews to {target} ({count} files)")
    return count


def save_validation_grid(samples: List[Dict[str, np.ndarray]], *, epoch: int, step: Optional[int],
                         output_dir: str) -> Path:
    """One PNG: a row per sample of GT | reconstruction (over the
    checkerboard) | |alpha difference|."""
    from PIL import Image

    panels = []
    for sample in samples:
        gt = np.asarray(sample["gt"], np.float32)
        recon = np.asarray(sample["recon"], np.float32)
        alpha_diff = np.repeat(np.abs(gt[..., 3:] - recon[..., 3:]), 3, axis=-1)
        panels.append(np.concatenate([_checkerboard(gt[None])[0], _checkerboard(recon[None])[0], alpha_diff],
                                     axis=1))
    width = max(p.shape[1] for p in panels)
    grid = np.concatenate([np.pad(p, ((0, 0), (0, width - p.shape[1]), (0, 0))) for p in panels], axis=0)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"val_recon_epoch_{epoch}_step_{step}.png" if step is not None else f"val_recon_epoch_{epoch}.png"
    Image.fromarray(_to_uint8(grid)).save(out_dir / name)
    print(f"[RGBA-VAE][val] saved visualization to {out_dir / name}")
    return out_dir / name


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------
def evaluate_rgba_vae(
    model: RgbaVAE,
    dataloader: DataLoader,
    *,
    epoch: int,
    eval_cfg: Dict[str, Any],
    global_step: Optional[int] = None,
    eval_step=None,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, float]:
    """Mean PSNR over each `val_background_colors` composite and the alpha
    MAE over at most `val_max_batches` batches, and the visual grid of the
    first `val_visual_rows` batches' first samples (written by process 0).
    With a `mesh` each batch, the same on every process, is padded to the
    processes and split over them, and every process gets all the metrics."""
    specs = list(eval_cfg.get("val_background_colors", ["white", "black"]))
    n_proc = 1 if mesh is None else mesh.size
    eval_step = eval_step or make_eval_step(model, mesh=mesh, background_specs=specs)
    device = next(model.module.parameters()).device
    max_batches = eval_cfg.get("val_max_batches")
    viz_rows = int(eval_cfg.get("val_visual_rows", 8))
    psnr: Dict[str, List[np.ndarray]] = {str(s): [] for s in specs}
    alpha_l1: List[np.ndarray] = []
    viz: List[Dict[str, np.ndarray]] = []
    for batch_idx, batch in enumerate(dataloader):
        inputs = np.asarray(build_training_batch(batch), dtype=np.float32)
        n_real = inputs.shape[0]
        out = eval_step(torch.from_numpy(pad_to_multiple(inputs, n_proc)).to(device), generator=generator)
        for spec in specs:
            psnr[str(spec)].append(out[f"psnr_{spec}"].float().cpu().numpy()[:n_real])
        alpha_l1.append(out["alpha_mae"].float().cpu().numpy()[:n_real])
        if len(viz) < viz_rows:
            viz.append({"gt": np.clip(inputs[0], 0.0, 1.0), "recon": out["recon"][0].float().cpu().numpy()})
        if max_batches is not None and batch_idx + 1 >= max_batches:
            break
    metrics: Dict[str, float] = {}
    if alpha_l1:
        for spec in specs:
            metrics[f"val/psnr_{spec}"] = float(np.concatenate(psnr[str(spec)]).mean())
            print(f"[RGBA-VAE][val] epoch {epoch} PSNR ({spec} background): {metrics[f'val/psnr_{spec}']:.2f} dB")
        metrics["val/alpha_mae"] = float(np.concatenate(alpha_l1).mean())
        print(f"[RGBA-VAE][val] epoch {epoch} alpha MAE: {metrics['val/alpha_mae']:.4f}")
    if viz and (mesh is None or mesh.rank == 0):   # one writer on a shared filesystem
        save_validation_grid(viz, epoch=epoch, step=global_step,
                             output_dir=eval_cfg.get("val_output_dir", "outputs"))
    return metrics


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def save_checkpoints(
    model: RgbaVAE,
    cfg: Dict[str, Any],
    *,
    step: Optional[int] = None,
    optimizer=None,
    generator: Optional[torch.Generator] = None,
    writer: Optional[ckpt_lib.AsyncCheckpointWriter] = None,
    mesh: Optional[Mesh] = None,
) -> Path:
    """`ckpt_dir/step_{N}` (or `ckpt_dir` without a step): weights, metadata
    and train state, on `writer`'s thread when one is given; then prune to
    `ckpt_keep_last`, after the save has landed. Over several processes
    every one must call it: the optimizer state is gathered from all (a
    collective), process 0 alone writes, and a barrier follows."""
    train_cfg = cfg.get("training", {})
    ckpt_dir = Path(train_cfg.get("ckpt_dir", "checkpoints"))
    target = ckpt_lib.checkpoint_dir(ckpt_dir, step)
    keep_last = int(train_cfg.get("ckpt_keep_last", 0) or 0)
    optimizer_state = None if optimizer is None else optimizer.state_dict()
    if mesh is not None and mesh.rank != 0:
        barrier(mesh)
        return target
    kwargs = dict(config=model.config, state=model.module.state_dict(), optimizer_state=optimizer_state,
                  generator_state=None if generator is None else generator.get_state(), step=step or 0)

    def prune():
        removed = ckpt_lib.prune_checkpoints(ckpt_dir, keep_last) if keep_last > 0 else 0
        if removed:
            print(f"[ckpt] pruned {removed} old checkpoints (keep_last={keep_last})")

    if writer is not None:
        writer.submit(target, on_complete=prune, **kwargs)
    else:
        ckpt_lib.save_train_checkpoint(target, **kwargs)
        prune()
    print(f"Saved RGBA-VAE checkpoints to {target}" + (f" (step {step})" if step else ""))
    if mesh is not None:
        barrier(mesh)
    return target


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------
def _compute_dtype(mixed_precision) -> torch.dtype:
    if isinstance(mixed_precision, bool):
        mixed_precision = "fp16" if mixed_precision else "no"
    if mixed_precision in ("bf16", "fp16", "float16", "bfloat16"):
        return torch.bfloat16     # fp16 maps to bf16, as in the JAX package
    if mixed_precision in ("no", "none", "fp32", "float32"):
        return torch.float32
    return dtype_from_str(mixed_precision)


def _remat(value) -> Union[bool, str]:
    """`vae_gradient_checkpointing`: a bool, or "all" / "half" / "none"; any
    other string raises (the JAX package turns it into no recompute)."""
    if isinstance(value, str):
        if value not in ("all", "half", "none"):
            raise ValueError(f"vae_gradient_checkpointing must be a bool or 'all', 'half', 'none'; got {value!r}")
        return value
    return bool(value)


def train_rgba_vae(cfg: Dict[str, Any], device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    """Run stage 1 on `device` (default: the card; a missing card raises).
    Returns the last metrics, with "global_step" (and "preempted" when a
    signal ended the run)."""
    model_cfg = cfg.get("model", {})
    train_cfg = cfg.get("training", {})
    data_cfg = cfg.get("data", {})
    device = local_device(resolve_device("cuda" if device is None else device))
    maybe_init_distributed(device)
    mesh = create_mesh()
    if mesh.size > 1 and float(data_cfg.get("background_sample_prob", 0.0)) > 0.0:
        raise ValueError("data.background_sample_prob > 0 is not supported on multi-host "
                         "runs (hosts would disagree on the training-batch row count); "
                         "set it to 0 or run single-host.")
    zero_impl = str(train_cfg.get("zero_impl", "gspmd")).lower()
    optimizer_offload = bool(train_cfg.get("optimizer_offload", False))
    if zero_impl == "shard_map":
        if int(train_cfg.get("gradient_accumulation_steps", 1)) != 1:
            raise ValueError("zero_impl: shard_map does not implement gradient accumulation;"
                             " use the default gspmd implementation.")
        if optimizer_offload:
            raise ValueError("optimizer_offload is implemented for the default gspmd step;"
                             " drop zero_impl: shard_map to combine it with ZeRO sharding.")
    compute_dtype = _compute_dtype(train_cfg.get("mixed_precision", "no"))

    rgb_ckpt = model_cfg.get("rgb_checkpoint")
    if not rgb_ckpt:
        raise ValueError("model.rgb_checkpoint must point to the converted VAE directory.")
    default_subfolder = "ae" if "flux" in str(model_cfg.get("base_arch", "qwen")).lower() else "vae"
    subfolder = model_cfg.get("rgb_subfolder")
    subfolder = default_subfolder if subfolder is None else subfolder
    model = RgbaVAE.from_pretrained_rgb(
        rgb_ckpt, subfolder=subfolder, alpha_bias_init=model_cfg.get("alpha_bias_init", 0.0),
        beta=model_cfg.get("beta", 0.25),
        alpha_loss_weight=model_cfg.get("alpha_loss_weight", 1.0),
        alpha_l1_weight=model_cfg.get("alpha_l1_weight", 0.0),
        rgb_loss_weight=model_cfg.get("rgb_loss_weight", 1.0),
        white_bg_weight=model_cfg.get("white_bg_loss_weight", 0.0),
        black_bg_weight=model_cfg.get("black_bg_loss_weight", 0.0),
        dtype=torch.float32, compute_dtype=compute_dtype,
        remat=_remat(train_cfg.get("vae_gradient_checkpointing", False)), device=device)
    if train_cfg.get("vae_tiling", True):
        model.enable_tiling(train_cfg.get("vae_tile_sample_size"))
    if train_cfg.get("vae_slicing", True):
        print("[RGBA-VAE] vae_slicing has no effect in the PyTorch port: batches run whole")
    if train_cfg.get("fused_kernels", True) and device.type == "cuda":
        model.enable_fused()

    train_loader = build_dataloader(cfg, split="train")
    val_loader = None
    if train_cfg.get("run_validation", True):
        try:
            val_loader = build_dataloader(cfg, split="val")
        except Exception as exc:
            print(f"[RGBA-VAE] no validation loader: {exc}")

    epochs = int(train_cfg.get("epochs", 1))
    max_grad_norm = train_cfg.get("max_grad_norm")
    params = trainable_parameters(model)
    optimizer = init_train_state(
        model, make_optimizer(params, float(train_cfg.get("learning_rate", 1e-4)), betas=(0.5, 0.9),
                              max_grad_norm=float(max_grad_norm) if max_grad_norm is not None else None),
        mesh=mesh, offload=optimizer_offload)

    lpips_scale = float(train_cfg.get("lpips_scale", 0.0) or 0.0)
    lpips_fn = None
    if lpips_scale > 0.0:
        lpips_fn = maybe_build_lpips(
            train_cfg.get("lpips_weights"), compute_dtype=None if compute_dtype == torch.float32 else compute_dtype,
            remat=bool(train_cfg.get("lpips_remat", True)), device=device)
        if lpips_fn is None:
            print("[RGBA-VAE] lpips_scale > 0 but no LPIPS weights available "
                  "(set training.lpips_weights); perceptual term disabled.")
            lpips_scale = 0.0
    loss_cfg = AlphaVaeLossConfig(
        reduce_mean=bool(train_cfg.get("loss_reduce_mean", False)),
        use_naive_mse=bool(train_cfg.get("use_naive_mse", False)),
        eb=tuple(model_cfg.get("loss_eb") or AlphaVaeLossConfig.eb),
        eb2=tuple(model_cfg.get("loss_eb2") or AlphaVaeLossConfig.eb2))
    step_cfg = VaeStepConfig(
        kl_scale=float(train_cfg.get("kl_scale") or 0.0),
        ref_kl_scale=float(train_cfg.get("ref_kl_scale") or 0.0),
        lpips_scale=lpips_scale,
        gradient_accumulation_steps=int(train_cfg.get("gradient_accumulation_steps", 1)))

    ref_model = None
    if step_cfg.ref_kl_scale > 0.0:
        ref_subfolder = model_cfg.get("ref_rgb_subfolder")
        ref_model = RgbaVAE.from_pretrained_rgb(
            model_cfg.get("ref_rgb_checkpoint") or rgb_ckpt,
            subfolder=subfolder if ref_subfolder is None else ref_subfolder,
            alpha_bias_init=model_cfg.get("alpha_bias_init", 0.0), dtype=compute_dtype, device=device)
        ref_model.module.requires_grad_(False)
        # the reference encodes the same triplets the same way
        ref_model.use_tiling, ref_model.tile_sample_size = model.use_tiling, model.tile_sample_size
        if model.fused:
            ref_model.enable_fused()

    sample_vis_count = int(train_cfg.get("sample_vis_count", 0) or 0)
    if sample_vis_count > 0 and mesh.rank == 0:
        try:
            visualize_dataloader_samples(
                train_loader, limit=sample_vis_count,
                output_dir=train_cfg.get("sample_vis_dir", "outputs/sample_vis"),
                nrow=int(train_cfg.get("sample_vis_nrow", 10) or 10))
        except Exception as exc:
            print(f"[RGBA-VAE] dataloader preview failed: {exc}")

    train_step = make_train_step(model, optimizer, loss_cfg, step_cfg, mesh=mesh, ref_model=ref_model,
                                 lpips_fn=lpips_fn, offload_opt_state=optimizer_offload)
    specs = list(train_cfg.get("val_background_colors", ["white", "black"]))
    eval_step = make_eval_step(model, mesh=mesh, background_specs=specs) if val_loader is not None else None

    seed = int(train_cfg.get("seed", 0))
    generator = torch.Generator(device).manual_seed(seed)
    start_step = 0
    resume_from = train_cfg.get("resume_from")
    if resume_from == "auto":
        resume_from = ckpt_lib.latest_checkpoint(train_cfg.get("ckpt_dir", "checkpoints"))
        if resume_from is None:
            print("[RGBA-VAE] resume_from: auto — no checkpoint found, starting fresh")
    if resume_from:
        _, state, train_state, meta = ckpt_lib.load_train_checkpoint(resume_from)
        model.module.load_state_dict(state, strict=True)
        start_step = int(meta.get("step", 0))
        if train_state is not None and train_state.get("optimizer") is not None:
            optimizer.load_state_dict(train_state["optimizer"])
        if train_state is not None and train_state.get("generator") is not None:
            generator.set_state(train_state["generator"])
        else:
            generator.manual_seed(seed * 1_000_003 + start_step)
        print(f"[RGBA-VAE] resumed from {resume_from} at step {start_step}")

    log_every = int(train_cfg.get("log_every", 50))
    nan_check_every = int(train_cfg.get("nan_check_every", log_every))
    ckpt_every_steps = int(train_cfg.get("ckpt_every_steps", 0) or 0)
    # periodic saves go to a worker thread (`async_checkpoint`, default on);
    # leaving the loop's `with` drains the last one and stops the worker
    ckpt_writer = (ckpt_lib.AsyncCheckpointWriter()
                   if bool(train_cfg.get("async_checkpoint", True)) and ckpt_every_steps > 0 else None)
    val_every_steps = int(train_cfg.get("val_every_steps", 500))
    run_validation = bool(train_cfg.get("run_validation", True)) and val_loader is not None
    background_sample_prob = float(data_cfg.get("background_sample_prob", 0.0))
    max_steps = train_cfg.get("max_steps")
    n_micro = step_cfg.gradient_accumulation_steps

    log_batch_and_buckets(batch_size=int(data_cfg.get("batch_size", 1)), grad_accum=n_micro,
                          num_devices=mesh.size, train_loader=train_loader)
    print(f"[Params] trainable parameters: {sum(p.numel() for p in params):,}")

    host_rng = np.random.default_rng(seed)
    # one writer on a shared filesystem: the metrics are the same on every process
    metrics_logger = MetricsLogger(
        train_cfg.get("metrics_dir", train_cfg.get("ckpt_dir")) if mesh.rank == 0 else None)
    global_step = start_step
    performed_validation = False
    pending: Optional[Dict[str, torch.Tensor]] = None
    last_metrics: Dict[str, float] = {}
    images_seen = 0
    t_start = time.time()

    def materialize(step_at: int, epoch: int) -> Dict[str, float]:
        nonlocal pending
        if pending is None:
            return dict(last_metrics)
        values = {k: float(v) for k, v in pending.items()}
        for name, v in values.items():
            ensure_finite(v, name, epoch=epoch, step=step_at)
        pending = None
        return values

    def validate(epoch: int) -> None:
        last_metrics.update(evaluate_rgba_vae(model, val_loader, epoch=epoch, eval_cfg=train_cfg,
                                              global_step=global_step, eval_step=eval_step,
                                              generator=generator, mesh=mesh))

    # a resumed run starts inside the schedule: the epoch and the batch
    # within it follow from the restored step
    start_epoch, skip_batches = 0, 0
    steps_per_epoch = len(train_loader)
    if start_step > 0 and steps_per_epoch > 0:
        start_epoch = min(start_step // steps_per_epoch, max(epochs - 1, 0))
        skip_batches = start_step - start_epoch * steps_per_epoch
        print(f"[RGBA-VAE] resume position: epoch {start_epoch}, skipping {skip_batches} batches")

    preempted = stop = False
    with ckpt_writer or contextlib.nullcontext(), \
            PreemptionGuard(enabled=preemption_enabled(train_cfg)) as guard, \
            trace_context(train_cfg.get("profile_dir", "outputs/trace"), enabled=bool(train_cfg.get("profile", False))):
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            batches = _step_batches(train_loader, skip=skip_batches if epoch == start_epoch else 0, rng=host_rng,
                                    background_sample_prob=background_sample_prob, n_micro=n_micro, mesh=mesh)
            for batch in cuda_prefetch(batches, device):
                images_seen += batch.pop("n_real")
                with annotate("rgba_vae_train_step", step=global_step):
                    pending = train_step(batch, generator=generator)
                global_step += 1

                if nan_check_every > 0 and global_step % nan_check_every == 0:
                    last_metrics = materialize(global_step, epoch)
                if log_every > 0 and global_step % log_every == 0:
                    last_metrics = materialize(global_step, epoch) or last_metrics
                    metrics_logger.log(last_metrics, step=global_step)
                    ips = images_seen / max(time.time() - t_start, 1e-9)
                    print(f"[RGBA-VAE] epoch {epoch} step {global_step} "
                          f"loss {last_metrics.get('train/loss', float('nan')):.4f} ({ips:.1f} img/s)", flush=True)
                if run_validation and val_every_steps > 0 and global_step % val_every_steps == 0:
                    validate(epoch)
                    performed_validation = True
                if ckpt_every_steps > 0 and global_step % ckpt_every_steps == 0:
                    save_checkpoints(model, cfg, step=global_step, optimizer=optimizer, generator=generator,
                                     writer=ckpt_writer, mesh=mesh)
                if guard.should_stop(sync=True):
                    # leave now; the save below commits this step for `resume_from: auto`
                    preempted = stop = True
                    print(f"[RGBA-VAE] preempted at step {global_step} ({guard.describe()}) "
                          "— checkpointing and exiting", flush=True)
                elif max_steps is not None and global_step - start_step >= int(max_steps):
                    stop = True
                if stop:
                    break
            if stop:
                break

    last_metrics = materialize(global_step, epochs - 1) or last_metrics
    if run_validation and not performed_validation and not preempted:
        validate(epochs - 1)
    save_checkpoints(model, cfg, step=global_step, optimizer=optimizer, generator=generator, mesh=mesh)
    last_metrics["global_step"] = float(global_step)
    if preempted:
        last_metrics["preempted"] = 1.0
    return last_metrics
