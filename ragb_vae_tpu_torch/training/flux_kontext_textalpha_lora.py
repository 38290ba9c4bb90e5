"""FLUX-Kontext text-alpha LoRA training stage, on one process or data-parallel.

Counterpart of `ragb_vae_tpu/training/flux_kontext_textalpha_lora.py`: the
same argparse surface and YAML -> args overlay with its synonyms
(ckpt_every_steps -> save_every, val_every_steps -> val_every,
val_max_batches -> val_max_samples), AdamW(0.9, 0.95) behind a global-norm
clip with a cosine schedule over the LoRA adapters only, peft-format saves
with `metadata.json`, GT|pred pair dumps for validation, and resume.

    python -m ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora \
        --pretrained_model_name_or_path CKPT --rgba_vae_path VAE --data_root DATA

The JAX package compiles one step that takes the adapter tree and the
optimizer state and returns new ones. Here the transformer module owns the
frozen base (bf16 under `mixed_precision: bf16`, weight-only int8 under
`--weight_quant int8`: QLoRA, where the gradients flow through the frozen
int8 linears to the fp32 adapters) and the fp32 adapters, the optimizer owns
its moments, and a step updates both in place. Each block is
recomputed in the backward (`use_gradient_checkpointing`), the batch is split
into `grad_accum_steps` micro-batches weighted by their real-sample count,
and batches reach the card through pinned buffers on a side stream.

The train state beside the adapters is `train_state.pt` (the optimizer's
state dict and the generator's state): an optax state serialised by flax
means nothing to `torch.optim`. It is written last and marks the checkpoint
complete. The adapters and `metadata.json` interchange with the JAX package
in both directions.

SIGTERM ends the run at the next step boundary: the step is saved as a
resumable `checkpoint-{N}`, no `final` is written, the result carries
`"preempted": 1.0` and `resume_from: auto` continues from there
(`handle_preemption: false`, `--no-handle_preemption` or
`RAGB_NO_PREEMPTION=1` turn the guard off). Every `log_every` steps the loss
and the learning rate go to `<ckpt_dir>/metrics.jsonl`, as the JAX stage
writes them; the printed line adds `data/wait_ms`, the mean host ms a step
spent handing over its batch since the last line (the `data.next` counter).
`RAGB_PROFILE_DIR` traces the loop (`utils/profiling.py::trace_context`).

`--device` names where the stage runs (default `cuda`; a missing card raises).

Under `torchrun` (or any initialised process group) the stage runs on the
data axis, one device a process: the base and the adapters are replicated,
each process fetches its slice of every batch (`process_shard`), the update
is ZeRO-2 over the adapters (`parallel/zero_step.py`, on one process too),
every process draws the whole batch's noise from the one seeded generator
and keeps its rows (so N processes compute what one computes), a SIGTERM on
any process stops all at the same step, and process 0 alone writes the
checkpoints (after the optimizer state is gathered from all), the metrics
log and the validation pairs, which every process samples alike.

`tensor_parallel: T` (above 1) splits the W processes into W / T data groups
of T consecutive ranks (`parallel/mesh.py::create_training_mesh`): the
frozen base is Megatron-sharded over each model group
(`parallel/tensor_parallel.py`), the adapters are replicated, and the input
shards, the noise rows and the loss's weighted means go by the DATA rank, so
the T ranks of one model group see the same rows and the same noise. Each
rank's adapter gradients are partials: they are summed over the model group
before `ZeroAdamW` reduces them over the data group, and the replicas of one
model group stay bit-identical. Validation samples on every rank, the
preemption flag is synced over the world, and global rank 0 writes.

`shard_base_params` splits the frozen base over the data group (FSDP,
`parallel/fsdp.py`): each rank keeps its part of every leaf that JAX's rule
splits and all-gathers a block's leaves inside the block's recompute, so
the backward gathers again instead of keeping the base alive; the adapters
stay replicated. `tensor_parallel` together with `shard_base_params` is
refused, as in the JAX stage.

`sequence_parallel: S` (above 1) adds a sequence axis inside each data
replica (`create_training_mesh(tp, sp)`, sp innermost): the S ranks of a
sequence group read the same rows and draw the same noise, run each
transformer call on their 1/S of the image and prompt streams with k and v
all-gathered for attention (`parallel/sequence_parallel.py`), and sum their
partial adapter gradients over the group (over the model group too under
TP x SP) before `ZeroAdamW` runs over the data group. Validation samples
sequence-parallel on every rank and global rank 0 writes. A stream whose
length does not divide by S runs unsharded on every rank, as in JAX.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ragb_vae_tpu_torch.data.loader import DataLoader, cuda_prefetch
from ragb_vae_tpu_torch.data.sampler import BucketBatchSampler
from ragb_vae_tpu_torch.data.text_alpha_dataset import TextAlphaBucketDataset
from ragb_vae_tpu_torch.device import resolve_device
from ragb_vae_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    create_training_mesh,
    local_device,
    maybe_init_distributed,
    process_index,
)
from ragb_vae_tpu_torch.parallel.fsdp import shard_base_, shard_bytes
from ragb_vae_tpu_torch.parallel.tensor_parallel import shard_transformer_, sum_grads_over, validate_tp
from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW, weighted_mean_over_ranks
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import (
    LORA_WEIGHT_FILES,
    FluxTextAlphaModel,
    read_lora_metadata,
    write_lora_metadata,
)
from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
from ragb_vae_tpu_torch.parallel.grad_accum import accumulated_grads
from ragb_vae_tpu_torch.training.rgba_vae_stage import _to_uint8, pad_to_multiple, padding_weights
from ragb_vae_tpu_torch.training.vae_step import ClippedAdamW, global_norm
from ragb_vae_tpu_torch.utils.metrics_logger import MetricsLogger
from ragb_vae_tpu_torch.utils.preemption import PreemptionGuard, preemption_enabled
from ragb_vae_tpu_torch.utils.profiling import Counter, annotate, trace_context

Tensor = torch.Tensor
TRAIN_STATE_FILE = "train_state.pt"


def _resolve_env_token(value: Optional[str]) -> Optional[str]:
    """`${env:VAR}` indirection for tokens."""
    if not value:
        return value
    if value.startswith("${env:") and value.endswith("}"):
        return os.environ.get(value[len("${env:"):-1])
    return value


def parse_args(args: Optional[List[str]] = None, *, allow_missing: bool = False) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="FLUX-Kontext LoRA for text_alpha latent prediction (PyTorch)."
    )
    required = not allow_missing
    parser.add_argument("--pretrained_model_name_or_path", type=str, required=required, default=None)
    parser.add_argument("--hf_token", type=str, default=None)
    parser.add_argument("--rgba_vae_path", type=str, required=required, default=None)
    parser.add_argument("--vae_subfolder", type=str, default="ae")
    parser.add_argument("--data_root", type=str, required=required, default=None)
    parser.add_argument("--train_split", type=str, default="train")
    parser.add_argument("--val_split", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--val_batch_size", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--adam_beta1", type=float, default=0.9)
    parser.add_argument("--adam_beta2", type=float, default=0.95)
    parser.add_argument("--adam_eps", type=float, default=1e-8)
    parser.add_argument("--max_train_steps", type=int, default=10000)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--save_every", type=int, default=1000)
    parser.add_argument("--ckpt_dir", type=str, default="checkpoints/flux_kontext_textalpha_lora")
    parser.add_argument("--output_dir", type=str, default="outputs/flux_kontext_textalpha_lora")
    parser.add_argument(
        "--val_output_dir", type=str, default="outputs/flux_kontext_textalpha_lora/val_samples"
    )
    parser.add_argument("--val_every", type=int, default=1000)
    parser.add_argument("--val_max_samples", type=int, default=100)
    parser.add_argument("--val_num_inference_steps", type=int, default=20)
    parser.add_argument("--run_validation_on_start", action="store_true")
    parser.add_argument("--mixed_precision", type=str, default="bf16")
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--rank", type=int, default=96)
    parser.add_argument("--lora_alpha", type=int, default=128)
    parser.add_argument("--drop_last", action="store_true")
    parser.add_argument("--interleave_buckets", action="store_true")
    parser.add_argument("--max_grad_norm", type=float, default=1.0)
    parser.add_argument(
        "--resume_from", type=str, default=None,
        help="LoRA checkpoint dir to resume from (adapters, optimizer state, step, "
             "generator state), or 'auto' for the newest complete checkpoint-* under ckpt_dir.",
    )
    parser.add_argument("--weight_quant", type=str, default="none", choices=["none", "int8"],
                        help="int8: QLoRA. The frozen base transformer is stored in weight-only "
                             "int8 (a quantised checkpoint loads as it is, a plain one is "
                             "quantised at load); gradients flow only to the fp32 adapters.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on. 'cuda' without a CUDA device is an error.")
    # left out of the namespace unless given, as in the JAX stage's: absent means on
    parser.add_argument("--handle_preemption", action=argparse.BooleanOptionalAction, default=argparse.SUPPRESS,
                        help="On SIGTERM, save a resumable checkpoint-N at the next step and stop "
                             "(default on; RAGB_NO_PREEMPTION=1 also turns it off).")
    parser.add_argument("--shard_base_params", action="store_true",
                        help="FSDP: split the frozen base over the data processes, each block all-gathered "
                             "before it runs.")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="Megatron tensor parallelism of the frozen base over T consecutive processes.")
    parser.add_argument("--sequence_parallel", type=int, default=1,
                        help="Split the token streams over S consecutive processes (k / v all-gathered for "
                             "attention).")
    return parser.parse_args(args=args)


def _check_ported(args: argparse.Namespace) -> None:
    if _tp_degree(args) > 1 and getattr(args, "shard_base_params", False):
        raise ValueError(
            "tensor_parallel and shard_base_params are mutually exclusive "
            "(Megatron model-axis sharding vs FSDP data-axis sharding of the same frozen base)")


def _tp_degree(args: argparse.Namespace) -> int:
    return max(1, int(getattr(args, "tensor_parallel", 1) or 1))


def _sp_degree(args: argparse.Namespace) -> int:
    return max(1, int(getattr(args, "sequence_parallel", 1) or 1))


def latest_complete_lora_checkpoint(root: Path) -> Optional[Path]:
    """Newest committed checkpoint-N dir under `root`, or None.

    `save_lora` writes the adapters, then the metadata, then the train state,
    so the train state marks a checkpoint complete: a crash in mid-save
    leaves a dir without it, which `resume_from: auto` must skip. Resuming
    warm adapters with a fresh optimizer and step would silently restart the
    cosine schedule on a half-written checkpoint."""
    if not root.exists():
        return None
    complete = [
        p for p in root.glob("checkpoint-*")
        if p.is_dir() and (p / LORA_WEIGHT_FILES[0]).exists() and (p / TRAIN_STATE_FILE).exists()
    ]
    return max(complete, key=lambda p: int(p.name.rsplit("-", 1)[1]), default=None)


# ---------------------------------------------------------------------------
# Image dumps
# ---------------------------------------------------------------------------
def _save_pair(gt: np.ndarray, pred: np.ndarray, path: Path) -> None:
    """GT | prediction side by side as one RGBA PNG."""
    from PIL import Image

    gt_img = Image.fromarray(_to_uint8(gt), mode="RGBA")
    pred_img = Image.fromarray(_to_uint8(pred), mode="RGBA")
    w, h = gt_img.size
    canvas = Image.new("RGBA", (w * 2, h))
    canvas.paste(gt_img, (0, 0))
    canvas.paste(pred_img, (w, 0))
    canvas.save(path)


# ---------------------------------------------------------------------------
# Optimizer and step
# ---------------------------------------------------------------------------
def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """`optax.cosine_decay_schedule`: init * 0.5 * (1 + cos(pi * min(step, T) / T))."""
    def schedule(step: int) -> float:
        frac = min(max(step, 0), decay_steps) / max(decay_steps, 1)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def make_lora_optimizer(
    params: Sequence[Tensor],
    learning_rate: float,
    *,
    betas: Tuple[float, float] = (0.9, 0.95),
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: Optional[float] = 1.0,
) -> ClippedAdamW:
    """Global-norm clip (optax's: max / max(norm, max)), then AdamW, as the
    JAX stage's optax chain. The learning rate is set per step by the train
    step from its schedule."""
    return ClippedAdamW(params, learning_rate, betas=betas, eps=eps,
                        weight_decay=weight_decay, max_grad_norm=max_grad_norm)


def make_lora_train_step(
    model: FluxTextAlphaModel,
    optimizer: Union[ClippedAdamW, ZeroAdamW],
    n_micro: int,
    lr_schedule: Optional[Callable[[int], float]] = None,
    mesh: Optional[Mesh] = None,
    model_mesh: Optional[Mesh] = None,
    seq_mesh: Optional[Mesh] = None,
):
    """Build `step(batch, generator, step_index) -> (loss, stats, grad_norm)`.

    `batch`: "gt" and "text_alpha" (B, H, W, 4) in [0, 1] and optionally
    "weights" (B,). The loss and its backward run over `n_micro`
    micro-batches, each weighted by the sum of its weights (so padding rows
    change neither the loss nor the gradients wherever they fall); then the
    clip and the AdamW update of the adapters, at `lr_schedule(step_index)`
    with `step_index` the number of updates made before this one. With a
    `mesh`, `batch` is this process's rows, `optimizer` a `ZeroAdamW` over
    the adapters, and the loss and stats are weighted means over all rows.
    With a `model_mesh` of size > 1 (the transformer is tensor-parallel over
    it; `mesh` is then the data axis), each rank's adapter gradients are
    partials and are summed over the model group before the update. With a
    `seq_mesh` of size > 1 (the model runs sequence-parallel over it), a
    batch whose streams were sharded leaves each rank the partial over its
    tokens: those are summed over the sequence group too. A step is the span
    `lora.step#<step_index>` around `lora.encode` and `lora.forward` (a
    micro-batch's, `compute_loss`), `lora.backward`, `lora.grad_sum` (TP, SP)
    and `lora.optimizer` (the clip and AdamW)."""
    params = list(lora_parameters(model.transformer).values())
    over_mesh = {} if mesh is None else {"mesh": mesh}

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator], step_index: int = 0):
        def loss_fn(micro: Dict[str, Tensor], index: int):
            return model.compute_loss(micro["gt"], micro["text_alpha"], generator,
                                      weights=micro.get("weights"), **over_mesh)

        with annotate("lora.step", step=step_index):
            loss, stats = accumulated_grads(
                loss_fn, params, batch, n_micro,
                micro_weight_fn=(lambda mb: mb["weights"].sum()) if "weights" in batch else None,
                backward_span="lora.backward",
            )
            over_model = model_mesh is not None and model_mesh.size > 1
            over_seq = seq_mesh is not None and model.sequence_sharded(*batch["gt"].shape[1:3])
            if over_model or over_seq:
                with annotate("lora.grad_sum"):
                    if over_model:
                        sum_grads_over(params, model_mesh)
                    if over_seq:
                        sum_grads_over(params, seq_mesh)
            if lr_schedule is not None:
                for group in optimizer.param_groups:
                    group["lr"] = lr_schedule(step_index)
            if mesh is None:
                with annotate("lora.optimizer"):
                    grad_norm = global_norm([p.grad for p in params if p.grad is not None])
                    optimizer.clipped_step(grad_norm)
                return loss, stats, grad_norm
            w_local = batch["weights"].sum() if "weights" in batch else None
            with annotate("lora.optimizer"):
                grad_norm = optimizer.step(w_local)
            reduced = weighted_mean_over_ranks({"loss": loss, **stats}, w_local, mesh)
            return reduced.pop("loss"), reduced, grad_norm

    return step


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------
def _padded_batches(loader: DataLoader, n_micro: int) -> Iterator[Dict[str, Any]]:
    for batch in loader:
        with annotate("data.pad"):
            gt = np.asarray(batch["gt"], np.float32)
            n_real = gt.shape[0]
            gt = pad_to_multiple(gt, n_micro)
            padded = {
                "gt": gt,
                "text_alpha": pad_to_multiple(np.asarray(batch["text_alpha"], np.float32), n_micro),
                "weights": padding_weights(n_real, gt.shape[0]),
            }
        yield padded


def train(
    args: argparse.Namespace,
    *,
    model: Optional[FluxTextAlphaModel] = None,
    device: Union[str, torch.device, None] = None,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> Dict[str, float]:
    """Run the stage on `device` (default: `args.device`, the card unless the
    caller names another; a card that is asked for and absent raises).
    `model` stands in for `from_pretrained` (a model built elsewhere, for
    example with random weights); adapters of `args.rank` are attached when
    it has none. `log_fn(step, metrics)` is called at every `log_every`-th
    step with the loss, the gradient norm before the clip and the learning
    rate; the loss and the learning rate also go to `<ckpt_dir>/metrics.jsonl`."""
    _check_ported(args)
    tp, sp = _tp_degree(args), _sp_degree(args)
    if tp > 1:   # the degree against the heads, before any model is built
        from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig

        validate_tp(model.transformer_config if model is not None else FluxTransformerConfig.from_json(
            Path(args.pretrained_model_name_or_path) / "transformer" / "config.json"), tp)
    device = local_device(resolve_device(device if device is not None else getattr(args, "device", "cuda")))
    maybe_init_distributed(model.device if model is not None else device)
    mesh, model_mesh, seq_mesh = create_training_mesh(tp=tp, sp=sp)     # the data, model and sequence axes
    fsdp = mesh if getattr(args, "shard_base_params", False) else None
    is_main = process_index() == 0
    weight_quant = getattr(args, "weight_quant", "none")
    dtype = torch.bfloat16 if args.mixed_precision in ("bf16", "fp16") else torch.float32

    if model is None:
        model = FluxTextAlphaModel.from_pretrained(
            args.pretrained_model_name_or_path,
            vae_path=args.rgba_vae_path,
            vae_subfolder=args.vae_subfolder,
            dtype=dtype,
            device=device,
            fused=device.type == "cuda",
            lora_rank=args.rank,
            lora_alpha=float(args.lora_alpha),
            weight_quant=weight_quant,
            tp=model_mesh,
            fsdp=fsdp,
            seq=seq_mesh,
        )
    elif model.transformer.weight_quant != weight_quant:
        raise ValueError(f"weight_quant={weight_quant!r} but the model given stores its transformer "
                         f"as {model.transformer.weight_quant!r}")
    elif not lora_parameters(model.transformer):
        model.lora_rank, model.lora_alpha = args.rank, float(args.lora_alpha)
        model.init_lora(torch.Generator(model.device).manual_seed(0))
    if model.transformer.tp.size != model_mesh.size:
        if model.transformer.tp.size > 1:
            raise ValueError(f"tensor_parallel={tp}, but the model given is sharded {model.transformer.tp.size} ways")
        validate_tp(model.transformer_config, tp, cuda=model.device.type == "cuda", weight_quant=weight_quant)
        shard_transformer_(model.transformer, model_mesh)
    if fsdp is not None and fsdp.size > 1 and model.transformer.fsdp is None:
        shard_base_(model.transformer, fsdp)
    model.seq = seq_mesh
    device = model.device
    model.vae.module.requires_grad_(False)
    lora = lora_parameters(model.transformer)

    train_ds = TextAlphaBucketDataset(Path(args.data_root), split=args.train_split)
    val_ds = TextAlphaBucketDataset(Path(args.data_root), split=args.val_split) if args.val_split else None
    if mesh.size > 1 and args.batch_size % mesh.size:
        raise ValueError(f"data.batch_size={args.batch_size} must divide by {mesh.size} "
                         "processes for multi-host input sharding")
    train_dl = DataLoader(
        train_ds,
        batch_sampler=BucketBatchSampler(
            train_ds.bucket_to_indices, batch_size=args.batch_size, shuffle=True,
            # several processes: uniform per-process slices of one index stream
            drop_last=args.drop_last or mesh.size > 1, interleave=args.interleave_buckets, seed=args.seed,
        ),
        num_workers=args.num_workers,
        process_shard=(mesh.rank, mesh.size) if mesh.size > 1 else None,
    )
    val_dl = None
    if val_ds is not None:
        # bucket-pure batches: plain range batching would stack samples of
        # different resolutions once val_batch_size > 1
        val_dl = DataLoader(
            val_ds,
            batch_sampler=BucketBatchSampler(
                val_ds.bucket_to_indices, batch_size=args.val_batch_size, shuffle=True, seed=args.seed),
            num_workers=min(4, args.num_workers),
        )

    lr_schedule = cosine_decay_schedule(args.learning_rate, args.max_train_steps)
    optimizer = ZeroAdamW(make_lora_optimizer(
        list(lora.values()), args.learning_rate,
        betas=(args.adam_beta1, args.adam_beta2), eps=args.adam_eps,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
    ), mesh)
    n_micro = max(1, args.grad_accum_steps)
    train_step = make_lora_train_step(model, optimizer, n_micro, lr_schedule, mesh=mesh, model_mesh=model_mesh,
                                      seq_mesh=seq_mesh)

    print(f"[Batch] effective_per_step={args.batch_size} (grad_accum={n_micro}, {mesh.size} data group(s) "
          f"of {tp * sp} process(es) -> {args.batch_size / (n_micro * mesh.size):g} rows per micro-batch) "
          f"device={device}")
    if fsdp is not None and fsdp.size > 1:
        held = shard_bytes(model.transformer)
        print(f"[FSDP] base split over {fsdp.size} processes: {held['split'] / 2**20:.1f} MiB of split leaves "
              f"and {held['whole'] / 2**20:.1f} MiB of whole ones on this process")
    print(f"[Train] {len(train_ds)} samples across {len(train_ds.bucket_to_indices)} buckets.")
    print(f"[Val]   {len(val_ds)} samples." if val_ds is not None
          else "[Val]   (disabled: no val_split provided)")
    print(f"[Params] trainable LoRA parameters: {sum(p.numel() for p in lora.values()):,}")

    generator = torch.Generator(device).manual_seed(args.seed)

    def run_validation(step_label: str) -> None:
        if val_dl is None:
            return
        out_dir = Path(args.val_output_dir) / f"step-{step_label}"
        if is_main:
            out_dir.mkdir(parents=True, exist_ok=True)
        saved = 0
        for batch in val_dl:
            if saved >= args.val_max_samples:
                break
            gt_np = np.asarray(batch["gt"], np.float32)
            decoded = model.sample(torch.from_numpy(gt_np),
                                   num_inference_steps=args.val_num_inference_steps,
                                   generator=generator).float().cpu().numpy()
            names = batch.get("sample_name", ["val"])
            for i in range(min(decoded.shape[0], args.val_max_samples - saved)):
                name = names[i] if i < len(names) else f"val_{saved}"
                if is_main:   # every process sampled the same pairs
                    _save_pair(gt_np[i], decoded[i], out_dir / f"{name}_pair.png")
                saved += 1
        print(f"[val-{step_label}] saved {saved} GT|pred pairs to {out_dir}")

    def save_lora(step: int, subdir: str) -> None:
        optimizer_state = optimizer.state_dict()   # a data-group collective: every process gathers
        if not is_main:
            barrier()
            return
        save_dir = Path(args.ckpt_dir) / subdir
        model.save_lora_weights(save_dir)
        write_lora_metadata(
            save_dir, model_id=str(args.pretrained_model_name_or_path), rank=args.rank,
            lora_alpha=float(args.lora_alpha),
            dtype="bfloat16" if dtype == torch.bfloat16 else "float32", step=step,
        )
        # written last: this file marks the checkpoint complete for `auto`
        torch.save({"optimizer": optimizer_state, "generator": generator.get_state()},
                   save_dir / TRAIN_STATE_FILE)
        print(f"[ckpt] saved LoRA weights to {save_dir}")
        barrier()

    metrics_logger = MetricsLogger(args.ckpt_dir if is_main else None)
    total_steps = 0
    resume_dir = getattr(args, "resume_from", None)
    if resume_dir == "auto":
        resume_dir = latest_complete_lora_checkpoint(Path(args.ckpt_dir))
        if resume_dir is None:
            print("[resume] resume_from: auto - no complete checkpoint found, starting fresh")
    if resume_dir:
        resume_dir = Path(resume_dir)
        model.load_lora(resume_dir)
        state_file = resume_dir / TRAIN_STATE_FILE
        if state_file.exists():
            state = torch.load(state_file, map_location="cpu", weights_only=True)
            optimizer.load_state_dict(state["optimizer"])
            generator.set_state(state["generator"])
        total_steps = int((read_lora_metadata(resume_dir) or {}).get("step", 0))
        print(f"[resume] resumed LoRA training from {resume_dir} at step {total_steps}")

    if args.run_validation_on_start:
        run_validation("start")

    if len(train_dl) == 0:
        # an empty index stream (a split typo, a batch_size above every bucket
        # with drop_last) would spin the loop below through epochs without a step
        raise ValueError(
            f"training dataloader yields no batches: {len(train_ds)} samples in "
            f"'{args.train_split}' with batch_size={args.batch_size}, drop_last={args.drop_last}"
        )

    last_loss = float("nan")
    loss = None
    preempted = False
    t0 = time.time()
    start_steps = total_steps
    epoch = 0
    feed = Counter("data.next")
    fed = feed.snapshot()
    guard = PreemptionGuard(
        enabled=preemption_enabled({"handle_preemption": getattr(args, "handle_preemption", True)}))
    with guard, trace_context(None):
        while total_steps < args.max_train_steps and not preempted:
            train_dl.set_epoch(epoch)
            for batch in cuda_prefetch(_padded_batches(train_dl, n_micro), device, counter=feed):
                loss, _, grad_norm = train_step(batch, generator, total_steps)
                total_steps += 1

                if total_steps % args.log_every == 0:
                    last_loss = float(loss)
                    if not math.isfinite(last_loss):
                        raise FloatingPointError(f"Non-finite loss at step {total_steps}.")
                    lr_now = lr_schedule(total_steps)
                    metrics_logger.log({"train/loss": last_loss, "lr": lr_now}, step=total_steps)
                    rate = (total_steps - start_steps) / max(time.time() - t0, 1e-9)
                    now = feed.snapshot()
                    wait_ms = 1000.0 * (now["total"] - fed["total"]) / max(now["count"] - fed["count"], 1)
                    fed = now
                    print(f"[step {total_steps}] loss={last_loss:.4f} lr={lr_now:.6f} "
                          f"({rate:.2f} steps/s) data/wait_ms={wait_ms:.1f}", flush=True)
                    if log_fn is not None:
                        log_fn(total_steps, {"train/loss": last_loss, "lr": lr_now,
                                             "train/grad_norm": float(grad_norm), "data/wait_ms": wait_ms})
                saved = bool(args.save_every) and total_steps % args.save_every == 0
                if saved:
                    save_lora(total_steps, f"checkpoint-{total_steps}")
                if args.val_every and total_steps % args.val_every == 0:
                    run_validation(str(total_steps))
                if guard.should_stop(sync=True):
                    # leave with a resumable checkpoint-N for `resume_from: auto`
                    preempted = True
                    print(f"[LoRA] preempted at step {total_steps} ({guard.describe()}) "
                          "- checkpointing and exiting", flush=True)
                    if not saved:
                        save_lora(total_steps, f"checkpoint-{total_steps}")
                    break
                if total_steps >= args.max_train_steps:
                    break
            epoch += 1

    if not preempted:
        save_lora(args.max_train_steps, "final")
    print("Preempted." if preempted else "Done.")
    if not math.isfinite(last_loss) and loss is not None:
        last_loss = float(loss)
    out = {"train/loss": last_loss, "global_step": float(total_steps)}
    if preempted:
        out["preempted"] = 1.0
    return out


def build_args_from_cfg(cfg: Dict[str, Any]) -> argparse.Namespace:
    """YAML {model, data, training} -> argparse namespace, with the synonyms."""
    model_cfg = cfg.get("model", {})
    data_cfg = cfg.get("data", {})
    train_cfg = cfg.get("training", {})
    args = argparse.Namespace(**vars(parse_args(args=[], allow_missing=True)))

    if model_cfg.get("pretrained_model_name_or_path"):
        args.pretrained_model_name_or_path = model_cfg["pretrained_model_name_or_path"]
    if model_cfg.get("hf_token"):
        args.hf_token = _resolve_env_token(model_cfg.get("hf_token"))
    if model_cfg.get("rgba_vae_path"):
        args.rgba_vae_path = model_cfg["rgba_vae_path"]
    if model_cfg.get("vae_subfolder") is not None:
        args.vae_subfolder = model_cfg["vae_subfolder"]

    if data_cfg.get("root"):
        args.data_root = data_cfg["root"]
    data_keys = {"train_split": str, "val_split": str, "batch_size": int, "val_batch_size": int,
                 "num_workers": int, "drop_last": bool, "interleave_buckets": bool}
    for key, cast in data_keys.items():
        if data_cfg.get(key) is not None:
            setattr(args, key, cast(data_cfg[key]))

    # (config key, args attribute, type); a synonym after its canonical key wins
    train_keys = (
        ("mixed_precision", "mixed_precision", str),
        ("grad_accum_steps", "grad_accum_steps", int),
        ("learning_rate", "learning_rate", float),
        ("weight_decay", "weight_decay", float),
        ("adam_beta1", "adam_beta1", float),
        ("adam_beta2", "adam_beta2", float),
        ("adam_eps", "adam_eps", float),
        ("max_train_steps", "max_train_steps", int),
        ("log_every", "log_every", int),
        ("save_every", "save_every", int),
        ("ckpt_every_steps", "save_every", int),
        ("ckpt_dir", "ckpt_dir", str),
        ("output_dir", "output_dir", str),
        ("val_output_dir", "val_output_dir", str),
        ("val_every", "val_every", int),
        ("val_every_steps", "val_every", int),
        ("val_max_samples", "val_max_samples", int),
        ("val_num_inference_steps", "val_num_inference_steps", int),
        ("run_validation_on_start", "run_validation_on_start", bool),
        ("rank", "rank", int),
        ("lora_alpha", "lora_alpha", int),
        ("max_grad_norm", "max_grad_norm", float),
        ("resume_from", "resume_from", str),
        ("shard_base_params", "shard_base_params", bool),
        ("tensor_parallel", "tensor_parallel", int),
        ("sequence_parallel", "sequence_parallel", int),
        ("weight_quant", "weight_quant", str),
        ("handle_preemption", "handle_preemption", bool),
        ("seed", "seed", int),
    )
    for src, dst, cast in train_keys:
        if train_cfg.get(src) is not None:
            setattr(args, dst, cast(train_cfg[src]))
    if train_cfg.get("val_max_batches") is not None:
        args.val_max_samples = int(train_cfg["val_max_batches"]) * args.val_batch_size

    missing = []
    if not args.pretrained_model_name_or_path:
        missing.append("model.pretrained_model_name_or_path")
    if not args.rgba_vae_path:
        missing.append("model.rgba_vae_path")
    if not args.data_root:
        missing.append("data.root")
    if missing:
        raise ValueError(f"Missing required config fields: {', '.join(missing)}")
    return args


def train_from_config(cfg: Dict[str, Any], **kwargs) -> Dict[str, float]:
    """`train` on a {model, data, training} config; keyword arguments go to `train`."""
    return train(build_args_from_cfg(cfg), **kwargs)


def main() -> None:
    train(parse_args())


if __name__ == "__main__":
    main()
