"""Text-alpha inference (library + CLI core), on one device, tensor-parallel
or pipeline-parallel.

Counterpart of `ragb_vae_tpu/inference.py`: same flags, seeded sampling, one
image or a batch of images grouped by size.
On a CUDA device the RGBA VAE runs its fused kernels. `--lora_path` loads
peft-format adapters (written by either package's LoRA stage) at the rank and
alpha of their `metadata.json`, which win over `--rank` / `--lora_alpha` as in
JAX; without that file the flags stand. `--quant int8` serves the transformer in weight-only int8: a
quantised checkpoint directory (`scripts/quantize_flux_checkpoint_torch.py`)
loads as it is, a plain one is quantised at load. `--device` names where it
runs (default `cuda`; a missing card raises, nothing falls back to the CPU).
`--tp N` runs the transformer tensor-parallel over N processes, one per
device, under `torchrun --nproc-per-node N` (N must equal the world size):
each rank loads its shard, every rank reads the same inputs and samples them
alike, and rank 0 alone writes the outputs. `--pp N` runs the transformer as
an N-stage pipeline from this one process (`parallel/pipeline.py`): on the
card over `cuda:0` .. `cuda:N-1`, with `--device cpu` N stages on the CPU;
the VAE and the prompt live on the first stage's device, and a seed gives the
answer it gives at `--pp 1`. `--tp` and `--pp` exclude each other.

    python -m ragb_vae_tpu_torch.inference --pretrained_model_name_or_path CKPT \
        --rgba_vae_path VAE --input_image in.png --output_path out.png
    torchrun --nproc-per-node 2 -m ragb_vae_tpu_torch.inference --tp 2 ...
"""
from __future__ import annotations

import argparse
import glob as _glob
from pathlib import Path

import numpy as np
import torch

from ragb_vae_tpu_torch.device import resolve_device

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.bfloat16, "fp32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Inference: predict text_alpha from RGBA input using FluxTextAlphaModel (PyTorch)"
    )
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--rgba_vae_path", type=str, required=True)
    p.add_argument("--vae_subfolder", type=str, default="ae")
    p.add_argument("--lora_path", type=str, default=None,
                   help="Directory with pytorch_lora_weights.safetensors (or .bin); the rank and alpha "
                        "of its metadata.json override --rank / --lora_alpha.")
    p.add_argument("--rank", type=int, default=96, help="LoRA rank when the adapters have no metadata.json.")
    p.add_argument("--lora_alpha", type=int, default=128,
                   help="LoRA alpha when the adapters have no metadata.json.")
    p.add_argument("--input_image", type=str, required=True,
                   help="RGBA input image, or a directory / glob of images.")
    p.add_argument("--output_path", type=str, required=True,
                   help="Output file, or a directory when several inputs match.")
    p.add_argument("--batch_size", type=int, default=4, help="Images per sampler batch (same size).")
    p.add_argument("--steps", type=int, default=20, help="Number of flow steps during sampling.")
    p.add_argument("--seed", type=int, default=None, help="Optional seed for deterministic sampling.")
    p.add_argument("--precision", type=str, default="bf16", choices=sorted(_DTYPES))
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                   help="Weight-only int8 transformer storage. Loads a quantised checkpoint "
                        "(scripts/quantize_flux_checkpoint_torch.py) directly, or quantises a "
                        "plain checkpoint at load.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on. 'cuda' without a CUDA device is an error.")
    p.add_argument("--pp", type=int, default=1,
                   help="Pipeline parallelism: the transformer in N stages on cuda:0..N-1 (N stages on the "
                        "CPU with --device cpu), driven by this one process.")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor parallelism over N processes under torchrun --nproc-per-node N.")
    p.add_argument("--compilation_cache", type=str, default="auto",
                   help="Accepted for the JAX CLI's command line; no effect here.")
    return p.parse_args(argv)


def _resolve_inputs(spec: str):
    """Single file, directory, or glob -> ordered list of image paths."""
    p = Path(spec)
    if p.is_file():
        return [p]
    if p.is_dir():
        exts = {".png", ".webp", ".jpg", ".jpeg"}
        found = sorted(q for q in p.iterdir() if q.suffix.lower() in exts)
    else:
        found = sorted(Path(q) for q in _glob.glob(spec))
    if not found:
        raise FileNotFoundError(f"No input images match {spec!r}")
    return found


def apply_lora_metadata(args: argparse.Namespace) -> None:
    """Take the rank and alpha of `<lora_path>/metadata.json` into `args`
    where the file gives them (JAX `inference.run`: the metadata wins over
    the flags, and a fractional alpha is truncated by `int`)."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import read_lora_metadata

    meta = read_lora_metadata(args.lora_path) if args.lora_path else None
    if not meta:
        return
    if meta.get("rank") is not None:
        args.rank = int(meta["rank"])
    alpha = meta.get("lora_alpha", meta.get("alpha"))
    if alpha is not None:
        args.lora_alpha = int(alpha)
    print(f"Loaded LoRA metadata: rank={args.rank} alpha={args.lora_alpha}")


def run(args: argparse.Namespace) -> None:
    from ragb_vae_tpu_torch.data import native_io
    from ragb_vae_tpu_torch.data.image_io import load_rgba, save_rgba
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel

    from ragb_vae_tpu_torch.parallel.bootstrap import build_pipelined_transformer, build_tp_group, validate_tp_pp
    from ragb_vae_tpu_torch.parallel.mesh import local_device
    from ragb_vae_tpu_torch.parallel.pipeline import pipelined_sample

    apply_lora_metadata(args)      # every rank reads it, before any model is built
    validate_tp_pp(args.tp, args.pp)
    device = local_device(resolve_device(args.device))
    tp = build_tp_group(args.tp, device)
    pipe = build_pipelined_transformer(args.pp, device, args.pretrained_model_name_or_path)
    writes = tp.rank == 0          # under --tp every rank samples; rank 0 writes
    if writes and args.compilation_cache != "off":
        print("--compilation_cache has no effect in the PyTorch port")
    model = FluxTextAlphaModel.from_pretrained(
        args.pretrained_model_name_or_path,
        vae_path=args.rgba_vae_path,
        vae_subfolder=args.vae_subfolder,
        dtype=_DTYPES[args.precision],
        device=device,
        fused=device.type == "cuda",
        lora_rank=args.rank if args.lora_path else 0,
        lora_alpha=float(args.lora_alpha) if args.lora_path else 0.0,
        weight_quant=args.quant,
        tp=tp,
        pipeline=pipe,
    )
    if args.lora_path:
        model.load_lora(args.lora_path)
    generator = torch.Generator(model.device).manual_seed(args.seed if args.seed is not None else 0)

    def run_sample(batch: np.ndarray) -> np.ndarray:
        gt = torch.from_numpy(batch)
        if pipe is None:
            out = model.sample(gt, num_inference_steps=args.steps, generator=generator)
        else:
            out = pipelined_sample(model, pipe, gt, num_inference_steps=args.steps, generator=generator)
        return out.cpu().numpy()

    paths = _resolve_inputs(args.input_image)
    if len(paths) == 1:
        pred = run_sample(load_rgba(paths[0])[None])
        if writes:
            save_rgba(pred[0], args.output_path)
            print(f"Saved to {args.output_path}")
        return

    out_dir = Path(args.output_path)
    if writes:
        out_dir.mkdir(parents=True, exist_ok=True)
    by_size: dict = {}
    for path in paths:
        arr = load_rgba(path)
        by_size.setdefault(arr.shape[:2], []).append((path, arr))
    used: set = set()  # same-stem inputs from different directories
    done = 0
    step = max(1, args.batch_size)
    for _, items in sorted(by_size.items()):
        for start in range(0, len(items), step):
            chunk = items[start : start + step]
            preds = run_sample(np.stack([arr for _, arr in chunk]))
            done += len(chunk)
            if not writes:
                continue
            outs = []
            for path, _ in chunk:
                out = out_dir / (Path(path).stem + "_text_alpha.png")
                n = 1
                while out in used:
                    out = out_dir / (Path(path).stem + f"_text_alpha_{n}.png")
                    n += 1
                used.add(out)
                outs.append(out)
            if native_io.available():
                native_io.encode_batch(outs, np.clip(preds, 0.0, 1.0))   # threaded C++ encode
            else:
                for out, pred in zip(outs, preds):
                    save_rgba(pred, out)
    if writes:
        print(f"Saved {done} predictions to {out_dir}")


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
