"""Text-alpha inference (library + CLI core), single device.

Counterpart of the single-device branch of `ragb_vae_tpu/inference.py`:
same flags, seeded sampling, one image or a batch of images grouped by size.
On a CUDA device the RGBA VAE runs its fused kernels. `--quant int8`,
`--tp`, `--pp` and `--lora_path` are not ported yet and raise.

    python -m ragb_vae_tpu_torch.inference --pretrained_model_name_or_path CKPT \
        --rgba_vae_path VAE --input_image in.png --output_path out.png
"""
from __future__ import annotations

import argparse
import glob as _glob
from pathlib import Path

import numpy as np
import torch

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.bfloat16, "fp32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Inference: predict text_alpha from RGBA input using FluxTextAlphaModel (PyTorch)"
    )
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--rgba_vae_path", type=str, required=True)
    p.add_argument("--vae_subfolder", type=str, default="ae")
    p.add_argument("--lora_path", type=str, default=None, help="Not ported yet.")
    p.add_argument("--rank", type=int, default=96)
    p.add_argument("--lora_alpha", type=int, default=128)
    p.add_argument("--input_image", type=str, required=True,
                   help="RGBA input image, or a directory / glob of images.")
    p.add_argument("--output_path", type=str, required=True,
                   help="Output file, or a directory when several inputs match.")
    p.add_argument("--batch_size", type=int, default=4, help="Images per sampler batch (same size).")
    p.add_argument("--steps", type=int, default=20, help="Number of flow steps during sampling.")
    p.add_argument("--seed", type=int, default=None, help="Optional seed for deterministic sampling.")
    p.add_argument("--precision", type=str, default="bf16", choices=sorted(_DTYPES))
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"], help="int8: not ported yet.")
    p.add_argument("--pp", type=int, default=1, help="Pipeline parallelism: not ported yet.")
    p.add_argument("--tp", type=int, default=1, help="Tensor parallelism: not ported yet.")
    return p.parse_args(argv)


def _check_ported(args: argparse.Namespace) -> None:
    missing = []
    if args.quant != "none":
        missing.append(f"--quant {args.quant}")
    if args.tp > 1:
        missing.append(f"--tp {args.tp}")
    if args.pp > 1:
        missing.append(f"--pp {args.pp}")
    if args.lora_path:
        missing.append("--lora_path")
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not ported yet to the PyTorch package "
            "(use ragb_vae_tpu.inference)."
        )


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


def run(args: argparse.Namespace) -> None:
    from ragb_vae_tpu_torch.data.image_io import load_rgba, save_rgba
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel

    _check_ported(args)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    model = FluxTextAlphaModel.from_pretrained(
        args.pretrained_model_name_or_path,
        vae_path=args.rgba_vae_path,
        vae_subfolder=args.vae_subfolder,
        dtype=_DTYPES[args.precision],
        device=device,
        fused=device.type == "cuda",
    )
    generator = torch.Generator(device).manual_seed(args.seed if args.seed is not None else 0)

    def run_sample(batch: np.ndarray) -> np.ndarray:
        out = model.sample(torch.from_numpy(batch), num_inference_steps=args.steps, generator=generator)
        return out.cpu().numpy()

    paths = _resolve_inputs(args.input_image)
    if len(paths) == 1:
        pred = run_sample(load_rgba(paths[0])[None])
        save_rgba(pred[0], args.output_path)
        print(f"Saved to {args.output_path}")
        return

    out_dir = Path(args.output_path)
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
            for (path, _), pred in zip(chunk, preds):
                out = out_dir / (Path(path).stem + "_text_alpha.png")
                n = 1
                while out in used:
                    out = out_dir / (Path(path).stem + f"_text_alpha_{n}.png")
                    n += 1
                used.add(out)
                save_rgba(pred, out)
            done += len(chunk)
    print(f"Saved {done} predictions to {out_dir}")


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
