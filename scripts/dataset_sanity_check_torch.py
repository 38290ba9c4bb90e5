#!/usr/bin/env python3
"""Multilayer dataset + dataloader sanity check with the PyTorch port: a dump
of one batch's shapes and, when --vae-checkpoint exists, a reconstruction
grid of its components through the RGBA VAE over a checkerboard (GT | recon
per row).

The same flags as `scripts/dataset_sanity_check.py`, plus --seed (the
posterior noise, drawn from a torch.Generator) and --device (default cuda; a
missing card raises, --device cpu runs on the CPU).

    python scripts/dataset_sanity_check_torch.py --rendered-root R --json-root J \
        --vae-checkpoint checkpoints/rgba_vae_init
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.data.loader import DataLoader  # noqa: E402
from ragb_vae_tpu_torch.data.multilayer_dataset import (  # noqa: E402
    MultiLayerDataset,
    multilayer_collate,
)
from ragb_vae_tpu_torch.device import resolve_device  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rendered-root", type=str, default=None)
    parser.add_argument("--json-root", type=str, default=None)
    parser.add_argument("--max-samples", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--alpha-threshold", type=int, default=100)
    parser.add_argument("--vae-checkpoint", type=str, default="checkpoints/rgba_vae_init")
    parser.add_argument("--output", type=str, default="outputs/dataset_sanity.png")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the posterior noise.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run the VAE on. 'cuda' without a CUDA device is an error.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    kwargs = {}
    if args.rendered_root:
        kwargs["rendered_root"] = Path(args.rendered_root)
    if args.json_root:
        kwargs["json_root"] = Path(args.json_root)
    ds = MultiLayerDataset(alpha_threshold=args.alpha_threshold, max_samples=args.max_samples, **kwargs)
    dl = DataLoader(ds, batch_size=args.batch_size, shuffle=False, num_workers=0,
                    collate_fn=multilayer_collate)
    batch = next(iter(dl))
    print("Batch keys:", list(batch.keys()))
    for key in ("background", "composite", "components", "component_mask", "visible_masks"):
        value = batch[key]
        print(f"{key}:", getattr(value, "shape", value))
    print("sample_dirs:", batch["sample_dirs"])

    ckpt_dir = Path(args.vae_checkpoint)
    if not ckpt_dir.exists():
        print(f"No VAE checkpoint at {ckpt_dir}; skipping reconstruction test.")
        return

    from PIL import Image

    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.ops.rgba import composite_over_checkerboard
    from ragb_vae_tpu_torch.training.rgba_vae_stage import _to_uint8

    on_card = device.type == "cuda"
    # the kernels take bf16 operands: fp32 weights, bf16 compute on the card
    model = RgbaVAE.from_pretrained_rgb(str(ckpt_dir), subfolder=None, device=device,
                                        compute_dtype=torch.bfloat16 if on_card else None)
    if on_card:
        model.enable_fused()
    mask = np.asarray(batch["component_mask"][0]).astype(bool)
    components = np.asarray(batch["components"][0], np.float32)[mask]
    if components.size == 0:
        print("No valid components in batch; skipping reconstruction test.")
        return
    generator = torch.Generator(device).manual_seed(args.seed)
    with torch.inference_mode():
        recon, _ = model.forward(torch.from_numpy(components).to(device), generator=generator)
    recon = recon.float().cpu().numpy()
    rows = []
    for gt, rc in zip(components, recon):
        gt_c = composite_over_checkerboard(torch.from_numpy(gt[None]))[0].numpy()
        rc_c = composite_over_checkerboard(torch.from_numpy(rc[None]))[0].numpy()
        rows.append(np.concatenate([gt_c, rc_c], axis=1))
    grid = np.concatenate(rows, axis=0)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(_to_uint8(grid)).save(out)
    print(f"Saved reconstruction grid to {out}")


if __name__ == "__main__":
    main()
