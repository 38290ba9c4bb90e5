#!/usr/bin/env python3
"""Reconstruct components through the stock RGB VAE (alpha dropped) with the
PyTorch port, as a visual baseline grid (input | reconstruction per row) and
the first image's PSNR.

The same flags as `scripts/rgb_vae_sanity_check.py` (a multilayer sample
through --rendered-root / --json-root, or one --image PNG), plus --seed (the
posterior noise, drawn from a torch.Generator) and --device (default cuda; a
missing card raises, --device cpu runs on the CPU). On the card the VAE runs
its fused kernels in bf16.

    python scripts/rgb_vae_sanity_check_torch.py --rgb-vae SRC --vae-subfolder ae --image in.png
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.device import resolve_device  # noqa: E402


def reconstruct_rgb(model, component: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """component: (1, H, W, C) in [0, 1] -> its reconstruction in [0, 1], fp32."""
    posterior = model.encode(component * 2.0 - 1.0)
    latents = posterior.sample(generator=generator, dtype=model.compute_dtype)
    recon = model.decode(latents)
    return torch.clamp((recon.float() + 1.0) * 0.5, 0.0, 1.0)


def load_stock_vae(path: str, subfolder, device: torch.device):
    """The checkpoint as it is (not widened to RGBA) in an RgbaVAE holder;
    on the card with bf16 compute and the fused kernels."""
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.models.weights import load_autoencoder_params

    config, state = load_autoencoder_params(path, subfolder)
    on_card = device.type == "cuda"
    model = RgbaVAE(config, compute_dtype=torch.bfloat16 if on_card else None, device="meta")
    model.module.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True, assign=True)
    if on_card:
        model.enable_fused()
    return model


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rendered-root", type=str, default=None)
    parser.add_argument("--json-root", type=str, default=None)
    parser.add_argument("--image", type=str, default=None, help="Single RGB(A) PNG to round-trip.")
    parser.add_argument("--sample-index", type=int, default=0)
    parser.add_argument("--max-components", type=int, default=12)
    parser.add_argument("--rgb-vae", type=str, required=True, help="Local dir of the RGB VAE.")
    parser.add_argument("--vae-subfolder", type=str, default="vae")
    parser.add_argument("--overlay-background", action="store_true")
    parser.add_argument("--output", type=str, default="outputs/rgb_vae_sanity.png")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the posterior noise.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run the VAE on. 'cuda' without a CUDA device is an error.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from PIL import Image

    from ragb_vae_tpu_torch.training.rgba_vae_stage import _to_uint8

    model = load_stock_vae(args.rgb_vae, args.vae_subfolder if args.vae_subfolder != "" else None, device)

    images = []
    if args.image:
        images.append(np.asarray(Image.open(args.image).convert("RGB"), np.float32) / 255.0)
    else:
        from ragb_vae_tpu_torch.data.multilayer_dataset import MultiLayerDataset

        kwargs = {}
        if args.rendered_root:
            kwargs["rendered_root"] = Path(args.rendered_root)
        if args.json_root:
            kwargs["json_root"] = Path(args.json_root)
        sample = MultiLayerDataset(alpha_threshold=0, **kwargs)[args.sample_index]
        for comp in sample.components[: args.max_components]:
            comp = np.asarray(comp, np.float32)
            rgb, alpha = comp[..., :3], comp[..., 3:]
            if args.overlay_background:
                rgb = rgb * alpha + np.asarray(sample.background, np.float32)[..., :3] * (1 - alpha)
            images.append(rgb)

    if not images:
        print("No images to reconstruct.")
        return

    generator = torch.Generator(device).manual_seed(args.seed)
    rows = []
    with torch.inference_mode():
        for rgb in images:
            inp = rgb
            if model.config.in_channels == 4:
                inp = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
            recon = reconstruct_rgb(model, torch.from_numpy(inp[None]).to(device), generator)[0].cpu().numpy()
            rows.append(np.concatenate([rgb, recon[..., :3]], axis=1))
    grid = np.concatenate(rows, axis=0)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(_to_uint8(grid)).save(out)
    half = rows[0].shape[1] // 2
    mse = float(np.mean((rows[0][:, :half] - rows[0][:, half:]) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-8))
    print(f"Saved RGB VAE sanity grid to {out} (first-image PSNR {psnr:.2f} dB)")


if __name__ == "__main__":
    main()
