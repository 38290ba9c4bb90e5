#!/usr/bin/env python3
"""Convert a pretrained RGB VAE checkpoint (Qwen or Flux) to RGBA, with the
PyTorch port.

The same flags and defaults as `scripts/convert_qwen_vae_to_rgba.py` ('vae'
for qwen, 'ae' for flux), and the same weights out, bit for bit: the RGB
weights are copied and the alpha path is zero-initialised (its output bias
from --alpha-bias-init) by `models/weights.py::adapt_params_to_rgba`.

    python scripts/convert_qwen_vae_to_rgba_torch.py --source SRC --arch flux --output-dir OUT
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

SCRIPT_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(SCRIPT_DIR.parent))

from ragb_vae_tpu_torch.models.weights import (  # noqa: E402
    load_autoencoder_params,
    save_autoencoder_params,
)


def convert(source: str, subfolder, alpha_bias_init: float):
    """Load an RGB AutoencoderKL dir and widen it to RGBA -> (config, state dict)."""
    return load_autoencoder_params(source, subfolder, adapt_to_rgba=True, alpha_bias_init=alpha_bias_init)


# arch-named aliases, as the JAX script has
def convert_qwen(source: str, subfolder: str = "vae", alpha_bias_init: float = 0.0):
    return convert(source, subfolder, alpha_bias_init)


def convert_flux(source: str, subfolder: str = "ae", alpha_bias_init: float = 0.0):
    return convert(source, subfolder, alpha_bias_init)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", required=True, help="Local directory with the RGB VAE.")
    parser.add_argument("--arch", default="qwen", choices=["qwen", "flux"],
                        help="Base VAE family to convert.")
    parser.add_argument("--subfolder", default=None,
                        help="Subfolder inside --source (defaults to 'vae' for Qwen or 'ae' for Flux).")
    parser.add_argument("--alpha-bias-init", type=float, default=0.0,
                        help="Initial bias for alpha channel.")
    parser.add_argument("--dtype", default="float32",
                        choices=["float16", "bfloat16", "float32"],
                        help="Kept for CLI parity; weights are stored float32.")
    parser.add_argument("--output-dir", required=True,
                        help="Directory to save the converted RGBA VAE (HF format).")
    parser.add_argument("--state-dict", action="store_true",
                        help="Kept for CLI parity (safetensors is always written).")
    return parser


def subfolder_of(args: argparse.Namespace) -> str:
    default = "ae" if args.arch == "flux" else "vae"
    return args.subfolder if args.subfolder not in (None, "") else default


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    config, state = convert(args.source, subfolder_of(args), args.alpha_bias_init)
    save_autoencoder_params(config, state, args.output_dir)
    print(f"Saved RGBA VAE to {args.output_dir}")


if __name__ == "__main__":
    main()
