#!/usr/bin/env python3
"""Convert a Qwen/Flux VAE to RGBA and stash it under checkpoints/rgba_vae_init,
with the PyTorch port: the stage-1 loop's `model.rgb_checkpoint`.

The same flags as `scripts/prepare_rgba_vae_init.py` (those of
`convert_qwen_vae_to_rgba_torch.py`, with --output-dir defaulting to
checkpoints/rgba_vae_init).

    python scripts/prepare_rgba_vae_init_torch.py --source SRC --arch flux \
        --output-dir checkpoints/flux_rgba_vae_init
"""
from __future__ import annotations

import sys
from pathlib import Path

SCRIPT_DIR = Path(__file__).resolve().parent
for path in (SCRIPT_DIR, SCRIPT_DIR.parent):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from convert_qwen_vae_to_rgba_torch import build_parser, convert, subfolder_of  # noqa: E402
from ragb_vae_tpu_torch.models.weights import save_autoencoder_params  # noqa: E402


def main(argv=None) -> None:
    parser = build_parser()
    # the same flags, but the output defaults to checkpoints/rgba_vae_init
    parser.set_defaults(output_dir=str(SCRIPT_DIR.parent / "checkpoints" / "rgba_vae_init"))
    for action in parser._actions:
        if action.dest == "output_dir":
            action.required = False
    args = parser.parse_args(argv)

    config, state = convert(args.source, subfolder_of(args), args.alpha_bias_init)
    output_dir = Path(args.output_dir).expanduser().resolve()
    save_autoencoder_params(config, state, output_dir)
    print(f"[prepare_rgba_vae_init] Saved {args.arch} RGBA VAE to {output_dir}")


if __name__ == "__main__":
    main()
