#!/usr/bin/env python3
"""Inference CLI shim of the PyTorch port: the logic lives in
ragb_vae_tpu_torch.inference (the same flags as inference_rgba_flux.py, plus
`--device`, default `cuda`)."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ragb_vae_tpu_torch.inference import main  # noqa: E402

if __name__ == "__main__":
    main()
