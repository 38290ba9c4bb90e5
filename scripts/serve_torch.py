#!/usr/bin/env python
"""Thin shim over ragb_vae_tpu_torch.serving_daemon, the PyTorch port's
serving daemon (the installed `ragb-serve-torch` entry point calls the module
directly):

    python scripts/serve_torch.py --pretrained_model_name_or_path CKPT \
        --rgba_vae_path VAE [--port 8418] [--quant int8] [--device cuda]
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.serving_daemon import (  # noqa: E402,F401
    build_server,
    main,
    make_handler,
    make_httpd,
    parse_args,
)

if __name__ == "__main__":
    main()
