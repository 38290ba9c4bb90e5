#!/usr/bin/env python
"""Training entry point of the PyTorch port:

    python scripts/train_torch.py --config configs/flux_vae.yaml [--stage S] [--device cuda]

Loads a `{data, training, model}` YAML (with `${env:VAR}` expansion) and runs
the stage `training.stage` names (`--stage` overrides it) through
`ragb_vae_tpu_torch.training.run_stage`, on `--device`: the card by default;
a missing card raises. `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.config import load_config  # noqa: E402
from ragb_vae_tpu_torch.device import resolve_device  # noqa: E402
from ragb_vae_tpu_torch.training import run_stage  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train ragb-vae stages on PyTorch.")
    parser.add_argument("--config", required=True, help="Path to the YAML config.")
    parser.add_argument("--stage", default=None, help="Override training.stage from the config.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.stage:
        cfg.setdefault("training", {})["stage"] = args.stage
    return run_stage(cfg, device=device)


if __name__ == "__main__":
    main()
