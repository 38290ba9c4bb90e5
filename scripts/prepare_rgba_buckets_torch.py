#!/usr/bin/env python3
"""CLI for the offline RGBA bucket preparation, on the port.

The flags of `scripts/prepare_rgba_buckets.py`; the work is
`ragb_vae_tpu_torch/data_generation/rgba_buckets.py::run_prepare`, which
writes the same manifest and the same PNG bytes. Host-side: numpy, PIL and
scipy, no card.

    python scripts/prepare_rgba_buckets_torch.py --rendered-root R --output-root O [--num-workers N]
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.data_generation.rgba_buckets import run_prepare  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Bucket RGBA component layers for VAE training.")
    parser.add_argument("--rendered-root", type=Path, required=True)
    parser.add_argument("--output-root", type=Path, required=True)
    parser.add_argument("--validation-list", type=Path, default=None,
                        help="File with validation sample names (one per line).")
    parser.add_argument("--train-count", type=int, default=None,
                        help="Optional cap on training composites.")
    parser.add_argument("--val-count", type=int, default=None,
                        help="Optional cap on validation composites.")
    parser.add_argument("--fg-max-groups", type=int, default=None,
                        help="Cap on foreground groups per sample.")
    parser.add_argument("--fg-erosion-iterations", type=int, default=1,
                        help="3x3 erosion iterations before overlap grouping.")
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--max-samples", type=int, default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    records = run_prepare(
        args.rendered_root,
        args.output_root,
        validation_list=args.validation_list,
        train_count=args.train_count,
        val_count=args.val_count,
        fg_max_groups=args.fg_max_groups,
        fg_erosion_iterations=args.fg_erosion_iterations,
        num_workers=args.num_workers,
        seed=args.seed,
        max_samples=args.max_samples,
    )
    print(f"Wrote manifest with {len(records)} entries to {args.output_root}/metadata/manifest.json")


if __name__ == "__main__":
    main()
