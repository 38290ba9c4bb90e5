#!/usr/bin/env python3
"""Bucket HF artplus/PrismLayersPro (base/composite/non-overlap/rep) with
modulo sharding across hosts, on the port.

The flags of `scripts/prism_layer_pro_bucketer.py`. Needs the network and
`datasets`; run it on CPU hosts where the data can be reached.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.data_generation.hf_bucketers import (  # noqa: E402
    process_prism_pro_sample,
    shard_indices,
    write_manifest,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Bucket PrismLayersPro (base/composite/non-overlap/rep)."
    )
    parser.add_argument("--output-root", type=Path, required=True)
    parser.add_argument("--splits", type=str, default="all",
                        help="Comma-separated splits, or 'all'.")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cache-dir", type=Path, default=None,
                        help="HF cache dir (sets HF_HOME/HF_DATASETS_CACHE).")
    parser.add_argument("--world-size", type=int, default=1)
    parser.add_argument("--rank", type=int, default=0)
    args = parser.parse_args(argv)

    if args.cache_dir:
        args.cache_dir.mkdir(parents=True, exist_ok=True)
        os.environ.setdefault("HF_HOME", str(args.cache_dir))
        os.environ.setdefault("HF_DATASETS_CACHE", str(args.cache_dir))

    from datasets import load_dataset

    ds = load_dataset("artplus/PrismLayersPro",
                      cache_dir=str(args.cache_dir) if args.cache_dir else None)
    split_names = (
        list(ds.keys())
        if args.splits.strip().lower() == "all"
        else [s.strip() for s in args.splits.split(",") if s.strip()]
    )

    output_root = Path(args.output_root)
    manifest = []
    rng = np.random.default_rng(args.seed)
    for split in split_names:
        if split not in ds:
            print(f"[warn] split {split} not found; skipping.")
            continue
        split_ds = ds[split]
        limit = len(split_ds) if args.max_samples is None else min(len(split_ds), args.max_samples)
        for idx in shard_indices(limit, args.world_size, args.rank):
            entry = process_prism_pro_sample(
                split_ds[idx], idx, output_root=output_root, split=split, rng=rng
            )
            if entry:
                manifest.append(entry)
    write_manifest(manifest, output_root / "metadata" / "manifest.json")
    print(f"Done. Saved {len(manifest)} entries.")


if __name__ == "__main__":
    main()
