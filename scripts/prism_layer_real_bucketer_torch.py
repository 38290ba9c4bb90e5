#!/usr/bin/env python3
"""Bucket HF artplus/PrismLayersReal samples (base/whole/layers), on the port.

The flags of `scripts/prism_layer_real_bucketer.py`. Needs the network and
`datasets`; run it on a CPU host where the data can be reached.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.data_generation.hf_bucketers import (  # noqa: E402
    process_prism_real_sample,
    write_manifest,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Bucket PrismLayersReal samples (base/whole/layers).")
    parser.add_argument("--output-root", type=Path, required=True)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--max-samples", type=int, default=None)
    args = parser.parse_args(argv)

    from datasets import load_dataset

    print("Loading dataset artplus/PrismLayersReal ...")
    ds = load_dataset("artplus/PrismLayersReal", split="train")

    output_root = Path(args.output_root)
    output_root.mkdir(parents=True, exist_ok=True)
    manifest = []
    total = len(ds) if args.max_samples is None else min(len(ds), args.max_samples)
    for idx in range(total):
        entry = process_prism_real_sample(ds[idx], idx, output_root=output_root, split=args.split)
        if entry:
            manifest.append(entry)
    write_manifest(manifest, output_root / "metadata" / "manifest.json")
    print(f"Done. Saved {len(manifest)} samples.")


if __name__ == "__main__":
    main()
