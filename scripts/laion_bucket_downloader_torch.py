#!/usr/bin/env python3
"""Stream laion2B-en-aesthetic and download its RGB images into buckets, on
the port.

The flags of `scripts/laion_bucket_downloader.py`. Needs the network,
`datasets` and `requests`; run it on CPU hosts.
"""
from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.data_generation.hf_bucketers import (  # noqa: E402
    LAION_MIN_SIDE,
    process_laion_row,
    write_manifest,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Bucket laion2B-en-aesthetic subset into RGB buckets.")
    parser.add_argument("--output-root", type=Path, required=True)
    parser.add_argument("--max-samples", type=int, default=1_000_000)
    parser.add_argument("--min-side", type=int, default=LAION_MIN_SIDE)
    parser.add_argument("--num-workers", type=int, default=16)
    parser.add_argument("--hf-cache", type=Path, default=None)
    args = parser.parse_args(argv)

    if args.hf_cache:
        os.environ["HF_HOME"] = str(args.hf_cache)
        os.environ["HF_DATASETS_CACHE"] = str(args.hf_cache)

    from datasets import load_dataset

    output_root = args.output_root
    output_root.mkdir(parents=True, exist_ok=True)
    ds = load_dataset("laion/laion2B-en-aesthetic", split="train", streaming=True)

    manifest, futures, kept = [], [], 0
    with ThreadPoolExecutor(max_workers=args.num_workers) as ex:
        for row in ds:
            if kept >= args.max_samples:
                break
            futures.append(ex.submit(process_laion_row, row, output_root, args.min_side))
            # a bounded queue of futures bounds the memory
            if len(futures) >= args.num_workers * 4:
                for f in as_completed(futures):
                    res = f.result()
                    if res:
                        manifest.append(res)
                        kept += 1
                        if kept >= args.max_samples:
                            break
                futures = []
        for f in as_completed(futures):
            res = f.result()
            if res:
                manifest.append(res)
                kept += 1
                if kept >= args.max_samples:
                    break

    write_manifest(manifest, output_root / "metadata" / "laion_aesthetic_manifest.json")
    print(f"Done. kept={kept}")


if __name__ == "__main__":
    main()
