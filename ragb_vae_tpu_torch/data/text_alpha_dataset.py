"""(gt, text_alpha) RGBA pairs from a bucketed tree.

Counterpart of `ragb_vae_tpu/data/text_alpha_dataset.py`. Layout:

    root/{split}/w{W}-h{H}/gt/*.png  and  .../text_alpha/{same name}.png

A pair counts only when both files exist; directories that are no bucket are
skipped. Items are numpy (H, W, 4) float32 in [0, 1].
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from ragb_vae_tpu_torch.data.buckets import parse_bucket_dims, BUCKET_RE
from ragb_vae_tpu_torch.data.image_io import load_rgba


class TextAlphaBucketDataset:
    def __init__(self, root: Union[Path, str], split: str = "train") -> None:
        self.split_root = Path(root) / split
        if not self.split_root.exists():
            raise FileNotFoundError(f"Split root not found: {self.split_root}")
        self.entries: List[Dict] = []
        for bucket_dir in sorted(p for p in self.split_root.iterdir() if p.is_dir()):
            if not BUCKET_RE.match(bucket_dir.name):
                continue
            gt_dir, ta_dir = bucket_dir / "gt", bucket_dir / "text_alpha"
            if not (gt_dir.exists() and ta_dir.exists()):
                continue
            dims = parse_bucket_dims(bucket_dir.name)
            for gt_path in sorted(gt_dir.glob("*.png")):
                ta_path = ta_dir / gt_path.name
                if ta_path.exists():
                    self.entries.append({
                        "bucket": bucket_dir.name, "bucket_dims": dims, "gt_path": gt_path,
                        "text_alpha_path": ta_path, "sample_name": gt_path.stem,
                    })
        if not self.entries:
            raise ValueError(f"No gt/text_alpha pairs found under {self.split_root}")
        self.bucket_to_indices: Dict[str, List[int]] = {}
        for idx, entry in enumerate(self.entries):
            self.bucket_to_indices.setdefault(entry["bucket"], []).append(idx)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict:
        entry = self.entries[idx]
        return {
            "gt": load_rgba(entry["gt_path"]),
            "text_alpha": load_rgba(entry["text_alpha_path"]),
            "bucket": entry["bucket"],
            "bucket_dims": np.asarray(entry["bucket_dims"], dtype=np.int64),
            "sample_name": entry["sample_name"],
        }
