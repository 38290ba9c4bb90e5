"""MixedBucketDataset: an index over `build_bucket_entries` output.

Counterpart of `ragb_vae_tpu/data/bucket_dataset.py`. Each entry is one
image, served under the key "composite" (the stage-1 loop treats a lone image
as a composite) as an (H, W, 4) float32 array in [0, 1]; `bucket_to_indices`
groups the entries for `BucketBatchSampler`. Images decode through PIL one at
a time (the JAX package's native batch PNG decode is not ported).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

from ragb_vae_tpu_torch.data.image_io import load_rgba


class MixedBucketDataset:
    """Entries must hold bucket and image_path (see `data/manifest.py`)."""

    def __init__(
        self,
        root_dir: Union[Path, str],
        entries: Sequence[Dict[str, Any]],
        *,
        include_metadata: bool = False,
        include_background: bool = False,
        blend_component_to_white: bool = False,
        transform=None,
    ) -> None:
        self.root_dir = Path(root_dir)
        self.entries: List[Dict[str, Any]] = list(entries)
        self.include_metadata = include_metadata
        # accepted for config compatibility and unused, as in the JAX package
        self.include_background = include_background
        self.blend_component_to_white = blend_component_to_white
        self.transform = transform
        self.bucket_to_indices: Dict[str, List[int]] = {}
        for idx, entry in enumerate(self.entries):
            self.bucket_to_indices.setdefault(entry["bucket"], []).append(idx)

    def __len__(self) -> int:
        return len(self.entries)

    def _path(self, entry: Dict[str, Any]) -> Path:
        if entry.get("image_path") is None:
            raise ValueError("image_path is required for each entry.")
        return Path(entry.get("root_dir", self.root_dir)) / entry["image_path"]

    def __getitem__(self, index: int) -> Dict[str, Any]:
        entry = self.entries[index]
        sample: Dict[str, Any] = {"composite": load_rgba(self._path(entry))}
        if self.include_metadata:
            sample.update({
                "bucket": entry.get("bucket"),
                "bucket_dims": tuple(entry.get("bucket_dims") or ()),
                "source_sample": entry.get("source_sample"),
                "image_path": entry.get("image_path"),
                "variant": entry.get("variant"),
            })
        return self.transform(sample) if self.transform is not None else sample
