"""MixedBucketDataset: an index over `build_bucket_entries` output.

Counterpart of `ragb_vae_tpu/data/bucket_dataset.py`. Each entry is one
image, served under the key "composite" (the stage-1 loop treats a lone image
as a composite) as an (H, W, 4) float32 array in [0, 1]; `bucket_to_indices`
groups the entries for `BucketBatchSampler`. `getitems` decodes a batch of
PNGs of one size in one native call (`data/native_io.py`), anything else one
image at a time.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

from ragb_vae_tpu_torch.data import native_io
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

    def _make_sample(self, entry: Dict[str, Any], composite) -> Dict[str, Any]:
        sample: Dict[str, Any] = {"composite": composite}
        if self.include_metadata:
            sample.update({
                "bucket": entry.get("bucket"),
                "bucket_dims": tuple(entry.get("bucket_dims") or ()),
                "source_sample": entry.get("source_sample"),
                "image_path": entry.get("image_path"),
                "variant": entry.get("variant"),
            })
        return self.transform(sample) if self.transform is not None else sample

    def __getitem__(self, index: int) -> Dict[str, Any]:
        entry = self.entries[index]
        return self._make_sample(entry, load_rgba(self._path(entry)))

    def getitems(self, indices: Sequence[int], *, map_fn=None) -> List[Dict[str, Any]]:
        """The samples of `indices`: one native batch decode when every image
        is a PNG of one size (a bucket-pure batch), else one decode per item,
        through `map_fn` (the loader's thread pool) when given."""
        entries = [self.entries[i] for i in indices]
        try:
            paths = [self._path(e) for e in entries]
            if len(paths) > 1 and native_io.available() and all(p.suffix.lower() == ".png" for p in paths):
                sizes = {native_io.png_size(p) for p in paths}
                if len(sizes) == 1:
                    (w, h), = sizes
                    batch = native_io.decode_batch(paths, h, w)
                    return [self._make_sample(e, batch[j]) for j, e in enumerate(entries)]
        except Exception:
            pass  # odd PNGs, native failures: one item at a time below
        if map_fn is not None and len(indices) > 1:
            return list(map_fn(self.__getitem__, indices))
        return [self[i] for i in indices]
