"""Bucketed RGBA (component, composite) pairs.

Counterpart of `ragb_vae_tpu/data/component_dataset.py`: the tree that
prepare_rgba_buckets writes, `root/{train,val}/w{W}-h{H}/*.png` with
`root/metadata/manifest.json`, served as (H, W, 4) float32 arrays through the
port's threaded `DataLoader`.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from ragb_vae_tpu_torch.data.image_io import load_rgba
from ragb_vae_tpu_torch.data.loader import DataLoader, default_collate, pad_collate

Sample = Dict[str, Any]


def blend_to_white(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) composited over white, alpha := 1."""
    alpha = rgba[..., 3:4]
    return np.concatenate([rgba[..., :3] * alpha + (1.0 - alpha), np.ones_like(alpha)], axis=-1)


class RgbaComponentDataset:
    """Yields {component, composite} RGBA pairs, with metadata on request."""

    def __init__(
        self,
        root_dir: Union[Path, str] = "data/rgba_layers",
        manifest_path: Optional[Union[Path, str]] = None,
        split: str = "train",
        limit: Optional[int] = None,
        transform: Optional[Callable[[Sample], Sample]] = None,
        include_metadata: bool = True,
        blend_component_to_white: bool = False,
    ) -> None:
        self.root_dir = Path(root_dir)
        manifest_path = Path(manifest_path or (self.root_dir / "metadata" / "manifest.json"))
        with manifest_path.open("r", encoding="utf-8") as f:
            entries: List[Dict[str, Any]] = json.load(f)
        self.entries = [e for e in entries if e["split"] == split][:limit]
        self.transform = transform
        self.include_metadata = include_metadata
        self.blend_component_to_white = blend_component_to_white

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, index: int) -> Sample:
        entry = self.entries[index]
        component = load_rgba(self.root_dir / entry["component_path"])
        sample: Sample = {"component": component,
                          "composite": load_rgba(self.root_dir / entry["composite_path"])}
        if self.blend_component_to_white:
            sample["component_white"] = blend_to_white(component)
        if self.include_metadata:
            sample.update({
                "bucket": entry["bucket"],
                "bucket_dims": tuple(entry["bucket_dims"]),
                "source_sample": entry["source_sample"],
                "component_index": entry["component_index"],
                "original_size": tuple(entry["original_size"]),
                "component_path": entry["component_path"],
                "composite_path": entry["composite_path"],
            })
        return self.transform(sample) if self.transform is not None else sample


def create_component_dataloader(
    root_dir: Union[Path, str] = "data/rgba_layers",
    manifest_path: Optional[Union[Path, str]] = None,
    split: str = "train",
    batch_size: int = 8,
    shuffle: bool = True,
    num_workers: int = 0,
    limit: Optional[int] = None,
    transform: Optional[Callable[[Sample], Sample]] = None,
    dataset_kwargs: Optional[Dict[str, Any]] = None,
    seed: Optional[int] = None,
    **loader_kwargs: Any,
) -> DataLoader:
    """The dataset in a loader: shuffled only for "train"; batches are
    zero-padded to their largest image (`pad_collate`) unless metadata is
    asked for, which stacks them as they are."""
    dataset_kwargs = dataset_kwargs or {}
    dataset = RgbaComponentDataset(root_dir=root_dir, manifest_path=manifest_path, split=split,
                                   limit=limit, transform=transform, **dataset_kwargs)
    collate = default_collate if dataset_kwargs.get("include_metadata", False) else pad_collate
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle if split == "train" else False,
                      num_workers=num_workers, collate_fn=collate, seed=seed, **loader_kwargs)
