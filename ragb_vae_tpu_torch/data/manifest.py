"""Manifest readers: the four bucket-dataset schemas as one list of entries.

Counterpart of `ragb_vae_tpu/data/manifest.py`. Every entry is a plain dict
{split, root_dir, bucket, bucket_dims, image_path, source_sample, variant};
the schemas, their key names and the order in which an item's images become
entries are the data contract of the offline preparation tools, so a tree
those tools wrote reads the same here as in the JAX package.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ragb_vae_tpu_torch.data.buckets import parse_bucket_dims

Entry = Dict[str, Any]


def _load_json(path: Path) -> Any:
    with path.open("r", encoding="utf-8") as f:
        return json.load(f)


def _bucket_of(item: Dict[str, Any]) -> Tuple[Optional[str], Tuple[int, int]]:
    """(bucket key, (width, height)): `bucket_dims` when given, else parsed
    from the `w{W}-h{H}` key."""
    if item.get("bucket_dims") is not None:
        return item.get("bucket"), tuple(item["bucket_dims"])
    if item.get("bucket") is None:
        raise ValueError("Entry must contain either bucket or bucket_dims")
    return item["bucket"], parse_bucket_dims(item["bucket"])


def _entries(
    data: Iterable[Dict[str, Any]],
    *,
    split: str,
    root: Path,
    respect_split: bool,
    id_key: str,
    variants,
) -> List[Entry]:
    """One entry per (item, variant image). `variants(item)` lists the item's
    (variant, path) pairs in the schema's order."""
    out: List[Entry] = []
    for item in data:
        if respect_split and item.get("split") != split:
            continue
        bucket, dims = _bucket_of(item)
        for variant, path in variants(item):
            out.append({"split": split, "root_dir": str(root), "bucket": bucket, "bucket_dims": dims,
                        "image_path": path, "source_sample": item.get(id_key), "variant": variant})
    return out


def _present(item: Dict[str, Any], pairs: Sequence[Tuple[str, str]]) -> List[Tuple[str, str]]:
    """(variant, item[key]) for each (variant, key) whose value is set."""
    return [(variant, item[key]) for variant, key in pairs if item.get(key)]


def standardize_components_manifest(
    data: List[Dict[str, Any]], *, split: str, root: Path, respect_split: bool = True
) -> List[Entry]:
    """The schema prepare_rgba_buckets writes: component / composite /
    background paths, then every selected component."""
    def variants(item):
        fixed = _present(item, (("component", "component_path"), ("composite", "composite_path"),
                                ("background", "background_path")))
        return fixed + [("selected_component", p) for p in item.get("selected_component_paths", [])]

    return _entries(data, split=split, root=root, respect_split=respect_split, id_key="source_sample",
                    variants=variants)


def standardize_prism_real(
    data: List[Dict[str, Any]], *, split: str, root: Path, respect_split: bool = True
) -> List[Entry]:
    """PrismLayersReal: base, whole, then each layer."""
    def variants(item):
        fixed = _present(item, (("base", "base_path"), ("whole", "whole_path")))
        return fixed + [("layer", p) for p in item.get("layer_paths") or []]

    return _entries(data, split=split, root=root, respect_split=respect_split, id_key="id",
                    variants=variants)


def standardize_prism_pro(
    data: List[Dict[str, Any]],
    *,
    split: str,
    use_fg: bool,
    use_rep: bool,
    root: Path,
    respect_split: bool = True,
) -> List[Entry]:
    """PrismLayersPro: base, composite, and optionally the non-overlapping
    foreground and the representative layer."""
    pairs = [("base", "base_path"), ("composite", "composite_path")]
    if use_fg:
        pairs.append(("fg_non_overlap", "fg_non_overlap_path"))
    if use_rep:
        pairs.append(("rep", "rep_path"))
    return _entries(data, split=split, root=root, respect_split=respect_split, id_key="id",
                    variants=lambda item: _present(item, pairs))


def collect_laion_rgb(root: Path, *, split: str, max_count: Optional[int] = None) -> List[Entry]:
    """A tree without a manifest: {split}/w{W}-h{H}/*.png, buckets and files
    in sorted order, at most `max_count` entries."""
    split_root = root / split
    if not split_root.exists():
        return []
    out: List[Entry] = []
    for bucket_dir in sorted(p for p in split_root.iterdir() if p.is_dir()):
        dims = parse_bucket_dims(bucket_dir.name)
        for path in sorted(bucket_dir.glob("*.png")):
            out.append({"split": split, "root_dir": str(root), "bucket": bucket_dir.name,
                        "bucket_dims": dims, "image_path": str(Path(split) / bucket_dir.name / path.name),
                        "source_sample": path.stem, "variant": "rgb_only"})
            if max_count is not None and len(out) >= max_count:
                return out
    return out


def build_bucket_entries(dataset_cfgs: Sequence[Dict[str, Any]], *, split: str) -> List[Entry]:
    """The entries of every dataset config that serves `split`, in order."""
    combined: List[Entry] = []
    for cfg in dataset_cfgs:
        if cfg.get("splits") is not None and split not in cfg["splits"]:
            continue
        kind = cfg.get("type", "components")
        root = Path(cfg["root"])
        target_split = cfg.get("split", split)
        respect = bool(cfg.get("respect_manifest_split", True))
        if kind == "laion_rgb":
            combined.extend(collect_laion_rgb(root, split=target_split, max_count=cfg.get("max_count")))
            continue
        data = _load_json(Path(cfg.get("manifest") or (root / "metadata" / "manifest.json")))
        if kind == "components":
            combined.extend(standardize_components_manifest(data, split=target_split, root=root,
                                                             respect_split=respect))
        elif kind == "prism_real":
            combined.extend(standardize_prism_real(data, split=target_split, root=root, respect_split=respect))
        elif kind == "prism_pro":
            combined.extend(standardize_prism_pro(
                data, split=target_split, use_fg=bool(cfg.get("use_fg_non_overlap", True)),
                use_rep=bool(cfg.get("use_rep", True)), root=root, respect_split=respect))
        else:
            raise ValueError(f"Unknown dataset type: {kind}")
    return combined
