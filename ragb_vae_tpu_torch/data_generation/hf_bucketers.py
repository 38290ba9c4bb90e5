"""PrismLayers bucketers and the LAION downloader (host-side, network-using).

Counterpart of `ragb_vae_tpu/data_generation/hf_bucketers.py`:
- PrismLayersReal: restore each cropped layer onto the full canvas by its
  box, resize to the bucket, save base / whole / layer_n;
- PrismLayersPro: also a back-to-front non-overlapping foreground composite
  and an alpha-sum-weighted representative layer, with `idx % world_size ==
  rank` sharding across hosts;
- LAION: streamed laion2B-en-aesthetic rows downloaded on a thread pool,
  min-side 512 and aspect < 2.0 filters, files named by sha256(url).

They run on CPU hosts with network access; `datasets` and `requests` are
imported only where they are used.
"""
from __future__ import annotations

import base64
import hashlib
import io
import json
import logging
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
from PIL import Image

from ragb_vae_tpu_torch.data.buckets import bucket_assignment, bucket_for_size, format_bucket_key

logger = logging.getLogger(__name__)

LAION_MIN_SIDE = 512
LAION_MAX_AR = 2.0


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------
def decode_image_or_passthrough(val) -> Optional[Image.Image]:
    """PIL.Image or base64 data URI -> RGBA PIL.Image."""
    if val is None or val == "":
        return None
    if isinstance(val, Image.Image):
        return val.convert("RGBA")
    b64_str = val.decode("utf-8") if isinstance(val, bytes) else val
    if b64_str.startswith("data:image"):
        b64_str = b64_str.split(",", 1)[1]
    return Image.open(io.BytesIO(base64.b64decode(b64_str))).convert("RGBA")


def layer_to_full_canvas(layer_val, box, canvas_size) -> Optional[Image.Image]:
    """Paste a cropped layer back onto a transparent full-size canvas."""
    layer_img = decode_image_or_passthrough(layer_val)
    if layer_img is None:
        return None
    x0, y0, x1, y1 = box
    if x1 <= x0 or y1 <= y0:
        return None
    expected = (x1 - x0, y1 - y0)
    if layer_img.size != expected:
        layer_img = layer_img.resize(expected, Image.LANCZOS)
    canvas = Image.new("RGBA", canvas_size, (0, 0, 0, 0))
    canvas.paste(layer_img, (x0, y0), layer_img)
    return canvas


def _save_rgba(img: Image.Image, path: Path, size: Tuple[int, int]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    img.convert("RGBA").resize(size, resample=Image.LANCZOS).save(path)


def _sample_layers(sample: Dict, canvas_size) -> List[Tuple[int, Image.Image]]:
    layers = []
    for i in range(int(sample.get("layer_count") or 0)):
        base_key = f"layer_{i:02}"
        img_key = f"{base_key}_image" if f"{base_key}_image" in sample else base_key
        canvas = layer_to_full_canvas(
            sample.get(img_key), sample.get(f"{base_key}_box", [0, 0, 0, 0]), canvas_size
        )
        if canvas is not None:
            layers.append((i, canvas))
    return layers


def find_nonoverlap(idxs: Iterable[int], masks: Dict[int, np.ndarray]) -> List[int]:
    """Back-to-front greedy non-overlap selection."""
    if not masks:
        return []
    covered = np.zeros_like(next(iter(masks.values())), dtype=bool)
    picks: List[int] = []
    for idx in reversed(list(idxs)):
        m = masks.get(idx)
        if m is None or np.any(m & covered):
            continue
        picks.append(idx)
        covered |= m
    picks.reverse()
    return picks


# ---------------------------------------------------------------------------
# PrismLayersReal
# ---------------------------------------------------------------------------
def process_prism_real_sample(
    sample: Dict, sample_idx: int, output_root: Path, split: str = "train"
) -> Optional[Dict]:
    sample_id = sample.get("id") or sample.get("sample_id") or f"sample_{sample_idx:06d}"
    base_img = decode_image_or_passthrough(sample.get("base_image"))
    whole_img = decode_image_or_passthrough(sample.get("whole_image"))
    if base_img is None or whole_img is None:
        logger.info("[skip] %s: missing base or whole", sample_id)
        return None
    assignment, reason = bucket_assignment(base_img.size)
    if assignment is None:
        logger.info("[skip] %s: %s", sample_id, reason)
        return None
    bucket_name, bucket_dims = assignment
    bucket_dir = output_root / split / bucket_name

    base_path = bucket_dir / f"{sample_id}_base.png"
    whole_path = bucket_dir / f"{sample_id}_whole.png"
    _save_rgba(base_img, base_path, bucket_dims)
    _save_rgba(whole_img, whole_path, bucket_dims)

    layer_paths: List[str] = []
    for i, canvas in _sample_layers(sample, base_img.size):
        layer_path = bucket_dir / f"{sample_id}_layer_{i:02}.png"
        _save_rgba(canvas, layer_path, bucket_dims)
        layer_paths.append(str(layer_path.relative_to(output_root)))

    return {
        "id": sample_id,
        "split": split,
        "bucket": bucket_name,
        "bucket_dims": list(bucket_dims),
        "base_path": str(base_path.relative_to(output_root)),
        "whole_path": str(whole_path.relative_to(output_root)),
        "layer_paths": layer_paths,
        "original_size": list(base_img.size),
    }


# ---------------------------------------------------------------------------
# PrismLayersPro
# ---------------------------------------------------------------------------
def process_prism_pro_sample(
    sample: Dict,
    sample_idx: int,
    output_root: Path,
    split: str,
    rng: np.random.Generator,
) -> Optional[Dict]:
    sample_id = sample.get("id") or sample.get("sample_id") or f"{split}_{sample_idx:06d}"
    file_id = f"{split}_{sample_id}"
    base_img = decode_image_or_passthrough(sample.get("base_image"))
    if base_img is None:
        logger.info("[skip] %s: missing base", sample_id)
        return None
    assignment, reason = bucket_assignment(base_img.size)
    if assignment is None:
        logger.info("[skip] %s: %s", sample_id, reason)
        return None
    bucket_name, bucket_dims = assignment
    # one train bucket path whatever the dataset split
    bucket_dir = output_root / "train" / bucket_name

    layers = _sample_layers(sample, base_img.size)
    masks: Dict[int, np.ndarray] = {}
    alpha_sums: Dict[int, int] = {}
    for i, canvas in layers:
        mask = np.asarray(canvas, dtype=np.uint8)[..., 3] > 0
        if mask.any():
            masks[i] = mask
            alpha_sums[i] = int(mask.sum())

    composite_all = base_img.convert("RGBA")
    for _, canvas in layers:
        composite_all = Image.alpha_composite(composite_all, canvas)

    remaining = [i for i, _ in layers if i in masks]
    non_overlap = find_nonoverlap(remaining, masks)
    fg_non_overlap = Image.new("RGBA", base_img.size, (0, 0, 0, 0))
    for i, canvas in layers:
        if i in non_overlap:
            fg_non_overlap = Image.alpha_composite(fg_non_overlap, canvas)

    rep_idx: Optional[int] = None
    rep_fg: Optional[Image.Image] = None
    if non_overlap:
        weights = np.array([alpha_sums[i] for i in non_overlap], dtype=np.float64)
        if weights.sum() > 0:
            rep_idx = int(rng.choice(non_overlap, p=weights / weights.sum()))
            rep_canvas = next(c for i, c in layers if i == rep_idx)
            rep_fg = Image.alpha_composite(
                Image.new("RGBA", base_img.size, (0, 0, 0, 0)), rep_canvas
            )

    base_path = bucket_dir / f"{file_id}_base.png"
    comp_path = bucket_dir / f"{file_id}_composite.png"
    nonoverlap_path = bucket_dir / f"{file_id}_fg_non_overlap.png"
    _save_rgba(base_img, base_path, bucket_dims)
    _save_rgba(composite_all, comp_path, bucket_dims)
    _save_rgba(fg_non_overlap, nonoverlap_path, bucket_dims)
    rep_path = None
    if rep_fg is not None:
        rep_path = bucket_dir / f"{file_id}_rep.png"
        _save_rgba(rep_fg, rep_path, bucket_dims)

    return {
        "id": sample_id,
        "split": split,
        "bucket": bucket_name,
        "bucket_dims": list(bucket_dims),
        "base_path": str(base_path.relative_to(output_root)),
        "composite_path": str(comp_path.relative_to(output_root)),
        "fg_non_overlap_path": str(nonoverlap_path.relative_to(output_root)),
        "rep_path": str(rep_path.relative_to(output_root)) if rep_path else None,
        "rep_layer_idx": rep_idx,
        "non_overlap_layer_indices": non_overlap,
        "original_size": list(base_img.size),
    }


def shard_indices(total: int, world_size: int, rank: int) -> List[int]:
    """The sample indices of host `rank` of `world_size` (modulo sharding)."""
    if world_size <= 0:
        raise ValueError("world_size must be >= 1")
    if not (0 <= rank < world_size):
        raise ValueError("rank must satisfy 0 <= rank < world_size")
    return [i for i in range(total) if i % world_size == rank]


# ---------------------------------------------------------------------------
# LAION RGB downloader
# ---------------------------------------------------------------------------
def laion_bucket_assignment(size: Tuple[int, int], min_side: int = LAION_MIN_SIDE):
    """LAION's filter: min side 512 and aspect < 2.0, then the usual bucket."""
    w, h = size
    if w <= 0 or h <= 0:
        return None, "invalid_dimensions"
    if min(w, h) < min_side:
        return None, f"too_small(<{min_side})"
    if max(w, h) / max(1, min(w, h)) >= LAION_MAX_AR:
        return None, f"extreme_aspect_ratio(>={LAION_MAX_AR})"
    dims = bucket_for_size(w, h)
    return (format_bucket_key(*dims), dims), None


def safe_image_id(url: str) -> str:
    return hashlib.sha256(url.encode("utf-8")).hexdigest()


def process_laion_row(row: Dict, output_root: Path, min_side: int = LAION_MIN_SIDE) -> Optional[Dict]:
    import requests

    url = row.get("URL") or row.get("url")
    if not url:
        return None
    try:
        resp = requests.get(url, timeout=10.0)
        resp.raise_for_status()
        img = Image.open(io.BytesIO(resp.content)).convert("RGB")
    except Exception:
        return None
    assignment, _ = laion_bucket_assignment(img.size, min_side=min_side)
    if assignment is None:
        return None
    bucket_name, bucket_dims = assignment
    out_path = output_root / "train" / bucket_name / f"{safe_image_id(url)}.png"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    img.resize(bucket_dims, resample=Image.LANCZOS).save(out_path, "PNG")
    return {
        "url": url,
        "id": safe_image_id(url),
        "bucket": bucket_name,
        "bucket_dims": list(bucket_dims),
        "original_size": list(img.size),
        "path": str(out_path.relative_to(output_root)),
    }


def write_manifest(records: List[Dict], manifest_path: Path) -> None:
    manifest_path.parent.mkdir(parents=True, exist_ok=True)
    manifest_path.write_text(json.dumps(records, ensure_ascii=False, indent=2))
