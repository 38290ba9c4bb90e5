"""Resolution buckets: the bucket rules of the offline preparation and the
bucket keys (`w{W}-h{H}`).

The port's copy of `ragb_vae_tpu/ops/buckets.py` (the port imports nothing of
the JAX package). Host-side Python: the preparation and the samplers call it
when they build manifests, so the buckets are the JAX package's exactly.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Tuple

# the bucket envelope: a resized sample holds at most ~1.08 MPx
MAX_SIDE = 1408
MAX_PIXELS = 1408 * 768
MULTIPLE = 64
MIN_BUCKET_SIDE = MULTIPLE
FILTER_MIN_SIDE = 384
FILTER_MAX_AR = 2.3
BACKGROUND_VISIBILITY_THRESHOLD = 0.01

BUCKET_RE = re.compile(r"^w(?P<w>\d+)-h(?P<h>\d+)$")


def round_to_multiple(value: float, multiple: int = MULTIPLE) -> int:
    """Round to the nearest multiple, floored at `multiple` itself."""
    return max(multiple, int(round(value / multiple)) * multiple)


def should_exclude_size(width: int, height: int) -> Optional[str]:
    """A rejection reason for an undersized or extreme-aspect image, else None."""
    smaller = min(width, height)
    larger = max(width, height)
    if smaller < FILTER_MIN_SIDE:
        return "too_small"
    if larger / max(1, smaller) >= FILTER_MAX_AR:
        return "extreme_aspect_ratio"
    return None


def bucket_for_size(width: int, height: int) -> Tuple[int, int]:
    """An image size's bucket (w, h): scaled down until max(side) <= MAX_SIDE
    and w*h <= MAX_PIXELS, then each side rounded to the nearest multiple of
    64 (at least 64)."""
    scale_side = min(MAX_SIDE / width, MAX_SIDE / height, 1.0)
    scale_pixels = min(math.sqrt(MAX_PIXELS / float(width * height)), 1.0)
    scale = min(scale_side, scale_pixels)
    sw, sh = width * scale, height * scale
    bucket_w = max(round_to_multiple(sw), MIN_BUCKET_SIDE)
    bucket_h = max(round_to_multiple(sh), MIN_BUCKET_SIDE)
    return int(bucket_w), int(bucket_h)


def bucket_assignment(
    size: Tuple[int, int],
) -> Tuple[Optional[Tuple[str, Tuple[int, int]]], Optional[str]]:
    """((bucket_key, (w, h)), None) for a kept size, (None, reason) for a rejected one."""
    w, h = size
    if w <= 0 or h <= 0:
        return None, "invalid_dimensions"
    reason = should_exclude_size(w, h)
    if reason:
        return None, reason
    bucket_dims = bucket_for_size(w, h)
    return (format_bucket_key(*bucket_dims), bucket_dims), None


def format_bucket_key(width: int, height: int) -> str:
    return f"w{width}-h{height}"


def parse_bucket_dims(bucket: str) -> Tuple[int, int]:
    """'w1024-h768' -> (1024, 768); raises ValueError on a malformed key."""
    m = BUCKET_RE.match(bucket)
    if not m:
        raise ValueError(f"Invalid bucket format: {bucket}")
    return int(m.group("w")), int(m.group("h"))
