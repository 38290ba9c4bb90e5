"""Resolution-bucket keys (`w{W}-h{H}`).

The port's copy of the bucket-key pattern and parser of
`ragb_vae_tpu/ops/buckets.py` (the port imports nothing of the JAX package).
"""
from __future__ import annotations

import re
from typing import Tuple

BUCKET_RE = re.compile(r"^w(?P<w>\d+)-h(?P<h>\d+)$")


def format_bucket_key(width: int, height: int) -> str:
    return f"w{width}-h{height}"


def parse_bucket_dims(bucket: str) -> Tuple[int, int]:
    """'w1024-h768' -> (1024, 768); raises ValueError on a malformed key."""
    m = BUCKET_RE.match(bucket)
    if not m:
        raise ValueError(f"Invalid bucket format: {bucket}")
    return int(m.group("w")), int(m.group("h"))
