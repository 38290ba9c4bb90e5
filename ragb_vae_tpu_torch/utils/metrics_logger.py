"""Step-metric sink: one JSON object per logging step in `<dir>/metrics.jsonl`.

Counterpart of `ragb_vae_tpu/utils/metrics_logger.py`.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union


class MetricsLogger:
    """`log_dir=None` logs nothing."""

    def __init__(self, log_dir: Optional[Union[str, Path]], *, filename: str = "metrics.jsonl"):
        self.path: Optional[Path] = None
        if log_dir:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(log_dir) / filename
        self._t0 = time.time()

    def log(self, metrics: Dict[str, Any], *, step: int) -> None:
        if self.path is None:
            return
        record = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for key, value in metrics.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = value
        with self.path.open("a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
