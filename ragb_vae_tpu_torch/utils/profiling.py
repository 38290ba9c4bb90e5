"""Tracing hooks over `torch.profiler`.

Counterpart of `ragb_vae_tpu/utils/profiling.py`:

    with trace_context("outputs/trace", enabled=cfg.get("profile")):
        for step ...:
            with annotate("train_step", step=step):
                train_step(...)

`trace_context` records the host and, where there is one, the card, and
writes a Chrome / Perfetto trace into the directory; `RAGB_PROFILE_DIR`
turns it on for that directory. `annotate` names a region of the trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: Optional[str], *, enabled: bool = True) -> Iterator[None]:
    target = os.environ.get("RAGB_PROFILE_DIR") or (log_dir if enabled else None)
    if not target:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    Path(target).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(target) / f"trace_{os.getpid()}_{int(time.time())}.json"))


@contextlib.contextmanager
def annotate(name: str, **kwargs) -> Iterator[None]:
    """A named region; `step=N` is appended to the name."""
    label = f"{name}#{kwargs['step']}" if "step" in kwargs else name
    with torch.profiler.record_function(label):
        yield
