"""Tracing hooks over `torch.profiler`, and the port's counters.

Counterpart of `ragb_vae_tpu/utils/profiling.py`:

    with trace_context("outputs/trace", enabled=cfg.get("profile")):
        for step ...:
            with annotate("train_step", step=step):
                train_step(...)

`trace_context` records the host (every thread, where the torch has the
option) and, where there is one, the card, and writes a Chrome / Perfetto
trace into the directory; `RAGB_PROFILE_DIR` turns it on for that directory.

Spans. `annotate(name, **ids)` names a region of the trace: a
`user_annotation` on the profiler's clock, beside the kernels, labelled
`name#id#...` (the text before the first `#` is the span's kind). It enters
`torch.profiler.record_function` only while a profiler runs; otherwise it
costs one read of the profiler's flag. A span opened before the profiler
starts or closed after it stops records nothing and raises nothing. No span
stays open across a `yield`, and none synchronises the device or reads a
tensor.

Counters. A `Counter` holds a count, a total and a maximum of one quantity
(seconds, unless its name says otherwise) and is owned by its layer: the
batcher, the daemon's handler, the feed. Creating one registers it by name
in place of the older owner of that name; `counters()` is a snapshot of
the registry, which holds the counters and nothing they were counted for.
`request_scope()` gives a request an identifier that `InferenceServer.submit`
takes over, so the daemon's spans and the batcher's name the same request.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace_context(log_dir: Optional[str], *, enabled: bool = True) -> Iterator[None]:
    target = os.environ.get("RAGB_PROFILE_DIR") or (log_dir if enabled else None)
    if not target:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, experimental_config=_all_threads()) as prof:
        yield
    Path(target).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(target) / f"trace_{os.getpid()}_{int(time.time())}.json"))


def _all_threads():
    """A profiler setting that records every thread's ops and spans (the
    default records the thread that started it), or None where the torch
    has no such option."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def profiler_running() -> bool:
        """Whether a torch profiler is recording (a module flag the profiler sets)."""
        return _autograd_profiler._is_profiler_enabled
else:  # a torch without the Python flag
    profiler_running = torch._C._autograd._profiler_enabled


class Span:
    """The context manager `annotate` returns."""

    __slots__ = ("name", "ids", "_record")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids, self._record = name, ids, None

    def __enter__(self) -> "Span":
        if profiler_running():
            label = "#".join([self.name, *map(str, self.ids.values())])
            self._record = torch.profiler.record_function(label)
            self._record.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._record is not None:
            record, self._record = self._record, None
            record.__exit__(*exc)


def annotate(name: str, **ids) -> Span:
    """A named region: `annotate("serve.step", step=3)` is `serve.step#3`."""
    return Span(name, ids)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, "Counter"] = {}


class Counter:
    """Count, total and maximum of one quantity, safe to add to from any thread."""

    __slots__ = ("name", "count", "total", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count, self.total, self.max = 0, 0.0, 0.0
        self._lock = threading.Lock()
        _REGISTRY[name] = self

    def add(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            if value > self.max:
                self.max = value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self.count, "total": self.total, "max": self.max}


def counters() -> Dict[str, Dict[str, float]]:
    """{name: {"count", "total", "max"}} of the newest counter of each name."""
    return {name: c.snapshot() for name, c in sorted(_REGISTRY.items())}


_request_ids = itertools.count(1)
_current_request: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar("ragb_request", default=None)


@contextlib.contextmanager
def request_scope() -> Iterator[int]:
    """A new request identifier, current in this context until the block ends."""
    rid = next(_request_ids)
    token = _current_request.set(rid)
    try:
        yield rid
    finally:
        _current_request.reset(token)


def request_id() -> int:
    """The current `request_scope`'s identifier, or a new one outside any."""
    rid = _current_request.get()
    return next(_request_ids) if rid is None else rid
