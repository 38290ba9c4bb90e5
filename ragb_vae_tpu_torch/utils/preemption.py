"""Graceful preemption: SIGTERM -> checkpoint -> clean exit.

Counterpart of `ragb_vae_tpu/utils/preemption.py`. The loop polls
`should_stop(sync=True)` once per step; when a signal has landed on any
process, every process leaves at that step, writes its part of a complete
checkpoint, and `resume_from: auto` continues from there.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Optional

import torch
import torch.distributed as dist

_DEFAULT_SIGNALS = (signal.SIGTERM,)


class PreemptionGuard:
    """Installs the signal handlers on entry and restores the previous ones
    on exit. Off the main thread it installs nothing and only
    `request_stop()` stops it."""

    def __init__(self, signals=_DEFAULT_SIGNALS, enabled: bool = True):
        self._signals = tuple(signals)
        self._enabled = bool(enabled) and bool(self._signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._received: Optional[int] = None

    def __enter__(self) -> "PreemptionGuard":
        if self._enabled and threading.current_thread() is threading.main_thread():
            self._prev = {sig: signal.signal(sig, self._on_signal) for sig in self._signals}
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def _on_signal(self, signum, frame) -> None:
        # signal context: set the flag, never checkpoint here
        self._received = signum
        self._event.set()

    def request_stop(self) -> None:
        self._event.set()

    @property
    def stop_requested(self) -> bool:
        """The local flag only: no collective, safe from any thread."""
        return self._event.is_set()

    def should_stop(self, sync: bool = False) -> bool:
        """Poll the flag; with `sync=True` OR it over the processes of the
        default group (one all-reduce MAX of a scalar; nothing at one
        process or without a group), so processes signalled unevenly still
        stop at the same step. The agreed flag is then set locally."""
        local = self._event.is_set()
        if not sync or not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return local
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(local)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed:
            self._event.set()
        return agreed

    def describe(self) -> str:
        if self._received is None:
            return "stop requested"
        try:
            return f"signal {signal.Signals(self._received).name}"
        except ValueError:
            return f"signal {self._received}"


def preemption_enabled(train_cfg) -> bool:
    """`training.handle_preemption` (default on); RAGB_NO_PREEMPTION=1 turns
    it off (an outer harness that owns SIGTERM)."""
    if os.environ.get("RAGB_NO_PREEMPTION") == "1":
        return False
    get = getattr(train_cfg, "get", None)
    return True if get is None else bool(get("handle_preemption", True))
