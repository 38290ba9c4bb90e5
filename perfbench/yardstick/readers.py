"""Arithmetic the per-layer metric readers share: idle share, model FLOPs
utilisation and roofline share from a run's trace and counters. Each returns
None where the run has nothing to read (no trace, no card peak, no kernel of
the class in the trace)."""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

from perfbench.yardstick import work


def device_idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def model_flops_util(run, flops_per_item, items, *, per_card: int = 1) -> Optional[float]:
    """100 x flops_per_item x items / traced window / peak (of `per_card` cards)."""
    peak = work.peak_flops(run.device_kind)
    if run.trace is None or not flops_per_item or not items or peak is None:
        return None
    return 100.0 * flops_per_item * items / run.trace.window_s / (peak * per_card)


def roofline_pct(run, jobs: Iterable[Tuple[float, Tuple[float, float]]], classes: Sequence[str]) -> Optional[float]:
    """100 x the least time of `jobs` ((count, (ops, bytes)) each) over the
    traced device time of the kernel `classes`."""
    if run.trace is None:
        return None
    spent = sum(t for label, t in work.class_seconds(run.trace.kernels).items() if label in classes)
    least = 0.0
    for count, (ops, nbytes) in jobs:
        t = work.least_time(ops, nbytes, run.device_kind)
        if t is None:
            return None
        least += count * t
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent

