"""What the training drivers share: the window over whole synchronised
steps, the snapshot of the first steps that the reference follows, and the
comparison of the program's first steps with the reference's.

The numbers compared (each a worst case; the reference's are the base):
- `loss_gap`: over the first `loss_steps` followed steps (none where the
  traffic file sets 0), |loss - ref| / |ref|;
- `grad_gap`: over the leaves, the gap between the norms of the first
  step's clipped gradient as the optimizer got it (AdamW's first moment
  after one step over 1 - beta1) and the reference's, over the larger of the
  reference leaf's norm and the median leaf's;
- `change_gap`: the same for each leaf's change over the followed steps,
  leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
- `grad_gap_rescaled`: the median leaf's `grad_gap` once one common scale
  (the median leaf's ratio of the two norms) is taken out of the program's
  norms. The global-norm clip turns one leaf's gap into a shift of every
  clipped leaf by one factor, which varies from seed to seed; what stays is
  how the gradient's norm is spread over the leaves.
A cell compares those of these that its traffic file gives a limit.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from perfbench import harness


def optimizer_first_moments(optimizer) -> List[torch.Tensor]:
    """AdamW's exp_avg of each parameter, in parameter order."""
    state = optimizer.state_dict()["state"]
    return [state[i]["exp_avg"] for i in sorted(state)]


class FirstSteps:
    """The program's readings over the steps the reference follows."""

    def __init__(self, names: List[str], params: List[torch.Tensor], beta1: float):
        self.names, self.params, self.beta1 = names, params, beta1
        self.start = [p.detach().clone() for p in params]
        self.sizes = [p.numel() for p in params]
        self.losses: List[float] = []
        self.grad_norms: List[float] = []
        self.change_norms: List[float] = []
        self.batches: List[Dict[str, torch.Tensor]] = []

    def after_step(self, loss: float, optimizer) -> None:
        self.losses.append(loss)
        if len(self.losses) == 1:
            self.grad_norms = [float(torch.linalg.vector_norm(m.float())) / (1.0 - self.beta1)
                               for m in optimizer_first_moments(optimizer)]

    def finish(self) -> None:
        self.change_norms = [float(torch.linalg.vector_norm(p.detach().float() - s.float()))
                             for p, s in zip(self.params, self.start)]
        self.start = []


def leaf_gaps(prog: List[float], ref: List[float], keep: Optional[List[bool]] = None) -> List[tuple]:
    """(gap, leaf index) of each kept leaf: the gap of the two norms over the
    larger of the reference's norm and the median leaf's."""
    base = statistics.median(ref)
    return [(abs(p - r) / max(abs(r), base, 1e-30), i) for i, (p, r) in enumerate(zip(prog, ref))
            if keep is None or keep[i]]


def loss_gaps(prog: FirstSteps, ref: FirstSteps) -> List[float]:
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog.losses, ref.losses)]


def rescaled_gaps(prog: List[float], ref: List[float]) -> List[tuple]:
    """`leaf_gaps` after the program's norms are divided by the median
    leaf's ratio of the two (a leaf under a thousandth of the median
    reference norm sets no ratio; with no positive ratio nothing is divided)."""
    base = statistics.median(ref)
    ratios = [p / r for p, r in zip(prog, ref) if r >= 1e-3 * base and r > 0]
    scale = statistics.median(ratios) if ratios else 1.0
    return leaf_gaps([p / scale for p in prog] if scale > 0 else prog, ref)


def compare(prog: FirstSteps, ref: FirstSteps, limits: dict, loss_steps: int,
            notes: Optional[List[str]] = None) -> List[harness.Check]:
    """The numbers that `limits` names, each beside its limit; `notes` gets
    the worst leaf of each kind."""
    med = statistics.median(ref.grad_norms)
    keep = [g >= 1e-3 * med for g in ref.grad_norms]
    values = {}
    for kind, gaps in (("grad", leaf_gaps(prog.grad_norms, ref.grad_norms)),
                       ("change", leaf_gaps(prog.change_norms, ref.change_norms, keep))):
        worst, i = max(gaps)
        values[f"{kind}_gap"] = worst
        if notes is not None:
            notes.append(f"{kind}_gap worst leaf {prog.names[i]} ({prog.sizes[i]} entries): {worst!r}; "
                         f"median leaf {statistics.median(g for g, _ in gaps)!r}")
    values["grad_gap_rescaled"] = statistics.median(g for g, _ in rescaled_gaps(prog.grad_norms, ref.grad_norms))
    checks = [harness.Check("loss_gap", max(loss_gaps(prog, ref)[:loss_steps]), limits["loss_gap"])] if loss_steps else []
    return checks + [harness.Check(name, value, limits[name]) for name, value in values.items() if name in limits]


def clip_(grads: List[torch.Tensor], max_norm: Optional[float]) -> float:
    norm = math.sqrt(sum(float(torch.sum(g.float() * g.float())) for g in grads))
    if max_norm is not None:
        scale = max_norm / max(norm, max_norm)
        for g in grads:
            g.mul_(scale)
    return norm


def window(record: harness.RunRecord, batches: Iterator, step: Callable, device, *, items_per_step: int,
           tracer: Optional["harness.Tracer"], trace_first: int, trace_steps: int) -> Dict[str, float]:
    """Whole steps until `record.seconds` have passed on the host clock, then
    a synchronise: (steps, items, seconds, loader wait in ms a step). With a
    tracer, steps [trace_first, trace_first + trace_steps) of the window are
    traced, synchronised at both ends."""
    harness.synchronize(device)
    t0 = time.perf_counter()
    record.setup_s = time.time() - record.counters["process_start"]
    n, wait = 0, 0.0
    while True:
        if tracer is not None and n == trace_first:
            tracer.start()
        t_wait = time.perf_counter()
        batch = next(batches)
        wait += time.perf_counter() - t_wait
        step(batch)
        n += 1
        if tracer is not None and n == trace_first + trace_steps:
            tracer.stop()
        if time.perf_counter() - t0 >= record.seconds and (tracer is None or n >= trace_first + trace_steps):
            break
    harness.synchronize(device)
    seconds = time.perf_counter() - t0
    return {"steps": n, "items": n * items_per_step, "seconds": seconds, "loader_wait_ms": 1000.0 * wait / n}
