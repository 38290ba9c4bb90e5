"""The benchmark's general parts: the manifest and the files it names, the
run record every driver fills, the device trace and its reduction, the
check that no JAX module was loaded, and the result line.

A cell is found by name: `BENCHMARK.json` names its configuration (a file
under `perfbench/configs/`) and its traffic (a file under
`perfbench/workloads/`, which names a driver under `perfbench/drivers/`);
each per-layer metric is a reader under `perfbench/metrics/<name>.py`. A
later cell, configuration or metric is a new file and a new entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

# top-level module names that may not be loaded in a run (compared whole:
# `ragb_vae_tpu_torch` is not `ragb_vae_tpu`)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "ragb_vae_tpu")


class BenchmarkError(RuntimeError):
    """A run that cannot give a result: the harness exits non-zero and prints none."""


# ---------------------------------------------------------------------------
# The manifest and the files it names
# ---------------------------------------------------------------------------
def load_manifest(path: Path = MANIFEST) -> dict:
    if not path.exists():
        raise BenchmarkError(f"{path} is missing")
    return json.loads(path.read_text())


def cell_of(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json")


def config_of(manifest: dict, cell: dict) -> dict:
    for cfg in manifest["configs"]:
        if cfg["name"] == cell["config"]:
            return json.loads((ROOT / cfg["file"]).read_text())
    raise BenchmarkError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell: dict) -> dict:
    path = HERE / "workloads" / f"{cell['traffic']}.json"
    if not path.exists():
        raise BenchmarkError(f"no traffic file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def metrics_for(manifest: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace on)."""
    if not trace:
        return [m for m in manifest["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    reported = {m["name"] for m in metrics_for(manifest, cell, False)}
    return [m for m in manifest["per_layer"]
            if m["moves"] in reported and cell["name"] in m.get("workloads", [cell["name"]])]


def load_file_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchmarkError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable[["RunRecord"], Optional[float]]:
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise BenchmarkError(f"no reader {path.relative_to(ROOT)} for metric {name!r}")
    return load_file_module(path, f"perfbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}").read


def driver(kind: str) -> ModuleType:
    path = HERE / "drivers" / f"{kind}.py"
    if not path.exists():
        raise BenchmarkError(f"no driver {path.relative_to(ROOT)}")
    return load_file_module(path, f"perfbench_driver_{kind}")


# ---------------------------------------------------------------------------
# What a run measured
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Check:
    """One number the correctness comparison reads, beside its limit (the
    run is correct when every value is at most its limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class RunRecord:
    """Filled by a driver; read by the metric readers and the result line."""
    cell: dict
    config: dict
    traffic: dict
    seconds: float
    trace_on: bool
    setup_s: float = float("nan")
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    device_kind: str = ""
    device_count: int = 1
    trace: Optional["Trace"] = None
    # the driver's own readings for the per-layer readers (counts, host spans, shapes)
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------
WINDOW_SPAN = "perfbench.traced_window"


@dataclasses.dataclass
class Trace:
    """Kernels and host ops of a traced stretch, in seconds from its start.
    `window_s` is the stretch's length on the host clock (its span in the
    trace); kernels are clipped to it."""
    window_s: float
    kernels: List[Tuple[str, float, float]]        # (name, start, duration)
    host_ops: List[Tuple[str, float, float]]       # (name, start, duration), outermost first

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(s, s + d) for _, s, d in self.kernels]))

    def device_ops(self, top: int = 10) -> List[List[Any]]:
        totals: Dict[str, float] = {}
        for n, _, d in self.kernels:
            key = n if len(n) <= 120 else n[:117] + "..."
            totals[key] = totals.get(key, 0.0) + d
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List[Any]]:
        """The longest stretches with no kernel running, each named by what
        the host was doing at its middle (the innermost host op there, on
        any thread, or "host idle")."""
        gaps, cursor = [], 0.0
        for s, e in merged([(s, s + d) for _, s, d in self.kernels]):
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.window_s:
            gaps.append((cursor, self.window_s))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid, name = 0.5 * (a + b), "host idle"
            for n, s, d in self.host_ops:
                if s > mid:
                    break
                if mid <= s + d:
                    name = n     # a later start inside the gap is a deeper op
            out.append([name, b - a])
        return out


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def trace_from_chrome(events: Sequence[dict]) -> Trace:
    """The traced window (the `WINDOW_SPAN` host span) with its kernels and
    host ops, from a Chrome trace's events (microseconds)."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"]
    if not spans:
        raise BenchmarkError("the trace holds no traced-window span")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    kernels, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, d = float(e["ts"]), float(e["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                kernels.append((str(e.get("name", "")), (a - t0) / 1e6, (b - a) / 1e6))
        elif cat in ("cpu_op", "user_annotation", "python_function") and e.get("name") != WINDOW_SPAN:
            if s + d > t0 and s < t1:
                host.append((str(e.get("name", "")), (s - t0) / 1e6, d / 1e6))
    host.sort(key=lambda h: (h[1], -h[2]))
    return Trace(window_s=(t1 - t0) / 1e6, kernels=kernels, host_ops=host)


class Tracer:
    """torch.profiler over a stretch the driver chooses: `start()` and
    `stop()` may be called from any one thread; the trace goes to a file
    under TMPDIR and is read back and deleted at `stop()`."""

    def __init__(self, device):
        self.device = device
        self.trace: Optional[Trace] = None
        self._prof = None
        self._span = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        """End the traced stretch (the device synchronised first)."""
        synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._span = None

    @property
    def running(self) -> bool:
        return self._span is not None

    def collect(self) -> Trace:
        """Read the stopped profile into a `Trace` (after the window: the
        export and its parse take seconds)."""
        import tempfile

        fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.trace = trace_from_chrome(events)
        if not self.trace.kernels:
            raise BenchmarkError("the profiler recorded no device kernels in the traced window")
        return self.trace


# ---------------------------------------------------------------------------
# Statistics and the JAX check
# ---------------------------------------------------------------------------
def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, by `statistics.quantiles(n=4)`."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# The result line
# ---------------------------------------------------------------------------
def result_line(record: RunRecord, metrics: Sequence[dict]) -> dict:
    """The last line of standard output. Per-layer metrics whose reader found
    nothing are left out; the checks come last."""
    out: Dict[str, Any] = {"correct": record.correct, "attempted": record.attempted, "failed": record.failed}
    values: Dict[str, Any] = {}
    for m in metrics:
        if m["name"] in record.e2e:
            value = record.e2e[m["name"]]
        elif record.trace_on:
            value = metric_reader(m["name"])(record)
        else:
            value = None
        if value is not None and math.isfinite(value):
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = values
    device = {"platform": "gpu", "kind": record.device_kind, "count": record.device_count,
              "memory_peak_bytes": record.memory_peak_bytes}
    if record.trace is not None:
        device["busy_s"] = record.trace.busy_s()
        device["window_s"] = record.trace.window_s
        out["breakdown"] = {"device_ops": record.trace.device_ops(), "idle_gaps": record.trace.idle_gaps()}
    out["device"] = device
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in record.checks}
    return out


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_facts(device) -> Tuple[str, int]:
    """(the device's name, its peak of allocated bytes so far)."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu", 0
    return torch.cuda.get_device_name(device), torch.cuda.max_memory_allocated(device)


def free_device_memory(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def process_start_time() -> float:
    """The wall-clock time this process started, from /proc (Linux)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
