"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic (which names its driver) and its
metrics are read from `BENCHMARK.json` and the files it names. With
`--trace 0` the last line of standard output is the cell's end-to-end
metrics; with `--trace 1` its per-layer metrics and the device trace's
breakdown. Every run checks what its timed path produced against the plain
reference and prints each compared number beside its limit, last, on
standard error and in the result line. The run fails (non-zero, no result)
without the CUDA devices the cell asks for, or when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the kernels and every cache the program or the harness keeps live inside
# the checkout, at fixed paths, so a second run of a cell finds them built
os.environ.setdefault("USE_FLAX", "0")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "inductor")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "perfbench" / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv=None) -> int:
    args = parse_args(argv)
    started = harness.process_start_time()
    manifest = harness.load_manifest()
    cell = harness.cell_of(manifest, args.workload)
    config = harness.config_of(manifest, cell)
    traffic = harness.traffic_of(cell)
    metrics = harness.metrics_for(manifest, cell, bool(args.trace))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        raise harness.BenchmarkError(
            f"the cell asks for {cell['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    record = harness.RunRecord(cell=cell, config=config, traffic=traffic, seconds=args.seconds,
                               trace_on=bool(args.trace))
    record.counters["process_start"] = started
    harness.driver(traffic["driver"]).run(record, seed=args.seed, device=torch.device("cuda", 0))
    record.e2e["setup_s"] = record.setup_s

    found = harness.forbidden_loaded()
    if found:
        raise harness.BenchmarkError(f"modules of JAX or of the JAX package were loaded: {', '.join(found)}")
    line = harness.result_line(record, metrics)
    for note in record.notes:
        print(f"[perfbench] {note}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main() -> None:
    t0 = time.time()
    try:
        code = run()
    except harness.BenchmarkError as exc:
        print(f"[perfbench] no result: {exc}", file=sys.stderr)
        code = 2
    except Exception:     # any other failure: no result line, the traceback on stderr
        traceback.print_exc()
        print("[perfbench] no result: the run failed", file=sys.stderr)
        code = 3
    print(f"[perfbench] {time.time() - t0:.1f} s in run.py", file=sys.stderr)
    sys.exit(code)


if __name__ == "__main__":
    main()
