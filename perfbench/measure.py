"""Run cells of the benchmark several times in a row and summarise them: the
tool for sizing bounds and run lengths, not part of a run.

    python3 perfbench/measure.py --workload serve-512-bf16 --seeds 11,12,13 \
        [--seconds 45] [--trace 0] [--out chiprun_out/measure.json]

Each run is the benchmark's own command in a fresh process, one after the
other. Prints each run's result line and, per metric, the median and the
quartile spread (Q3 - Q1 over the median, `statistics.quantiles(n=4)`), and
writes every run's last lines to `--out`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="chiprun_out/measure.json")
    args = p.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or manifest["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for name in args.workload:
        for seed in seeds:
            cmd = manifest["command"] + ["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                                         "--trace", str(args.trace)]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.time() - t0
            lines = proc.stdout.strip().splitlines()
            result = None
            if proc.returncode == 0 and lines:
                result = json.loads(lines[-1])
            runs.append({"workload": name, "seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result,
                         "stderr_tail": proc.stderr[-3000:]})
            print(f"[measure] {name} seed {seed}: rc {proc.returncode}, {wall:.1f} s", flush=True)
            print(proc.stderr[-1500:] if proc.returncode else "\n".join(
                l for l in proc.stderr.splitlines() if l.startswith(("[check]", "[perfbench]"))), flush=True)
            print(json.dumps(result), flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    for name in args.workload:
        done = [r["result"] for r in runs if r["workload"] == name and r["result"]]
        keys = sorted({k for r in done for k in r["metrics"]})
        for k in keys:
            vals = [r["metrics"][k]["value"] for r in done if k in r["metrics"]]
            spread = harness.quartile_spread(vals) if len(vals) >= 2 else float("nan")
            print(f"[measure] {name} {k}: median {statistics.median(vals)!r} spread {spread!r} over {len(vals)}: "
                  f"{vals}", flush=True)
        checks = sorted({k for r in done for k in r["checks"]})
        for k in checks:
            vals = [r["checks"][k]["value"] for r in done]
            print(f"[measure] {name} check {k}: max {max(vals)!r} of {vals}", flush=True)
        print(f"[measure] {name}: correct {[r['correct'] for r in done]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
