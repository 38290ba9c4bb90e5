"""Read the two ends that each correctness limit is set between.

    python3 perfbench/control.py --workload serve-512-bf16 --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--seconds 11] [--out chiprun_out/control.json]

For every seed, one short run of the cell (its own sizes and load; the
window only as long as `control_seconds` in the traffic file, to finish a
batch or the followed steps) gives the program's readings: the lower end.
For each control seed, the same cell's numbers for the control, each in
the program's place against the same fp32 reference:
- the reference computed in float8 e4m3 (the precision below the bf16
  that the configurations state), every cell;
- the training faults: the loss over half of each batch (the reference
  with the fault planted); a step that leaves the state unchanged reads 1
  by construction.
Beside each variant's numbers stands its verdict under the cell's limits
(`<variant>_correct`: every number at most its limit, as a run decides
`correct`). Everything runs in this one process, one seed after another,
and is printed and written to `--out`. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def _checks(checks):
    return {c.name: c.value for c in checks}


def _verdict(out: dict, label: str, checks) -> None:
    """The variant's numbers and whether the cell's limits pass it."""
    out[label] = _checks(checks)
    out[label + "_correct"] = bool(checks) and all(c.ok for c in checks)


def control_readings(kind: str, record: harness.RunRecord, seed: int, device) -> dict:
    """The control's and the faults' readings on one seed, from a program
    run `record` of the same seed (which kept its reference)."""
    import torch

    from perfbench.drivers import _train
    from perfbench.reference.numerics import Numerics

    cfg, traffic = record.config, record.traffic
    out = {}
    d = harness.driver(kind)
    if kind == "serve":
        c = record.counters
        fp8 = d.reference_images(cfg, traffic, seed, device, c["checked"], c["images"], "fp8")
        _verdict(out, "fp8_reference", d.compare_images(fp8, c["reference_images"], traffic["limits"]))
    else:
        ref, first, names = record.counters["reference"], record.counters["followed"], record.counters["names"]
        for label, num, half in (("fp8_reference", Numerics("fp8"), False), ("half_batch", Numerics("fp32"), True)):
            if kind == "vae_train":
                got = d.follow(cfg, seed, device, first, names, num, traffic["reference_chunk"], half_batch=half)
            else:
                got = d.follow(cfg, traffic, seed, device, first, names, num, half_batch=half)
            notes = []
            _verdict(out, label, _train.compare(got, ref, traffic["limits"], traffic["loss_steps"], notes))
            out[label + "_notes"] = notes
            out[label + "_loss_gap_a_step"] = _train.loss_gaps(got, ref)
            del got
            harness.free_device_memory(device)
    torch.cuda.empty_cache()
    return out


def _record(cell, cfg, traffic, seconds) -> harness.RunRecord:
    rec = harness.RunRecord(cell=cell, config=cfg, traffic=traffic, seconds=seconds, trace_on=False)
    rec.counters["process_start"] = time.time()
    return rec


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float)
    p.add_argument("--out", default="chiprun_out/control.json")
    args = p.parse_args(argv)
    manifest = harness.load_manifest()
    cell = harness.cell_of(manifest, args.workload)
    cfg, traffic = harness.config_of(manifest, cell), harness.traffic_of(cell)
    kind = traffic["driver"]
    seconds = args.seconds or traffic["control_seconds"]
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        rec = _record(cell, cfg, traffic, seconds)
        harness.driver(kind).run(rec, seed=seed, device=device)
        row = {"seed": seed, "program": _checks(rec.checks), "program_correct": rec.correct, "notes": rec.notes}
        if seed in controls:
            row.update(control_readings(kind, rec, seed, device))
        del rec
        harness.free_device_memory(device)
        row["seconds"] = time.time() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    for name in rows[0]["program"]:
        low = max(r["program"][name] for r in rows)
        line = f"[control] {args.workload} {name}: lower {low!r} over {len(rows)} seeds"
        for variant in ("fp8_reference", "half_batch"):
            vals = [r[variant][name] for r in rows if variant in r and name in r[variant]]
            if vals:
                line += f"; {variant} min {min(vals)!r} of {vals}"
        print(line, flush=True)
    for variant in ("program", "fp8_reference", "half_batch"):
        verdicts = [r[variant + "_correct"] for r in rows if variant + "_correct" in r]
        if verdicts:
            print(f"[control] {args.workload} {variant}: correct {verdicts}", flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
