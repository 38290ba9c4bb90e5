"""Show that `chip_smoke.py`'s bounds on the backward kernels (K4-K7) and on
the int8 matmul and the downsample conv (K10, K9) bite.

    python3 scripts/planted_faults_bwd.py

For each fault below, the package and `chip_smoke.py` are copied into a
temporary directory, one line of a CUDA source in the COPY is replaced, and
`python3 chip_smoke.py --phases kernels` runs there (it rebuilds the kernels
from the copy). A fault counts as caught when that run exits non-zero with a
FAIL on a line of the kernel the fault was planted in. The tree itself is
never touched. Exits 0 only when every fault was caught; needs an NVIDIA GPU
and nvcc.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BACKWARD_KERNELS = ("_bwd", "flash_attention_dq", "flash_attention_dkv")

# (label, source file, the line to replace, its replacement, the kernels whose lines must FAIL)
FAULTS = [
    ("one weight-gradient partial left out of the reduce", "resnet_block_bwd.cu",
     "return launch_reduce_rows(p.partial, dw, p.S,",
     "return launch_reduce_rows(p.partial, dw, p.S > 1 ? p.S - 1 : p.S,", BACKWARD_KERNELS),
    ("top halo row missing from the data-gradient conv's slab", "conv_taps.cuh",
     "if (hh >= 0 && hh < Hin && ww >= 0 && ww < Win && ch < C) {",
     "if (hh >= 0 && hh < Hin && ww >= 0 && ww < Win && ch < C && !(EPI == EPI_BWD_ACT && r == 0)) {",
     BACKWARD_KERNELS),
    ("statistics cotangent's sum-of-squares term left out of dye", "resnet_block_bwd.cu",
     "ds1[j] = 2.0f * ds[", "ds1[j] = 0.0f * ds[", BACKWARD_KERNELS),
    ("key-tail mask left out of the dQ kernel", "flash_attention_bwd.cu",
     "const bool valid = k0 + (c * 2 + h) * 8 + t * 2 + e < Sk;", "const bool valid = true;", BACKWARD_KERNELS),
    ("last query tile left out of the dK/dV kernel's loop", "flash_attention_bwd.cu",
     "const int n_tiles = (Sq + BQ - 1) / BQ;", "const int n_tiles = (Sq + BQ - 1) / BQ - 1;", BACKWARD_KERNELS),
    ("int8 matmul: last K tile left out of the loop", "int8_matmul.cu",
     "const int nk = (K + BK - 1) / BK;", "const int nk = (K + BK - 1) / BK - 1;", ("int8_matmul",)),
    ("int8 matmul: scale left out of the last N tile", "int8_matmul.cu",
     "const float s0 = scale[n], s1 = scale[n + 1];",
     "const bool last = n0 + BN >= N; const float s0 = last ? 1.0f : scale[n], s1 = last ? 1.0f : scale[n + 1];",
     ("int8_matmul",)),
    ("downsample conv: the padded bottom row read from the image instead of zero", "conv_taps.cuh",
     "const int hh = PS * h0 - G::LO + r, ww = PS * w0 - G::LO + c;",
     "const int hh0 = PS * h0 - G::LO + r, ww = PS * w0 - G::LO + c; "
     "const int hh = (MODE == MODE_DOWN3 && hh0 == Hin) ? Hin - 1 : hh0;", ("downsample_conv3x3_stats",)),
]


def run_fault(label: str, source: str, old: str, new: str, kernels) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        shutil.copytree(ROOT / "ragb_vae_tpu_torch", work / "ragb_vae_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", work / "chip_smoke.py")
        path = work / "ragb_vae_tpu_torch" / "csrc" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"[fault] {label}: the line to replace occurs {text.count(old)} times in {source}")
        path.write_text(text.replace(old, new))
        proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "kernels"], cwd=work,
                              capture_output=True, text=True)
    failing = [line for line in proc.stdout.splitlines()
               if "FAIL" in line and any(name in line for name in kernels)]
    caught = proc.returncode != 0 and bool(failing)
    print(f"[fault] {label}: exit {proc.returncode}, {len(failing)} cases of {'/'.join(kernels)} fail, "
          f"{'caught' if caught else 'NOT caught'}", flush=True)
    for line in failing:
        parts = [p.strip() for p in re.split(r"[:;]", line) if "FAIL" in p]
        print(f"[fault]   {line.split(':')[0]}: " + "; ".join(parts), flush=True)
    if not caught:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
    return caught


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = [run_fault(*fault) for fault in FAULTS]
    print(f"[fault] {sum(results)} of {len(results)} planted faults caught", flush=True)
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
