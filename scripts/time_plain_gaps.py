#!/usr/bin/env python3
"""Time the plain PyTorch versions that PERF.md's kernel table lacks, on the card.

K2's plain version (`upsample_conv3x3_stats_plain`) at the two shapes the
table times from `scripts/time_conv_engine.py`, (4,64,64,512)->512 and
(4,256,256,256)->256, and K6's dskip plain version (`skip_grad_plain`) at
chip_smoke's four dskip shapes, in bf16 with TF32 off: the median of 10
CUDA-event-timed calls from an idle card after 2 warm-ups, as chip_smoke
times. Prints the card's name and power limit first and one JSON line last.

    python3 scripts/time_plain_gaps.py
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb  # noqa: E402

K2_SHAPES = [((4, 64, 64, 512), 512), ((4, 256, 256, 256), 256)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    out = {}
    for shape, n in K2_SHAPES:
        c = shape[3]
        x = cs._randn(gen, shape)
        wt = cs._randn(gen, (3, 3, c, n), 1.0 / math.sqrt(9 * c))
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        key = f"K2 plain {shape}->{n}"
        out[key] = cs.time_ms(lambda: rb.upsample_conv3x3_stats_plain(x, wt, bias))
        print(f"{key}: {out[key]:.3f} ms", flush=True)
    for shape, c_skip in cs.DSKIP_SHAPES:
        dye = cs._randn(gen, shape)
        ws = cs._randn(gen, (c_skip, shape[3]), 1.0 / math.sqrt(shape[3]))
        key = f"dskip plain {shape} -> Cs {c_skip}"
        out[key] = cs.time_ms(lambda: rb.skip_grad_plain(dye, ws))
        print(f"{key}: {out[key]:.3f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
