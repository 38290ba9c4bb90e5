"""Time variants of the Winograd conv (K8, `ragb_vae_tpu_torch/csrc/
resnet_block_wino.cu`) side by side on one NVIDIA GPU, to see what each of
its stages costs.

    python3 scripts/k8_variants.py
    python3 scripts/k8_variants.py --only 'no-op'

Each variant is the package's CUDA sources with some text of
`resnet_block_wino.cu` replaced (each replaced text must occur once); the
unchanged sources are the first variant. For each, `resnet_block_wino.cu` is
compiled with nvcc into a library of its own under `build/k8_variants/`, all
variants at once, and called through ctypes on the same inputs and the same
transformed weights: (2,128,128,512)->512 SiLU, (1,512,512,128)->128 SiLU
with an identity skip and (2,128,128,256)->512 SiLU with a projection of x.
Prints, per shape and variant, the time from an idle card (median of 10
CUDA-event-timed calls) and back to back (mean of 20), and the largest
difference of y from the first variant's (a variant that skips work shows
it there). The card's name and power limit come first. Needs an NVIDIA GPU
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

from k1_stage_variants import finish_build, idle_ms, queued_ms, start_build  # noqa: E402

from ragb_vae_tpu_torch.ops.kernels.resnet_block import wino_tiles  # noqa: E402

OUT = ROOT / "build" / "k8_variants"
SOURCE = "resnet_block_wino.cu"
ENTRIES = {"ragb_resnet_conv3x3_stats_wino": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]}

_TRANSFORM = "    wino_transform(sm + L::slab_off"
_ACT = "  wino_act_kernel<<<act_blocks"
_PRODUCTS = "wino_products<P>(acc[NU], v_stage(st), u_stage(st));"

_NO_U = [("mbar_arrive_expect_tx(u_full(st), 4 * L::PLANE);", "mbar_arrive(u_full(st));"),
         ("for (int mu = 0; mu < 4; ++mu)\n          tma_load_3d(u_stage(st)",
          "for (int mu = 0; mu < 0; ++mu)\n          tma_load_3d(u_stage(st)")]

# (label, [(text of resnet_block_wino.cu, its replacement), ...]); the no-op
# variants give wrong results and show what the rest of the kernel costs
VARIANTS = [
    ("as is", []),
    ("transform a no-op", [(_TRANSFORM, "    if (false) wino_transform(sm + L::slab_off")]),
    ("activation pass a no-op", [(_ACT, "  if (false) wino_act_kernel<<<act_blocks")]),
    ("products a no-op", [(_PRODUCTS, "")]),
    ("transform and products no-ops",
     [(_TRANSFORM, "    if (false) wino_transform(sm + L::slab_off"), (_PRODUCTS, "")]),
    # U's boxes not loaded (its stage's barrier completes at once): what the
    # 1 GB of U that the blocks read from L2 at (2,128,128,512)->512 costs
    ("U loads a no-op", _NO_U),
    ("U loads and transform no-ops", _NO_U + [(_TRANSFORM, "    if (false) wino_transform(sm + L::slab_off")]),
]

SHAPES = [((2, 128, 128, 512), 512, None), ((1, 512, 512, 128), 128, "identity"), ((2, 128, 128, 256), 512, "proj")]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="besides the sources as they are, only the variants whose label holds this")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    variants = [v for i, v in enumerate(VARIANTS) if i == 0 or args.only in v[0]]
    builds = [start_build(i, reps, edited=SOURCE, sources=(SOURCE,), out=OUT) for i, (_, reps) in enumerate(variants)]
    libs = [finish_build(d, jobs, ENTRIES) for d, jobs in builds]
    gen = torch.Generator("cuda").manual_seed(0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    for shape, n, skip in SHAPES:
        bsz, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        a = 1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
        b = 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
        u = wino_tiles((torch.randn((3, 3, c, n), generator=gen, device="cuda") / math.sqrt(9 * c)).to(torch.bfloat16))
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        sk = ws = wsb = None
        if skip == "identity":
            sk = torch.randn((bsz, h, w, n), generator=gen, device="cuda").to(torch.bfloat16)
        elif skip == "proj":
            sk = x
            ws = (torch.randn((c, n), generator=gen, device="cuda") / math.sqrt(c)).to(torch.bfloat16)
            wsb = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        y = torch.empty((bsz, h, w, n), device="cuda", dtype=torch.bfloat16)
        xa = torch.empty_like(x)
        tiles = -(-h // 8) * -(-w // 32)                 # the kernel's 8 x 32 tile
        partial = torch.empty((bsz, tiles, 2, n), device="cuda")
        stats = torch.empty((bsz, 2, n), device="cuda")
        mode = {None: 0, "identity": 1, "proj": 2}[skip]
        first, parts = None, []
        for (label, _), lib in zip(variants, libs):
            fn = lambda: lib.ragb_resnet_conv3x3_stats_wino(
                p(x), p(a), p(b), p(u), p(bias), p(sk), p(ws), p(wsb), p(xa), p(y), p(partial), p(stats), tiles, bsz, h, w,
                c, n, 0 if ws is None else c, 1, mode, stream())
            if fn() != 0:
                raise SystemExit(f"{label}: the launch failed")
            torch.cuda.synchronize()
            if first is None:
                first = y.clone()
            diff = (y.float() - first.float()).abs().max().item()
            parts.append(f"{label} {idle_ms(fn):.4f} ({queued_ms(fn):.4f}, y differs by {diff:.3g})")
        print(f"K8 {shape}->{n} skip={skip}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
