"""Show that `chip_smoke.py`'s bounds on the attention forward (K3), on the
backward kernels (K4-K7), on the int8 matmul (K10), on the Hopper conv
engine of K9, K11, K1 (the resnet conv forward) and K2 (the sub-pixel
upsample conv), on K6's dskip (the engine's one-tap mode) and on the
Winograd conv (K8) bite.

    python3 scripts/planted_faults_bwd.py

    python3 scripts/planted_faults_bwd.py --only winograd    # the faults whose label holds it
    python3 scripts/planted_faults_bwd.py --only 'resnet conv backward'    # K6's
    python3 scripts/planted_faults_bwd.py --only 'resnet conv forward'     # K1's
    python3 scripts/planted_faults_bwd.py --only 'sub-pixel'               # K2's and K7's
    python3 scripts/planted_faults_bwd.py --only 'attention forward'
    python3 scripts/planted_faults_bwd.py --only 'Hopper conv engine'
    python3 scripts/planted_faults_bwd.py --only 'int8 matmul'

For each fault below, the package, `chip_smoke.py` and `configs/` are copied
into a temporary directory, some text of a source in the COPY is replaced
(a CUDA source under `ragb_vae_tpu_torch/csrc/`, or, for a name with a
slash, a file under `ragb_vae_tpu_torch/`), and `python3 chip_smoke.py --phases P` runs there (it rebuilds the
kernels from the copy) for each phase P the fault names, then for each phase
it names only to read (run and printed; it may pass). A fault counts as
caught when every run of a phase it names exits non-zero with a FAIL on a line of the
kernel the fault was planted in (phase `kernels`) or of the phase itself
(phase `stage1`, whose route check holds the whole VAE's Winograd forward
against the direct and the fp32 route). For the Winograd faults the route
check's readings are printed in either case, caught or not. The tree itself
is never touched. Exits 0 only when every fault was caught; needs an NVIDIA
GPU and nvcc.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BACKWARD_KERNELS = ("_bwd", "flash_attention_dq", "flash_attention_dkv")
FORWARD_KERNELS = ("flash_attention_fwd",)
# the conv engine runs K9, K11, K6's data gradient, K1, K12, K2 and K7's data gradient
CONV_SM90_KERNELS = ("downsample_conv3x3_stats", "conv3x3_same", "resnet_conv3x3_stats_bwd", "resnet_conv3x3_stats ",
                     "fused_gn_silu_conv3x3", "subpixel_upsample_conv3x3_stats")
# K1's lines of the kernel phase (not its backward's or K8's)
K1_KERNELS = ("resnet_conv3x3_stats ",)
# K2's and K7's lines
K2_KERNELS = ("subpixel_upsample_conv3x3_stats ",)
K7_KERNELS = ("subpixel_upsample_conv3x3_stats_bwd",)

# (label, source file, the text to replace (once in the file), its replacement, the kernels whose lines must FAIL
# [, the phases that must fail: `kernels` when not given[, phases only read, which may pass]])
FAULTS = [
    # K6, the resnet-block conv backward: dye pass, data gradient on the conv
    # engine (conv_sm90.cuh, BWD), weight gradient (wgrad_sm90.cuh)
    ("resnet conv backward: one weight-gradient pixel slice's partial left out of the sum", "wgrad_sm90.cuh",
     "for (int r = 1; r < S; ++r) {", "for (int r = 1; r < S - 1; ++r) {", BACKWARD_KERNELS),
    # warpgroup 0's first tap row reads one slab row down: the tile's top
    # halo row never enters the data gradient
    ("resnet conv backward: the data gradient's top halo row skipped", "conv_sm90.cuh",
     "return (MB * w + tap / 3) * SW + tap % 3;",
     "return (MB * w + tap / 3 + (MODE == CONV_BWD && w == 0 && tap < 3)) * SW + tap % 3;",
     BACKWARD_KERNELS),
    ("resnet conv backward: statistics cotangent's sum-of-squares term left out of dye", "resnet_block_bwd.cu",
     "ds1[j] = 2.0f * ds[", "ds1[j] = 0.0f * ds[", BACKWARD_KERNELS),
    ("resnet conv backward: the third column tap's K offset one pixel off", "wgrad_sm90.cuh",
     "wgmma_desc(a_slab + v * 128 + kk * 2048, L::A_SLOT, 1024)",
     "wgmma_desc(a_slab + (v + (v == 2)) * 128 + kk * 2048, L::A_SLOT, 1024)", BACKWARD_KERNELS),
    # the trap the materialised A avoids: had the weight gradient applied the
    # activation to a zero-filled x, SAME padding would read act(0 * a + b)
    # = act(b); the fault adds those halo terms (A rounded to bf16) to dW
    ("resnet conv backward: A's SAME padding taken as act(zero-filled x) = act(b)", "ops/kernels/resnet_block.py",
     "    _build.check(err, name)\n    CONV_BWD_LAUNCHES += 1\n",
     "    _build.check(err, name)\n"
     "    halo = torch.ones((bsz, height + 2, width + 2, 1), device=dev)\n"
     "    halo[:, 1:-1, 1:-1] = 0.0\n"
     "    halo = halo * (F.silu(b) if activation == 'silu' else b).to(torch.bfloat16).float()[:, None, None, :]\n"
     "    dw += torch.stack([torch.stack([halo[:, u:u + height, v:v + width].reshape(-1, c_in).t()\n"
     "                                    @ dye.float().reshape(-1, n_out) for v in range(3)]) for u in range(3)])\n"
     "    CONV_BWD_LAUNCHES += 1\n", BACKWARD_KERNELS),
    ("resnet conv backward: one tile's (d_t * x, d_t) partial left out", "conv_sm90.cuh",
     "partial[row * N + n] = s0;\n        partial[(row + 1) * N + n] = s1;",
     "partial[row * N + n] = BWD && tile == 1 ? 0.0f : s0;\n        partial[(row + 1) * N + n] = BWD && tile == 1 ? 0.0f : s1;",
     BACKWARD_KERNELS),
    ("resnet conv backward: the epilogue's x read from the neighbouring tile", "conv_sm90.cuh",
     "tma_load_4d(b_stage(bs), &emap, n0 + 64 * (k % 2), w0, h0 + MB * (k / 2), b, e_full);",
     "tma_load_4d(b_stage(bs), &emap, n0 + 64 * (k % 2), w0 + L::TW, h0 + MB * (k / 2), b, e_full);",
     BACKWARD_KERNELS),
    # the producer waits for the last x box's B stage one phase late: the
    # release it waits for never comes, the wait traps, the launch fails (in
    # K6's mode only: the loader also brings K1's identity skip)
    ("resnet conv backward: one ring stage's parity wrong for the epilogue's x (traps)", "conv_sm90.cuh",
     "mbar_wait_or_trap(b_empty(bs), ((it / BST) & 1) ^ 1);\n          tma_load_4d(b_stage(bs), &emap",
     "mbar_wait_or_trap(b_empty(bs), ((it / BST) & 1) ^ 1 ^ (BWD && k == BST - 1));\n          tma_load_4d(b_stage(bs), &emap",
     BACKWARD_KERNELS),
    # K1 on the conv engine's activation mode (conv_sm90.cuh, CONV_ACT)
    # SAME padding pads the activated value: the stage computes act(0 * a + b)
    # = act(b) for the pixels outside the image instead of writing 0
    ("resnet conv forward: the halo written as act(b) instead of 0", "conv_sm90.cuh",
     "if (live && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W) {", "if (live) {", K1_KERNELS),
    # the channels past C of a partial last chunk activated too, their a and b
    # read past the (B, C) arrays (chip_smoke puts NaN after them)
    ("resnet conv forward: the channel tail of a partial chunk not zeroed", "conv_sm90.cuh",
     "{ return c * 64 + 8 * lc < C; }", "{ return true; }", K1_KERNELS),
    ("resnet conv forward: a and b taken by the physical, not the logical, swizzle chunk", "conv_sm90.cuh",
     "slab + r * 128 + ((lc ^ (r & 7)) << 4)", "slab + r * 128 + (lc << 4)", K1_KERNELS),
    ("resnet conv forward: the activation stage skipped for the last chunk", "conv_sm90.cuh",
     "for (int k = k0; k < k1; ++k) {", "for (int k = k0; k < (c == (C - 1) / 64 ? k0 : k1); ++k) {", K1_KERNELS),
    ("resnet conv forward: the projection loop drops its last Cs chunk", "conv_sm90.cuh",
     "proj_steps = (op->Cs + L::BK - 1) / L::BK;", "proj_steps = (op->Cs + L::BK - 1) / L::BK - 1;", K1_KERNELS),
    ("resnet conv forward: the identity skip's box taken from the neighbouring tile", "conv_sm90.cuh",
     "tma_load_4d(b_stage(bs), &emap, n0 + 64 * (k % 2), w0, h0 + MB * (k / 2), b, e_full);",
     "tma_load_4d(b_stage(bs), &emap, n0 + 64 * (k % 2), w0 + (ACT ? L::TW : 0), h0 + MB * (k / 2), b, e_full);",
     K1_KERNELS),
    ("resnet conv forward: one tile's statistics partial row left out", "conv_sm90.cuh",
     "partial[row * N + n] = s0;\n        partial[(row + 1) * N + n] = s1;",
     "partial[row * N + n] = ACT && tile == 1 ? 0.0f : s0;\n        partial[(row + 1) * N + n] = ACT && tile == 1 ? 0.0f : s1;",
     K1_KERNELS),
    # K2 on the conv engine (conv_sm90.cuh, CONV_UP) and K7: dx on the engine
    # (CONV_UP_DX), the folded weights' gradient on wgrad_sm90.cuh
    ("sub-pixel upsample (K2): the row offset takes pb for pa", "conv_sm90.cuh",
     "if (UP) return (MB * w + pa + tap / 2) * SW + pb + tap % 2;",
     "if (UP) return (MB * w + pb + tap / 2) * SW + pb + tap % 2;", K2_KERNELS),
    ("sub-pixel upsample (K2): parity (pb, pa)'s folded weights read", "conv_sm90.cuh",
     "if (UP) return parity * 4 + tap;", "if (UP) return ((parity & 1) * 2 + (parity >> 1)) * 4 + tap;", K2_KERNELS),
    ("sub-pixel upsample (K2): the column parity dropped from the store", "conv_sm90.cuh",
     "((size_t)(p >> 1) * 2 * W + (p & 1)) * N", "((size_t)(p >> 1) * 2 * W) * N", K2_KERNELS),
    ("sub-pixel upsample (K2): the slab's origin at (w0, h0), not (w0 - 1, h0 - 1)", "conv_sm90.cuh",
     "return make_int2(w0 - 1, h0 - 1);", "return make_int2(w0 - 1 + UP, h0 - 1 + UP);", K2_KERNELS),
    ("sub-pixel upsample (K2): one tile's statistics partial row left out", "conv_sm90.cuh",
     "partial[row * N + n] = s0;\n        partial[(row + 1) * N + n] = s1;",
     "partial[row * N + n] = UP && tile == 1 ? 0.0f : s0;\n        partial[(row + 1) * N + n] = UP && tile == 1 ? 0.0f : s1;",
     K2_KERNELS),
    ("sub-pixel backward (K7): dx's plane slab one dye row off", "conv_sm90.cuh",
     "if (DX) return make_int2(2 * w0 - tap / 4 % 2, 2 * h0 - tap / 8);",
     "if (DX) return make_int2(2 * w0 - tap / 4 % 2, 2 * h0 - tap / 8 + 1);", K7_KERNELS),
    # dye's last, partial chunk of channels left out of dx (the ragged N = 136)
    ("sub-pixel backward (K7): dx loses the last chunk of a ragged N", "conv_sm90.cuh",
     "const int chunks = (C + L::BK - 1) / L::BK;",
     "const int chunks = (C + L::BK - 1) / L::BK - (L::DX && C % L::BK != 0);", K7_KERNELS),
    ("sub-pixel backward (K7): dW's A row h + pa + u, not h + pa + u - 1", "wgrad_sm90.cuh",
     "const int row_off = L::UP ? pa + (u & 1) - 1 : TAPS == 3 ? u - 1 : 0;",
     "const int row_off = L::UP ? pa + (u & 1) : TAPS == 3 ? u - 1 : 0;", K7_KERNELS),
    ("sub-pixel backward (K7): dW's dye box ignores pb", "wgrad_sm90.cuh",
     "L::UP ? 2 * w0 + pb : w0,", "L::UP ? 2 * w0 : w0,", K7_KERNELS),
    ("sub-pixel backward (K7): one weight-gradient partial left out of the reduce", "wgrad_sm90.cuh",
     "reinterpret_cast<float4*>(dw), S, m4);", "reinterpret_cast<float4*>(dw), L::UP && S > 1 ? S - 1 : S, m4);",
     K7_KERNELS),
    # The dQ kernel's key-tail mask cut one key short: the last real key's
    # dS K term is lost from every dQ row. (Leaving the mask out altogether
    # changes no output: TMA zero-fills the K rows past Sk, so their dS K
    # terms are 0 whatever dS is; the mask only keeps an inf from exp2 off
    # those zero rows.)
    ("key-tail mask of the dQ kernel one key short", "flash_attention_bwd.cu",
     "const bool valid = k0 + nt * 8 + t * 2 + e < Sk;", "const bool valid = k0 + nt * 8 + t * 2 + e < Sk - 1;",
     BACKWARD_KERNELS),
    ("last query tile left out of the dK/dV kernel's loop", "flash_attention_bwd.cu",
     "const int n_tiles = (Sq + BQ - 1) / BQ;", "const int n_tiles = (Sq + BQ - 1) / BQ - 1;", BACKWARD_KERNELS),
    # the MN-major B operand of dV += P^T dO: its LBO (the distance between
    # the dO tile's two 64-column boxes) halved, so columns 64..127 read rows
    # 32..63 of the first box
    ("dK/dV kernel: the dO tile's MN-major descriptor LBO set wrong", "flash_attention_bwd.cu",
     "wgmma_desc(dosm + s * L::Q_BYTES + kk * 2048, L::QBOX, 1024)",
     "wgmma_desc(dosm + s * L::Q_BYTES + kk * 2048, L::QBOX / 2, 1024)", BACKWARD_KERNELS),
    ("dK/dV kernel: lse and delta read from the neighbouring ring stage", "flash_attention_bwd.cu",
     "const float* terms = rows + s * 2 * BQ;", "const float* terms = rows + ((s + 1) % ST) * 2 * BQ;",
     BACKWARD_KERNELS),
    ("attention forward: key-tail mask left out", "flash_attention.cu",
     "const bool valid = k0 + nt * 8 + t * 2 + e < Sk;", "const bool valid = true;", FORWARD_KERNELS),
    ("attention forward: the running-max rescale of O forced to 1", "flash_attention.cu",
     "for (int i = 0; i < NO / 4; ++i) {", "for (int i = 0; i < 0; ++i) {", FORWARD_KERNELS),
    ("attention forward: the last key split dropped from the merge", "flash_attention.cu",
     "for (int s = 0; s < splits; ++s) {", "for (int s = 0; s < splits - 1; ++s) {", FORWARD_KERNELS),
    ("attention forward, d = 512: the other warpgroup's half of S left out", "flash_attention.cu",
     "sc[i] += xb[", "sc[i] += 0.0f * xb[", FORWARD_KERNELS),
    # K10: the tensor-core kernel's last 64-k ring stage left out (producer
    # and consumers agree, so nothing hangs: the products miss 64 of K terms)
    ("int8 matmul: last K chunk left out of the loop", "int8_matmul.cu",
     "const int chunks = (K + L::BK - 1) / L::BK;", "const int chunks = (K + L::BK - 1) / L::BK - (K > L::BK);",
     ("int8_matmul",)),
    ("int8 matmul: scale left out of the last N tile", "int8_matmul.cu",
     "sc[h] = n < N ? scale[n] : 0.0f;", "sc[h] = n < N ? (n0 + L::BN >= N ? 1.0f : scale[n]) : 0.0f;",
     ("int8_matmul",)),
    # the consumers wait on the last ring stage's full barrier for the phase
    # before the one they need: they read that stage before its load lands
    ("int8 matmul: one ring stage's parity read from the wrong phase", "int8_matmul.cu",
     "mbar_wait_or_trap(full(nx), ((c + 1) / ST) & 1);", "mbar_wait_or_trap(full(nx), (((c + 1) / ST) & 1) ^ (nx == ST - 1));",
     ("int8_matmul",)),
    # the int8 fragment read one 16-byte chunk off the 64-byte swizzle: each
    # k-step takes the weights of another k-step of the same rows
    ("int8 matmul: the weight fragment's swizzle off by one chunk", "int8_matmul.cu",
     "((s ^ (r >> 1)) & 3) * 16", "((s ^ ((r >> 1) + 1)) & 3) * 16", ("int8_matmul",)),
    # the skinny kernel stages only the first chunk of x (8192 / rows k):
    # every later chunk multiplies the first chunk's x (chip_smoke's fp32
    # modulation at batch 4 has two chunks)
    ("int8 matmul, skinny kernel: a K chunk of x left out of shared memory", "int8_matmul.cu",
     "stage_x<T, ROWS>(x, gemv_xs, m0, rows, K, kc, klen);",
     "if (kc == 0) stage_x<T, ROWS>(x, gemv_xs, m0, rows, K, kc, klen);", ("int8_matmul",)),
    # K9 and K11 on the Hopper conv engine: K9's input tensor map one row
    # taller, so the zero-padded bottom row is read from memory (the next
    # image's first row) instead of TMA's zero fill
    ("Hopper conv engine, K9: the padded bottom row read from memory", "conv_sm90.cuh",
     "(cuuint64_t)Hin, (cuuint64_t)B};", "(cuuint64_t)(Hin + DOWN), (cuuint64_t)B};", ("downsample_conv3x3_stats",)),
    ("Hopper conv engine: the last tap left out of the K loop", "conv_sm90.cuh",
     "static constexpr int TAPS = UP ? 4 : DX ? 16 : ONE ? 1 : 9;",
     "static constexpr int TAPS = UP ? 4 : DX ? 16 : ONE ? 1 : 8;", CONV_SM90_KERNELS),
    # the weights' MN-major B operand: its LBO (the distance between the two
    # 64-channel boxes of N) halved, so channels 64..127 read rows 32..63 of
    # the first box
    ("Hopper conv engine: the weights' MN-major descriptor LBO halved", "conv_sm90.cuh",
     "wgmma_desc(b_stage(bs) + kk * 2048, L::B_BOX, 1024)", "wgmma_desc(b_stage(bs) + kk * 2048, L::B_BOX / 2, 1024)",
     CONV_SM90_KERNELS),
    # the consumers wait on the last B stage's full barrier for the phase
    # before the one they need: they read that stage before its load lands
    ("Hopper conv engine: one B ring stage's parity read from the wrong phase", "conv_sm90.cuh",
     "mbar_wait_or_trap(b_full(bs), (it / BST) & 1);", "mbar_wait_or_trap(b_full(bs), ((it / BST) & 1) ^ (bs == BST - 1));",
     CONV_SM90_KERNELS),
    # K6's dskip on the conv engine's one-tap mode (CONV_1X1): the grid leaves
    # out the last, partial 128-channel tile of a ragged Cs (Cs = 40: no
    # block at all, the launch fails; Cs = 200: 72 channels never written)
    ("resnet conv backward: dskip's ragged last Cs tile lost", "conv_sm90.cuh",
     "dim3 grid((UP ? 4 : 1) * ((N + L::BN - 1) / L::BN), tiles_w * tiles_h, B);",
     "dim3 grid((UP ? 4 : 1) * ((N + (L::ONE && N % L::BN ? 0 : L::BN - 1)) / L::BN), tiles_w * tiles_h, B);",
     ("resnet_conv3x3_stats_bwd", "dskip")),
    # K8 (resnet_block_wino.cu): the input transform, the folded products, the
    # output transform
    ("winograd conv: a sign flipped in the input transform", "resnet_block_wino.cu",
     "out[1][j] = pack_bf16x2(c1[2 * j] + c2[2 * j],", "out[1][j] = pack_bf16x2(c1[2 * j] - c2[2 * j],",
     ("resnet_conv3x3_stats_wino",), ("kernels", "stage1")),
    ("winograd conv: one column variant's products left out of a row", "resnet_block_wino.cu",
     "wino_products<P>(acc[NU], v_stage(st), u_stage(st));",
     "if (NU != 2 || P == 0) wino_products<P>(acc[NU], v_stage(st), u_stage(st));",
     ("resnet_conv3x3_stats_wino",), ("kernels", "stage1")),
    # one more rounding than the JAX kernel makes: the fp32 products Z rounded
    # to bf16 before the column transform. Less than an ulp of the largest y,
    # so only phase 3's error over the whole tensor sees it; the stage-1 route
    # check, where every conv's bf16 rounding adds up, is only read
    ("winograd conv: the products rounded to bf16 before the output transform", "resnet_block_wino.cu",
     "const float z0 = acc[0][i + e], z1 = acc[1][i + e], z2 = acc[2][i + e], z3 = acc[3][i + e];",
     "const float z0 = __bfloat162float(__float2bfloat16(acc[0][i + e])), "
     "z1 = __bfloat162float(__float2bfloat16(acc[1][i + e])), z2 = __bfloat162float(__float2bfloat16(acc[2][i + e])), "
     "z3 = __bfloat162float(__float2bfloat16(acc[3][i + e]));",
     ("resnet_conv3x3_stats_wino",), ("kernels",), ("stage1",)),
    # tile 17's V rows land in tile 18's: tile 18 gets 17's transform and 17
    # keeps the stage's stale rows
    ("winograd conv: a V row stored to the wrong tile", "resnet_block_wino.cu",
     "const uint32_t off = t * 128 + ((lc ^ (t & 7)) << 4) + 8 * half;",
     "const int tv = t == 17 ? 18 : t; const uint32_t off = tv * 128 + ((lc ^ (tv & 7)) << 4) + 8 * half;",
     ("resnet_conv3x3_stats_wino",)),
    # row p = 1 adds V3 U3 where the fold subtracts it
    ("winograd conv: imm-scale-b's sign dropped for U3", "resnet_block_wino.cu",
     "wgmma_ss_tb64<S>(z, wgmma_desc(vst + (P + 2) * Wino::PLANE", "wgmma_ss_tb64<1>(z, wgmma_desc(vst + (P + 2) * Wino::PLANE",
     ("resnet_conv3x3_stats_wino",)),
    # the projection's q = 1 column added to Z[p][0] as well as taken out of
    # Z[p][3]: y[p][0] carries the wrong pixel's projection
    ("winograd conv: the projection's second column into the first column's accumulator", "resnet_block_wino.cu",
     "wgmma_ss_tb64<Q == 0 ? 1 : -1>(acc[3 * Q],", "wgmma_ss_tb64<1>(acc[0],",
     ("resnet_conv3x3_stats_wino",)),
]


def source_path(package: Path, source: str) -> Path:
    """A fault's file: `csrc/<source>`, or `<source>` under the package when it names a directory."""
    return package / source if "/" in source else package / "csrc" / source


def _run_phase(work: Path, phase: str, kernels) -> tuple:
    """chip_smoke's `phase` in `work` -> (exit code, its FAIL lines, the stage-1 route readings, output)."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", phase], cwd=work,
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    marks = kernels if phase == "kernels" else (f"[{phase}]",)
    failing = [line for line in lines if "FAIL" in line and any(mark in line for mark in marks)]
    readings = [line for line in lines if line.startswith("[stage1] decoder output")]
    return proc.returncode, failing, readings, proc.stdout[-3000:] + proc.stderr[-3000:]


def run_fault(label: str, source: str, old: str, new: str, kernels, phases=("kernels",), read=()) -> bool:
    caught = True
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        shutil.copytree(ROOT / "ragb_vae_tpu_torch", work / "ragb_vae_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copytree(ROOT / "configs", work / "configs")
        shutil.copy(ROOT / "chip_smoke.py", work / "chip_smoke.py")
        path = source_path(work / "ragb_vae_tpu_torch", source)
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"[fault] {label}: the line to replace occurs {text.count(old)} times in {source}")
        path.write_text(text.replace(old, new))
        for phase in phases + read:
            rc, failing, readings, tail = _run_phase(work, phase, kernels)
            hit = rc != 0 and bool(failing)
            if phase in phases:
                caught &= hit
            print(f"[fault] {label}: phase {phase} exit {rc}, {len(failing)} FAIL lines, "
                  f"{'caught' if hit else 'NOT caught'}{'' if phase in phases else ' (read only)'}", flush=True)
            for line in failing:
                print(f"[fault]   {line}", flush=True)
            for line in readings:
                print(f"[fault]   {line}", flush=True)
            if not hit and phase in phases:
                print(tail, flush=True)
    return caught


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="run only the faults whose label contains this")
    args = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = [run_fault(*fault) for fault in FAULTS if args.only in fault[0]]
    print(f"[fault] {sum(results)} of {len(results)} planted faults caught", flush=True)
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
