// The Hopper (sm_90a) implicit-GEMM conv engine: a 3x3 conv over NHWC bf16,
// fed by TMA through an mbarrier ring and computed by wgmma, with one
// producer warp and two consumer warpgroups per block. One kernel template,
// `conv_sm90_kernel<MODE>`, seven modes:
//
//   CONV_SAME (K11) `_conv_kernel` of ragb_vae_tpu/ops/pallas/conv3x3.py:39
//       (entry `conv3x3_same` in conv_kernels.cu): y = conv3x3_same(x, w),
//       stride 1, no bias, no statistics. The TPU version pads the input in
//       a pass of its own.
//   CONV_DOWN (K9) `_downsample_kernel` of
//       ragb_vae_tpu/ops/pallas/resnet_block.py:1622 (entry
//       `fused_downsample_conv3x3_stats`): y = conv3x3(pad(x, bottom 1, right
//       1), w, stride 2) + bias, and the per-channel (sum, sum of squares) of
//       the ROUNDED y. The TPU version views column pairs as 2C channels and
//       pads each row tap to a dense K = 4C GEMM.
//   CONV_BWD (K6's data gradient) `_bwd_kernel` of
//       ragb_vae_tpu/ops/pallas/resnet_block.py:952 (entry
//       `ragb_resnet_conv3x3_stats_bwd` in resnet_block_bwd.cu):
//       dA = conv3x3_same(dye, flipped-transposed w), K11's mainloop, with the
//       chain rule through A = act(t), t = x*a + b, in the epilogue: the
//       forward's x comes in by TMA, d_t = dA * act'(t) from the fp32
//       accumulators (dA is never rounded), dx = bf16(d_t * a) and
//       A = bf16(act(t)) go out by TMA stores (A is the weight gradient's
//       operand), and per-channel (d_t * x, d_t) sums over the tile's pixels
//       inside the image become one (B, T, 2, C) partial row per block.
//   CONV_ACT (K1 and K12) `_kernel` of ragb_vae_tpu/ops/pallas/resnet_block.py:69
//       (entry `gn_silu_conv3x3_stats`, C entry `ragb_resnet_conv3x3_stats` in
//       resnet_block.cu) and `_kernel` of
//       ragb_vae_tpu/ops/pallas/fused_gn_silu_conv.py:45 (entry
//       `fused_gn_silu_conv3x3`, C entry `ragb_fused_gn_silu_conv3x3` in
//       conv_kernels.cu):
//         y = bf16(conv3x3_same(bf16(act(x*a + b))) + bias
//                  [+ skip | + skip @ ws + wsb])
//       with act SiLU or the identity and a, b (B, C) fp32, and for K1 the
//       per-channel (sum, sum of squares) of the ROUNDED y. K12 is this mode
//       with no skip and no statistics.
//   CONV_UP (K2) `_subpixel_kernel` of
//       ragb_vae_tpu/ops/pallas/resnet_block.py:231 (entry
//       `ragb_subpixel_upsample_conv3x3_stats` in resnet_block.cu): a
//       nearest-2x upsample + conv3x3 + bias as four 2x2 "parity" convs on
//       the small grid,
//         y[b, 2h+pa, 2w+pb] = bias + sum over u, v of
//                              x[b, h+pa+u-1, w+pb+v-1] . Wf[pa, pb, u, v]
//       over the folded weights Wf (2, 2, 2, 2C, N) (x zero outside the
//       image), and the per-channel (sum, sum of squares) of the ROUNDED y.
//   CONV_UP_DX (K7's data gradient) `_subpixel_bwd_kernel` of
//       ragb_vae_tpu/ops/pallas/resnet_block.py:2003 (entry
//       `ragb_subpixel_upsample_conv3x3_stats_bwd` in resnet_block_bwd.cu):
//       dx[h, w] = sum over r, s < 4 of dye[2h-1+r, 2w-1+s] . wb[r, s], a
//       stride-2 4x4 conv of dye (B, 2H, 2W, N) over the doubly folded
//       weights wb (4, 4, N, C) (dye zero outside the image); no bias, no
//       statistics.
//   CONV_1X1 (K6's dskip) of `_bwd_kernel` (entry
//       `ragb_resnet_conv3x3_stats_bwd`): dskip = dye @ ws^T, a 1x1 conv of
//       dye (B, H, W, N) into (B, H, W, Cs) over ws (Cs, N) as it lies; no
//       taps, no halo, no bias, no statistics.
// All accumulate in fp32 and round y (dx, dskip) to bf16 once.
//
// What bounds it on the H100: a conv3x3 does 2*9*C operations per output
// element. K11 at (1,128,128,512)->512 does 77 GFLOP against 38 MB: tensor-
// core operations bound it (0.078 ms at 989 TFLOP/s). K9 at C = 512, e.g.
// (2,128,128,512)->512, also (0.039 ms). K1 at (2,128,128,512)->512 does 155
// GFLOP against 38 MB (0.156 ms, operations); at (1,512,512,128)->128 with an
// identity skip 39 GFLOP against 201 MB, 193 FLOP per byte, still
// operations (0.078 ms against 0.060 for the bytes). K9 at
// (4,512,512,128)->128 reads a 268 MB input and writes 67 MB for 77 GFLOP,
// 230 FLOP per byte, below the bf16 ridge (~295): bytes bound it (0.100 ms
// at 3.35 TB/s). K2 and K7's dx do 2*16*C operations per small-grid pixel
// and output channel: K2 at (4,128,128,512)->512 0.55 TFLOP against 335 MB
// (0.556 ms, operations), K7's dx at (4,64,64,512)->512 0.14 TFLOP against
// 84 MB (0.139 ms, operations). dskip does 2*N operations per output
// element against 2 bytes of it and 2*N / Cs of dye's: at most 128 FLOP a
// byte at Cs = 512, below the ridge, so bytes bound it: (4,256,256,256) ->
// Cs 512 moves 402 MB (0.120 ms at 3.35 TB/s), (4,512,512,128) -> 256 805 MB
// (0.240 ms).
//
// What the design does about it:
// - Implicit GEMM: M = a tile of TH x TW = 4 x 64 output pixels (one output
//   row is one m64 block), N = 128 output channels, K = 9 taps x C in chunks
//   of 64 channels. Each consumer warpgroup owns two output rows and issues
//   wgmma m64n128k16 for each with fp32 accumulators in registers (128 a
//   thread); setmaxnreg moves the producer warpgroup's registers to the
//   consumers.
// - K11's A (the input) is ONE halo'd slab per chunk, a TMA box {64, TW + 2,
//   TH + 2, 1} of a 4-D tensor map over x as (C, W, H, B) started at (c0,
//   w0 - 1, h0 - 1, b): it lands as (TH + 2) x (TW + 2) rows of 128 bytes in
//   128-byte swizzle, and the window of tap (dy, dx) for output row i is the
//   64 consecutive rows from (i + dy)(TW + 2) + dx: a K-major A operand as it
//   stands, its descriptor only offset (the swizzle follows the address
//   bits). So each input element comes from L2 about 1.5 times per chunk
//   instead of 9 (a box per tap, the first design, moved ~9.5 TB/s from L2
//   on an H100 SXM: about all L2 delivers). TMA's zero fill outside the tensor, negative coordinates
//   included, IS the SAME padding: no pad pass, no edge test.
// - K1's A is K11's slab, rewritten in shared memory before the consumers
//   read it: the activation stage. TMA brings raw x into a ring of three
//   slab stages; threads that are not issuing a wgmma rewrite each slab IN
//   PLACE to bf16(act(x*a + b)), fence their writes to the async proxy
//   (fence.proxy.async: generic writes before a wgmma read) and arrive on a
//   per-stage "ready" barrier, which the consumers wait on instead of the
//   TMA's. SAME padding pads the ACTIVATED value, so the stage writes 0, not
//   act(0*a + b) = act(b), at every slab pixel outside the image (the halo
//   included: TMA's zero fill there is x, not the activation), and at every
//   channel >= C of a partial last chunk, where a and b are not read at all
//   (they end at C; a NaN past them would survive B's zero rows, since
//   0 * NaN = NaN). A thread owns one LOGICAL 16-byte chunk (8 channels) of
//   a group of rows, its 16 coefficients in registers for the chunk; the
//   chunk's physical place in row r is logical ^ (r % 8) (128-byte
//   swizzle), and a quarter warp covers one row's 128 bytes (no bank
//   conflicts). The sigmoid takes the fast exp and divide (K6's
//   act_chain), 2 MUFU operations an element.
//   Who does the work decides the speed. The producer warpgroup's three
//   idle warps alone (one warp per SM sub-partition) took ~8.5 us a
//   64-channel chunk, more than the chunk's ~8 us of wgmma, and K1 ran at
//   0.43-0.52 ms at (2,128,128,512)->512. So the 256 consumer threads share
//   each slab with them (9 rows each of 44 groups of 8 threads): a consumer
//   activates one row of the NEXT chunk's slab after issuing each tap's
//   wgmma, while the tensor cores run (chunk 0's rows before the first
//   products), and the three warps take the rest as soon as the slab lands;
//   their first thread also issues the A ring's loads, one step ahead, so
//   that a slab's load does not queue behind the B ring's. 0.35-0.37 ms
//   there (H100 SXM, scripts/time_conv_engine.py).
// - K1's 1x1 projection skip (skip_mode 2) is an extra K loop after the nine
//   taps, into the same accumulators: per 64 skip channels one {64 Cs, TW,
//   TH} box of the RAW skip (no activation stage, no halo) through the A
//   ring, rows in output-pixel order, and two {64 N, 64 Cs} boxes of ws
//   (Cs, N) through a 3-D map as B; wsb joins the bias.
// - K9's A is one box per (tap, chunk), {64, 2 TW, 2 TH, 1} read with
//   traversal strides {1, 2, 2, 1} from (c0, 2 w0 + dx, 2 h0 + dy, b): every
//   other pixel, so the TH x TW rows are the tap's window as they land, and
//   the zero fill past Hin and Win IS the (0, 1) padding. (A stride-2 window
//   is not a run of consecutive slab rows; slabs of the even and odd columns
//   per (chunk, dy) moved a third fewer bytes but measured 5-11% slower.)
// - K2's A is K11's slab (TMA's zero fill is the upsampled image's zero
//   halo: K2 has no activation), and tap (u, v) of parity (pa, pb) is K11's
//   row offset with (dy, dx) = (pa + u, pb + v): output row i reads the 64
//   rows from (i + pa + u)(TW + 2) + pb + v. A block computes one parity:
//   the grid's x walks the four parities of each N tile, so a slab comes
//   from L2 four times (~150 FLOP a byte). B is the folded weights as (16,
//   C, N), tap t = ((pa * 2 + pb) * 2 + u) * 2 + v, through the 3-D map.
//   y goes out through four tensor maps, one per parity, over y with the
//   strides of two columns and two rows from row pa, column pb: a parity's
//   tile is an ordinary box of its view, clipped at the small grid's edges.
// - K7's dx reads dye as four parity planes (qa, qb) (rows 2k + qa, columns
//   2k + qb). Plane (qa, qb)'s slab is one box {64, 2 (TW + 1), 2 (TH + 1),
//   1} at traversal strides {1, 2, 2, 1} from (c0, 2 w0 - qb, 2 h0 - qa, b):
//   (TH + 1) x (TW + 1) plane pixels from (h0 - qa, w0 - qb). Output pixel
//   (h, w) reads plane pixels (h - qa + u', w - qb + v'), u', v' in {0, 1},
//   through wb[2 u' + 1 - qa][2 v' + 1 - qb]: the plane's four taps are row
//   offsets (i + u')(TW + 1) + v', as K11's. Four slabs of 41.6 KB a chunk
//   (a ring of 3) for 16 taps, against 16 boxes of 32 KB read as K9 reads
//   them (scripts/time_conv_bwd.py --dx-boxes builds that form from a copy
//   of this file and times both).
//   TMA's zero fill, negative coordinates included, is dye's zero outside
//   the image.
// - dskip's A is one {64 N, TW, TH} box of dye a 64-channel chunk, rows in
//   output-pixel order (K1's projection box), and its B is ws (Cs, N) as it
//   lies: one {64 N, 128 Cs} box is the K-major B operand (the contraction
//   contiguous), so ws^T needs no copy. It has 2 to 8 k-steps a tile, so a
//   block a tile would pay its fixed cost (first loads, epilogue, store)
//   every few k-steps: instead about one block an SM walks tiles (image,
//   tile) of its 128 output channels, its rings (3 A, 2 B stages) running on
//   across tiles, and each tile's output goes out of a staging area of its
//   own by TMA stores that leave while the next tile's products run. A block
//   reads dye once for its 128 output channels; the blocks of a tile's N
//   tiles run side by side, so dye's re-reads for Cs > 128 come from L2.
//   Channels past C read as zeros in every mode.
//   Halo re-reads come from L2: the
//   grid walks the N tiles of a pixel tile together and the pixel tiles in
//   raster order.
// - B (the weights) straight from HWIO as the MN-major operand (N
//   contiguous): boxes {64 N, 64 C} of tap t from a 3-D map over w as (N, C,
//   9); LBO is one box's bytes. No transpose of the weights.
// - Two rings on full and empty mbarriers: A (K11, K6, K2: 2 slab stages, one
//   per chunk; K1: 3; K7: 3, one per plane; K9: 4 stages, one per tap;
//   dskip: 3, one per chunk) and B
//   (4 stages, one per tap; dskip: 2). One
//   producer thread keeps the loads in flight (K1's A loads: the activation
//   stage's first thread); the consumers keep one wgmma
//   group in flight and release a stage when the group that read it last
//   has completed.
// - Epilogue: (+ bias), one rounding to bf16, staged in the drained ring in
//   the swizzled box layout and written by a TMA store per warpgroup, which
//   writes no element outside the tensor (ragged H, W, N need no masks). K9,
//   K1 and K2 take the statistics of the rounded y per channel over the tile's pixels
//   inside the image: a fixed shuffle tree over a warp's rows, then the 8
//   warps in order into one (B, T, 2, N) partial row per block, which
//   `stats_reduce_kernel` (stats_reduce.cuh) sums in a fixed order. No
//   float atomics: bit-for-bit reproducible. K1's identity skip (skip_mode
//   1) comes by TMA into the drained B ring, one {64 N, TW, MB} box per
//   stage, and is added to the fp32 accumulators before the one rounding.
//   K6's data gradient (BWD) stages
//   dx the same way; the forward's x tile comes by TMA into the B ring, one
//   {64 C, TW, MB} box per stage, each stage as soon as the consumers release
//   it after its last k-step (the last boxes' loads overlap the last
//   products); each thread reads its own accumulator elements' x, computes
//   t, sigmoid(t) once, d_t, dx and A, writes A over x in place (no other
//   thread reads that element) and the boxes go out by TMA stores; the
//   (d_t * x, d_t) sums take K9's shuffle tree and partial rows.
// One block per tile (but dskip: above). Persistent blocks, whose producer runs on into the
// next tile, measured 8-14% slower storing y from the accumulators, and with
// the TMA store and 3-stage rings 3-15% slower for K9 (7% faster for K11 at
// C = 128). K9 at C = 128 runs 18 k-steps a tile and pays a fixed ~8 us a
// tile, most of it the epilogue (a quarter of its time), which this design
// does not hide; K1 pays ~17 us a tile (its first slab's activation, the
// skip's boxes after the last tap, the statistics): 45% of a tile at
// C = 128, 31% at C = 256. (H100 SXM, scripts/time_conv_engine.py.)
// Every barrier wait traps after 2^22 polls, so a barrier that can never
// complete fails the launch instead of hanging the card.
// C, N (and K1's Cs) must be multiples of 8 (16-byte global strides for TMA).
#pragma once

#include "sm90.cuh"
#include "stats_reduce.cuh"

namespace {

// The engine's modes: what one launch computes (see the note above).
enum { CONV_SAME = 0, CONV_DOWN = 1, CONV_BWD = 2, CONV_ACT = 3, CONV_UP = 4, CONV_UP_DX = 5, CONV_1X1 = 6 };

template <int MODE>
struct ConvSm90 {
  static constexpr bool DOWN = MODE == CONV_DOWN, ACT = MODE == CONV_ACT, UP = MODE == CONV_UP;
  static constexpr bool DX = MODE == CONV_UP_DX, ONE = MODE == CONV_1X1;
  static constexpr int TH = 4, TW = 64;            // output tile: TH rows x TW columns
  static constexpr int MB = TH / 2;                // output rows (m64 blocks) of a consumer warpgroup
  static constexpr int BN = 128;                   // output channels of a block
  static constexpr int BK = 64;                    // input channels of a K chunk: one 128-byte row (act_live's 64)
  static constexpr int TAPS = UP ? 4 : DX ? 16 : ONE ? 1 : 9;
  static constexpr int A_TAPS = DOWN ? 1 : DX ? 4 : TAPS;   // the k-steps that read one A box
  static constexpr bool SLAB = A_TAPS == TAPS;                // one A box a chunk (K11, K6, K1, K2)
  static constexpr int W_TAPS = UP || DX ? 16 : ONE ? 1 : 9;            // the weights' taps (wmap's third dimension)
  // slab row: the tile's columns and their halo (K7: a plane's; dskip: no halo)
  static constexpr int SW = DX ? TW + 1 : ONE ? TW : TW + 2;
  static constexpr int SH = DX ? TH + 1 : ONE ? TH : TH + 2;
  // an A box lands as AH rows of AW pixels, read at traversal stride STRIDE
  static constexpr int AW = DOWN ? TW : SW, AH = DOWN ? TH : SH;
  static constexpr int STRIDE = DOWN || DX ? 2 : 1;
  static constexpr int A_ROWS = AH * AW;
  static constexpr int A_BYTES = A_ROWS * 128;     // one A box
  static constexpr int P_BYTES = TH * TW * 128;    // K1's projection: one {64 Cs, TW, TH} box of the skip
  static constexpr int A_STAGE = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr int A_STAGES = DOWN ? 4 : ACT || DX || ONE ? 3 : 2;
  static constexpr int B_BOX = BK * 128;           // one {64 N, 64 C} box of a tap's weights (dskip: one {64 N, 128 Cs} box)
  static constexpr int B_BYTES = (BN / 64) * B_BOX;
  static constexpr int B_STAGES = ONE ? 2 : 4;
  static constexpr int Y_BOX = MB * TW * 128;      // a warpgroup's rows x 64 output channels
  static constexpr int a_off = 0;
  static constexpr int b_off = a_off + A_STAGES * A_STAGE;
  static constexpr int red_off = b_off + B_STAGES * B_BYTES;   // [2][8 warps][BN] fp32 statistics
  static constexpr int stg_off = red_off + 2 * 8 * BN * 4;   // dskip: its output tile, staged outside the rings
  static constexpr int STG_BYTES = ONE ? 2 * (BN / 64) * Y_BOX : 0;
  static constexpr int bar_off = stg_off + STG_BYTES;
  // full and empty per stage of each ring, the epilogue tile's, K1's "ready" per A stage
  static constexpr int BARS = 2 * (A_STAGES + B_STAGES) + 1 + (ACT ? A_STAGES : 0);
  static constexpr int bytes = bar_off + BARS * 8 + 1024;   // + alignment slack
  static constexpr int CONSUMERS = 256, THREADS = 384;
  // K1's activation stage: warps 1-3 of the producer warpgroup (96 threads)
  // and the 256 consumer threads share each slab. A thread owns one logical
  // 16-byte chunk (8 channels) of a row group: a producer-warp thread
  // STAGE_ROWS rows 12 apart from row q / 8, a consumer thread TAP_ROWS rows
  // 32 apart from row 12 STAGE_ROWS + threadIdx.x / 8, spread over the nine
  // taps of the chunk before
  static constexpr int ACT_THREADS = 96 + CONSUMERS, STAGE_ROWS = 9, TAP_ROWS = 9;
  // the stage keeps 16 coefficients and a row of work in registers; the pool
  // of 384 x 168 stays what every other setmaxnreg kernel here uses
  static constexpr int PRODUCER_REGS = ACT ? 56 : 40, CONSUMER_REGS = ACT ? 224 : 232;
  static_assert(bytes <= 232448, "shared memory");
  static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * 168, "register pool");
  static_assert(2 * (BN / 64) * Y_BOX <= red_off, "the output tile is staged in the drained rings");
  // K6's data gradient: dx staged in the drained A ring, x (then A) one box per B stage
  static_assert(DOWN || 2 * (BN / 64) * Y_BOX <= A_STAGES * A_STAGE, "dx is staged in the A ring");
  static_assert(Y_BOX == B_BYTES && (ONE || B_STAGES == 2 * (BN / 64)), "one x box per B stage");
  static_assert(!ACT || (P_BYTES <= A_STAGE && 12 * STAGE_ROWS + 32 * TAP_ROWS == A_ROWS),
                "K1's stage covers each slab row once");
  static_assert(TAPS % A_TAPS == 0, "a chunk's k-steps read whole A boxes");

  // The origin (column, row) in x of the A box that k-step `tap` of a chunk
  // starts reading.
  __device__ __forceinline__ static int2 a_origin(int tap, int w0, int h0) {
    if (DOWN) return make_int2(2 * w0 + tap % 3, 2 * h0 + tap / 3);      // K9: tap (dy, dx), no halo above or left
    if (DX) return make_int2(2 * w0 - tap / 4 % 2, 2 * h0 - tap / 8);    // K7: plane (qa, qb) = (tap / 8, tap / 4 % 2)
    return make_int2(w0 - 1, h0 - 1);                                    // the halo'd slab
  }

  // The first A row of warpgroup w's first output row under k-step `tap`
  // (K2: of parity (pa, pb)); output row MB w + m reads from m AW rows on.
  __device__ __forceinline__ static uint32_t a_row(int w, int tap, int pa, int pb) {
    if (DOWN) return MB * w * TW;                                // the tap's window as it lands
    if (UP) return (MB * w + pa + tap / 2) * SW + pb + tap % 2;  // K2: tap (u, v) = (tap / 2, tap % 2)
    if (DX) return (MB * w + tap % 4 / 2) * SW + tap % 2;        // K7: the plane's tap (u', v')
    return (MB * w + tap / 3) * SW + tap % 3;                    // K11's tap (dy, dx)
  }

  // The weights' tap (wmap's third coordinate) of k-step `tap`.
  __device__ __forceinline__ static int w_tap(int tap, int parity) {
    if (UP) return parity * 4 + tap;               // Wf[pa][pb][u][v] of (16, C, N): ((pa * 2 + pb) * 2 + u) * 2 + v
    if (DX)                                        // plane (qa, qb), tap (u', v'): wb[2 u' + 1 - qa][2 v' + 1 - qb]
      return (2 * (tap % 4 / 2) + 1 - tap / 8) * 4 + 2 * (tap % 2) + 1 - tap / 4 % 2;
    return tap;
  }
};

// K6's chain rule through the activation, per element: t = x*a + b; the
// cotangent of t from dA (fp32), and A = act(t) before its rounding. The
// sigmoid takes the fast exp and divide: a few ulp of fp32, far below the
// bf16 rounding of dx and A.
__device__ __forceinline__ void act_chain(float x, float a, float b, float da, int silu, float& d_t, float& act) {
  const float t = x * a + b;
  if (silu) {
    const float s = __fdividef(1.0f, 1.0f + __expf(-t));
    d_t = da * (s * (1.0f + t * (1.0f - s)));
    act = t * s;
  } else {
    d_t = da;
    act = t;
  }
}

// K1's activation of two neighbouring channels of a raw bf16 pair, rounded
// to bf16: act(x*a + b), the value K6's data gradient recomputes as A.
__device__ __forceinline__ uint32_t act_pair(uint32_t raw, float a0, float a1, float b0, float b1, int silu) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  float d, g0, g1;                                 // no cotangent here: d is dead
  act_chain(x.x, a0, b0, 0.0f, silu, d, g0);
  act_chain(x.y, a1, b1, 0.0f, silu, d, g1);
  return pack_bf16x2(g0, g1);
}

// Whether logical chunk lc of K1's 64-channel chunk c (channels 64 c + 8 lc
// .. + 7) lies inside C; C % 8 == 0, so all 8 channels or none.
__device__ __forceinline__ bool act_live(int c, int lc, int C) { return c * 64 + 8 * lc < C; }

// K1's activation coefficients of one thread: those channels of one
// sample's a and b (B, C) fp32, or zeros past C, where a and b are not read.
__device__ __forceinline__ void act_coeffs(const float* ca, const float* cb, int c, int lc, int C, float4& a0,
                                           float4& a1, float4& e0, float4& e1) {
  const int ch = c * 64 + 8 * lc;
  a0 = a1 = e0 = e1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (act_live(c, lc, C)) {
    a0 = *reinterpret_cast<const float4*>(ca + ch);
    a1 = *reinterpret_cast<const float4*>(ca + ch + 4);
    e0 = *reinterpret_cast<const float4*>(cb + ch);
    e1 = *reinterpret_cast<const float4*>(cb + ch + 4);
  }
}

// K1's activation of chunk c's slab in place, one thread's share: logical
// chunk lc (coefficients a0, a1, e0, e1) of slab rows r0 + k stride, k in
// [k0, k1), each at its physical place lc ^ (r % 8) (128-byte swizzle); 0
// where the slab pixel lies outside the image (SAME padding pads the
// activated value) or the channels lie past C.
template <int SW>
__device__ __forceinline__ void act_rows(unsigned char* slab, int c, int C, int r0, int stride, int k0, int k1, int lc,
                                         const float4& a0, const float4& a1, const float4& e0, const float4& e1,
                                         int h0, int w0, int H, int W, int silu) {
  const bool live = act_live(c, lc, C);
  for (int k = k0; k < k1; ++k) {
    const int r = r0 + k * stride;
    const int hh = h0 - 1 + r / SW, ww = w0 - 1 + r % SW;
    uint4* p = reinterpret_cast<uint4*>(slab + r * 128 + ((lc ^ (r & 7)) << 4));
    uint4 out = zero_vec();
    if (live && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W) {
      const uint4 xv = *p;
      out.x = act_pair(xv.x, a0.x, a0.y, e0.x, e0.y, silu);
      out.y = act_pair(xv.y, a0.z, a0.w, e0.z, e0.w, silu);
      out.z = act_pair(xv.z, a1.x, a1.y, e1.x, e1.y, silu);
      out.w = act_pair(xv.w, a1.z, a1.w, e1.z, e1.w, silu);
    }
    *p = out;
  }
}

// Grid (N tiles, pixel tiles of one image, batch); K2: (4 parities x N
// tiles, ...), x = parity * N tiles + N tile. Per mode (see the note above):
// xmap the conv input (K1: raw x; K7: dye); wmap the weights; ymap y (K6,
// K7: dx); emap the epilogue's tile (K6: the forward's x; K1: the identity
// skip); amap K6's A (written) or K1's projection operand (the skip, read);
// pmap K1's ws. K2: ymap, emap, amap, pmap the views of y of parities (0, 0),
// (0, 1), (1, 0), (1, 1) (`y_view`). act_a, act_b (B, C or N) the activation's
// coefficients; wsb K1's projection bias; proj_steps K1's projection K loop
// (0: none).
template <int MODE>
__global__ void __launch_bounds__(ConvSm90<MODE>::THREADS, 1)
    conv_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap emap,
                     const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap pmap,
                     const float* __restrict__ bias, const float* __restrict__ act_a,
                     const float* __restrict__ act_b, const float* __restrict__ wsb, int silu, int skip_mode,
                     int proj_steps, float* __restrict__ partial, int H, int W, int C, int N, int tiles_w,
                     int batch) {
  using L = ConvSm90<MODE>;
  constexpr bool DOWN = L::DOWN, BWD = MODE == CONV_BWD, ACT = L::ACT, UP = L::UP;
  constexpr int AST = L::A_STAGES, BST = L::B_STAGES, BN = L::BN, MB = L::MB;
  extern __shared__ __align__(1024) unsigned char conv_sm90_smem[];
  const uint32_t raw = smem_addr(conv_sm90_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = conv_sm90_smem + (base - raw);
  const uint32_t bars = base + L::bar_off;
  auto a_full = [&](int s) { return bars + 8 * s; };
  auto a_empty = [&](int s) { return bars + 8 * (AST + s); };
  auto b_full = [&](int s) { return bars + 8 * (2 * AST + s); };
  auto b_empty = [&](int s) { return bars + 8 * (2 * AST + BST + s); };
  const uint32_t e_full = bars + 8 * (2 * AST + 2 * BST);   // BWD, K1's skip: the epilogue's tile has landed
  auto a_ready = [&](int s) { return bars + 8 * (2 * AST + 2 * BST + 1 + s); };   // K1: slab s activated
  auto a_stage = [&](int s) { return base + L::a_off + s * L::A_STAGE; };
  auto b_stage = [&](int s) { return base + L::b_off + s * L::B_BYTES; };

  const int n_tiles = UP ? gridDim.x / 4 : gridDim.x;
  const int n0 = (UP ? blockIdx.x % n_tiles : blockIdx.x) * BN;
  const int parity = UP ? blockIdx.x / n_tiles : 0, pa = parity >> 1, pb = parity & 1;   // K2: rows 2h + pa, columns 2w + pb
  // K2 has no epilogue tile, projection or ws: parity p's view of y rides in
  // the p-th of those slots (launch_conv_sm90 fills them in this order)
  auto y_view = [&](int p) { return p == 0 ? &ymap : p == 1 ? &emap : p == 2 ? &amap : &pmap; };
  const int tile = blockIdx.y, b = blockIdx.z;
  const int h0 = (tile / tiles_w) * L::TH, w0 = (tile % tiles_w) * L::TW;
  const int chunks = (C + L::BK - 1) / L::BK;
  const bool epi_tile = BWD || (ACT && skip_mode == SKIP_ADD);
  const bool stats = DOWN || BWD || UP || (ACT && partial != nullptr);

  if (threadIdx.x == 0) {
    for (int s = 0; s < AST; ++s) {
      mbar_init(a_full(s), 1);
      mbar_init(a_empty(s), 8);                    // lane 0 of each consumer warp
      if (ACT) mbar_init(a_ready(s), L::ACT_THREADS);
    }
    for (int s = 0; s < BST; ++s) {
      mbar_init(b_full(s), 1);
      mbar_init(b_empty(s), 8);
    }
    if (BWD || ACT) mbar_init(e_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (L::ONE) {
    // dskip: a block walks the (image, tile) items blockIdx.y, + gridDim.y,
    // ... of its 128 output channels; the rings run on across items, and
    // an item's TMA store leaves while the next item's products run
    const int T = tiles_w * ((H + L::TH - 1) / L::TH), items = batch * T;
    if (threadIdx.x >= L::CONSUMERS) {
      setmaxnreg_dec<L::PRODUCER_REGS>();
      if (threadIdx.x != L::CONSUMERS) return;
      int k = 0;                                   // k-steps of all items: both rings' index
      for (int item = blockIdx.y; item < items; item += gridDim.y) {
        const int bi = item / T, t = item % T, ih0 = (t / tiles_w) * L::TH, iw0 = (t % tiles_w) * L::TW;
        for (int chunk = 0; chunk < chunks; ++chunk, ++k) {
          const int as = k % AST, bs = k % BST;
          mbar_wait_or_trap(a_empty(as), ((k / AST) & 1) ^ 1);
          mbar_arrive_expect_tx(a_full(as), L::A_BYTES);
          tma_load_4d(a_stage(as), &xmap, chunk * L::BK, iw0, ih0, bi, a_full(as));
          mbar_wait_or_trap(b_empty(bs), ((k / BST) & 1) ^ 1);
          mbar_arrive_expect_tx(b_full(bs), L::B_BYTES);
          tma_load_3d(b_stage(bs), &wmap, chunk * L::BK, n0, 0, b_full(bs));   // ws's {64 N, 128 Cs} box, K-major
        }
      }
      return;
    }
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    int k = 0;
    for (int item = blockIdx.y; item < items; item += gridDim.y) {
      const int bi = item / T, ti = item % T, ih0 = (ti / tiles_w) * L::TH, iw0 = (ti % tiles_w) * L::TW;
      float acc[MB][BN / 2];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.0f;
      for (int chunk = 0; chunk < chunks; ++chunk, ++k) {
        const int as = k % AST, bs = k % BST;
        mbar_wait_or_trap(a_full(as), (k / AST) & 1);
        mbar_wait_or_trap(b_full(bs), (k / BST) & 1);
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int kk = 0; kk < L::BK / 16; ++kk)
            wgmma_ss<BN>(acc[m], wgmma_desc(a_stage(as) + (MB * w + m) * L::TW * 128 + kk * 32, 16, 1024),
                         wgmma_desc(b_stage(bs) + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
        if (lane == 0) {
          mbar_arrive(a_empty(as));
          mbar_arrive(b_empty(bs));
        }
      }
      // the warpgroup's staging is free once its last item's stores have read it
      if (tid == 0) tma_store_wait_read();
      named_barrier_sync(2 + w, 128);
      const int r = 16 * warp + g;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        unsigned char* box = sm + L::stg_off + (w * (BN / 64) + col / 64) * L::Y_BOX;
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(m * L::TW + r + 8 * h, col % 64)) =
                __floats2bfloat162_rn(acc[m][4 * nt + 2 * h], acc[m][4 * nt + 2 * h + 1]);
      }
      fence_proxy_async();
      named_barrier_sync(2 + w, 128);
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (n0 + 64 * j < N)
            tma_store_4d(&ymap, base + L::stg_off + (w * (BN / 64) + j) * L::Y_BOX, n0 + 64 * j, iw0, ih0 + MB * w,
                         bi);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_read();
    return;
  }

  if (threadIdx.x >= L::CONSUMERS) {
    // ---------------- producer warpgroup: one thread issues every load
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == L::CONSUMERS) {
      int it = 0;                                  // (chunk, tap) steps, tap inside
      for (int chunk = 0; chunk < chunks; ++chunk) {
        const int c0 = chunk * L::BK;
        if (L::SLAB && !ACT) {                     // K1's slabs: the activation stage loads its own
          const int as = chunk % AST;
          const int2 at = L::a_origin(0, w0, h0);
          mbar_wait_or_trap(a_empty(as), ((chunk / AST) & 1) ^ 1);
          mbar_arrive_expect_tx(a_full(as), L::A_BYTES);
          tma_load_4d(a_stage(as), &xmap, c0, at.x, at.y, b, a_full(as));
        }
        for (int tap = 0; tap < L::TAPS; ++tap, ++it) {
          if (!L::SLAB && tap % L::A_TAPS == 0) {  // K9: a box a tap; K7's dx: a plane's slab every 4 taps
            const int ai = it / L::A_TAPS, as = ai % AST;
            const int2 at = L::a_origin(tap, w0, h0);
            mbar_wait_or_trap(a_empty(as), ((ai / AST) & 1) ^ 1);
            mbar_arrive_expect_tx(a_full(as), L::A_BYTES);
            tma_load_4d(a_stage(as), &xmap, c0, at.x, at.y, b, a_full(as));
          }
          const int bs = it % BST;
          mbar_wait_or_trap(b_empty(bs), ((it / BST) & 1) ^ 1);
          mbar_arrive_expect_tx(b_full(bs), L::B_BYTES);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(b_stage(bs) + j * L::B_BOX, &wmap, n0 + 64 * j, c0, L::w_tap(tap, parity), b_full(bs));
        }
      }
      if (ACT) {
        // K1's projection: ws's two {64 N, 64 Cs} boxes through the B ring
        for (int j = 0; j < proj_steps; ++j, ++it) {
          const int bs = it % BST;
          mbar_wait_or_trap(b_empty(bs), ((it / BST) & 1) ^ 1);
          mbar_arrive_expect_tx(b_full(bs), L::B_BYTES);
#pragma unroll
          for (int jj = 0; jj < BN / 64; ++jj)
            tma_load_3d(b_stage(bs) + jj * L::B_BOX, &pmap, n0 + 64 * jj, j * L::BK, 0, b_full(bs));
        }
      }
      if (epi_tile) {
        // the epilogue's tile (K6: the forward's x; K1: the skip): box k
        // (output rows MB (k / 2) .., channels 64 (k % 2) ..) into B stage
        // (it + k) % BST, each once the consumers have released it
        mbar_arrive_expect_tx(e_full, BST * L::B_BYTES);
        for (int k = 0; k < BST; ++k, ++it) {
          const int bs = it % BST;
          mbar_wait_or_trap(b_empty(bs), ((it / BST) & 1) ^ 1);
          tma_load_4d(b_stage(bs), &emap, n0 + 64 * (k % 2), w0, h0 + MB * (k / 2), b, e_full);
        }
      }
    } else if (ACT && threadIdx.x >= L::CONSUMERS + 32) {
      // ---------------- K1's activation stage, its producer-warp share: slab
      // rows of each chunk as soon as it lands
      const int q = threadIdx.x - L::CONSUMERS - 32;
      const int lc = q % 8;                        // the logical chunk: channels 8 lc .. 8 lc + 7
      const float* ca = act_a + (size_t)b * C;
      const float* cb = act_b + (size_t)b * C;
      // The A ring's loads, issued by the stage's first thread one step
      // ahead of its work (a single producer thread would queue them behind
      // the B ring's, a few taps before the consumers need the slab): the
      // chunks' raw slabs, then K1's projection boxes of the raw skip.
      const int a_steps = chunks + proj_steps;
      auto load_a = [&](int i) {
        const int as = i % AST;
        mbar_wait_or_trap(a_empty(as), ((i / AST) & 1) ^ 1);
        if (i < chunks) {
          mbar_arrive_expect_tx(a_full(as), L::A_BYTES);
          tma_load_4d(a_stage(as), &xmap, i * L::BK, w0 - 1, h0 - 1, b, a_full(as));
        } else {
          mbar_arrive_expect_tx(a_full(as), L::P_BYTES);
          tma_load_4d(a_stage(as), &amap, (i - chunks) * L::BK, w0, h0, b, a_full(as));
        }
      };
      if (q == 0) load_a(0);
      for (int chunk = 0; chunk < chunks; ++chunk) {
        const int s = chunk % AST;
        if (q == 0 && chunk + 1 < a_steps) load_a(chunk + 1);
        float4 a0, a1, e0, e1;
        act_coeffs(ca, cb, chunk, lc, C, a0, a1, e0, e1);
        mbar_wait_or_trap(a_full(s), (chunk / AST) & 1);
        act_rows<L::SW>(sm + L::a_off + s * L::A_STAGE, chunk, C, q / 8, 12, 0, L::STAGE_ROWS, lc, a0, a1, e0, e1, h0,
                        w0, H, W, silu);
        fence_proxy_async();                       // these writes before the consumers' wgmma reads
        mbar_arrive(a_ready(s));
      }
      if (q == 0)
        for (int i = chunks + 1; i < a_steps; ++i) load_a(i);
    }
  } else {
    // ---------------- consumer warpgroups: warpgroup w owns output rows MB w .. MB w + MB - 1
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

    float acc[MB][BN / 2];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.0f;
    // K1: the consumers' share of the activation stage, rows k0 .. k1 - 1 of
    // their slab rows of chunk c; chunk 0's before the first products, chunk
    // c + 1's spread over the taps of chunk c, its coefficients loaded
    // (act_load) before the chunk's first barrier wait
    const int alc = threadIdx.x & 7;
    float4 ka0, ka1, ke0, ke1;
    auto act_load = [&](int c) {
      act_coeffs(act_a + (size_t)b * C, act_b + (size_t)b * C, c, alc, C, ka0, ka1, ke0, ke1);
    };
    auto act_row = [&](int c, int k0, int k1) {
      act_rows<L::SW>(sm + L::a_off + (c % AST) * L::A_STAGE, c, C, 12 * L::STAGE_ROWS + (threadIdx.x >> 3), 32, k0,
                      k1, alc, ka0, ka1, ke0, ke1, h0, w0, H, W, silu);
    };
    if (ACT) {
      act_load(0);
      mbar_wait_or_trap(a_full(0), 0);
      act_row(0, 0, L::TAP_ROWS);
      fence_proxy_async();
      mbar_arrive(a_ready(0));
    }
    int it = 0;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      if (ACT && chunk + 1 < chunks) act_load(chunk + 1);
      if (L::SLAB) mbar_wait_or_trap(ACT ? a_ready(chunk % AST) : a_full(chunk % AST), (chunk / AST) & 1);
      for (int tap = 0; tap < L::TAPS; ++tap, ++it) {
        const int ai = L::SLAB ? chunk : it / L::A_TAPS, as = ai % AST;   // the A box this k-step reads
        if (!L::SLAB && tap % L::A_TAPS == 0) mbar_wait_or_trap(a_full(as), (ai / AST) & 1);
        const int bs = it % BST;
        mbar_wait_or_trap(b_full(bs), (it / BST) & 1);
        const uint32_t a_row = L::a_row(w, tap, pa, pb);
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int kk = 0; kk < L::BK / 16; ++kk)
            wgmma_ss_tb<BN>(acc[m], wgmma_desc(a_stage(as) + (a_row + m * L::AW) * 128 + kk * 32, 16, 1024),
                            wgmma_desc(b_stage(bs) + kk * 2048, L::B_BOX, 1024), 1);
        wgmma_commit();
        if (ACT && chunk + 1 < chunks) {           // while the tap's products run: rows of the next slab
          if (tap == 0) mbar_wait_or_trap(a_full((chunk + 1) % AST), ((chunk + 1) / AST) & 1);
          act_row(chunk + 1, tap * L::TAP_ROWS / L::TAPS, (tap + 1) * L::TAP_ROWS / L::TAPS);
          if (tap == L::TAPS - 1) {
            fence_proxy_async();
            mbar_arrive(a_ready((chunk + 1) % AST));
          }
        }
        // one group stays in flight; the previous one has read its stages
        wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
        if (it > 0 && lane == 0) {
          mbar_arrive(b_empty((it - 1) % BST));
          if (L::SLAB ? tap == 0 : tap % L::A_TAPS == 0)   // the previous k-step read its A box last
            mbar_arrive(a_empty((L::SLAB ? chunk - 1 : (it - 1) / L::A_TAPS) % AST));
        }
      }
    }
    if (ACT) {
      // K1's projection: output row MB w + m is rows (MB w + m) TW .. of the skip box
      for (int j = 0; j < proj_steps; ++j, ++it) {
        const int i = chunks + j, as = i % AST;
        const uint32_t ws_stage = b_stage(it % BST);
        mbar_wait_or_trap(a_full(as), (i / AST) & 1);
        mbar_wait_or_trap(b_full(it % BST), (it / BST) & 1);
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int kk = 0; kk < L::BK / 16; ++kk)
            wgmma_ss_tb<BN>(acc[m], wgmma_desc(a_stage(as) + (MB * w + m) * L::TW * 128 + kk * 32, 16, 1024),
                            wgmma_desc(ws_stage + kk * 2048, L::B_BOX, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
        if (lane == 0) {                           // the previous k-step (the last tap, or a projection step)
          mbar_arrive(b_empty((it - 1) % BST));
          mbar_arrive(a_empty((i - 1) % AST));
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
    if (epi_tile && lane == 0) mbar_arrive(b_empty((it - 1) % BST));   // the last B stage, for the epilogue's tile
    // both warpgroups' products are complete and every load has landed: the
    // rings are free for the output tile
    named_barrier_sync(1, L::CONSUMERS);
    if (epi_tile) mbar_wait_or_trap(e_full, 0);

    // epilogue: the thread's accumulator rows are columns r and r + 8 of output rows MB w + m
    const int r = 16 * warp + g;
    bool in[MB][2];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const bool row_in = h0 + MB * w + m < H;
      in[m][0] = row_in && w0 + r < W;
      in[m][1] = row_in && w0 + r + 8 < W;
    }
    float* red = reinterpret_cast<float*>(sm + L::red_off);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      float b0 = 0.0f, b1 = 0.0f;
      if ((DOWN || ACT || UP) && n0 + col < N) {   // N % 8 == 0: col + 1 is inside too
        b0 = bias[n0 + col];
        b1 = bias[n0 + col + 1];
        if (ACT && skip_mode == SKIP_PROJ) {
          b0 += wsb[n0 + col];
          b1 += wsb[n0 + col + 1];
        }
      }
      unsigned char* box = sm + L::a_off + (w * (BN / 64) + col / 64) * L::Y_BOX;
      // K6's x, K1's skip: box k = the k-th B load after the products
      unsigned char* xbox = sm + L::b_off + ((it + w * (BN / 64) + col / 64) % BST) * L::B_BYTES;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};       // sum, sum, sumsq, sumsq of columns col, col + 1
      if (BWD) {
        // v: (d_t * x, d_t * x, d_t, d_t) of columns col, col + 1
        float a0 = 0.0f, a1 = 0.0f, e0 = 0.0f, e1 = 0.0f;
        if (n0 + col < N) {
          a0 = act_a[(size_t)b * N + n0 + col];
          a1 = act_a[(size_t)b * N + n0 + col + 1];
          e0 = act_b[(size_t)b * N + n0 + col];
          e1 = act_b[(size_t)b * N + n0 + col + 1];
        }
#pragma unroll
        for (int m = 0; m < MB; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t off = sw128_offset(m * L::TW + r + 8 * h, col % 64);
            __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xbox + off);
            const float2 xv = __bfloat1622float2(*xp);
            float d0, d1, g0, g1;
            act_chain(xv.x, a0, e0, acc[m][4 * nt + 2 * h], silu, d0, g0);
            act_chain(xv.y, a1, e1, acc[m][4 * nt + 2 * h + 1], silu, d1, g1);
            *reinterpret_cast<__nv_bfloat162*>(box + off) = __floats2bfloat162_rn(d0 * a0, d1 * a1);
            *xp = __floats2bfloat162_rn(g0, g1);     // A over x: this thread alone reads and writes it
            if (in[m][h]) {
              v[0] += d0 * xv.x;
              v[1] += d1 * xv.y;
              v[2] += d0;
              v[3] += d1;
            }
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t off = sw128_offset(m * L::TW + r + 8 * h, col % 64);
            float y0 = acc[m][4 * nt + 2 * h] + b0, y1 = acc[m][4 * nt + 2 * h + 1] + b1;
            if (ACT && skip_mode == SKIP_ADD) {    // the skip before the one rounding
              const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xbox + off));
              y0 += sv.x;
              y1 += sv.y;
            }
            const __nv_bfloat162 yv = __floats2bfloat162_rn(y0, y1);
            *reinterpret_cast<__nv_bfloat162*>(box + off) = yv;
            if (stats && in[m][h]) {               // statistics of the rounded y inside the image
              const float2 f = __bfloat1622float2(yv);
              v[0] += f.x;
              v[1] += f.y;
              v[2] += f.x * f.x;
              v[3] += f.y * f.y;
            }
          }
        }
      }
      if (stats) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
        if (g == 0) {
          const int wi = 4 * w + warp;
          red[wi * BN + col] = v[0];
          red[wi * BN + col + 1] = v[1];
          red[(8 + wi) * BN + col] = v[2];
          red[(8 + wi) * BN + col + 1] = v[3];
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(2 + w, 128);
    if (tid == 0) {
      const CUtensorMap* ym = UP ? y_view(parity) : &ymap;
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        if (n0 + 64 * j < N)
          tma_store_4d(ym, base + L::a_off + (w * (BN / 64) + j) * L::Y_BOX, n0 + 64 * j, w0, h0 + MB * w, b);
      if (BWD)
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (n0 + 64 * j < N)
            tma_store_4d(&amap, base + L::b_off + ((it + w * (BN / 64) + j) % BST) * L::B_BYTES, n0 + 64 * j, w0,
                         h0 + MB * w, b);
      tma_store_commit_and_wait();
    }
    if (stats) {
      named_barrier_sync(1, L::CONSUMERS);
      const int n = n0 + (int)threadIdx.x;
      if ((int)threadIdx.x < BN && n < N) {
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s0 += red[i * BN + threadIdx.x];
          s1 += red[(8 + i) * BN + threadIdx.x];
        }
        const size_t row = (((size_t)b * (UP ? 4 : 1) + parity) * gridDim.y + tile) * 2;   // K2: T = 4 x tiles
        partial[row * N + n] = s0;
        partial[(row + 1) * N + n] = s1;
      }
    }
  }
}

// The operands beyond x, w and bias. K6's data gradient: the forward's input
// x (B, H, W, N), its coefficients a, b (B, N) fp32, and the activation
// A = act(x*a + b) written out as bf16 (B, H, W, N). K1 and K12: the
// coefficients a, b (B, C) fp32 of the input's activation, and K1's skip:
// skip_mode SKIP_ADD adds skip (B, H, W, N), SKIP_PROJ adds skip (B, H, W,
// Cs) @ ws (Cs, N) + wsb (N,) fp32. silu 0 is the identity.
struct ConvSm90Act {
  const void* x;
  const float* a;
  const float* b;
  void* act;
  int silu;
  const void* skip;
  const void* ws;
  const float* wsb;
  int Cs;
  int skip_mode;
};

// Launches the conv over x (B, Hin, Win, C) and w (3, 3, C, N) into y (B, H,
// W, N): H, W = Hin, Win (K11, K6's dA, K1) or Hin / 2, Win / 2 (K9; K7's
// dx, x = dye, w = wb (4, 4, C, N)); K2: w = Wf (2, 2, 2, 2C, N), y (B, 2H,
// 2W, N) with H, W = Hin, Win; dskip: x = dye (B, H, W, C), w = ws (N, C), y =
// dskip (B, H, W, N). K9, K2, K6 and K1 (when `partial` is given)
// also write the per-tile partials (B, T, 2, N), T = the tiles of one image
// (K2: 4 x, one per parity), and their fixed-order sum `stats` (B, 2, N): K9,
// K2 and K1 (sum, sum of squares) of y, K6 (sum of d_t * x, sum of d_t), with
// y = dx. `op` holds K6's and K1's further operands.
template <int MODE>
int launch_conv_sm90(const void* x, const void* w, const float* bias, void* y, float* partial, float* stats, int T,
                     int B, int Hin, int Win, int C, int N, cudaStream_t stream, const ConvSm90Act* op = nullptr) {
  using L = ConvSm90<MODE>;
  constexpr bool DOWN = L::DOWN, BWD = MODE == CONV_BWD, ACT = L::ACT, UP = L::UP;
  const int H = DOWN || L::DX ? Hin / 2 : Hin, W = DOWN || L::DX ? Win / 2 : Win;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 8 || N < 8 || C % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int tiles_w = (W + L::TW - 1) / L::TW, tiles_h = (H + L::TH - 1) / L::TH;
  if ((long long)tiles_w * tiles_h > 65535) return (int)cudaErrorInvalidValue;
  const bool with_stats = DOWN || BWD || UP || partial != nullptr;
  if (with_stats && (partial == nullptr || stats == nullptr || T != (UP ? 4 : 1) * tiles_w * tiles_h))
    return (int)cudaErrorInvalidValue;
  if ((DOWN || UP) && bias == nullptr) return (int)cudaErrorInvalidValue;
  if ((BWD || ACT) && (op == nullptr || op->a == nullptr || op->b == nullptr)) return (int)cudaErrorInvalidValue;
  int proj_steps = 0;
  if (ACT) {
    if (bias == nullptr || op->skip_mode < SKIP_NONE || op->skip_mode > SKIP_PROJ) return (int)cudaErrorInvalidValue;
    if (op->skip_mode != SKIP_NONE && op->skip == nullptr) return (int)cudaErrorInvalidValue;
    if (op->skip_mode == SKIP_PROJ) {
      if (op->ws == nullptr || op->wsb == nullptr || op->Cs < 8 || op->Cs % 8) return (int)cudaErrorInvalidValue;
      proj_steps = (op->Cs + L::BK - 1) / L::BK;
    }
    // the activation stage reads a and b as float4
    if ((reinterpret_cast<uintptr_t>(op->a) | reinterpret_cast<uintptr_t>(op->b) |
         reinterpret_cast<uintptr_t>(op->skip) | reinterpret_cast<uintptr_t>(op->ws)) & 15)
      return (int)cudaErrorMisalignedAddress;
  }
  CUtensorMap xm, wm, ym, em, am, pm;
  int e;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)Win, (cuuint64_t)Hin, (cuuint64_t)B};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)(L::STRIDE * L::AW), (cuuint32_t)(L::STRIDE * L::AH), 1};
  const cuuint32_t xstride[4] = {1, (cuuint32_t)L::STRIDE, (cuuint32_t)L::STRIDE, 1};
  if ((e = encode_tensor_map(&xm, x, 4, xdims, xbox, xstride))) return e;
  // the weights (N contiguous, boxes {64 N, 64 C} per tap); dskip: ws (N, C)
  // with C contiguous, one {64 C, 128 N} box
  if ((e = L::ONE ? encode_tensor_map_3d(&wm, w, C, N, 1, L::BN) : encode_tensor_map_3d(&wm, w, N, C, L::W_TAPS, 64)))
    return e;
  const cuuint64_t ydims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t ybox[4] = {64, L::TW, L::MB, 1};
  const cuuint32_t ystride[4] = {1, 1, 1, 1};
  if ((e = encode_tensor_map(&ym, y, 4, ydims, ybox, ystride))) return e;
  em = ym;
  am = ym;
  pm = wm;
  if (UP) {
    // parity p = (pa, pb)'s pixels of y (B, 2H, 2W, N), rows 2h + pa and
    // columns 2w + pb, as a (B, H, W, N) tensor: strides of two columns, two
    // rows and an image, in bytes
    const cuuint64_t view_strides[3] = {4ull * N, 8ull * W * N, 8ull * H * W * N};
    CUtensorMap* views[4] = {&ym, &em, &am, &pm};   // the kernel's y_view(p)
    for (int p = 0; p < 4; ++p) {
      const bf16* view = static_cast<const bf16*>(y) + ((size_t)(p >> 1) * 2 * W + (p & 1)) * N;
      if ((e = encode_tensor_map(views[p], view, 4, ydims, ybox, ystride, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                 CU_TENSOR_MAP_SWIZZLE_128B, view_strides)))
        return e;
    }
  }
  if (BWD) {
    if ((reinterpret_cast<uintptr_t>(op->x) | reinterpret_cast<uintptr_t>(op->act)) & 15)
      return (int)cudaErrorMisalignedAddress;
    if ((e = encode_tensor_map(&em, op->x, 4, ydims, ybox, ystride))) return e;
    if ((e = encode_tensor_map(&am, op->act, 4, ydims, ybox, ystride))) return e;
  }
  if (ACT && op->skip_mode == SKIP_ADD && (e = encode_tensor_map(&em, op->skip, 4, ydims, ybox, ystride))) return e;
  if (ACT && op->skip_mode == SKIP_PROJ) {
    const cuuint64_t sdims[4] = {(cuuint64_t)op->Cs, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint32_t sbox[4] = {64, L::TW, L::TH, 1};
    if ((e = encode_tensor_map(&am, op->skip, 4, sdims, sbox, ystride))) return e;
    if ((e = encode_tensor_map_3d(&pm, op->ws, N, op->Cs, 1, 64))) return e;
  }
  // the shared-memory opt-in, once per device
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= 64 || !((opted_in >> dev) & 1)) {
    ce = cudaFuncSetAttribute(conv_sm90_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (ce != cudaSuccess) return (int)ce;
    if (dev < 64) opted_in |= (uint64_t)1 << dev;
  }
  dim3 grid((UP ? 4 : 1) * ((N + L::BN - 1) / L::BN), tiles_w * tiles_h, B);
  if (L::ONE) {                                    // dskip: about one block an SM, each walking its (image, tile) items
    int sms = 0;
    if ((ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)ce;
    const long long items = (long long)B * tiles_w * tiles_h;
    const int per_tile = grid.x > 0 && sms >= (int)grid.x ? sms / (int)grid.x : 1;   // blocks per N tile
    grid.y = (unsigned)(items < per_tile ? items : per_tile);
    grid.z = 1;
  }
  conv_sm90_kernel<MODE><<<grid, L::THREADS, L::bytes, stream>>>(
      xm, wm, ym, em, am, pm, bias, op != nullptr ? op->a : nullptr, op != nullptr ? op->b : nullptr,
      ACT && op->skip_mode == SKIP_PROJ ? op->wsb : nullptr, op != nullptr ? op->silu : 0,
      ACT ? op->skip_mode : SKIP_NONE, proj_steps, with_stats ? partial : nullptr, H, W, C, N, tiles_w, B);
  ce = cudaGetLastError();
  if (ce != cudaSuccess || !with_stats) return (int)ce;
  stats_reduce_kernel<<<dim3((N + 31) / 32, B), dim3(32, 32), 0, stream>>>(partial, stats, T, N);
  return (int)cudaGetLastError();
}

}  // namespace
