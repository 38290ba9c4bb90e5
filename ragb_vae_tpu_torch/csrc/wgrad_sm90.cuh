// The weight gradients of K6 and K7 for Hopper (sm_90a): a split-K GEMM over
// pixels, fed by TMA through an mbarrier ring and computed by wgmma by two
// warpgroups per block.
//
// Replaces the weight-gradient half of the TPU kernel K6 `_bwd_kernel`
// (ragb_vae_tpu/ops/pallas/resnet_block.py:952; entry
// `ragb_resnet_conv3x3_stats_bwd` in resnet_block_bwd.cu):
//   dW[u][v][c][n] = sum over pixels (b, h, w) of A[b][h+u-1][w+v-1][c] * dye[b][h][w][n]
// (TAPS = 3, one tap row u per block, A zero outside the image), and the
// projection's dws[c][n] = sum of skip[b][h][w][c] * dye[b][h][w][n] (TAPS =
// 1); and the weight-gradient half of K7 `_subpixel_bwd_kernel` (:2003;
// entry `ragb_subpixel_upsample_conv3x3_stats_bwd`), the gradient of the
// folded weights of the sub-pixel upsample conv (TAPS = SUBPIXEL_TAPS = 2):
//   dWf[pa][pb][u][v][c][n] = sum over small-grid pixels (b, h, w) of
//       x[b][h+pa+u-1][w+pb+v-1][c] * dye[b][2h+pa][2w+pb][n]
// one group (pa, pb, u) of 8 per block with its two column taps v, raw x as
// A (K2 has no activation: TMA's zero fill is the padding), dye's parity
// pixels read by a box at traversal stride 2 along W. A is the activation
// act(x*a + b) rounded to bf16, which K6's data
// gradient writes in its epilogue (conv_sm90.cuh): SAME padding zeroes A,
// not x, so A comes in materialised and TMA's zero fill of its boxes IS the
// padding. (Applying the activation to x in shared memory would make the
// zero-filled halo silu(b); applying it per tap in registers, as K10 converts
// its weights, costs about as many exps a k-step as the k-step's products
// take cycles.)
//
// What bounds it on the H100: 2 * 9 * C * N operations per pixel against
// (C + N) * 2 bytes per pixel: tensor-core operations (0.31 ms at
// (4,128,128,512)->512 and 989 TFLOP/s), far above the bf16 ridge. K7's:
// 2 * 16 * C * N per small-grid pixel, 0.14 TFLOP at (4,64,64,512)->512
// against ~84 MB of x and dye (0.139 ms, operations).
//
// What the design does about it:
// - M = 128 input channels c (64 per consumer warpgroup), N = 128 output
//   channels n, K = pixels, 64 (one image row's run) per k-step. Both
//   operands are MN-major (pixels are the outer dimension of NHWC), so the
//   products are wgmma m64n128k16 with A and B both transposed
//   (`wgmma_ss_tatb`): no transpose pass, dW lands as (c, n).
// - One block covers the three column taps v of its tap row u: its A slab is
//   the 64 + 2 pixels w0 - 1 .. w0 + 64 of row h + u - 1, a TMA box {64 c,
//   66 pixels} per 64 channels in 128-byte swizzle, and tap v's operand is
//   the same slab started v rows (v * 128 bytes) in: the swizzle follows the
//   address bits, as K11's row offsets rely on. Per k-step the block reads
//   ~34 KB (two A slabs, two dye boxes {64 n, 64 pixels}) for 6.3 MFLOP:
//   ~190 FLOP per byte from L2, ~5 TB/s at the tensor-core peak (a block per
//   tap would need ~3x that; a box per tap was L2-bound in the conv engine).
//   Each thread holds three m64n128 fp32 accumulators (192 registers), so
//   the block is the two warpgroups alone, 8 warps, two on each SM
//   sub-partition, which lets every thread hold up to 255 registers: a
//   producer warp or warpgroup beside them puts three warps on one
//   sub-partition, ptxas allots 168 registers a thread and spills the
//   accumulators, serialising the wgmmas (1.8 ms at (4,128,128,512)->512
//   with 384 threads, 6.6 ms with 288).
// - K7: group (pa, pb, u)'s A slab is the BK + 1 pixels w0 + pb - 1 .. of x's
//   row h + pa + u - 1, tap v's operand v rows in; its B the dye pixels
//   (2h + pa, 2w + pb), a box {64 n, 2 BK} from (n0, 2 w0 + pb, 2h + pa, b)
//   at traversal stride 2 along W, which lands as BK rows. Two m64n128
//   accumulators a thread (128 registers). Per k-step ~33 KB for 4.2 MFLOP.
// - A ring of STAGES stages on full mbarriers. Thread 0 issues the loads
//   STAGES - 1 k-steps ahead: at step i, once all 8 warps have passed a
//   named barrier after their wait for step i - 1's wgmma group (so nothing
//   reads that stage any more), it loads step i - 1 + STAGES there. The
//   warps keep one wgmma group in flight. (Thread 0 polling an empty
//   mbarrier instead put a loop on a divergent path, and ptxas serialised
//   the wgmmas around it.) Rows whose A row lies outside the image are
//   skipped.
// - Split-K: the grid's z dimension is (slice, group: K6's tap row, K7's
//   (pa, pb, u)); slice s sums the image rows of its share of B * H and
//   writes its fp32 partial (S, GROUPS, TAPS, C, N) (K7: (S, 2, 2, 2, 2C, N),
//   dWf's layout) with masked stores straight from the accumulators;
//   `sum_slices_kernel` adds the S partials in a fixed order, four floats a
//   thread (one thread per row of 1024 did not keep the memory busy: 0.31 ms
//   for 84 MB). No float atomics: bit-for-bit reproducible.
// Ragged C, N, W: TMA zero-fills A and dye past the tensor (zero products);
// the stores are masked. C and N must be multiples of 8 (TMA's 16-byte
// strides). Every barrier wait traps after 2^22 polls.
#pragma once

#include "sm90.cuh"

namespace {

// K7's taps: the folded weights' two column taps v of a group (pa, pb, u)
constexpr int SUBPIXEL_TAPS = 2;

template <int TAPS>
struct WgradSm90 {
  static constexpr bool UP = TAPS == SUBPIXEL_TAPS;  // K7
  static constexpr int GROUPS = UP ? 8 : TAPS;       // one per block: K6's tap rows, K7's (pa, pb, u)
  static constexpr int BM = 128, BN = 128;           // input channels c, output channels n of a block
  static constexpr int BK = 64;                      // pixels of a k-step
  static constexpr int A_ROWS = BK + TAPS - 1;       // the slab: the k-step's pixels and the taps' halo
  static constexpr int A_BOX = A_ROWS * 128;         // one {64 c, A_ROWS} box
  static constexpr int A_SLOT = (A_BOX + 1023) / 1024 * 1024;
  static constexpr int D_BOX = BK * 128;             // one {64 n, BK} box of dye
  static constexpr int STAGE = 2 * A_SLOT + (BN / 64) * D_BOX;
  static constexpr int STAGES = 6;
  static constexpr int bar_off = STAGES * STAGE;
  static constexpr int bytes = bar_off + STAGES * 8 + 1024;   // + alignment slack
  static constexpr int THREADS = 256;
  static_assert(bytes <= 232448, "shared memory");
};

// Grid (C tiles, N tiles, S * GROUPS): block z = slice * GROUPS + group.
// H, W: the small grid's for K7 (x (B, H, W, C), dye (B, 2H, 2W, N)).
template <int TAPS>
__global__ void __launch_bounds__(WgradSm90<TAPS>::THREADS, 1)
    wgrad_sm90_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap dmap,
                      float* __restrict__ partial, int B, int H, int W, int C, int N, int S) {
  using L = WgradSm90<TAPS>;
  constexpr int ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char wgrad_sm90_smem[];
  const uint32_t raw = smem_addr(wgrad_sm90_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::bar_off;
  auto full = [&](int s) { return bars + 8 * s; };
  auto stage = [&](int s) { return base + s * L::STAGE; };

  const int c0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const int u = blockIdx.z % L::GROUPS, slice = blockIdx.z / L::GROUPS;
  const int pa = L::UP ? u >> 2 : 0, pb = L::UP ? u >> 1 & 1 : 0;   // K7: group u = (pa, pb, u & 1)
  // A row = h + row_off, tap v's A column = w + col_off + v
  const int row_off = L::UP ? pa + (u & 1) - 1 : TAPS == 3 ? u - 1 : 0;
  const int col_off = L::UP ? pb - 1 : -(TAPS - 1) / 2;
  const int rows = B * H;
  const int rps = (rows + S - 1) / S;
  const int row_begin = slice * rps, row_end = min(rows, row_begin + rps);
  const int steps_per_row = (W + L::BK - 1) / L::BK;
  auto row_used = [&](int row) {                     // a zero row of A adds nothing
    const int ar = row % H + row_off;
    return ar >= 0 && ar < H;
  };
  int steps = 0;
  for (int row = row_begin; row < row_end; ++row) steps += row_used(row) ? steps_per_row : 0;

  const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // thread 0's load cursor: the next k-step to load is (lrow, lk)
  int lrow = row_begin, lk = 0;
  auto load = [&](int it) {
    if (!row_used(lrow)) ++lrow;                     // H >= 2 when a row is used: never two skipped in a row
    const int b = lrow / H, h = lrow % H, s = it % ST, w0 = lk * L::BK;
    mbar_arrive_expect_tx(full(s), 2 * L::A_BOX + (L::BN / 64) * L::D_BOX);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      tma_load_4d(stage(s) + j * L::A_SLOT, &amap, c0 + 64 * j, w0 + col_off, h + row_off, b, full(s));
#pragma unroll
    for (int j = 0; j < L::BN / 64; ++j)   // K7: dye pixels (2h + pa, 2w + pb)
      tma_load_4d(stage(s) + 2 * L::A_SLOT + j * L::D_BOX, &dmap, n0 + 64 * j, L::UP ? 2 * w0 + pb : w0,
                  L::UP ? 2 * h + pa : h, b, full(s));
    if (++lk == steps_per_row) {
      lk = 0;
      ++lrow;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
    for (int it = 0; it < min(ST, steps); ++it) load(it);
  }
  __syncthreads();

  // warpgroup w owns input channels c0 + 64 w ..
  float acc[TAPS][L::BN / 2];
#pragma unroll
  for (int v = 0; v < TAPS; ++v)
#pragma unroll
    for (int i = 0; i < L::BN / 2; ++i) acc[v][i] = 0.0f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % ST;
    mbar_wait_or_trap(full(s), (it / ST) & 1);
    const uint32_t a_slab = stage(s) + w * L::A_SLOT, d_box = stage(s) + 2 * L::A_SLOT;
#pragma unroll
    for (int v = 0; v < TAPS; ++v) fence_regs(acc[v]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk)
#pragma unroll
      for (int v = 0; v < TAPS; ++v)
        // tap v's A: the slab from row v (pixel w0 + v - 1 for TAPS = 3)
        wgmma_ss_tatb<L::BN>(acc[v], wgmma_desc(a_slab + v * 128 + kk * 2048, L::A_SLOT, 1024),
                             wgmma_desc(d_box + kk * 2048, L::D_BOX, 1024), 1);
    wgmma_commit();
    // one group stays in flight; the previous one has read its stage
    wgmma_wait<1>();
#pragma unroll
    for (int v = 0; v < TAPS; ++v) fence_regs(acc[v]);
    if (it > 0 && it - 1 + ST < steps) {
      named_barrier_sync(1, L::THREADS);             // step it - 1's stage is read by no warp any more
      if (threadIdx.x == 0) load(it - 1 + ST);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int v = 0; v < TAPS; ++v) fence_regs(acc[v]);

  // accumulator element i: row c = 16 warp + g + 8 ((i / 2) % 2), column n = 8 (i / 4) + 2 t + i % 2
#pragma unroll
  for (int v = 0; v < TAPS; ++v) {
    float* out = partial + (((size_t)slice * L::GROUPS + u) * TAPS + v) * C * N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 64 * w + 16 * warp + g + 8 * hh;
      if (c >= C) continue;
#pragma unroll
      for (int nt = 0; nt < L::BN / 8; ++nt) {
        const int n = n0 + nt * 8 + 2 * t;
        if (n < N)                                     // N % 8 == 0: n + 1 < N too
          *reinterpret_cast<float2*>(out + (size_t)c * N + n) =
              make_float2(acc[v][4 * nt + 2 * hh], acc[v][4 * nt + 2 * hh + 1]);
      }
    }
  }
}

// out[m] = sum over r < S of partial[r * M + m], r in order; four floats a
// thread (M % 4 == 0).
__global__ void sum_slices_kernel(const float4* __restrict__ partial, float4* __restrict__ out, int S, size_t M4) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M4) return;
  float4 s = partial[m];
  for (int r = 1; r < S; ++r) {
    const float4 v = partial[(size_t)r * M4 + m];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[m] = s;
}

// Launches the split-K weight gradient of act (B, H, W, C) bf16 against dye
// (B, H, W, N) bf16 (K7: x against dye (B, 2H, 2W, N)) into S fp32 partials
// (S, GROUPS, TAPS, C, N) and their fixed-order sum dw (GROUPS, TAPS, C, N).
template <int TAPS>
int launch_wgrad_sm90(const void* act, const void* dye, float* partial, float* dw, int S, int B, int H, int W,
                      int C, int N, cudaStream_t stream) {
  using L = WgradSm90<TAPS>;
  if (B < 1 || H < 1 || W < 1 || C < 8 || N < 8 || C % 8 || N % 8 || S < 1 ||
      (long long)S * L::GROUPS > 65535 || (C + L::BM - 1) / L::BM > 65535 || (N + L::BN - 1) / L::BN > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(act) | reinterpret_cast<uintptr_t>(dye)) & 15)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap am, dm;
  int e;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t adims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t abox[4] = {64, (cuuint32_t)L::A_ROWS, 1, 1};
  if ((e = encode_tensor_map(&am, act, 4, adims, abox, ones))) return e;
  const int up = L::UP ? 2 : 1;                      // K7: dye on the upsampled grid, read every other column
  const cuuint64_t ddims[4] = {(cuuint64_t)N, (cuuint64_t)(up * W), (cuuint64_t)(up * H), (cuuint64_t)B};
  const cuuint32_t dbox[4] = {64, (cuuint32_t)(up * L::BK), 1, 1};
  const cuuint32_t dstride[4] = {1, (cuuint32_t)up, 1, 1};
  if ((e = encode_tensor_map(&dm, dye, 4, ddims, dbox, dstride))) return e;
  // the shared-memory opt-in, once per device
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= 64 || !((opted_in >> dev) & 1)) {
    ce = cudaFuncSetAttribute(wgrad_sm90_kernel<TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (ce != cudaSuccess) return (int)ce;
    if (dev < 64) opted_in |= (uint64_t)1 << dev;
  }
  dim3 grid((C + L::BM - 1) / L::BM, (N + L::BN - 1) / L::BN, S * L::GROUPS);
  wgrad_sm90_kernel<TAPS><<<grid, L::THREADS, L::bytes, stream>>>(am, dm, partial, B, H, W, C, N, S);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const size_t m4 = (size_t)L::GROUPS * TAPS * C * N / 4;
  sum_slices_kernel<<<(unsigned)((m4 + 255) / 256), 256, 0, stream>>>(reinterpret_cast<const float4*>(partial),
                                                                      reinterpret_cast<float4*>(dw), S, m4);
  return (int)cudaGetLastError();
}

}  // namespace
