// Weight-only int8 matmul for Hopper (sm_90a): y = (x @ W^T) * scale + bias.
//
// Replaces the TPU kernel `_kernel` of ragb_vae_tpu/ops/pallas/int8_matmul.py
// (driven by `_int8_matmul_impl`, entry `int8_matmul`): x (M, K) bf16 or fp32,
// int8 weights with one fp32 scale per output channel, optional fp32 bias,
// fp32 accumulation, scale and bias applied once to the accumulator, and ONE
// rounding of the result to x's dtype. int8 magnitudes are exact in bf16, so
// the products are the exact products of x and the stored integers.
//
// Layout: the weights come as (N, K) row-major (one output channel per row,
// as nn.Linear keeps its weight), not the JAX package's (K, N). They are
// never reordered in memory: the backward, the checkpoints and the JAX
// carry-across share that layout.
//
// What bounds it on the H100: two regimes, two kernels.
// * M > 8 and bf16 x (`int8_wgmma_kernel`, the token streams: M = 512 ..
//   8704): 2*M*N*K operations against M*K*2 + N*K + M*N*2 bytes is far above
//   the bf16 ridge (~295 FLOP/byte): tensor-core operations bound it, and
//   only wgmma reaches their rate. The kernel computes y^T tiles, so that the
//   narrow operand sits in registers (as CUTLASS's Hopper mixed-input GEMM
//   does): a block owns 128 channels x BM tokens (BM 256, or 128 where that
//   fills the 132 SMs better, as the text stream's 512 tokens need); each of
//   two consumer warpgroups runs wgmma m64nBMk16 with its 64 weight rows as
//   the register A operand and x as the K-major B operand in shared memory.
//   One producer warp keeps a ring of TMA loads in flight (per 64 k: an x box
//   {64 bf16, BM} in 128-byte swizzle and a weight box {64 int8, 128} in
//   64-byte swizzle), on full and empty mbarriers; setmaxnreg gives the
//   producer's registers to the consumers. Each weight value is turned into
//   bf16 once per block, in the registers of the one thread that feeds it to
//   wgmma, and the conversion of k-step s + 1 (four 2-byte shared loads, a
//   byte permute, two logic ops and one bf16x2 add per pair, exact) runs
//   while the wgmma of step s does. No dequantised weight is ever written.
//   Epilogue: scale and bias per row of y^T (per output channel), one
//   rounding to bf16, a transposing stmatrix into the drained ring, one TMA
//   store per warpgroup. TMA's zero fill and clipping cover the M, N and K
//   tails. Blocks run in groups of 16 channel tiles, channel tiles fastest
//   inside a group: the group's weights stay in L2 while its token tiles
//   pass, so the weights cross HBM once, and each x tile is read by adjacent
//   blocks. One owner per output tile, no split-K: bit-for-bit reproducible.
// * M <= 8, or fp32 x (`int8_gemv_kernel`, the AdaLN modulation, norm_out
//   and the embedders: M = batch): every weight byte is used M times, so the
//   N*K weight bytes bound it (56.6 MB for 3072 -> 18432, 0.017 ms). A block
//   stages x (up to 8 rows) in shared memory as fp32, 8192 / rows k at a
//   time, read once per block; each of its 8 warps streams 4 weight rows with
//   16-byte loads (two pieces of each row in flight per lane, the first
//   issued before x is staged) and accumulates up to 8 rows in fp32 FMAs
//   (an fp32 x stays fp32: a tensor-core pass would round it to bf16 and
//   change the result), then sums each lane's partials in a fixed butterfly.
// K must be a multiple of 16 and N of 8: TMA's 16-byte global strides for the
// int8 weight rows and the bf16 y rows, and the 16-byte weight loads of the
// skinny kernel. The wrapper checks both.

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// int8 -> bf16 and int8 -> fp32, exactly
// ---------------------------------------------------------------------------
// Two int8 (bytes 0 and 1 of `pair`) -> bf16x2. With q = (q & 127) - 128 s (s
// the sign bit), 0x4300 | (q & 127) is the bf16 128 + (q & 127) and
// 0xC300 | (q & 128) is -(128 + 128 s): their sum is q, an integer that bf16
// holds exactly, so the add rounds nothing.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t pair) {
  const uint32_t spread = __byte_perm(pair, 0u, 0x4140);          // q0 and q1 in the low bytes of the halves
  const uint32_t mag = (spread & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (spread & 0x00800080u) | 0xC300C300u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(mag), "r"(0x3F803F80u), "r"(off));
  return out;
}

// four packed int8 -> four floats, without the conversion unit:
// 0x4B000000 | (q ^ 0x80) is the float 2^23 + q + 128
__device__ __forceinline__ void int8x4_to_float4(uint32_t packed, float* f) {
  const uint32_t biased = packed ^ 0x80808080u;   // q + 128 in every byte
  constexpr float MAGIC = 8388736.0f;             // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650)) - MAGIC;
  f[1] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7651)) - MAGIC;
  f[2] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7652)) - MAGIC;
  f[3] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7653)) - MAGIC;
}

// ---------------------------------------------------------------------------
// the tensor-core kernel: y^T tiles of 128 channels x BM tokens
// ---------------------------------------------------------------------------
template <int BM>
struct Int8Gemm {
  static constexpr int BN = 128;                  // output channels of a block: 64 per consumer warpgroup
  static constexpr int BK = 64;                   // k of a ring stage: a 128-byte x row, a 64-byte weight row
  static constexpr int STAGES = BM == 256 ? 4 : 6;
  static constexpr int X_BYTES = BM * 128;        // x box {64 bf16, BM tokens}, 128-byte swizzle
  static constexpr int W_BYTES = BN * 64;         // weight box {64 int8, 128 channels}, 64-byte swizzle
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int Y_BOX = BM * 128;          // y {64 channels, BM tokens} of one warpgroup, bf16
  static constexpr int bar_off = STAGES * STAGE;
  static constexpr int bytes = bar_off + 2 * STAGES * 8 + 1024;   // + alignment slack
  static constexpr int CONSUMERS = 256, THREADS = 384;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int GROUP = 16;                // channel tiles of a raster group
  static_assert(STAGE % 1024 == 0, "every box starts on a 1024-byte boundary");
  static_assert(bytes <= 232448, "shared memory");
  static_assert(2 * Y_BOX <= bar_off, "the output tile is staged in the drained ring");
};

// The int8 pairs of the A fragment of k-step s (0..3) of a stage's weight
// box, for the thread's weight rows `row` and row + 8 (16-byte chunk c of row
// r sits at chunk c ^ ((r >> 1) & 3) in the 64-byte swizzle): q[0], q[1] = k
// 2t, 2t + 1 of the two rows, q[2], q[3] = k 2t + 8, 2t + 9.
__device__ __forceinline__ void load_q(const unsigned char* wbox, int row, int s, int t, uint32_t (&q)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const unsigned char* p = wbox + r * 64 + ((s ^ (r >> 1)) & 3) * 16 + 2 * t;
    q[h] = *reinterpret_cast<const uint16_t*>(p);
    q[2 + h] = *reinterpret_cast<const uint16_t*>(p + 8);
  }
}

__device__ __forceinline__ void to_a(const uint32_t (&q)[4], uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = int8x2_to_bf16x2(q[i]);
}

template <int BM>
__global__ void __launch_bounds__(Int8Gemm<BM>::THREADS, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap ymap, const float* __restrict__ scale,
                      const float* __restrict__ bias, int M, int N, int K) {
  using L = Int8Gemm<BM>;
  constexpr int ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char int8_gemm_smem[];
  const uint32_t raw = smem_addr(int8_gemm_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = int8_gemm_smem + (base - raw);
  const uint32_t bars = base + L::bar_off;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  auto x_stage = [&](int s) { return base + s * L::STAGE; };
  auto w_stage = [&](int s) { return sm + s * L::STAGE + L::X_BYTES; };

  // raster: groups of GROUP channel tiles; inside a group the channel tile
  // runs fastest, then the token tile
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + L::BN - 1) / L::BN;
  const int per_group = L::GROUP * tiles_m;
  const int group = blockIdx.x / per_group, first_n = group * L::GROUP;
  const int width = min(L::GROUP, tiles_n - first_n);
  const int within = blockIdx.x - group * per_group;
  const int n0 = (first_n + within % width) * L::BN;
  const int m0 = (within / width) * BM;
  const int chunks = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                      // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::CONSUMERS) {
    // ---------------- producer warpgroup: one thread issues every load
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == L::CONSUMERS) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % ST;
        mbar_wait_or_trap(empty(s), ((c / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE);
        tma_load_3d(x_stage(s), &xmap, c * L::BK, m0, 0, full(s));
        tma_load_3d(x_stage(s) + L::X_BYTES, &wmap, c * L::BK, n0, 0, full(s));
      }
    }
  } else {
    // ---------------- consumer warpgroups: warpgroup w owns channels n0 + 64 w .. + 63
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row = 64 * w + 16 * warp + g;        // the thread's weight rows: row and row + 8

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
    uint32_t a[2][4], q[4];
    mbar_wait_or_trap(full(0), 0);
    load_q(w_stage(0), row, 0, t, q);
    to_a(q, a[0]);
    for (int c = 0; c < chunks; ++c) {
      const int st = c % ST;
#pragma unroll
      for (int s = 0; s < L::BK / 16; ++s) {
        fence_regs(acc);
        fence_regs(a);
        wgmma_fence();
        wgmma_rs<BM>(acc, a[s & 1], wgmma_desc(x_stage(st) + 32 * s, 16, 1024), 1);
        wgmma_commit();
        // the next k-step's int8 pairs, read while this product runs
        const bool more = s + 1 < L::BK / 16 || c + 1 < chunks;
        if (s + 1 < L::BK / 16) {
          load_q(w_stage(st), row, s + 1, t, q);
        } else if (more) {
          const int nx = (c + 1) % ST;
          mbar_wait_or_trap(full(nx), ((c + 1) / ST) & 1);
          load_q(w_stage(nx), row, 0, t, q);
        }
        // one product stays in flight: the previous one has completed, so its
        // fragment may be overwritten and its stage handed back
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(a);
        if (s == 0 && c > 0 && lane == 0) mbar_arrive(empty((c - 1) % ST));
        if (more) to_a(q, a[(s + 1) & 1]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // both warpgroups' products are complete and every load has landed: the
    // ring is free for the output tile
    named_barrier_sync(1, L::CONSUMERS);

    // epilogue: the thread's rows of y^T are channels row and row + 8;
    // accumulator 4j + 2h + e is channel row + 8h, token 8j + 2t + e
    float sc[2], bi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row + 8 * h;
      sc[h] = n < N ? scale[n] : 0.0f;
      bi[h] = bias != nullptr && n < N ? bias[n] : 0.0f;
    }
    // lane l addresses row l % 8 of matrix l / 8: token block j + (l / 8) / 2,
    // channels 8 ((l / 8) % 2) on from the warp's 16
    const uint32_t box = base + w * L::Y_BOX;
    const int mat = lane >> 3, col = 16 * warp + 8 * (mat & 1);
#pragma unroll
    for (int j = 0; j < BM / 8; j += 2) {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, e = 4 * j + 4 * (i >> 1) + 2 * h;
        r[i] = pack_bf16x2(acc[e] * sc[h] + bi[h], acc[e + 1] * sc[h] + bi[h]);
      }
      const int token = 8 * (j + (mat >> 1)) + (lane & 7);
      stmatrix_x4_trans(box + sw128_offset(token, col), r[0], r[1], r[2], r[3]);
    }
    fence_proxy_async();
    named_barrier_sync(2 + w, 128);
    if (tid == 0) {
      if (n0 + 64 * w < N) tma_store_3d(&ymap, box, n0 + 64 * w, m0, 0);
      tma_store_commit_and_wait();
    }
  }
}

// the token tile that runs the fewest waves of blocks, a block's fixed cost
// (ring fill, epilogue) counted as 64 tokens of products
int pick_bm(int M, int N, int sms) {
  const long long tiles_n = (N + 127) / 128;
  const int candidates[2] = {256, 128};
  long long best_cost = -1;
  int best = 256;
  for (int bm : candidates) {
    const long long waves = ((M + bm - 1) / bm * tiles_n + sms - 1) / sms;
    const long long cost = waves * (bm + 64);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = bm;
    }
  }
  return best;
}

template <int BM>
int launch_wgmma(const void* x, const void* w, const float* scale, const float* bias, void* y, int M, int N, int K,
                 cudaStream_t stream) {
  using L = Int8Gemm<BM>;
  CUtensorMap xm, wm, ym;
  int e;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t xdims[3] = {(cuuint64_t)K, (cuuint64_t)M, 1};
  const cuuint32_t xbox[3] = {64, BM, 1};
  if ((e = encode_tensor_map(&xm, x, 3, xdims, xbox, ones))) return e;
  const cuuint64_t wdims[3] = {(cuuint64_t)K, (cuuint64_t)N, 1};
  const cuuint32_t wbox[3] = {64, L::BN, 1};
  if ((e = encode_tensor_map(&wm, w, 3, wdims, wbox, ones, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                             CU_TENSOR_MAP_SWIZZLE_64B)))
    return e;
  const cuuint64_t ydims[3] = {(cuuint64_t)N, (cuuint64_t)M, 1};
  const cuuint32_t ybox[3] = {64, BM, 1};
  if ((e = encode_tensor_map(&ym, y, 3, ydims, ybox, ones))) return e;
  cudaError_t ce = cudaFuncSetAttribute(int8_wgmma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return (int)ce;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + L::BN - 1) / L::BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int8_wgmma_kernel<BM><<<(unsigned)tiles, L::THREADS, L::bytes, stream>>>(xm, wm, ym, scale, bias, M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the skinny kernel: 8 warps x 4 channels a block, x staged once per block
// ---------------------------------------------------------------------------
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_CH = 4;              // output channels of a warp
constexpr int GEMV_X_FLOATS = 8192;     // x in shared memory: ROWS rows of 8192 / ROWS k (32 KB)
constexpr int SKINNY_MAX_M = 8;         // bf16 x with more rows goes to the tensor-core kernel

// The x chunk lies in shared memory as fp32 rows of KC. Lane l reads the
// 16 values from k = 16 l on as four 16-byte pieces, 64 bytes from its
// neighbour's: piece j of lane l is stored at piece j ^ ((l >> 1) & 3) of its
// 64 bytes, so the eight lanes of one shared-memory phase hit eight distinct
// 16-byte bank groups.
__device__ __forceinline__ int xs_swz(int k) { return k ^ (((k >> 5) & 3) << 2); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// rows m0 .. m0 + ROWS - 1 of x, k = kc .. kc + klen - 1, into xs as fp32
// (rows past M as zeros)
template <typename T, int ROWS>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs, int m0, int rows, int K, int kc,
                                        int klen) {
  constexpr int KC = GEMV_X_FLOATS / ROWS;
  const int per_row = klen / 4;
  for (int i = threadIdx.x; i < ROWS * per_row; i += GEMV_WARPS * 32) {
    const int r = i / per_row, k = 4 * (i - r * per_row);
    const float4 v = r < rows ? load4(x + (size_t)(m0 + r) * K + kc + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(xs + r * KC + xs_swz(k)) = v;
  }
}

// 16 int8 weights of each of the warp's channels from k on (zeros past N)
__device__ __forceinline__ void load_w16(const int8_t* __restrict__ w, int n0, int N, size_t k, int K,
                                         int4 (&wv)[GEMV_CH]) {
#pragma unroll
  for (int c = 0; c < GEMV_CH; ++c)
    wv[c] = n0 + c < N ? __ldg(reinterpret_cast<const int4*>(w + (size_t)(n0 + c) * K + k)) : make_int4(0, 0, 0, 0);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
    int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y, int M, int N, int K) {
  constexpr int KC = GEMV_X_FLOATS / ROWS;
  extern __shared__ __align__(16) float gemv_xs[];   // [ROWS][KC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_CH;
  const int m0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, M - m0);
  float acc[ROWS][GEMV_CH];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < GEMV_CH; ++c) acc[r][c] = 0.0f;

  for (int kc = 0; kc < K; kc += KC) {
    const int klen = min(KC, K - kc);
    // the chunk's first weights are in flight while x is staged
    int4 wv[GEMV_CH];
    if (lane * 16 < klen) load_w16(w, n0, N, kc + lane * 16, K, wv);
    __syncthreads();                               // every warp has read the previous chunk
    stage_x<T, ROWS>(x, gemv_xs, m0, rows, K, kc, klen);
    __syncthreads();
    for (int k = lane * 16; k < klen; k += 32 * 16) {
      int4 next[GEMV_CH];                          // one piece ahead
      if (k + 32 * 16 < klen) load_w16(w, n0, N, kc + k + 32 * 16, K, next);
      float wf[GEMV_CH][16];
#pragma unroll
      for (int c = 0; c < GEMV_CH; ++c) {
        int8x4_to_float4((uint32_t)wv[c].x, wf[c]);
        int8x4_to_float4((uint32_t)wv[c].y, wf[c] + 4);
        int8x4_to_float4((uint32_t)wv[c].z, wf[c] + 8);
        int8x4_to_float4((uint32_t)wv[c].w, wf[c] + 12);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(gemv_xs + r * KC + xs_swz(k + 4 * j));
#pragma unroll
          for (int c = 0; c < GEMV_CH; ++c) {
            acc[r][c] = fmaf(xv.x, wf[c][4 * j], acc[r][c]);
            acc[r][c] = fmaf(xv.y, wf[c][4 * j + 1], acc[r][c]);
            acc[r][c] = fmaf(xv.z, wf[c][4 * j + 2], acc[r][c]);
            acc[r][c] = fmaf(xv.w, wf[c][4 * j + 3], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < GEMV_CH; ++c) wv[c] = next[c];
    }
  }
#pragma unroll
  for (int c = 0; c < GEMV_CH; ++c) {
    const int n = n0 + c;
    const float s = n < N ? scale[n] : 0.0f;
    const float b = bias != nullptr && n < N ? bias[n] : 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float total = warp_sum(acc[r][c]);      // butterfly: the same order on every run
      if (lane == 0 && r < rows && n < N) store_out(y + (size_t)(m0 + r) * N + n, total * s + b);
    }
  }
}

template <typename T, int ROWS>
int launch_gemv_rows(const void* x, const void* w, const float* scale, const float* bias, void* y, int M, int N,
                     int K, cudaStream_t stream) {
  constexpr int smem = GEMV_X_FLOATS * (int)sizeof(float);
  cudaError_t ce = cudaFuncSetAttribute(int8_gemv_kernel<T, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((N + GEMV_WARPS * GEMV_CH - 1) / (GEMV_WARPS * GEMV_CH), (M + ROWS - 1) / ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int8_gemv_kernel<T, ROWS><<<grid, GEMV_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, bias, static_cast<T*>(y), M, N, K);
  return (int)cudaGetLastError();
}

// the row block is the least power of two >= M, up to 8 (fp32 x with more
// rows runs in blocks of 8)
template <typename T>
int launch_gemv(const void* x, const void* w, const float* scale, const float* bias, void* y, int M, int N, int K,
                cudaStream_t stream) {
  if (M <= 1) return launch_gemv_rows<T, 1>(x, w, scale, bias, y, M, N, K, stream);
  if (M <= 2) return launch_gemv_rows<T, 2>(x, w, scale, bias, y, M, N, K, stream);
  if (M <= 4) return launch_gemv_rows<T, 4>(x, w, scale, bias, y, M, N, K, stream);
  return launch_gemv_rows<T, 8>(x, w, scale, bias, y, M, N, K, stream);
}

}  // namespace

// x (M, K) bf16 or fp32 (`x_is_fp32`), w (N, K) int8, scale (N,) fp32, bias
// (N,) fp32 or null, y (M, N) in x's type; x, w and y 16-byte aligned. At or
// below SKINNY_MAX_M rows, and for every fp32 x, the skinny kernel runs: a
// tensor-core tile would be nearly empty, and it is the only one that takes
// fp32.
extern "C" int ragb_int8_matmul(const void* x, const void* w, const float* scale, const float* bias,
                                void* y, int M, int N, int K, int x_is_fp32, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (x_is_fp32) return launch_gemv<float>(x, w, scale, bias, y, M, N, K, stream);
  if (M <= SKINNY_MAX_M) return launch_gemv<bf16>(x, w, scale, bias, y, M, N, K, stream);
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  if (pick_bm(M, N, sms) == 256) return launch_wgmma<256>(x, w, scale, bias, y, M, N, K, stream);
  return launch_wgmma<128>(x, w, scale, bias, y, M, N, K, stream);
}
