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
// as nn.Linear keeps its weight), not the JAX package's (K, N). The B operand
// of mma.sync.m16n8k16 wants two consecutive k of one column in one register;
// in (N, K) they are two adjacent bytes.
//
// What bounds it on the H100: two regimes, two kernels.
// * M > 8 (`int8_mma_kernel`, the token streams: M = 512 .. 8704): 2*M*N*K
//   operations against M*K*2 + N*K + M*N*2 bytes is far above the bf16 ridge
//   (~295 FLOP/byte) once M is in the hundreds: tensor-core operations bound
//   it. One block owns a 128 x 128 output tile and loops over K in chunks of
//   64 (no split-K, no atomics: bit-for-bit reproducible). x tiles (bf16) and
//   weight tiles (int8, half the bytes of a bf16 weight) go global -> shared
//   through a 3-stage cp.async ring; x fragments come from ldmatrix; each
//   thread turns its int8 pairs into bf16 pairs in registers with a
//   byte-permute and one fp32 subtract per value (0x4B000000 | (q ^ 0x80) is
//   2^23 + q + 128 as a float; minus 2^23 + 128 is q, whose upper 16 bits are
//   its bf16), so no weight is ever dequantised to memory; 8 warps of 64 x 32
//   share each converted fragment over four mma rows. Blocks that share a
//   weight tile are adjacent in the grid, so the weights cross HBM once and x
//   is re-read from L2.
// * M <= 8, or fp32 x (`int8_skinny_kernel`, the AdaLN modulation and the
//   embedders: M = batch): every weight byte is used M times, so the N*K
//   weight bytes bound it (56.6 MB for 3072 -> 18432). One warp owns one
//   output channel, reads its weight row once in 16-byte pieces and
//   accumulates up to four rows of x in fp32 FMAs (an fp32 x stays fp32: a
//   tensor-core pass would round it to bf16 and change the result).
// Tile edges are masked (rows past M, channels past N, and K chunks past K are
// zero-filled). K must be a multiple of 16 and N of 8 (16-byte copies of int8
// rows, paired stores); the wrapper checks both.
// Not yet done (later work): wgmma + TMA, a persistent tile loop.

#include "mma.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int A_LD = BK + 8;            // bf16 elements per x row in shared memory
constexpr int B_LD = BK + 16;           // bytes per weight row in shared memory
constexpr int A_STAGE = BM * A_LD;      // elements
constexpr int B_STAGE = BN * B_LD;      // bytes
constexpr int MMA_THREADS = 256;
constexpr size_t MMA_SMEM = (size_t)STAGES * (A_STAGE * sizeof(bf16) + B_STAGE);

// 16-byte global -> shared copy of raw bytes; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// four packed int8 -> four floats, exactly, without the conversion unit:
// 0x4B000000 | (q ^ 0x80) is the float 2^23 + q + 128
__device__ __forceinline__ void int8x4_to_float4(uint32_t packed, float* f) {
  const uint32_t biased = packed ^ 0x80808080u;   // q + 128 in every byte
  constexpr float MAGIC = 8388736.0f;             // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650)) - MAGIC;
  f[1] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7651)) - MAGIC;
  f[2] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7652)) - MAGIC;
  f[3] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7653)) - MAGIC;
}

// four int8 (k, k+1 in the low half; k+8, k+9 in the high half) -> two bf16x2
__device__ __forceinline__ void int8x4_to_bf16x2x2(uint32_t packed, uint32_t& lo, uint32_t& hi) {
  float f[4];
  int8x4_to_float4(packed, f);
  // a small integer's bf16 is the upper half of its fp32
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__global__ void __launch_bounds__(MMA_THREADS)
    int8_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    bf16* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  int8_t* Bs = reinterpret_cast<int8_t*>(smem_raw + (size_t)STAGES * A_STAGE * sizeof(bf16));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 7, lsel = lane >> 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64;       // this warp's 64 rows
  const int wn = (warp & 3) * 32;        // and 32 channels of the tile
  const int nk = (K + BK - 1) / BK;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    bf16* a_dst = As + stage * A_STAGE;
    int8_t* b_dst = Bs + stage * B_STAGE;
    // x: BM rows of BK bf16 = 8 pieces of 16 bytes a row
    for (int i = tid; i < BM * (BK / 8); i += MMA_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      const bf16* src = ok ? x + (size_t)(m0 + r) * K + k0 + c : x;
      cp_async16_raw(a_dst + r * A_LD + c, src, ok ? 16 : 0);
    }
    // weights: BN rows of BK int8 = 4 pieces of 16 bytes a row
    for (int i = tid; i < BN * (BK / 16); i += MMA_THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      const int8_t* src = ok ? w + (size_t)(n0 + r) * K + k0 + c : w;
      cp_async16_raw(b_dst + r * B_LD + c, src, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt has landed; nobody still reads the stage refilled below
    if (kt + STAGES - 1 < nk) load_tile(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const bf16* a_s = As + (kt % STAGES) * A_STAGE;
    const int8_t* b_s = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b_lo[4], b_hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b_s + (wn + j * 8 + g) * B_LD + kk + 2 * t;
        const uint32_t k_lo = *reinterpret_cast<const uint16_t*>(p);
        const uint32_t k_hi = *reinterpret_cast<const uint16_t*>(p + 8);
        int8x4_to_bf16x2x2(k_lo | (k_hi << 16), b_lo[j], b_hi[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, a_s + (wm + i * 16 + lrow + (lsel & 1) * 8) * A_LD + kk + (lsel >> 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a, b_lo[j], b_hi[j]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: scale and bias once on the fp32 accumulator, one rounding
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    if (n >= N) continue;                // N is even: n + 1 < N too
    const float s0 = scale[n], s1 = scale[n + 1];
    const float c0 = bias != nullptr ? bias[n] : 0.0f;
    const float c1 = bias != nullptr ? bias[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m < M) {
          const float v0 = acc[i][j][2 * h] * s0 + c0;
          const float v1 = acc[i][j][2 * h + 1] * s1 + c1;
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// skinny variant: one warp per output channel, up to ROWS rows of x per pass
// ---------------------------------------------------------------------------
constexpr int SKINNY_ROWS = 4;
constexpr int SKINNY_WARPS = 8;
constexpr int SKINNY_MAX_M = 8;         // bf16 x with more rows goes to the tensor-core kernel

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const bf16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + 8 * i);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[8 * i + j] = __bfloat162float(h[j]);
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(SKINNY_WARPS * 32)
    int8_skinny_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       T* __restrict__ y, int M, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * SKINNY_WARPS + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * SKINNY_ROWS;
  if (n >= N) return;
  const int rows = min(SKINNY_ROWS, M - m0);
  float acc[SKINNY_ROWS];
#pragma unroll
  for (int r = 0; r < SKINNY_ROWS; ++r) acc[r] = 0.0f;
  const int8_t* wrow = w + (size_t)n * K;
  for (int k = lane * 16; k < K; k += 32 * 16) {
    const int4 raw = *reinterpret_cast<const int4*>(wrow + k);
    float wf[16];
    int8x4_to_float4((uint32_t)raw.x, wf);
    int8x4_to_float4((uint32_t)raw.y, wf + 4);
    int8x4_to_float4((uint32_t)raw.z, wf + 8);
    int8x4_to_float4((uint32_t)raw.w, wf + 12);
#pragma unroll
    for (int r = 0; r < SKINNY_ROWS; ++r) {
      if (r < rows) {
        float xv[16];
        load16(x + (size_t)(m0 + r) * K + k, xv);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[r] = fmaf(xv[i], wf[i], acc[r]);
      }
    }
  }
  const float s = scale[n];
  const float c = bias != nullptr ? bias[n] : 0.0f;
#pragma unroll
  for (int r = 0; r < SKINNY_ROWS; ++r) {
    const float total = warp_sum(acc[r]);     // butterfly: the same order on every run
    if (lane == 0 && r < rows) store_out(y + (size_t)(m0 + r) * N + n, total * s + c);
  }
}

template <typename T>
int launch_skinny(const void* x, const void* w, const float* scale, const float* bias, void* y,
                  int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + SKINNY_WARPS - 1) / SKINNY_WARPS, (M + SKINNY_ROWS - 1) / SKINNY_ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int8_skinny_kernel<T><<<grid, SKINNY_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, bias, static_cast<T*>(y), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 or fp32 (`x_is_fp32`), w (N, K) int8, scale (N,) fp32, bias
// (N,) fp32 or null, y (M, N) in x's type. At or below SKINNY_MAX_M rows, and
// for every fp32 x, the one-warp-per-channel kernel runs: the tensor-core tile
// would be nearly empty, and it is the only one that takes fp32.
extern "C" int ragb_int8_matmul(const void* x, const void* w, const float* scale, const float* bias,
                                void* y, int M, int N, int K, int x_is_fp32, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8) return (int)cudaErrorInvalidValue;
  if (x_is_fp32) return launch_skinny<float>(x, w, scale, bias, y, M, N, K, stream);
  if (M <= SKINNY_MAX_M) return launch_skinny<bf16>(x, w, scale, bias, y, M, N, K, stream);
  cudaError_t e = cudaFuncSetAttribute(int8_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)MMA_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int8_mma_kernel<<<grid, MMA_THREADS, MMA_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), scale, bias,
      static_cast<bf16*>(y), M, N, K);
  return (int)cudaGetLastError();
}
