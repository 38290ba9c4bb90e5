// The first design's implicit-GEMM conv kernel, left with one launch: K6's
// dskip = dye @ ws^T, a 1x1 conv (resnet_block_bwd.cu). NHWC bf16 in and
// out. (K1, K2, K9, K11, K12, K6's data gradient and K7's run on the TMA +
// wgmma engine of conv_sm90.cuh.)
//
// One block computes a TH x TW tile of output pixels for TN output channels:
// M = 64 pixels, N = 64 channels, K = input channels, on tensor cores
// through nvcuda::wmma bf16 fragments with fp32 accumulation, each K chunk's
// input tile loaded into shared memory once. MODE picks the taps:
//   MODE_CONV1    1x1 conv                                        (K6 dskip)
// EPI picks what happens to the fp32 tile:
//   EPI_FWD       + bias, round, store, and the per-channel (sum, sumsq) of
//                 the rounded output as partials (bias and partial may be
//                 null: a bare conv that only stores)
// Per-block partials land in a (B, T, 2, N) scratch and `stats_reduce_kernel`
// adds them in a fixed order: no float atomics, so results are bit-for-bit
// reproducible. Tile edges (H, W, N not multiples of the tile) are masked; C
// and N must be multiples of 8 (16-byte vector loads).
#pragma once

#include "common.cuh"
#include "stats_reduce.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 16;                  // tile width in pixels: one fragment's 16 rows
constexpr int TH = 4;                   // tile height in rows
constexpr int TN = 64;                  // output channels per block
constexpr int KC = 32;                  // input channels per K chunk
constexpr int A_LD = KC + 16;           // smem row stride (elements) of the input slab
constexpr int B_LD = TN + 8;            // smem row stride of a weight chunk
constexpr int C_LD = TN + 4;            // smem row stride of the fp32 epilogue tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE_PIX = TH * TW;       // 64 output pixels

enum { MODE_CONV1 = 2 };
enum { EPI_FWD = 0 };

template <int MODE>
struct TapGeometry {
  static constexpr int NTAPS = 1;
  static constexpr int SH = TH, SW = TW;                             // the input tile: no halo
  static constexpr int SLAB_PIX = SH * SW;
};

struct ConvArgs {
  const bf16* x;       // conv input (B, H, W, C)
  const bf16* w;       // (taps, C, N)
  const float* bias;   // (N,) or null
  bf16* y;             // (B, H, W, N)
  float* partial;      // (B, T, 2, N) per-block partial sums, or null
  int B, H, W, C, N;
  int tiles_w, tiles_h;
};

template <int MODE>
__host__ __device__ constexpr size_t conv_smem_bytes() {
  using G = TapGeometry<MODE>;
  size_t main = (size_t)G::SLAB_PIX * A_LD * sizeof(bf16) + (size_t)G::NTAPS * KC * B_LD * sizeof(bf16);
  size_t epi = (size_t)TILE_PIX * C_LD * sizeof(float) + (size_t)8 * TN * sizeof(float);
  return main > epi ? main : epi;
}

template <int MODE, int EPI>
__global__ void __launch_bounds__(NTHREADS) conv_taps_kernel(ConvArgs p) {
  using G = TapGeometry<MODE>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* slab = reinterpret_cast<bf16*>(smem_raw);
  bf16* wsm = slab + G::SLAB_PIX * A_LD;

  constexpr int NTAPS = G::NTAPS;
  const int tile = blockIdx.x;
  const int tw = tile % p.tiles_w;
  const int th = tile / p.tiles_w;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int h0 = th * TH, w0 = tw * TW;
  const int H = p.H, W = p.W, C = p.C, N = p.N;
  const int warp = threadIdx.x >> 5;
  const int wrow = warp >> 1;           // tile row this warp's fragments cover
  const int wcol = (warp & 1) * 32;     // first of its 32 output channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int c0 = 0; c0 < C; c0 += KC) {
    // the input tile, zero outside the image
    for (int i = threadIdx.x; i < G::SLAB_PIX * (KC / 8); i += NTHREADS) {
      const int pix = i / (KC / 8);
      const int cv = (i % (KC / 8)) * 8;
      const int r = pix / G::SW, c = pix % G::SW;
      const int hh = h0 + r, ww = w0 + c;
      const int ch = c0 + cv;
      uint4 out = zero_vec();
      if (hh < H && ww < W && ch < C)
        out = *reinterpret_cast<const uint4*>(p.x + (((size_t)b * H + hh) * W + ww) * C + ch);
      *reinterpret_cast<uint4*>(slab + pix * A_LD + cv) = out;
    }
    // this chunk's weights for every tap: NTAPS x KC x TN
    for (int i = threadIdx.x; i < NTAPS * KC * (TN / 8); i += NTHREADS) {
      const int t = i / (KC * (TN / 8));
      const int rem = i % (KC * (TN / 8));
      const int k = rem / (TN / 8);
      const int nv = (rem % (TN / 8)) * 8;
      const int ch = c0 + k, n = n0 + nv;
      uint4 val = zero_vec();
      if (ch < C && n < N) val = *reinterpret_cast<const uint4*>(p.w + ((size_t)t * C + ch) * N + n);
      *reinterpret_cast<uint4*>(wsm + (t * KC + k) * B_LD + nv) = val;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      // fragment row j is output pixel (wrow, j): tile pixel (wrow, j)
      const bf16* arow = slab + wrow * G::SW * A_LD;
      const bf16* bt = wsm + t * KC * B_LD;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, arow + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, bt + kk * B_LD + wcol + j * 16, B_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: fragments -> fp32 tile in shared memory (reusing the slab)
  float* ctile = reinterpret_cast<float*>(smem_raw);
  float* red = ctile + TILE_PIX * C_LD;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(ctile + (wrow * TW) * C_LD + wcol + j * 16, acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();

  const int n_local = threadIdx.x % TN;
  const int grp = threadIdx.x / TN;     // 4 groups of 16 pixels (one tile row each)
  const int n = n0 + n_local;
  float s0 = 0.0f, s1 = 0.0f;
  if (n < N) {
    const float bn = p.bias != nullptr ? p.bias[n] : 0.0f;
    for (int q = 0; q < TILE_PIX / 4; ++q) {
      const int pix = grp * (TILE_PIX / 4) + q;
      const int hh = h0 + pix / TW, ww = w0 + pix % TW;
      if (hh < H && ww < W) {
        const float v = ctile[pix * C_LD + n_local] + bn;
        const size_t oidx = (((size_t)b * H + hh) * W + ww) * N + n;
        const bf16 yb = __float2bfloat16(v);
        p.y[oidx] = yb;
        const float yr = __bfloat162float(yb);   // stats of the ROUNDED output
        s0 += yr;
        s1 += yr * yr;
      }
    }
  }
  if (p.partial == nullptr) return;
  red[(grp * 2 + 0) * TN + n_local] = s0;
  red[(grp * 2 + 1) * TN + n_local] = s1;
  __syncthreads();
  if (grp == 0 && n < N) {
    float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      t0 += red[(g * 2 + 0) * TN + n_local];
      t1 += red[(g * 2 + 1) * TN + n_local];
    }
    const size_t T = (size_t)p.tiles_h * p.tiles_w;
    p.partial[(((size_t)b * T + tile) * 2 + 0) * N + n] = t0;
    p.partial[(((size_t)b * T + tile) * 2 + 1) * N + n] = t1;
  }
}

// Launches the conv and, when `sums` is given, the fixed-order reduce of its
// partials into `sums` (B, 2, N). T is the caller's count of partial tiles.
template <int MODE, int EPI>
int launch_conv(ConvArgs& p, float* sums, int T, cudaStream_t stream) {
  p.tiles_w = (p.W + TW - 1) / TW;
  p.tiles_h = (p.H + TH - 1) / TH;
  if (p.C % 8 || p.N % 8) return (int)cudaErrorInvalidValue;
  if (p.partial != nullptr && T != p.tiles_w * p.tiles_h) return (int)cudaErrorInvalidValue;
  if (p.B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = conv_smem_bytes<MODE>();
  cudaError_t e = cudaFuncSetAttribute(conv_taps_kernel<MODE, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.tiles_w * p.tiles_h, (p.N + TN - 1) / TN, p.B);
  conv_taps_kernel<MODE, EPI><<<grid, NTHREADS, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.partial == nullptr) return (int)e;
  stats_reduce_kernel<<<dim3((p.N + 31) / 32, p.B), dim3(32, 32), 0, stream>>>(p.partial, sums,
                                                                               T, p.N);
  return (int)cudaGetLastError();
}

}  // namespace
