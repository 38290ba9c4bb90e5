// Whole-resnet-block conv kernels for Hopper (sm_90a), NHWC bf16 in and out.
//
// Replaces two TPU kernels of ragb_vae_tpu/ops/pallas/resnet_block.py:
//   K1 `_kernel` (driven by `_chain_fwd_impl`, entry `gn_silu_conv3x3_stats`):
//      y = conv3x3(act(x*a + b)) + bias [+ skip | + skip @ ws + wsb]
//   K2 `_subpixel_kernel` (driven by `_subpixel_fwd_impl`, entry
//      `fused_upsample_conv3x3_stats`): nearest-2x upsample + conv3x3 + bias
//      computed as four 2x2 "parity" convs on the small grid.
// Both end in the same epilogue: the output is rounded to bf16 and stored,
// and fp32 per-channel (sum, sum of squares) of the ROUNDED output are
// accumulated, the next GroupNorm's statistics.
//
// What bounds it on the H100: at the VAE's widths (C, N in 128..512) a conv
// does 2*9*C FLOPs per output element against ~2*(C+N) bytes of traffic, so
// it sits well above the bf16 ridge (~295 FLOP/byte): tensor-core FLOPs bound
// it. The design therefore (1) runs the GEMM on tensor cores through
// nvcuda::wmma bf16 fragments with fp32 accumulation, as an implicit GEMM
// (M = 64 output pixels, N = 64 output channels, K = taps x C); (2) loads each
// input element of a block's halo'd slab ONCE per K chunk, applies the GroupNorm
// coefficients and SiLU there in fp32 and rounds to bf16 (the activation
// never goes to device memory), and lets all taps read their shifted window
// of that slab from shared memory; (3) fuses bias, residual or 1x1
// projection (a fourth GEMM on the skip tile into the same accumulators) and
// the statistics into the epilogue, so the next GroupNorm costs no extra pass.
// TPU grids run in order and carried the statistics across row tiles; CUDA
// blocks run in parallel, so each block writes its partial sums to a scratch
// and a second small kernel sums them in a fixed order: no float atomics, so
// the statistics, and everything downstream, are bit-for-bit reproducible.
// Tile edges (H, W, N not multiples of the tile) are masked; C and N must be
// multiples of 8 (16-byte vector loads), which the wrapper checks.
// Not yet done (later work): cp.async/TMA double buffering, wgmma.

#include "common.cuh"

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
constexpr int SLAB_PIX = (TH + 2) * (TW + 2);

enum { MODE_CONV3 = 0, MODE_SUBPIXEL = 1 };
enum { SKIP_NONE = 0, SKIP_ADD = 1, SKIP_PROJ = 2 };

struct ConvArgs {
  const bf16* x;       // (B, H, W, C)
  const float* a;      // (B, C) GroupNorm scale coefficients (K1 only)
  const float* b;      // (B, C) GroupNorm shift coefficients (K1 only)
  const bf16* w;       // K1: (3, 3, C, N); K2: (2, 2, 2, 2C, N) folded
  const float* bias;   // (N,)
  const bf16* skip;    // (B, H, W, N) or (B, H, W, Cs)
  const bf16* ws;      // (Cs, N)
  const float* wsb;    // (N,)
  bf16* y;             // K1: (B, H, W, N); K2: (B, 2H, 2W, N)
  float* partial;      // (B, T, 2, N) per-block partial statistics
  int B, H, W, C, N, Cs;
  int silu;
  int skip_mode;
  int tiles_w, tiles_h;
};

__host__ __device__ constexpr size_t conv_smem_bytes(int ntaps) {
  return (size_t)SLAB_PIX * A_LD * sizeof(bf16) + (size_t)ntaps * KC * B_LD * sizeof(bf16);
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS) conv_taps_kernel(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* slab = reinterpret_cast<bf16*>(smem_raw);
  bf16* wsm = slab + SLAB_PIX * A_LD;

  constexpr int P = (MODE == MODE_SUBPIXEL) ? 4 : 1;
  constexpr int NTAPS = (MODE == MODE_SUBPIXEL) ? 4 : 9;
  const int tile = blockIdx.x;
  const int tw = tile % p.tiles_w;
  const int th = tile / p.tiles_w;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z / P;
  const int parity = blockIdx.z % P;
  const int pa = parity >> 1, pb = parity & 1;
  const int h0 = th * TH, w0 = tw * TW;
  const int H = p.H, W = p.W, C = p.C, N = p.N;
  const int warp = threadIdx.x >> 5;
  const int wrow = warp >> 1;           // tile row this warp's fragments cover
  const int wcol = (warp & 1) * 32;     // first of its 32 output channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int c0 = 0; c0 < C; c0 += KC) {
    // halo'd input slab: rows [h0-1, h0+TH+1), cols [w0-1, w0+TW+1); zero
    // outside the image AFTER activation (SAME padding pads act(x))
    for (int i = threadIdx.x; i < SLAB_PIX * (KC / 8); i += NTHREADS) {
      const int pix = i / (KC / 8);
      const int cv = (i % (KC / 8)) * 8;
      const int r = pix / (TW + 2), c = pix % (TW + 2);
      const int hh = h0 - 1 + r, ww = w0 - 1 + c;
      const int ch = c0 + cv;
      uint4 out = zero_vec();
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ch < C) {
        uint4 raw = *reinterpret_cast<const uint4*>(p.x + (((size_t)b * H + hh) * W + ww) * C + ch);
        if (MODE == MODE_CONV3) {
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
          bf16 o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float t = __bfloat162float(xv[j]) * p.a[b * C + ch + j] + p.b[b * C + ch + j];
            if (p.silu) t = t / (1.0f + expf(-t));
            o[j] = __float2bfloat16(t);
          }
          out = *reinterpret_cast<const uint4*>(o);
        } else {
          out = raw;
        }
      }
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
      if (ch < C && n < N) {
        const bf16* wt;
        if (MODE == MODE_CONV3) {
          wt = p.w + (size_t)t * C * N;
        } else {
          const int u = t >> 1, v = t & 1;
          wt = p.w + ((size_t)((parity * 2 + u) * 2) * C + (size_t)v * C) * N;
        }
        val = *reinterpret_cast<const uint4*>(wt + (size_t)ch * N + n);
      }
      *reinterpret_cast<uint4*>(wsm + (t * KC + k) * B_LD + nv) = val;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      int dy, dx;
      if (MODE == MODE_CONV3) {
        dy = t / 3;
        dx = t % 3;
      } else {
        dy = pa + (t >> 1);
        dx = pb + (t & 1);
      }
      const bf16* arow = slab + ((wrow + dy) * (TW + 2) + dx) * A_LD;
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

  if (MODE == MODE_CONV3 && p.skip_mode == SKIP_PROJ) {
    // 1x1 conv_shortcut on the raw skip tile, into the same accumulators
    for (int c0 = 0; c0 < p.Cs; c0 += KC) {
      for (int i = threadIdx.x; i < TILE_PIX * (KC / 8); i += NTHREADS) {
        const int pix = i / (KC / 8);
        const int cv = (i % (KC / 8)) * 8;
        const int hh = h0 + pix / TW, ww = w0 + pix % TW;
        const int ch = c0 + cv;
        uint4 val = zero_vec();
        if (hh < H && ww < W && ch < p.Cs)
          val = *reinterpret_cast<const uint4*>(p.skip + (((size_t)b * H + hh) * W + ww) * p.Cs + ch);
        *reinterpret_cast<uint4*>(slab + pix * A_LD + cv) = val;
      }
      for (int i = threadIdx.x; i < KC * (TN / 8); i += NTHREADS) {
        const int k = i / (TN / 8);
        const int nv = (i % (TN / 8)) * 8;
        uint4 val = zero_vec();
        if (c0 + k < p.Cs && n0 + nv < N)
          val = *reinterpret_cast<const uint4*>(p.ws + (size_t)(c0 + k) * N + n0 + nv);
        *reinterpret_cast<uint4*>(wsm + k * B_LD + nv) = val;
      }
      __syncthreads();
      const bf16* arow = slab + (wrow * TW) * A_LD;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, arow + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, wsm + kk * B_LD + wcol + j * 16, B_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
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
    const float bn = p.bias[n] + (p.skip_mode == SKIP_PROJ ? p.wsb[n] : 0.0f);
    for (int q = 0; q < TILE_PIX / 4; ++q) {
      const int pix = grp * (TILE_PIX / 4) + q;
      const int hh = h0 + pix / TW, ww = w0 + pix % TW;
      if (hh < H && ww < W) {
        float v = ctile[pix * C_LD + n_local] + bn;
        if (p.skip_mode == SKIP_ADD)
          v += __bfloat162float(p.skip[(((size_t)b * H + hh) * W + ww) * N + n]);
        size_t oidx;
        if (MODE == MODE_CONV3)
          oidx = (((size_t)b * H + hh) * W + ww) * N + n;
        else
          oidx = (((size_t)b * (2 * H) + 2 * hh + pa) * (2 * W) + 2 * ww + pb) * N + n;
        const bf16 yb = __float2bfloat16(v);
        p.y[oidx] = yb;
        const float yr = __bfloat162float(yb);   // stats of the ROUNDED output
        s0 += yr;
        s1 += yr * yr;
      }
    }
  }
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
    const size_t T = (size_t)P * p.tiles_h * p.tiles_w;
    const size_t tid = (size_t)parity * p.tiles_h * p.tiles_w + tile;
    p.partial[(((size_t)b * T + tid) * 2 + 0) * N + n] = t0;
    p.partial[(((size_t)b * T + tid) * 2 + 1) * N + n] = t1;
  }
}

// Sums the (B, T, 2, N) partials into (B, 2, N) in a fixed order: thread
// lane j adds tiles j, j+32, ... in sequence, then lane 0 adds the 32 lanes.
__global__ void stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                    int T, int N) {
  __shared__ float red[2][32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int b = blockIdx.y;
  float s0 = 0.0f, s1 = 0.0f;
  if (n < N) {
    for (int t = threadIdx.y; t < T; t += 32) {
      s0 += partial[(((size_t)b * T + t) * 2 + 0) * N + n];
      s1 += partial[(((size_t)b * T + t) * 2 + 1) * N + n];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s0;
  red[1][threadIdx.y][threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int j = 0; j < 32; ++j) {
      t0 += red[0][j][threadIdx.x];
      t1 += red[1][j][threadIdx.x];
    }
    stats[((size_t)b * 2 + 0) * N + n] = t0;
    stats[((size_t)b * 2 + 1) * N + n] = t1;
  }
}

template <int MODE>
int launch_conv(ConvArgs& p, float* stats, int T, cudaStream_t stream) {
  constexpr int P = (MODE == MODE_SUBPIXEL) ? 4 : 1;
  constexpr int NTAPS = (MODE == MODE_SUBPIXEL) ? 4 : 9;
  p.tiles_w = (p.W + TW - 1) / TW;
  p.tiles_h = (p.H + TH - 1) / TH;
  if (T != P * p.tiles_w * p.tiles_h || p.C % 8 || p.N % 8 || p.Cs % 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = conv_smem_bytes(NTAPS);
  cudaError_t e = cudaFuncSetAttribute(conv_taps_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.tiles_w * p.tiles_h, (p.N + TN - 1) / TN, p.B * P);
  conv_taps_kernel<MODE><<<grid, NTHREADS, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<<<dim3((p.N + 31) / 32, p.B), dim3(32, 32), 0, stream>>>(p.partial, stats,
                                                                               T, p.N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ragb_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Output tile geometry, so the wrapper sizes the partial-statistics scratch.
int ragb_conv_tile_shape(int* tile_h, int* tile_w) {
  *tile_h = TH;
  *tile_w = TW;
  return 0;
}

int ragb_resnet_conv3x3_stats(const void* x, const float* a, const float* b, const void* w,
                              const float* bias, const void* skip, const void* ws,
                              const float* wsb, void* y, float* partial, float* stats, int T,
                              int B, int H, int W, int C, int N, int Cs, int silu, int skip_mode,
                              void* stream) {
  ConvArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a;
  p.b = b;
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.skip = static_cast<const bf16*>(skip);
  p.ws = static_cast<const bf16*>(ws);
  p.wsb = wsb;
  p.y = static_cast<bf16*>(y);
  p.partial = partial;
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N;
  p.Cs = skip_mode == SKIP_PROJ ? Cs : 0;
  p.silu = silu;
  p.skip_mode = skip_mode;
  return launch_conv<MODE_CONV3>(p, stats, T, static_cast<cudaStream_t>(stream));
}

int ragb_subpixel_upsample_conv3x3_stats(const void* x, const void* w_fold, const float* bias,
                                         void* y, float* partial, float* stats, int T, int B,
                                         int H, int W, int C, int N, void* stream) {
  ConvArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w_fold);
  p.bias = bias;
  p.y = static_cast<bf16*>(y);
  p.partial = partial;
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N;
  p.Cs = 0;
  p.silu = 0;
  p.skip_mode = SKIP_NONE;
  return launch_conv<MODE_SUBPIXEL>(p, stats, T, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
