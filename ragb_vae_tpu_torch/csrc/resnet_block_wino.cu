// K1's function by Winograd F(2x2, 3x3), for Hopper (sm_90a), NHWC bf16 in and
// out:
//   y = conv3x3(act(x*a + b)) + bias [+ skip | + skip @ ws + wsb]
// and the per-channel (sum, sum of squares) of the ROUNDED y.
//
// Replaces the TPU kernel `_wino_kernel` of
// ragb_vae_tpu/ops/pallas/resnet_block.py (driven by `_wino_fwd_impl`, entry
// `gn_silu_conv3x3_stats(algo="winograd")`). Its backward is K1's (K6 in
// resnet_block_bwd.cu): the primal function is the same.
//
// The arithmetic, per 2x2 output tile and input channel: the 4x4 input patch d
// (activation rounded to bf16, zero outside the image) goes through the input
// transform B^T d B in fp32, COLUMNS FIRST as the TPU kernel does, and is
// rounded to bf16 (V, 16 variants). Each variant is one GEMM over the input
// channels against U = G w G^T (folded in fp32 from the bf16 weights, rounded
// to bf16 by the wrapper), fp32 accumulation: M[mu][nu]. The output transform
// A^T M A runs in fp32 in the epilogue, rows first: Z[p][nu] = (M0 + M1 + M2,
// M1 - M2 - M3)[p], y[p][q] = (Z0 + Z1 + Z2, Z1 - Z2 - Z3)[q].
//
// The TPU kernel folds the output-ROW transform into the contraction (8 GEMMs
// of depth 3C: 6/9 of the direct MACs instead of 4/9) because its matrix unit
// wants deep K and its vector unit pays for every fp32 combine of the 16 M
// tiles; its pair-channel view (B, H, W/2, 2C) exists for the 128-lane layout.
// Neither carries over: here the 16 products of depth C are separate mma.sync
// GEMMs (the 4/9 of the direct MACs that make Winograd worth it), each warp
// owns two variants, and the 16 M tiles meet once, through shared memory, in
// the epilogue.
//
// What bounds it on the H100: at the VAE's widths (C, N in 128..512) the 16
// variant GEMMs do 2*4*C operations per output element (4/9 of a direct conv)
// against ~2*(C + N) bytes per pixel, above the bf16 ridge: tensor-core
// operations bound it, plus the transforms' fp32 adds (~40 per 2x2 tile and
// input channel, 10 per output element and channel on the CUDA cores). The
// design: one block per 8 x 16 output pixels (32 Winograd tiles, the GEMMs' M)
// and 32 output channels; per K chunk of 32 input channels the halo'd 10 x 18
// slab is staged ONCE through the GroupNorm coefficients and SiLU (rounded to
// bf16, never written out), transformed into shared memory, and the 16
// variants' products run on mma.sync m16n8k16 from ldmatrix fragments. The 1x1
// projection of the skip is a GEMM of its own after the main loop. The
// statistics go through per-block fp32 partials and the fixed-order reduce
// (stats_reduce_kernel): no float atomics, bit-for-bit reproducible.
// H and W must be even (a Winograd tile never straddles the image edge), C, N
// and Cs multiples of 8 (16-byte vector loads); tile edges are masked.
// Not yet done (later work): cp.async double buffering, wgmma, TMA.

#include "mma.cuh"
#include "stats_reduce.cuh"

namespace {

struct WinoArgs {
  const bf16* x;       // (B, H, W, C)
  const float* a;      // (B, C) GroupNorm coefficients applied on load: x*a + b
  const float* b;
  const bf16* w;       // U = G w G^T: (16, C, N)
  const float* bias;   // (N,)
  const bf16* skip;    // (B, H, W, N) or (B, H, W, Cs)
  const bf16* ws;      // (Cs, N)
  const float* wsb;    // (N,)
  bf16* y;             // (B, H, W, N)
  float* partial;      // (B, T, 2, N) per-block partial sums
  int B, H, W, C, N, Cs;
  int silu;
  int skip_mode;
  int tiles_w, tiles_h;
};

constexpr int WH = 8;                          // output rows per block
constexpr int WW = 16;                         // output columns per block
constexpr int WTN = 32;                        // output channels per block
constexpr int WKC = 32;                        // input channels per K chunk
constexpr int WT_COLS = WW / 2;                // Winograd tiles per block row
constexpr int WTILES = (WH / 2) * WT_COLS;     // 32 Winograd tiles: the GEMMs' M
constexpr int WVAR = 16;                       // variants of the 4x4 transform domain
constexpr int WSH = WH + 2, WSW = WW + 2;      // input slab: one halo row / column each side
constexpr int WSLAB_PIX = WSH * WSW;
constexpr int WPIX = WH * WW;                  // 128 output pixels
constexpr int V_LD = WKC + 8;                  // row stride (elements) of V and the skip tile
constexpr int U_LD = WTN + 8;                  // row stride of a weight chunk
constexpr int M_LD = WTN + 4;                  // row stride of the fp32 epilogue tiles
constexpr int WNWARPS = 8;
constexpr int WTHREADS = WNWARPS * 32;
static_assert(WVAR == 2 * WNWARPS, "each warp owns two variants");
static_assert(WPIX == 16 * WNWARPS, "each warp owns 16 pixels of the projection");

// shared memory: the main loop's slab, V and U; the projection's skip tile and
// weight chunk (over the same bytes, after the main loop); the epilogue's fp32
// M tiles, projection tile and reduction scratch (over the same bytes again)
constexpr size_t SLAB_BYTES = (size_t)WSLAB_PIX * WKC * sizeof(bf16);
constexpr size_t V_BYTES = (size_t)WVAR * WTILES * V_LD * sizeof(bf16);
constexpr size_t U_BYTES = (size_t)WVAR * WKC * U_LD * sizeof(bf16);
constexpr size_t MAIN_BYTES = SLAB_BYTES + V_BYTES + U_BYTES;
constexpr size_t MBUF_BYTES = (size_t)WVAR * WTILES * M_LD * sizeof(float);
constexpr size_t PBUF_BYTES = (size_t)WPIX * M_LD * sizeof(float);
constexpr size_t RED_BYTES = (size_t)WNWARPS * 2 * WTN * sizeof(float);
constexpr size_t EPI_BYTES = MBUF_BYTES + PBUF_BYTES + RED_BYTES;
constexpr size_t WINO_SMEM = MAIN_BYTES > EPI_BYTES ? MAIN_BYTES : EPI_BYTES;
static_assert((size_t)WPIX * V_LD * sizeof(bf16) + (size_t)WKC * U_LD * sizeof(bf16) <= MAIN_BYTES,
              "the projection's staging fits the main loop's bytes");

__global__ void __launch_bounds__(WTHREADS) wino_conv_kernel(WinoArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* slab = reinterpret_cast<bf16*>(smem_raw);
  bf16* vbuf = reinterpret_cast<bf16*>(smem_raw + SLAB_BYTES);
  bf16* ubuf = reinterpret_cast<bf16*>(smem_raw + SLAB_BYTES + V_BYTES);

  const int tile = blockIdx.x;
  const int h0 = (tile / p.tiles_w) * WH, w0 = (tile % p.tiles_w) * WW;
  const int n0 = blockIdx.y * WTN;
  const int b = blockIdx.z;
  const int H = p.H, W = p.W, C = p.C, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float acc[2][2][4][4];                       // [own variant][m16 tile][n8 tile][fragment]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][nt][e] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += WKC) {
    // halo'd input slab through the coefficients and the activation, rounded
    // to bf16; zero outside the image AFTER the activation (SAME padding)
    for (int i = tid; i < WSLAB_PIX * (WKC / 8); i += WTHREADS) {
      const int pix = i / (WKC / 8), cv = (i % (WKC / 8)) * 8;
      const int hh = h0 - 1 + pix / WSW, ww = w0 - 1 + pix % WSW;
      const int ch = c0 + cv;
      uint4 out = zero_vec();
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ch < C) {
        uint4 raw = *reinterpret_cast<const uint4*>(p.x + (((size_t)b * H + hh) * W + ww) * C + ch);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
        bf16 o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t = __bfloat162float(xv[j]) * p.a[b * C + ch + j] + p.b[b * C + ch + j];
          if (p.silu) t = t / (1.0f + expf(-t));
          o[j] = __float2bfloat16(t);
        }
        out = *reinterpret_cast<const uint4*>(o);
      }
      *reinterpret_cast<uint4*>(slab + pix * WKC + cv) = out;
    }
    // this chunk's transformed weights of every variant: 16 x WKC x WTN
    for (int i = tid; i < WVAR * WKC * (WTN / 8); i += WTHREADS) {
      const int v = i / (WKC * (WTN / 8));
      const int rem = i % (WKC * (WTN / 8));
      const int k = rem / (WTN / 8), nv = (rem % (WTN / 8)) * 8;
      uint4 val = zero_vec();
      if (c0 + k < C && n0 + nv < N)
        val = *reinterpret_cast<const uint4*>(p.w + ((size_t)v * C + c0 + k) * N + n0 + nv);
      *reinterpret_cast<uint4*>(ubuf + (v * WKC + k) * U_LD + nv) = val;
    }
    __syncthreads();

    // input transform: one (Winograd tile, channel) per thread and pass
    for (int task = tid; task < WTILES * WKC; task += WTHREADS) {
      const int c = task % WKC, t = task / WKC;
      const bf16* d = slab + ((2 * (t / WT_COLS)) * WSW + 2 * (t % WT_COLS)) * WKC + c;
      float cv[4][4];                          // [patch row][column variant]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d0 = __bfloat162float(d[(r * WSW + 0) * WKC]);
        const float d1 = __bfloat162float(d[(r * WSW + 1) * WKC]);
        const float d2 = __bfloat162float(d[(r * WSW + 2) * WKC]);
        const float d3 = __bfloat162float(d[(r * WSW + 3) * WKC]);
        cv[r][0] = d0 - d2;
        cv[r][1] = d1 + d2;
        cv[r][2] = d2 - d1;
        cv[r][3] = d1 - d3;
      }
#pragma unroll
      for (int nu = 0; nu < 4; ++nu) {
        const float rv[4] = {cv[0][nu] - cv[2][nu], cv[1][nu] + cv[2][nu], cv[2][nu] - cv[1][nu],
                             cv[1][nu] - cv[3][nu]};
#pragma unroll
        for (int mu = 0; mu < 4; ++mu)
          vbuf[((mu * 4 + nu) * WTILES + t) * V_LD + c] = __float2bfloat16(rv[mu]);
      }
    }
    __syncthreads();

    // the variants' GEMMs: warp w owns variants 2w and 2w + 1
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int v = warp * 2 + j;
      const bf16* vt = vbuf + v * WTILES * V_LD;
      const bf16* ut = ubuf + v * WKC * U_LD;
#pragma unroll
      for (int kk = 0; kk < WKC; kk += 16) {
        uint32_t af[2][4], bfr[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(af[mt], vt + (mt * 16 + (lane & 15)) * V_LD + kk + ((lane >> 4) << 3));
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          ldmatrix_x4_trans(bfr[nb], ut + (kk + (lane & 15)) * U_LD + nb * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_16816(acc[j][mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();
  }

  // 1x1 projection of the raw skip tile: warp w owns output pixels 16w..16w+15
  float pacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[nt][e] = 0.0f;
  if (p.skip_mode == SKIP_PROJ) {
    bf16* sk = reinterpret_cast<bf16*>(smem_raw);
    bf16* wsm = sk + WPIX * V_LD;
    for (int c0 = 0; c0 < p.Cs; c0 += WKC) {
      for (int i = tid; i < WPIX * (WKC / 8); i += WTHREADS) {
        const int pix = i / (WKC / 8), cv = (i % (WKC / 8)) * 8;
        const int hh = h0 + pix / WW, ww = w0 + pix % WW, ch = c0 + cv;
        uint4 val = zero_vec();
        if (hh < H && ww < W && ch < p.Cs)
          val = *reinterpret_cast<const uint4*>(p.skip + (((size_t)b * H + hh) * W + ww) * p.Cs + ch);
        *reinterpret_cast<uint4*>(sk + pix * V_LD + cv) = val;
      }
      for (int i = tid; i < WKC * (WTN / 8); i += WTHREADS) {
        const int k = i / (WTN / 8), nv = (i % (WTN / 8)) * 8;
        uint4 val = zero_vec();
        if (c0 + k < p.Cs && n0 + nv < N)
          val = *reinterpret_cast<const uint4*>(p.ws + (size_t)(c0 + k) * N + n0 + nv);
        *reinterpret_cast<uint4*>(wsm + k * U_LD + nv) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WKC; kk += 16) {
        uint32_t af[4], bfr[2][4];
        ldmatrix_x4(af, sk + (warp * 16 + (lane & 15)) * V_LD + kk + ((lane >> 4) << 3));
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          ldmatrix_x4_trans(bfr[nb], wsm + (kk + (lane & 15)) * U_LD + nb * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(pacc[nt], af, bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
      }
      __syncthreads();
    }
  }

  // accumulators -> fp32 tiles in shared memory; fragment (g, 2t) layout of
  // m16n8: elements 0, 1 at row g, columns 2t, 2t+1; elements 2, 3 at row g+8
  float* mbuf = reinterpret_cast<float*>(smem_raw);
  float* pbuf = mbuf + WVAR * WTILES * M_LD;
  float* red = pbuf + WPIX * M_LD;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* row = mbuf + ((warp * 2 + j) * WTILES + mt * 16 + g) * M_LD + nt * 8 + t2;
        row[0] = acc[j][mt][nt][0];
        row[1] = acc[j][mt][nt][1];
        row[8 * M_LD] = acc[j][mt][nt][2];
        row[8 * M_LD + 1] = acc[j][mt][nt][3];
      }
  if (p.skip_mode == SKIP_PROJ) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* row = pbuf + (warp * 16 + g) * M_LD + nt * 8 + t2;
      row[0] = pacc[nt][0];
      row[1] = pacc[nt][1];
      row[8 * M_LD] = pacc[nt][2];
      row[8 * M_LD + 1] = pacc[nt][3];
    }
  }
  __syncthreads();

  // output transform, bias, skip or projection, rounding, statistics: thread
  // (group, channel) takes the Winograd tiles group, group + 8, ...
  const int n_local = tid % WTN, grp = tid / WTN;
  const int n = n0 + n_local;
  float s0 = 0.0f, s1 = 0.0f;
  if (n < N) {
    const float bn = p.bias[n];
    const float wsbn = p.skip_mode == SKIP_PROJ ? p.wsb[n] : 0.0f;
    for (int t = grp; t < WTILES; t += WTHREADS / WTN) {
      const int ty = t / WT_COLS, tx = t % WT_COLS;
      if (h0 + 2 * ty >= H || w0 + 2 * tx >= W) continue;   // H, W even: whole tiles in or out
      float m[4][4];
#pragma unroll
      for (int v = 0; v < WVAR; ++v) m[v >> 2][v & 3] = mbuf[(v * WTILES + t) * M_LD + n_local];
      float z[2][4];
#pragma unroll
      for (int nu = 0; nu < 4; ++nu) {
        z[0][nu] = m[0][nu] + m[1][nu] + m[2][nu];
        z[1][nu] = m[1][nu] - m[2][nu] - m[3][nu];
      }
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float val = q == 0 ? z[pr][0] + z[pr][1] + z[pr][2] : z[pr][1] - z[pr][2] - z[pr][3];
          const int pix = (2 * ty + pr) * WW + 2 * tx + q;
          const int hh = h0 + 2 * ty + pr, ww = w0 + 2 * tx + q;
          const size_t oidx = (((size_t)b * H + hh) * W + ww) * N + n;
          val += bn;
          if (p.skip_mode == SKIP_PROJ)
            val = val + pbuf[pix * M_LD + n_local] + wsbn;
          else if (p.skip_mode == SKIP_ADD)
            val += __bfloat162float(p.skip[oidx]);
          const bf16 yb = __float2bfloat16(val);
          p.y[oidx] = yb;
          const float yr = __bfloat162float(yb);    // stats of the ROUNDED output
          s0 += yr;
          s1 += yr * yr;
        }
    }
  }
  red[(grp * 2 + 0) * WTN + n_local] = s0;
  red[(grp * 2 + 1) * WTN + n_local] = s1;
  __syncthreads();
  if (grp == 0 && n < N) {
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int q = 0; q < WTHREADS / WTN; ++q) {
      r0 += red[(q * 2 + 0) * WTN + n_local];
      r1 += red[(q * 2 + 1) * WTN + n_local];
    }
    const size_t T = (size_t)p.tiles_h * p.tiles_w;
    p.partial[(((size_t)b * T + tile) * 2 + 0) * N + n] = r0;
    p.partial[(((size_t)b * T + tile) * 2 + 1) * N + n] = r1;
  }
}

}  // namespace

extern "C" {

// Output tile geometry, so the wrapper sizes the partial-statistics scratch.
int ragb_wino_tile_shape(int* tile_h, int* tile_w) {
  *tile_h = WH;
  *tile_w = WW;
  return 0;
}

// u: (16, C, N) bf16, variant mu * 4 + nu of U = G w G^T; the rest as K1's entry.
int ragb_resnet_conv3x3_stats_wino(const void* x, const float* a, const float* b, const void* u,
                                   const float* bias, const void* skip, const void* ws,
                                   const float* wsb, void* y, float* partial, float* stats, int T,
                                   int B, int H, int W, int C, int N, int Cs, int silu,
                                   int skip_mode, void* stream) {
  WinoArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a;
  p.b = b;
  p.w = static_cast<const bf16*>(u);
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
  p.tiles_w = (W + WW - 1) / WW;
  p.tiles_h = (H + WH - 1) / WH;
  if (H % 2 || W % 2 || C % 8 || N % 8 || p.Cs % 8) return (int)cudaErrorInvalidValue;
  if (a == nullptr || b == nullptr || bias == nullptr || partial == nullptr || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  if (T != p.tiles_w * p.tiles_h || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(wino_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)WINO_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.tiles_w * p.tiles_h, (N + WTN - 1) / WTN, B);
  wino_conv_kernel<<<grid, WTHREADS, WINO_SMEM, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<<<dim3((N + 31) / 32, B), dim3(32, 32), 0, s>>>(partial, stats, T, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
