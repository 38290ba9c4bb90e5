// Backward of the whole-resnet-block conv kernels for Hopper (sm_90a).
//
// Replaces two TPU kernels of ragb_vae_tpu/ops/pallas/resnet_block.py:
//   K6 `_bwd_kernel` (driven by `_chain_bwd_impl`): every cotangent of
//      y = conv3x3(act(x*a + b)) + bias [+ skip | + skip @ ws + wsb] with the
//      (sum, sumsq) statistics of y, in one entry point:
//        dye   = g + ds0 + 2*y*ds1                  (stats-chain cotangent)
//        dA    = conv3x3(dye, flipped-transposed W)
//        dx    = dA * act'(t) * a,  t = x*a + b recomputed from x
//        da,db = per-(B, C) sums of dA*act'(t)*x and dA*act'(t)
//        dW    = A-patches^T @ dye,  A = act(t) rounded to bf16
//        dbias = sum dye;  dskip = dye | dye @ ws^T;  dws = skip^T @ dye
//   K7 `_subpixel_bwd_kernel` (driven by `_subpixel_bwd_impl`): every
//      cotangent of the nearest-2x upsample + conv3x3: dye on the (2H, 2W)
//      grid, dx as a stride-2 4x4 conv of dye over doubly folded weights, the
//      gradient of the FOLDED weights (unfolded by the wrapper), dbias.
// One TPU kernel becomes several __global__ functions behind one C entry
// point: an elementwise dye pass, a data-gradient conv, a weight-gradient
// GEMM, and fixed-order reduces.
//
// What bounds it on the H100: the data gradient and the weight gradient are
// each a GEMM of the forward's size (2*9*C*N FLOPs per pixel against a few
// (C+N) bytes), far above the bf16 ridge (~295 FLOP/byte): tensor-core FLOPs
// bound them; the dye pass and the reduces are bytes-bound and small.
//
// K6's design: (1) dye is formed ONCE, in fp32 from bf16 g, bf16 y and the
// fp32 statistics cotangent, rounded to bf16 and stored (it is dskip itself
// under an identity skip), so both GEMMs stream one operand instead of two
// and dbias falls out of the same pass; (2) the data gradient runs on the
// Hopper conv engine (conv_sm90.cuh, K11's TMA + wgmma mainloop) with the
// chain rule through act(x*a + b) in its epilogue, which also writes
// A = bf16(act(t)) once, a scratch the size of x that lives for this call;
// (3) the weight gradient is the TMA + wgmma split-K GEMM of wgrad_sm90.cuh
// over A, whose zero fill is the SAME padding (dws is its 1-tap case over
// the skip); (4) dskip = dye @ ws^T is the conv engine's one-tap mode
// (CONV_1X1): dye by TMA a 64-channel box at a time, ws (Cs, N) as it lies
// as the K-major B operand, dskip out by TMA stores. dskip moves 2 bytes an
// output and reads dye once per 128 of its channels: bytes bound it, and the
// engine's 4-box A ring keeps the next chunks' loads under the products.
// The TPU grid ran in order and kept dW, da, db,
// dbias in scratch across all steps; CUDA blocks run in parallel, so every
// cross-block sum goes through per-tile or per-slice fp32 partials and a
// second kernel that adds them in a fixed order: no float atomics, so a
// training step is bit-for-bit reproducible.
// K7's design: the same dye pass; dx on the conv engine's CONV_UP_DX mode
// (dye read as four parity planes, one TMA slab each a 64-channel chunk,
// the plane's 2 x 2 taps as row offsets); the gradient of the folded
// weights on wgrad_sm90.cuh's sub-pixel variant (a block per (pa, pb, u),
// raw x as A, whose zero fill is the padding, dye's parity pixels by a
// stride-2 box), split-K with a fixed-order slice sum; it recomputes nothing.
// Rounding points follow the TPU kernel: dye rounded to bf16 before the
// GEMMs, dA kept in fp32 through the chain rule, A rounded to bf16 for dW,
// dx and dskip rounded once on store; SAME padding zeroes A and dye outside
// the image, not x.

#include "conv_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// dye = bf16(g + ds0 + 2*y*ds1), and per-slice column sums of the rounded dye
// ---------------------------------------------------------------------------
// grid (S, B), block (N/8, PL): thread (v, l) owns channels 8v..8v+7 and the
// pixels l, l+PL, ... of its slice; partial is (B*S, N).
__global__ void dye_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                           const float* __restrict__ ds, bf16* __restrict__ dye,
                           float* __restrict__ partial, int HW, int N, int S) {
  extern __shared__ float dye_red[];     // (PL, N)
  const int b = blockIdx.y, s = blockIdx.x;
  const int pps = (HW + S - 1) / S;
  const int p_end = min(HW, (s + 1) * pps);
  const int n0 = threadIdx.x * 8;
  float ds0[8], ds1[8], acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ds0[j] = ds[((size_t)b * 2 + 0) * N + n0 + j];
    ds1[j] = 2.0f * ds[((size_t)b * 2 + 1) * N + n0 + j];
    acc[j] = 0.0f;
  }
  for (int pix = s * pps + threadIdx.y; pix < p_end; pix += blockDim.y) {
    const size_t idx = ((size_t)b * HW + pix) * N + n0;
    const uint4 graw = *reinterpret_cast<const uint4*>(g + idx);
    const uint4 yraw = *reinterpret_cast<const uint4*>(y + idx);
    const bf16* gv = reinterpret_cast<const bf16*>(&graw);
    const bf16* yv = reinterpret_cast<const bf16*>(&yraw);
    bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = __float2bfloat16(__bfloat162float(gv[j]) + ds0[j] + __bfloat162float(yv[j]) * ds1[j]);
      acc[j] += __bfloat162float(o[j]);
    }
    *reinterpret_cast<uint4*>(dye + idx) = *reinterpret_cast<const uint4*>(o);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dye_red[threadIdx.y * N + n0 + j] = acc[j];
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float t = 0.0f;
      for (int l = 0; l < blockDim.y; ++l) t += dye_red[l * N + n0 + j];
      partial[((size_t)b * S + s) * N + n0 + j] = t;
    }
  }
}

// out[m] = sum over r < R of partial[r*M + m], in a fixed order: lane j adds
// rows j, j+32, ... in sequence, then lane 0 adds the 32 lanes.
__global__ void reduce_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int R, size_t M) {
  __shared__ float red[32][33];
  const size_t m = (size_t)blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (m < M)
    for (int r = threadIdx.y; r < R; r += 32) s += partial[(size_t)r * M + m];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && m < M) {
    float t = 0.0f;
    for (int j = 0; j < 32; ++j) t += red[j][threadIdx.x];
    out[m] = t;
  }
}

int launch_reduce_rows(const float* partial, float* out, int R, size_t M, cudaStream_t stream) {
  reduce_rows_kernel<<<(unsigned)((M + 31) / 32), dim3(32, 32), 0, stream>>>(partial, out, R, M);
  return (int)cudaGetLastError();
}

int launch_dye(const bf16* g, const bf16* y, const float* ds, bf16* dye, float* partial,
               float* dbias, int B, int HW, int N, int S, cudaStream_t stream) {
  const int nv = N / 8;
  if (N % 8 || nv > 1024 || S < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int pl = nv >= 256 ? 1 : 256 / nv;
  const size_t smem = (size_t)pl * N * sizeof(float);
  dye_kernel<<<dim3(S, B), dim3(nv, pl), smem, stream>>>(g, y, ds, dye, partial, HW, N, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce_rows(partial, dbias, B * S, (size_t)N, stream);
}

}  // namespace

extern "C" {

// K6. Scratch and outputs are the wrapper's: dye (B, H, W, N) bf16 (it IS
// dskip under an identity skip), act (B, H, W, C) bf16 (A, written by the
// data gradient, read by the weight gradient), dbias_partial (B*S_dye, N),
// dab_partial (B, T, 2, C) with T the conv engine's tiles of one image,
// dw_partial (S_w, 3, 3, C, N), dws_partial (S_ws, Cs, N). wt is w flipped
// and transposed, (3, 3, N, C); ws is the projection's weight as it lies, (Cs, N).
int ragb_resnet_conv3x3_stats_bwd(
    const void* x, const float* a, const float* b, const void* wt, const void* skip,
    const void* ws, const void* y, const void* gy, const float* gstats,
    void* dye, void* act, void* dx, float* dab, float* dw, float* dbias, void* dskip, float* dws,
    float* dbias_partial, float* dab_partial, float* dw_partial, float* dws_partial,
    int T, int S_dye, int S_w, int S_ws, int B, int H, int W, int C, int N, int Cs, int silu,
    int skip_mode, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = launch_dye(static_cast<const bf16*>(gy), static_cast<const bf16*>(y), gstats,
                       static_cast<bf16*>(dye), dbias_partial, dbias, B, H * W, N, S_dye, stream);
  if (err) return err;

  // dA = conv3x3(dye, wt) on the conv engine, the chain rule through act in its
  // epilogue: dx, A and the (da, db) partials, then their fixed-order sum
  const ConvSm90Act op{x, a, b, act, silu};
  err = launch_conv_sm90<CONV_BWD>(dye, wt, nullptr, dx, dab_partial, dab, T, B, H, W, N, C, stream, &op);
  if (err) return err;

  err = launch_wgrad_sm90<3>(act, dye, dw_partial, dw, S_w, B, H, W, C, N, stream);
  if (err) return err;

  if (skip_mode == SKIP_PROJ) {
    // dskip = dye @ ws^T on the conv engine's one-tap mode
    err = launch_conv_sm90<CONV_1X1>(dye, ws, nullptr, dskip, nullptr, nullptr, 0, B, H, W, N, Cs, stream);
    if (err) return err;
    err = launch_wgrad_sm90<1>(skip, dye, dws_partial, dws, S_ws, B, H, W, Cs, N, stream);   // dws = skip^T @ dye
    if (err) return err;
  }
  return 0;
}

// K7. x (B, H, W, C); y, gy, dye (B, 2H, 2W, N); wb (4, 4, N, C) the doubly
// folded transposed weights; dwf (2, 2, 2, 2C, N) the folded weights'
// gradient; dbias_partial (B*S_dye, N), dwf_partial (S_w, 2, 2, 2, 2C, N).
int ragb_subpixel_upsample_conv3x3_stats_bwd(
    const void* x, const void* wb, const void* y, const void* gy, const float* gstats,
    void* dye, void* dx, float* dwf, float* dbias, float* dbias_partial, float* dwf_partial,
    int S_dye, int S_w, int B, int H, int W, int C, int N, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = launch_dye(static_cast<const bf16*>(gy), static_cast<const bf16*>(y), gstats,
                       static_cast<bf16*>(dye), dbias_partial, dbias, B, 4 * H * W, N, S_dye,
                       stream);
  if (err) return err;

  // dx = the stride-2 conv4x4 of dye over wb, on the conv engine
  err = launch_conv_sm90<CONV_UP_DX>(dye, wb, nullptr, dx, nullptr, nullptr, 0, B, 2 * H, 2 * W, N, C, stream);
  if (err) return err;

  // the folded weights' gradient: S_w fp32 partials, then their fixed-order sum
  return launch_wgrad_sm90<SUBPIXEL_TAPS>(x, dye, dwf_partial, dwf, S_w, B, H, W, C, N, stream);
}

// K6's dskip alone, for measuring it and holding it against dye @ ws^T:
// dye (B, H, W, N), ws (Cs, N), dskip (B, H, W, Cs).
int ragb_resnet_skip_grad(const void* dye, const void* ws, void* dskip, int B, int H, int W, int N, int Cs,
                          void* stream) {
  return launch_conv_sm90<CONV_1X1>(dye, ws, nullptr, dskip, nullptr, nullptr, 0, B, H, W, N, Cs,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
