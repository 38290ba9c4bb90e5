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
// The kernel template itself is in conv_taps.cuh, shared with the backward
// kernels of resnet_block_bwd.cu; this file holds the forward entry points.
// Not yet done (later work): cp.async/TMA double buffering, wgmma.

#include "conv_taps.cuh"

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
  return launch_conv<MODE_CONV3, EPI_FWD>(p, stats, T, static_cast<cudaStream_t>(stream));
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
  return launch_conv<MODE_SUBPIXEL, EPI_FWD>(p, stats, T, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
