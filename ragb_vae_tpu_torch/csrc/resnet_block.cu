// Whole-resnet-block conv kernels for Hopper (sm_90a), NHWC bf16 in and out.
//
// Replaces two TPU kernels of ragb_vae_tpu/ops/pallas/resnet_block.py:
//   K1 `_kernel` (:69, driven by `_chain_fwd_impl`, entry
//      `gn_silu_conv3x3_stats`):
//      y = conv3x3(act(x*a + b)) + bias [+ skip | + skip @ ws + wsb]
//   K2 `_subpixel_kernel` (:231, driven by `_subpixel_fwd_impl`, entry
//      `fused_upsample_conv3x3_stats`): nearest-2x upsample + conv3x3 + bias
//      computed as four 2x2 "parity" convs on the small grid.
// Both end in the same epilogue: the output is rounded to bf16 and stored,
// and fp32 per-channel (sum, sum of squares) of the ROUNDED output are
// accumulated, the next GroupNorm's statistics.
//
// What bounds it on the H100: at the VAE's widths (C, N in 128..512) a conv
// does 2*9*C FLOPs per output element against ~2*(C+N) bytes of traffic, so
// it sits well above the bf16 ridge (~295 FLOP/byte): tensor-core FLOPs bound
// it.
//
// K1 runs on the Hopper conv engine (conv_sm90.cuh, mode CONV_ACT): TMA
// brings each 64-channel chunk's halo'd slab of raw x, an activation stage
// (three warps that issue no wgmma) rewrites it in shared memory to
// bf16(act(x*a + b)) with 0 outside the image and past channel C (SAME
// padding pads the activated value), and two consumer warpgroups run K11's
// wgmma mainloop over it; the 1x1 projection is an extra K loop over the raw
// skip into the same accumulators, the identity skip comes by TMA into the
// drained ring, and the epilogue adds bias (+ wsb) and the skip to the fp32
// accumulators, rounds once, stores by TMA and writes one statistics partial
// row a block. conv_sm90.cuh says what each part of the design does about
// the bound.
// K2 runs on the same engine's CONV_UP mode: K11's halo'd slab of x a
// 64-channel chunk, the four 2x2 taps of one output parity (pa, pb) as row
// offsets into it, the folded weights as (16, C, N) through a 3-D map, bias,
// one rounding, and a TMA store through the parity's strided view of y (rows
// 2h + pa, columns 2w + pb); K9's statistics partial rows, one per (parity,
// tile).
// TPU grids run in order and carried the statistics across row tiles; CUDA
// blocks run in parallel, so each block writes its partial sums to a scratch
// and a second small kernel (stats_reduce.cuh) sums them in a fixed order:
// no float atomics, so the statistics, and everything downstream, are
// bit-for-bit reproducible. C, N (and K1's Cs) must be multiples of 8, which
// the wrapper checks.

#include "conv_sm90.cuh"

extern "C" {

const char* ragb_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// K1: x (B, H, W, C), a, b (B, C) fp32, w (3, 3, C, N), bias (N,) fp32; skip
// (B, H, W, N) for skip_mode SKIP_ADD or (B, H, W, Cs) with ws (Cs, N) and
// wsb (N,) fp32 for SKIP_PROJ; y (B, H, W, N), stats (B, 2, N) and partial
// (B, T, 2, N) with T the conv engine's tiles of one image
// (ragb_conv_sm90_tile_shape).
int ragb_resnet_conv3x3_stats(const void* x, const float* a, const float* b, const void* w,
                              const float* bias, const void* skip, const void* ws,
                              const float* wsb, void* y, float* partial, float* stats, int T,
                              int B, int H, int W, int C, int N, int Cs, int silu, int skip_mode,
                              void* stream) {
  if (partial == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  const ConvSm90Act op{nullptr, a, b, nullptr, silu, skip, ws, wsb, skip_mode == SKIP_PROJ ? Cs : 0, skip_mode};
  return launch_conv_sm90<CONV_ACT>(x, w, bias, y, partial, stats, T, B, H, W, C, N,
                                    static_cast<cudaStream_t>(stream), &op);
}

// K2: x (B, H, W, C), w_fold (2, 2, 2, 2C, N) the folded weights, bias (N,)
// fp32; y (B, 2H, 2W, N), stats (B, 2, N) and partial (B, T, 2, N) with T
// four times the conv engine's tiles of one small image (one per parity).
int ragb_subpixel_upsample_conv3x3_stats(const void* x, const void* w_fold, const float* bias,
                                         void* y, float* partial, float* stats, int T, int B,
                                         int H, int W, int C, int N, void* stream) {
  return launch_conv_sm90<CONV_UP>(x, w_fold, bias, y, partial, stats, T, B, H, W, C, N,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
