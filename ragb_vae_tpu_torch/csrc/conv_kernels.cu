// The VAE's three stand-alone conv kernels for Hopper (sm_90a), NHWC bf16 in
// and out, all three on the TMA-fed wgmma implicit-GEMM engine of
// conv_sm90.cuh (`conv_sm90_kernel<MODE>`): K11 in mode CONV_SAME, K9 in
// CONV_DOWN, K12 in CONV_ACT (K1's mode, with no skip and no statistics:
// an activation stage rewrites each TMA-loaded slab in shared memory).
//
// Replaces three TPU kernels:
//   K9  `_downsample_kernel` of ragb_vae_tpu/ops/pallas/resnet_block.py
//       (driven by `_downsample_fwd_impl`, entry `fused_downsample_conv3x3_stats`):
//       conv3x3, stride 2, the bottom row and the right column zero-padded
//       (diffusers Downsample2D), + bias, with the per-channel (sum, sum of
//       squares) of the ROUNDED output. The TPU kernel views column pairs as
//       2C channels and pads each row tap to a dense K = 4C GEMM, a quarter
//       of it zeros, because its matrix unit wants dense 128-wide operands;
//       here TMA reads each tap's input box at traversal stride 2, so only the
//       9C real products are computed, and its zero fill is the padding.
//   K11 `_conv_kernel` of ragb_vae_tpu/ops/pallas/conv3x3.py (driven by
//       `_conv3x3_same_fwd_impl`, entry `conv3x3_same`): a bare conv3x3 SAME,
//       stride 1: no coefficients, no bias, no statistics. The TPU version
//       pads the input in a pass of its own; here TMA's zero fill of the boxes
//       that start above or left of the image is the padding.
//   K12 `_kernel` of ragb_vae_tpu/ops/pallas/fused_gn_silu_conv.py (driven by
//       `_fused_fwd_impl`, entry `fused_gn_silu_conv3x3`): silu(x*a + b) ->
//       conv3x3 SAME -> + bias, the activation rounded to bf16 in shared
//       memory and never written out (0 in the halo: SAME padding pads the
//       activated value); per-sample (B, C) coefficients.
//
// What bounds it on the H100, each of the three: at the VAE's widths (C, N
// in 128..512) a conv3x3 does 2*9*C operations per output element against
// about 2*(C + N) bytes per pixel, above the bf16 ridge (~295 FLOP/byte):
// tensor-core operations bound K11, K12 and K9 at C = 512; K9 at C = 128
// over a 512^2 input does a quarter of the operations per input byte and is
// bound by bytes. conv_sm90.cuh says what its design does about it. K9 uses
// fixed-order statistics (per-tile partials, then one ordered sum: no float
// atomics, bit-for-bit reproducible). C and N must be multiples of 8; the
// TMA boxes' zero fill and the TMA stores take the ragged tile edges.

#include "conv_sm90.cuh"

extern "C" {

// the output tile (rows, cols) of the conv engine, the same in every mode:
// K9's, K1's and K6's partials hold one row per tile of an image
int ragb_conv_sm90_tile_shape(int* tile_h, int* tile_w) {
  *tile_h = ConvSm90<CONV_DOWN>::TH;
  *tile_w = ConvSm90<CONV_DOWN>::TW;
  return 0;
}

// K11: y = conv3x3_same(x, w); x (B, H, W, C), w (3, 3, C, N)
int ragb_conv3x3_same(const void* x, const void* w, void* y, int B, int H, int W, int C, int N,
                      void* stream) {
  return launch_conv_sm90<CONV_SAME>(x, w, nullptr, y, nullptr, nullptr, 0, B, H, W, C, N,
                                     static_cast<cudaStream_t>(stream));
}

// K12: y = conv3x3_same(silu(x*a + b), w) + bias; a, b (B, C) fp32
int ragb_fused_gn_silu_conv3x3(const void* x, const float* a, const float* b, const void* w,
                               const float* bias, void* y, int B, int H, int W, int C, int N,
                               void* stream) {
  const ConvSm90Act op{nullptr, a, b, nullptr, 1};
  return launch_conv_sm90<CONV_ACT>(x, w, bias, y, nullptr, nullptr, 0, B, H, W, C, N,
                                    static_cast<cudaStream_t>(stream), &op);
}

// K9: x (B, Hin, Win, C) -> y (B, Hin / 2, Win / 2, N) and stats (B, 2, N);
// partial (B, T, 2, N) with T the engine's tiles of one output image
int ragb_downsample_conv3x3_stats(const void* x, const void* w, const float* bias, void* y,
                                  float* partial, float* stats, int T, int B, int Hin, int Win,
                                  int C, int N, void* stream) {
  return launch_conv_sm90<CONV_DOWN>(x, w, bias, y, partial, stats, T, B, Hin, Win, C, N,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
