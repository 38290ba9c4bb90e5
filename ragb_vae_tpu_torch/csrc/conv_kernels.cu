// The VAE's three stand-alone conv kernels for Hopper (sm_90a), NHWC bf16 in
// and out, as entry points over the shared implicit-GEMM template of
// conv_taps.cuh.
//
// Replaces three TPU kernels:
//   K9  `_downsample_kernel` of ragb_vae_tpu/ops/pallas/resnet_block.py
//       (driven by `_downsample_fwd_impl`, entry `fused_downsample_conv3x3_stats`):
//       conv3x3, stride 2, the bottom row and the right column zero-padded
//       (diffusers Downsample2D), + bias, with the per-channel (sum, sum of
//       squares) of the ROUNDED output. The TPU kernel views column pairs as
//       2C channels and pads each row tap to a dense K = 4C GEMM, a quarter
//       of it zeros, because its matrix unit wants dense 128-wide operands;
//       here the tap mode MODE_DOWN3 reads the nine taps at stride 2 from one
//       shared-memory slab, so only the 9C real products are computed.
//   K11 `_conv_kernel` of ragb_vae_tpu/ops/pallas/conv3x3.py (driven by
//       `_conv3x3_same_fwd_impl`, entry `conv3x3_same`): a bare conv3x3 SAME,
//       stride 1: no coefficients, no bias, no statistics. The TPU version
//       pads the input in a pass of its own so that every halo window is a
//       static slice; here the slab load masks the image edge.
//   K12 `_kernel` of ragb_vae_tpu/ops/pallas/fused_gn_silu_conv.py (driven by
//       `_fused_fwd_impl`, entry `fused_gn_silu_conv3x3`): silu(x*a + b) ->
//       conv3x3 SAME -> + bias, the activation rounded to bf16 in shared
//       memory and never written out; per-sample (B, C) coefficients.
//
// What bounds it on the H100: at the VAE's widths (C, N in 128..512) a conv3x3
// does 2*9*C operations per output element against about 2*(C + N) bytes per
// pixel, far above the bf16 ridge (~295 FLOP/byte): tensor-core operations
// bound all three (K9 does a quarter of the operations per input byte and is
// still above the ridge from C = 128 up). What the design does about it is the
// template's: one 64-pixel x 64-channel tile per block on wmma bf16 fragments
// with fp32 accumulation, each input element loaded once per K chunk into a
// halo'd slab that all nine taps read. K11 and K12 return no statistics, so
// they pass no partial buffer and the template skips its statistics passes;
// K9 uses the two-pass fixed-order statistics of K1 (per-block partials, then
// one ordered sum: no float atomics, bit-for-bit reproducible).
// C and N must be multiples of 8; tile edges are masked.

#include "conv_taps.cuh"

extern "C" {

// K11: y = conv3x3_same(x, w); x (B, H, W, C), w (3, 3, C, N)
int ragb_conv3x3_same(const void* x, const void* w, void* y, int B, int H, int W, int C, int N,
                      void* stream) {
  ConvArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<bf16*>(y);
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N;
  p.skip_mode = SKIP_NONE;
  return launch_conv<MODE_CONV3, EPI_FWD>(p, nullptr, 0, static_cast<cudaStream_t>(stream));
}

// K12: y = conv3x3_same(silu(x*a + b), w) + bias; a, b (B, C) fp32
int ragb_fused_gn_silu_conv3x3(const void* x, const float* a, const float* b, const void* w,
                               const float* bias, void* y, int B, int H, int W, int C, int N,
                               void* stream) {
  ConvArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a;
  p.b = b;
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.y = static_cast<bf16*>(y);
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N;
  p.silu = 1;
  p.skip_mode = SKIP_NONE;
  return launch_conv<MODE_CONV3, EPI_FWD>(p, nullptr, 0, static_cast<cudaStream_t>(stream));
}

// K9: x (B, Hin, Win, C) -> y (B, Hin / 2, Win / 2, N) and stats (B, 2, N)
int ragb_downsample_conv3x3_stats(const void* x, const void* w, const float* bias, void* y,
                                  float* partial, float* stats, int T, int B, int Hin, int Win,
                                  int C, int N, void* stream) {
  ConvArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.y = static_cast<bf16*>(y);
  p.partial = partial;
  p.B = B; p.H = Hin / 2; p.W = Win / 2; p.C = C; p.N = N;
  p.Hin = Hin; p.Win = Win;
  p.skip_mode = SKIP_NONE;
  if (p.H < 1 || p.W < 1) return (int)cudaErrorInvalidValue;
  return launch_conv<MODE_DOWN3, EPI_FWD>(p, stats, T, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
