// The fixed-order sum of per-tile statistics partials, shared by every conv
// kernel that writes the next GroupNorm's (sum, sum of squares) (K1, K2, K8,
// K9 and K6's (da, db)): each block writes one (B, T, 2, N) partial row, and
// this kernel adds them in one order. No float atomics, so the statistics, and
// everything downstream, are bit-for-bit reproducible.
#pragma once

#include "common.cuh"

namespace {

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

}  // namespace
