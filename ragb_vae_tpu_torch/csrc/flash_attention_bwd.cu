// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV of (BH, S, 128)
// bf16 attention, from q, k, v, dO, the forward's log-sum-exp and
// delta = rowsum(dO * O).
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` of
// ragb_vae_tpu/ops/pallas/flash_attention.py (driven by
// `flash_attention_bwd_3d`, the FlashAttention-2 backward of `_flash_kernel`):
//   S = scale * Q K^T in fp32, keys past the sequence end masked to -1e30,
//   P = exp(S - lse), dP = dO V^T, dS = P * (dP - delta) * scale,
//   dQ += bf16(dS) K, dV += bf16(P)^T dO, dK += bf16(dS)^T Q,
// with fp32 accumulators and one rounding of each output.
//
// What bounds it on the H100: per (Q tile, K/V tile) pair dQ takes
// 6*BQ*BK*D FLOPs and dK/dV 8*BQ*BK*D against a few tiles of bytes, far above
// the bf16 ridge at the FLUX sequence lengths (S = 2.3k..8.7k), so tensor-core
// FLOPs bound both and neither S, P nor dS may reach device memory.
//
// The TPU grid runs in order and carries dQ (or dK, dV) in scratch across its
// innermost axis. Here blocks run in no order, so every accumulator has one
// owner and no float atomic is needed (the backward is bitwise reproducible):
// - dQ kernel: one block per 128-row Q tile; it loops over the K/V tiles.
//   Each warp owns 16 query rows; Q and dO fragments and the fp32 dQ
//   accumulator live in registers in the mma.sync m16n8k16 layouts, exactly
//   as the forward keeps Q and O. S and dP are formed 16 keys at a time, the
//   dS registers of two adjacent 8-key tiles are the A operand of dS K, and
//   K is read back (transposed ldmatrix) as its B operand.
// - dK/dV kernel: one block per 128-row K/V tile; it loops over the Q tiles.
//   Each warp owns 16 key rows and forms the TRANSPOSED scores S^T = K Q^T
//   and dP^T = V dO^T directly (K, V as the A operand, the Q and dO tiles as
//   B), so P^T and dS^T come out of the accumulators already laid out as the
//   A operand of P^T dO and dS^T Q: no transpose through shared memory. lse
//   and delta belong to the columns here and are staged in shared memory.
// K/V tiles (dQ) and Q/dO tiles (dK/dV) are double-buffered with cp.async.
// Ragged ends: the dQ kernel re-reads the last key for rows past the end and
// masks them before the exp (P = 0); the dK/dV kernel zero-fills query rows
// past the end and gives them lse = +1e30 (P = 0), and never reads lse or
// delta past Sq. Not yet done (later work): wgmma, TMA, warp specialisation.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int D = 128;
constexpr int LD = D + 8;  // row stride (elements) of every staged tile

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------
struct DqTile {
  static constexpr int BQ = 128;  // 8 warps x 16 query rows
  static constexpr int BK = 64;
  static constexpr int NT = 256;
  static constexpr int TILE = BK * LD;
  static constexpr size_t bytes = ((size_t)BQ * LD + 4 * (size_t)TILE) * 2;
};

__global__ void __launch_bounds__(DqTile::NT)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Sk, float scale) {
  using L = DqTile;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // Q, then dO
  bf16* Ks = Qs + BQ * LD;                        // [2][BK][LD]
  bf16* Vs = Ks + 2 * L::TILE;                    // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 7, lsel = lane >> 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  const int n_tiles = (Sk + BK - 1) / BK;
  const float scale_log2 = scale * LOG2E;

  // rows past the end re-read the last key; the mask below gives them P = 0
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const size_t off = (size_t)min(k0 + r, Sk - 1) * D + c;
      cp_async16(Ks + buf * L::TILE + r * LD + c, kb + off, 16);
      cp_async16(Vs + buf * L::TILE + r * LD + c, vb + off, 16);
    }
    cp_async_commit();
  };
  // a (BQ, D) tile of q or dO as A fragments, rows past Sq zero
  auto load_rows = [&](const bf16* src, uint32_t (&frag)[D / 16][4]) {
    const bf16* base = src + (size_t)bh * Sq * D;
    for (int i = tid; i < BQ * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 val = zero_vec();
      if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * D + c);
      *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      ldmatrix_x4(frag[kc], Qs + (warp * 16 + lrow + (lsel & 1) * 8) * LD + kc * 16 + (lsel >> 1) * 8);
    __syncthreads();
  };

  load_kv(0, 0);
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_rows(q, qf);
  load_rows(dout, dof);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const size_t rbase = (size_t)bh * Sq;
  const float lse0 = row0 < Sq ? lse[rbase + row0] * LOG2E : 0.0f;
  const float lse1 = row1 < Sq ? lse[rbase + row1] * LOG2E : 0.0f;
  const float dl0 = row0 < Sq ? delta[rbase + row0] : 0.0f;
  const float dl1 = row1 < Sq ? delta[rbase + row1] : 0.0f;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * L::TILE;
    const bf16* Vt = Vs + (it & 1) * L::TILE;

#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      // S and dP for 16 keys: two 8-key tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.0f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.0f;
        const int key_row = (c * 2 + h) * 8 + lrow;
#pragma unroll
        for (int kc = 0; kc < D / 16; kc += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, Kt + key_row * LD + kc * 16 + lsel * 8);
          mma_16816(s[h], qf[kc], b[0], b[1]);
          mma_16816(s[h], qf[kc + 1], b[2], b[3]);
          ldmatrix_x4(b, Vt + key_row * LD + kc * 16 + lsel * 8);
          mma_16816(dp[h], dof[kc], b[0], b[1]);
          mma_16816(dp[h], dof[kc + 1], b[2], b[3]);
        }
      }
      // dS = P (dP - delta) scale, rounded to bf16 as the A operand of dS K
      uint32_t dsf[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds0[2], ds1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = k0 + (c * 2 + h) * 8 + t * 2 + e < Sk;
          const float s0 = valid ? s[h][e] * scale_log2 : NEG_INF;
          const float s1 = valid ? s[h][2 + e] * scale_log2 : NEG_INF;
          ds0[e] = exp2f(s0 - lse0) * (dp[h][e] - dl0) * scale;
          ds1[e] = exp2f(s1 - lse1) * (dp[h][2 + e] - dl1) * scale;
        }
        dsf[h * 2 + 0] = pack_bf16x2(ds0[0], ds0[1]);
        dsf[h * 2 + 1] = pack_bf16x2(ds1[0], ds1[1]);
      }
      // dQ += dS K: transposed ldmatrix of (keys 0-7 | 8-15) x (d | d+8)
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Kt + (c * 16 + lrow + (lsel & 1) * 8) * LD + nt * 8 + (lsel >> 1) * 8);
        mma_16816(acc[nt], dsf, b[0], b[1]);
        mma_16816(acc[nt + 1], dsf, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the load two tiles on
  }

  bf16* ob = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int d = nt * 8 + t * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * D + d) = pack_bf16x2(acc[nt][0], acc[nt][1]);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * D + d) = pack_bf16x2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------
struct DkvTile {
  static constexpr int BKV = 128;  // 8 warps x 16 key rows
  static constexpr int BQ = 64;
  static constexpr int NT = 256;
  static constexpr int QTILE = BQ * LD;
  static constexpr size_t row_off = (2 * (size_t)BKV * LD + 4 * (size_t)QTILE) * 2;
  static constexpr size_t bytes = row_off + 4 * (size_t)BQ * sizeof(float);
};

__global__ void __launch_bounds__(DkvTile::NT)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, float scale) {
  using L = DkvTile;
  constexpr int BKV = L::BKV, BQ = L::BQ, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                       // [BKV][LD]
  bf16* Qs = Vs + BKV * LD;                       // [2][BQ][LD]
  bf16* Os = Qs + 2 * L::QTILE;                   // [2][BQ][LD], the dO tiles
  float* lse_s = reinterpret_cast<float*>(smem_raw + L::row_off);  // [2][BQ], times log2 e
  float* dl_s = lse_s + 2 * BQ;                                    // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 7, lsel = lane >> 3;
  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * BKV;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* ob = dout + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  const size_t rbase = (size_t)bh * Sq;
  const int n_tiles = (Sq + BQ - 1) / BQ;
  const float scale_log2 = scale * LOG2E;

  // query rows past the end: q and dO zero, lse = +1e30 so that P = 0; lse
  // and delta are not defined there and are not read
  auto load_q = [&](int tile, int buf) {
    const int r0 = tile * BQ;
    for (int i = tid; i < BQ * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = r0 + r < Sq;
      const size_t off = (size_t)(ok ? r0 + r : 0) * D + c;
      cp_async16(Qs + buf * L::QTILE + r * LD + c, qb + off, ok ? 16 : 0);
      cp_async16(Os + buf * L::QTILE + r * LD + c, ob + off, ok ? 16 : 0);
    }
    if (tid < BQ) {
      const bool ok = r0 + tid < Sq;
      lse_s[buf * BQ + tid] = ok ? lse[rbase + r0 + tid] * LOG2E : 1e30f;
      dl_s[buf * BQ + tid] = ok ? delta[rbase + r0 + tid] : 0.0f;
    }
    cp_async_commit();
  };

  // this block's K and V rows (zero past the end; those rows are never stored)
  for (int i = tid; i < BKV * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = kv0 + r < Sk;
    const size_t off = (size_t)(ok ? kv0 + r : 0) * D + c;
    cp_async16(Ks + r * LD + c, kb + off, ok ? 16 : 0);
    cp_async16(Vs + r * LD + c, vb + off, ok ? 16 : 0);
  }
  load_q(0, 0);  // commits the K, V copies with the first Q tile
  cp_async_wait<0>();
  __syncthreads();

  // K as A fragments stay in registers; V fragments are re-read per use
  const bf16* a_row = Ks + (warp * 16 + lrow + (lsel & 1) * 8) * LD + (lsel >> 1) * 8;
  const bf16* v_row = Vs + (warp * 16 + lrow + (lsel & 1) * 8) * LD + (lsel >> 1) * 8;
  uint32_t kf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ldmatrix_x4(kf[kc], a_row + kc * 16);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    dk_acc[nt][0] = dk_acc[nt][1] = dk_acc[nt][2] = dk_acc[nt][3] = 0.0f;
    dv_acc[nt][0] = dv_acc[nt][1] = dv_acc[nt][2] = dv_acc[nt][3] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (it & 1) * L::QTILE;
    const bf16* Ot = Os + (it & 1) * L::QTILE;
    const float* lse_t = lse_s + (it & 1) * BQ;
    const float* dl_t = dl_s + (it & 1) * BQ;

#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      // S^T = K Q^T and dP^T = V dO^T for 16 queries: rows are keys here
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.0f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.0f;
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; kc += 2) {
        uint32_t va[2][4];
        ldmatrix_x4(va[0], v_row + kc * 16);
        ldmatrix_x4(va[1], v_row + (kc + 1) * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q_row = (c * 2 + h) * 8 + lrow;
          uint32_t b[4];
          ldmatrix_x4(b, Qt + q_row * LD + kc * 16 + lsel * 8);
          mma_16816(s[h], kf[kc], b[0], b[1]);
          mma_16816(s[h], kf[kc + 1], b[2], b[3]);
          ldmatrix_x4(b, Ot + q_row * LD + kc * 16 + lsel * 8);
          mma_16816(dp[h], va[0], b[0], b[1]);
          mma_16816(dp[h], va[1], b[2], b[3]);
        }
      }
      // P^T and dS^T, rounded to bf16 as A operands (lse, delta per column)
      uint32_t pf[4], dsf[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0[2], p1[2], ds0[2], ds1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = (c * 2 + h) * 8 + t * 2 + e;
          const float l = lse_t[qi], dl = dl_t[qi];
          p0[e] = exp2f(s[h][e] * scale_log2 - l);
          p1[e] = exp2f(s[h][2 + e] * scale_log2 - l);
          ds0[e] = p0[e] * (dp[h][e] - dl) * scale;
          ds1[e] = p1[e] * (dp[h][2 + e] - dl) * scale;
        }
        pf[h * 2 + 0] = pack_bf16x2(p0[0], p0[1]);
        pf[h * 2 + 1] = pack_bf16x2(p1[0], p1[1]);
        dsf[h * 2 + 0] = pack_bf16x2(ds0[0], ds0[1]);
        dsf[h * 2 + 1] = pack_bf16x2(ds1[0], ds1[1]);
      }
      // dV += P^T dO, dK += dS^T Q over these 16 queries
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        const int off = (c * 16 + lrow + (lsel & 1) * 8) * LD + nt * 8 + (lsel >> 1) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ot + off);
        mma_16816(dv_acc[nt], pf, b[0], b[1]);
        mma_16816(dv_acc[nt + 1], pf, b[2], b[3]);
        ldmatrix_x4_trans(b, Qt + off);
        mma_16816(dk_acc[nt], dsf, b[0], b[1]);
        mma_16816(dk_acc[nt + 1], dsf, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the load two tiles on
  }

  const int row0 = kv0 + warp * 16 + g, row1 = row0 + 8;
  bf16* dkb = dk + (size_t)bh * Sk * D;
  bf16* dvb = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int d = nt * 8 + t * 2;
    if (row0 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)row0 * D + d) = pack_bf16x2(dk_acc[nt][0], dk_acc[nt][1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)row0 * D + d) = pack_bf16x2(dv_acc[nt][0], dv_acc[nt][1]);
    }
    if (row1 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)row1 * D + d) = pack_bf16x2(dk_acc[nt][2], dk_acc[nt][3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)row1 * D + d) = pack_bf16x2(dv_acc[nt][2], dv_acc[nt][3]);
    }
  }
}

bool bad_shape(int BH, int Sq, int Sk, int d) {
  return BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 65535 || d != D;
}

}  // namespace

extern "C" int ragb_flash_attention_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dq, int BH, int Sq, int Sk, int d, float scale,
                                       void* stream) {
  if (bad_shape(BH, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DqTile::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + DqTile::BQ - 1) / DqTile::BQ, BH);
  flash_dq_kernel<<<grid, DqTile::NT, DqTile::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), Sq, Sk, scale);
  return (int)cudaGetLastError();
}

extern "C" int ragb_flash_attention_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dk, void* dv, int BH, int Sq, int Sk, int d,
                                        float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DkvTile::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + DkvTile::BKV - 1) / DkvTile::BKV, BH);
  flash_dkv_kernel<<<grid, DkvTile::NT, DkvTile::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Sq, Sk, scale);
  return (int)cudaGetLastError();
}
