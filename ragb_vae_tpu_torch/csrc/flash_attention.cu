// Flash-attention forward for Hopper (sm_90a): (BH, S, D) bf16 in and out.
//
// Replaces the TPU kernel `_flash_kernel` of
// ragb_vae_tpu/ops/pallas/flash_attention.py (driven by `_flash_fwd_impl`,
// entry `attention`): online-softmax attention with fp32 logits, running
// (max, sum) and output accumulator, keys past the sequence end masked with
// -1e30, and the per-row log-sum-exp written beside the output.
//
// What bounds it on the H100: for one (Q tile, K/V tile) pair the block does
// 4*BQ*BK*D FLOPs against (BQ + 2*BK)*D*2 bytes, far above the bf16 ridge at
// the sequence lengths of this system (FLUX: S = 2.3k..8.7k, d = 128; VAE
// mid-block: S = 4k..16k, d = 512), so tensor-core FLOPs bound it and the
// S x S logits must never reach device memory. Everything of one Q tile stays
// on chip, in two variants:
// - d = 128 (the FLUX blocks, 57 launches per sampler step): the
//   FlashAttention-2 layout. Each warp owns 16 query rows; Q fragments, the
//   fp32 scores and the fp32 output accumulator live in registers in the
//   mma.sync m16n8k16 layouts, the softmax runs on them with quad shuffles,
//   and the score registers are re-packed as the A operand of P V, so only
//   the K and V tiles go through shared memory.
// - d = 512 (the VAE mid-block, 2 launches per request): a 16-row fragment of
//   the output alone would take 256 registers a thread, so the accumulator
//   sits in shared memory and both products run through nvcuda::wmma bf16
//   fragments (32-row Q and K tiles, ~170 KB of shared memory).
// Both variants need more than the 48 KB static limit: the launcher raises
// the dynamic shared-memory attribute and returns the launch error.
// Not yet done (later work): wgmma and TMA in both variants; the d = 128
// variant double-buffers its K/V tiles with cp.async, the d = 512 variant
// loads them synchronously, one tile at a time.

#include "common.cuh"
#include "mma.cuh"

using namespace nvcuda;

namespace {

constexpr float NEG_INF = -1e30f;

// d = 512: shared-memory accumulator, wmma products
template <int D>
struct SmemFlash {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int NW = 4;
  static constexpr int QLD = D + 8;    // bf16 row stride of Q, K, V tiles
  static constexpr int SLD = BK + 4;   // fp32 row stride of the score tile
  static constexpr int PLD = BK + 8;   // bf16 row stride of the probability tile
  static constexpr int OLD = D + 4;    // fp32 row stride of the output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)BQ * QLD * 2;
  static constexpr size_t v_off = k_off + (size_t)BK * QLD * 2;
  static constexpr size_t s_off = v_off + (size_t)BK * QLD * 2;
  static constexpr size_t p_off = s_off + (size_t)BQ * SLD * 4;
  static constexpr size_t o_off = p_off + (size_t)BQ * PLD * 2;
  static constexpr size_t m_off = o_off + (size_t)BQ * OLD * 4;
  static constexpr size_t l_off = m_off + (size_t)BQ * 4;
  static constexpr size_t bytes = l_off + (size_t)BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(SmemFlash<D>::NW * 32)
    flash_fwd_smem_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Sk, float scale) {
  using L = SmemFlash<D>;
  constexpr int BQ = L::BQ, BK = L::BK, NW = L::NW, NT = NW * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L::p_off);
  float* Os = reinterpret_cast<float*>(smem_raw + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem_raw + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem_raw + L::l_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;

  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = zero_vec();
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * L::QLD + c) = val;
  }
  for (int i = tid; i < BQ * D; i += NT) Os[(i / D) * L::OLD + i % D] = 0.0f;
  for (int i = tid; i < BQ; i += NT) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile's P V no longer reads Ks, Vs, Ps
    for (int i = tid; i < BK * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = zero_vec(), vv = zero_vec();
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::QLD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * L::QLD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T, one 16x16 fragment per step, spread over the warps
    for (int f = warp; f < (BQ / 16) * (BK / 16); f += NW) {
      const int fr = f / (BK / 16), fc = f % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + fr * 16 * L::QLD + d0, L::QLD);
        wmma::load_matrix_sync(fb, Ks + fc * 16 * L::QLD + d0, L::QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + fr * 16 * L::SLD + fc * 16, acc, L::SLD, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one row per warp
    for (int r = warp; r < BQ; r += NW) {
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) {
        float s = Ss[r * L::SLD + j] * scale;
        if (k0 + j >= Sk) s = NEG_INF;
        Ss[r * L::SLD + j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float pj = expf(Ss[r * L::SLD + j] - m_new);
        sum += pj;
        Ps[r * L::PLD + j] = __float2bfloat16(pj);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) Os[r * L::OLD + d] *= alpha;
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O += P V
    for (int f = warp; f < (BQ / 16) * (D / 16); f += NW) {
      const int fr = f / (D / 16), fc = f % (D / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = Os + fr * 16 * L::OLD + fc * 16;
      wmma::load_matrix_sync(acc, optr, L::OLD, wmma::mem_row_major);
#pragma unroll
      for (int j0 = 0; j0 < BK; j0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + fr * 16 * L::PLD + j0, L::PLD);
        wmma::load_matrix_sync(fb, Vs + j0 * L::QLD + fc * 16, L::QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::OLD, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* ob = o + (size_t)bh * Sq * D;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    if (q0 + r < Sq) ob[(size_t)(q0 + r) * D + d] = __float2bfloat16(Os[r * L::OLD + d] / l_s[r]);
  }
  for (int r = tid; r < BQ; r += NT)
    if (q0 + r < Sq) lse[(size_t)bh * Sq + q0 + r] = m_s[r] + logf(l_s[r]);
}

// ---------------------------------------------------------------------------
// d = 128: register-resident variant (the FLUX blocks' 24 x 128 heads)
// ---------------------------------------------------------------------------
// Each warp owns 16 query rows. Q fragments, the score tile and the fp32
// output accumulator stay in registers, in the m16n8k16 mma.sync layouts: the
// score accumulator of two adjacent 8-key tiles is exactly the A operand of
// the P V product, so probabilities never touch shared memory. K and V tiles
// are staged row-major ([key][d]) by cp.async into two buffers, so the next
// tile loads while this one computes; ldmatrix reads K as the B operand of
// Q K^T and (transposed) V as the B operand of P V. Rows are padded by 16
// bytes so the 8 row addresses of an ldmatrix hit distinct banks. The softmax
// works in the log2 domain (scale folded with log2 e, exp2f).

template <int D>
struct MmaFlash {
  static constexpr int BQ = 128;       // 8 warps x 16 rows
  static constexpr int BK = 64;
  static constexpr int NW = 8;
  static constexpr int LD = D + 8;     // row stride (elements) of Q, K and V tiles
  static constexpr int TILE = BK * LD; // one K or V buffer
  static constexpr size_t bytes = ((size_t)BQ * LD + 4 * (size_t)TILE) * 2;
};

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int Sq, int Sk, float scale_log2) {
  using L = MmaFlash<D>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NW * 32, LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;          // [2][BK][LD]
  bf16* Vs = Ks + 2 * L::TILE;      // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  const int n_tiles = (Sk + BK - 1) / BK;

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < Sk;
      const size_t off = (size_t)(ok ? k0 + r : 0) * D + c;
      cp_async16(Ks + buf * L::TILE + r * LD + c, kb + off, ok ? 16 : 0);
      cp_async16(Vs + buf * L::TILE + r * LD + c, vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  load_kv(0, 0);
  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = zero_vec();
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();
  // Q as A fragments: matrices (rows 0-7 | 8-15) x (cols kc*16 | kc*16+8)
  uint32_t qf[D / 16][4];
  const int lrow = lane & 7, lsel = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(qf[kc], Qs + (warp * 16 + lrow + (lsel & 1) * 8) * LD + kc * 16 + (lsel >> 1) * 8);

  float oacc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

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

    // S = Q K^T: per 8-key tile, ldmatrix gives the B fragments of two
    // 16-wide d chunks (matrices: keys 0-7 at d, d+8, d+16, d+24)
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; kc += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (nt * 8 + lrow) * LD + kc * 16 + lsel * 8);
        mma_16816(s[nt], qf[kc], b[0], b[1]);
        mma_16816(s[nt], qf[kc + 1], b[2], b[3]);
      }
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + nt * 8 + t * 2 + e < Sk;
        s[nt][e] = valid ? s[nt][e] * scale_log2 : NEG_INF;
        s[nt][2 + e] = valid ? s[nt][2 + e] * scale_log2 : NEG_INF;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    // the four lanes of a quad hold one row's columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      oacc[nt][0] *= a0;
      oacc[nt][1] *= a0;
      oacc[nt][2] *= a1;
      oacc[nt][3] *= a1;
    }

    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p00 = exp2f(s[nt][0] - m0), p01 = exp2f(s[nt][1] - m0);
      const float p10 = exp2f(s[nt][2] - m1), p11 = exp2f(s[nt][3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(p00, p01);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(p10, p11);
    }

    // O += P V: transposed ldmatrix of (keys 0-7 | 8-15) x (d | d+8) gives
    // the B fragments of two 8-wide d tiles for one 16-key chunk
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + (kc * 16 + lrow + (lsel & 1) * 8) * LD + nt * 8 + (lsel >> 1) * 8);
        mma_16816(oacc[nt], pf[kc], b[0], b[1]);
        mma_16816(oacc[nt + 1], pf[kc], b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the load two tiles on
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  bf16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int d = nt * 8 + t * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * D + d) =
          pack_bf16x2(oacc[nt][0] * inv0, oacc[nt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * D + d) =
          pack_bf16x2(oacc[nt][2] * inv1, oacc[nt][3] * inv1);
  }
  constexpr float LN2 = 0.69314718055994531f;
  if (t == 0) {
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = (m0 + log2f(l0)) * LN2;
    if (row1 < Sq) lse[(size_t)bh * Sq + row1] = (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                     int Sq, int Sk, float scale, cudaStream_t stream) {
  using L = MmaFlash<D>;
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  constexpr float LOG2E = 1.4426950408889634f;
  dim3 grid((Sq + L::BQ - 1) / L::BQ, BH);
  kernel<<<grid, L::NW * 32, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Sk, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_smem(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                      int Sq, int Sk, float scale, cudaStream_t stream) {
  using L = SmemFlash<D>;
  auto kernel = flash_fwd_smem_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + L::BQ - 1) / L::BQ, BH);
  kernel<<<grid, L::NW * 32, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ragb_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int BH, int Sq, int Sk, int D, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 128:
      return launch_flash_mma<128>(q, k, v, o, lse, BH, Sq, Sk, scale, s);
    case 512:
      return launch_flash_smem<512>(q, k, v, o, lse, BH, Sq, Sk, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
