// Flash-attention forward for Hopper (sm_90a): (BH, S, D) bf16 in and out.
//
// Replaces the TPU kernel `_flash_kernel` of
// ragb_vae_tpu/ops/pallas/flash_attention.py (driven by `_flash_fwd_impl`,
// entry `attention`): online-softmax attention with fp32 logits, running
// (max, sum) and output accumulator, keys past the sequence end masked with
// -1e30, P rounded to bf16 once before P V, the output rounded once, and the
// per-row natural-log log-sum-exp written beside the output.
//
// What bounds it on the H100: for one (Q tile, K/V tile) pair the block does
// 4*BQ*BK*D FLOPs against (BQ + 2*BK)*D*2 bytes, far above the bf16 ridge at
// the sequence lengths of this system (FLUX: S = 2.5k..8.7k, d = 128; VAE
// mid-block: S = 4k..16k, d = 512), so tensor-core FLOPs bound it and the
// S x S logits never reach device memory.
//
// Design (one kernel template, two tilings; 384 threads = two consumer
// warpgroups and one producer warpgroup):
// - The producer's one thread loads the block's Q tile once and then the K
//   and V tiles of its key range into a two-stage ring by TMA (3-D tensor
//   maps over (D, S, BH), so a ragged tile reads zeros from past the end of
//   its own head, never the next head's rows; 128-byte swizzle), each K and
//   each V buffer guarded by a full and an empty mbarrier, so a K buffer is
//   refilled as soon as its Q K^T is done. setmaxnreg gives the producer's
//   registers to the consumers; the key loop has no __syncthreads.
// - Consumers run S = Q K^T as wgmma with both operands in shared memory
//   (K-major), the online softmax on the accumulator registers in the log2
//   domain, convert P to bf16 in registers and feed it as the register A
//   operand of O += P V, whose B operand is the V tile as loaded (MN-major,
//   the transpose bit set).
// - d = 128 (the FLUX blocks): BQ = 128, BK = 128; warpgroup w owns query
//   rows 64w..64w+63 and all 128 output columns (m64n128 products). Each
//   warpgroup runs S, softmax, P V in turn; the other one's products fill
//   the tensor cores meanwhile. (Overlapping the softmax with the products
//   on purpose, within a warpgroup or by turns between the two, measured
//   slower at this tile on the H100: PERF.md.)
// - d = 512 (the VAE mid-block): a 64 x 512 fp32 accumulator would take 256
//   registers a thread, so the two warpgroups share 64 query rows and split
//   the output columns (m64n256 each). Both need the whole P: each computes S
//   over its half of D (its own Q and K columns) and the two partial S tiles
//   are summed through shared memory (a + b is b + a in fp32, so both hold
//   the same S, P, max and sum). Publishing P from one warpgroup would
//   leave the other idle through Q K^T, half of all FLOPs. BK = 32: Q
//   (64 KB) plus two stages of K and V (128 KB) and the exchange (32 KB).
//   One head at S = 4096 gives only 64 query tiles for 132 SMs, so the keys
//   may be split (flash-decoding): each block of a split writes its
//   unnormalised fp32 O, max and sum, and `flash_merge_kernel` combines
//   them into `out` and the exact log-sum-exp. The wrapper picks the count.
// - Epilogue: O / l rounded to bf16, staged in the warpgroup's own part of
//   the Q tile in the swizzled layout, TMA-stored (rows past Sq are clipped).

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.69314718055994531f;
constexpr int CONSUMERS = 256;   // two consumer warpgroups
constexpr int THREADS = 384;     // and one producer warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int D>
struct Fwd;

template <>
struct Fwd<128> {
  static constexpr int BQ = 128, BK = 128, STAGES = 2;
  static constexpr bool COL_SPLIT = false;   // warpgroups split the rows
};

template <>
struct Fwd<512> {
  static constexpr int BQ = 64, BK = 32, STAGES = 2;
  static constexpr bool COL_SPLIT = true;    // warpgroups split the columns
};

template <int D>
struct Layout {
  using C = Fwd<D>;
  static constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
  static constexpr bool COL_SPLIT = C::COL_SPLIT;
  static constexpr int DW = COL_SPLIT ? D / 2 : D;   // output columns of a warpgroup
  static constexpr int QBOX = BQ * 128;              // bytes of one {64, BQ} box
  static constexpr int KBOX = BK * 128;              // bytes of one {64, BK} box
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  static constexpr int NS = BK / 2;                  // S accumulator registers
  static constexpr int NO = DW / 2;                  // O accumulator registers
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + Q_BYTES;
  static constexpr int v_off = k_off + STAGES * KV_BYTES;
  static constexpr int x_off = v_off + STAGES * KV_BYTES;   // S exchange (COL_SPLIT)
  static constexpr int x_bytes = COL_SPLIT ? 2 * 2 * NS * 128 * 4 : 0;
  static constexpr int bar_off = x_off + x_bytes;
  static constexpr int bytes = bar_off + 128 + 1024;        // + alignment slack
  static_assert(bytes <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                           float* __restrict__ lse, float* __restrict__ part_o, float* __restrict__ part_m,
                           float* __restrict__ part_l, int Sq, int Sk, float scale_log2, int splits) {
  using L = Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t qsm = base + L::q_off, ksm = base + L::k_off, vsm = base + L::v_off;
  const uint32_t bars = base + L::bar_off;
  // barriers: Q, then per stage full K, full V, empty K, empty V
  const uint32_t qbar = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };

  const int bh = blockIdx.y, split = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int n_all = (Sk + BK - 1) / BK;
  const int t_begin = (int)((long long)split * n_all / splits);
  const int n_tiles = (int)((long long)(split + 1) * n_all / splits) - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), CONSUMERS);
      mbar_init(empty_v(s), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(qbar, L::Q_BYTES);
      for (int b = 0; b < D / 64; ++b) tma_load_3d(qsm + b * L::QBOX, &qmap, 64 * b, q0, bh, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t free_parity = ((j / ST) & 1) ^ 1;
        const int k0 = (t_begin + j) * BK;
        mbar_wait(empty_k(s), free_parity);
        mbar_arrive_expect_tx(full_k(s), L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b)
          tma_load_3d(ksm + s * L::KV_BYTES + b * L::KBOX, &kmap, 64 * b, k0, bh, full_k(s));
        mbar_wait(empty_v(s), free_parity);
        mbar_arrive_expect_tx(full_v(s), L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b)
          tma_load_3d(vsm + s * L::KV_BYTES + b * L::KBOX, &vmap, 64 * b, k0, bh, full_v(s));
      }
    }
  } else {
    // ---------------- consumer warpgroups
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = L::NS, NO = L::NO;
    constexpr int KS = (L::COL_SPLIT ? D / 2 : D) / 16;   // k-steps of this warpgroup's Q K^T
    constexpr int KP = BK / 16;                           // k-steps of P V
    const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row_base = L::COL_SPLIT ? 0 : 64 * w;        // first query row of the warpgroup
    const int box0 = L::COL_SPLIT ? (D / 128) * w : 0;    // first 64-column box it reads in Q K^T and writes
    float* xbuf = reinterpret_cast<float*>(sm + L::x_off);

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

    // S_j = Q K_j^T over this warpgroup's depth, issued and committed
    auto issue_s = [&](float(&sc)[NS], int j) {
      const int s = j % ST;
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
      mbar_wait(full_k(s), (j / ST) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        const int box = box0 + kc / 4;
        const uint64_t da = wgmma_desc(qsm + box * L::QBOX + row_base * 128 + (kc % 4) * 32, 16, 1024);
        const uint64_t db = wgmma_desc(ksm + s * L::KV_BYTES + box * L::KBOX + (kc % 4) * 32, 16, 1024);
        wgmma_ss<BK>(sc, da, db, kc > 0);
      }
      wgmma_commit();
    };
    // O += P_j V_j, P from registers, V as loaded (keys x d, d contiguous),
    // issued and committed
    auto issue_pv = [&](uint32_t(&pf)[KP][4], int j) {
      const int s = j % ST;
      mbar_wait(full_v(s), (j / ST) & 1);
      fence_regs(o);
      fence_regs(pf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const uint64_t db = wgmma_desc(vsm + s * L::KV_BYTES + box0 * L::KBOX + kk * 2048, L::KBOX, 1024);
        wgmma_rs_tb<L::DW>(o, pf[kk], db, 1);
      }
      wgmma_commit();
    };
    // online softmax of S_j (rows g and g + 8 of the warp's 16): leaves
    // exp2(S - m) in sc, updates m and l, returns the old rows' rescale
    auto softmax = [&](float(&sc)[NS], int j, float& a0, float& a1) {
      if constexpr (L::COL_SPLIT) {
        // add the other warpgroup's half of the depth; the buffer alternates
        // by tile, and one barrier per tile keeps a write behind the
        // partner's read of two tiles back
        float* xb = xbuf + (j & 1) * (2 * NS * 128);
#pragma unroll
        for (int i = 0; i < NS; ++i) xb[(w * NS + i) * 128 + tid] = sc[i];
        named_barrier_sync(1, CONSUMERS);
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] += xb[((1 - w) * NS + i) * 128 + tid];
      }
      const int k0 = (t_begin + j) * BK;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = k0 + nt * 8 + t * 2 + e < Sk;
          sc[nt * 4 + e] = valid ? sc[nt * 4 + e] * scale_log2 : NEG_INF;
          sc[nt * 4 + 2 + e] = valid ? sc[nt * 4 + 2 + e] * scale_log2 : NEG_INF;
          mx0 = fmaxf(mx0, sc[nt * 4 + e]);
          mx1 = fmaxf(mx1, sc[nt * 4 + 2 + e]);
        }
      }
      // the four lanes of a quad hold one row's columns
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = exp2f(m0 - mn0);
      a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt * 4 + e] = exp2f(sc[nt * 4 + e] - m0);
          sc[nt * 4 + 2 + e] = exp2f(sc[nt * 4 + 2 + e] - m1);
          sum0 += sc[nt * 4 + e];
          sum1 += sc[nt * 4 + 2 + e];
        }
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
    };
    // P rounded to bf16 once, in the A-operand layout: the accumulator of
    // two adjacent 8-key column tiles is one 16-key A fragment
    auto to_bf16 = [&](const float(&sc)[NS], uint32_t(&pf)[KP][4]) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(sc[nt * 4 + 0], sc[nt * 4 + 1]);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(sc[nt * 4 + 2], sc[nt * 4 + 3]);
      }
    };

    mbar_wait(qbar, 0);
    float sc[NS];
    uint32_t pf[KP][4];
    float a0, a1;
    for (int j = 0; j < n_tiles; ++j) {
      issue_s(sc, j);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k(j % ST));
      softmax(sc, j, a0, a1);
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        o[4 * i + 0] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
      to_bf16(sc, pf);
      issue_pv(pf, j);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      mbar_arrive(empty_v(j % ST));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = row_base + warp * 16 + g, r1 = r0 + 8;   // rows within the block's tile
    const int bh_count = gridDim.y;
    const bool writes_rows = t == 0 && (!L::COL_SPLIT || w == 0);
    if (splits == 1) {
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      // the warpgroup's own part of the Q tile (rows for d = 128, column
      // boxes for d = 512) is read by no one else any more
#pragma unroll
      for (int nt = 0; nt < NO / 4; ++nt) {
        const int col = nt * 8 + t * 2;
        const uint32_t box = qsm + (box0 + col / 64) * L::QBOX - base;
        *reinterpret_cast<uint32_t*>(sm + box + sw128_offset(r0, col % 64)) =
            pack_bf16x2(o[4 * nt + 0] * inv0, o[4 * nt + 1] * inv0);
        *reinterpret_cast<uint32_t*>(sm + box + sw128_offset(r1, col % 64)) =
            pack_bf16x2(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
      }
      fence_proxy_async();
      named_barrier_sync(2 + w, 128);
      if (tid == 0) {
        for (int b = 0; b < L::DW / 64; ++b)
          tma_store_3d(&omap, qsm + (box0 + b) * L::QBOX + row_base * 128, 64 * (box0 + b), q0 + row_base, bh);
        tma_store_commit_and_wait();
      }
      if (writes_rows) {
        if (q0 + r0 < Sq) lse[(size_t)bh * Sq + q0 + r0] = (m0 + log2f(l0)) * LN2;
        if (q0 + r1 < Sq) lse[(size_t)bh * Sq + q0 + r1] = (m1 + log2f(l1)) * LN2;
      }
    } else {
      // this key range's unnormalised O, max (natural-log units) and sum
      const size_t rows0 = ((size_t)split * bh_count + bh) * Sq + q0;
#pragma unroll
      for (int nt = 0; nt < NO / 4; ++nt) {
        const int col = box0 * 64 + nt * 8 + t * 2;
        if (q0 + r0 < Sq)
          *reinterpret_cast<float2*>(part_o + (rows0 + r0) * D + col) = make_float2(o[4 * nt], o[4 * nt + 1]);
        if (q0 + r1 < Sq)
          *reinterpret_cast<float2*>(part_o + (rows0 + r1) * D + col) = make_float2(o[4 * nt + 2], o[4 * nt + 3]);
      }
      if (writes_rows) {
        if (q0 + r0 < Sq) {
          part_m[rows0 + r0] = m0 * LN2;
          part_l[rows0 + r0] = l0;
        }
        if (q0 + r1 < Sq) {
          part_m[rows0 + r1] = m1 * LN2;
          part_l[rows0 + r1] = l1;
        }
      }
    }
  }
}

// Combines the key splits: one warp per (head, query) row.
// out = sum_s w_s O_s / sum_s w_s l_s, lse = M + log(sum_s w_s l_s) with
// w_s = exp(m_s - M), M = max_s m_s.
template <int D>
__global__ void __launch_bounds__(256)
    flash_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_m,
                       const float* __restrict__ part_l, bf16* __restrict__ o, float* __restrict__ lse, int rows,
                       int splits) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[(size_t)s * rows + row]);
  float sum = 0.0f;
  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = (size_t)s * rows + row;
    const float wgt = expf(part_m[r] - mx);
    sum += wgt * part_l[r];
    const float* src = part_o + r * D;
#pragma unroll
    for (int c = 0; c < D / 128; ++c) {
      const float4 val = *reinterpret_cast<const float4*>(src + c * 128 + lane * 4);
      acc[4 * c + 0] += wgt * val.x;
      acc[4 * c + 1] += wgt * val.y;
      acc[4 * c + 2] += wgt * val.z;
      acc[4 * c + 3] += wgt * val.w;
    }
  }
  const float inv = 1.0f / sum;
#pragma unroll
  for (int c = 0; c < D / 128; ++c) {
    uint2 packed;
    packed.x = pack_bf16x2(acc[4 * c + 0] * inv, acc[4 * c + 1] * inv);
    packed.y = pack_bf16x2(acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
    *reinterpret_cast<uint2*>(o + (size_t)row * D + c * 128 + lane * 4) = packed;
  }
  if (lane == 0) lse[row] = mx + logf(sum);
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, float* lse, float* part_o, float* part_m,
                 float* part_l, int BH, int Sq, int Sk, int splits, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  const int n_all = (Sk + L::BK - 1) / L::BK;
  if (splits < 1 || splits > n_all || splits > 65535) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_o == nullptr || part_m == nullptr || part_l == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  int e;
  if ((e = encode_tensor_map_3d(&qm, q, D, Sq, BH, L::BQ))) return e;
  if ((e = encode_tensor_map_3d(&km, k, D, Sk, BH, L::BK))) return e;
  if ((e = encode_tensor_map_3d(&vm, v, D, Sk, BH, L::BK))) return e;
  if ((e = encode_tensor_map_3d(&om, o, D, Sq, BH, 64))) return e;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((Sq + L::BQ - 1) / L::BQ, BH, splits);
  kernel<<<grid, THREADS, L::bytes, stream>>>(qm, km, vm, om, lse, part_o, part_m, part_l, Sq, Sk, scale * LOG2E,
                                              splits);
  ce = cudaGetLastError();
  if (ce != cudaSuccess || splits == 1) return (int)ce;
  const int rows = BH * Sq;
  flash_merge_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(part_o, part_m, part_l, static_cast<bf16*>(o), lse,
                                                           rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// splits > 1 (d = 512 in practice) needs fp32 workspaces part_o (splits, BH,
// Sq, D), part_m and part_l (splits, BH, Sq); otherwise they may be null.
extern "C" int ragb_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                        float* part_o, float* part_m, float* part_l, int BH, int Sq, int Sk, int D,
                                        int splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 128:
      return launch_flash<128>(q, k, v, o, lse, part_o, part_m, part_l, BH, Sq, Sk, splits, scale, s);
    case 512:
      return launch_flash<512>(q, k, v, o, lse, part_o, part_m, part_l, BH, Sq, Sk, splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
