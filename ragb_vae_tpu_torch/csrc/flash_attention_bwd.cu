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
// owner and no float atomic is needed (the backward is bitwise reproducible);
// dQ and dK/dV are two kernels for that reason.
//
// Both kernels have K3's shape (csrc/flash_attention.cu): 384 threads, two
// consumer warpgroups that each own 64 rows of the block's output tile and one
// producer warp that feeds them by TMA (3-D tensor maps over (D, S, BH), boxes
// of {64 columns, 64 rows}, 128-byte swizzle, zero fill past the end of the
// head) through a ring of full and empty mbarriers; setmaxnreg hands the
// producer warpgroup's registers to the consumers. Every product is a wgmma
// with fp32 accumulators in registers; the softmax terms are formed on those
// registers and packed to bf16 as the register A operand of the next product,
// as K3 packs P.
// - flash_dq_kernel: one block per 128 query rows; Q and dO are loaded once,
//   lse and delta of the thread's two rows live in registers. K and V come
//   through a 4-stage ring in tiles of 64 keys. Per tile S = Q K^T and
//   dP = dO V^T (m64n64, both operands K-major in shared memory), then the
//   key-tail mask (a zero-filled K row gives S = 0, not P = 0) and dS, then
//   dQ += dS K (m64n128, K as the MN-major B operand: the transpose bit, LBO
//   the distance between its 64-column boxes).
// - flash_dkv_kernel: one block per 128 key rows; K and V are loaded once and
//   Q, dO tiles of 64 queries stream through a 4-stage ring, with the tile's
//   lse and delta written into the same stage by the producer warp (fp32 rows
//   of any length: no tensor map, bounds-checked loads; rows past Sq get
//   lse = +1e30, delta = 0, so P = 0 and nothing past Sq is inf or NaN). Each
//   warpgroup forms the TRANSPOSED scores S^T = K Q^T and dP^T = V dO^T
//   (m64n64, K-major), so P^T and dS^T come out of the accumulators already
//   laid out as the A operand of dV += P^T dO and dK += dS^T Q (m64n128, dO
//   and Q MN-major): no transpose through shared memory. lse and delta belong
//   to the columns here; each thread reads its accumulator columns' values
//   from the stage.
// Epilogues round once to bf16, stage the tile in the warpgroup's own rows of
// a buffer nobody reads any more (Q for dQ, K and V for dK and dV) and
// TMA-store it; the store writes no row past the end.

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LSE_PAD = 1e30f;   // lse of a query row past Sq: P = exp2(S - 1e30) = 0
constexpr float LOG2E = 1.4426950408889634f;
constexpr int D = 128;
constexpr int BOX_ROWS = 64;       // rows of every TMA box
constexpr int CONSUMERS = 256;     // two consumer warpgroups
constexpr int THREADS = 384;       // and one producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------
struct DqLayout {
  static constexpr int BQ = 128, BK = 64, STAGES = 4;
  static constexpr int QBOX = BQ * 128;          // one {64, BQ} column box of Q or dO
  static constexpr int KBOX = BK * 128;          // one {64, BK} column box of K or V
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or V tile
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + Q_BYTES;
  static constexpr int k_off = do_off + Q_BYTES;
  static constexpr int v_off = k_off + STAGES * KV_BYTES;
  static constexpr int bar_off = v_off + STAGES * KV_BYTES;
  static constexpr int bytes = bar_off + 256 + 1024;   // + alignment slack
  static_assert(bytes <= 232448, "shared memory");
};

__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
                    const float* __restrict__ delta, int Sq, int Sk, float scale) {
  using L = DqLayout;
  constexpr int BK = L::BK, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t qsm = base + L::q_off, dosm = base + L::do_off;
  const uint32_t ksm = base + L::k_off, vsm = base + L::v_off;
  const uint32_t bars = base + L::bar_off;
  // barriers: Q and dO, then per stage full K, full V, empty K, empty V
  const uint32_t qbar = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::BQ;
  const int n_tiles = (Sk + BK - 1) / BK;

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
      mbar_arrive_expect_tx(qbar, 2 * L::Q_BYTES);
      for (int b = 0; b < D / 64; ++b)
        for (int h = 0; h < L::BQ / BOX_ROWS; ++h) {
          const uint32_t off = b * L::QBOX + h * BOX_ROWS * 128;
          tma_load_3d(qsm + off, &qmap, 64 * b, q0 + BOX_ROWS * h, bh, qbar);
          tma_load_3d(dosm + off, &domap, 64 * b, q0 + BOX_ROWS * h, bh, qbar);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t free_parity = ((j / ST) & 1) ^ 1;
        mbar_wait(empty_k(s), free_parity);
        mbar_arrive_expect_tx(full_k(s), L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b)
          tma_load_3d(ksm + s * L::KV_BYTES + b * L::KBOX, &kmap, 64 * b, j * BK, bh, full_k(s));
        mbar_wait(empty_v(s), free_parity);
        mbar_arrive_expect_tx(full_v(s), L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b)
          tma_load_3d(vsm + s * L::KV_BYTES + b * L::KBOX, &vmap, 64 * b, j * BK, bh, full_v(s));
      }
    }
  } else {
    // ---------------- consumer warpgroups: warpgroup w owns query rows 64w..64w+63
    setmaxnreg_inc<CONSUMER_REGS>();
    const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = 64 * w + warp * 16 + g;   // the thread's accumulator rows: row0, row0 + 8
    const float scale_log2 = scale * LOG2E;
    const size_t rbase = (size_t)bh * Sq + q0;
    const bool in0 = q0 + row0 < Sq, in1 = q0 + row0 + 8 < Sq;
    const float lse0 = in0 ? lse[rbase + row0] * LOG2E : LSE_PAD;
    const float lse1 = in1 ? lse[rbase + row0 + 8] * LOG2E : LSE_PAD;
    const float dl0 = in0 ? delta[rbase + row0] : 0.0f;
    const float dl1 = in1 ? delta[rbase + row0 + 8] : 0.0f;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
    float sc[BK / 2], dp[BK / 2];
    uint32_t dsf[BK / 16][4];

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t parity = (j / ST) & 1;
      // S = Q K^T and dP = dO V^T over the warpgroup's 64 rows, one commit group
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.0f;
      mbar_wait(full_k(s), parity);
      mbar_wait(full_v(s), parity);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t a_off = (kc / 4) * L::QBOX + 64 * w * 128 + (kc % 4) * 32;
        const uint32_t b_off = s * L::KV_BYTES + (kc / 4) * L::KBOX + (kc % 4) * 32;
        wgmma_ss<BK>(sc, wgmma_desc(qsm + a_off, 16, 1024), wgmma_desc(ksm + b_off, 16, 1024), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t a_off = (kc / 4) * L::QBOX + 64 * w * 128 + (kc % 4) * 32;
        const uint32_t b_off = s * L::KV_BYTES + (kc / 4) * L::KBOX + (kc % 4) * 32;
        wgmma_ss<BK>(dp, wgmma_desc(dosm + a_off, 16, 1024), wgmma_desc(vsm + b_off, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(empty_v(s));
      // dS = P (dP - delta) scale with P = exp(S - lse), keys past Sk masked,
      // rounded to bf16 in the A-operand layout (two 8-key column tiles of
      // the accumulator are one 16-key fragment)
      const int k0 = j * BK;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        float d0[2], d1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = k0 + nt * 8 + t * 2 + e < Sk;
          const float s0 = valid ? sc[nt * 4 + e] * scale_log2 : NEG_INF;
          const float s1 = valid ? sc[nt * 4 + 2 + e] * scale_log2 : NEG_INF;
          d0[e] = exp2f(s0 - lse0) * (dp[nt * 4 + e] - dl0) * scale;
          d1[e] = exp2f(s1 - lse1) * (dp[nt * 4 + 2 + e] - dl1) * scale;
        }
        dsf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(d0[0], d0[1]);
        dsf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(d1[0], d1[1]);
      }
      // dQ += dS K: K as loaded (keys x d, d contiguous) is the MN-major B operand
      fence_regs(dq);
      fence_regs(dsf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_tb<D>(dq, dsf[kk], wgmma_desc(ksm + s * L::KV_BYTES + kk * 2048, L::KBOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsf);
      mbar_arrive(empty_k(s));
    }

    // epilogue: dQ in bf16 through the warpgroup's own rows of the Q tile
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + t * 2;
      const uint32_t box = L::q_off + (col / 64) * L::QBOX;
      *reinterpret_cast<uint32_t*>(sm + box + sw128_offset(row0, col % 64)) = pack_bf16x2(dq[4 * nt], dq[4 * nt + 1]);
      *reinterpret_cast<uint32_t*>(sm + box + sw128_offset(row0 + 8, col % 64)) =
          pack_bf16x2(dq[4 * nt + 2], dq[4 * nt + 3]);
    }
    fence_proxy_async();
    named_barrier_sync(2 + w, 128);
    if (tid == 0) {
      for (int b = 0; b < D / 64; ++b)
        tma_store_3d(&dqmap, qsm + b * L::QBOX + 64 * w * 128, 64 * b, q0 + 64 * w, bh);
      tma_store_commit_and_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------
struct DkvLayout {
  static constexpr int BKV = 128, BQ = 64, STAGES = 4;
  static constexpr int KBOX = BKV * 128;         // one {64, BKV} column box of K or V
  static constexpr int QBOX = BQ * 128;          // one {64, BQ} column box of a Q or dO tile
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;     // one Q or dO tile
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + KV_BYTES;
  static constexpr int q_off = v_off + KV_BYTES;
  static constexpr int do_off = q_off + STAGES * Q_BYTES;
  // [STAGES][2][BQ] fp32: per stage the tile's lse (times log2 e), then its delta
  static constexpr int rows_off = do_off + STAGES * Q_BYTES;
  static constexpr int bar_off = rows_off + STAGES * 2 * BQ * 4;
  static constexpr int bytes = bar_off + 256 + 1024;          // + alignment slack
  static_assert(bytes <= 232448, "shared memory");
};

__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap dkmap, const __grid_constant__ CUtensorMap dvmap,
                     const float* __restrict__ lse, const float* __restrict__ delta, int Sq, int Sk,
                     float scale) {
  using L = DkvLayout;
  constexpr int BQ = L::BQ, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ksm = base + L::k_off, vsm = base + L::v_off;
  const uint32_t qsm = base + L::q_off, dosm = base + L::do_off;
  float* rows = reinterpret_cast<float*>(sm + L::rows_off);
  const uint32_t bars = base + L::bar_off;
  // barriers: K and V, then per stage full (Q, dO, lse, delta) and empty
  const uint32_t kvbar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * L::BKV;
  const int n_tiles = (Sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);   // the producer warp's lanes, each after its lse and delta writes
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---------------- producer warpgroup: its first warp issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < CONSUMERS + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b)
          for (int h = 0; h < L::BKV / BOX_ROWS; ++h) {
            const uint32_t off = b * L::KBOX + h * BOX_ROWS * 128;
            tma_load_3d(ksm + off, &kmap, 64 * b, kv0 + BOX_ROWS * h, bh, kvbar);
            tma_load_3d(vsm + off, &vmap, 64 * b, kv0 + BOX_ROWS * h, bh, kvbar);
          }
      }
      const float* lse_bh = lse + (size_t)bh * Sq;
      const float* dl_bh = delta + (size_t)bh * Sq;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        // the tile's lse and delta, read before the wait so the load overlaps it
        float lv[BQ / 32], dlv[BQ / 32];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int r = j * BQ + 32 * i + lane;
          lv[i] = r < Sq ? lse_bh[r] * LOG2E : LSE_PAD;
          dlv[i] = r < Sq ? dl_bh[r] : 0.0f;
        }
        mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          rows[s * 2 * BQ + 32 * i + lane] = lv[i];
          rows[s * 2 * BQ + BQ + 32 * i + lane] = dlv[i];
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * L::Q_BYTES);
          for (int b = 0; b < D / 64; ++b) {
            tma_load_3d(qsm + s * L::Q_BYTES + b * L::QBOX, &qmap, 64 * b, j * BQ, bh, full(s));
            tma_load_3d(dosm + s * L::Q_BYTES + b * L::QBOX, &domap, 64 * b, j * BQ, bh, full(s));
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: warpgroup w owns key rows 64w..64w+63
    setmaxnreg_inc<CONSUMER_REGS>();
    const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = 64 * w + warp * 16 + g;   // the thread's accumulator rows (keys): row0, row0 + 8
    const float scale_log2 = scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
    float st[BQ / 2], dpt[BQ / 2];
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];

    mbar_wait(kvbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      // S^T = K Q^T and dP^T = V dO^T over the warpgroup's 64 keys and the
      // tile's 64 queries, one commit group
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
      mbar_wait(full(s), (j / ST) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t a_off = (kc / 4) * L::KBOX + 64 * w * 128 + (kc % 4) * 32;
        const uint32_t b_off = s * L::Q_BYTES + (kc / 4) * L::QBOX + (kc % 4) * 32;
        wgmma_ss<BQ>(st, wgmma_desc(ksm + a_off, 16, 1024), wgmma_desc(qsm + b_off, 16, 1024), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t a_off = (kc / 4) * L::KBOX + 64 * w * 128 + (kc % 4) * 32;
        const uint32_t b_off = s * L::Q_BYTES + (kc / 4) * L::QBOX + (kc % 4) * 32;
        wgmma_ss<BQ>(dpt, wgmma_desc(vsm + a_off, 16, 1024), wgmma_desc(dosm + b_off, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // P^T and dS^T (lse and delta per column, i.e. per query), rounded to
      // bf16 in the A-operand layout
      const float* terms = rows + s * 2 * BQ;   // this stage's lse, then its delta
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(terms + nt * 8 + t * 2);
        const float2 dl = *reinterpret_cast<const float2*>(terms + BQ + nt * 8 + t * 2);
        const float p0 = exp2f(st[nt * 4 + 0] * scale_log2 - l.x);
        const float p1 = exp2f(st[nt * 4 + 1] * scale_log2 - l.y);
        const float p2 = exp2f(st[nt * 4 + 2] * scale_log2 - l.x);
        const float p3 = exp2f(st[nt * 4 + 3] * scale_log2 - l.y);
        pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(p0, p1);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(p2, p3);
        dsf[nt / 2][(nt % 2) * 2 + 0] =
            pack_bf16x2(p0 * (dpt[nt * 4 + 0] - dl.x) * scale, p1 * (dpt[nt * 4 + 1] - dl.y) * scale);
        dsf[nt / 2][(nt % 2) * 2 + 1] =
            pack_bf16x2(p2 * (dpt[nt * 4 + 2] - dl.x) * scale, p3 * (dpt[nt * 4 + 3] - dl.y) * scale);
      }
      // dV += P^T dO and dK += dS^T Q: the dO and Q tiles as loaded (queries x
      // d, d contiguous) are the MN-major B operands
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_tb<D>(dv, pf[kk], wgmma_desc(dosm + s * L::Q_BYTES + kk * 2048, L::QBOX, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_tb<D>(dk, dsf[kk], wgmma_desc(qsm + s * L::Q_BYTES + kk * 2048, L::QBOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      mbar_arrive(empty(s));
    }

    // epilogue: dK and dV in bf16 through the warpgroup's own rows of the K
    // and V buffers
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + t * 2;
      const uint32_t kbox = L::k_off + (col / 64) * L::KBOX, vbox = L::v_off + (col / 64) * L::KBOX;
      const uint32_t o0 = sw128_offset(row0, col % 64), o1 = sw128_offset(row0 + 8, col % 64);
      *reinterpret_cast<uint32_t*>(sm + kbox + o0) = pack_bf16x2(dk[4 * nt], dk[4 * nt + 1]);
      *reinterpret_cast<uint32_t*>(sm + kbox + o1) = pack_bf16x2(dk[4 * nt + 2], dk[4 * nt + 3]);
      *reinterpret_cast<uint32_t*>(sm + vbox + o0) = pack_bf16x2(dv[4 * nt], dv[4 * nt + 1]);
      *reinterpret_cast<uint32_t*>(sm + vbox + o1) = pack_bf16x2(dv[4 * nt + 2], dv[4 * nt + 3]);
    }
    fence_proxy_async();
    named_barrier_sync(2 + w, 128);
    if (tid == 0) {
      for (int b = 0; b < D / 64; ++b) {
        tma_store_3d(&dkmap, ksm + b * L::KBOX + 64 * w * 128, 64 * b, kv0 + 64 * w, bh);
        tma_store_3d(&dvmap, vsm + b * L::KBOX + 64 * w * 128, 64 * b, kv0 + 64 * w, bh);
      }
      tma_store_commit_and_wait();
    }
  }
}

bool bad_shape(int BH, int Sq, int Sk, int d) {
  return BH <= 0 || Sq <= 0 || Sk <= 0 || BH > 65535 || d != D;
}

// Tensor maps over the operands and outputs; every box is {64, 64}.
struct BwdMaps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
};

int encode_maps(BwdMaps& m, const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                void* dv, int BH, int Sq, int Sk) {
  int e;
  if ((e = encode_tensor_map_3d(&m.q, q, D, Sq, BH, BOX_ROWS))) return e;
  if ((e = encode_tensor_map_3d(&m.k, k, D, Sk, BH, BOX_ROWS))) return e;
  if ((e = encode_tensor_map_3d(&m.v, v, D, Sk, BH, BOX_ROWS))) return e;
  if ((e = encode_tensor_map_3d(&m.dout, dout, D, Sq, BH, BOX_ROWS))) return e;
  if (dq != nullptr && (e = encode_tensor_map_3d(&m.dq, dq, D, Sq, BH, BOX_ROWS))) return e;
  if (dk != nullptr && (e = encode_tensor_map_3d(&m.dk, dk, D, Sk, BH, BOX_ROWS))) return e;
  if (dv != nullptr && (e = encode_tensor_map_3d(&m.dv, dv, D, Sk, BH, BOX_ROWS))) return e;
  return 0;
}

int launch_dq(const BwdMaps& m, const float* lse, const float* delta, int BH, int Sq, int Sk, float scale,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       DqLayout::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + DqLayout::BQ - 1) / DqLayout::BQ, BH);
  flash_dq_kernel<<<grid, THREADS, DqLayout::bytes, stream>>>(m.q, m.k, m.v, m.dout, m.dq, lse, delta, Sq, Sk,
                                                              scale);
  return (int)cudaGetLastError();
}

int launch_dkv(const BwdMaps& m, const float* lse, const float* delta, int BH, int Sq, int Sk, float scale,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       DkvLayout::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + DkvLayout::BKV - 1) / DkvLayout::BKV, BH);
  flash_dkv_kernel<<<grid, THREADS, DkvLayout::bytes, stream>>>(m.q, m.k, m.v, m.dout, m.dk, m.dv, lse, delta,
                                                                Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ragb_flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dq, int BH, int Sq, int Sk,
                                       int d, float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  BwdMaps m;
  int e = encode_maps(m, q, k, v, dout, dq, nullptr, nullptr, BH, Sq, Sk);
  return e ? e : launch_dq(m, lse, delta, BH, Sq, Sk, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int ragb_flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                        const float* lse, const float* delta, void* dk, void* dv, int BH, int Sq,
                                        int Sk, int d, float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  BwdMaps m;
  int e = encode_maps(m, q, k, v, dout, nullptr, dk, dv, BH, Sq, Sk);
  return e ? e : launch_dkv(m, lse, delta, BH, Sq, Sk, scale, static_cast<cudaStream_t>(stream));
}

// Both kernels on one set of tensor maps: K4 (dQ), then K5 (dK, dV), on `stream`.
extern "C" int ragb_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                        const float* lse, const float* delta, void* dq, void* dk, void* dv, int BH,
                                        int Sq, int Sk, int d, float scale, void* stream) {
  if (bad_shape(BH, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdMaps m;
  int e = encode_maps(m, q, k, v, dout, dq, dk, dv, BH, Sq, Sk);
  if (e) return e;
  e = launch_dq(m, lse, delta, BH, Sq, Sk, scale, s);
  return e ? e : launch_dkv(m, lse, delta, BH, Sq, Sk, scale, s);
}
