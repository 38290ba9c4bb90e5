// K1's function by Winograd F(2x2, 3x3), for Hopper (sm_90a), NHWC bf16 in and
// out:
//   y = conv3x3(act(x*a + b)) + bias [+ skip | + skip @ ws + wsb]
// and the per-channel (sum, sum of squares) of the ROUNDED y.
//
// Replaces the TPU kernel `_wino_kernel` of
// ragb_vae_tpu/ops/pallas/resnet_block.py:383 (driven by `_wino_fwd_impl`
// at :678, entry `gn_silu_conv3x3_stats(algo="winograd")`). Its backward is
// K1's (K6 in resnet_block_bwd.cu): the primal function is the same.
//
// The arithmetic is the TPU kernel's. Per 2x2 output tile and input channel,
// the 4x4 patch d of the activation (rounded to bf16, zero outside the
// image) goes through the input transform B^T d B in fp32, COLUMNS FIRST,
// and is rounded to bf16: V[mu][nu]. The output ROW transform A^T is folded
// into the contraction, as `_wino_weights` folds it: for each column
// variant nu, two products of depth 3C,
//   Z[0][nu] = V[0] U[0] + V[1] U[1] + V[2] U[2]
//   Z[1][nu] = V[1] U[1] - V[2] U[2] - V[3] U[3]      (each [.][nu])
// over U = G w G^T (folded in fp32 from the bf16 weights, rounded to bf16
// once by the wrapper), accumulated in fp32; then the column transform
// y[p][q] = (Z0 + Z1 + Z2, Z1 - Z2 - Z3)[q] in fp32, bias, the skip, and one
// rounding of y.
//
// What bounds it on the H100: the folded products do 2*6*C operations per
// output element (6/9 of a direct conv's): (2,128,128,512)->512 does 103
// GFLOP against 38 MB, above the bf16 ridge, 0.104 ms at 989 TFLOP/s. The
// transform adds fp32 work on the CUDA cores and ~100 KB of shared-memory
// traffic a step that a direct conv does not have, beside the m64n64
// products' own ~100 KB: the two slow each other, and with a fixed ~13 us a
// block they, not the tensor cores, set its pace (0.47 ms back to back at
// that shape, H100 SXM, scripts/k8_variants.py; U's 1 GB of L2 reads there
// are not the limit).
//
// The design:
// - The activation is a pass of its own (`wino_act_kernel`): xa =
//   bf16(act(x*a + b)), K1's activation arithmetic, once per element. The
//   TPU kernel activates its slab in VMEM; done in the conv kernel it would
//   run once per 64 output channels (8 times at N = 512), and it measured
//   as much time as the transform (0.21 ms of 0.65 at (2,128,128,512)->512,
//   H100 SXM, scripts/k8_variants.py); the pass reads x and writes xa once.
//   TMA's zero fill of xa outside the image is the SAME padding of the
//   activated value.
// - A block owns 64 Winograd tiles (4 rows x 16 columns: 8 x 32 output
//   pixels, one m64) and 64 output channels. Two consumer warpgroups, one
//   per output row p, each hold Z[p][0..3], four m64n64 fp32 accumulators
//   (128 registers a thread); all four Z[p][nu] of a tile sit at the same
//   fragment positions, so the column transform runs in registers.
// - The contraction walks 64-channel chunks and, inside a chunk, the column
//   variants nu (nu-major): a step (chunk, nu) needs V[0..3][nu] (four 8 KB
//   planes, 64 tiles x 128 bytes, the K-major A operand in 128-byte swizzle)
//   and U[0..3][nu] (four {64 N, 64 C} boxes by TMA from U as (16, C, N), the
//   MN-major B operand). Warpgroup p issues twelve m64n64k16 wgmma a step;
//   the signs of -U2 and -U3 are wgmma's imm-scale-b = -1, so U's 16 tiles
//   are stored once, unsigned.
// - One producer thread issues every TMA load: the halo'd slab of xa a chunk
//   ({64 C, 34, 10} from (c0, w0 - 1, h0 - 1), negative coordinates
//   included) one chunk ahead into a ring of two, and the U boxes of each
//   step into a ring of two.
// - The transform: each consumer thread, after issuing a step's products,
//   transforms one pair of vertically neighbouring tiles (they share two of
//   their six slab rows) in one 16-byte chunk of channels for the next step
//   into a V ring of two, while the tensor cores run: 256 equal tasks a
//   step, so V is transformed once per (tile, chunk, nu) for 64 output
//   channels. One named barrier of the 256 consumer threads a step hands
//   the V ring over.
// - K1's 1x1 projection is a K loop after the main one into the same
//   accumulators: per 64 skip channels and output column q, the skip's
//   pixels (2 ty + p, 2 tx + q) of the 64 tiles as one TMA box read at
//   traversal strides {1, 2, 2} per warpgroup, and ws's {64 N, 64 Cs} box.
//   q = 0 adds to Z[p][0], which only y[p][0] reads; q = 1 subtracts from
//   Z[p][3] (imm-scale-b = -1), which y[p][1] reads with a minus sign.
// - The epilogue forms y from the accumulators, adds bias (+ wsb) and the
//   identity skip (a TMA box into the slab ring, loaded as the last chunk
//   starts), rounds once, stages y in the drained V ring and stores it by
//   TMA, a row a box; the statistics of the rounded y inside the image take
//   the conv engine's fixed shuffle tree and warp order into one (B, T, 2, N)
//   partial row a block, which `stats_reduce_kernel` sums in a fixed order:
//   no float atomics, bit-for-bit reproducible.
// Every mbarrier wait traps after 2^22 polls, so a barrier that can never
// complete fails the launch instead of hanging the card.
// H and W must be even (a Winograd tile never straddles the image edge); C,
// N and Cs multiples of 8 (16-byte global strides for TMA). Ragged edges are
// zero-filled by TMA on the way in and clipped by it on the way out.

#include "conv_sm90.cuh"

namespace {

struct Wino {
  static constexpr int TTH = 4, TTW = 16;              // Winograd tiles of a block: one m64
  static constexpr int TH = 2 * TTH, TW = 2 * TTW;     // its output pixels: 8 x 32
  static constexpr int BN = 64;                        // output channels of a block
  static constexpr int BK = 64;                        // input channels of a chunk: one 128-byte row
  static constexpr int SH = TH + 2, SW = TW + 2;       // the halo'd slab: 10 x 34 pixels
  static constexpr int SLAB_BYTES = SH * SW * 128;
  static constexpr int SLAB_STAGE = (SLAB_BYTES + 1023) / 1024 * 1024;
  static constexpr int PLANE = 64 * 128;               // a V plane (64 tiles) or a U box {64 N, 64 C}
  static constexpr int STAGE = 4 * PLANE;              // V[0..3][nu], or U[0..3][nu]
  static constexpr int ROW_BOX = TW * 128;             // a {64 N, 32} box of y: one output row of the tile
  static constexpr int slab_off = 0;
  static constexpr int v_off = slab_off + 2 * SLAB_STAGE;
  static constexpr int u_off = v_off + 2 * STAGE;
  static constexpr int red_off = u_off + 2 * STAGE;    // [2][8 warps][BN] fp32 statistics
  static constexpr int bar_off = red_off + 2 * 8 * BN * 4;
  static constexpr int BARS = 9;                       // 4 kinds x 2 stages, the skip tile's
  static constexpr int bytes = bar_off + BARS * 8 + 1024;   // + alignment slack
  static constexpr int CONSUMERS = 256, THREADS = 384;
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
  static_assert(bytes <= 232448, "shared memory");
  static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * 168, "register pool");
  static_assert(CONSUMERS == 2 * TTW * 8, "a consumer thread transforms one tile pair's 16-byte chunk a step");
  static_assert(3 * PLANE <= STAGE, "a projection step: two skip boxes and ws's box in a U stage");
  static_assert(TH * ROW_BOX <= SLAB_STAGE && TH * ROW_BOX <= 2 * STAGE, "the skip and y tiles fit their rings");
};

// xa = bf16(act(x*a + b)) over x (B, H, W, C) bf16, a, b (B, C) fp32, eight
// channels a thread and step: K1's activation (act_pair), once per element.
__global__ void __launch_bounds__(256) wino_act_kernel(const uint4* __restrict__ x, const float* __restrict__ a,
                                                      const float* __restrict__ b, uint4* __restrict__ xa,
                                                      size_t vecs, int C, size_t image_vecs, int silu) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < vecs; i += (size_t)gridDim.x * blockDim.x) {
    const size_t off = (i / image_vecs) * C + (i * 8) % C;   // sample and channel of the vector's coefficients
    const float4 a0 = *reinterpret_cast<const float4*>(a + off), a1 = *reinterpret_cast<const float4*>(a + off + 4);
    const float4 e0 = *reinterpret_cast<const float4*>(b + off), e1 = *reinterpret_cast<const float4*>(b + off + 4);
    const uint4 v = x[i];
    uint4 out;
    out.x = act_pair(v.x, a0.x, a0.y, e0.x, e0.y, silu);
    out.y = act_pair(v.y, a0.z, a0.w, e0.z, e0.w, silu);
    out.z = act_pair(v.z, a1.x, a1.y, e1.x, e1.y, silu);
    out.w = act_pair(v.w, a1.z, a1.w, e1.z, e1.w, silu);
    xa[i] = out;
  }
}

// V[0..3][nu] of the Winograd tiles (ty, tx) and (ty + 1, tx), ty even, in
// logical 16-byte chunk lc (8 channels), from the slab into the V stage: the
// column transform of slab rows 2 ty .. 2 ty + 5 (cv[r] = d[r][ca] +-
// d[r][cb], the TPU kernel's operand order; the two tiles share rows 2, 3),
// then each tile's row transform (cv0 - cv2, cv1 + cv2, cv2 - cv1, cv1 - cv3)
// over its four rows, all in fp32, each V rounded to bf16 once and stored at
// row t of plane mu, physical chunk lc ^ (t % 8) (128-byte swizzle). Four
// channels at a time, the rows streamed (rows 4, 5 take the places of rows
// 0, 1), so that it runs beside the four accumulators without spilling; the
// tile pairs of odd tx take the chunk's halves in the other order, so that a
// warp's 8-byte accesses spread over all 32 banks.
__device__ __forceinline__ void wino_transform(const unsigned char* slab, unsigned char* vst, int ty, int tx,
                                               int lc, int nu) {
  const int ca = nu == 0 ? 0 : nu == 2 ? 2 : 1;        // d0 - d2, d1 + d2, d2 - d1, d1 - d3
  const int cb = nu == 0 ? 2 : nu == 2 ? 1 : nu == 1 ? 2 : 3;
  const float sg = nu == 1 ? 1.0f : -1.0f;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int half = pass ^ (tx & 1);
    float cv[4][4];                                    // [row % 4][channel]
    auto column = [&](int r) {                         // slab row 2 ty + r into cv[r % 4]
      const int ra = (2 * ty + r) * Wino::SW + 2 * tx + ca, rb = ra + cb - ca;
      const uint2 va = *reinterpret_cast<const uint2*>(slab + ra * 128 + ((lc ^ (ra & 7)) << 4) + 8 * half);
      const uint2 vb = *reinterpret_cast<const uint2*>(slab + rb * 128 + ((lc ^ (rb & 7)) << 4) + 8 * half);
      const uint32_t wa[2] = {va.x, va.y}, wb[2] = {vb.x, vb.y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[j]));
        const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[j]));
        cv[r % 4][2 * j] = fa.x + sg * fb.x;
        cv[r % 4][2 * j + 1] = fa.y + sg * fb.y;
      }
    };
    auto rows = [&](int k) {                           // tile ty + k from slab rows 2 k .. 2 k + 3
      const float(&c0)[4] = cv[(2 * k) % 4], (&c1)[4] = cv[(2 * k + 1) % 4], (&c2)[4] = cv[(2 * k + 2) % 4],
                  (&c3)[4] = cv[(2 * k + 3) % 4];
      uint32_t out[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        out[0][j] = pack_bf16x2(c0[2 * j] - c2[2 * j], c0[2 * j + 1] - c2[2 * j + 1]);
        out[1][j] = pack_bf16x2(c1[2 * j] + c2[2 * j], c1[2 * j + 1] + c2[2 * j + 1]);
        out[2][j] = pack_bf16x2(c2[2 * j] - c1[2 * j], c2[2 * j + 1] - c1[2 * j + 1]);
        out[3][j] = pack_bf16x2(c1[2 * j] - c3[2 * j], c1[2 * j + 1] - c3[2 * j + 1]);
      }
      const int t = (ty + k) * Wino::TTW + tx;
      const uint32_t off = t * 128 + ((lc ^ (t & 7)) << 4) + 8 * half;
#pragma unroll
      for (int mu = 0; mu < 4; ++mu)
        *reinterpret_cast<uint2*>(vst + mu * Wino::PLANE + off) = make_uint2(out[mu][0], out[mu][1]);
    };
#pragma unroll
    for (int r = 0; r < 4; ++r) column(r);
    rows(0);
    column(4);
    column(5);
    rows(1);
  }
}

// Warpgroup P's products of one step into z = Z[P][nu]: V[P + i][nu] U[P + i][nu]
// over i = 0, 1, 2, signed (+, +, +) for P = 0 and (+, -, -) for P = 1.
template <int P>
__device__ __forceinline__ void wino_products(float (&z)[32], uint32_t vst, uint32_t ust) {
  constexpr int S = P == 0 ? 1 : -1;
#pragma unroll
  for (int kk = 0; kk < Wino::BK / 16; ++kk) {
    wgmma_ss_tb64<1>(z, wgmma_desc(vst + P * Wino::PLANE + kk * 32, 16, 1024),
                     wgmma_desc(ust + P * Wino::PLANE + kk * 2048, Wino::PLANE, 1024), 1);
    wgmma_ss_tb64<S>(z, wgmma_desc(vst + (P + 1) * Wino::PLANE + kk * 32, 16, 1024),
                     wgmma_desc(ust + (P + 1) * Wino::PLANE + kk * 2048, Wino::PLANE, 1024), 1);
    wgmma_ss_tb64<S>(z, wgmma_desc(vst + (P + 2) * Wino::PLANE + kk * 32, 16, 1024),
                     wgmma_desc(ust + (P + 2) * Wino::PLANE + kk * 2048, Wino::PLANE, 1024), 1);
  }
}

template <int V>
struct IntC {
  static constexpr int value = V;
};

// Grid (N tiles of 64, pixel tiles of one image, batch). xmap xa (C, W, H, B)
// in boxes {64, 34, 10}; umap U (16, C, N) in boxes {64 N, 64 C}; smap the
// projection's skip (Cs, W, H, B) in boxes {64, 32, 8} at traversal strides
// {1, 2, 2}, or the identity skip (N, W, H, B) in boxes {64, 32, 8}; wsmap ws
// (Cs, N) in boxes {64 N, 64 Cs}; ymap y (N, W, H, B) in boxes {64, 32, 1};
// partial (B, T, 2, N).
__global__ void __launch_bounds__(Wino::THREADS, 1)
    wino_conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap umap,
                     const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap wsmap,
                     const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
                     const float* __restrict__ wsb, float* __restrict__ partial, int H, int W, int C, int N, int Cs,
                     int skip_mode, int tiles_w) {
  using L = Wino;
  extern __shared__ __align__(1024) unsigned char wino_smem[];
  const uint32_t raw = smem_addr(wino_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = wino_smem + (base - raw);
  const uint32_t bars = base + L::bar_off;
  auto slab_full = [&](int s) { return bars + 8 * s; };
  auto slab_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto u_full = [&](int s) { return bars + 8 * (4 + s); };
  auto u_empty = [&](int s) { return bars + 8 * (6 + s); };
  const uint32_t e_full = bars + 8 * 8;                // the identity skip's tile has landed
  auto slab_stage = [&](int s) { return base + L::slab_off + s * L::SLAB_STAGE; };
  auto u_stage = [&](int s) { return base + L::u_off + s * L::STAGE; };
  auto v_stage = [&](int s) { return base + L::v_off + s * L::STAGE; };

  const int n0 = blockIdx.x * L::BN, tile = blockIdx.y, b = blockIdx.z;
  const int h0 = (tile / tiles_w) * L::TH, w0 = (tile % tiles_w) * L::TW;
  const int chunks = (C + L::BK - 1) / L::BK;
  const int steps = 4 * chunks;                        // (chunk, nu), nu inside
  const int proj_steps = skip_mode == SKIP_PROJ ? 2 * ((Cs + L::BK - 1) / L::BK) : 0;   // (Cs chunk, q), q inside

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(slab_full(s), 1);
      mbar_init(slab_empty(s), 8);                     // lane 0 of each consumer warp
      mbar_init(u_full(s), 1);
      mbar_init(u_empty(s), 8);
    }
    mbar_init(e_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::CONSUMERS) {
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x != L::CONSUMERS) return;
    // ---------------- the producer thread: every TMA load
    mbar_arrive_expect_tx(slab_full(0), L::SLAB_BYTES);
    tma_load_4d(slab_stage(0), &xmap, 0, w0 - 1, h0 - 1, b, slab_full(0));
    for (int s = 0; s < steps + proj_steps; ++s) {
      const int st = s & 1;
      if (s < steps && (s & 3) == 0) {
        // the next chunk's slab, a chunk ahead; after the last chunk's, the
        // identity skip's tile into the same ring
        const int c = (s >> 2) + 1;
        if (c < chunks || skip_mode == SKIP_ADD) {
          mbar_wait_or_trap(slab_empty(c & 1), ((c >> 1) & 1) ^ 1);
          if (c < chunks) {
            mbar_arrive_expect_tx(slab_full(c & 1), L::SLAB_BYTES);
            tma_load_4d(slab_stage(c & 1), &xmap, c * L::BK, w0 - 1, h0 - 1, b, slab_full(c & 1));
          } else {
            mbar_arrive_expect_tx(e_full, L::TH * L::ROW_BOX);
            tma_load_4d(slab_stage(c & 1), &smap, n0, w0, h0, b, e_full);
          }
        }
      }
      mbar_wait_or_trap(u_empty(st), ((s >> 1) & 1) ^ 1);
      if (s < steps) {                                 // U[0..3][nu] of the chunk
        mbar_arrive_expect_tx(u_full(st), 4 * L::PLANE);
#pragma unroll
        for (int mu = 0; mu < 4; ++mu)
          tma_load_3d(u_stage(st) + mu * L::PLANE, &umap, n0, (s >> 2) * L::BK, mu * 4 + (s & 3), u_full(st));
      } else {                                         // the projection: the skip for p = 0, 1 at column q, and ws
        const int j = s - steps, cs0 = (j >> 1) * L::BK, q = j & 1;
        mbar_arrive_expect_tx(u_full(st), 3 * L::PLANE);
        tma_load_4d(u_stage(st), &smap, cs0, w0 + q, h0, b, u_full(st));
        tma_load_4d(u_stage(st) + L::PLANE, &smap, cs0, w0 + q, h0 + 1, b, u_full(st));
        tma_load_3d(u_stage(st) + 2 * L::PLANE, &wsmap, n0, cs0, 0, u_full(st));
      }
    }
    return;
  }

  // ---------------- consumer warpgroups: warpgroup p owns output rows of parity p
  setmaxnreg_inc<L::CONSUMER_REGS>();
  const int p = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // the thread's transform task: tiles (ty, tx), (ty + 1, tx), 16-byte chunk lc
  const int lc = threadIdx.x & 7, pair = threadIdx.x >> 3;
  const int task_ty = 2 * (pair / L::TTW), task_tx = pair % L::TTW;
  // step s's V into its stage, once the slab has landed. The stage is free:
  // the step barrier before step s - 1's products saw both warpgroups' step
  // s - 2 products complete
  auto transform = [&](int s) {
    const int c = s >> 2, nu = s & 3;
    if (nu == 0) mbar_wait_or_trap(slab_full(c & 1), (c >> 1) & 1);
    wino_transform(sm + L::slab_off + (c & 1) * L::SLAB_STAGE, sm + L::v_off + (s & 1) * L::STAGE, task_ty,
                   task_tx, lc, nu);
    fence_proxy_async();                               // these writes before the wgmma reads
    if (nu == 3) {                                     // the warp's last read of the slab is done
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(slab_empty(c & 1));
    }
  };

  float acc[4][32];                                    // Z[p][nu]
#pragma unroll
  for (int nu = 0; nu < 4; ++nu)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nu][i] = 0.0f;

  transform(0);
  auto run = [&](auto pc) {
    constexpr int P = decltype(pc)::value;
    auto step = [&](int c, auto nuc) {
      constexpr int NU = decltype(nuc)::value;
      const int s = 4 * c + NU, st = s & 1;
      // the step barrier: every consumer's share of V is written, and both
      // warpgroups' previous products have completed
      named_barrier_sync(1, L::CONSUMERS);
      mbar_wait_or_trap(u_full(st), (s >> 1) & 1);
      fence_regs(acc[NU]);
      wgmma_fence();
      wino_products<P>(acc[NU], v_stage(st), u_stage(st));
      wgmma_commit();
      if (s + 1 < steps) transform(s + 1);             // while the tensor cores run
      wgmma_wait<0>();
      fence_regs(acc[NU]);
      if (lane == 0) mbar_arrive(u_empty(st));
    };
    for (int c = 0; c < chunks; ++c) {
      step(c, IntC<0>());
      step(c, IntC<1>());
      step(c, IntC<2>());
      step(c, IntC<3>());
    }
    // K1's projection: q = 0 into Z[p][0], q = 1 out of Z[p][3]
    auto proj = [&](int s, auto qc) {
      constexpr int Q = decltype(qc)::value;
      const int st = s & 1;
      mbar_wait_or_trap(u_full(st), (s >> 1) & 1);
      fence_regs(acc[3 * Q]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk)
        wgmma_ss_tb64<Q == 0 ? 1 : -1>(acc[3 * Q], wgmma_desc(u_stage(st) + P * L::PLANE + kk * 32, 16, 1024),
                                       wgmma_desc(u_stage(st) + 2 * L::PLANE + kk * 2048, L::PLANE, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[3 * Q]);
      if (lane == 0) mbar_arrive(u_empty(st));
    };
    for (int j = 0; j < proj_steps; j += 2) {
      proj(steps + j, IntC<0>());
      proj(steps + j + 1, IntC<1>());
    }
  };
  if (p == 0)
    run(IntC<0>());
  else
    run(IntC<1>());

  // ---------------- epilogue: the thread's accumulator rows are Winograd
  // tiles (warp, g) and (warp, g + 8): output row 2 warp + p of the tile (r),
  // columns 2 tx + q. Both warpgroups' products are done: the V ring is free
  // for y, a {64 N, 32} box per output row.
  named_barrier_sync(1, L::CONSUMERS);
  if (skip_mode == SKIP_ADD) mbar_wait_or_trap(e_full, 0);
  const int r = 2 * warp + p, hh = h0 + r;
  unsigned char* ybox = sm + L::v_off + r * L::ROW_BOX;
  const unsigned char* sbox = sm + L::slab_off + (chunks & 1) * L::SLAB_STAGE + r * L::ROW_BOX;   // the skip's row r
  float* red = reinterpret_cast<float*>(sm + L::red_off);
#pragma unroll
  for (int nt = 0; nt < L::BN / 8; ++nt) {
    const int col = nt * 8 + 2 * t4, n = n0 + col;
    const bool live = n < N;                           // N % 8 == 0: n + 1 is inside too
    float b0 = 0.0f, b1 = 0.0f;
    if (live) {
      b0 = bias[n];
      b1 = bias[n + 1];
      if (skip_mode == SKIP_PROJ) {
        b0 += wsb[n];
        b1 += wsb[n + 1];
      }
    }
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};             // sum, sum, sumsq, sumsq of channels n, n + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * nt + 2 * h, tx = g + 8 * h;
      float yq[2][2];                                  // [q][channel]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z0 = acc[0][i + e], z1 = acc[1][i + e], z2 = acc[2][i + e], z3 = acc[3][i + e];
        yq[0][e] = z0 + z1 + z2;
        yq[1][e] = z1 - z2 - z3;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t off = sw128_offset(2 * tx + q, col);
        float y0 = yq[q][0] + b0, y1 = yq[q][1] + b1;
        if (skip_mode == SKIP_ADD) {                   // the skip before the one rounding
          const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sbox + off));
          y0 += sv.x;
          y1 += sv.y;
        }
        const __nv_bfloat162 yv = __floats2bfloat162_rn(y0, y1);
        *reinterpret_cast<__nv_bfloat162*>(ybox + off) = yv;
        if (live && hh < H && w0 + 2 * tx + q < W) {   // statistics of the rounded y inside the image
          const float2 f = __bfloat1622float2(yv);
          v[0] += f.x;
          v[1] += f.y;
          v[2] += f.x * f.x;
          v[3] += f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (g == 0) {
      const int wi = 4 * p + warp;
      red[wi * L::BN + col] = v[0];
      red[wi * L::BN + col + 1] = v[1];
      red[(8 + wi) * L::BN + col] = v[2];
      red[(8 + wi) * L::BN + col + 1] = v[3];
    }
  }
  fence_proxy_async();                                 // the staged y before the TMA stores read it
  __syncwarp();
  if (lane == 0) {                                     // a warp's row of the tile; TMA clips it at the edges
    tma_store_4d(&ymap, base + L::v_off + r * L::ROW_BOX, n0, w0, hh, b);
    tma_store_commit_and_wait();
  }
  named_barrier_sync(1, L::CONSUMERS);
  const int n = n0 + (int)threadIdx.x;
  if ((int)threadIdx.x < L::BN && n < N) {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s0 += red[i * L::BN + threadIdx.x];
      s1 += red[(8 + i) * L::BN + threadIdx.x];
    }
    const size_t row = ((size_t)b * gridDim.y + tile) * 2;
    partial[row * N + n] = s0;
    partial[(row + 1) * N + n] = s1;
  }
}

}  // namespace

extern "C" {

// Output tile geometry, so the wrapper sizes the partial-statistics scratch.
int ragb_wino_tile_shape(int* tile_h, int* tile_w) {
  *tile_h = Wino::TH;
  *tile_w = Wino::TW;
  return 0;
}

// u: (4, 4, C, N) bf16, U[mu][nu] = (G w G^T)[mu][nu]; xa (B, H, W, C) bf16,
// scratch for the activated input; the rest as K1's entry: x (B, H, W, C), a,
// b (B, C) fp32, bias (N,) fp32; skip (B, H, W, N) for SKIP_ADD or (B, H, W,
// Cs) with ws (Cs, N) and wsb (N,) fp32 for SKIP_PROJ; y (B, H, W, N), stats
// (B, 2, N), partial (B, T, 2, N) with T this kernel's tiles of one image
// (ragb_wino_tile_shape).
int ragb_resnet_conv3x3_stats_wino(const void* x, const float* a, const float* b, const void* u,
                                   const float* bias, const void* skip, const void* ws, const float* wsb,
                                   void* xa, void* y, float* partial, float* stats, int T, int B, int H, int W,
                                   int C, int N, int Cs, int silu, int skip_mode, void* stream) {
  using L = Wino;
  if (skip_mode != SKIP_PROJ) Cs = 0;
  if (B < 1 || B > 65535 || H < 2 || W < 2 || H % 2 || W % 2 || C < 8 || N < 8 || C % 8 || N % 8 || Cs % 8)
    return (int)cudaErrorInvalidValue;
  if (skip_mode < SKIP_NONE || skip_mode > SKIP_PROJ || (skip_mode != SKIP_NONE && skip == nullptr) ||
      (skip_mode == SKIP_PROJ && (ws == nullptr || wsb == nullptr || Cs < 8)))
    return (int)cudaErrorInvalidValue;
  if (a == nullptr || b == nullptr || bias == nullptr || xa == nullptr || partial == nullptr || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + L::TW - 1) / L::TW, tiles_h = (H + L::TH - 1) / L::TH;
  if ((long long)tiles_w * tiles_h > 65535 || T != tiles_w * tiles_h) return (int)cudaErrorInvalidValue;
  // TMA bases and the 16-byte vectors of the activation pass
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(skip) |
       reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(xa) | reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap xm, um, sm, wm, ym;
  int e;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)L::SW, (cuuint32_t)L::SH, 1};
  if ((e = encode_tensor_map(&xm, xa, 4, xdims, xbox, ones))) return e;
  if ((e = encode_tensor_map_3d(&um, u, N, C, 16, 64))) return e;
  const cuuint64_t ydims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t ybox[4] = {64, (cuuint32_t)L::TW, 1, 1};
  if ((e = encode_tensor_map(&ym, y, 4, ydims, ybox, ones))) return e;
  sm = xm;
  wm = um;
  const cuuint32_t tile_box[4] = {64, (cuuint32_t)L::TW, (cuuint32_t)L::TH, 1};
  if (skip_mode == SKIP_ADD && (e = encode_tensor_map(&sm, skip, 4, ydims, tile_box, ones))) return e;
  if (skip_mode == SKIP_PROJ) {
    // the skip's pixels (2 ty + p, 2 tx + q) of a block's 64 tiles: every
    // other column and row of a {64, 32, 8} box
    const cuuint64_t sdims[4] = {(cuuint64_t)Cs, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint32_t every_other[4] = {1, 2, 2, 1};
    if ((e = encode_tensor_map(&sm, skip, 4, sdims, tile_box, every_other))) return e;
    if ((e = encode_tensor_map_3d(&wm, ws, N, Cs, 1, 64))) return e;
  }
  // the shared-memory opt-in, once per device
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= 64 || !((opted_in >> dev) & 1)) {
    ce = cudaFuncSetAttribute(wino_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (ce != cudaSuccess) return (int)ce;
    if (dev < 64) opted_in |= (uint64_t)1 << dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vecs = (size_t)B * H * W * C / 8;
  const unsigned act_blocks = (unsigned)((vecs + 255) / 256 < 132 * 16 ? (vecs + 255) / 256 : 132 * 16);
  wino_act_kernel<<<act_blocks, 256, 0, s>>>(static_cast<const uint4*>(x), a, b, static_cast<uint4*>(xa), vecs, C,
                                              (size_t)H * W * C / 8, silu);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((N + L::BN - 1) / L::BN, tiles_w * tiles_h, B);
  wino_conv_kernel<<<grid, L::THREADS, L::bytes, s>>>(xm, um, sm, wm, ym, bias, wsb, partial, H, W, C, N, Cs,
                                                      skip_mode, tiles_w);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  stats_reduce_kernel<<<dim3((N + 31) / 32, B), dim3(32, 32), 0, s>>>(partial, stats, T, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
