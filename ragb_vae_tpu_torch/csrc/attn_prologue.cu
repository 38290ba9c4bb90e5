// Attention prologue for Hopper (sm_90a), K13: from the q, k, v projections
// to the (B, H, S, D) operands of the attention kernel, forward and backward.
//
// Replaces no TPU kernel. The JAX package leaves this chain of
// ragb_vae_tpu/models/flux_transformer.py (split into heads, RMSNorm of q and
// k per stream, text tokens before image tokens, RoPE) to XLA's fusion, which
// hands q, k and v to `_flash_kernel` of
// ragb_vae_tpu/ops/pallas/flash_attention.py. In eager PyTorch the same chain was about twenty
// elementwise passes a block (fp32 casts, the square, the mean, rsqrt, the
// products, the stacked rotation, the concatenations, K3's `.contiguous()`),
// each reading and writing whole stream tensors; K13 does it in one pass.
//
// Arithmetic: the plain chain's, rounding where it rounds. A row of D values
// x (one token, one head) is read in bf16; its mean square is summed in fp32
// (the only change: the order of the sum), r = rsqrtf(mean + eps),
// y = bf16((x * r) * w) with each product rounded in fp32 as PyTorch's
// separate kernels round them; RoPE then runs in fp32 from that bf16 y,
// out_2i = y_2i cos_2i - y_2i+1 sin_2i and out_2i+1 = y_2i+1 cos_2i+1 +
// y_2i sin_2i+1, each product and the sum rounded once (no FMA), and the
// result is rounded once to bf16. v is copied.
//
// Backward (`attn_prologue_bwd_kernel`): from the gradients of q, k, v in the
// joint layout and the saved bf16 projection outputs; r is recomputed from x.
// All in fp32: gy = RoPE^T g (rotation by -theta: gy_2i = g_2i cos_2i +
// g_2i+1 sin_2i+1, gy_2i+1 = g_2i+1 cos_2i+1 - g_2i sin_2i), gn = gy * w,
// dx = r gn - (r^3 / D) x sum(gn x), rounded once to bf16 into the stream's
// own (B, S, H * D) layout; dv is the inverse copy. The norm weights'
// gradients sum(gy * x * r) over rows only when asked: each block folds its
// rows in registers, then its warps through shared memory in a fixed order,
// and writes one partial row per weight; the wrapper sums the partials.
// The plain chain rounds gy to bf16 between RoPE and RMSNorm (its fp32 casts
// hand a bf16 gradient back); K13 keeps it in fp32.
//
// What bounds it on the H100: bytes. Per element of q, k and v it reads 2
// bytes and writes 2 (cos and sin, (S, D) fp32, are shared by every batch
// row and head and stay in L2), about one operation a byte, far under the
// ridge: at the serving shape (B 4, S 2,560, 24 heads of 128) that is 377 MB
// a call, 0.113 ms at 3.35 TB/s; the backward reads 5 tensors and writes 3.
//
// Design: a row is 16 lanes (a half-warp), each holding VEC consecutive
// values in each of NC chunks (d = 128: one 16-byte load per lane per
// tensor, NC = 1), so an adjacent RoPE pair always lies in one lane and
// the sums over a row are four shuffles. Rows are ordered (b, token, head),
// so consecutive rows read consecutive input bytes and share their cos and
// sin row; each row's output is a contiguous D-run of the head-major layout.
// The lanes of a row load q, k and v and both cos and sin before any use,
// so every thread keeps several 16-byte loads in flight; 256-thread blocks
// walk the rows in a grid-stride loop sized to fill every SM.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int GROUP = 16;                   // lanes a row
constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / GROUP;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int N_WEIGHTS = 4;                // txt q, txt k, img q, img k

// VEC bf16 values, loaded and stored in one instruction
template <int VEC>
struct alignas(2 * VEC) Bf16Pack {
  __nv_bfloat162 h[VEC / 2];
};

// VEC fp32 values (cos, sin, an fp32 weight)
template <int VEC>
struct alignas(VEC >= 4 ? 16 : 4 * VEC) FloatPack {
  float f[VEC];
};

template <int VEC>
__device__ __forceinline__ void load_bf16(const bf16* p, float* out) {
  const Bf16Pack<VEC> pk = *reinterpret_cast<const Bf16Pack<VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(pk.h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store_bf16(bf16* p, const float* in) {
  Bf16Pack<VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) pk.h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<Bf16Pack<VEC>*>(p) = pk;
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  const FloatPack<VEC> pk = *reinterpret_cast<const FloatPack<VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = pk.f[i];
}

// a norm weight (bf16 or fp32) as fp32
template <int VEC>
__device__ __forceinline__ void load_weight(const void* w, int e, bool w_fp32, float* out) {
  if (w_fp32)
    load_f32<VEC>(static_cast<const float*>(w) + e, out);
  else
    load_bf16<VEC>(static_cast<const bf16*>(w) + e, out);
}

// sum over the 16 lanes of a row (xor offsets below 16 stay in the
// half-warp); `mask` names the row's lanes only: the other half-warp may
// have left the row loop
__device__ __forceinline__ float row_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ unsigned row_mask() { return 0xFFFFu << (threadIdx.x & GROUP); }

struct Geometry {
  int B, S_txt, S_img, H, D;
  __host__ __device__ int rows() const { return B * (S_txt + S_img) * H; }
};

// The places of one row: the stream it comes from, its offset there
// ((B, S_stream, H * D)), its offset in the joint (B, H, S, D) layout and in
// cos / sin (S, D).
struct Row {
  bool txt;
  size_t in, out, rope;
};

__device__ __forceinline__ Row locate(const Geometry& g, int r) {
  const int S = g.S_txt + g.S_img;
  const int h = r % g.H;
  const int t = (r / g.H) % S;
  const int b = r / (g.H * S);
  Row row;
  row.txt = t < g.S_txt;
  const int s_stream = row.txt ? g.S_txt : g.S_img;
  const int tok = row.txt ? t : t - g.S_txt;
  row.in = ((size_t(b) * s_stream + tok) * g.H + h) * g.D;
  row.out = ((size_t(b) * g.H + h) * S + t) * g.D;
  row.rope = size_t(t) * g.D;
  return row;
}

struct FwdArgs {
  const bf16 *q, *k, *v, *tq, *tk, *tv;     // (B, S_img, H*D), (B, S_txt, H*D)
  const void *wq, *wk, *wtq, *wtk;          // (D,) bf16 or fp32
  const float *cos, *sin;                   // (S, D)
  bf16 *oq, *ok, *ov;                       // (B, H, S, D)
};

template <int VEC, int NC>
__global__ void __launch_bounds__(THREADS) attn_prologue_kernel(FwdArgs a, Geometry g, float eps, int w_fp32) {
  const int lane = threadIdx.x % GROUP;
  const unsigned mask = row_mask();
  const int rows = g.rows();
  const float inv_d = 1.0f / g.D;
  for (int r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / GROUP; r < rows; r += gridDim.x * ROWS_PER_BLOCK) {
    const Row row = locate(g, r);
    const bf16* src[3] = {row.txt ? a.tq : a.q, row.txt ? a.tk : a.k, row.txt ? a.tv : a.v};
    const void* wsrc[2] = {row.txt ? a.wtq : a.wq, row.txt ? a.wtk : a.wk};
    float x[2][NC][VEC], c[NC][VEC], s[NC][VEC];
    Bf16Pack<VEC> v[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (lane + j * GROUP) * VEC;
      if (e < g.D) {
        load_bf16<VEC>(src[0] + row.in + e, x[0][j]);
        load_bf16<VEC>(src[1] + row.in + e, x[1][j]);
        v[j] = *reinterpret_cast<const Bf16Pack<VEC>*>(src[2] + row.in + e);
        load_f32<VEC>(a.cos + row.rope + e, c[j]);
        load_f32<VEC>(a.sin + row.rope + e, s[j]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[0][j][i] = x[1][j][i] = 0.0f;
      }
    }
    bf16* dst[2] = {a.oq, a.ok};
#pragma unroll
    for (int m = 0; m < 2; ++m) {            // q, then k
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = __fadd_rn(ss, __fmul_rn(x[m][j][i], x[m][j][i]));
      const float rstd = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss, mask), inv_d), eps));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int e = (lane + j * GROUP) * VEC;
        if (e >= g.D) continue;
        float w[VEC], y[VEC], o[VEC];
        load_weight<VEC>(wsrc[m], e, w_fp32, w);
#pragma unroll
        for (int i = 0; i < VEC; ++i)     // RMSNorm, rounded to bf16 as the plain chain rounds it
          y[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fmul_rn(x[m][j][i], rstd), w[i])));
#pragma unroll
        for (int i = 0; i < VEC; i += 2) {
          o[i] = __fadd_rn(__fmul_rn(y[i], c[j][i]), __fmul_rn(-y[i + 1], s[j][i]));
          o[i + 1] = __fadd_rn(__fmul_rn(y[i + 1], c[j][i + 1]), __fmul_rn(y[i], s[j][i + 1]));
        }
        store_bf16<VEC>(dst[m] + row.out + e, o);
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (lane + j * GROUP) * VEC;
      if (e < g.D) *reinterpret_cast<Bf16Pack<VEC>*>(a.ov + row.out + e) = v[j];
    }
  }
}

struct BwdArgs {
  const bf16 *gq, *gk, *gv;                 // (B, H, S, D)
  const bf16 *q, *k, *tq, *tk;              // the saved projection outputs
  const void *wq, *wk, *wtq, *wtk;
  const float *cos, *sin;
  bf16 *dq, *dk, *dv, *dtq, *dtk, *dtv;     // the streams' layouts
  float* partial;                           // (gridDim.x, N_WEIGHTS, D) when NEED_DW
};

template <int VEC, int NC, bool NEED_DW>
__global__ void __launch_bounds__(THREADS) attn_prologue_bwd_kernel(BwdArgs a, Geometry g, float eps, int w_fp32) {
  __shared__ float red[NEED_DW ? WARPS * N_WEIGHTS * MAX_D : 1];
  const int lane = threadIdx.x % GROUP;
  const unsigned mask = row_mask();
  const int rows = g.rows();
  const float inv_d = 1.0f / g.D;
  float acc[NEED_DW ? N_WEIGHTS : 1][NC][VEC];
  if constexpr (NEED_DW) {
#pragma unroll
    for (int n = 0; n < N_WEIGHTS; ++n)
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[n][j][i] = 0.0f;
  }
  for (int r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / GROUP; r < rows; r += gridDim.x * ROWS_PER_BLOCK) {
    const Row row = locate(g, r);
    const bf16* xsrc[2] = {row.txt ? a.tq : a.q, row.txt ? a.tk : a.k};
    const void* wsrc[2] = {row.txt ? a.wtq : a.wq, row.txt ? a.wtk : a.wk};
    bf16* dst[3] = {row.txt ? a.dtq : a.dq, row.txt ? a.dtk : a.dk, row.txt ? a.dtv : a.dv};
    const bf16* gsrc[2] = {a.gq, a.gk};
    float x[2][NC][VEC], gr[2][NC][VEC], c[NC][VEC], s[NC][VEC];
    Bf16Pack<VEC> gv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (lane + j * GROUP) * VEC;
      if (e < g.D) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          load_bf16<VEC>(xsrc[m] + row.in + e, x[m][j]);
          load_bf16<VEC>(gsrc[m] + row.out + e, gr[m][j]);
        }
        gv[j] = *reinterpret_cast<const Bf16Pack<VEC>*>(a.gv + row.out + e);
        load_f32<VEC>(a.cos + row.rope + e, c[j]);
        load_f32<VEC>(a.sin + row.rope + e, s[j]);
      } else {   // past D: zeros, so the row's sums and this lane's RoPE^T see nothing
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          x[0][j][i] = x[1][j][i] = gr[0][j][i] = gr[1][j][i] = c[j][i] = s[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = __fadd_rn(ss, __fmul_rn(x[m][j][i], x[m][j][i]));
      const float rstd = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss, mask), inv_d), eps));
      float gy[NC][VEC], gn[NC][VEC], dot = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int e = (lane + j * GROUP) * VEC;
        float w[VEC];
        if (e < g.D) {
          load_weight<VEC>(wsrc[m], e, w_fp32, w);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) w[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < VEC; i += 2) {   // RoPE^T: rotation by -theta
          gy[j][i] = gr[m][j][i] * c[j][i] + gr[m][j][i + 1] * s[j][i + 1];
          gy[j][i + 1] = gr[m][j][i + 1] * c[j][i + 1] - gr[m][j][i] * s[j][i];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          gn[j][i] = gy[j][i] * w[i];
          dot += gn[j][i] * x[m][j][i];
        }
      }
      const float coef = rstd * rstd * rstd * row_sum(dot, mask) * inv_d;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int e = (lane + j * GROUP) * VEC;
        if (e >= g.D) continue;
        float dx[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) dx[i] = rstd * gn[j][i] - coef * x[m][j][i];
        store_bf16<VEC>(dst[m] + row.in + e, dx);
        if constexpr (NEED_DW) {
          const int n = (row.txt ? 0 : 2) + m;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[n][j][i] += gy[j][i] * (x[m][j][i] * rstd);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int e = (lane + j * GROUP) * VEC;
      if (e < g.D) *reinterpret_cast<Bf16Pack<VEC>*>(dst[2] + row.in + e) = gv[j];
    }
  }
  if constexpr (NEED_DW) {
    // lanes l and l ^ 16 hold the same columns: fold the two rows of a warp,
    // then the warps in order
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int n = 0; n < N_WEIGHTS; ++n)
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float v = acc[n][j][i] + __shfl_xor_sync(0xffffffffu, acc[n][j][i], GROUP);
          const int e = (lane + j * GROUP) * VEC + i;
          if (threadIdx.x % 32 < GROUP && e < g.D) red[(warp * N_WEIGHTS + n) * MAX_D + e] = v;
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < N_WEIGHTS * g.D; idx += THREADS) {
      const int n = idx / g.D, e = idx % g.D;
      float total = 0.0f;
      for (int w = 0; w < WARPS; ++w) total += red[(w * N_WEIGHTS + n) * MAX_D + e];
      a.partial[(size_t(blockIdx.x) * N_WEIGHTS + n) * g.D + e] = total;
    }
  }
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return true;
  return false;
}

bool bad_geometry(const Geometry& g, int blocks) {
  const long long rows = 1LL * g.B * (g.S_txt + g.S_img) * g.H;
  return g.B <= 0 || g.S_txt < 0 || g.S_img <= 0 || g.H <= 0 || g.D <= 0 || g.D > MAX_D || g.D % 2 ||
         rows > 0x7fffffffLL || blocks <= 0;
}

template <int VEC, int NC>
cudaError_t launch_fwd(const FwdArgs& a, const Geometry& g, float eps, int w_fp32, int blocks, cudaStream_t s) {
  attn_prologue_kernel<VEC, NC><<<blocks, THREADS, 0, s>>>(a, g, eps, w_fp32);
  return cudaGetLastError();
}

template <int VEC, int NC>
cudaError_t launch_bwd(const BwdArgs& a, const Geometry& g, float eps, int w_fp32, int need_dw, int blocks,
                       cudaStream_t s) {
  if (need_dw)
    attn_prologue_bwd_kernel<VEC, NC, true><<<blocks, THREADS, 0, s>>>(a, g, eps, w_fp32);
  else
    attn_prologue_bwd_kernel<VEC, NC, false><<<blocks, THREADS, 0, s>>>(a, g, eps, w_fp32);
  return cudaGetLastError();
}

// The chunk shape of a row of D values: 16-byte chunks when D allows them.
#define ATTN_PROLOGUE_DISPATCH(D, LAUNCH, ...)                        \
  ((D) % 8 == 0 && (D) <= 128 ? LAUNCH<8, 1>(__VA_ARGS__)             \
   : (D) % 8 == 0             ? LAUNCH<8, 2>(__VA_ARGS__)             \
   : (D) % 4 == 0             ? LAUNCH<4, 4>(__VA_ARGS__)             \
                              : LAUNCH<2, 8>(__VA_ARGS__))

}  // namespace

// Forward: q, k, v (B, S_img, H*D) and tq, tk, tv (B, S_txt, H*D) bf16 (null
// when S_txt is 0), the four norm weights (D,) (fp32 when w_fp32, else bf16),
// cos and sin (S_txt + S_img, D) fp32 -> oq, ok, ov (B, H, S_txt + S_img, D)
// bf16, text rows first. `blocks` blocks of 256 threads.
extern "C" int ragb_attn_prologue_fwd(const void* q, const void* k, const void* v, const void* tq, const void* tk,
                                      const void* tv, const void* wq, const void* wk, const void* wtq,
                                      const void* wtk, const float* cos, const float* sin, void* oq, void* ok,
                                      void* ov, int B, int S_txt, int S_img, int H, int D, int w_fp32, int blocks,
                                      float eps, void* stream) {
  const Geometry g{B, S_txt, S_img, H, D};
  if (bad_geometry(g, blocks)) return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, wq, wk, cos, sin, oq, ok, ov}) || (S_txt && misaligned({tq, tk, tv, wtq, wtk})))
    return (int)cudaErrorMisalignedAddress;
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const bf16*>(tq), static_cast<const bf16*>(tk), static_cast<const bf16*>(tv),
                  wq, wk, wtq, wtk, cos, sin,
                  static_cast<bf16*>(oq), static_cast<bf16*>(ok), static_cast<bf16*>(ov)};
  return (int)ATTN_PROLOGUE_DISPATCH(D, launch_fwd, a, g, eps, w_fp32, blocks, static_cast<cudaStream_t>(stream));
}

// Backward: gq, gk, gv (B, H, S, D) bf16, the forward's q, k, tq, tk,
// weights, cos and sin -> dq, dk, dv (B, S_img, H*D) and dtq, dtk, dtv
// (B, S_txt, H*D) bf16; with need_dw, partial (blocks, 4, D) fp32 holds each
// block's sums for the weights txt q, txt k, img q, img k.
extern "C" int ragb_attn_prologue_bwd(const void* gq, const void* gk, const void* gv, const void* q, const void* k,
                                      const void* tq, const void* tk, const void* wq, const void* wk,
                                      const void* wtq, const void* wtk, const float* cos, const float* sin,
                                      void* dq, void* dk, void* dv, void* dtq, void* dtk, void* dtv, float* partial,
                                      int B, int S_txt, int S_img, int H, int D, int w_fp32, int need_dw,
                                      int blocks, float eps, void* stream) {
  const Geometry g{B, S_txt, S_img, H, D};
  if (bad_geometry(g, blocks) || (need_dw && partial == nullptr)) return (int)cudaErrorInvalidValue;
  if (misaligned({gq, gk, gv, q, k, wq, wk, cos, sin, dq, dk, dv}) ||
      (S_txt && misaligned({tq, tk, wtq, wtk, dtq, dtk, dtv})))
    return (int)cudaErrorMisalignedAddress;
  const BwdArgs a{static_cast<const bf16*>(gq), static_cast<const bf16*>(gk), static_cast<const bf16*>(gv),
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(tq),
                  static_cast<const bf16*>(tk), wq, wk, wtq, wtk, cos, sin,
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  static_cast<bf16*>(dtq), static_cast<bf16*>(dtk), static_cast<bf16*>(dtv), partial};
  return (int)ATTN_PROLOGUE_DISPATCH(D, launch_bwd, a, g, eps, w_fp32, need_dw, blocks,
                                     static_cast<cudaStream_t>(stream));
}
