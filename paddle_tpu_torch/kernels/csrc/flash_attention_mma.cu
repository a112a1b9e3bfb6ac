// Flash attention forward, dQ and dK/dV at every head dim that is a
// multiple of 16 from 16 to 256, for Hopper (sm_90a).
//
// Replaces the same Pallas kernels of paddle_tpu/kernels/flash_attention.py
// as flash_attention.cu (K1 _fwd_kernel, K2 _bwd_dq_kernel, K3
// _bwd_dkv_kernel) where the wgmma kernels do not run.  By kernel, head
// dim and type, the wrapper (kernels/flash_attention.py, _library) picks:
//   bf16/fp16, D 64, 96, 128:  K1, K2, K3 in flash_attention.cu
//   bf16/fp16, D 256:          K1, K3 in flash_attention_d256.cu; K2 here
//   bf16/fp16, other D:        K1, K2, K3 here
//   fp32, every D:             K1, K2, K3 here
// So this file holds one simpler design for fp32 at every D and for
// bf16/fp16 at the other head dims.  Its bf16 K1 and K3 of the 256
// bucket still run D 240, and chip_smoke.py times them at D 256 beside
// the wgmma kernels that took D 256 over.
//
// The arithmetic and its rounding are those of flash_attention.cu's header:
// every product of 16-bit inputs takes both operands in bf16 and sums in
// fp32, P is rounded to bf16 before P.V and P^T.dO, dS before dS.K and
// dS^T.Q; fp16 inputs arrive rounded to bf16 by the wrapper and O, dQ, dK
// and dV are written as fp16 straight from the fp32 accumulators
// (Params::out_f16); fp32 inputs stay fp32 on CUDA cores.  The causal mask
// is the finite -FLT_MAX; O = acc / max(l, 1e-30), LSE = m + log(max(l,
// 1e-30)).  Nothing crosses CTAs and every sum runs in a fixed order: no
// atomics, and two runs give the same bits.
//
// Why not the wgmma design at every D: flash_attention.cu's K3 gives each
// consumer warpgroup both a dK and a dV accumulator, 256 registers a
// thread on their own at D 256, and its K2 holds dQ beside two score
// tiles.  flash_attention_d256.cu recuts K1 and K3 for D 256 (64-key
// tiles; K3's warpgroups split dV from dK and hand P^T over); K2 at D
// 256 and the other head dims take the FA2 shape here: a CTA of 4 warps owns
// 64 query rows (K1, K2) or 64 key rows (K3), each warp 16 of them, and
// loops over the other side's tiles staged in shared memory; products are
// warp-level mma.sync m16n8k16 (bf16 in, fp32 sums) fed by ldmatrix, with
// a score tile's accumulators reused in registers as the A operand of the
// next product.  Above D 128, K3 computes dV and dK in two CTAs of a
// 2-deep grid (each recomputes the scores), so a thread holds one
// 16 x D accumulator, and K1/K2 stream 32-key tiles.
//
// What bounds them on this card: as in flash_attention.cu, the tensor-core
// work (4, 6 and 8 * D flops per (query, key) pair for K1, K2, K3, halved by
// causal) against a few bytes a row; this design reaches a fraction of it
// (no TMA, no wgmma, one CTA's loads not overlapped with its products).
//
// Head dims are built by buckets: DB = D rounded up to a multiple of 32
// (32, 64, ..., 256), eight instances a kernel and type.  Rows are loaded
// D wide and zero-filled to DB in shared memory, the score products stop
// at D, and only D columns are written.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with the same plain C interface as flash_attention.cu.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a CTA owns (q in K1/K2, k in K3)
constexpr float kNegInf = -FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  int64_t q_sb, q_sh, q_ss;
  const void* k;
  int64_t k_sb, k_sh, k_ss;
  const void* v;
  int64_t v_sb, v_sh, v_ss;
  const void* dout;  // dO (K2, K3)
  int64_t do_sb, do_sh, do_ss;
  const float* lse;    // [B, H, S] (K2, K3)
  const float* delta;  // [B, H, S] (K2, K3)
  void* out;           // O (K1), dQ (K2), dK (K3)
  int64_t o_sb, o_sh, o_ss;
  void* out2;          // dV (K3), same strides as out
  float* lse_out;      // [B, H, S] (K1)
  int B, H, S, D, causal;
  float scale;
  int out_f16;         // bf16 kernels: write O, dQ, dK, dV as fp16
};

// keys a K/V tile holds in K1 and K2: fewer above D 128, where the 16 x D
// accumulator takes half a thread's registers
template <int DB>
__host__ __device__ constexpr int tile_k() {
  return DB > 128 ? 32 : 64;
}

// queries a Q/dO tile holds in K3
template <int DB>
__host__ __device__ constexpr int tile_q() {
  return DB <= 64 ? 64 : 32;
}

// K3 splits dV and dK over blockIdx.z above D 128
template <int DB>
__host__ __device__ constexpr bool split_dkv() {
  return DB > 128;
}

// Shared-memory row pitch: DB plus one 16-byte vector of padding (rows
// stay 16-byte aligned for ldmatrix and 128-byte rows do not share banks).
template <typename T, int DB>
__host__ __device__ constexpr int pitch() {
  return DB + 16 / static_cast<int>(sizeof(T));
}

// Copy `rows` rows of D elements (global row stride `stride`) into shared
// memory at pitch<T, DB>(), zero-filling columns D..DB-1, in 16-byte
// vectors (D is a multiple of 16, so a vector never straddles D).
template <typename T, int DB>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t stride, int rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DB / kVec;
  constexpr int LD = pitch<T, DB>();
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < D) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two products every kernel is made of, on one warp's 16 rows, with
// results in the mma accumulator layout: lane = 4*g + t holds, of each
// 8-column tile j, c[j][0..1] = row g, cols 8j+2t, 8j+2t+1 and c[j][2..3]
// = row g+8, the same cols.
//
// rowdot: c[16 x 8NT] = A[16 x D] . B[8NT x D]^T (A, B in shared memory,
// rows at pitch<T, DB>()).  bf16: mma.sync over k-steps of 16 dims, A by
// ldmatrix, B's rows (n) with k contiguous by ldmatrix, two n-tiles a
// load.  fp32: CUDA cores.
template <typename T, int DB, int NT>
__device__ __forceinline__ void rowdot(const T* A, const T* Bm,
                                       float (&c)[NT][4], int D) {
  constexpr int LD = pitch<T, DB>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(NT % 2 == 0, "n-tiles come in pairs");
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < DB; k0 += 16) {
      if (k0 >= D) break;
      uint32_t a[4];
      ldsm_x4(a, A + (r + (mi & 1) * 8) * LD + k0 + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, Bm + (j * 8 + r + (mi >> 1) * 8) * LD + k0 + (mi & 1) * 8);
        mma_bf16(c[j], a, b[0], b[1]);
        mma_bf16(c[j + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float alo = A[g * LD + d];
      const float ahi = A[(g + 8) * LD + d];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = Bm[(j * 8 + 2 * t) * LD + d];
        const float b1 = Bm[(j * 8 + 2 * t + 1) * LD + d];
        c[j][0] = fmaf(alo, b0, c[j][0]);
        c[j][1] = fmaf(alo, b1, c[j][1]);
        c[j][2] = fmaf(ahi, b0, c[j][2]);
        c[j][3] = fmaf(ahi, b1, c[j][3]);
      }
    }
  }
}

// accum: o[16 x D] += P[16 x 8NT] . B[8NT x D], P in the accumulator
// layout, B in shared memory with rows of D.  bf16: P rounded to bf16 and
// packed into the A fragments of k-steps of 16 (two n-tiles each), B by
// ldmatrix.trans.  fp32: CUDA cores, P's elements passed by shuffles.
template <typename T, int DB, int NT>
__device__ __forceinline__ void accum(const float (&p)[NT][4], const T* Bm,
                                      float (&o)[DB / 8][4], int D) {
  constexpr int LD = pitch<T, DB>();
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, bf16>::value) {
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DB / 8; dt += 2) {
        if (dt * 8 >= D) break;
        uint32_t b[4];
        ldsm_x4_t(b, Bm + (kk * 16 + r + (mi & 1) * 8) * LD + dt * 8 +
                         (mi >> 1) * 8);
        mma_bf16(o[dt], a, b[0], b[1]);
        mma_bf16(o[dt + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // P[row][8j + c] lives in lane 4g + c/2 of this quad
        const int src = (lane & ~3) | (c >> 1);
        const float plo = __shfl_sync(kFull, p[j][c & 1], src);
        const float phi = __shfl_sync(kFull, p[j][2 + (c & 1)], src);
        const T* br = Bm + (j * 8 + c) * LD + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DB / 8; ++dt) {
          if (dt * 8 >= D) break;
          const float b0 = br[dt * 8];
          const float b1 = br[dt * 8 + 1];
          o[dt][0] = fmaf(plo, b0, o[dt][0]);
          o[dt][1] = fmaf(plo, b1, o[dt][1]);
          o[dt][2] = fmaf(phi, b0, o[dt][2]);
          o[dt][3] = fmaf(phi, b1, o[dt][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Write a warp's 16 x D accumulator o * mul to rows row0.. of a strided
// [S, D] slice of element type OT.
template <typename OT, int DB>
__device__ __forceinline__ void store_typed(OT* base, int64_t stride,
                                            const float (&o)[DB / 8][4],
                                            float mul_lo, float mul_hi,
                                            int D) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  OT* lo = base + g * stride + 2 * t;
  OT* hi = base + (g + 8) * stride + 2 * t;
#pragma unroll
  for (int dt = 0; dt < DB / 8; ++dt) {
    if (dt * 8 >= D) break;
    store2(lo + dt * 8, o[dt][0] * mul_lo, o[dt][1] * mul_lo);
    store2(hi + dt * 8, o[dt][2] * mul_hi, o[dt][3] * mul_hi);
  }
}

// The output's element type: T, or fp16 for a bf16 kernel with out_f16.
// `offset` is the element offset of the warp's first row.
template <typename T, int DB>
__device__ __forceinline__ void store_rows(const Params& p, void* out,
                                           int64_t offset,
                                           const float (&o)[DB / 8][4],
                                           float mul) {
  if constexpr (std::is_same<T, float>::value) {
    store_typed<float, DB>(static_cast<float*>(out) + offset, p.o_ss, o, mul,
                           mul, p.D);
  } else if (p.out_f16) {
    store_typed<__half, DB>(static_cast<__half*>(out) + offset, p.o_ss, o,
                            mul, mul, p.D);
  } else {
    store_typed<bf16, DB>(static_cast<bf16*>(out) + offset, p.o_ss, o, mul,
                          mul, p.D);
  }
}

// Scale (and causally mask) a score tile whose rows start at q_pos row0
// and whose columns start at key col0 (or, transposed, rows are keys and
// columns queries: K3).
template <int NT, bool kRowsAreKeys>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], float scale,
                                           bool causal, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + (e >= 2 ? 8 : 0);
      const int c = col0 + j * 8 + 2 * t + (e & 1);
      const bool masked = kRowsAreKeys ? c < r : r < c;
      s[j][e] = causal && masked ? kNegInf : s[j][e] * scale;
    }
}

template <int DB>
__device__ __forceinline__ void zero(float (&o)[DB / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < DB / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------
template <typename T, int DB>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = pitch<T, DB>();
  constexpr int TK = tile_k<DB>();
  constexpr int NT = TK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;
  T* sV = sK + TK * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * kRows;
  const int row0 = q0 + warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_rows<T, DB>(sQ, q + q0 * p.q_ss, p.q_ss, kRows, p.D);

  float o[DB / 8][4];
  zero<DB>(o);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles = p.causal ? (q0 + kRows + TK - 1) / TK : p.S / TK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();  // the previous tile is consumed
    load_rows<T, DB>(sK, k + k0 * p.k_ss, p.k_ss, TK, p.D);
    load_rows<T, DB>(sV, v + k0 * p.v_ss, p.v_ss, TK, p.D);
    __syncthreads();
    if (p.causal && k0 > row0 + 15) continue;  // masked for all 16 rows

    float s[NT][4];
    rowdot<T, DB, NT>(sQ + warp * 16 * LD, sK, s, p.D);
    scale_mask<NT, false>(s, p.scale, p.causal, row0, k0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int dt = 0; dt < DB / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
    accum<T, DB, NT>(s, sV, o, p.D);
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  // acc / l as the TPU kernel divides (not a multiply by 1/l)
#pragma unroll
  for (int dt = 0; dt < DB / 8; ++dt) {
    o[dt][0] /= l0;
    o[dt][1] /= l0;
    o[dt][2] /= l1;
    o[dt][3] /= l1;
  }
  store_rows<T, DB>(p, p.out, b * p.o_sb + h * p.o_sh + row0 * p.o_ss, o,
                    1.f);
  if (t == 0) {
    float* lse = p.lse_out + (static_cast<int64_t>(b) * p.H + h) * p.S;
    lse[row0 + g] = m[0] + logf(l0);
    lse[row0 + g + 8] = m[1] + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------
template <typename T, int DB>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = pitch<T, DB>();
  constexpr int TK = tile_k<DB>();
  constexpr int NT = TK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kRows * LD;  // dO rows
  T* sK = sO + kRows * LD;
  T* sV = sK + TK * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q0 = qi * kRows;
  const int row0 = q0 + warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bh = (static_cast<int64_t>(b) * p.H + h) * p.S;
  const float lse[2] = {p.lse[bh + row0 + g], p.lse[bh + row0 + g + 8]};
  const float dlt[2] = {p.delta[bh + row0 + g], p.delta[bh + row0 + g + 8]};
  load_rows<T, DB>(sQ, q + q0 * p.q_ss, p.q_ss, kRows, p.D);
  load_rows<T, DB>(sO, dout + q0 * p.do_ss, p.do_ss, kRows, p.D);

  float dq[DB / 8][4];
  zero<DB>(dq);

  const int n_tiles = p.causal ? (q0 + kRows + TK - 1) / TK : p.S / TK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();
    load_rows<T, DB>(sK, k + k0 * p.k_ss, p.k_ss, TK, p.D);
    load_rows<T, DB>(sV, v + k0 * p.v_ss, p.v_ss, TK, p.D);
    __syncthreads();
    if (p.causal && k0 > row0 + 15) continue;

    float s[NT][4], dp[NT][4];
    rowdot<T, DB, NT>(sQ + warp * 16 * LD, sK, s, p.D);
    scale_mask<NT, false>(s, p.scale, p.causal, row0, k0);
    rowdot<T, DB, NT>(sO + warp * 16 * LD, sV, dp, p.D);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[j][e] - lse[e >> 1]);
        dp[j][e] = pr * (dp[j][e] - dlt[e >> 1]);  // dS
      }
    accum<T, DB, NT>(dp, sK, dq, p.D);
  }
  store_rows<T, DB>(p, p.out, b * p.o_sb + h * p.o_sh + row0 * p.o_ss, dq,
                    p.scale);
}

// ---------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------
// kPart: 0 computes dK and dV, 1 dV only, 2 dK only.
template <typename T, int DB, int kPart>
__device__ __forceinline__ void dkv_body(const Params& p,
                                         unsigned char* smem) {
  constexpr int LD = pitch<T, DB>();
  constexpr int TQ = tile_q<DB>();
  constexpr int NT = TQ / 8;
  constexpr bool kDv = kPart != 2, kDk = kPart != 1;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;
  T* sO = sQ + TQ * LD;  // dO rows
  float* sL = reinterpret_cast<float*>(sO + TQ * LD);
  float* sD = sL + TQ;

  const int ki = blockIdx.x;  // the first key tiles see the most queries
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5;
  const int kv0 = ki * kRows;
  const int key0 = kv0 + warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bh = (static_cast<int64_t>(b) * p.H + h) * p.S;
  load_rows<T, DB>(sK, k + kv0 * p.k_ss, p.k_ss, kRows, p.D);
  if (kDk) load_rows<T, DB>(sV, v + kv0 * p.v_ss, p.v_ss, kRows, p.D);

  float dk[kDk ? DB / 8 : 1][4], dv[kDv ? DB / 8 : 1][4];
#pragma unroll
  for (int dt = 0; dt < (kDk ? DB / 8 : 1); ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = 0.f;
#pragma unroll
  for (int dt = 0; dt < (kDv ? DB / 8 : 1); ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dt][e] = 0.f;

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int first = p.causal ? kv0 / TQ : 0;
  for (int qt = first; qt < p.S / TQ; ++qt) {
    const int qs = qt * TQ;
    __syncthreads();
    load_rows<T, DB>(sQ, q + qs * p.q_ss, p.q_ss, TQ, p.D);
    load_rows<T, DB>(sO, dout + qs * p.do_ss, p.do_ss, TQ, p.D);
    for (int i = threadIdx.x; i < TQ; i += kThreads) {
      sL[i] = p.lse[bh + qs + i];
      sD[i] = p.delta[bh + qs + i];
    }
    __syncthreads();
    if (p.causal && qs + TQ - 1 < key0) continue;  // masked for all 16 keys

    float s[NT][4];
    rowdot<T, DB, NT>(sK + warp * 16 * LD, sQ, s, p.D);  // S^T: keys x queries
    scale_mask<NT, true>(s, p.scale, p.causal, key0, qs);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = expf(s[j][e] - sL[j * 8 + 2 * t + (e & 1)]);  // P^T
    if constexpr (kDv) accum<T, DB, NT>(s, sO, dv, p.D);
    if constexpr (kDk) {
      float dp[NT][4];
      rowdot<T, DB, NT>(sV + warp * 16 * LD, sO, dp, p.D);  // dP^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - sD[j * 8 + 2 * t + (e & 1)]);
      accum<T, DB, NT>(dp, sQ, dk, p.D);
    }
  }
  const int64_t off = b * p.o_sb + h * p.o_sh + key0 * p.o_ss;
  if constexpr (kDk) store_rows<T, DB>(p, p.out, off, dk, p.scale);
  if constexpr (kDv) store_rows<T, DB>(p, p.out2, off, dv, 1.f);
}

template <typename T, int DB>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (split_dkv<DB>()) {
    if (blockIdx.z == 0)
      dkv_body<T, DB, 1>(p, smem);
    else
      dkv_body<T, DB, 2>(p, smem);
  } else {
    dkv_body<T, DB, 0>(p, smem);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum Kind { kFwd, kDq, kDkv };

template <typename T, int DB>
size_t smem_bytes(Kind kind) {
  constexpr size_t row = pitch<T, DB>() * sizeof(T);
  switch (kind) {
    case kFwd: return (kRows + 2 * tile_k<DB>()) * row;
    case kDq: return (2 * kRows + 2 * tile_k<DB>()) * row;
    default:
      return (2 * kRows + 2 * tile_q<DB>()) * row +
             2 * tile_q<DB>() * sizeof(float);
  }
}

template <typename T, int DB>
cudaError_t launch_typed(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) =
      kind == kFwd ? flash_fwd_kernel<T, DB>
                   : (kind == kDq ? flash_bwd_dq_kernel<T, DB>
                                  : flash_bwd_dkv_kernel<T, DB>);
  const size_t smem = smem_bytes<T, DB>(kind);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.S / kRows, p.B * p.H,
                  kind == kDkv && split_dkv<DB>() ? 2 : 1);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// D's bucket: D rounded up to a multiple of 32; 0 for a D not taken.
int bucket(int D) {
  return (D >= 16 && D <= 256 && D % 16 == 0) ? (D + 31) / 32 * 32 : 0;
}

template <typename T>
cudaError_t launch_bucket(Kind kind, const Params& p, cudaStream_t stream) {
  switch (bucket(p.D)) {
    case 32: return launch_typed<T, 32>(kind, p, stream);
    case 64: return launch_typed<T, 64>(kind, p, stream);
    case 96: return launch_typed<T, 96>(kind, p, stream);
    case 128: return launch_typed<T, 128>(kind, p, stream);
    case 160: return launch_typed<T, 160>(kind, p, stream);
    case 192: return launch_typed<T, 192>(kind, p, stream);
    case 224: return launch_typed<T, 224>(kind, p, stream);
    case 256: return launch_typed<T, 256>(kind, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 fp32; 1 bf16; 2 fp16 outputs from bf16 operands.
int launch(Kind kind, Params p, int D, int dtype, void* stream) {
  if (p.S % 128 != 0 || p.S <= 0 || p.B * p.H < 1 || p.B * p.H > 65535 ||
      dtype < 0 || dtype > 2 || bucket(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.D = D;
  p.out_f16 = dtype == 2;
  cudaError_t err = dtype != 0 ? launch_bucket<bf16>(kind, p, s)
                               : launch_bucket<float>(kind, p, s);
  return static_cast<int>(err);
}

Params base_params(const void* q, long long q_sb, long long q_sh,
                   long long q_ss, const void* k, long long k_sb,
                   long long k_sh, long long k_ss, const void* v,
                   long long v_sb, long long v_sh, long long v_ss, int B,
                   int H, int S, int causal, float scale) {
  Params p{};
  p.q = q; p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k = k; p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v = v; p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.B = B; p.H = H; p.S = S; p.causal = causal; p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

int flash_fwd_launch(const void* q, long long q_sb, long long q_sh,
                     long long q_ss, const void* k, long long k_sb,
                     long long k_sh, long long k_ss, const void* v,
                     long long v_sb, long long v_sh, long long v_ss,
                     void* out, long long o_sb, long long o_sh,
                     long long o_ss, float* lse, int B, int H, int S, int D,
                     int dtype, int causal, float scale, void* stream) {
  Params p = base_params(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_ss, v, v_sb,
                         v_sh, v_ss, B, H, S, causal, scale);
  p.out = out; p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse_out = lse;
  return launch(kFwd, p, D, dtype, stream);
}

int flash_bwd_dq_launch(const void* q, long long q_sb, long long q_sh,
                        long long q_ss, const void* k, long long k_sb,
                        long long k_sh, long long k_ss, const void* v,
                        long long v_sb, long long v_sh, long long v_ss,
                        const void* dout, long long do_sb, long long do_sh,
                        long long do_ss, const float* lse,
                        const float* delta, void* dq, long long o_sb,
                        long long o_sh, long long o_ss, int B, int H, int S,
                        int D, int dtype, int causal, float scale,
                        void* stream) {
  Params p = base_params(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_ss, v, v_sb,
                         v_sh, v_ss, B, H, S, causal, scale);
  p.dout = dout; p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.lse = lse; p.delta = delta;
  p.out = dq; p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  return launch(kDq, p, D, dtype, stream);
}

int flash_bwd_dkv_launch(const void* q, long long q_sb, long long q_sh,
                         long long q_ss, const void* k, long long k_sb,
                         long long k_sh, long long k_ss, const void* v,
                         long long v_sb, long long v_sh, long long v_ss,
                         const void* dout, long long do_sb, long long do_sh,
                         long long do_ss, const float* lse,
                         const float* delta, void* dk, long long o_sb,
                         long long o_sh, long long o_ss, void* dv, int B,
                         int H, int S, int D, int dtype, int causal,
                         float scale, void* stream) {
  Params p = base_params(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_ss, v, v_sb,
                         v_sh, v_ss, B, H, S, causal, scale);
  p.dout = dout; p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.lse = lse; p.delta = delta;
  p.out = dk; p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.out2 = dv;
  return launch(kDkv, p, D, dtype, stream);
}

// Dynamic shared memory a launch asks for: kind 0 = K1, 1 = K2, 2 = K3;
// dtype as launch() takes it; -1 for a head dim that is not taken.
long long flash_attention_smem_bytes(int kind, int D, int dtype) {
  const Kind k = kind == 0 ? kFwd : (kind == 1 ? kDq : kDkv);
  const bool b = dtype != 0;
  switch (bucket(D)) {
#define PTT_CASE(DB) \
  case DB: return b ? smem_bytes<bf16, DB>(k) : smem_bytes<float, DB>(k);
    PTT_CASE(32) PTT_CASE(64) PTT_CASE(96) PTT_CASE(128)
    PTT_CASE(160) PTT_CASE(192) PTT_CASE(224) PTT_CASE(256)
#undef PTT_CASE
    default: return -1;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
