// Flash attention forward, dQ and dK/dV for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/kernels/flash_attention.py:
//   K1 _fwd_kernel     (via _flash_fwd)  -> flash_fwd_kernel
//   K2 _bwd_dq_kernel  (via _flash_bwd)  -> flash_bwd_dq_kernel
//   K3 _bwd_dkv_kernel (via _flash_bwd)  -> flash_bwd_dkv_kernel
//
// What they compute, per (batch b, head h), over q/k/v rows of length S
// (S % 64 == 0 here; the wrapper asks S % 128 == 0, the TPU kernel's rule):
//   K1: O = softmax(scale * Q K^T) V with an online softmax over 64-key
//       tiles, and LSE = m + log(max(l, 1e-30)); O = acc / max(l, 1e-30).
//   K2: dQ = scale * sum_k [P o (dO V^T - delta)] K, P = exp(scale*QK^T - LSE)
//   K3: dV = sum_q P^T dO, dK = scale * sum_q dS^T Q, dS = P o (dP - delta)
// Causal masks q_pos < k_pos with the finite -FLT_MAX (NEG_INF of the plain
// version), so exp never sees inf - inf.  As the TPU kernel's _dot_f32 does,
// every product of 16-bit inputs takes both operands in bf16 and sums in
// fp32: P is rounded to bf16 before P.V and P^T.dO, dS before dS.K and
// dS^T.Q.  fp32 inputs run the same loops on CUDA cores in fp32.  dK is
// scaled once at the end instead of per tile (equal up to fp32 rounding).
//
// What bounds them on this card: at training shapes (S = 1024, D = 96)
// the tensor-core work, ~4*S*S*D flops per (b, h) for K1 (halved by
// causal) against ~4*S*D*2 bytes of q/k/v/o: hundreds of flops per byte,
// above the H100's ~295 flops/byte ridge.  So the design keeps Q, K, V
// tiles in shared memory and every score tile in registers, and never
// writes the S x S matrix to device memory.
//
// Design (FA2-style, simple first):
// * 4 warps per CTA, each warp owning 16 rows; a CTA owns 64 query rows
//   (K1, K2) or 64 key rows (K3).  Grid (S/64, B*H).  The TPU kernels'
//   sequential grid dimension becomes the loop inside the CTA; nothing
//   crosses CTAs, so there are no atomics and sums run in a fixed order:
//   the gradients are deterministic.  K2 and K3 keep the TPU's split of
//   dQ from dK/dV for the same reason.
// * Products run on tensor cores with mma.sync.m16n8k16 bf16 -> fp32.
//   Score tiles stay in the accumulator layout, and the accumulator of
//   one product is repacked in registers as the A operand of the next
//   (P of Q K^T becomes the A of P V).  The online softmax runs on those
//   registers, with the row max and sum reduced across each lane quad.
// * Operands are read from shared memory with 32-bit loads; rows are
//   padded by 16 bytes so the 8 rows a load touches sit in distinct banks.
// * Causal CTAs stop at the diagonal, and a warp skips the tiles that are
//   fully masked for its 16 rows.  K1/K2 start the heaviest query tiles
//   first; K3's heaviest key tiles (the first) have the lowest index.
// * q, k, v, dO and the outputs are strided views with a contiguous head
//   dim: (b, h, s) strides are passed in, so the [B, S, 3H] projection
//   output is read without transposes and outputs land [B, S, H, D].
// * Head dims 64, 96 and 128 are instantiated, those of GPT-3 125M, 760M
//   and 1.3B (96 = 6 x 16 along the mma depth, 12 x 8 along its width:
//   nothing assumes a power of two).
//
// Later PRs: cp.async / TMA double buffering, ldmatrix, wgmma with warp
// specialisation (FA3), exp2 with a folded log2(e).
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a CTA owns (q in K1/K2, k in K3)
constexpr int kTileK = 64;          // keys per tile in K1/K2
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
  int B, H, S, causal;
  float scale;
};

// Shared-memory row pitch: D plus one 16-byte vector of padding.
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Copy `rows` rows of D elements (global row stride `stride` elements)
// into shared memory at pitch<T, D>(), in 16-byte vectors.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t stride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = pitch<T, D>();
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi))
          << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b on a 16x8x16 bf16 tile, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two products every kernel is made of, on one warp's 16 rows, with
// results in the mma accumulator layout: lane = 4*g + t holds, of each
// 8-column tile j, c[j][0..1] = row g, cols 8j+2t, 8j+2t+1 and
// c[j][2..3] = row g+8, the same cols.
//
// rowdot: c[16 x 8NT] = A[16 x D] . B[8NT x D]^T (A, B in shared memory).
template <typename T, int D, int NT>
__device__ __forceinline__ void rowdot(const T* A, const T* Bm,
                                       float (&c)[NT][4]) {
  constexpr int LD = pitch<T, D>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int k0 = kc * 16 + 2 * t;
      const uint32_t a0 = ld32(A + g * LD + k0);
      const uint32_t a1 = ld32(A + (g + 8) * LD + k0);
      const uint32_t a2 = ld32(A + g * LD + k0 + 8);
      const uint32_t a3 = ld32(A + (g + 8) * LD + k0 + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* br = Bm + (j * 8 + g) * LD + k0;
        mma16816(c[j], a0, a1, a2, a3, ld32(br), ld32(br + 8));
      }
    }
  } else {
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
// layout (rounded to bf16 on the tensor-core path), B in shared memory.
template <typename T, int D, int NT>
__device__ __forceinline__ void accum(const float (&p)[NT][4], const T* Bm,
                                      float (&o)[D / 8][4]) {
  constexpr int LD = pitch<T, D>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(NT % 2 == 0, "P tiles pair up into 16-deep mma steps");
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      const uint32_t a0 = pack_f32(p[2 * kc][0], p[2 * kc][1]);
      const uint32_t a1 = pack_f32(p[2 * kc][2], p[2 * kc][3]);
      const uint32_t a2 = pack_f32(p[2 * kc + 1][0], p[2 * kc + 1][1]);
      const uint32_t a3 = pack_f32(p[2 * kc + 1][2], p[2 * kc + 1][3]);
      const T* r0 = Bm + (kc * 16 + 2 * t) * LD;
      const T* r8 = r0 + 8 * LD;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int d = dt * 8 + g;
        mma16816(o[dt], a0, a1, a2, a3, pack2(r0 + d, r0 + LD + d),
                 pack2(r8 + d, r8 + LD + d));
      }
    }
  } else {
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
        for (int dt = 0; dt < D / 8; ++dt) {
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

// Write a warp's 16 x D accumulator o * mul to rows row0.. of a strided
// [S, D] slice.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, int64_t stride,
                                           const float (&o)[D / 8][4],
                                           float mul_lo, float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* lo = base + g * stride + 2 * t;
  T* hi = base + (g + 8) * stride + 2 * t;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    store2(lo + dt * 8, o[dt][0] * mul_lo, o[dt][1] * mul_lo);
    store2(hi + dt * 8, o[dt][2] * mul_hi, o[dt][3] * mul_hi);
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

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = pitch<T, D>();
  constexpr int NT = kTileK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;
  T* sV = sK + kTileK * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * kRows;
  const int row0 = q0 + warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_rows<T, D>(sQ, q + q0 * p.q_ss, p.q_ss, kRows);

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles =
      p.causal ? (q0 + kRows + kTileK - 1) / kTileK : p.S / kTileK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // the previous tile is consumed
    load_rows<T, D>(sK, k + k0 * p.k_ss, p.k_ss, kTileK);
    load_rows<T, D>(sV, v + k0 * p.v_ss, p.v_ss, kTileK);
    __syncthreads();
    if (p.causal && k0 > row0 + 15) continue;  // masked for all 16 rows

    float s[NT][4];
    rowdot<T, D, NT>(sQ + warp * 16 * LD, sK, s);
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
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
    accum<T, D, NT>(s, sV, o);
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  // acc / l as the TPU kernel divides (not a multiply by 1/l)
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    o[dt][0] /= l0;
    o[dt][1] /= l0;
    o[dt][2] /= l1;
    o[dt][3] /= l1;
  }
  store_rows<T, D>(out + row0 * p.o_ss, p.o_ss, o, 1.f, 1.f);
  if (t == 0) {
    float* lse = p.lse_out + (static_cast<int64_t>(b) * p.H + h) * p.S;
    lse[row0 + g] = m[0] + logf(l0);
    lse[row0 + g + 8] = m[1] + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = pitch<T, D>();
  constexpr int NT = kTileK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kRows * LD;  // dO rows
  T* sK = sO + kRows * LD;
  T* sV = sK + kTileK * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q0 = qi * kRows;
  const int row0 = q0 + warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bh = (static_cast<int64_t>(b) * p.H + h) * p.S;
  const float lse[2] = {p.lse[bh + row0 + g], p.lse[bh + row0 + g + 8]};
  const float dlt[2] = {p.delta[bh + row0 + g], p.delta[bh + row0 + g + 8]};
  load_rows<T, D>(sQ, q + q0 * p.q_ss, p.q_ss, kRows);
  load_rows<T, D>(sO, dout + q0 * p.do_ss, p.do_ss, kRows);

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;

  const int n_tiles =
      p.causal ? (q0 + kRows + kTileK - 1) / kTileK : p.S / kTileK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();
    load_rows<T, D>(sK, k + k0 * p.k_ss, p.k_ss, kTileK);
    load_rows<T, D>(sV, v + k0 * p.v_ss, p.v_ss, kTileK);
    __syncthreads();
    if (p.causal && k0 > row0 + 15) continue;

    float s[NT][4], dp[NT][4];
    rowdot<T, D, NT>(sQ + warp * 16 * LD, sK, s);
    scale_mask<NT, false>(s, p.scale, p.causal, row0, k0);
    rowdot<T, D, NT>(sO + warp * 16 * LD, sV, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[j][e] - lse[e >> 1]);
        dp[j][e] = pr * (dp[j][e] - dlt[e >> 1]);  // dS
      }
    accum<T, D, NT>(dp, sK, dq);
  }
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  store_rows<T, D>(out + row0 * p.o_ss, p.o_ss, dq, p.scale, p.scale);
}

// ---------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------
template <typename T, int D>
__host__ __device__ constexpr int dkv_tile_q() {
  return D <= 64 ? 64 : 32;  // keeps dK + dV + two score tiles in registers
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = pitch<T, D>();
  constexpr int TQ = dkv_tile_q<T, D>();
  constexpr int NT = TQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
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
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bh = (static_cast<int64_t>(b) * p.H + h) * p.S;
  load_rows<T, D>(sK, k + kv0 * p.k_ss, p.k_ss, kRows);
  load_rows<T, D>(sV, v + kv0 * p.v_ss, p.v_ss, kRows);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int first = p.causal ? kv0 / TQ : 0;
  for (int qt = first; qt < p.S / TQ; ++qt) {
    const int qs = qt * TQ;
    __syncthreads();
    load_rows<T, D>(sQ, q + qs * p.q_ss, p.q_ss, TQ);
    load_rows<T, D>(sO, dout + qs * p.do_ss, p.do_ss, TQ);
    for (int i = threadIdx.x; i < TQ; i += kThreads) {
      sL[i] = p.lse[bh + qs + i];
      sD[i] = p.delta[bh + qs + i];
    }
    __syncthreads();
    if (p.causal && qs + TQ - 1 < key0) continue;  // masked for all 16 keys

    float s[NT][4], dp[NT][4];
    rowdot<T, D, NT>(sK + warp * 16 * LD, sQ, s);  // S^T: keys x queries
    scale_mask<NT, true>(s, p.scale, p.causal, key0, qs);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = expf(s[j][e] - sL[j * 8 + 2 * t + (e & 1)]);  // P^T
    accum<T, D, NT>(s, sO, dv);
    rowdot<T, D, NT>(sV + warp * 16 * LD, sO, dp);  // dP^T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - sD[j * 8 + 2 * t + (e & 1)]);
    accum<T, D, NT>(dp, sQ, dk);
  }
  T* out_k = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  T* out_v = static_cast<T*>(p.out2) + b * p.o_sb + h * p.o_sh;
  store_rows<T, D>(out_k + key0 * p.o_ss, p.o_ss, dk, p.scale, p.scale);
  store_rows<T, D>(out_v + key0 * p.o_ss, p.o_ss, dv, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum Kind { kFwd, kDq, kDkv };

template <typename T, int D>
size_t smem_bytes(Kind kind) {
  constexpr int LD = pitch<T, D>();
  switch (kind) {
    case kFwd:
      return static_cast<size_t>(kRows + 2 * kTileK) * LD * sizeof(T);
    case kDq:
      return static_cast<size_t>(2 * kRows + 2 * kTileK) * LD * sizeof(T);
    default:
      return static_cast<size_t>(2 * kRows + 2 * dkv_tile_q<T, D>()) * LD *
                 sizeof(T) +
             2 * dkv_tile_q<T, D>() * sizeof(float);
  }
}

template <typename T, int D>
cudaError_t launch_typed(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) =
      kind == kFwd ? flash_fwd_kernel<T, D>
                   : (kind == kDq ? flash_bwd_dq_kernel<T, D>
                                  : flash_bwd_dkv_kernel<T, D>);
  const size_t smem = smem_bytes<T, D>(kind);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.S / kRows, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(Kind kind, int D, const Params& p,
                       cudaStream_t stream) {
  switch (D) {
    case 64: return launch_typed<T, 64>(kind, p, stream);
    case 96: return launch_typed<T, 96>(kind, p, stream);
    case 128: return launch_typed<T, 128>(kind, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int launch(Kind kind, const Params& p, int D, int is_bf16, void* stream) {
  if (p.S % kRows != 0 || p.S <= 0 || p.B * p.H < 1 || p.B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch_dim<bf16>(kind, D, p, s)
                            : launch_dim<float>(kind, D, p, s);
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
                     int is_bf16, int causal, float scale, void* stream) {
  Params p = base_params(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_ss, v, v_sb,
                         v_sh, v_ss, B, H, S, causal, scale);
  p.out = out; p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse_out = lse;
  return launch(kFwd, p, D, is_bf16, stream);
}

int flash_bwd_dq_launch(const void* q, long long q_sb, long long q_sh,
                        long long q_ss, const void* k, long long k_sb,
                        long long k_sh, long long k_ss, const void* v,
                        long long v_sb, long long v_sh, long long v_ss,
                        const void* dout, long long do_sb, long long do_sh,
                        long long do_ss, const float* lse,
                        const float* delta, void* dq, long long o_sb,
                        long long o_sh, long long o_ss, int B, int H, int S,
                        int D, int is_bf16, int causal, float scale,
                        void* stream) {
  Params p = base_params(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_ss, v, v_sb,
                         v_sh, v_ss, B, H, S, causal, scale);
  p.dout = dout; p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.lse = lse; p.delta = delta;
  p.out = dq; p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  return launch(kDq, p, D, is_bf16, stream);
}

int flash_bwd_dkv_launch(const void* q, long long q_sb, long long q_sh,
                         long long q_ss, const void* k, long long k_sb,
                         long long k_sh, long long k_ss, const void* v,
                         long long v_sb, long long v_sh, long long v_ss,
                         const void* dout, long long do_sb, long long do_sh,
                         long long do_ss, const float* lse,
                         const float* delta, void* dk, long long o_sb,
                         long long o_sh, long long o_ss, void* dv, int B,
                         int H, int S, int D, int is_bf16, int causal,
                         float scale, void* stream) {
  Params p = base_params(q, q_sb, q_sh, q_ss, k, k_sb, k_sh, k_ss, v, v_sb,
                         v_sh, v_ss, B, H, S, causal, scale);
  p.dout = dout; p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.lse = lse; p.delta = delta;
  p.out = dk; p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.out2 = dv;
  return launch(kDkv, p, D, is_bf16, stream);
}

// Dynamic shared memory a launch asks for: kind 0 = K1, 1 = K2, 2 = K3;
// -1 for a head dim that is not instantiated.
long long flash_attention_smem_bytes(int kind, int D, int is_bf16) {
  const Kind k = kind == 0 ? kFwd : (kind == 1 ? kDq : kDkv);
  const bool b = is_bf16 != 0;
  switch (D) {
    case 64: return b ? smem_bytes<bf16, 64>(k) : smem_bytes<float, 64>(k);
    case 96: return b ? smem_bytes<bf16, 96>(k) : smem_bytes<float, 96>(k);
    case 128: return b ? smem_bytes<bf16, 128>(k) : smem_bytes<float, 128>(k);
    default: return -1;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
