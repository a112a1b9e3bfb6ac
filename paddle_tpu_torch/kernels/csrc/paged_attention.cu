// Paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/paged_attention.py::_decode_kernel, the
// Pallas kernel behind paged_decode_attention: K4 over fp32/bf16 pools
// (quant=False) and K4q over int8 or fp8-e4m3 pools (quant=True).
//
// What it computes: for every row b and head h, the single query
// q[b, h, :] attends over the row's logical sequence, which lives in
// physical blocks bt[b, 0..pos[b]/bs] of the pool [n_blocks, bs, nh, hd];
// keys past pos[b] are masked.  Output is fp32 [B, nh, hd]:
//   out = sum_t softmax_t(scale * q.k_t) v_t   over t <= pos[b].
// K4q: the pools hold 1-byte values with one fp32 scale per (block,
// position), sk and sv [n_blocks, bs], so k_t = sk_t * kq_t and v_t =
// sv_t * vq_t.  A per-token scale commutes with both contractions: the
// logit is (scale * q.kq_t) * sk_t, the running sum l takes the
// unscaled probability p_t, and the accumulator takes p_t * sv_t * vq_t,
// exactly as _decode_kernel scales its logit and probability rows.
//
// What bounds it on this card: memory bandwidth.  A row reads
// (pos + 1) * nh * hd * 2 * itemsize bytes of K/V and does one
// multiply-add per K/V element it reads (one flop per byte in bf16), far
// below the ~295 flops/byte at which an H100 becomes compute bound
// (two flops per byte over 1-byte pools).  To
// reach the bandwidth, enough loads must be in flight: about 3 MB across
// the card (3.35 TB/s times ~1 us of memory latency).
//
// Design:
// * One CTA per (head, row): grid (nh, B), 8 warps.  One CTA streams one
//   head's keys once; nothing is shared between CTAs, so no second pass
//   and no atomics.
// * Each warp owns its own run of keys (kUnroll keys per step, strided by
//   the 8 warps) and its own online-softmax state, so warps never wait on
//   one another inside the loop.  A warp issues the K and V loads of all
//   its kUnroll keys before it uses any of them.
// * Lanes split the head dims: lane l holds dims [l*DPL, (l+1)*DPL) of q
//   (pre-scaled, in registers), of the running acc and of each loaded key,
//   so neighbouring lanes read neighbouring addresses, DPL elements at a
//   time (one vector load when hd is a multiple of DPL: 4-8 bytes a lane
//   over 1-byte pools at hd 128-256).  A butterfly shuffle sums each
//   key's dot product.
// * K4q: every lane reads the key's two scales (one broadcast load each)
//   and widens its int8 or fp8 values to fp32 in registers; the 1-byte
//   tiles are never expanded in device memory.  K4q keeps 8 keys in
//   flight a warp at every head dim, as its loads are half K4's in bf16.
// * Each key's block is read from bt[b, t / bs] by the CTA itself (this
//   replaces the TPU kernel's scalar prefetch).
// * Keys past pos[b] are never loaded and get probability 0; the running
//   max starts at the finite -FLT_MAX (neg_inf in the plain version), so
//   exp(m_prev - m_new) never computes inf - inf.
// * Running max, sum and acc are fp32.  At the end the 8 warps' states are
//   merged through shared memory, and the output is acc / max(l, 1e-30).
// * Idle rows arrive tabled to the trash block 0 at pos 0: they read one
//   finite key and stay finite.
//
// Later PRs: split long rows across CTAs (flash-decoding) when there are
// fewer (row, head) pairs than SMs, and stage blocks with cp.async or
// TMA.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Unsigned type of N bytes, N in {1, 2, 4, 8, 16}.
template <int N> struct Raw;
template <> struct Raw<1> { using type = unsigned char; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// Load DPL consecutive elements at p into fp32 registers; ``vec`` says p
// is aligned to DPL elements and all DPL are in range, else each element
// d0 + i < hd is loaded on its own.
template <typename T, int DPL>
__device__ __forceinline__ void load_dims(const T* p, bool vec, int d0,
                                          int hd, float (&out)[DPL]) {
  if (vec) {
    constexpr int kBytes = sizeof(T) * DPL;
    constexpr int kChunk = kBytes < 16 ? kBytes : 16;
    using R = typename Raw<kChunk>::type;
    R raw[kBytes / kChunk];
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c)
      raw[c] = reinterpret_cast<const R*>(p)[c];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      out[i] = d0 + i < hd ? to_float(p[i]) : 0.f;
  }
}

template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v,
                    const float* __restrict__ scale_k,
                    const float* __restrict__ scale_v,
                    const int32_t* __restrict__ bt,
                    const int32_t* __restrict__ pos, float* __restrict__ out,
                    int nh, int hd, int bs, int max_blocks, float scale) {
  // 1-byte pools are quantized (K4q) and come with per-token scales
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr int kUnroll = kQuant ? 8 : (DPL >= 8 ? 4 : 8);
  __shared__ float m_sh[kWarps];
  __shared__ float l_sh[kWarps];
  __shared__ float acc_sh[kWarps][kMaxHeadDim];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = lane * DPL;
  const bool active = d0 < hd;
  const bool vec = hd % DPL == 0;  // then an active lane has all DPL dims

  const int64_t qo = ((int64_t)b * nh + h) * hd;
  float qr[DPL];
  if (active) load_dims<TQ, DPL>(q + qo + d0, vec, d0, hd, qr);
#pragma unroll
  for (int i = 0; i < DPL; ++i) qr[i] = active ? qr[i] * scale : 0.f;

  int n = pos[b] + 1;  // live keys
  if (n > max_blocks * bs) n = max_blocks * bs;
  const int32_t* row_bt = bt + (int64_t)b * max_blocks;

  float m = -FLT_MAX, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
    float sk[kUnroll], sv[kUnroll];  // K4q's per-token scales
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      sk[u] = sv[u] = 0.f;
      if (t < n) {
        const int64_t blk = row_bt[t / bs];
        const int64_t slot = blk * bs + t % bs;
        if constexpr (kQuant) {
          sk[u] = scale_k[slot];
          sv[u] = scale_v[slot];
        }
        if (active) {
          const int64_t off = (slot * nh + h) * hd + d0;
          load_dims<TKV, DPL>(pool_k + off, vec, d0, hd, kr[u]);
          load_dims<TKV, DPL>(pool_v + off, vec, d0, hd, vr[u]);
        }
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s[u] += qr[i] * kr[u][i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] *= sk[u];
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < n) m_new = fmaxf(m_new, s[u]);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = t0 + u < n ? expf(s[u] - m_new) : 0.f;
      l += p;
      float pv = p;
      if constexpr (kQuant) pv = p * sv[u];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += pv * vr[u][i];
    }
    m = m_new;
  }

  // merge the warps' online-softmax states
  if (lane == 0) {
    m_sh[warp] = m;
    l_sh[warp] = l;
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (d0 + i < hd) acc_sh[warp][d0 + i] = acc[i];
  }
  __syncthreads();
  float m_all = -FLT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_sh[w]);
  float l_all = 0.f, wgt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no key keeps m = -FLT_MAX, l = 0, acc = 0
    wgt[w] = expf(m_sh[w] - m_all);
    l_all += l_sh[w] * wgt[w];
  }
  l_all = fmaxf(l_all, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += acc_sh[w][d] * wgt[w];
    out[qo + d] = o / l_all;
  }
}

// The launch's operands, passed through the dispatch below unchanged.
struct Args {
  const void *q, *pool_k, *pool_v;
  const float *scale_k, *scale_v;
  const int32_t *bt, *pos;
  float* out;
  int B, nh, hd, bs, max_blocks;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int DPL>
cudaError_t launch(const Args& a) {
  paged_decode_kernel<TQ, TKV, DPL>
      <<<dim3(a.nh, a.B), kThreads, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.pool_k),
          static_cast<const TKV*>(a.pool_v), a.scale_k, a.scale_v, a.bt,
          a.pos, a.out, a.nh, a.hd, a.bs, a.max_blocks, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dims(const Args& a) {
  // dims per lane: the smallest power of two with 32 * DPL >= hd
  if (a.hd <= 32) return launch<TQ, TKV, 1>(a);
  if (a.hd <= 64) return launch<TQ, TKV, 2>(a);
  if (a.hd <= 128) return launch<TQ, TKV, 4>(a);
  return launch<TQ, TKV, 8>(a);
}

template <typename TQ>
cudaError_t launch_pool(const Args& a, int kv_type) {
  switch (kv_type) {
    case 0: return launch_dims<TQ, float>(a);
    case 1: return launch_dims<TQ, __nv_bfloat16>(a);
    case 2: return launch_dims<TQ, int8_t>(a);
    case 3: return launch_dims<TQ, __nv_fp8_e4m3>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_bf16: 0 for float32 q, 1 for bfloat16.  kv_type: the pools' type,
// 0 float32, 1 bfloat16 (K4; scale_k and scale_v are ignored), 2 int8,
// 3 fp8 e4m3 (K4q; scale_k and scale_v are fp32 [n_blocks, bs]).  Returns
// the cudaError_t of the launch (0 on success).  The caller guarantees
// every bt value is below n_blocks, 1 <= hd <= 256, bs >= 1, B <= 65535,
// and 16-byte aligned, contiguous operands.
int paged_decode_attention_launch(const void* q, int q_bf16,
                                  const void* pool_k, const void* pool_v,
                                  int kv_type, const void* scale_k,
                                  const void* scale_v, const void* bt,
                                  const void* pos, void* out, int B, int nh,
                                  int hd, int bs, int max_blocks, float scale,
                                  void* stream) {
  const Args a{q,
               pool_k,
               pool_v,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<const int32_t*>(bt),
               static_cast<const int32_t*>(pos),
               static_cast<float*>(out),
               B,
               nh,
               hd,
               bs,
               max_blocks,
               scale,
               static_cast<cudaStream_t>(stream)};
  return q_bf16 ? launch_pool<__nv_bfloat16>(a, kv_type)
                : launch_pool<float>(a, kv_type);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
