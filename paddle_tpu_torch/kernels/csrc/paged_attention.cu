// Paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/paged_attention.py::_decode_kernel (the
// Pallas kernel behind paged_decode_attention, unquantized pools).
//
// What it computes: for every row b and head h, the single query
// q[b, h, :] attends over the row's logical sequence, which lives in
// physical blocks bt[b, 0..pos[b]/bs] of the pool [n_blocks, bs, nh, hd];
// keys past pos[b] are masked.  Output is fp32 [B, nh, hd]:
//   out = sum_t softmax_t(scale * q.k_t) v_t   over t <= pos[b].
//
// What bounds it on this card: memory bandwidth.  A row reads
// (pos + 1) * nh * hd * 2 * itemsize bytes of K/V and does one
// multiply-add per K/V element it reads (one flop per byte in bf16), far
// below the ~295 flops/byte at which an H100 becomes compute bound.  To
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
//   time (one vector load when hd is a multiple of DPL).  A butterfly
//   shuffle sums each key's dot product.
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
// fewer (row, head) pairs than SMs, stage blocks with cp.async or TMA,
// and add fp8 pools.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Unsigned type of N bytes, N in {2, 4, 8, 16}.
template <int N> struct Raw;
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
                    const int32_t* __restrict__ bt,
                    const int32_t* __restrict__ pos, float* __restrict__ out,
                    int nh, int hd, int bs, int max_blocks, float scale) {
  constexpr int kUnroll = DPL >= 8 ? 4 : 8;
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
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      if (t < n && active) {
        const int64_t blk = row_bt[t / bs];
        const int64_t off = ((blk * bs + t % bs) * nh + h) * hd + d0;
        load_dims<TKV, DPL>(pool_k + off, vec, d0, hd, kr[u]);
        load_dims<TKV, DPL>(pool_v + off, vec, d0, hd, vr[u]);
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
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += p * vr[u][i];
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

template <typename TQ, typename TKV, int DPL>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* bt, const void* pos, void* out, int B, int nh,
                   int hd, int bs, int max_blocks, float scale,
                   cudaStream_t stream) {
  paged_decode_kernel<TQ, TKV, DPL><<<dim3(nh, B), kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(pos), static_cast<float*>(out), nh, hd, bs,
      max_blocks, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dims(const void* q, const void* pool_k, const void* pool_v,
                        const void* bt, const void* pos, void* out, int B,
                        int nh, int hd, int bs, int max_blocks, float scale,
                        cudaStream_t stream) {
  // dims per lane: the smallest power of two with 32 * DPL >= hd
  if (hd <= 32)
    return launch<TQ, TKV, 1>(q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs,
                              max_blocks, scale, stream);
  if (hd <= 64)
    return launch<TQ, TKV, 2>(q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs,
                              max_blocks, scale, stream);
  if (hd <= 128)
    return launch<TQ, TKV, 4>(q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs,
                              max_blocks, scale, stream);
  return launch<TQ, TKV, 8>(q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs,
                            max_blocks, scale, stream);
}

}  // namespace

extern "C" {

// q_bf16 / kv_bf16: 0 for float32 operands, 1 for bfloat16.  Returns the
// cudaError_t of the launch (0 on success).  The caller guarantees every
// bt value is below n_blocks, 1 <= hd <= 256, bs >= 1, B <= 65535, and
// 16-byte aligned, contiguous operands.
int paged_decode_attention_launch(const void* q, int q_bf16,
                                  const void* pool_k, const void* pool_v,
                                  int kv_bf16, const void* bt, const void* pos,
                                  void* out, int B, int nh, int hd, int bs,
                                  int max_blocks, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_dims<__nv_bfloat16, __nv_bfloat16>(
        q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs, max_blocks, scale, s);
  if (q_bf16)
    return launch_dims<__nv_bfloat16, float>(
        q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs, max_blocks, scale, s);
  if (kv_bf16)
    return launch_dims<float, __nv_bfloat16>(
        q, pool_k, pool_v, bt, pos, out, B, nh, hd, bs, max_blocks, scale, s);
  return launch_dims<float, float>(q, pool_k, pool_v, bt, pos, out, B, nh, hd,
                                   bs, max_blocks, scale, s);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
