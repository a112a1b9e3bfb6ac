// Paged decode attention for Hopper (sm_90a), split-K (flash-decoding).
//
// Replaces paddle_tpu/kernels/paged_attention.py::_decode_kernel, the
// Pallas kernel behind paged_decode_attention: K4 over fp32/bf16/fp16
// pools (quant=False) and K4q over int8 or fp8-e4m3 pools (quant=True).
// Queries are fp32, bf16 or fp16; an fp16 query pairs with fp16 or 1-byte
// pools and fp16 pools with an fp16 query (the fp16 model's paths).  As
// the JAX kernel's _dot32 widens both operands to fp32, every element is
// widened on load and nothing is rounded to bf16.
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
// below the ~295 flops/byte at which an H100 becomes compute bound.  To
// reach the bandwidth, enough loads must be in flight: about 3 MB across
// the card (3.35 TB/s times ~1 us of memory latency), no load may wait on
// another, and the arithmetic between loads must stay short.
//
// Design:
// * Split the keys (flash-decoding).  Grid (nh, B, n_split): a CTA owns
//   blocks [split * bps, (split + 1) * bps) of one (row, head), bps
//   ("blocks per split") chosen by the wrapper from the block size alone
//   (about 64 keys a split), so the grid is a function of shapes and
//   never of pos, as a CUDA graph needs.  At the engine's shape (B 8, 16
//   heads, 64 blocks of 16) that is 2048 CTAs, and 256 at B = 1: every SM
//   has work even when one row is left.  A CTA whose split starts past
//   pos[b] exits after reading pos[b].
// * No dependent loads in the loop.  A CTA reads its split's slice of
//   bt[b] into shared memory beside pos[b] (every table entry names a
//   valid block); each key's physical slot is then a shared-memory read.
// * Staged, full-width loads.  The split's keys stream in tiles of 16
//   through a ring of 2-4 shared-memory stages (as many as fit in 32 KB),
//   K and V of a key one [hd] row each, with 16-byte cp.async copies (a
//   half-warp a key at hd 128 in bf16), so the whole split, or the next
//   tiles of a long one, are in flight while a tile is reduced.  K4q
//   stages the tile's sk and sv beside it (4-byte cp.async).  Head dims
//   whose rows are not whole 16-byte vectors (hd 33) take a scalar path:
//   synchronous element loads into the same stages.
// * Short arithmetic.  GK lanes (8, 16 or 32) share a key, each holding
//   DPT contiguous dims of q (pre-scaled, in registers), of the key and
//   of its own accumulator, read from shared memory in 16- or 32-byte
//   vectors; a butterfly of log2(GK) shuffles sums the dot product.  The
//   128 threads hold 128 / GK keys at once, each lane group keeping its
//   own online-softmax state over the keys it sees.  K4q widens its int8
//   or fp8 values to fp32 in registers (never in device memory) and
//   scales logit and probability by sk and sv.
// * Keys past pos[b] are never loaded and get probability 0; the running
//   max starts at the finite -FLT_MAX (neg_inf in the plain version), so
//   exp(m_prev - m_new) never computes inf - inf.
// * Deterministic merge, in the same launch.  The lane groups merge in
//   shared memory and the CTA writes its split's state (m, l, acc[hd]) to
//   fp32 scratch [B, nh, n_split, hd + 2].  The CTA that finishes the
//   last live split of a (row, head), found by an acq_rel atomic count in
//   a zeroed int32 buffer [B * nh] that the wrapper keeps, merges the
//   live splits in split order, 16 at a time with all their loads in
//   flight, into a running max, sum and accumulator (out = acc /
//   max(l, 1e-30)), and sets the count back to 0.  Which CTA merges
//   varies; what it sums, and in which order, does not: the same inputs
//   give the same bits, and the buffer is ready for the next launch (or
//   a graph replay) without a memset.  (A second merge kernel cost as
//   much as this tail, plus a launch.)
// * Idle rows arrive tabled to the trash block 0 at pos 0: they read one
//   finite key and stay finite.
//
// Later PRs: CUDA-graph capture of the decode step (the launch takes
// shapes only and resets its own counts); TMA boxes for a block's slab.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.

#include <cfloat>
#include <cstdint>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;                // keys a stage holds
constexpr int kMaxSplitBlocks = 64;      // bt entries a split may own
constexpr int kMaxSplits = 4096;         // splits a (row, head) may have
constexpr int kStageBudget = 32 * 1024;  // bytes of K/V stages wanted
constexpr int kMergeUnroll = 16;         // split loads in flight a merge

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Unsigned type of N bytes, N in {4, 8, 16}.
template <int N> struct Raw;
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// Read N consecutive elements at shared-memory p (aligned to N elements)
// into fp32 registers, in vector loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void read_dims(const T* p, float (&out)[N]) {
  constexpr int kBytes = sizeof(T) * N;
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using R = typename Raw<kChunk>::type;
  R raw[kBytes / kChunk];
#pragma unroll
  for (int c = 0; c < kBytes / kChunk; ++c)
    raw[c] = reinterpret_cast<const R*>(p)[c];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One instantiation's shape: GK lanes a key, DPT dims a lane (so at most
// kDims = GK * DPT head dims), kKeys keys at once; the shared memory is a
// ring of kStages stages, each kTile rows of K then kTile rows of V at a
// pitch of kDims elements, then the stages' scales (K4q).
template <typename T, int DPT, int GK>
struct Shape {
  static constexpr int kDims = GK * DPT;
  static constexpr int kKeys = kThreads / GK;
  static constexpr int kPasses = kTile / kKeys;  // keys a lane takes a tile
  static constexpr int kRowBytes = kDims * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;
  static constexpr int kFit = kStageBudget / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kScaleBytes = kQuant ? kStages * 2 * kTile * 4 : 0;
  static constexpr int kBytes = kStages * kStageBytes + kScaleBytes;
  // A lane's dims: runs of kVec (one 16-byte vector) kVec * GK apart, so
  // the GK lanes of a key read neighbouring vectors at each step.
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T)) < DPT
                                  ? 16 / static_cast<int>(sizeof(T))
                                  : DPT;
  static __device__ __forceinline__ int dim(int lane, int i) {
    return (i / kVec * GK + lane) * kVec + i % kVec;
  }
  // Read a lane's DPT dims of one staged row into fp32 registers.
  static __device__ __forceinline__ void read(const T* row, int lane,
                                              float (&out)[DPT]) {
#pragma unroll
    for (int j = 0; j < DPT / kVec; ++j) {
      float part[kVec];
      read_dims<T, kVec>(row + dim(lane, j * kVec), part);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[j * kVec + i] = part[i];
    }
  }
  // the lane groups' (m, l, acc) reuse the stages once the loop is done
  static_assert(kKeys * (kDims + 2) * 4 <= kStages * kStageBytes,
                "merge scratch fits in the stages");
};

template <typename TQ, typename TKV, int DPT, int GK>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v,
                    const float* __restrict__ scale_k,
                    const float* __restrict__ scale_v,
                    const int32_t* __restrict__ bt,
                    const int32_t* __restrict__ pos, float* part,
                    int* __restrict__ count, float* __restrict__ out, int nh,
                    int hd, int bs, int max_blocks, int bps, float scale) {
  using S = Shape<TKV, DPT, GK>;
  constexpr bool kQuant = S::kQuant;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t sbt[kMaxSplitBlocks];
  __shared__ int last;
  TKV* stages = reinterpret_cast<TKV*>(smem);
  float* scales = reinterpret_cast<float*>(smem + kStages * S::kStageBytes);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int64_t bh = static_cast<int64_t>(b) * nh + h;

  // q, pos[b] and the split's table slice are read together
  const int grp = threadIdx.x / GK;  // the lane group: its keys
  const int gl = threadIdx.x % GK;   // the lane within it: its dims
  const int64_t qo = bh * hd;
  float qr[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = S::dim(gl, i);
    qr[i] = d < hd ? to_float(q[qo + d]) : 0.f;
  }
  const int blk0 = split * bps;
  const int k0 = blk0 * bs;
  const int32_t* row_bt = bt + static_cast<int64_t>(b) * max_blocks;
  const int n_blk = min(bps, max_blocks - blk0);
  for (int i = threadIdx.x; i < n_blk; i += kThreads)
    sbt[i] = row_bt[blk0 + i];
  int n = pos[b] + 1;  // live keys
  if (n > max_blocks * bs) n = max_blocks * bs;
  if (k0 >= n) return;  // not a live split: the merge skips it
  const int k1 = min(n, k0 + bps * bs);
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;
  const int keys = bps * bs;
  const int live_splits = min(n_split, (n + keys - 1) / keys);
  __syncthreads();

  // whole 16-byte vectors a row (and so 16-byte aligned rows)
  const int row_bytes = hd * static_cast<int>(sizeof(TKV));
  const bool vec = row_bytes % 16 == 0;
  const int64_t head_off = static_cast<int64_t>(h) * hd;
  // vector copies: thread i moves chunk i % per_row of key i / per_row,
  // K and V alike, copy_keys keys at a time (divisions once a CTA)
  const int per_row = vec ? row_bytes / 16 : 1;
  const int copy_keys = kThreads / per_row;
  const int my_chunk = threadIdx.x % per_row;
  const int my_row = threadIdx.x / per_row;

  // Stage tile `tile` into ring slot `slot`; keys past k1 are not loaded.
  auto issue = [&](int tile, int slot) {
    TKV* k_rows = stages + slot * (2 * kTile * S::kDims);
    TKV* v_rows = k_rows + kTile * S::kDims;
    const int t0 = tile * kTile;  // first key of the tile, from k0
    const int live = min(kTile, k1 - k0 - t0);
    if (vec) {
      for (int r = my_row; r < live; r += copy_keys) {
        const int t = t0 + r;
        const int64_t off =
            (static_cast<int64_t>(sbt[t / bs]) * bs + t % bs) * nh * hd +
            head_off;
        const int byte = 16 * my_chunk;
        cp_async16(
            reinterpret_cast<unsigned char*>(k_rows + r * S::kDims) + byte,
            reinterpret_cast<const unsigned char*>(pool_k + off) + byte);
        cp_async16(
            reinterpret_cast<unsigned char*>(v_rows + r * S::kDims) + byte,
            reinterpret_cast<const unsigned char*>(pool_v + off) + byte);
      }
    } else {
      for (int i = threadIdx.x; i < live * hd; i += kThreads) {
        const int r = i / hd, d = i % hd;
        const int t = t0 + r;
        const int64_t off =
            (static_cast<int64_t>(sbt[t / bs]) * bs + t % bs) * nh * hd +
            head_off;
        k_rows[r * S::kDims + d] = pool_k[off + d];
        v_rows[r * S::kDims + d] = pool_v[off + d];
      }
    }
    if constexpr (kQuant) {
      float* sc = scales + slot * 2 * kTile;
      if (threadIdx.x < live) {
        const int t = t0 + threadIdx.x;
        const int64_t slot_g =
            static_cast<int64_t>(sbt[t / bs]) * bs + t % bs;
        cp_async4(sc + threadIdx.x, scale_k + slot_g);
        cp_async4(sc + kTile + threadIdx.x, scale_v + slot_g);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < DPT; ++i) qr[i] *= scale;

  float m = -FLT_MAX, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int ahead = tile + kStages - 1;
    if (ahead < n_tiles) issue(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile's group has landed
    __syncthreads();

    const int slot = tile % kStages;
    const TKV* k_rows = stages + slot * (2 * kTile * S::kDims);
    const TKV* v_rows = k_rows + kTile * S::kDims;
    const float* sc = scales + slot * 2 * kTile;
    const int live = k1 - k0 - tile * kTile;  // keys of this tile: min(16, .)
    float s[S::kPasses], vr[S::kPasses][DPT];
#pragma unroll
    for (int u = 0; u < S::kPasses; ++u) {
      const int r = u * S::kKeys + grp;
      float kr[DPT];
      S::read(k_rows + r * S::kDims, gl, kr);
      S::read(v_rows + r * S::kDims, gl, vr[u]);
      s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i)  // dims past hd: q is 0, k not read
        s[u] += S::dim(gl, i) < hd ? qr[i] * kr[i] : 0.f;
    }
#pragma unroll
    for (int o = GK / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < S::kPasses; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < S::kPasses; ++u) {
      const int r = u * S::kKeys + grp;
      if constexpr (kQuant) s[u] *= sc[r];
      if (r < live) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < S::kPasses; ++u) {
      const int r = u * S::kKeys + grp;
      if (r < live) {
        const float p = expf(s[u] - m_new);
        l += p;
        const float pv = kQuant ? p * sc[kTile + r] : p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += pv * vr[u][i];
      }
    }
    m = m_new;
    __syncthreads();  // the slot is read; the next issue may refill it
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the lane groups' states through the (now idle) stages; a group
  // that saw no key keeps m = -FLT_MAX, l = 0, acc = 0
  float* gm = reinterpret_cast<float*>(smem);
  float* gl_sum = gm + S::kKeys;
  float* gacc = gl_sum + S::kKeys;
  if (gl == 0) {
    gm[grp] = m;
    gl_sum[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) gacc[grp * S::kDims + S::dim(gl, i)] = acc[i];
  __syncthreads();
  float m_all = -FLT_MAX;
#pragma unroll
  for (int g = 0; g < S::kKeys; ++g) m_all = fmaxf(m_all, gm[g]);
  float l_all = 0.f;
#pragma unroll
  for (int g = 0; g < S::kKeys; ++g) l_all += gl_sum[g] * expf(gm[g] - m_all);
  const int stride = hd + 2;
  float* mine = part + (bh * n_split + split) * stride;
  if (threadIdx.x == 0) {
    mine[0] = m_all;
    mine[1] = l_all;
  }
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < S::kKeys; ++g)
      o += gacc[g * S::kDims + d] * expf(gm[g] - m_all);
    mine[2 + d] = o;
  }

  // the CTA that completes the (row, head) merges its live splits
  // (thread 0's acq_rel count, after the barrier, publishes the CTA's
  // state and, in the last CTA, sees every other split's)
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(count + bh)
                 : "memory");
    last = prev == live_splits - 1;
  }
  __syncthreads();
  if (!last) return;
  // The merge reads the splits' states from L2 (__ldcg: other SMs wrote
  // them), kMergeUnroll splits at a time with every load of a chunk in
  // flight at once (one round trip a chunk), and folds chunk after chunk
  // into a running max, sum and accumulator: the same order, so the same
  // bits, in every thread and on every launch.
  const float* p = part + bh * n_split * stride;
  constexpr int kOut = 256 / kThreads;  // output dims a thread, hd <= 256
  float big = -FLT_MAX, total = 0.f, o[kOut] = {};
  for (int c0 = 0; c0 < live_splits; c0 += kMergeUnroll) {
    const int n_c = min(kMergeUnroll, live_splits - c0);
    float ms[kMergeUnroll], ls[kMergeUnroll], a[kOut][kMergeUnroll];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const float* ps = p + (c0 + u) * stride;
      const bool in = u < n_c;
      ms[u] = in ? __ldcg(ps) : -FLT_MAX;
      ls[u] = in ? __ldcg(ps + 1) : 0.f;
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int d = threadIdx.x + k * kThreads;
        a[k][u] = in && d < hd ? __ldcg(ps + 2 + d) : 0.f;
      }
    }
    float nb = big;
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) nb = fmaxf(nb, ms[u]);
    const float keep = expf(big - nb);  // 0 for the first chunk
    total *= keep;
#pragma unroll
    for (int k = 0; k < kOut; ++k) o[k] *= keep;
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const float w = expf(ms[u] - nb);  // 0 past n_c: ls and a are 0
      total += ls[u] * w;
#pragma unroll
      for (int k = 0; k < kOut; ++k) o[k] += a[k][u] * w;
    }
    big = nb;
  }
  total = fmaxf(total, 1e-30f);
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int d = threadIdx.x + k * kThreads;
    if (d < hd) out[qo + d] = o[k] / total;
  }
  if (threadIdx.x == 0) count[bh] = 0;  // ready for the next launch
}

// The launch's operands, passed through the dispatch below unchanged.
struct Args {
  const void *q, *pool_k, *pool_v;
  const float *scale_k, *scale_v;
  const int32_t *bt, *pos;
  float *part, *out;
  int* count;
  int B, nh, hd, bs, max_blocks, bps;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int DPT, int GK>
cudaError_t launch(const Args& a) {
  auto kernel = paged_decode_kernel<TQ, TKV, DPT, GK>;
  constexpr int kSmem = Shape<TKV, DPT, GK>::kBytes;
  if (kSmem > 48 * 1024) {
    static bool opted = false;  // once per instantiation and process
    if (!opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return err;
      opted = true;
    }
  }
  const int n_split = (a.max_blocks + a.bps - 1) / a.bps;
  kernel<<<dim3(a.nh, a.B, n_split), kThreads, kSmem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.pool_k),
      static_cast<const TKV*>(a.pool_v), a.scale_k, a.scale_v, a.bt, a.pos,
      a.part, a.count, a.out, a.nh, a.hd, a.bs, a.max_blocks, a.bps,
      a.scale);
  return cudaGetLastError();
}

// GK lanes a key and DPT dims a lane: 8 lanes of 16- or 32-byte reads
// up to hd 128 (bf16, 1-byte) or 64 (fp32), more lanes above.
template <typename TQ, typename TKV>
cudaError_t launch_dims(const Args& a) {
  constexpr int kWide = sizeof(TKV) == 4 ? 8 : 16;  // dims a lane at most
  if (a.hd <= 32) return launch<TQ, TKV, 4, 8>(a);
  if (a.hd <= 64) return launch<TQ, TKV, 8, 8>(a);
  if (a.hd <= 8 * kWide) return launch<TQ, TKV, kWide, 8>(a);
  if (a.hd <= 16 * kWide) return launch<TQ, TKV, kWide, 16>(a);
  return launch<TQ, TKV, kWide, 32>(a);
}

// fp16 pools are built with fp16 queries only, and fp16 queries with fp16
// or 1-byte pools: the pairs an fp16 model serves with.
template <typename TQ>
cudaError_t launch_pool(const Args& a, int kv_type) {
  constexpr bool kHalf = std::is_same<TQ, __half>::value;
  switch (kv_type) {
    case 0:
      if constexpr (!kHalf) return launch_dims<TQ, float>(a);
      break;
    case 1:
      if constexpr (!kHalf) return launch_dims<TQ, __nv_bfloat16>(a);
      break;
    case 2: return launch_dims<TQ, int8_t>(a);
    case 3: return launch_dims<TQ, __nv_fp8_e4m3>(a);
    case 4:
      if constexpr (kHalf) return launch_dims<TQ, __half>(a);
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q_type: 0 for float32 q, 1 for bfloat16, 2 for float16.  kv_type: the
// pools' type, 0 float32, 1 bfloat16, 4 float16 (K4; scale_k and scale_v
// are ignored), 2 int8, 3 fp8 e4m3 (K4q; scale_k and scale_v are fp32
// [n_blocks, bs]).  part:
// fp32 scratch [B, nh, ceil(max_blocks / bps), hd + 2]; count: int32
// [B * nh], all zero before the launch and left all zero by it.  Returns
// the cudaError_t of the launch (0 on success).  The caller guarantees
// every bt value is below n_blocks, 1 <= hd <= 256, bs >= 1, 1 <= bps <=
// 64, ceil(max_blocks / bps) <= 4096, B <= 65535, and 16-byte aligned,
// contiguous operands.
int paged_decode_attention_launch(const void* q, int q_type,
                                  const void* pool_k, const void* pool_v,
                                  int kv_type, const void* scale_k,
                                  const void* scale_v, const void* bt,
                                  const void* pos, void* part, void* count,
                                  void* out, int B, int nh, int hd, int bs,
                                  int max_blocks, int bps, float scale,
                                  void* stream) {
  if (hd < 1 || hd > 256 || bs < 1 || bps < 1 || bps > kMaxSplitBlocks ||
      B < 1 || B > 65535 || max_blocks < 1 ||
      (max_blocks + bps - 1) / bps > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               pool_k,
               pool_v,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<const int32_t*>(bt),
               static_cast<const int32_t*>(pos),
               static_cast<float*>(part),
               static_cast<float*>(out),
               static_cast<int*>(count),
               B,
               nh,
               hd,
               bs,
               max_blocks,
               bps,
               scale,
               static_cast<cudaStream_t>(stream)};
  switch (q_type) {
    case 0: return launch_pool<float>(a, kv_type);
    case 1: return launch_pool<__nv_bfloat16>(a, kv_type);
    case 2: return launch_pool<__half>(a, kv_type);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
