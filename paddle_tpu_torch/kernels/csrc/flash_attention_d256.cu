// Flash attention forward (K1), dQ (K2) and dK/dV (K3) at head dim 256,
// bf16 and fp16, for Hopper (sm_90a).
//
// Replaces, at D 256, the Pallas kernels of paddle_tpu/kernels/
// flash_attention.py:
//   K1 _fwd_kernel     (via _flash_fwd)  -> hopper::flash_fwd_d256_kernel
//   K2 _bwd_dq_kernel  (via _flash_bwd)  -> hopper::flash_bwd_dq_d256_kernel
//   K3 _bwd_dkv_kernel (via _flash_bwd)  -> hopper::flash_bwd_dkv_d256_kernel
// Heads of 256 are what the paddle-style scaled_dot_product_attention
// sends to the kernels from nn.MultiHeadAttention(4096, 16) and the
// encoders built on it.  fp32 at every D is flash_attention_mma.cu's;
// bf16/fp16 at D 64/96/128 are flash_attention.cu's.  The wrapper
// (kernels/flash_attention.py, _library) picks the library per kernel.
//
// The arithmetic is flash_attention.cu's, unchanged: every product takes
// bf16 operands and sums in fp32; P is rounded to bf16 before P.V and
// P^T.dO, dS before dS.K and dS^T.Q; fp16 inputs arrive rounded to bf16
// by the wrapper and the epilogues write fp16 straight from the fp32
// accumulators (Params::out_f16).  The causal mask is the finite -FLT_MAX;
// O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30)); dQ and dK are
// scaled once at the end.  No atomics, every sum in a fixed order: two
// runs give the same bits.
//
// What bounds them on this card: the tensor-core work, 4, 6 and 8 * 256
// flops per (query, key) pair (halved by causal), against 512 bytes a row
// of each operand: well above the H100's ~295 flops/byte ridge.
//
// The design is flash_attention.cu's (its header): a persistent CTA an
// SM walking items heaviest first, a producer warpgroup whose one thread
// issues TMA loads into a 2-stage ring under mbarriers, two consumer
// warpgroups on wgmma with fp32 accumulators in registers (setmaxnreg
// 24/240), tensor maps over the strided [B, S, 3*H*D] projection views,
// 32-dim slabs with the 64-byte swizzle (8 at D 256), P exponentiated in
// base 2 and fed back from registers as the A operand.  What D 256 changes:
// * A 64 x 256 fp32 accumulator takes 128 registers a thread, so a
//   consumer holds one accumulator and nothing else of that size.
// * K1: items of 128 query rows (64 a warpgroup), 64-key K/V tiles.  A
//   consumer holds O (128 registers), one 64 x 64 score tile (32) and P
//   in bf16 (16).  O += P V is m64n256k16.  Under the causal mask
//   warpgroup 0 skips the item's last tile, whose keys all follow its
//   rows.  Shared memory: Q 64 KB and two stages of K and V 128 KB leave
//   no room for two 64 x 256 staging tiles (64 KB), so each warpgroup
//   stages its rows through 16 KB of its own in two parts of 128 columns:
//   225 KB with the alignment slack.
// * K2: K1's items, each consumer warpgroup owning 64 rows and their dQ
//   (128 registers), so nothing passes between warpgroups.  Q and dO stay
//   resident (128 KB), which leaves room for two stages of 32-key K and V
//   tiles (64 KB) and K1's staging (32 KB): 225 KB.  A consumer holds dQ,
//   S and dP (16 each) and dS in bf16 (8).  S = Q K^T and dP = dO V^T are
//   m64n32, dQ += dS K two m64n256 steps; under the causal mask warpgroup
//   0 skips the two tiles past its rows and both mask the tiles that
//   cross their diagonal.  A CTA walks its items in rounds of
//   alternating direction, so that the heaviest items of one round meet
//   the lightest of the next.
// * K3: an item is a 64-key tile of one (b, h); its K and V stay resident
//   while Q and dO stream in 64-query tiles, with their LSE and delta
//   slices, diagonal tile first under the causal mask.  The two consumer
//   warpgroups split the outputs, not the keys: warpgroup 1 owns dV
//   (S^T = K Q^T, P^T, dV += P^T dO) and warpgroup 2 owns dK (dP^T =
//   V dO^T, dS^T = P^T o (dP^T - delta), dK += dS^T Q).  Warpgroup 1 hands
//   P^T to warpgroup 2 in fp32 (the value the mma.sync kernel forms dS
//   from) through 16 KB of shared memory, behind two mbarriers (full,
//   empty; each thread arrives): each thread of warpgroup 2 reads the
//   values its peer of the same rank wrote, since both accumulators have
//   one layout.  So each warpgroup runs two of the tile's four 64 x 64 x
//   256 products; recomputing S^T in warpgroup 2 instead would give it
//   three.  Both warpgroups run one code path for their products (a
//   score accumulator, the output accumulator, one A operand); only the
//   elementwise work between them differs.  Named barriers (bar.sync /
//   bar.arrive) in place of the mbarriers made ptxas spill ~380 bytes and
//   serialize the wgmmas (C7512).  The epilogue stages 64-column parts through 8 KB a
//   warpgroup.  Shared memory: K and V 64 KB, two stages of Q and dO
//   128 KB, the stats 1 KB, P^T 16 KB, the staging 16 KB: 226 KB with
//   the slack.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with the plain C interface of the other two flash sources.

#include "flash_hopper.cuh"

namespace {
namespace hopper {

constexpr int kD = 256;
constexpr int kSlabs = kD / kSlab;  // 8 slabs of 32 dims
// keys of a K1 K/V tile; keys of a K3 item and queries of its Q/dO tiles
constexpr int kTile = 64;
constexpr int kTileSlabBytes = kTile * kSlab * 2;    // 64 rows x 64 bytes
constexpr int kTileBytes = kSlabs * kTileSlabBytes;  // 64 x 256 bf16: 32 KB
constexpr int kQSlabBytes = kBlockM * kSlab * 2;     // 128 rows x 64 bytes
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

// K1: Q, then K and V of each stage, then each warpgroup's staging of
// 128 output columns; plus the slack to align the dynamic base.
struct FwdSmem {
  static constexpr int kQBytes = kSlabs * kQSlabBytes;  // 128 x 256
  static constexpr int kStaging = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kPart = 128;
  static constexpr int kBytes = kStaging + 2 * Stage<kPart>::kBytes + 1024;
};

// K3: K and V, then Q and dO of each stage, then the LSE and delta slices
// of each stage (64 fp32 each), then the P^T exchange (64 x 64 fp32), then
// each warpgroup's staging of 64 output columns.
struct DkvSmem {
  static constexpr int kRing = 2 * kTileBytes;
  static constexpr int kStatBytes = kTile * 4;
  static constexpr int kStats = kRing + 2 * kStages * kTileBytes;
  static constexpr int kPt = kStats + 2 * kStages * kStatBytes;
  static constexpr int kStaging = kPt + kTile * kTile * 4;
  static constexpr int kPart = 64;
  static constexpr int kBytes = kStaging + 2 * Stage<kPart>::kBytes + 1024;
};

// K2: Q and dO, then K and V of each stage (32-key tiles), then each
// warpgroup's staging of 128 output columns.
constexpr int kDqTile = 32;  // keys of a K2 K/V tile
constexpr int kDqTileSlabBytes = kDqTile * kSlab * 2;    // 32 rows x 64 B
constexpr int kDqTileBytes = kSlabs * kDqTileSlabBytes;  // 32 x 256: 16 KB
struct DqSmem {
  static constexpr int kQBytes = FwdSmem::kQBytes;  // 128 x 256
  static constexpr int kStaging = 2 * kQBytes + 2 * kStages * kDqTileBytes;
  static constexpr int kPart = 128;
  static constexpr int kBytes = kStaging + 2 * Stage<kPart>::kBytes + 1024;
};

// the barriers' static shared memory is well under 1 KB
static_assert(FwdSmem::kBytes + 1024 <= kMaxSmem, "K1 shared memory");
static_assert(DqSmem::kBytes + 1024 <= kMaxSmem, "K2 shared memory");
static_assert(DkvSmem::kBytes + 1024 <= kMaxSmem, "K3 shared memory");

// Write this warpgroup's 64 x 256 accumulator to out (row stride ss) in
// parts of W columns, each through the warpgroup's staging tile as
// f(x, half) (stage_acc).
template <int W, int Part = 0, typename F>
__device__ __forceinline__ void write_parts(unsigned char* stage,
                                            const float (&acc)[kD / 2],
                                            uint16_t* out, int64_t ss,
                                            int cw, bool f16, F f) {
  wg_sync(cw);  // the last part, or the last item, has left the tile
  stage_acc<W, Part * W / 2>(stage, acc, f16, f);
  wg_sync(cw);
  flush_stage<W>(stage, out + Part * W, ss);
  if constexpr ((Part + 1) * W < kD)
    write_parts<W, Part + 1>(stage, acc, out, ss, cw, f16, f);
}

// ---------------------------------------------------------------------------
// K1 at D 256
// ---------------------------------------------------------------------------
// Items (128-row query tile, b, h), heaviest first (item_of).  The
// producer loads the item's Q once and streams 64-key K and V tiles from
// the diagonal down to key 0; each consumer warpgroup owns 64 rows:
// S = Q K^T (m64n64, 16 steps of 16 dims), the online softmax in base 2,
// O += P V (m64n256, 4 steps of 16 keys).
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = FwdSmem;
  constexpr int kN = kTile / 8;  // 8-key column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_q_free;
  __shared__ __align__(8) uint64_t bar_k[kStages], bar_v[kStages];
  __shared__ __align__(8) uint64_t bar_free[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int n_items = p.S / kBlockM * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&bar_q_free, kConsumerWarps);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_k[st], 1);
      mbar_init(&bar_v[st], 1);
      mbar_init(&bar_free[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = item_of(i, p);
        const int q0 = w.qi * kBlockM;
        const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kTile;
        mbar_wait(&bar_q_free, (round & 1) ^ 1);
        mbar_expect_tx(&bar_q, L::kQBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s)
          tma_load(base + s * kQSlabBytes, &tm_q, &bar_q, s * kSlab, q0,
                   w.h, w.b);
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int k0 = (n_tiles - 1 - it) * kTile;
          mbar_wait(&bar_free[st], ((ring / kStages) & 1) ^ 1);
          const uint32_t sk = base + L::kQBytes + 2 * st * kTileBytes;
          const uint32_t sv = sk + kTileBytes;
          mbar_expect_tx(&bar_k[st], kTileBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sk + s * kTileSlabBytes, &tm_k, &bar_k[st], s * kSlab,
                     k0, w.h, w.b);
          mbar_expect_tx(&bar_v[st], kTileBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sv + s * kTileSlabBytes, &tm_v, &bar_v[st], s * kSlab,
                     k0, w.h, w.b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * cw + 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  const float sl2 = p.scale * kLog2e;
  const uint32_t sq = base + cw * 64 * 64;  // 64 rows of 64 bytes a slab
  unsigned char* const stage =
      gbase + L::kStaging + cw * Stage<L::kPart>::kBytes;

  int ring = 0, round = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
    const Item w = item_of(i, p);
    const int q0 = w.qi * kBlockM;
    const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kTile;
    float o[kD / 2];
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) o[j] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    mbar_wait(&bar_q, round & 1);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sk = base + L::kQBytes + 2 * st * kTileBytes;
      const uint32_t sv = sk + kTileBytes;
      const int k0 = (n_tiles - 1 - it) * kTile;
      // causal: the tile's first key less the warpgroup's first row, a
      // multiple of 64: above 0 every key follows every row (P = 0, the
      // tile skipped), 0 on the diagonal (masked)
      const int c0 = k0 - (q0 + 64 * cw);
      if (p.causal && c0 > 0) {
        mbar_wait(&bar_k[st], par);  // the stage's loads land before it frees
        mbar_wait(&bar_v[st], par);
        if (lane == 0) {
          if (it == n_tiles - 1) mbar_arrive(&bar_q_free);
          mbar_arrive(&bar_free[st]);
        }
        continue;
      }

      // S = Q K^T: 16 steps of 16 dims, two per 64-byte slab row
      float s[kTile / 2];
      mbar_wait(&bar_k[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n64(s,
                     desc_sw64(sq + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                     desc_sw64(sk + (kk >> 1) * kTileSlabBytes + kb, 16, 512),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (it == n_tiles - 1 && lane == 0) mbar_arrive(&bar_q_free);  // Q read

      if (p.causal && c0 == 0) {  // the tile on the warpgroup's diagonal
#pragma unroll
        for (int j = 0; j < kN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = q0 + r0 + (e >= 2 ? 8 : 0);
            const int c = k0 + 8 * j + 2 * t + (e & 1);
            if (c > r) s[4 * j + e] = kNegInf;
          }
      }
      // online softmax on raw scores, in base 2: p = 2^(s*sl2 - m*sl2)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float alpha[2], ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        ms[r] = mx[r] * sl2;
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = exp2f(fmaf(s[4 * j + e], sl2, -ms[e >> 1]));
          sum[e >> 1] += s[4 * j + e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
      // P in bf16 as the A operand of P V: 16 keys a step
      uint32_t pa[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        pa[kk][0] = pack_f32(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];

      // O += P V: V MN-major, 16 keys (1024 bytes) a step; the next
      // 32-dim slab is kTileSlabBytes on
      mbar_wait(&bar_v[st], par);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_rs_n256(o, pa[kk],
                      desc_sw64(sv + kk * 1024, kTileSlabBytes, 512));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }

    // epilogue, while the producer already loads the next item: acc / l
    // as the TPU kernel divides (not a multiply by 1/l)
    const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
    write_parts<L::kPart>(
        stage, o,
        static_cast<uint16_t*>(p.out) + w.b * p.o_sb + w.h * p.o_sh +
            (q0 + 64 * cw) * p.o_ss,
        p.o_ss, cw, p.out_f16,
        [&](float x, int hi) { return x / (hi ? l1 : l0); });
    if (t == 0) {
      float* lse = p.lse_out + (static_cast<int64_t>(w.b) * p.H + w.h) * p.S;
      lse[q0 + r0] = m[0] * p.scale + logf(l0);
      lse[q0 + r0 + 8] = m[1] * p.scale + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 at D 256
// ---------------------------------------------------------------------------
// The CTA's round-th item, rounds in alternating directions: the CTA
// with the heaviest item of one round takes the lightest of the next.
__device__ __forceinline__ int snake_item(int round) {
  const int g = gridDim.x, b = blockIdx.x;
  return round * g + ((round & 1) ? g - 1 - b : b);
}

// Items (128-row query tile, b, h), heaviest first (item_of), as K1, but
// a CTA takes them in rounds of alternating direction (snake_item): at
// B 2, H 16, S 1024, causal, the 256 items make two rounds on 132 SMs,
// and the plain stride gave the CTAs with the heaviest items (32 tiles)
// the next round's heaviest too (16); alternating took 21 % off the
// launch on an H100 80GB HBM3 (113.9 -> 90.1 us).  The producer loads
// the item's Q and dO once and streams 32-key K and V tiles from the
// diagonal down to key 0; each consumer warpgroup owns 64 rows and their
// dQ (128 registers): S = Q K^T and dP = dO V^T (m64n32, 16 steps of 16
// dims each, both operands K-major), P and dS = P o (dP - delta) in one
// pass once both are done, dS rounded to bf16 as the A operand of dQ +=
// dS K (m64n256, 2 steps of 16 keys, K read MN-major as K1 reads V).
// Under the causal mask warpgroup 0 skips the item's two tiles whose keys
// all follow its rows.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         Params p) {
  using L = DqSmem;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_q_free;
  __shared__ __align__(8) uint64_t bar_k[kStages], bar_v[kStages];
  __shared__ __align__(8) uint64_t bar_free[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int n_items = p.S / kBlockM * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&bar_q_free, kConsumerWarps);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_k[st], 1);
      mbar_init(&bar_v[st], 1);
      mbar_init(&bar_free[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0, round = 0;
      for (int i = snake_item(0); i < n_items; i = snake_item(++round)) {
        const Item w = item_of(i, p);
        const int q0 = w.qi * kBlockM;
        const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kDqTile;
        mbar_wait(&bar_q_free, (round & 1) ^ 1);
        mbar_expect_tx(&bar_q, 2 * L::kQBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + s * kQSlabBytes, &tm_q, &bar_q, s * kSlab, q0,
                   w.h, w.b);
          tma_load(base + L::kQBytes + s * kQSlabBytes, &tm_do, &bar_q,
                   s * kSlab, q0, w.h, w.b);
        }
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int k0 = (n_tiles - 1 - it) * kDqTile;
          mbar_wait(&bar_free[st], ((ring / kStages) & 1) ^ 1);
          const uint32_t sk = base + 2 * L::kQBytes + 2 * st * kDqTileBytes;
          const uint32_t sv = sk + kDqTileBytes;
          mbar_expect_tx(&bar_k[st], kDqTileBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sk + s * kDqTileSlabBytes, &tm_k, &bar_k[st],
                     s * kSlab, k0, w.h, w.b);
          mbar_expect_tx(&bar_v[st], kDqTileBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sv + s * kDqTileSlabBytes, &tm_v, &bar_v[st],
                     s * kSlab, k0, w.h, w.b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * cw + 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  const float sl2 = p.scale * kLog2e;
  const uint32_t sq = base + cw * 64 * 64;  // 64 rows of 64 bytes a slab
  const uint32_t sdo = sq + L::kQBytes;
  unsigned char* const stage =
      gbase + L::kStaging + cw * Stage<L::kPart>::kBytes;

  int ring = 0, round = 0;
  for (int i = snake_item(0); i < n_items; i = snake_item(++round)) {
    const Item w = item_of(i, p);
    const int q0 = w.qi * kBlockM;
    const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kDqTile;
    const int64_t row =
        (static_cast<int64_t>(w.b) * p.H + w.h) * p.S + q0 + r0;
    // LSE in base 2, once a row: P = 2^(s * scale * log2e - lse * log2e)
    const float lse2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
    const float dlt[2] = {p.delta[row], p.delta[row + 8]};
    float dq[kD / 2];
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) dq[j] = 0.f;

    mbar_wait(&bar_q, round & 1);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sk = base + 2 * L::kQBytes + 2 * st * kDqTileBytes;
      const uint32_t sv = sk + kDqTileBytes;
      const int k0 = (n_tiles - 1 - it) * kDqTile;
      // causal: the tile's first key less the warpgroup's first row, a
      // multiple of 32: 64 and above, every key follows every row (P = 0,
      // the tile skipped); 0 and 32, some do (masked)
      const int c0 = k0 - (q0 + 64 * cw);
      if (p.causal && c0 >= 64) {
        mbar_wait(&bar_k[st], par);  // the stage's loads land before it frees
        mbar_wait(&bar_v[st], par);
        if (lane == 0) {
          if (it == n_tiles - 1) mbar_arrive(&bar_q_free);
          mbar_arrive(&bar_free[st]);
        }
        continue;
      }

      // S = Q K^T and dP = dO V^T: 16 steps of 16 dims each, two per
      // 64-byte slab row
      float s[kDqTile / 2], dp[kDqTile / 2];
      mbar_wait(&bar_k[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n32(s, desc_sw64(sq + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                     desc_sw64(sk + (kk >> 1) * kDqTileSlabBytes + kb, 16,
                               512),
                     kk > 0);
      }
      wgmma_commit();
      mbar_wait(&bar_v[st], par);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n32(dp,
                     desc_sw64(sdo + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                     desc_sw64(sv + (kk >> 1) * kDqTileSlabBytes + kb, 16,
                               512),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      if (it == n_tiles - 1 && lane == 0) mbar_arrive(&bar_q_free);

      // P and dS in one pass, dS in bf16 as the A operand of dS K:
      // da[kk][e] holds row half e & 1, keys 16 kk + 8 (e >> 1) + 2 t and
      // + 1 of the tile
      const bool diag = p.causal && c0 >= 0;
      uint32_t da[kDqTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqTile / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * kk + 2 * e;
          const int r = r0 + 8 * (e & 1);
          const int c = k0 - q0 + 16 * kk + 8 * (e >> 1) + 2 * t;
          float pr[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            pr[h] = diag && c + h > r
                        ? 0.f
                        : exp2_ftz(fmaf(s[x + h], sl2, -lse2[e & 1]));
          da[kk][e] = pack_f32(pr[0] * (dp[x] - dlt[e & 1]),
                               pr[1] * (dp[x + 1] - dlt[e & 1]));
        }
      // dQ += dS K: K MN-major, 16 keys (1024 bytes) a step; the next
      // 32-dim slab is kDqTileSlabBytes on
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqTile / 16; ++kk)
        wgmma_rs_n256(dq, da[kk],
                      desc_sw64(sk + kk * 1024, kDqTileSlabBytes, 512));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }

    // epilogue, while the producer already loads the next item: dQ
    // scaled once
    write_parts<L::kPart>(
        stage, dq,
        static_cast<uint16_t*>(p.out) + w.b * p.o_sb + w.h * p.o_sh +
            (q0 + 64 * cw) * p.o_ss,
        p.o_ss, cw, p.out_f16, [&](float x, int) { return x * p.scale; });
  }
}

// ---------------------------------------------------------------------------
// K3 at D 256
// ---------------------------------------------------------------------------
// Items (64-key tile, b, h), lowest key tile first: under the causal
// mask it sees the most queries.
__device__ __forceinline__ Item dkv_item_of(int i, const Params& p) {
  const int n_bh = p.B * p.H;
  const int bh = i % n_bh;
  return {i / n_bh, bh / p.H, bh % p.H};  // qi holds the key tile here
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          Params p) {
  using L = DkvSmem;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_kv_free;
  __shared__ __align__(8) uint64_t bar_q[kStages], bar_do[kStages];
  __shared__ __align__(8) uint64_t bar_free[kStages];
  // the P^T exchange: full (each thread of warpgroup 1 wrote its values)
  // and empty (each thread of warpgroup 2 read them)
  __shared__ __align__(8) uint64_t bar_pt_full, bar_pt_empty;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int n_items = p.S / kTile * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    mbar_init(&bar_kv_free, kConsumerWarps);
    mbar_init(&bar_pt_full, 128);
    mbar_init(&bar_pt_empty, 128);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_q[st], 1);
      mbar_init(&bar_do[st], 1);
      mbar_init(&bar_free[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = dkv_item_of(i, p);
        const int k0 = w.qi * kTile;
        const int first = p.causal ? k0 / kTile : 0;
        const int n_tiles = p.S / kTile - first;
        const int64_t bh = (static_cast<int64_t>(w.b) * p.H + w.h) * p.S;
        mbar_wait(&bar_kv_free, (round & 1) ^ 1);
        mbar_expect_tx(&bar_kv, 2 * kTileBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + s * kTileSlabBytes, &tm_k, &bar_kv, s * kSlab, k0,
                   w.h, w.b);
          tma_load(base + kTileBytes + s * kTileSlabBytes, &tm_v, &bar_kv,
                   s * kSlab, k0, w.h, w.b);
        }
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int qs = (first + it) * kTile;
          mbar_wait(&bar_free[st], ((ring / kStages) & 1) ^ 1);
          const uint32_t sqt = base + L::kRing + 2 * st * kTileBytes;
          const uint32_t sdo = sqt + kTileBytes;
          const uint32_t stats = base + L::kStats + 2 * st * L::kStatBytes;
          mbar_expect_tx(&bar_q[st], kTileBytes + L::kStatBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sqt + s * kTileSlabBytes, &tm_q, &bar_q[st], s * kSlab,
                     qs, w.h, w.b);
          bulk_load(stats, p.lse + bh + qs, L::kStatBytes, &bar_q[st]);
          mbar_expect_tx(&bar_do[st], kTileBytes + L::kStatBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sdo + s * kTileSlabBytes, &tm_do, &bar_do[st],
                     s * kSlab, qs, w.h, w.b);
          bulk_load(stats + L::kStatBytes, p.delta + bh + qs, L::kStatBytes,
                    &bar_do[st]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7;  // 0: dV, 1: dK
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // keys r0 and r0 + 8 of the item's 64
  const float sl2 = p.scale * kLog2e;
  const uint32_t sk = base, sv = base + kTileBytes;
  // this thread's column of the P^T exchange: accumulator elements
  // 4j .. 4j + 3 at pt[128 * j], so a warp's accesses are contiguous
  float4* const pt = reinterpret_cast<float4*>(gbase + L::kPt) + (tid & 127);
  unsigned char* const stage =
      gbase + L::kStaging + cw * Stage<L::kPart>::kBytes;

  int ring = 0, round = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
    const Item w = dkv_item_of(i, p);
    const int k0 = w.qi * kTile;
    const int first = p.causal ? k0 / kTile : 0;
    const int n_tiles = p.S / kTile - first;
    float acc[kD / 2];  // dV in warpgroup 1, dK in warpgroup 2
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) acc[j] = 0.f;

    mbar_wait(&bar_kv, round & 1);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sqt = base + L::kRing + 2 * st * kTileBytes;
      const uint32_t sdo = sqt + kTileBytes;
      const float* lse = reinterpret_cast<const float*>(
          gbase + L::kStats + 2 * st * L::kStatBytes);
      const float* dlt = lse + kTile;
      // causal: the first tile is the diagonal one (its queries start at
      // the item's first key), the only one masked
      const bool diag = p.causal && it == 0;

      // the score tile: S^T = K Q^T in warpgroup 1, dP^T = V dO^T in
      // warpgroup 2.  Both warpgroups run one code path for their products
      // (one score accumulator, one output accumulator, one A operand);
      // only the elementwise work between them differs.
      const uint32_t sa = cw ? sv : sk, sb = cw ? sdo : sqt;
      mbar_wait(cw ? &bar_do[st] : &bar_q[st], par);
      float sc[kTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n64(sc,
                     desc_sw64(sa + (kk >> 1) * kTileSlabBytes + kb, 16, 512),
                     desc_sw64(sb + (kk >> 1) * kTileSlabBytes + kb, 16, 512),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      // sc[x], sc[x + 1] (x = 8 kk + 2 e): key half e & 1, queries
      // col = 16 kk + 8 (e >> 1) + 2 t and + 1; the A operand a[kk][e]
      // holds the same pair in bf16
      uint32_t a[kTile / 16][4];
      if (cw == 0) {
        // P^T = 2^(s*sl2 - lse*log2e), LSE per column; handed over in fp32
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 8 * kk + 2 * e;
            const int r = r0 + 8 * (e & 1);
            const int col = 16 * kk + 8 * (e >> 1) + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
            const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
            for (int h = 0; h < 2; ++h)
              sc[x + h] = diag && col + h < r
                              ? 0.f
                              : exp2_ftz(fmaf(sc[x + h], sl2, -lse2[h]));
          }
        // warpgroup 2 has read the last tile's P^T (the exchange counts
        // tiles as the ring does: one a tile)
        mbar_wait(&bar_pt_empty, (ring & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
          pt[128 * j] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                                    sc[4 * j + 3]);
        mbar_arrive(&bar_pt_full);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[kk][e] = pack_f32(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      } else {
        // dS^T = P^T o (dP^T - delta) from warpgroup 1's fp32 P^T, delta
        // per column
        mbar_wait(&bar_pt_full, ring & 1);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 8 * kk + 2 * e;
            const int col = 16 * kk + 8 * (e >> 1) + 2 * t;
            const float2 pv =
                reinterpret_cast<const float2*>(pt + 128 * (x >> 2))[e & 1];
            const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
            a[kk][e] = pack_f32(pv.x * (sc[x] - d2.x),
                                pv.y * (sc[x + 1] - d2.y));
          }
        mbar_arrive(&bar_pt_empty);
      }

      // dV += P^T dO (warpgroup 1), dK += dS^T Q (warpgroup 2): dO or Q
      // MN-major, 16 queries (1024 bytes) a step
      const uint32_t so = cw ? sqt : sdo;
      mbar_wait(cw ? &bar_q[st] : &bar_do[st], par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_rs_n256(acc, a[kk], desc_sw64(so + kk * 1024, kTileSlabBytes,
                                            512));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(a);
      if (lane == 0) {
        if (it == n_tiles - 1) mbar_arrive(&bar_kv_free);
        mbar_arrive(&bar_free[st]);
      }
    }

    // epilogue: dV as it is, dK scaled once (x * 1 is x)
    const float f = cw ? p.scale : 1.f;
    write_parts<L::kPart>(
        stage, acc,
        static_cast<uint16_t*>(cw ? p.out : p.out2) + w.b * p.o_sb +
            w.h * p.o_sh + k0 * p.o_ss,
        p.o_ss, cw, p.out_f16, [&](float x, int) { return x * f; });
  }
}

cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_view(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p, kD, kBlockM) ||
      !encode_view(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p, kD, kTile) ||
      !encode_view(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p, kD, kTile))
    return cudaErrorInvalidValue;
  return launch_persistent<flash_fwd_d256_kernel>(
      FwdSmem::kBytes, p.S / kBlockM * p.B * p.H, stream, tq, tk, tv, p);
}

// q and dO in 128-row boxes, k and v in 32-row boxes, in any strides TMA
// takes.
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_view(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p, kD, kBlockM) ||
      !encode_view(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p, kD, kDqTile) ||
      !encode_view(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p, kD, kDqTile) ||
      !encode_view(&tdo, p.dout, p.do_sb, p.do_sh, p.do_ss, p, kD, kBlockM))
    return cudaErrorInvalidValue;
  return launch_persistent<flash_bwd_dq_d256_kernel>(
      DqSmem::kBytes, p.S / kBlockM * p.B * p.H, stream, tq, tk, tv, tdo, p);
}

// q, k, v and dO in 64-row boxes, in any strides TMA takes; the LSE and
// delta slices by bulk copies, which need 16-byte aligned rows.
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_view(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p, kD, kTile) ||
      !encode_view(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p, kD, kTile) ||
      !encode_view(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p, kD, kTile) ||
      !encode_view(&tdo, p.dout, p.do_sb, p.do_sh, p.do_ss, p, kD, kTile))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p.lse) |
       reinterpret_cast<uintptr_t>(p.delta)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  return launch_persistent<flash_bwd_dkv_d256_kernel>(
      DkvSmem::kBytes, p.S / kTile * p.B * p.H, stream, tq, tk, tv, tdo, p);
}

}  // namespace hopper

// dtype: 1 bf16; 2 fp16 outputs from bf16 operands (Params::out_f16).
int check(Params* p, int D, int dtype) {
  if (p->S % 128 != 0 || p->S <= 0 || p->B * p->H < 1 ||
      p->B * p->H > 65535 || D != hopper::kD || dtype < 1 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  p->out_f16 = dtype == 2;
  return 0;
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
  if (const int err = check(&p, D, dtype)) return err;
  return static_cast<int>(
      hopper::launch_fwd(p, static_cast<cudaStream_t>(stream)));
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
  if (const int err = check(&p, D, dtype)) return err;
  return static_cast<int>(
      hopper::launch_dq(p, static_cast<cudaStream_t>(stream)));
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
  if (const int err = check(&p, D, dtype)) return err;
  return static_cast<int>(
      hopper::launch_dkv(p, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory a launch asks for: kind 0 = K1, 1 = K2, 2 = K3;
// dtype as check() takes it; -1 for what is not built.
long long flash_attention_smem_bytes(int kind, int D, int dtype) {
  if (D != hopper::kD || dtype < 1 || dtype > 2) return -1;
  if (kind == 0) return hopper::FwdSmem::kBytes;
  if (kind == 1) return hopper::DqSmem::kBytes;
  if (kind == 2) return hopper::DkvSmem::kBytes;
  return -1;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
