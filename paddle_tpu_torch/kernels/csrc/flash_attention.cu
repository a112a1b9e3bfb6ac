// Flash attention forward, dQ and dK/dV for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/kernels/flash_attention.py
// at head dims 64, 96 and 128 (GPT-3 125M's, 760M's and 1.3B's) in bf16
// and fp16:
//   K1 _fwd_kernel     (via _flash_fwd)  -> hopper::flash_fwd_wgmma_kernel
//   K2 _bwd_dq_kernel  (via _flash_bwd)  -> hopper::flash_bwd_dq_wgmma_kernel
//   K3 _bwd_dkv_kernel (via _flash_bwd)  -> hopper::flash_bwd_dkv_wgmma_kernel
// K1-K3 at head dim 256 in bf16/fp16 are flash_attention_d256.cu's
// (this design, recut for D 256); fp32 at every head dim, and bf16/fp16
// at the other multiples of 16 up to 240, are flash_attention_mma.cu's
// simpler kernels.  The helpers the Hopper kernels share (TMA,
// mbarriers, wgmma, descriptors, staging, launches) are in
// flash_hopper.cuh.
//
// What they compute, per (batch b, head h), over q/k/v rows of length S
// (S % 128 == 0, the TPU kernel's rule):
//   K1: O = softmax(scale * Q K^T) V with an online softmax over key
//       tiles, and LSE = m + log(max(l, 1e-30)); O = acc / max(l, 1e-30).
//   K2: dQ = scale * sum_k [P o (dO V^T - delta)] K, P = exp(scale*QK^T - LSE)
//   K3: dV = sum_q P^T dO, dK = scale * sum_q dS^T Q, dS = P o (dP - delta)
// Causal masks q_pos < k_pos with the finite -FLT_MAX (NEG_INF of the plain
// version), so exp never sees inf - inf; a masked P is 0.  As the TPU
// kernel's _dot_f32 does, every product of 16-bit inputs takes both
// operands in bf16 and sums in fp32: P is rounded to bf16 before P.V and
// P^T.dO, dS before dS.K and dS^T.Q.  fp16 inputs run the bf16 kernels
// on operands rounded to bf16 (what _dot_f32 does to a 2-byte operand):
// K1, K2 and K3 read the fp16 tiles through TMA and round them in shared
// memory (Params::in_f16, dtype 3: the converter warps of the producer
// warpgroup, flash_hopper.cuh); dtype 2 takes operands the wrapper
// rounded by copies, the route those outputs are held to bit for bit.
// The epilogues write O, dQ, dK and dV as fp16 straight from the fp32
// accumulators (Params::out_f16), never through a bf16 value.  dQ and dK
// are scaled once at the end instead of per tile (equal up to fp32
// rounding).  Nothing crosses CTAs and every sum runs in a fixed order:
// no atomics, and two runs give the same bits.
// K2 and K3 keep the TPU's split of dQ from dK/dV for that reason.
//
// What bounds them on this card: at training shapes (S = 1024, D = 96)
// the tensor-core work, 4, 6 and 8 * D flops per (query, key) pair for K1,
// K2 and K3 (halved by causal), against a few bytes of q/k/v/dO a row:
// hundreds of flops per byte, at or above the H100's ~295 flops/byte
// ridge.  So every design keeps its tiles in shared memory and its score
// tiles in registers, never writes an S x S matrix to device memory, and
// is held back by how busy it keeps the tensor cores.
//
// The bf16 kernels (the `hopper` namespace below) share one design:
// * A persistent CTA of three warpgroups, one a card SM, walks work items
//   (a 128-row tile, b, h), heaviest causal items first.  Warpgroup 0 is
//   the producer: one thread issues TMA loads (cp.async.bulk.tensor) of
//   the item's resident tiles once and streams the other side's tiles
//   through a ring of 2 stages, completing on mbarriers; each consumer
//   warp frees a stage (and the resident tiles) on another mbarrier, so
//   the next item's loads overlap this item's last tiles and epilogue.
//   Warpgroups 1 and 2 each own 64 rows of the item; setmaxnreg moves
//   registers from the producer to them: 40 and 232 in K1, K3 and fp16
//   K2, where with fp16 operands warps 1-3 of warpgroup 0 round each
//   landed tile to bf16 in place and arrive on its ready barrier, which
//   the consumers wait on too (at 24, ptxas spilled the converter loop
//   and K3's producer); 24 and 240 in bf16 K2, an instance of its own
//   (the template's F16).  Either split takes 504 registers for each of
//   128 thread slots: the 168 x 384 that the CTA holds.
// * Products are wgmma with fp32 accumulators in registers.  A score tile
//   is taken from the accumulators, exponentiated in base 2 (scale *
//   log2(e) folded into one FMA, the LSE pre-scaled by log2(e)), rounded
//   to bf16 and fed back as the register A operand of the next product.
//   One shared-memory tile serves as a K-major operand in one product and
//   as a transposed (MN-major) B in another, so no tile is transposed.
//   K1: S = Q K^T, O += P V.  K2 (items: query tiles; K, V streamed):
//   S = Q K^T, dP = dO V^T, dQ += dS K.  K3 (items: 128-key tiles; Q, dO
//   streamed in 64-query tiles with their LSE and delta slices by 1-d
//   bulk copies): the scores transposed, S^T = K Q^T and dP^T = V dO^T,
//   so that P^T and dS^T have keys as rows, the A layout of dV += P^T dO
//   and dK += dS^T Q.  Causal items load no tile past the diagonal and
//   mask only the diagonal ones; K3 skips a warpgroup's tile whose every
//   query is before every one of its keys.
// * Tensor maps (D, S, H, B) over the strided views (the [B, S, 3*H*D]
//   projection output, read in place; dO in any stride order), encoded
//   per launch with cuTensorMapEncodeTiled from the runtime's driver entry
//   point (no -lcuda).  D = 96 rows are 192 bytes, which no 128-byte
//   swizzle box covers, so every operand is cut into 32-dim (64-byte)
//   slabs with the 64-byte swizzle: 2, 3 or 4 slabs for D 64, 96, 128, one
//   layout for all three.  K-major descriptors step 32 bytes within a slab
//   row and a slab between 16-dim steps; MN-major ones step 16 rows (1024
//   bytes) a k-step, their leading offset one slab (the next 32 dims).
// * Epilogues stage each warpgroup's 64 output rows in shared memory and
//   write them in whole 16-byte vectors; the accumulator layout alone
//   would store 4-byte pieces 8 rows apart.
// * K2's and K3's consumers are short of issue slots rather than of
//   tensor-core time.  So they form P and dS in one pass once both score
//   products are done (P never lies whole beside dP, which keeps them
//   clear of spills), each exp is one MUFU op (ex2.approx.ftz), and K3
//   issues dV += P^T dO and dK += dS^T Q as one group: together 12 % off
//   K2's time and 17 % off K3's at the 760M shape on an H100 80GB HBM3.
//   K1 keeps exp2f.
// * Measured alternatives that lost at the 760M shape, and so are not
//   here (PERF.md, Findings): for K1 a non-persistent grid, 64-key
//   tiles, warpgroups taking turns on the tensor cores, the next tile's
//   Q K^T issued before this tile's softmax, and 64-dim slabs with the
//   128-byte swizzle; for K2 and K3 the next tile's score products issued
//   before this tile's last product is done, 3 stages, pairing light with
//   heavy tiles so that CTAs in flight share a head's tiles in L2,
//   descriptors precomputed once a tile, and P computed while dP's
//   product runs.
//
// They read q, k, v and dO as strided views with a contiguous head dim
// and write outputs [B, S, H, D].
//
// Still open: why two warpgroups' wgmma groups leave the tensor cores
// idle (on an H100 80GB HBM3, K1's products alone, without softmax or
// loads, took 59 of its 95 us); overlap the elementwise work with them.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.

#include "flash_hopper.cuh"

namespace {
namespace hopper {

constexpr int kBlockN = 128;  // keys a K/V tile holds
constexpr int kQSlabBytes = kBlockM * kSlab * 2;   // 128 rows x 64 bytes
constexpr int kKVSlabBytes = kBlockN * kSlab * 2;
constexpr int kStages = 2;    // K/V tiles in flight

constexpr int kBlockQ = 64;   // queries a Q/dO tile of K3 holds
constexpr int kQTSlabBytes = kBlockQ * kSlab * 2;  // 64 rows x 64 bytes

// K1: Q, then K and V of each stage, each tile 1024-byte aligned, then
// the two warpgroups' output staging; plus the slack to align the
// dynamic base.
template <int D>
struct Smem {
  static constexpr int kQBytes = D / kSlab * kQSlabBytes;    // 128 x D
  static constexpr int kKVBytes = D / kSlab * kKVSlabBytes;  // kBlockN x D
  static constexpr int kBytes =
      kQBytes + 2 * kStages * kKVBytes + 2 * Stage<D>::kBytes + 1024;
};

// K2: Q and dO, then K and V of each stage, then the dQ staging.
template <int D>
struct DqSmem {
  static constexpr int kQBytes = Smem<D>::kQBytes;
  static constexpr int kKVBytes = Smem<D>::kKVBytes;
  static constexpr int kBytes =
      2 * kQBytes + 2 * kStages * kKVBytes + 2 * Stage<D>::kBytes + 1024;
};

// K3: K and V (128 keys), then Q and dO (64 queries) of each stage, then
// the LSE and delta slices of each stage (64 fp32 each), then the dK and
// dV staging of both warpgroups.
template <int D>
struct DkvSmem {
  static constexpr int kKBytes = Smem<D>::kKVBytes;           // 128 x D
  static constexpr int kQTBytes = D / kSlab * kQTSlabBytes;   // 64 x D
  static constexpr int kStatBytes = kBlockQ * 4;
  static constexpr int kStats = 2 * kKBytes + 2 * kStages * kQTBytes;
  static constexpr int kStaging = kStats + 2 * kStages * kStatBytes;
  static constexpr int kBytes = kStaging + 4 * Stage<D>::kBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, Params p) {
  constexpr int kSlabs = D / kSlab;
  constexpr int kQBytes = Smem<D>::kQBytes;
  constexpr int kKV = Smem<D>::kKVBytes;
  constexpr int kN = kBlockN / 8;  // 8-key column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_q_free;
  __shared__ __align__(8) uint64_t bar_k[kStages], bar_v[kStages];
  __shared__ __align__(8) uint64_t bar_free[kStages];
  // fp16 operands: each tile's converters are done
  __shared__ __align__(8) uint64_t bar_q_ready, bar_k_ready[kStages],
      bar_v_ready[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n_items = p.S / kBlockM * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&bar_q_free, kConsumerWarps);
    mbar_init(&bar_q_ready, kConverters);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_k[st], 1);
      mbar_init(&bar_v[st], 1);
      mbar_init(&bar_free[st], kConsumerWarps);
      mbar_init(&bar_k_ready[st], kConverters);
      mbar_init(&bar_v_ready[st], kConverters);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every TMA load, for item after item;
    // an item's tiles go from the diagonal (the only masked one) down to
    // key 0.  `ring` counts K/V tiles over the CTA's whole life.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (p.in_f16 && threadIdx.x >= 32) {
      // converters: the producer's walk, each tile rounded once landed
      const int c = threadIdx.x - 32;
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = item_of(i, p);
        const int n_tiles =
            (p.causal ? (w.qi + 1) * kBlockM : p.S) / kBlockN;
        convert_landed(&bar_q, &bar_q_ready, round & 1, base, kQBytes, c);
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int par = (ring / kStages) & 1;
          const uint32_t tk = base + kQBytes + 2 * st * kKV;
          convert_landed(&bar_k[st], &bar_k_ready[st], par, tk, kKV, c);
          convert_landed(&bar_v[st], &bar_v_ready[st], par, tk + kKV, kKV,
                         c);
        }
      }
    }
    if (threadIdx.x == 0) {
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = item_of(i, p);
        const int q0 = w.qi * kBlockM;
        const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kBlockN;
        mbar_wait(&bar_q_free, (round & 1) ^ 1);
        mbar_expect_tx(&bar_q, kQBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s)
          tma_load(base + s * kQSlabBytes, &tm_q, &bar_q, s * kSlab, q0,
                   w.h, w.b);
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int k0 = (n_tiles - 1 - it) * kBlockN;
          mbar_wait(&bar_free[st], ((ring / kStages) & 1) ^ 1);
          const uint32_t sk = base + kQBytes + 2 * st * kKV, sv = sk + kKV;
          mbar_expect_tx(&bar_k[st], kKV);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sk + s * kKVSlabBytes, &tm_k, &bar_k[st], s * kSlab, k0,
                     w.h, w.b);
          mbar_expect_tx(&bar_v[st], kKV);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sv + s * kKVSlabBytes, &tm_v, &bar_v[st], s * kSlab, k0,
                     w.h, w.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows 64*cw .. 64*cw + 63 of the
  // item's tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * cw + 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  const float sl2 = p.scale * kLog2e;
  const uint32_t sq = base + cw * 64 * 64;  // 64 rows of 64 bytes a slab

  int ring = 0, round = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
    const Item w = item_of(i, p);
    const int q0 = w.qi * kBlockM;
    const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kBlockN;
    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    tile_wait(&bar_q, &bar_q_ready, round & 1, p.in_f16);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sk = base + kQBytes + 2 * st * kKV, sv = sk + kKV;
      const int k0 = (n_tiles - 1 - it) * kBlockN;

      // S = Q K^T: D/16 steps of 16 dims, two per 64-byte slab row
      float s[kBlockN / 2];
      tile_wait(&bar_k[st], &bar_k_ready[st], par, p.in_f16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n128(s, desc_sw64(sq + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                      desc_sw64(sk + (kk >> 1) * kKVSlabBytes + kb, 16, 512),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (it == n_tiles - 1 && lane == 0) mbar_arrive(&bar_q_free);  // Q read

      if (p.causal && k0 + kBlockN > q0) {  // the tile on the diagonal
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
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_f32(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];

      // O += P V: V MN-major, 16 keys (1024 bytes) a step; the next
      // 32-dim slab is kKVSlabBytes on
      tile_wait(&bar_v[st], &bar_v_ready[st], par, p.in_f16);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], desc_sw64(sv + kk * 1024, kKVSlabBytes, 512));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }

    // epilogue, while the producer already loads the next item: the
    // warpgroup's 64 output rows go through shared memory, so that they
    // leave in whole 16-byte vectors a thread rather than as the
    // accumulator layout's 4-byte pieces
    const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
    unsigned char* stage = smem_raw + (base - smem_u32(smem_raw)) + kQBytes +
                           2 * kStages * kKV + cw * Stage<D>::kBytes;
    wg_sync(cw);
    // acc / l as the TPU kernel divides (not a multiply by 1/l)
    stage_acc<D>(stage, o, p.out_f16,
                 [&](float x, int hi) { return x / (hi ? l1 : l0); });
    wg_sync(cw);
    flush_stage<D>(stage, static_cast<uint16_t*>(p.out) + w.b * p.o_sb +
                              w.h * p.o_sh + (q0 + 64 * cw) * p.o_ss,
                   p.o_ss);
    if (t == 0) {
      float* lse = p.lse_out + (static_cast<int64_t>(w.b) * p.H + w.h) * p.S;
      lse[q0 + r0] = m[0] * p.scale + logf(l0);
      lse[q0 + r0 + 8] = m[1] * p.scale + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ on the same machinery
// ---------------------------------------------------------------------------
// A persistent CTA walks items (128-row query tile, b, h), heaviest causal
// tiles first (item_of).  The producer loads the item's Q and dO tiles
// once, then streams 128-key K and V tiles through the ring, diagonal
// tile first.  Each consumer warpgroup owns 64 query rows and runs three
// wgmma products a tile: S = Q K^T and dP = dO V^T (both operands K-major
// in shared memory), then dQ += dS K with dS from registers and the K
// tile read as a transposed (MN-major) B, as K1 reads V.
//
// F16 (fp16 operands, dtype code 3) is an instance of its own: warps 1-3
// of the producer warpgroup round each landed tile to bf16 in shared
// memory, as in K1 and K3, and need 40 registers a thread (at 24 the
// converter loop spills), so its consumers take 232.  Q and dO land
// together but are ready apart, in the order the products read them (Q,
// the first K, dO, the first V): S starts before dO is rounded, which
// took 6 % off fp16 K2 at the 760M shape on an H100 80GB HBM3.  The bf16
// instance keeps 24/240 and its code.
template <int D, bool F16>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          Params p) {
  constexpr int kSlabs = D / kSlab;
  constexpr int kQBytes = DqSmem<D>::kQBytes;
  constexpr int kKV = DqSmem<D>::kKVBytes;
  constexpr int kN = kBlockN / 8;  // 8-key column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_q_free;
  __shared__ __align__(8) uint64_t bar_k[kStages], bar_v[kStages];
  __shared__ __align__(8) uint64_t bar_free[kStages];
  // F16: each tile's converters are done (Q and dO land on bar_q)
  __shared__ __align__(8) uint64_t bar_q_ready, bar_k_ready[kStages],
      bar_v_ready[kStages], bar_do_ready;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n_items = p.S / kBlockM * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&bar_q_free, kConsumerWarps);
    if constexpr (F16) {
      mbar_init(&bar_q_ready, kConverters);
      mbar_init(&bar_do_ready, kConverters);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_k[st], 1);
      mbar_init(&bar_v[st], 1);
      mbar_init(&bar_free[st], kConsumerWarps);
      if constexpr (F16) {
        mbar_init(&bar_k_ready[st], kConverters);
        mbar_init(&bar_v_ready[st], kConverters);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    if constexpr (F16) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
      if (threadIdx.x >= 32) {
        // converters: the producer's walk, each tile rounded once landed,
        // dO after the item's first K
        const int c = threadIdx.x - 32;
        int ring = 0, round = 0;
        for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
          const Item w = item_of(i, p);
          const int n_tiles =
              (p.causal ? (w.qi + 1) * kBlockM : p.S) / kBlockN;
          convert_landed(&bar_q, &bar_q_ready, round & 1, base, kQBytes, c);
          for (int it = 0; it < n_tiles; ++it, ++ring) {
            const int st = ring % kStages;
            const int par = (ring / kStages) & 1;
            const uint32_t tk = base + 2 * kQBytes + 2 * st * kKV;
            convert_landed(&bar_k[st], &bar_k_ready[st], par, tk, kKV, c);
            if (it == 0)
              convert_landed(&bar_q, &bar_do_ready, round & 1,
                             base + kQBytes, kQBytes, c);
            convert_landed(&bar_v[st], &bar_v_ready[st], par, tk + kKV, kKV,
                           c);
          }
        }
      }
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    if (threadIdx.x == 0) {
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = item_of(i, p);
        const int q0 = w.qi * kBlockM;
        const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kBlockN;
        mbar_wait(&bar_q_free, (round & 1) ^ 1);
        mbar_expect_tx(&bar_q, 2 * kQBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + s * kQSlabBytes, &tm_q, &bar_q, s * kSlab, q0, w.h,
                   w.b);
          tma_load(base + kQBytes + s * kQSlabBytes, &tm_do, &bar_q,
                   s * kSlab, q0, w.h, w.b);
        }
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int k0 = (n_tiles - 1 - it) * kBlockN;
          mbar_wait(&bar_free[st], ((ring / kStages) & 1) ^ 1);
          const uint32_t sk = base + 2 * kQBytes + 2 * st * kKV, sv = sk + kKV;
          mbar_expect_tx(&bar_k[st], kKV);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sk + s * kKVSlabBytes, &tm_k, &bar_k[st], s * kSlab, k0,
                     w.h, w.b);
          mbar_expect_tx(&bar_v[st], kKV);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sv + s * kKVSlabBytes, &tm_v, &bar_v[st], s * kSlab, k0,
                     w.h, w.b);
        }
      }
    }
    return;
  }

  if constexpr (F16)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * cw + 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  const float sl2 = p.scale * kLog2e;
  const uint32_t sq = base + cw * 64 * 64;  // 64 rows of 64 bytes a slab
  const uint32_t sdo = sq + kQBytes;

  int ring = 0, round = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
    const Item w = item_of(i, p);
    const int q0 = w.qi * kBlockM;
    const int n_tiles = (p.causal ? q0 + kBlockM : p.S) / kBlockN;
    const int64_t row =
        (static_cast<int64_t>(w.b) * p.H + w.h) * p.S + q0 + r0;
    // LSE in base 2, once a row: P = 2^(s * scale * log2e - lse * log2e)
    const float lse2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
    const float dlt[2] = {p.delta[row], p.delta[row + 8]};
    float dq[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

    tile_wait(&bar_q, &bar_q_ready, round & 1, F16);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sk = base + 2 * kQBytes + 2 * st * kKV, sv = sk + kKV;
      const int k0 = (n_tiles - 1 - it) * kBlockN;

      // S = Q K^T and dP = dO V^T
      float s[kBlockN / 2], dp[kBlockN / 2];
      tile_wait(&bar_k[st], &bar_k_ready[st], par, F16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n128(s, desc_sw64(sq + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                      desc_sw64(sk + (kk >> 1) * kKVSlabBytes + kb, 16, 512),
                      kk > 0);
      }
      wgmma_commit();
      tile_wait(&bar_v[st], &bar_v_ready[st], par, F16);
      if (F16 && it == 0) mbar_wait(&bar_do_ready, round & 1);  // dO rounded
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n128(dp,
                      desc_sw64(sdo + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                      desc_sw64(sv + (kk >> 1) * kKVSlabBytes + kb, 16, 512),
                      kk > 0);
      }
      wgmma_commit();

      // P and dS = P o (dP - delta) in one pass once both products are
      // done (P never lies beside dP whole: no spills, and the one-op
      // exp), dS in bf16 as the A operand of dS K: da[kk][e] holds row
      // half e & 1, keys 16 kk + 8 (e >> 1) + 2 t and + 1.  The diagonal
      // tile (the first) alone is masked.
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      if (it == n_tiles - 1 && lane == 0) mbar_arrive(&bar_q_free);
      const bool diag = p.causal && it == 0;
      uint32_t da[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
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
      // dQ += dS K: K MN-major, 16 keys (1024 bytes) a step
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<D>(dq, da[kk], desc_sw64(sk + kk * 1024, kKVSlabBytes, 512));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&bar_free[st]);
    }

    // epilogue: dQ scaled once, out through shared memory
    unsigned char* stage = smem_raw + (base - smem_u32(smem_raw)) +
                           2 * kQBytes + 2 * kStages * kKV +
                           cw * Stage<D>::kBytes;
    wg_sync(cw);
    stage_acc<D>(stage, dq, p.out_f16,
                 [&](float x, int) { return x * p.scale; });
    wg_sync(cw);
    flush_stage<D>(stage, static_cast<uint16_t*>(p.out) + w.b * p.o_sb +
                              w.h * p.o_sh + (q0 + 64 * cw) * p.o_ss,
                   p.o_ss);
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: dK and dV on the same machinery
// ---------------------------------------------------------------------------
// Items are (128-key tile, b, h), lowest key tile first: under the causal
// mask it sees the most queries.  The producer loads the item's K and V
// once, then streams 64-query Q and dO tiles, with their LSE and delta
// slices (1-d bulk copies), through the ring; causal items start at the
// diagonal.  Each consumer warpgroup owns 64 keys and computes the scores
// transposed, S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T leave
// the accumulators with keys as rows: the A layout of dV += P^T dO and
// dK += dS^T Q, whose B (dO, Q) is read MN-major.  No tile is transposed
// through shared memory.
__device__ __forceinline__ Item dkv_item_of(int i, const Params& p) {
  const int n_bh = p.B * p.H;
  const int bh = i % n_bh;
  return {i / n_bh, bh / p.H, bh % p.H};  // qi holds the key tile here
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           Params p) {
  using L = DkvSmem<D>;
  constexpr int kSlabs = D / kSlab;
  constexpr int kK = L::kKBytes;
  constexpr int kQT = L::kQTBytes;
  constexpr int kM = kBlockQ / 8;  // 8-query column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_kv_free;
  __shared__ __align__(8) uint64_t bar_q[kStages], bar_do[kStages];
  __shared__ __align__(8) uint64_t bar_free[kStages];
  // fp16 operands: each tile's converters are done
  __shared__ __align__(8) uint64_t bar_kv_ready, bar_q_ready[kStages],
      bar_do_ready[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int n_items = p.S / kBlockN * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    mbar_init(&bar_kv_free, kConsumerWarps);
    mbar_init(&bar_kv_ready, kConverters);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_q[st], 1);
      mbar_init(&bar_do[st], 1);
      mbar_init(&bar_free[st], kConsumerWarps);
      mbar_init(&bar_q_ready[st], kConverters);
      mbar_init(&bar_do_ready[st], kConverters);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (p.in_f16 && threadIdx.x >= 32) {
      // converters: the producer's walk, each tile rounded once landed
      // (the LSE and delta slices are fp32 and stay as they are)
      const int c = threadIdx.x - 32;
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = dkv_item_of(i, p);
        const int first = p.causal ? w.qi * kBlockN / kBlockQ : 0;
        const int n_tiles = p.S / kBlockQ - first;
        convert_landed(&bar_kv, &bar_kv_ready, round & 1, base, 2 * kK, c);
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int par = (ring / kStages) & 1;
          const uint32_t tq = base + 2 * kK + 2 * st * kQT;
          convert_landed(&bar_q[st], &bar_q_ready[st], par, tq, kQT, c);
          convert_landed(&bar_do[st], &bar_do_ready[st], par, tq + kQT, kQT,
                         c);
        }
      }
    }
    if (threadIdx.x == 0) {
      int ring = 0, round = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
        const Item w = dkv_item_of(i, p);
        const int k0 = w.qi * kBlockN;
        const int first = p.causal ? k0 / kBlockQ : 0;
        const int n_tiles = p.S / kBlockQ - first;
        const int64_t bh = (static_cast<int64_t>(w.b) * p.H + w.h) * p.S;
        mbar_wait(&bar_kv_free, (round & 1) ^ 1);
        mbar_expect_tx(&bar_kv, 2 * kK);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + s * kKVSlabBytes, &tm_k, &bar_kv, s * kSlab, k0,
                   w.h, w.b);
          tma_load(base + kK + s * kKVSlabBytes, &tm_v, &bar_kv, s * kSlab,
                   k0, w.h, w.b);
        }
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int st = ring % kStages;
          const int qs = (first + it) * kBlockQ;
          mbar_wait(&bar_free[st], ((ring / kStages) & 1) ^ 1);
          const uint32_t sqt = base + 2 * kK + 2 * st * kQT, sdo = sqt + kQT;
          const uint32_t stats = base + L::kStats + 2 * st * L::kStatBytes;
          mbar_expect_tx(&bar_q[st], kQT + L::kStatBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sqt + s * kQTSlabBytes, &tm_q, &bar_q[st], s * kSlab, qs,
                     w.h, w.b);
          bulk_load(stats, p.lse + bh + qs, L::kStatBytes, &bar_q[st]);
          mbar_expect_tx(&bar_do[st], kQT + L::kStatBytes);
#pragma unroll
          for (int s = 0; s < kSlabs; ++s)
            tma_load(sdo + s * kQTSlabBytes, &tm_do, &bar_do[st], s * kSlab,
                     qs, w.h, w.b);
          bulk_load(stats + L::kStatBytes, p.delta + bh + qs, L::kStatBytes,
                    &bar_do[st]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // keys r0 and r0 + 8 of the warpgroup's 64
  const float sl2 = p.scale * kLog2e;
  const uint32_t sk = base + cw * 64 * 64;  // 64 keys of 64 bytes a slab
  const uint32_t sv = sk + kK;

  int ring = 0, round = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++round) {
    const Item w = dkv_item_of(i, p);
    const int k0 = w.qi * kBlockN;
    const int first = p.causal ? k0 / kBlockQ : 0;
    const int n_tiles = p.S / kBlockQ - first;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;

    tile_wait(&bar_kv, &bar_kv_ready, round & 1, p.in_f16);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const int qs = (first + it) * kBlockQ;
      const uint32_t sqt = base + 2 * kK + 2 * st * kQT, sdo = sqt + kQT;
      const float* lse = reinterpret_cast<const float*>(
          gbase + L::kStats + 2 * st * L::kStatBytes);
      const float* dlt = lse + kBlockQ;
      // causal: c0 is the tile's first query less the warpgroup's first
      // key; every query is before every key (P^T = 0, skipped), or some
      // are (the diagonal, masked)
      const int c0 = qs - (k0 + 64 * cw);
      const bool skip = p.causal && c0 + kBlockQ <= 0;
      const bool diag = p.causal && c0 < 64;

      tile_wait(&bar_q[st], &bar_q_ready[st], par, p.in_f16);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T
        float s[kBlockQ / 2], dp[kBlockQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t kb = (kk & 1) * 32;
          wgmma_ss_n64(s,
                       desc_sw64(sk + (kk >> 1) * kKVSlabBytes + kb, 16, 512),
                       desc_sw64(sqt + (kk >> 1) * kQTSlabBytes + kb, 16, 512),
                       kk > 0);
        }
        wgmma_commit();
        tile_wait(&bar_do[st], &bar_do_ready[st], par, p.in_f16);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t kb = (kk & 1) * 32;
          wgmma_ss_n64(dp,
                       desc_sw64(sv + (kk >> 1) * kKVSlabBytes + kb, 16, 512),
                       desc_sw64(sdo + (kk >> 1) * kQTSlabBytes + kb, 16, 512),
                       kk > 0);
        }
        wgmma_commit();

        // P^T and dS^T = P^T o (dP^T - delta) in one pass once both
        // products are done, each rounded to bf16 as the A operand of its
        // product: pa[kk][e] and da[kk][e] hold key half e & 1, queries
        // col = 16 kk + 8 (e >> 1) + 2 t and + 1.  LSE and delta are per
        // column (query) here.
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        uint32_t pa[kBlockQ / 16][4], da[kBlockQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBlockQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 8 * kk + 2 * e;
            const int r = r0 + 8 * (e & 1);
            const int col = 16 * kk + 8 * (e >> 1) + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
            const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
            const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
            float pr[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              pr[h] = diag && c0 + col + h < r
                          ? 0.f
                          : exp2_ftz(fmaf(s[x + h], sl2, -lse2[h]));
            pa[kk][e] = pack_f32(pr[0], pr[1]);
            da[kk][e] = pack_f32(pr[0] * (dp[x] - d2.x),
                                 pr[1] * (dp[x + 1] - d2.y));
          }
        // dV += P^T dO and dK += dS^T Q, dO and Q MN-major, 16 queries
        // (1024 bytes) a step, in one group
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockQ / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk],
                      desc_sw64(sdo + kk * 1024, kQTSlabBytes, 512));
#pragma unroll
        for (int kk = 0; kk < kBlockQ / 16; ++kk)
          wgmma_rs<D>(dk, da[kk],
                      desc_sw64(sqt + kk * 1024, kQTSlabBytes, 512));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
      } else {
        // the stage's loads land, and are rounded, before it frees
        tile_wait(&bar_do[st], &bar_do_ready[st], par, p.in_f16);
      }
      if (lane == 0) {
        if (it == n_tiles - 1) mbar_arrive(&bar_kv_free);
        mbar_arrive(&bar_free[st]);
      }
    }

    // epilogue: dK scaled once, dV as it is, out through shared memory
    unsigned char* stage_k = gbase + L::kStaging + 2 * cw * Stage<D>::kBytes;
    unsigned char* stage_v = stage_k + Stage<D>::kBytes;
    wg_sync(cw);
    stage_acc<D>(stage_k, dk, p.out_f16,
                 [&](float x, int) { return x * p.scale; });
    stage_acc<D>(stage_v, dv, p.out_f16, [](float x, int) { return x; });
    wg_sync(cw);
    const int64_t off = w.b * p.o_sb + w.h * p.o_sh + (k0 + 64 * cw) * p.o_ss;
    flush_stage<D>(stage_k, static_cast<uint16_t*>(p.out) + off, p.o_ss);
    flush_stage<D>(stage_v, static_cast<uint16_t*>(p.out2) + off, p.o_ss);
  }
}

template <int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  if (p.S % kBlockM != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_view(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p, D, kBlockM) ||
      !encode_view(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p, D, kBlockN) ||
      !encode_view(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p, D, kBlockN))
    return cudaErrorInvalidValue;
  return launch_persistent<flash_fwd_wgmma_kernel<D>>(
      Smem<D>::kBytes, p.S / kBlockM * p.B * p.H, stream, tq, tk, tv, p);
}

// K2 (dkv false) and K3: maps over q, k, v and dO in any strides TMA
// takes; K3 reads q and dO in 64-row boxes and the LSE and delta slices
// by bulk copies, which need 16-byte aligned rows.
template <int D>
cudaError_t launch_bwd(bool dkv, const Params& p, cudaStream_t stream) {
  if (p.S % kBlockM != 0) return cudaErrorInvalidValue;
  const int rows = dkv ? kBlockQ : kBlockM;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_view(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p, D, rows) ||
      !encode_view(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p, D, kBlockN) ||
      !encode_view(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p, D, kBlockN) ||
      !encode_view(&tdo, p.dout, p.do_sb, p.do_sh, p.do_ss, p, D, rows))
    return cudaErrorInvalidValue;
  const int n_items = p.S / kBlockM * p.B * p.H;
  if (!dkv && p.in_f16)
    return launch_persistent<flash_bwd_dq_wgmma_kernel<D, true>>(
        DqSmem<D>::kBytes, n_items, stream, tq, tk, tv, tdo, p);
  if (!dkv)
    return launch_persistent<flash_bwd_dq_wgmma_kernel<D, false>>(
        DqSmem<D>::kBytes, n_items, stream, tq, tk, tv, tdo, p);
  if ((reinterpret_cast<uintptr_t>(p.lse) |
       reinterpret_cast<uintptr_t>(p.delta)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  return launch_persistent<flash_bwd_dkv_wgmma_kernel<D>>(
      DkvSmem<D>::kBytes, n_items, stream, tq, tk, tv, tdo, p);
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum Kind { kFwd, kDq, kDkv };

template <int D>
size_t smem_bytes(Kind kind) {
  switch (kind) {
    case kFwd: return hopper::Smem<D>::kBytes;
    case kDq: return hopper::DqSmem<D>::kBytes;
    default: return hopper::DkvSmem<D>::kBytes;
  }
}

template <int D>
cudaError_t launch_typed(Kind kind, const Params& p, cudaStream_t stream) {
  if (kind == kFwd) return hopper::launch_fwd<D>(p, stream);
  return hopper::launch_bwd<D>(kind == kDkv, p, stream);
}

// dtype: 1 bf16; 2 fp16 outputs from bf16 operands (Params::out_f16: the
// caller rounded the fp16 operands); 3 fp16 operands, rounded to bf16 in
// shared memory (Params::in_f16), and fp16 outputs.  fp32, and the other
// head dims, are flash_attention_mma.cu's.
bool takes(int dtype) { return dtype >= 1 && dtype <= 3; }

int launch(Kind kind, Params p, int D, int dtype, void* stream) {
  if (p.S % 128 != 0 || p.S <= 0 || p.B * p.H < 1 || p.B * p.H > 65535 ||
      !takes(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.out_f16 = dtype >= 2;
  p.in_f16 = dtype == 3;
  switch (D) {
    case 64: return static_cast<int>(launch_typed<64>(kind, p, s));
    case 96: return static_cast<int>(launch_typed<96>(kind, p, s));
    case 128: return static_cast<int>(launch_typed<128>(kind, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// dtype as launch() takes it; -1 for a head dim or type not built here.
long long flash_attention_smem_bytes(int kind, int D, int dtype) {
  const Kind k = kind == 0 ? kFwd : (kind == 1 ? kDq : kDkv);
  if (!takes(dtype)) return -1;
  switch (D) {
    case 64: return smem_bytes<64>(k);
    case 96: return smem_bytes<96>(k);
    case 128: return smem_bytes<128>(k);
    default: return -1;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
