// Flash attention forward, dQ and dK/dV for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/kernels/flash_attention.py
// at head dims 64, 96 and 128 (GPT-3 125M's, 760M's and 1.3B's) in bf16
// and fp16:
//   K1 _fwd_kernel     (via _flash_fwd)  -> hopper::flash_fwd_wgmma_kernel
//   K2 _bwd_dq_kernel  (via _flash_bwd)  -> hopper::flash_bwd_dq_wgmma_kernel
//   K3 _bwd_dkv_kernel (via _flash_bwd)  -> hopper::flash_bwd_dkv_wgmma_kernel
// fp32 at every head dim, and bf16/fp16 at the other multiples of 16 up to
// 256, are flash_attention_mma.cu's simpler kernels.
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
// P^T.dO, dS before dS.K and dS^T.Q.  fp16 inputs run the bf16 kernels:
// the wrapper rounds Q, K, V and dO to bf16 (what _dot_f32 does to a
// 2-byte operand) and the epilogues write O, dQ, dK and dV as fp16
// straight from the fp32 accumulators (Params::out_f16), never through a
// bf16 value.  dQ and dK are scaled once at the end instead of per tile
// (equal up to fp32 rounding).  Nothing crosses CTAs and every sum runs in a
// fixed order: no atomics, and two runs give the same bits.  K2 and K3
// keep the TPU's split of dQ from dK/dV for that reason.
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
//   registers from the producer (24) to them (240).
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

#include <cfloat>
#include <cstdint>

#include <cuda.h>  // CUtensorMap types; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

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
  int out_f16;         // bf16 kernels: write O, dQ, dK, dV as fp16
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: the Hopper kernels (TMA, mbarriers, wgmma, warp-specialised)
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kBlockM = 128;  // query rows a CTA owns: two warpgroups of 64
constexpr int kBlockN = 128;  // keys a K/V tile holds
constexpr int kSlab = 32;     // head dims of one 64-byte swizzled slab
constexpr int kQSlabBytes = kBlockM * kSlab * 2;   // 128 rows x 64 bytes
constexpr int kKVSlabBytes = kBlockN * kSlab * 2;
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;  // each frees a stage once it is done
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kBlockQ = 64;   // queries a Q/dO tile of K3 holds
constexpr int kQTSlabBytes = kBlockQ * kSlab * 2;  // 64 rows x 64 bytes

// A warpgroup's 64 output rows of D bf16 on their way out: written from
// the accumulator layout (4-byte pieces, 8 rows apart) and read back as
// whole 16-byte vectors.  Rows of D 64 and 128 (8 or 16 vectors) are
// unpadded, with the vector index XORed by row % 8; D 96 rows (12
// vectors) are padded by one.  Either way the 8 rows a quad-strided
// write touches sit in distinct banks.
template <int D>
struct Stage {
  static constexpr bool kXor = D % 64 == 0;
  static constexpr int kPitch = kXor ? 2 * D : 2 * D + 16;
  static constexpr int kBytes = 64 * kPitch;
  static __device__ __forceinline__ int at(int row, int vec) {
    return row * kPitch + 16 * (kXor ? vec ^ (row & 7) : vec);
  }
};

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

// 2^x in one MUFU op, results below 2^-126 flushed to 0: exp2f's
// handling of subnormal results cost K2's and K3's consumers, which are
// short of issue slots, a tenth to a sixth of their time.  A P that small
// adds nothing to an fp32 sum of the products it enters.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.  A wait
// that outlasts 2^24 polls (seconds; a real one lasts microseconds) traps,
// so a broken pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a (D, S, H, B) tensor map into shared memory at dst,
// completing on bar's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(bar)), "r"(d),
      "r"(s), "r"(h), "r"(b)
      : "memory");
}

// A 1-d bulk copy of `bytes` (a multiple of 16) from global src to
// shared dst, both 16-byte aligned, completing on bar's transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for A operands held in registers: they stay live, and in
// place, until the product that reads them is known to be done.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// A wgmma shared-memory descriptor over a 64-byte-swizzled layout (type 2
// in bits 62-63): start address, leading and stride byte offsets, all in
// 16-byte units.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 2ull << 62;
}

// d[64 x 128] (+)= A . B^T: A and B K-major in shared memory, named by
// their descriptors; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A . B^T: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A . B: A in registers (bf16 pairs, the mma.sync A
// layout per warp), B MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 96] += A . B: A in registers (bf16 pairs, the mma.sync A
// layout per warp), B MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A . B: A in registers (bf16 pairs, the mma.sync A
// layout per warp), B MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 96) wgmma_rs_n96(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Named barrier of consumer warpgroup cw's 128 threads.
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

// Two fp32 values as the 4 bytes of an output pair: bf16, or fp16 for
// the fp16 instances (whose operands the wrapper rounded to bf16, as the
// TPU kernel's _dot_f32 does): either way rounded once, from fp32.
__device__ __forceinline__ uint32_t pack2(float a, float b, bool f16) {
  uint32_t bits;
  if (f16) {
    const __half2 h = __floats2half2_rn(a, b);
    memcpy(&bits, &h, 4);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    memcpy(&bits, &h, 4);
  }
  return bits;
}

// Write this warpgroup's 64 x D accumulator acc into its staging rows as
// f(x, half) in the output type (fp16 if f16, else bf16), half 1 for the
// rows 8 below the thread's first.
template <int D, typename F>
__device__ __forceinline__ void stage_acc(unsigned char* stage,
                                          const float (&acc)[D / 2],
                                          bool f16, F f) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + Stage<D>::at(row, j) + 4 * t) =
        pack2(f(acc[4 * j], 0), f(acc[4 * j + 1], 0), f16);
    *reinterpret_cast<uint32_t*>(stage + Stage<D>::at(row + 8, j) + 4 * t) =
        pack2(f(acc[4 * j + 2], 1), f(acc[4 * j + 3], 1), f16);
  }
}

// Copy the 64 staged rows of 2-byte values to out (row stride ss
// elements) in 16-byte vectors, the warpgroup's threads on consecutive
// vectors.
template <int D>
__device__ __forceinline__ void flush_stage(const unsigned char* stage,
                                            void* out_, int64_t ss) {
  uint16_t* out = static_cast<uint16_t*>(out_);
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x & 127; i < 64 * kVecs; i += 128) {
    const int row = i / kVecs, c = i % kVecs;
    *reinterpret_cast<uint4*>(out + row * ss + 8 * c) =
        *reinterpret_cast<const uint4*>(stage + Stage<D>::at(row, c));
  }
}

// Work item i of a launch: query tile qi of (batch, head) bh.  Items run
// heaviest first: every (b, h)'s last query tile, then the one before...
struct Item {
  int qi, b, h;
};

__device__ __forceinline__ Item item_of(int i, const Params& p) {
  const int n_bh = p.B * p.H;
  const int qi = p.S / kBlockM - 1 - i / n_bh;
  const int bh = i % n_bh;
  return {qi, bh / p.H, bh % p.H};
}

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
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
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
    // producer: one thread issues every TMA load, for item after item;
    // an item's tiles go from the diagonal (the only masked one) down to
    // key 0.  `ring` counts K/V tiles over the CTA's whole life.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
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

    mbar_wait(&bar_q, round & 1);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sk = base + kQBytes + 2 * st * kKV, sv = sk + kKV;
      const int k0 = (n_tiles - 1 - it) * kBlockN;

      // S = Q K^T: D/16 steps of 16 dims, two per 64-byte slab row
      float s[kBlockN / 2];
      mbar_wait(&bar_k[st], par);
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
      mbar_wait(&bar_v[st], par);
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
// K2, bf16: dQ on the same machinery
// ---------------------------------------------------------------------------
// A persistent CTA walks items (128-row query tile, b, h), heaviest causal
// tiles first (item_of).  The producer loads the item's Q and dO tiles
// once, then streams 128-key K and V tiles through the ring, diagonal
// tile first.  Each consumer warpgroup owns 64 query rows and runs three
// wgmma products a tile: S = Q K^T and dP = dO V^T (both operands K-major
// in shared memory), then dQ += dS K with dS from registers and the K
// tile read as a transposed (MN-major) B, as K1 reads V.
template <int D>
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
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
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

    mbar_wait(&bar_q, round & 1);
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kStages;
      const int par = (ring / kStages) & 1;
      const uint32_t sk = base + 2 * kQBytes + 2 * st * kKV, sv = sk + kKV;
      const int k0 = (n_tiles - 1 - it) * kBlockN;

      // S = Q K^T and dP = dO V^T
      float s[kBlockN / 2], dp[kBlockN / 2];
      mbar_wait(&bar_k[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kb = (kk & 1) * 32;
        wgmma_ss_n128(s, desc_sw64(sq + (kk >> 1) * kQSlabBytes + kb, 16, 512),
                      desc_sw64(sk + (kk >> 1) * kKVSlabBytes + kb, 16, 512),
                      kk > 0);
      }
      wgmma_commit();
      mbar_wait(&bar_v[st], par);
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
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int n_items = p.S / kBlockN * p.B * p.H;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    mbar_init(&bar_kv_free, kConsumerWarps);
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

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
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

    mbar_wait(&bar_kv, round & 1);
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

      mbar_wait(&bar_q[st], par);
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
        mbar_wait(&bar_do[st], par);
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
        mbar_wait(&bar_do[st], par);  // the stage's loads land before it frees
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

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                            cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (D, S, H, B) tensor map over a strided [B, H, S, D] bf16 view with a
// contiguous head dim, boxes of 32 dims x 128 rows, 64-byte swizzle.
bool encode_view(CUtensorMap* tm, const void* ptr, int64_t sb, int64_t sh,
                 int64_t ss, const Params& p, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(p.S),
                              static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kSlab, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise kernel's dynamic shared memory limit to smem bytes and read the
// card's SM count: once per kernel and process (one card a process).
template <auto kernel>
cudaError_t prepare(int smem, int* sms) {
  static int count = 0;
  if (count == 0) {
    int device = 0, n = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    count = n;
  }
  *sms = count;
  return cudaSuccess;
}

// Persistent: one CTA an SM, no more than there are items, walks them.
template <auto kernel, typename... Args>
cudaError_t launch_persistent(int smem, int n_items, cudaStream_t stream,
                              const Args&... args) {
  int sms = 0;
  const cudaError_t err = prepare<kernel>(smem, &sms);
  if (err != cudaSuccess) return err;
  kernel<<<n_items < sms ? n_items : sms, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
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
  if (!dkv)
    return launch_persistent<flash_bwd_dq_wgmma_kernel<D>>(
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

// dtype: 1 bf16; 2 fp16 outputs from bf16 operands (Params::out_f16).
// fp32, and the other head dims, are flash_attention_mma.cu's.
int launch(Kind kind, Params p, int D, int dtype, void* stream) {
  if (p.S % 128 != 0 || p.S <= 0 || p.B * p.H < 1 || p.B * p.H > 65535 ||
      dtype < 1 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.out_f16 = dtype == 2;
  switch (D) {
    case 64: return static_cast<int>(launch_typed<64>(kind, p, s));
    case 96: return static_cast<int>(launch_typed<96>(kind, p, s));
    case 128: return static_cast<int>(launch_typed<128>(kind, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// dtype as launch() takes it; -1 for a head dim or type not built here.
long long flash_attention_smem_bytes(int kind, int D, int dtype) {
  const Kind k = kind == 0 ? kFwd : (kind == 1 ? kDq : kDkv);
  if (dtype < 1 || dtype > 2) return -1;
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
