// Shared pieces of the Hopper flash-attention kernels (sm_90a): the
// launch parameters, TMA loads and bulk copies under mbarriers, wgmma
// products and their shared-memory descriptors over 64-byte-swizzled
// 32-dim slabs, the rounding of landed fp16 tiles to bf16 in shared
// memory, the epilogue's staging through shared memory, the persistent
// launch and the tensor maps.  Included by flash_attention.cu
// (head dims 64/96/128) and flash_attention_d256.cu (head dim 256); each
// builds into its own library, so everything here has internal linkage.
//
// paddle_tpu_torch/kernels/_build.py keys a library's build by its source
// and every csrc/ header the source includes, so an edit here rebuilds
// both.

#pragma once

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
  int in_f16;          // q, k, v, dO are fp16: rounded to bf16 in shared
                       // memory by the producer warpgroup's converters
};

// Params of a launch, from the C entry points' leading arguments.
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

namespace hopper {

constexpr int kBlockM = 128;  // query rows of a K1/K2 item: 2 warpgroups of 64
constexpr int kSlab = 32;     // head dims of one 64-byte swizzled slab
constexpr int kThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;  // each frees a stage once it is done
constexpr float kLog2e = 1.4426950408889634f;

// A warpgroup's 64 output rows of D bf16 on their way out: written from
// the accumulator layout (4-byte pieces, 8 rows apart) and read back as
// whole 16-byte vectors (D 256 rows go out in parts of 64 or 128
// columns).  Rows of D 64 and 128 (8 or 16 vectors) are unpadded, with the vector index XORed by row % 8; D 96 rows (12
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

// d[64 x 32] (+)= A . B^T: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

// d[64 x 256] += A . B: A in registers (bf16 pairs, the mma.sync A
// layout per warp), B MN-major in shared memory (transposed B).  The
// accumulator is two n128 accumulators side by side: d[64 + i] is
// column 128 + (the column of d[i]).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// ---------------------------------------------------------------------------
// fp16 operands.  The products take both operands in bf16, as the TPU
// kernel's _dot_f32 rounds every 2-byte operand, so an fp16 operand is
// rounded once on its way in: TMA lands the fp16 tile (an fp16 tile has
// the bytes of its bf16 rounding), warps 1-3 of the producer warpgroup
// round it in place in shared memory, and the consumers wait on the
// tile's "ready" barrier as well as on its TMA barrier.  No extra byte
// crosses device memory.
// ---------------------------------------------------------------------------
constexpr int kConverters = 96;  // warps 1-3 of warpgroup 0

// Two fp16 values (one 32-bit word) as two bf16 values: widened to fp32
// exactly, then rounded to nearest even (cvt.rn.bf16x2.f32), as torch's
// and JAX's casts round.
__device__ __forceinline__ uint32_t f16x2_to_bf16x2(uint32_t bits) {
  __half2 h;
  memcpy(&h, &bits, 4);
  const float2 f = __half22float2(h);
  return pack_f32(f.x, f.y);
}

// Round `bytes` (a multiple of 16) of fp16 at shared address tile to
// bf16 in place, 16 bytes a converter thread c a step, neighbours on
// neighbouring vectors.  Elementwise and size-keeping, so the tile's
// swizzle does not matter.  (Two or four vectors in flight a thread
// measured the same on an H100 80GB HBM3.)
__device__ __forceinline__ void round_f16_tile(uint32_t tile, int bytes,
                                               int c) {
  for (int off = 16 * c; off < bytes; off += 16 * kConverters) {
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(tile + off)
                 : "memory");
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = f16x2_to_bf16x2(v[e]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     tile + off),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// Converter thread c's step for one tile the producer lands: wait for the
// phase `parity` of its TMA barrier, round it, order the writes before
// the async proxy's next accesses (the consumers' wgmma reads, the next
// TMA write into the stage), and arrive on its ready barrier (count
// kConverters).  The converters walk the producer's tiles in its order.
__device__ __forceinline__ void convert_landed(uint64_t* landed,
                                               uint64_t* ready, int parity,
                                               uint32_t tile, int bytes,
                                               int c) {
  mbar_wait(landed, parity);
  round_f16_tile(tile, bytes, c);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(ready);
}

// A consumer's wait for a tile: its TMA barrier (which also covers the
// fp32 bulk copies landing with it), and with fp16 operands its ready
// barrier.
__device__ __forceinline__ void tile_wait(uint64_t* landed, uint64_t* ready,
                                          int parity, bool f16) {
  mbar_wait(landed, parity);
  if (f16) mbar_wait(ready, parity);
}

// Named barrier of consumer warpgroup cw's 128 threads.
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

// Two fp32 values as the 4 bytes of an output pair: bf16, or fp16 for
// the fp16 instances (whose operands were rounded to bf16, as the TPU
// kernel's _dot_f32 does): either way rounded once, from fp32.
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

// Write D columns of this warpgroup's 64-row accumulator acc, from its
// element Off on (column 2 * Off: the whole of it, or one D-wide part of
// a wider one), into its staging rows as f(x, half) in the output type
// (fp16 if f16, else bf16), half 1 for the rows 8 below the thread's
// first.
template <int D, int Off = 0, int N, typename F>
__device__ __forceinline__ void stage_acc(unsigned char* stage,
                                          const float (&acc)[N], bool f16,
                                          F f) {
  static_assert(Off % 4 == 0 && Off + D / 2 <= N, "a part of acc");
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float* a = acc + Off + 4 * j;
    *reinterpret_cast<uint32_t*>(stage + Stage<D>::at(row, j) + 4 * t) =
        pack2(f(a[0], 0), f(a[1], 0), f16);
    *reinterpret_cast<uint32_t*>(stage + Stage<D>::at(row + 8, j) + 4 * t) =
        pack2(f(a[2], 1), f(a[3], 1), f16);
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

// A (D, S, H, B) tensor map over a strided [B, H, S, D] bf16 view (fp16
// if p.in_f16) with a contiguous head dim, boxes of 32 dims x `rows`
// rows, 64-byte swizzle.
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
  const CUtensorMapDataType type = p.in_f16
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(tm, type, 4, const_cast<void*>(ptr),
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

}  // namespace hopper
}  // namespace
