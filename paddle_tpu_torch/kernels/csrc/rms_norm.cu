// RMSNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/rms_norm.py::_rms_kernel (the Pallas kernel
// behind rms_norm).
//
// What it computes, row by row of x [rows, H] with w [H]:
//   n = (x * rsqrt(mean(x^2) + eps)) in fp32, rounded to x's type;
//   y = n * w, in x's type when w is as narrow as x (bf16 * bf16), in
//   fp32 when x is fp32 (w fp32 or bf16).
// The wrapper refuses a w wider than x (x bf16, w fp32), which the TPU
// kernel cannot store either.
//
// What bounds it on this card: memory bandwidth.  It reads x and w once
// and writes y once, with three flops an element: rows * H * 2 *
// itemsize bytes (w is read once per CTA from L2).
//
// Design:
// * A group of kRowThreads threads owns one row: a warp (kRowThreads 32,
//   8 rows a CTA) for H <= 1024, the whole CTA of 256 threads above, so
//   every lane has at least a few vectors of work.
// * Threads read 16-byte vectors (8 bf16 or 4 fp32) with neighbouring
//   threads on neighbouring vectors; when H is not a multiple of the
//   vector width, or a pointer is not 16-byte aligned, every element is
//   read on its own (rows then start at unaligned addresses).
// * The sum of squares is fp32: each thread's strided partial sum, a
//   butterfly shuffle inside the warp, then (a CTA per row) the warps'
//   sums through shared memory.  rsqrt is 1 / sqrtf, both correctly
//   rounded.
// * The second pass reads the row again: a row is at most a few KB and
//   was just read by the same threads, so it comes from L1 or L2, not
//   from device memory.
//
// Built by paddle_tpu_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements of T in one 16-byte vector.
template <typename T> constexpr int kVec = 16 / sizeof(T);

// y = n * w for one element, n already rounded to TX: bf16 * bf16 rounds
// the exact fp32 product to bf16 once; an fp32 x keeps the fp32 product.
template <typename TX, typename TW>
__device__ __forceinline__ TX scale_out(float v, float r, TW w) {
  const float n = to_float(from_float<TX>(v * r));
  return from_float<TX>(n * to_float(w));
}

template <typename TX, typename TW, int kRowThreads>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                TX* __restrict__ y, int rows, int H, float eps, bool vec) {
  constexpr int kRowsPerCta = kThreads / kRowThreads;
  constexpr int V = kVec<TX>;
  __shared__ float warp_sum[kThreads / 32];

  const int tid = threadIdx.x % kRowThreads;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerCta + threadIdx.x / kRowThreads;
  const bool live = row < rows;  // no early return: a CTA row syncs below
  const TX* xr = x + row * H;
  TX* yr = y + row * H;

  float ss = 0.f;
  if (live) {
    if (vec) {
      for (int c = tid * V; c < H; c += kRowThreads * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
        const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = to_float(e[i]);
          ss += v * v;
        }
      }
    } else {
      for (int c = tid; c < H; c += kRowThreads) {
        const float v = to_float(xr[c]);
        ss += v * v;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (kRowThreads > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_sum[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < kRowThreads / 32; ++i) ss += warp_sum[i];
  }
  if (!live) return;
  const float r = 1.f / sqrtf(ss / static_cast<float>(H) + eps);

  if (vec) {
    for (int c = tid * V; c < H; c += kRowThreads * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const TX* e = reinterpret_cast<const TX*>(&raw);
      uint4 packed;
      TX* o = reinterpret_cast<TX*>(&packed);
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = scale_out<TX, TW>(to_float(e[i]), r, w[c + i]);
      *reinterpret_cast<uint4*>(yr + c) = packed;
    }
  } else {
    for (int c = tid; c < H; c += kRowThreads)
      yr[c] = scale_out<TX, TW>(to_float(xr[c]), r, w[c]);
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int H,
                   float eps, bool vec, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (H <= 1024) {
    constexpr int kRows = kThreads / 32;
    rms_norm_kernel<TX, TW, 32>
        <<<(rows + kRows - 1) / kRows, kThreads, 0, stream>>>(xp, wp, yp, rows,
                                                             H, eps, vec);
  } else {
    rms_norm_kernel<TX, TW, kThreads>
        <<<rows, kThreads, 0, stream>>>(xp, wp, yp, rows, H, eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_bf16: 0 for float32 x (and y), 1 for bfloat16.  w_bf16: the same for
// w; the caller refuses x bf16 with w float32.  vec: H is a multiple of
// the 16-byte vector width of x and x, y are 16-byte aligned.  Returns
// the cudaError_t of the launch (0 on success).  The caller guarantees
// contiguous operands, 1 <= rows <= 2^31 - 1 and H >= 1.
int rms_norm_launch(const void* x, int x_bf16, const void* w, int w_bf16,
                    void* y, int rows, int H, float eps, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, H, eps, vec,
                                                 s);
  if (x_bf16) return cudaErrorInvalidValue;  // w wider than x
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, y, rows, H, eps, vec, s);
  return launch<float, float>(x, w, y, rows, H, eps, vec, s);
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
