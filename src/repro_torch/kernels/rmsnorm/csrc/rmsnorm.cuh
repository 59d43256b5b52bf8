// Fused RMSNorm on Hopper.
//
//   out[n, :] = x[n, :] * rsqrt(mean(x[n, :]^2) + eps) * w      x: (N, d)
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas` (`_rms_kernel`,
// src/repro/kernels/rmsnorm/rmsnorm.py). It computes what that kernel
// computes, row for row: statistics in fp32, the output in x's type
// (float or bfloat16), the product taken as (x * r) * w.
//
//   * ROWS (`block_rows`, the template parameter) rows per block, as the
//     Pallas grid gives `block_rows` rows to each program. Rows past N are
//     masked in the kernel: decode calls it with N = batch = 4 whatever
//     the instantiation, where the TPU kernel clamps `rows = min(block_rows,
//     N)` on the host.
//   * One warp per row at a time (ROWS * 32 threads, at most 1024, so
//     ROWS >= 32 gives each warp ROWS / 32 rows). A row streams through the
//     warp in two passes: the sum of squares (fp32, reduced with warp
//     shuffles), then the scaled product. The second pass reads the row
//     again, from L1/L2. Nothing is staged in shared memory and the
//     registers a thread holds do not grow with d: the TPU kernel keeps
//     the whole (rows, d) block resident, which at d = 4096 and
//     block_rows = 8 is already 256 kB and would not fit a Hopper block.
//   * `lookahead` is inert.
//
// What bounds it on an H100: 2 * N * d elements moved against ~4 * N * d
// operations, so it is memory-bound (3.35 TB/s). The design keeps every
// access coalesced (a warp reads 32 consecutive elements, 16-byte vectors
// for fp32 rows whose length and address allow it), and the second read
// of each row is meant to hit the cache. The block count is N / ROWS: a
// large `block_rows` at small N leaves SMs idle, which is the trade-off
// the tuner explores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace rmsnorm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int ROWS>
struct Shape {
  static constexpr int kThreads = ROWS * 32 < 1024 ? ROWS * 32 : 1024;
  static constexpr int kWarps = kThreads / 32;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int ROWS, typename T>
__global__ void __launch_bounds__(Shape<ROWS>::kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int N, int d, float eps, int vec4) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  vec4 = vec4 && sizeof(T) == sizeof(float);
  for (int r = warp; r < ROWS; r += Shape<ROWS>::kWarps) {
    const long long row = (long long)blockIdx.x * ROWS + r;
    if (row >= N) break;
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float ss = 0.f;
    if (vec4) {
      // fp32 only (the wrapper sets vec4 for float rows of d % 4 == 0 on
      // 16-byte aligned pointers)
      const float4* xv = reinterpret_cast<const float4*>(xr);
      for (int j = lane; j < d / 4; j += 32) {
        const float4 v = xv[j];
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float v = to_f32(xr[j]);
        ss = fmaf(v, v, ss);
      }
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)d + eps);
    if (vec4) {
      const float4* xv = reinterpret_cast<const float4*>(xr);
      const float4* wv = reinterpret_cast<const float4*>(w);
      float4* ov = reinterpret_cast<float4*>(orow);
      for (int j = lane; j < d / 4; j += 32) {
        const float4 v = xv[j], s = wv[j];
        ov[j] = make_float4(v.x * inv * s.x, v.y * inv * s.y, v.z * inv * s.z,
                            v.w * inv * s.w);
      }
    } else {
      for (int j = lane; j < d; j += 32)
        orow[j] = from_f32<T>(to_f32(xr[j]) * inv * to_f32(w[j]));
    }
  }
}

// Host launcher: on `stream`, allocates nothing, does not synchronise;
// returns the launch status, which the Python wrapper turns into an
// exception.
template <int ROWS, typename T>
int launch(const void* x, const void* w, void* out, int N, int d, float eps,
           int vec4, void* stream) {
  const long long blocks = ((long long)N + ROWS - 1) / ROWS;
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rmsnorm_kernel<ROWS, T><<<(unsigned)blocks, Shape<ROWS>::kThreads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), N,
      d, eps, vec4);
  return (int)cudaGetLastError();
}

}  // namespace rmsnorm

// One exported C symbol per instantiation:
//   int rmsnorm_r<ROWS>_<f32|bf16>(x, w, out, N, d, eps, vec4, stream)
#define RMSNORM_INSTANTIATE(ROWS, TAG, T)                                           \
  extern "C" int rmsnorm_r##ROWS##_##TAG(const void* x, const void* w, void* out,   \
                                         int N, int d, float eps, int vec4,         \
                                         void* stream) {                            \
    return rmsnorm::launch<ROWS, T>(x, w, out, N, d, eps, vec4, stream);            \
  }
