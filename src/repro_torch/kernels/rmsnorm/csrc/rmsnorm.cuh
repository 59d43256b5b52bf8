// Fused RMSNorm on Hopper.
//
//   out[n, :] = x[n, :] * rsqrt(mean(x[n, :]^2) + eps) * w      x: (N, d)
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas` (`_rms_kernel`,
// src/repro/kernels/rmsnorm/rmsnorm.py). It computes what that kernel
// computes, row for row: statistics in fp32, the output in x's type
// (float or bfloat16), the product taken as (x * r) * w. The TPU kernel
// keeps a whole (block_rows, d) block resident in VMEM; at d = 4096 and
// block_rows = 8 that is already 256 kB, more than a Hopper block has.
//
// What bounds it on an H100: 2 * N * d elements moved against ~4 * N * d
// operations, so it is memory-bound (3.35 TB/s): the only gains are to
// read each element from device memory once and to keep enough bytes in
// flight on every SM. The design:
//
//   * One read from global memory per element. A block stages its rows
//     one at a time into a ring of `lookahead + 1` shared-memory row
//     buffers by cp.async (16-byte copies where the row's bytes and the
//     base allow it; 4-byte copies for other fp32 rows; plain loads for
//     other bf16 rows, since cp.async has no 2-byte copy). The sum of
//     squares and the scaled product both read the staged row, never
//     device memory again. The weight is staged once per block. Staging
//     in shared memory, not registers, keeps any d: a thread's share of a
//     row is not bounded at compile time.
//   * `lookahead` is the ring's depth: while the block reduces and scales
//     one row, the copies of the next `lookahead` rows are in flight
//     (lookahead 0: none, every row waits for its own copy). Each depth is
//     its own kernel (template parameter LA), picked by the launcher, so
//     wait_group's count is a compile-time constant.
//   * A grid that fills the card at both serving shapes. `block_rows`
//     (ROWS) bounds the rows one block holds: the grid is
//     max(ceil(N / ROWS), min(N, R)) blocks, R the blocks the card holds
//     resident at once (SMs x blocks an SM, from the occupancy API, which
//     shared memory sets: at d = 4096 fp32 and lookahead 1, 4 an SM), rows
//     dealt out evenly (each block takes floor or ceil of N / grid). Every
//     point then fills the card, and several blocks an SM keep more rows
//     in flight than one block's ring does (one block an SM measured
//     slower on the card). The price is that block_rows values coincide
//     where ceil(N / ROWS) <= min(N, R): on an H100 at (2048, 4096) every
//     option gives the same R blocks of 3-5 rows, and at decode's
//     (4, 4096) 4 blocks of one row, so the knob is inert at both serving
//     shapes and tells points apart only past N = 8 R rows. One row is
//     spread over a whole block of 256 threads, and every thread issues
//     all its copies before the reduction waits.
//   * 16-byte accesses (4 fp32 or 8 bf16) from shared memory always (the
//     ring's rows start 16-byte aligned and are zero-padded to 16 bytes),
//     and to device memory where the row allows. The reduction is warp
//     shuffles, then one shared-memory step across the block's 8 warps.
//
// Shared memory per block: (lookahead + 2) row buffers of d elements
// rounded up to 16 bytes (the ring and the weight), plus 8 floats
// (rmsnorm/rmsnorm.py `smem_bytes`, which the tuning space's Hopper rule
// counts).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace rmsnorm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// 16 bytes of T <-> floats: 4 fp32, or 8 bf16 (element 2i in the low half
// of word i, as memory holds them)
__device__ __forceinline__ void load16(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store16(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float v[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (uint32_t)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(v[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// one element of a row that is not copied 16 bytes at a time: fp32 by a
// 4-byte cp.async (zero past the row), bf16 by a plain load
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool in) {
  sm90::cp_async4(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool in) {
  *dst = in ? *src : from_f32<__nv_bfloat16>(0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// elements of one staged row buffer: d rounded up to 16 bytes
template <typename T>
__host__ __device__ constexpr long long row_elems(int d) {
  return ((long long)d * sizeof(T) + 15) / 16 * (16 / sizeof(T));
}

// shared memory of one block at ring depth LA, in bytes
template <int LA, typename T>
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return (size_t)(LA + 2) * row_elems<T>(d) * sizeof(T) + kWarps * sizeof(float);
}

template <int LA, typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int N, int d, int grid, float eps) {
  constexpr int kVE = 16 / sizeof(T);       // elements in 16 bytes
  constexpr int stages = LA + 1;
  extern __shared__ __align__(16) float smem[];
  const int ld = (int)row_elems<T>(d);
  T* ws = reinterpret_cast<T*>(smem);       // the weight
  T* ring = ws + ld;                        // [stages][ld]
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * ld);  // [kWarps]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // this block's rows: [r0, r0 + rows), dealt out evenly over the grid
  const long long r0 = (long long)blockIdx.x * N / grid;
  const int rows = (int)((long long)(blockIdx.x + 1) * N / grid - r0);
  const bool vec = ((long long)d * sizeof(T)) % 16 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)w & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const int nv = ld / kVE;                  // 16-byte pieces of a staged row

  auto stage = [&](const T* src, T* dst) {
    if (vec) {
      for (int v = tid; v < nv; v += kThreads)
        sm90::cp_async16(dst + v * kVE, src + (size_t)v * kVE, 16);
    } else {
      for (int j = tid; j < ld; j += kThreads) copy_elem(dst + j, j < d ? src + j : src, j < d);
    }
  };
  auto row_of = [&](int i) { return x + (size_t)(r0 + i) * d; };

  stage(w, ws);
  sm90::cp_async_commit();
  for (int s = 0; s < LA; ++s) {
    if (s < rows) stage(row_of(s), ring + (size_t)s * ld);
    sm90::cp_async_commit();
  }

#pragma unroll 1
  for (int i = 0; i < rows; ++i) {
    if constexpr (LA == 0) {
      __syncthreads();  // every thread is done with the only row buffer
      stage(row_of(i), ring);
      sm90::cp_async_commit();
    }
    sm90::cp_async_wait(LA == 0 ? 0 : LA - 1);
    __syncthreads();  // row i has landed; the buffer of row i - 1 is free
    if constexpr (LA > 0) {
      if (i + LA < rows) stage(row_of(i + LA), ring + (size_t)((i + LA) % stages) * ld);
      sm90::cp_async_commit();
    }

    const T* xs = ring + (size_t)(i % stages) * ld;
    float ss = 0.f;
    for (int v = tid; v < nv; v += kThreads) {
      float e[kVE];
      load16(xs + v * kVE, e);
#pragma unroll
      for (int k = 0; k < kVE; ++k) ss = fmaf(e[k], e[k], ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += red[k];
    const float inv = rsqrtf(total / (float)d + eps);

    T* orow = out + (size_t)(r0 + i) * d;
    if (vec) {
      for (int v = tid; v < nv; v += kThreads) {
        float e[kVE], s[kVE];
        load16(xs + v * kVE, e);
        load16(ws + v * kVE, s);
#pragma unroll
        for (int k = 0; k < kVE; ++k) e[k] = e[k] * inv * s[k];
        store16(orow + (size_t)v * kVE, e);
      }
    } else {
      for (int j = tid; j < d; j += kThreads)
        orow[j] = from_f32<T>(to_f32(xs[j]) * inv * to_f32(ws[j]));
    }
  }
  sm90::cp_async_wait(0);  // nothing in flight when the block exits
}

// Host launcher: on `stream`, allocates nothing, does not synchronise;
// returns the launch status, which the Python wrapper turns into an
// exception. `sms` is the card's SM count.
template <int ROWS, int LA, typename T>
int launch_depth(const void* x, const void* w, void* out, int N, int d, float eps, int sms,
                 void* stream) {
  auto kernel = rmsnorm_kernel<LA, T>;
  const size_t smem = smem_bytes<LA, T>(d);
  // above 48 KB, dynamic shared memory must be opted in to; the attribute
  // belongs to the current device, so it is set on every such launch
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  // blocks resident on one SM at this footprint, asked again only when
  // the footprint changes (decode's host time is the serving path's limit)
  static size_t asked_smem = 0;
  static int per_sm = 0;
  if (smem != asked_smem) {
    const cudaError_t occ =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (occ != cudaSuccess) return (int)occ;
    asked_smem = smem;
  }
  const long long by_rows = ((long long)N + ROWS - 1) / ROWS;
  const long long resident = (long long)sms * (per_sm > 1 ? per_sm : 1);
  const long long least = N < resident ? N : resident;
  const long long grid = by_rows > least ? by_rows : least;
  if (grid <= 0) return (int)cudaSuccess;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), N, d,
      (int)grid, eps);
  return (int)cudaGetLastError();
}

template <int ROWS, typename T>
int launch(const void* x, const void* w, void* out, int N, int d, float eps, int lookahead,
           int sms, void* stream) {
  switch (lookahead) {
    case 0: return launch_depth<ROWS, 0, T>(x, w, out, N, d, eps, sms, stream);
    case 1: return launch_depth<ROWS, 1, T>(x, w, out, N, d, eps, sms, stream);
    case 2: return launch_depth<ROWS, 2, T>(x, w, out, N, d, eps, sms, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rmsnorm

// One exported C symbol per instantiation:
//   int rmsnorm_r<ROWS>_<f32|bf16>(x, w, out, N, d, eps, lookahead, sms, stream)
// and its shared-memory footprint, `long long rmsnorm_r<ROWS>_<tag>_smem(d,
// lookahead)`.
#define RMSNORM_INSTANTIATE(ROWS, TAG, T)                                              \
  extern "C" int rmsnorm_r##ROWS##_##TAG(const void* x, const void* w, void* out,      \
                                         int N, int d, float eps, int lookahead,       \
                                         int sms, void* stream) {                      \
    return rmsnorm::launch<ROWS, T>(x, w, out, N, d, eps, lookahead, sms, stream);     \
  }                                                                                    \
  extern "C" long long rmsnorm_r##ROWS##_##TAG##_smem(int d, int lookahead) {          \
    switch (lookahead) {                                                               \
      case 0: return (long long)rmsnorm::smem_bytes<0, T>(d);                          \
      case 1: return (long long)rmsnorm::smem_bytes<1, T>(d);                          \
      case 2: return (long long)rmsnorm::smem_bytes<2, T>(d);                          \
      default: return -1;                                                              \
    }                                                                                  \
  }
