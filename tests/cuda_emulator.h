// Enough of CUDA, on the host, to run the port's hand kernels on the CPU
// (tests/test_torch_cuda_emulation.py): one std::thread per CUDA thread,
// blocks one after the other, a block-wide barrier for __syncthreads and
// a per-warp one for shuffles. __shared__ arrays become function-local
// statics (blocks never overlap), dynamic shared memory one buffer per
// launch. It checks indexing, masking and synchronization, not speed,
// and says nothing about what nvcc accepts or how the card schedules.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <algorithm>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x)
#define __restrict__
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
using std::min; using std::max;
inline float fmaxf(float a, float b) { return a > b ? a : b; }
inline float rsqrtf(float a) { return 1.f / std::sqrt(a); }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float expf(float a) { return std::exp(a); }
inline std::barrier<>* g_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
inline float g_shfl[1024];
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x, w = t / 32;
  g_shfl[t] = v;
  g_warp_barriers[w]->arrive_and_wait();
  const float r = g_shfl[t ^ off];
  g_warp_barriers[w]->arrive_and_wait();
  return r;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct __nv_bfloat16 { unsigned short v; };
inline float __bfloat162float(__nv_bfloat16 b) { unsigned u = (unsigned)b.v << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) { unsigned u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1); return {(unsigned short)(u >> 16)}; }
inline char* emu_dyn_smem;
inline void emu_launch(unsigned grid, unsigned block, size_t smem, std::function<void()> body) {
  std::vector<char> dyn(smem + 64);
  emu_dyn_smem = dyn.data();
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar((std::ptrdiff_t)block);
    g_block_barrier = &bar;
    g_warp_barriers.clear();
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      g_warp_barriers.emplace_back(new std::barrier<>((std::ptrdiff_t)std::min(32u, block - w * 32)));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = b; body(); });
    for (auto& th : ts) th.join();
  }
}
