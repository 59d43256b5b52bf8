// Enough of CUDA, on the host, to run the port's hand kernels on the CPU
// (tests/test_torch_cuda_emulation.py): one std::thread per CUDA thread,
// blocks one after the other, a block-wide barrier for __syncthreads and
// a per-warp one for shuffles. __shared__ arrays become function-local
// statics (blocks never overlap), dynamic shared memory one buffer per
// launch. It checks indexing, masking and synchronization, not speed,
// and says nothing about what nvcc accepts or how the card schedules.
//
// The Hopper primitives of src/repro_torch/kernels/_csrc/sm90.cuh have
// host versions here, in the same namespace: tf32_split rounds to
// nearest, ties away, on the low 13 mantissa bits, tf32_split_trunc
// clears them; pack_bf16x2 rounds to nearest even; the m16n8k8 (TF32)
// and m16n8k16 (bf16) products gather the warp's fragments through a
// per-warp exchange, in PTX's documented fragment layout, so a kernel's
// fragment indexing is really checked; cp.async copies (with zero-fill) are held per thread in commit
// groups and land when cp_async_wait retires their group, so a stage read
// before its wait reads stale data, as it may on the card.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
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
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x)
#define __restrict__
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
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
inline float __shfl_sync(unsigned, float v, int src) {
  const int t = threadIdx.x, w = t / 32;
  g_shfl[t] = v;
  g_warp_barriers[w]->arrive_and_wait();
  const float r = g_shfl[w * 32 + (src & 31)];
  g_warp_barriers[w]->arrive_and_wait();
  return r;
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline uint32_t g_mma_a[1024][4];
inline uint32_t g_mma_b[1024][2];
namespace sm90 {
inline uint32_t tf32_round(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return u;
}
inline void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}
inline void tf32_split_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}
inline void mma_tf32_m16n8k8(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  const int t = threadIdx.x, w = t / 32, base = w * 32, lane = t % 32;
  for (int i = 0; i < 4; ++i) g_mma_a[t][i] = a[i];
  for (int i = 0; i < 2; ++i) g_mma_b[t][i] = b[i];
  g_warp_barriers[w]->arrive_and_wait();
  // the tensor core reads the tf32 bits only
  auto f = [](uint32_t u) { return (double)__uint_as_float(u & 0xffffe000u); };
  double A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    const int gg = l / 4, qq = l % 4;
    A[gg][qq] = f(g_mma_a[base + l][0]);
    A[gg + 8][qq] = f(g_mma_a[base + l][1]);
    A[gg][qq + 4] = f(g_mma_a[base + l][2]);
    A[gg + 8][qq + 4] = f(g_mma_a[base + l][3]);
    B[qq][gg] = f(g_mma_b[base + l][0]);
    B[qq + 4][gg] = f(g_mma_b[base + l][1]);
  }
  g_warp_barriers[w]->arrive_and_wait();
  const int g = lane / 4, q = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * q + i % 2;
    double s = d[i];
    for (int k = 0; k < 8; ++k) s += A[r][k] * B[k][c];
    d[i] = (float)s;
  }
}
inline void mma_3xtf32(float d[4], const uint32_t a_big[4], const uint32_t a_small[4],
                       const uint32_t b_big[2], const uint32_t b_small[2]) {
  mma_tf32_m16n8k8(d, a_small, b_big);
  mma_tf32_m16n8k8(d, a_big, b_small);
  mma_tf32_m16n8k8(d, a_big, b_big);
}
// the m16n8k16 bf16 product: two bf16 values a register, lower index in
// the low half, gathered through the same per-warp exchange
inline void mma_bf16_m16n8k16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  const int t = threadIdx.x, w = t / 32, base = w * 32, lane = t % 32;
  for (int i = 0; i < 4; ++i) g_mma_a[t][i] = a[i];
  for (int i = 0; i < 2; ++i) g_mma_b[t][i] = b[i];
  g_warp_barriers[w]->arrive_and_wait();
  auto lo = [](uint32_t u) { return (double)__uint_as_float(u << 16); };
  auto hi = [](uint32_t u) { return (double)__uint_as_float(u & 0xffff0000u); };
  double A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int gg = l / 4, qq = l % 4;
    const uint32_t* ra = g_mma_a[base + l];
    const uint32_t* rb = g_mma_b[base + l];
    A[gg][2 * qq] = lo(ra[0]);         A[gg][2 * qq + 1] = hi(ra[0]);
    A[gg + 8][2 * qq] = lo(ra[1]);     A[gg + 8][2 * qq + 1] = hi(ra[1]);
    A[gg][2 * qq + 8] = lo(ra[2]);     A[gg][2 * qq + 9] = hi(ra[2]);
    A[gg + 8][2 * qq + 8] = lo(ra[3]); A[gg + 8][2 * qq + 9] = hi(ra[3]);
    B[2 * qq][gg] = lo(rb[0]);         B[2 * qq + 1][gg] = hi(rb[0]);
    B[2 * qq + 8][gg] = lo(rb[1]);     B[2 * qq + 9][gg] = hi(rb[1]);
  }
  g_warp_barriers[w]->arrive_and_wait();
  const int g = lane / 4, q = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * q + i % 2;
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += A[r][k] * B[k][c];
    d[i] = (float)s;
  }
}
// round to nearest, ties to even (finite values)
inline uint32_t bf16_bits(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}
inline uint32_t pack_bf16x2(float lo, float hi) { return bf16_bits(lo) | (bf16_bits(hi) << 16); }
inline uint32_t pack_u16x2(uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); }
// cp.async lands only when a wait_group retires its group: a kernel that
// reads a stage before waiting for it reads stale data here too
struct EmuCopy { void* dst; const void* src; int size, src_bytes; };
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_open;
inline void cp_async16(void* smem, const void* gmem, int src_bytes) {
  emu_open.push_back({smem, gmem, 16, src_bytes});
}
inline void cp_async4(void* smem, const void* gmem, int src_bytes) {
  emu_open.push_back({smem, gmem, 4, src_bytes});
}
inline void cp_async_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
inline void cp_async_wait(int pending) {
  pending = pending < 0 ? 0 : (pending > 2 ? 2 : pending);
  while ((int)emu_groups.size() > pending) {
    for (const EmuCopy& c : emu_groups.front()) {
      std::memset(c.dst, 0, (size_t)c.size);
      if (c.src_bytes > 0) std::memcpy(c.dst, c.src, (size_t)c.src_bytes);
    }
    emu_groups.erase(emu_groups.begin());
  }
}
}  // namespace sm90
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
struct cudaFuncAttributes { int maxThreadsPerBlock = 1024; };
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, F) { return cudaSuccess; }
// one resident block an SM: a test's `sms` argument is then its grid
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct __nv_bfloat16 { unsigned short v; };
inline float __bfloat162float(__nv_bfloat16 b) { unsigned u = (unsigned)b.v << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline __nv_bfloat16 __float2bfloat16(float f) { unsigned u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1); return {(unsigned short)(u >> 16)}; }
inline char* emu_dyn_smem;
inline void emu_launch(unsigned grid, unsigned block, size_t smem, std::function<void()> body) {
  std::vector<char> dyn(smem + 64);
  emu_dyn_smem = dyn.data();
  blockDim.x = block;
  gridDim.x = grid;
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
