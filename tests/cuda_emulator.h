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
//
// Hopper's asynchronous machinery has host versions too. An mbarrier is
// a host object (count, pending arrivals, expected bytes, phase parity)
// behind the shared-memory word the kernel gives; try_wait returns only
// once the phase of the asked parity has completed (a wait that stays
// blocked for a minute aborts: a deadlocked ring fails the test instead
// of hanging it). A TMA load copies its box at once, element by element
// with zero fill past every edge of the tensor, into shared memory in the
// hardware's swizzle (16-byte chunk index XOR the 128-byte row index, on
// the address bits as the card applies them), and completes its bytes on
// its barrier. CUtensorMap and make_tile_map are stand-ins that refuse
// what cuTensorMapEncodeTiled refuses (a base or a stride that is not a
// multiple of 16 bytes, a box wider than its swizzle). A wgmma is queued
// and runs when wgmma_wait retires its group: the warpgroup's 128 threads
// then pass their A registers (as they hold them then: the card reads
// them while the wgmma runs) through an exchange, and A and B are read
// from shared memory through their descriptors (start, strides, swizzle,
// K- or MN-major), so a kernel that frees a stage, or rewrites its A
// registers, before its wait reads what was written there since.
#pragma once
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <mutex>
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
#define __grid_constant__
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
// dynamic shared memory of the running launch, 1024-byte aligned
inline char* emu_dyn_smem;
inline std::vector<std::unique_ptr<std::barrier<>>> g_wg_barriers;
// the stand-in tensor map: a bf16 tensor's base, dims (innermost first),
// byte strides (stride[0] the element), box and swizzle span in bytes
struct CUtensorMap {
  const char* base;
  int rank;
  uint64_t dims[5], strides[5];
  uint32_t box[5];
  int swizzle;
};
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
// ---------------------------------------------- mbarriers, TMA, wgmma
inline uint32_t smem_addr(const void* p) { return (uint32_t)((const char*)p - emu_dyn_smem); }
// the card's swizzle on a shared-memory address: bits [4, 4 + b) ^= bits [7, 7 + b)
inline uint32_t emu_swizzle(uint32_t a, int span) {
  const uint32_t mask = span == 128 ? 7u : span == 64 ? 3u : span == 32 ? 1u : 0u;
  return a ^ (((a >> 7) & mask) << 4);
}
struct EmuMbar {
  std::mutex mu;
  std::condition_variable cv;
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;  // parity of the phase in progress
};
inline std::mutex g_mbar_mu;
inline std::map<const void*, std::unique_ptr<EmuMbar>> g_mbars;
inline EmuMbar& emu_mbar(const void* p) {
  std::lock_guard<std::mutex> g(g_mbar_mu);
  auto& b = g_mbars[p];
  if (!b) b.reset(new EmuMbar);
  return *b;
}
inline void emu_mbar_settle(EmuMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.expected;
    b.cv.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.expected = b.pending = count;
  b.tx = 0;
  b.phase = 0;
}
inline void fence_barrier_init() {}
inline void fence_proxy_async() {}
inline void mbar_arrive(uint64_t* bar) {
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  --b.pending;
  emu_mbar_settle(b);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.tx += bytes;
  --b.pending;
  emu_mbar_settle(b);
}
inline void emu_complete_tx(uint64_t* bar, long long bytes) {
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.tx -= bytes;
  emu_mbar_settle(b);
}
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  EmuMbar& b = emu_mbar(bar);
  std::unique_lock<std::mutex> g(b.mu);
  if (!b.cv.wait_for(g, std::chrono::seconds(60), [&] { return b.phase != (parity & 1u); })) {
    std::fprintf(stderr, "emulator: mbarrier wait for parity %u never completed (deadlock)\n",
                 parity);
    std::abort();
  }
  return true;
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// one TMA box: zero past the tensor's edges, swizzled as the card writes it
inline void emu_tma(void* dst, const CUtensorMap* m, uint64_t* bar, const int* c) {
  uint32_t box[4] = {1, 1, 1, 1};
  for (int i = 0; i < m->rank; ++i) box[i] = m->box[i];
  const uint32_t base = smem_addr(dst);
  uint32_t row = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1, ++row)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0) {
          const long long at[4] = {(long long)c[0] + i0, (long long)c[1] + i1,
                                   (long long)c[2] + i2, (long long)c[3] + i3};
          bool in = true;
          size_t off = 0;
          for (int d = 0; d < m->rank; ++d) {
            in = in && at[d] >= 0 && at[d] < (long long)m->dims[d];
            off += (size_t)at[d] * m->strides[d];
          }
          uint16_t v = 0;
          if (in) std::memcpy(&v, m->base + off, 2);
          const uint32_t a = emu_swizzle(base + row * box[0] * 2 + i0 * 2, m->swizzle);
          std::memcpy(emu_dyn_smem + a, &v, 2);
        }
  emu_complete_tx(bar, 2LL * box[0] * box[1] * box[2] * box[3]);
}
inline void tma_load_2d(void* dst, const CUtensorMap* m, uint64_t* bar, int c0, int c1) {
  const int c[4] = {c0, c1, 0, 0};
  emu_tma(dst, m, bar, c);
}
inline void tma_load_3d(void* dst, const CUtensorMap* m, uint64_t* bar, int c0, int c1, int c2) {
  const int c[4] = {c0, c1, c2, 0};
  emu_tma(dst, m, bar, c);
}
inline void tma_load_4d(void* dst, const CUtensorMap* m, uint64_t* bar, int c0, int c1, int c2,
                        int c3) {
  const int c[4] = {c0, c1, c2, c3};
  emu_tma(dst, m, bar, c);
}
// cuTensorMapEncodeTiled's checks, as far as the kernels rely on them
inline int make_tile_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                         const uint64_t* strides, const uint32_t* box, int swizzle) {
  if (rank < 1 || rank > 4 || ((uintptr_t)base & 15) != 0) return 1;
  map->base = (const char*)base;
  map->rank = rank;
  map->swizzle = swizzle;
  map->strides[0] = 2;
  for (int i = 0; i < rank; ++i) {
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256) return 1;
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i + 1 < rank) {
      if (strides[i] % 16 != 0) return 1;
      map->strides[i + 1] = strides[i];
    }
  }
  if ((box[0] * 2) % 16 != 0 || (swizzle > 0 && box[0] * 2 > (uint32_t)swizzle)) return 1;
  return 0;
}
inline uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | ((uint64_t)((lbo & 0x3ffff) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffff) >> 4) << 32) | (layout << 62);
}
// element (mn, k) of an operand read through its descriptor, as a double
inline double emu_desc_elem(uint64_t desc, int mn, int k, bool mn_major) {
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fff) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
  const int layout = (int)(desc >> 62);
  const int span = layout == 1 ? 128 : layout == 2 ? 64 : 32;
  uint32_t off;
  if (!mn_major) {
    off = start + (mn / 8) * sbo + (mn % 8) * span + k * 2;
  } else {
    const int w = span / 2;
    off = start + (mn / w) * lbo + (k / 8) * sbo + (k % 8) * span + (mn % w) * 2;
  }
  uint16_t v;
  std::memcpy(&v, emu_dyn_smem + emu_swizzle(off, span), 2);
  return (double)__uint_as_float((uint32_t)v << 16);
}
struct EmuWgmma {
  float* d;
  int n;
  const uint32_t* a;  // the A registers, read when the wgmma runs
  uint64_t da, db;
  int tb, scale_d;
};
inline thread_local std::vector<std::vector<EmuWgmma>> emu_wg_groups;
inline thread_local std::vector<EmuWgmma> emu_wg_open;
struct EmuWgExchange {
  uint32_t a[128][4];
  double A[64][16], B[16][256];
};
inline EmuWgExchange g_wg_x[8];
// one queued wgmma, run by the warpgroup's 128 threads together
inline void emu_wgmma_run(const EmuWgmma& op) {
  const int t = threadIdx.x, wg = t / 128, lt = t % 128;
  EmuWgExchange& x = g_wg_x[wg];
  std::barrier<>& bar = *g_wg_barriers[wg];
  if (op.a)
    for (int i = 0; i < 4; ++i) x.a[lt][i] = op.a[i];
  bar.arrive_and_wait();
  if (lt == 0) {
    auto lo = [](uint32_t u) { return (double)__uint_as_float(u << 16); };
    auto hi = [](uint32_t u) { return (double)__uint_as_float(u & 0xffff0000u); };
    for (int l = 0; l < 128; ++l) {
      if (!op.a) break;
      const int w = l / 32, gg = (l % 32) / 4, qq = l % 4, r = 16 * w + gg;
      const uint32_t* ra = x.a[l];
      x.A[r][2 * qq] = lo(ra[0]);         x.A[r][2 * qq + 1] = hi(ra[0]);
      x.A[r + 8][2 * qq] = lo(ra[1]);     x.A[r + 8][2 * qq + 1] = hi(ra[1]);
      x.A[r][2 * qq + 8] = lo(ra[2]);     x.A[r][2 * qq + 9] = hi(ra[2]);
      x.A[r + 8][2 * qq + 8] = lo(ra[3]); x.A[r + 8][2 * qq + 9] = hi(ra[3]);
    }
    if (!op.a)
      for (int r = 0; r < 64; ++r)
        for (int k = 0; k < 16; ++k) x.A[r][k] = emu_desc_elem(op.da, r, k, false);
    for (int k = 0; k < 16; ++k)
      for (int n = 0; n < op.n; ++n) x.B[k][n] = emu_desc_elem(op.db, n, k, op.tb != 0);
  }
  bar.arrive_and_wait();
  const int w = lt / 32, g = (lt % 32) / 4, q = lt % 4;
  for (int j = 0; j < op.n / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * w + g + 8 * (i / 2), c = 8 * j + 2 * q + i % 2;
      double s = op.scale_d ? (double)op.d[4 * j + i] : 0.0;
      for (int k = 0; k < 16; ++k) s += x.A[r][k] * x.B[k][c];
      op.d[4 * j + i] = (float)s;
    }
  bar.arrive_and_wait();
}
inline void wgmma_fence() {}
inline void wgmma_commit() {
  emu_wg_groups.push_back(std::move(emu_wg_open));
  emu_wg_open.clear();
}
template <int N>
inline void wgmma_wait() {
  while ((int)emu_wg_groups.size() > N) {
    for (const EmuWgmma& op : emu_wg_groups.front()) emu_wgmma_run(op);
    emu_wg_groups.erase(emu_wg_groups.begin());
  }
}
inline void fence_operand(float&) {}
template <int N>
struct Wgmma {
  template <int TB>
  static void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    emu_wg_open.push_back({d, N, nullptr, da, db, TB, scale_d});
  }
  template <int TB>
  static void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    emu_wg_open.push_back({d, N, a, 0, db, TB, scale_d});
  }
};
template <int R>
inline void setmaxnreg_inc() {}
template <int R>
inline void setmaxnreg_dec() {}
}  // namespace sm90
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
// the SMs a persistent grid fills (one block each, below): small, so that
// every block walks several tiles
inline int emu_sm_count = 3;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = emu_sm_count; return cudaSuccess; }
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
inline void emu_launch(unsigned grid, unsigned block, size_t smem, std::function<void()> body) {
  std::vector<char> dyn(smem + 2048);
  emu_dyn_smem = (char*)(((uintptr_t)dyn.data() + 1023) & ~(uintptr_t)1023);
  blockDim.x = block;
  gridDim.x = grid;
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar((std::ptrdiff_t)block);
    g_block_barrier = &bar;
    g_warp_barriers.clear();
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      g_warp_barriers.emplace_back(new std::barrier<>((std::ptrdiff_t)std::min(32u, block - w * 32)));
    g_wg_barriers.clear();
    for (unsigned w = 0; w < (block + 127) / 128; ++w)
      g_wg_barriers.emplace_back(new std::barrier<>((std::ptrdiff_t)std::min(128u, block - w * 128)));
    {
      std::lock_guard<std::mutex> g(sm90::g_mbar_mu);
      sm90::g_mbars.clear();
    }
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = b; body(); });
    for (auto& th : ts) th.join();
  }
}
