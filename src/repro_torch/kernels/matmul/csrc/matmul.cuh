// Tiled fp32 matrix product on Hopper.
//
//   C[M, N] = A[M, K] @ B[K, N]        A, B, C: fp32, row-major
//
// Replaces the Pallas TPU kernel `matmul_pallas` (`_mm_kernel` and
// `_mm_kernel_noscratch`, src/repro/kernels/matmul/matmul.py). It computes
// what that kernel computes, block for block:
//
//   * one block per BM x BN output tile; `order` maps block ids to tiles
//     (0: m-major "mn", 1: n-major "nm");
//   * the TPU's sequential k grid axis becomes a loop inside the block over
//     ceil(K / BK) chunks; the final chunk is masked with zeros (the
//     Pallas `k_rem`), as are the ragged M and N edges;
//   * UNROLL splits each chunk into UNROLL sub-chunks with independent
//     partial accumulators, summed in order into the chunk's total, which
//     is added to the accumulator;
//   * scratch=1 accumulates in registers and stores once (the VMEM
//     scratch accumulator); scratch=0 read-modify-writes the output tile
//     after every chunk, as `_mm_kernel_noscratch` accumulates in `o_ref`;
//   * `lookahead` is inert: the chunk loop does not prefetch.
//   * Products are fp32 FMAs on the CUDA cores, never TF32 (which keeps
//     about three digits: chip_smoke.py holds every instantiation to a
//     limit a TF32 product fails).
//
// What bounds it on an H100: 2*M*N*K fp32 operations against
// 4*(M*K + K*N + M*N) bytes, so at the MLP up-projection of deepseek-7b
// (2048 x 11008 x 4096) it is compute-bound on the CUDA cores
// (67 TFLOP/s fp32; 2.76 ms). The design keeps the inner loop at two
// 16-byte shared-memory loads per 16 FMAs: 256 threads in a 16x16 layout
// each own a 4x4 register micro-tile of a 64x64 pass, and A is staged
// k-major so a thread's four rows are contiguous. A BM x BN tile larger
// than 64x64 is walked in passes and each BK chunk in 32-deep slices, so
// registers (16 accumulators and UNROLL x 16 partials a thread) and shared
// memory (one 64x32 slice of A and one 32x64 slice of B, 17 kB) stay
// bounded whatever the tile: the TPU kernel's whole (BM, BK) and (BK, BN)
// blocks, up to 2 MB, would not fit a Hopper block. Later work: wgmma or
// mma.sync products, TMA or cp.async double buffering (`lookahead` as a
// real pipeline depth), a gated TF32 knob.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace matmul {

constexpr int kThreads = 256;
constexpr int kTx = 16;            // threads along n
constexpr int kTy = 16;            // threads along m
constexpr int kR = 4;              // rows (and columns) per thread per pass
constexpr int kSubM = kTy * kR;    // 64 rows per pass
constexpr int kSubN = kTx * kR;    // 64 columns per pass
constexpr int kSlice = 32;         // k depth staged per step
constexpr int kPad = 4;            // keeps rows 16-byte aligned
constexpr int kLd = kSubM + kPad;  // leading dimension of both slices

// shared memory of one block, in bytes (what the tuning space's Hopper
// capacity rule counts)
constexpr size_t kSmemBytes = sizeof(float) * 2 * kSlice * kLd;

// Stage A[r0.., k0..k0+len) k-major into as[k][r] and B[k0.., c0..] into
// bs[k][c]; zero outside the matrices and past `len` (the end of the
// partial's sub-chunk, or K).
__device__ __forceinline__ void stage(const float* __restrict__ a,
                                      const float* __restrict__ b, int M, int N,
                                      int K, int r0, int c0, int k0, int len,
                                      float* as, float* bs) {
  for (int e = threadIdx.x; e < kSubM * kSlice; e += kThreads) {
    const int r = e / kSlice, k = e % kSlice;
    const int gr = r0 + r, gk = k0 + k;
    as[k * kLd + r] = (gr < M && k < len && gk < K) ? a[(size_t)gr * K + gk] : 0.f;
  }
  for (int e = threadIdx.x; e < kSlice * kSubN; e += kThreads) {
    const int k = e / kSubN, c = e % kSubN;
    const int gk = k0 + k, gc = c0 + c;
    bs[k * kLd + c] = (gc < N && k < len && gk < K) ? b[(size_t)gk * N + gc] : 0.f;
  }
}

// One chunk [kc0, kc0 + BK) of one 64x64 pass: this thread's 4x4 chunk
// totals. UNROLL sub-chunks of BK / UNROLL keep independent partials,
// each walked in 32-deep slices, summed in order into the total.
template <int BK, int UNROLL>
__device__ __forceinline__ void chunk_totals(const float* __restrict__ a,
                                             const float* __restrict__ b, int M,
                                             int N, int K, int r0, int c0, int kc0,
                                             float* as, float* bs,
                                             float total[kR][kR]) {
  constexpr int kSub = BK / UNROLL;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  float part[UNROLL][kR][kR];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) part[u][i][j] = 0.f;

#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int s0 = kc0 + u * kSub;
#pragma unroll 1
    for (int k0 = s0; k0 < s0 + kSub && k0 < K; k0 += kSlice) {
      const int len = min(kSlice, s0 + kSub - k0);
      __syncthreads();  // every thread is done with the previous slice
      stage(a, b, M, N, K, r0, c0, k0, len, as, bs);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kSlice; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(as + k * kLd + ty * kR);
        const float4 bv = *reinterpret_cast<const float4*>(bs + k * kLd + tx * kR);
        const float aa[kR] = {av.x, av.y, av.z, av.w};
        const float bb[kR] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) part[u][i][j] = fmaf(aa[i], bb[j], part[u][i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      float t = part[0][i][j];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) t += part[u][i][j];
      total[i][j] = t;
    }
}

template <int BM, int BN, int BK, int UNROLL>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int M, int N, int K, int order, int scratch) {
  static_assert(BM % kSubM == 0 && BN % kSubN == 0, "tile is not a multiple of the 64x64 pass");
  static_assert(BK % UNROLL == 0, "block_k must split into UNROLL sub-chunks");
  constexpr int kPassN = BN / kSubN;
  constexpr int kPasses = (BM / kSubM) * kPassN;
  __shared__ __align__(16) float as[kSlice * kLd];
  __shared__ __align__(16) float bs[kSlice * kLd];

  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  int bi, bj;
  if (order == 0) {
    bi = blockIdx.x / n_tiles;
    bj = blockIdx.x % n_tiles;
  } else {
    bj = blockIdx.x / m_tiles;
    bi = blockIdx.x % m_tiles;
  }
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int n_chunks = (K + BK - 1) / BK;
  float total[kR][kR];

  if (scratch) {
    // registers: each pass keeps its accumulators across every chunk and
    // stores once
#pragma unroll 1
    for (int p = 0; p < kPasses; ++p) {
      const int r0 = bi * BM + (p / kPassN) * kSubM;
      const int c0 = bj * BN + (p % kPassN) * kSubN;
      float acc[kR][kR] = {};
#pragma unroll 1
      for (int kc = 0; kc < n_chunks; ++kc) {
        chunk_totals<BK, UNROLL>(a, b, M, N, K, r0, c0, kc * BK, as, bs, total);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] += total[i][j];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int gr = r0 + ty * kR + i, gc = c0 + tx * kR + j;
          if (gr < M && gc < N) c[(size_t)gr * N + gc] = acc[i][j];
        }
    }
    return;
  }

  // no scratch: after each chunk, each pass read-modify-writes its part
  // of the output tile
#pragma unroll 1
  for (int kc = 0; kc < n_chunks; ++kc) {
#pragma unroll 1
    for (int p = 0; p < kPasses; ++p) {
      const int r0 = bi * BM + (p / kPassN) * kSubM;
      const int c0 = bj * BN + (p % kPassN) * kSubN;
      chunk_totals<BK, UNROLL>(a, b, M, N, K, r0, c0, kc * BK, as, bs, total);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int gr = r0 + ty * kR + i, gc = c0 + tx * kR + j;
          if (gr < M && gc < N) {
            float* o = c + (size_t)gr * N + gc;
            *o = kc == 0 ? total[i][j] : *o + total[i][j];
          }
        }
    }
  }
}

// Host launcher for one instantiation: on `stream`, allocates nothing,
// does not synchronise; returns the launch status (cudaGetLastError),
// which the Python wrapper turns into an exception.
template <int BM, int BN, int BK, int UNROLL>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           int order, int scratch, void* stream) {
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  matmul_kernel<BM, BN, BK, UNROLL>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, c, M, N, K,
                                                                 order, scratch);
  return (int)cudaGetLastError();
}

}  // namespace matmul

// One exported C symbol per instantiation:
//   int matmul_bm<BM>_bn<BN>_bk<BK>_u<UNROLL>(a, b, c, M, N, K, order,
//                                             scratch, stream)
#define MATMUL_INSTANTIATE(BM, BN, BK, U)                                           \
  extern "C" int matmul_bm##BM##_bn##BN##_bk##BK##_u##U(                            \
      const float* a, const float* b, float* c, int M, int N, int K, int order,     \
      int scratch, void* stream) {                                                  \
    return matmul::launch<BM, BN, BK, U>(a, b, c, M, N, K, order, scratch, stream); \
  }
