// Squared euclidean distances on Hopper (Streamcluster case study).
//
//   out[n, m] = sum_d (x[n, d] - c[m, d])^2       x: (N, D), c: (M, D) fp32
//
// Replaces the Pallas TPU kernel `euclid_pallas` (`_euclid_kernel` and
// `_euclid_kernel_noscratch`, src/repro/kernels/euclid/euclid.py). It
// computes what that kernel computes, point for point:
//
//   * one block per BN x BM output tile; `order` maps block ids to tiles
//     (0: n-major "nm", 1: m-major "mn");
//   * the TPU's sequential d grid axis becomes a loop inside the block
//     over ceil(D / BD) chunks staged through shared memory; the final
//     chunk is masked with zeros (the Pallas `d_rem`), as are the ragged
//     N and M edges;
//   * UNROLL splits each chunk into UNROLL sub-chunks with independent
//     partial accumulators, summed (in order) into the chunk total;
//   * VEC=1 forms ||x||^2 + ||c||^2 - 2 x.c per sub-chunk in fp32 FMA (no
//     TF32, which keeps ~3 digits: chip_smoke.py holds every instantiation
//     to rtol 2e-5 and checks that a TF32 product fails that limit);
//     VEC=0 forms the diff-square-sum;
//   * scratch=1 accumulates in registers and stores once: each 64x32 pass
//     keeps its accumulators across all chunks, restaging that pass's rows
//     per chunk. scratch=0 stages the whole tile's chunk once and walks it
//     in passes that read-modify-write the output, as the noscratch kernel
//     writes o_ref every chunk. (Two ways to pay: reloads from L2 against
//     output traffic — a real trade-off for the tuner.)
//   * `lookahead` is inert: the chunk loop does not prefetch.
//
// What bounds it on an H100: 2*N*M*D fp32 operations against 4*(N*D +
// M*D + N*M) bytes, so at the Streamcluster sizes it is compute-bound on
// the CUDA cores (67 TFLOP/s fp32). The design keeps the inner loop at
// one 16-byte and one 8-byte shared-memory load per 8 FMAs: 256 threads
// in a 16x16 layout each own a 4x2 register micro-tile of a 64x32 pass,
// the operands are stored d-major so a thread's four rows (two columns)
// are contiguous, and the squared norms of VEC=1 are computed once per
// chunk into shared memory instead of by every thread. A BN x BM tile
// larger than 64x32 is walked in passes, so registers stay bounded (8
// accumulators and UNROLL x 8 partials a thread) whatever the tile: a
// whole 256x128 tile of accumulators would take half the register file.
//
// Shared memory per block: at most BD*(BN+4) + BD*(BM+4) +
// VEC*UNROLL*(BN+BM) floats (scratch=0; scratch=1 stages one 64x32 pass
// and needs less). The tuning space's validator counts BN*BD + BM*BD +
// BN*BM words and more, which is never less, so every point it admits
// against the card's opt-in shared memory per block launches.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace euclid {

constexpr int kThreads = 256;
constexpr int kTx = 16;              // threads along m
constexpr int kTy = 16;              // threads along n
constexpr int kRn = 4;               // rows per thread per pass
constexpr int kRm = 2;               // columns per thread per pass
constexpr int kSubN = kTy * kRn;     // 64 rows per pass
constexpr int kSubM = kTx * kRm;     // 32 columns per pass
constexpr int kPad = 4;              // keeps rows 16-byte aligned

template <int BN, int BM, int BD, int UNROLL, int VEC>
struct Tile {
  static_assert(BN % kSubN == 0 && BM % kSubM == 0, "tile is not a multiple of the 64x32 pass");
  static_assert(BD % UNROLL == 0, "block_d must split into UNROLL sub-chunks");
  static constexpr int kSub = BD / UNROLL;
  static constexpr int kLdN = BN + kPad;
  static constexpr int kLdM = BM + kPad;
  static constexpr int kPassN = BN / kSubN;
  static constexpr int kPassM = BM / kSubM;
  static constexpr int kPasses = kPassN * kPassM;
  // scratch=0 stages the whole tile's chunk; scratch=1 one pass's rows
  static constexpr size_t kSmemBytes = sizeof(float) *
      ((size_t)BD * kLdN + (size_t)BD * kLdM + (size_t)VEC * UNROLL * (BN + BM));
  static constexpr size_t kSmemScratchBytes = sizeof(float) *
      ((size_t)BD * (kSubN + kPad) + (size_t)BD * (kSubM + kPad) +
       (size_t)VEC * UNROLL * (kSubN + kSubM));
};

// Stage rows [r0, r0 + ROWS) x columns [d0, d0 + BD) of src (rows_total x
// D, row-major) into dst[k * LD + r], zero outside the matrix: coalesced
// reads along d, d-major stores.
template <int ROWS, int BD, int LD>
__device__ __forceinline__ void stage(const float* __restrict__ src, int rows_total,
                                      int r0, int d0, int D, float* dst) {
  for (int e = threadIdx.x; e < ROWS * BD; e += kThreads) {
    const int r = e / BD, k = e % BD;
    const int gr = r0 + r, gk = d0 + k;
    dst[k * LD + r] = (gr < rows_total && gk < D) ? src[(size_t)gr * D + gk] : 0.f;
  }
}

// Squared norms of the ROWS staged rows per sub-chunk: sq[u * ROWS + r].
template <int ROWS, int BD, int UNROLL, int LD>
__device__ __forceinline__ void norms(const float* staged, float* sq) {
  constexpr int kSub = BD / UNROLL;
  for (int e = threadIdx.x; e < UNROLL * ROWS; e += kThreads) {
    const int u = e / ROWS, r = e % ROWS;
    float s = 0.f;
    for (int k = u * kSub; k < (u + 1) * kSub; ++k) {
      const float v = staged[k * LD + r];
      s = fmaf(v, v, s);
    }
    sq[u * ROWS + r] = s;
  }
}

// One 64x32 pass over a staged chunk: this thread's 4x2 chunk totals,
// rows pr.. of xs (leading dim LDX, norms xsq of stride NX) against
// columns pc.. of cs (LDC, csq of stride NC). UNROLL sub-chunks keep
// independent partial accumulators, summed in order into the total.
template <int BD, int UNROLL, int VEC, int LDX, int LDC, int NX, int NC>
__device__ __forceinline__ void pass_totals(const float* xs, const float* cs,
                                            const float* xsq, const float* csq,
                                            int pr, int pc, float total[kRn][kRm]) {
  constexpr int kSub = BD / UNROLL;
  float part[UNROLL][kRn][kRm];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
#pragma unroll
    for (int i = 0; i < kRn; ++i)
#pragma unroll
      for (int j = 0; j < kRm; ++j) part[u][i][j] = 0.f;

#pragma unroll 4
  for (int kk = 0; kk < kSub; ++kk) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = u * kSub + kk;
      const float4 xv = *reinterpret_cast<const float4*>(xs + k * LDX + pr);
      const float2 cv = *reinterpret_cast<const float2*>(cs + k * LDC + pc);
      const float xa[kRn] = {xv.x, xv.y, xv.z, xv.w};
      const float ca[kRm] = {cv.x, cv.y};
#pragma unroll
      for (int i = 0; i < kRn; ++i)
#pragma unroll
        for (int j = 0; j < kRm; ++j) {
          if (VEC) {
            part[u][i][j] = fmaf(xa[i], ca[j], part[u][i][j]);
          } else {
            const float dl = xa[i] - ca[j];
            part[u][i][j] = fmaf(dl, dl, part[u][i][j]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRn; ++i)
#pragma unroll
    for (int j = 0; j < kRm; ++j) {
      float t = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        t += VEC ? (xsq[u * NX + pr + i] + csq[u * NC + pc + j]) - 2.f * part[u][i][j]
                 : part[u][i][j];
      }
      total[i][j] = t;
    }
}

template <int BN, int BM, int BD, int UNROLL, int VEC>
__global__ void __launch_bounds__(kThreads)
euclid_kernel(const float* __restrict__ x, const float* __restrict__ c,
              float* __restrict__ out, int N, int M, int D, int order,
              int scratch) {
  using T = Tile<BN, BM, BD, UNROLL, VEC>;
  extern __shared__ __align__(16) float smem[];

  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  int bi, bj;
  if (order == 0) {
    bi = blockIdx.x / m_tiles;
    bj = blockIdx.x % m_tiles;
  } else {
    bj = blockIdx.x / n_tiles;
    bi = blockIdx.x % n_tiles;
  }
  const int n0 = bi * BN;
  const int m0 = bj * BM;
  const int ty = threadIdx.x / kTx;
  const int tx = threadIdx.x % kTx;
  const int n_chunks = (D + BD - 1) / BD;
  float total[kRn][kRm];

  if (scratch) {
    // Registers: each 64x32 pass keeps its 4x2 accumulators across every
    // chunk and stores once, so the pass's rows are staged per chunk.
    constexpr int LDX = kSubN + kPad, LDC = kSubM + kPad;
    float* xs = smem;                    // [BD][LDX]
    float* cs = xs + BD * LDX;           // [BD][LDC]
    float* xsq = cs + BD * LDC;          // [UNROLL][kSubN]  (VEC only)
    float* csq = xsq + UNROLL * kSubN;   // [UNROLL][kSubM]  (VEC only)
#pragma unroll 1
    for (int p = 0; p < T::kPasses; ++p) {
      const int r0 = n0 + (p / T::kPassM) * kSubN;
      const int c0 = m0 + (p % T::kPassM) * kSubM;
      float acc[kRn][kRm] = {};
      for (int kd = 0; kd < n_chunks; ++kd) {
        __syncthreads();  // every thread is done with the previous chunk
        stage<kSubN, BD, LDX>(x, N, r0, kd * BD, D, xs);
        stage<kSubM, BD, LDC>(c, M, c0, kd * BD, D, cs);
        __syncthreads();
        if (VEC) {
          norms<kSubN, BD, UNROLL, LDX>(xs, xsq);
          norms<kSubM, BD, UNROLL, LDC>(cs, csq);
          __syncthreads();
        }
        pass_totals<BD, UNROLL, VEC, LDX, LDC, kSubN, kSubM>(
            xs, cs, xsq, csq, ty * kRn, tx * kRm, total);
#pragma unroll
        for (int i = 0; i < kRn; ++i)
#pragma unroll
          for (int j = 0; j < kRm; ++j) acc[i][j] += total[i][j];
      }
#pragma unroll
      for (int i = 0; i < kRn; ++i)
#pragma unroll
        for (int j = 0; j < kRm; ++j) {
          const int gr = r0 + ty * kRn + i, gc = c0 + tx * kRm + j;
          if (gr < N && gc < M) out[(size_t)gr * M + gc] = acc[i][j];
        }
    }
    return;
  }

  // No scratch: the whole BN x BM tile's chunk is staged once and walked
  // in 64x32 passes, each read-modify-writing its part of the output.
  float* xs = smem;                        // [BD][kLdN]
  float* cs = xs + BD * T::kLdN;           // [BD][kLdM]
  float* xsq = cs + BD * T::kLdM;          // [UNROLL][BN]  (VEC only)
  float* csq = xsq + UNROLL * BN;          // [UNROLL][BM]  (VEC only)
  for (int kd = 0; kd < n_chunks; ++kd) {
    __syncthreads();
    stage<BN, BD, T::kLdN>(x, N, n0, kd * BD, D, xs);
    stage<BM, BD, T::kLdM>(c, M, m0, kd * BD, D, cs);
    __syncthreads();
    if (VEC) {
      norms<BN, BD, UNROLL, T::kLdN>(xs, xsq);
      norms<BM, BD, UNROLL, T::kLdM>(cs, csq);
      __syncthreads();
    }
#pragma unroll 1
    for (int p = 0; p < T::kPasses; ++p) {
      const int pr = (p / T::kPassM) * kSubN + ty * kRn;
      const int pc = (p % T::kPassM) * kSubM + tx * kRm;
      pass_totals<BD, UNROLL, VEC, T::kLdN, T::kLdM, BN, BM>(
          xs, cs, xsq, csq, pr, pc, total);
#pragma unroll
      for (int i = 0; i < kRn; ++i)
#pragma unroll
        for (int j = 0; j < kRm; ++j) {
          const int gr = n0 + pr + i, gc = m0 + pc + j;
          if (gr < N && gc < M) {
            float* o = out + (size_t)gr * M + gc;
            *o = kd == 0 ? total[i][j] : *o + total[i][j];
          }
        }
    }
  }
}

// Host launcher for one instantiation. Launches on `stream`, allocates
// nothing, does not synchronise; returns the launch status
// (cudaGetLastError), which the Python wrapper turns into an exception.
template <int BN, int BM, int BD, int UNROLL, int VEC>
int launch(const float* x, const float* c, float* out, int N, int M, int D,
           int order, int scratch, void* stream) {
  using T = Tile<BN, BM, BD, UNROLL, VEC>;
  // Above 48 KB, dynamic shared memory must be opted in to. The attribute
  // belongs to the current device, so it is set on every launch (cheap
  // next to the launch): a second card, or a call after a transient
  // failure, gets its own attempt.
  if (T::kSmemBytes > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        euclid_kernel<BN, BM, BD, UNROLL, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
  }
  const long long blocks = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = scratch ? T::kSmemScratchBytes : T::kSmemBytes;
  euclid_kernel<BN, BM, BD, UNROLL, VEC>
      <<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
          x, c, out, N, M, D, order, scratch);
  return (int)cudaGetLastError();
}

}  // namespace euclid

// One exported C symbol per instantiation:
//   int euclid_bn<BN>_bm<BM>_bd<BD>_u<UNROLL>_v<VEC>(x, c, out, N, M, D,
//                                                   order, scratch, stream)
// plus its shared-memory footprint, so the wrapper can check it against
// the card before launching.
#define EUCLID_INSTANTIATE(BN, BM, BD, U, V)                                       \
  extern "C" int euclid_bn##BN##_bm##BM##_bd##BD##_u##U##_v##V(                   \
      const float* x, const float* c, float* out, int N, int M, int D, int order, \
      int scratch, void* stream) {                                                 \
    return euclid::launch<BN, BM, BD, U, V>(x, c, out, N, M, D, order, scratch,   \
                                            stream);                              \
  }                                                                                \
  extern "C" long long euclid_bn##BN##_bm##BM##_bd##BD##_u##U##_v##V##_smem() {   \
    return (long long)euclid::Tile<BN, BM, BD, U, V>::kSmemBytes;                 \
  }
