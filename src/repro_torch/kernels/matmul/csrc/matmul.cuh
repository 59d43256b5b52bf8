// Tiled matrix product on Hopper, on the tensor cores: fp32 operands in
// 3xTF32, bf16 operands in bf16, fp32 accumulators and output either way.
//
//   C[M, N] = A[M, K] @ B[K, N]        A, B: fp32 or bf16; C: fp32; row-major
//
// Replaces the Pallas TPU kernel `matmul_pallas` (`_mm_kernel` and
// `_mm_kernel_noscratch`, src/repro/kernels/matmul/matmul.py). It computes
// what that kernel computes, block for block:
//
//   * one block per BM x BN output tile; `order` maps block ids to tiles
//     (0: m-major "mn", 1: n-major "nm");
//   * the TPU's sequential k grid axis becomes a loop inside the block over
//     ceil(K / BK) chunks; the final chunk reads zeros past K (the Pallas
//     `k_rem`), as the ragged M and N edges do;
//   * UNROLL splits each chunk into UNROLL sub-chunks whose partials are
//     computed one after the other and summed in order into the chunk's
//     total, which is added to the accumulator (UNROLL = 1: the partial
//     is the total);
//   * scratch=1 accumulates in registers and stores once (the VMEM
//     scratch accumulator); scratch=0 read-modify-writes the output tile
//     after every chunk, as `_mm_kernel_noscratch` accumulates in `o_ref`;
//   * `lookahead` is the depth of the copy pipeline (below).
//
// What bounds it on an H100: 2*M*N*K operations against
// 4*(M*K + K*N + M*N) bytes, so at the MLP up-projection of deepseek-7b
// (2048 x 11008 x 4096, 184.7 GFLOP) it is bound by operations. On the
// CUDA cores (67 TFLOP/s fp32) no kernel gets below 2.76 ms, and cuBLAS's
// fp32 product is at 3.71. A TF32 product keeps about three digits, which
// chip_smoke.py's limit refuses; so the products run in 3xTF32
// (sm90::mma_3xtf32): each operand x is split into big = tf32(x) and
// small = tf32(x - big), and small*big + big*small + big*big is
// accumulated in fp32 by mma.sync m16n8k8. That is three TF32 products at
// 495 TFLOP/s, 1.12 ms of tensor-core time for the up-projection.
//
// The design:
//   * 256 threads, 8 warps in a 2 (m) x 4 (n) layout. The block holds a
//     pass tile of PM x 128 outputs in registers (PM = min(BM, 128) at
//     UNROLL = 1, whose partial is the chunk total; 64 at UNROLL > 1,
//     which holds an accumulator, a total and one partial): a warp owns
//     PM/2 x 32 outputs, PM/32 x 4 m16n8 fragments. Larger tiles are
//     walked in passes. With scratch=1 each pass runs over all of K and
//     stores once; with scratch=0 the passes run inside each chunk.
//   * A (PM x D, k contiguous) and B (D x 128, n contiguous) are staged
//     into a ring of `lookahead + 1` shared-memory stages by cp.async,
//     D = 64 deep (32 where a sub-chunk is only 32 deep): while the warps
//     compute on one slice, `lookahead` later slices are in flight,
//     across pass and chunk boundaries. One __syncthreads a slice (two at
//     lookahead 0, which has no overlap).
//   * Rows are padded to D + 4 (A) and 136 (B) floats, so the fragment loads
//     (8 rows x 4 columns of A, 4 rows x 8 columns of B per instruction)
//     hit 32 different banks.
//   * The 16-byte copy serves an operand whose row length is a multiple of
//     4 floats and whose base is 16-byte aligned; any other stride (such
//     as B rows of 450 floats) is copied 4 bytes at a time. Copies past an
//     edge have a source size of 0 and fill zeros.
//   * Fragments are split on the way from shared memory to the mma;
//     accumulators never leave fp32 registers. Plain TF32 (one product)
//     is never used.
//   * Each ring depth is its own kernel (template parameter LA), picked by
//     the launcher: with the depth a run-time value and wait_group's
//     count behind a switch, the ring raced on the card.
// Precision: chip_smoke.py reads 0.21 of its limit (rtol 2e-5, atol
// 1e-3) over every instantiation; a TF32 product reads 90 times it. The
// k-chunk partials (at most 512 deep, summed in fp32) bound the tensor
// core's own accumulation error (tests/test_torch_tf32.py).
// What bounds it now: latency more than the tensor cores' rate. At 255
// registers a block of 8 warps fills an SM, 2 warps a scheduler, which
// do not hide the chain from shared memory through the split to the
// dependent mma.syncs (on an H100 80GB HBM3 at 700 W: 4.2 ms at the
// up-projection at DEFAULT_POINT, cuBLAS fp32 3.6 ms).
// bf16 operands: the input class of `matmul_pallas` whose operands are
// bf16 and whose output stays fp32 (`out_dtype=jnp.float32`). Its bound
// at the up-projection: 184.7 GFLOP at 989 TFLOP/s, 0.187 ms, against
// 0.059 ms of bytes: operations. A bf16 x bf16 product is exact in fp32.
// Two kernels, picked by the Python wrapper before the launch:
//
// `wg::matmul_wgmma` (symbols `_bf16`), for operands TMA can describe (K
// and N multiples of 8, both 16-byte aligned): Hopper's own machinery.
//   * A persistent grid of at most as many blocks as are resident on the
//     SMs walks the output tiles: tiles of 64 or 128 rows (block_m < 128
//     or not) by 128 or 256 columns (block_n < 256 or not). `order` 0
//     ("mn") walks bands of tile rows column by column, 1 ("nm") bands
//     of tile columns row by row. A band is at least block_m (block_n)
//     wide, and wide enough that the tiles resident at once span about as
//     many bytes of A as of B (h bands with h * h * TM >= blocks * TN):
//     with bands of one tile row the resident tiles re-read all of B from
//     HBM for every few rows of A.
//   * A block is a producer warpgroup and two consumer warpgroups (384
//     threads; setmaxnreg gives the producer 40 registers, the consumers
//     232). One producer thread issues TMA loads of 64-deep A and B
//     slices into a ring of `lookahead + 2` stages (one more than the
//     mma.sync kernel's: a stage stays held while the products reading it
//     finish), each with a full and an empty mbarrier: A as one box of
//     tile rows x 64 (k innermost), B as 64 x 64 boxes (n innermost),
//     both with the 128-byte swizzle. TMA fills zeros past every edge: the
//     Pallas kernel's `k_rem` and the ragged M and N edges need no masked
//     copy.
//   * Each consumer warpgroup owns 64 rows x 128 or 256 columns (at 64
//     tile rows, both share the rows and split the columns) on wgmma
//     m64nNk16 (sm90::Wgmma<N>::ss), A K-major and B MN-major (the
//     descriptor's transpose bit: no transposing stage) from shared
//     memory, fp32 accumulators in registers. A slice's four wgmmas run
//     while the next slice's are issued (wgmma_wait<1>); a stage goes back
//     to the producer once the products reading it are done.
//   * scratch=1 accumulates over all of K and stores once; scratch=0
//     stores after the first block_k chunk and read-modify-writes the
//     output after every later one. The producer loads the next tile's
//     slices while the consumers write a tile out.
//   * Inert here: `unroll` (every product of a tile is one accumulation
//     chain), and `block_k` at scratch=1.
// What still holds it back: the epilogue (fp32 stores from registers)
// leaves the tensor cores idle, since both consumer warpgroups finish a
// tile together; a 128 x 256 tile grid leaves the last of 5.2 waves a
// quarter full at the up-projection; 128 x 128 tiles (DEFAULT_POINT)
// give each wgmma half the columns of a 128 x 256 tile's, for the same
// A rows read from shared memory.
//
// `matmul_kernel<bf16_t, ...>` (symbols `_bf16_mma`), for any other
// operands: one mma.sync m16n8k16 bf16 product (sm90::mma_bf16_m16n8k16)
// into the same fp32 accumulators, the same tiles, passes, ring, partials,
// orders and ragged-edge zeros as the fp32 kernel above. The slices are
// staged as bf16 (16-byte copies of 8 values; K or N not a multiple of 8,
// or an unaligned operand, is staged by plain 2-byte loads and stores,
// which the ring's barriers order as they order the copies). A rows are
// padded to D + 8 values, so each A fragment register is one 32-bit load
// of two k-adjacent values, conflict-free. B is n-contiguous, but the
// .col B fragment wants k-adjacent pairs: each B register is two 16-bit
// shared-memory reads, rows k and k + 1, packed (sm90::pack_u16x2); rows
// of 136 values keep the four k rows a warp reads in different banks.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace matmul {

// bf16 operands travel as their 16-bit patterns
using bf16_t = uint16_t;

constexpr int kThreads = 256;
constexpr int kPN = 128;       // pass tile columns
constexpr int kLdB = kPN + 8;  // B rows, in elements of either type

// A rows, in elements: D + 4 floats or D + 8 bf16 values (conflict-free
// fragment loads either way)
template <class T, int D>
__host__ __device__ constexpr int ld_a() { return sizeof(T) == 4 ? D + 4 : D + 8; }

// k depth of one staged slice: 64, or 32 where a sub-chunk is 32 deep
// (block_k 128 at UNROLL 4); 64 halves the barriers of 32 and measured
// 13 % faster at the serving shape
template <int BK, int UNROLL>
__host__ __device__ constexpr int slice_depth() { return (BK / UNROLL) % 64 == 0 ? 64 : 32; }

// pass tile rows of an instantiation
template <int BM, int UNROLL>
__host__ __device__ constexpr int pass_m() { return UNROLL == 1 ? (BM < 128 ? BM : 128) : 64; }

// shared memory of one ring stage, in bytes (the tuning space's Hopper
// capacity rule counts lookahead + 1 of them)
template <class T, int BM, int BK, int UNROLL>
__host__ __device__ constexpr size_t stage_bytes() {
  constexpr int slice = slice_depth<BK, UNROLL>();
  return sizeof(T) * ((size_t)pass_m<BM, UNROLL>() * ld_a<T, slice>() + (size_t)slice * kLdB);
}

// one element of a slice where the 16-byte copy does not apply: a 4-byte
// cp.async (zero past an edge) for fp32, a plain load and store for bf16
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool in) {
  sm90::cp_async4(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(bf16_t* dst, const bf16_t* src, bool in) {
  *dst = in ? *src : (bf16_t)0;
}

__device__ __forceinline__ uint32_t ld32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One kernel per ring depth LA (= lookahead), picked by the launcher: the
// ring's slot arithmetic and the wait_group count are compile-time
// constants, and each depth gets its own register allocation.
template <class T, int BM, int BN, int BK, int UNROLL, int LA>
__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ c, int M, int N, int K, int order, int scratch) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PM = pass_m<BM, UNROLL>();
  constexpr int kSlice = slice_depth<BK, UNROLL>();
  constexpr int kLdA = ld_a<T, kSlice>();  // A rows padded: conflict-free fragments
  constexpr int kVec = 16 / sizeof(T);     // elements of one 16-byte copy
  constexpr int WM = PM / 2;             // warp tile rows
  constexpr int MF = WM / 16;            // m16 fragments a warp
  constexpr int NF = 4;                  // n8 fragments a warp (32 columns)
  constexpr int kPassN = BN / kPN;
  constexpr int kPasses = (BM / PM) * kPassN;
  constexpr int kSub = BK / UNROLL;      // sub-chunk depth
  constexpr int kSubSlices = kSub / kSlice;
  constexpr int kChunkSlices = BK / kSlice;
  constexpr int kStageElems = PM * kLdA + kSlice * kLdB;
  static_assert(BM % PM == 0 && BN % kPN == 0, "tile is not a multiple of the pass tile");
  static_assert(BK % UNROLL == 0 && kSub % kSlice == 0,
                "sub-chunks must be whole slices");
  extern __shared__ __align__(16) float smem[];
  T* const sm = reinterpret_cast<T*>(smem);

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
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  constexpr int la = LA, stages = LA + 1;
  const int S = (K + kSlice - 1) / kSlice;  // slices over all of K
  const int n_items = kPasses * S;          // (pass, slice) items
  const bool vec_a = K % kVec == 0 && ((uintptr_t)a & 15) == 0;
  const bool vec_b = N % kVec == 0 && ((uintptr_t)b & 15) == 0;

  // item -> (pass, slice): pass-major with scratch, chunk-major without
  auto item = [&](int idx, int& p, int& j) {
    if (scratch) {
      p = idx / S;
      j = idx % S;
    } else {
      const int kc = idx / (kPasses * kChunkSlices);
      const int r = idx - kc * kPasses * kChunkSlices;
      const int len = min(kChunkSlices, S - kc * kChunkSlices);
      p = r / len;
      j = kc * kChunkSlices + r % len;
    }
  };
  auto pass_origin = [&](int p, int& r0, int& c0) {
    r0 = bi * BM + (p / kPassN) * PM;
    c0 = bj * BN + (p % kPassN) * kPN;
  };

  // stage item idx into ring slot `slot`
  auto issue = [&](int idx, int slot) {
    int p, j, r0, c0;
    item(idx, p, j);
    pass_origin(p, r0, c0);
    const int k0 = j * kSlice;
    T* as = sm + (size_t)slot * kStageElems;
    T* bs = as + PM * kLdA;
    if (vec_a) {
      for (int e = tid; e < PM * (kSlice / kVec); e += kThreads) {
        const int r = e / (kSlice / kVec), kk = (e % (kSlice / kVec)) * kVec;
        const int gr = r0 + r, gk = k0 + kk;
        const int n = gr < M ? max(0, min(kVec, K - gk)) : 0;
        sm90::cp_async16(as + r * kLdA + kk, n ? a + (size_t)gr * K + gk : a,
                         (int)sizeof(T) * n);
      }
    } else {
      for (int e = tid; e < PM * kSlice; e += kThreads) {
        const int r = e / kSlice, kk = e % kSlice;
        const int gr = r0 + r, gk = k0 + kk;
        const bool in = gr < M && gk < K;
        copy_elem(as + r * kLdA + kk, in ? a + (size_t)gr * K + gk : a, in);
      }
    }
    if (vec_b) {
      for (int e = tid; e < kSlice * (kPN / kVec); e += kThreads) {
        const int kk = e / (kPN / kVec), cc = (e % (kPN / kVec)) * kVec;
        const int gk = k0 + kk, gc = c0 + cc;
        const int n = gk < K ? max(0, min(kVec, N - gc)) : 0;
        sm90::cp_async16(bs + kk * kLdB + cc, n ? b + (size_t)gk * N + gc : b,
                         (int)sizeof(T) * n);
      }
    } else {
      for (int e = tid; e < kSlice * kPN; e += kThreads) {
        const int kk = e / kPN, cc = e % kPN;
        const int gk = k0 + kk, gc = c0 + cc;
        const bool in = gk < K && gc < N;
        copy_elem(bs + kk * kLdB + cc, in ? b + (size_t)gk * N + gc : b, in);
      }
    }
  };

  // this thread's outputs of a pass: rows r0 + wm*WM + mf*16 + g (+8),
  // columns c0 + wn*32 + nf*8 + 2q (+1); `add` read-modify-writes
  auto store = [&](int r0, int c0, float (*v)[NF][4], bool add) {
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = r0 + wm * WM + mf * 16 + g + 8 * h;
        if (gr >= M) continue;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int gc = c0 + wn * 32 + nf * 8 + 2 * q;
          float* o = c + (size_t)gr * N + gc;
          const float x0 = v[mf][nf][2 * h], x1 = v[mf][nf][2 * h + 1];
          if (gc + 1 < N) {
            o[0] = add ? o[0] + x0 : x0;
            o[1] = add ? o[1] + x1 : x1;
          } else if (gc < N) {
            o[0] = add ? o[0] + x0 : x0;
          }
        }
      }
  };

  float part[MF][NF][4];
  float acc[MF][NF][4];
  float total[UNROLL > 1 ? MF : 1][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mf][nf][i] = 0.f;

  for (int s = 0; s < la; ++s) {
    if (s < n_items) issue(s, s);
    sm90::cp_async_commit();
  }

#pragma unroll 1
  for (int idx = 0; idx < n_items; ++idx) {
    if constexpr (la == 0) {
      __syncthreads();  // every warp is done with the only stage
      issue(idx, 0);
      sm90::cp_async_commit();
    }
    sm90::cp_async_wait(la == 0 ? 0 : la - 1);
    __syncthreads();  // item idx has landed; slot (idx - 1) % stages is free
    if constexpr (la > 0) {
      if (idx + la < n_items) issue(idx + la, (idx + la) % stages);
      sm90::cp_async_commit();
    }

    int p, j, r0, c0;
    item(idx, p, j);
    pass_origin(p, r0, c0);
    if (scratch && j == 0) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;
    }

    const T* as = sm + (size_t)(idx % stages) * kStageElems;
    const T* bs = as + PM * kLdA;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 16) {
        // B[kk + 2q, kk + 2q + 1][col] and rows + 8: k pairs from an
        // n-contiguous tile, two 16-bit reads a register
        uint32_t bb[NF][2];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const T* bc = bs + (kk + 2 * q) * kLdB + wn * 32 + nf * 8 + g;
          bb[nf][0] = sm90::pack_u16x2(bc[0], bc[kLdB]);
          bb[nf][1] = sm90::pack_u16x2(bc[8 * kLdB], bc[9 * kLdB]);
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const T* ar = as + (wm * WM + mf * 16 + g) * kLdA + kk + 2 * q;
          const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLdA), ld32(ar + 8),
                                  ld32(ar + 8 * kLdA + 8)};
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) sm90::mma_bf16_m16n8k16(part[mf][nf], af, bb[nf]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 8) {
        uint32_t bb[NF][2], bsm[NF][2];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int col = wn * 32 + nf * 8 + g;
          sm90::tf32_split(bs[(kk + q) * kLdB + col], bb[nf][0], bsm[nf][0]);
          sm90::tf32_split(bs[(kk + q + 4) * kLdB + col], bb[nf][1], bsm[nf][1]);
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const int row = wm * WM + mf * 16 + g;
          uint32_t ab[4], asm_[4];
          sm90::tf32_split(as[row * kLdA + kk + q], ab[0], asm_[0]);
          sm90::tf32_split(as[(row + 8) * kLdA + kk + q], ab[1], asm_[1]);
          sm90::tf32_split(as[row * kLdA + kk + q + 4], ab[2], asm_[2]);
          sm90::tf32_split(as[(row + 8) * kLdA + kk + q + 4], ab[3], asm_[3]);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            sm90::mma_3xtf32(part[mf][nf], ab, asm_, bb[nf], bsm[nf]);
        }
      }
    }

    // the slice ends a sub-chunk, a chunk, a pass?
    const bool last = j == S - 1;
    if (!(last || (j + 1) % kSubSlices == 0)) continue;
    const bool chunk_end = last || (j + 1) % kChunkSlices == 0;
    float (*chunk_total)[NF][4] = part;
    if constexpr (UNROLL > 1) {
      const bool first_sub = (j % kChunkSlices) < kSubSlices;
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            total[mf][nf][i] = first_sub ? part[mf][nf][i] : total[mf][nf][i] + part[mf][nf][i];
            part[mf][nf][i] = 0.f;
          }
      chunk_total = total;
    }
    if (chunk_end) {
      if (scratch) {
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mf][nf][i] += chunk_total[mf][nf][i];
        if (last) store(r0, c0, acc, false);
      } else {
        store(r0, c0, chunk_total, j >= kChunkSlices);
      }
    }
    if constexpr (UNROLL == 1) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mf][nf][i] = 0.f;
    }
  }
  sm90::cp_async_wait(0);  // nothing in flight when the block exits
}

// Host launcher for one instantiation: on `stream`, allocates nothing,
// does not synchronise; returns the launch status (cudaGetLastError),
// which the Python wrapper turns into an exception.
template <class T, int BM, int BN, int BK, int UNROLL, int LA>
int launch_depth(const T* a, const T* b, float* c, int M, int N, int K,
                 int order, int scratch, void* stream) {
  const size_t smem = (size_t)(LA + 1) * stage_bytes<T, BM, BK, UNROLL>();
  // above 48 KB, dynamic shared memory must be opted in to; the attribute
  // belongs to the current device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<T, BM, BN, BK, UNROLL, LA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  matmul_kernel<T, BM, BN, BK, UNROLL, LA>
      <<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, b, c, M, N, K, order,
                                                                  scratch);
  return (int)cudaGetLastError();
}

template <class T, int BM, int BN, int BK, int UNROLL>
int launch(const T* a, const T* b, float* c, int M, int N, int K,
           int order, int scratch, int lookahead, void* stream) {
  switch (lookahead) {
    case 0: return launch_depth<T, BM, BN, BK, UNROLL, 0>(a, b, c, M, N, K, order, scratch, stream);
    case 1: return launch_depth<T, BM, BN, BK, UNROLL, 1>(a, b, c, M, N, K, order, scratch, stream);
    case 2: return launch_depth<T, BM, BN, BK, UNROLL, 2>(a, b, c, M, N, K, order, scratch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------- the bf16 wgmma kernel (path "wgmma")
namespace wg {

constexpr int kThreads = 384;     // a producer warpgroup and two consumer warpgroups
constexpr int kDepth = 64;        // k depth of a staged slice: one 128-byte swizzle row
constexpr int kBarrierBytes = 64; // a full and an empty barrier for each of <= 4 stages

// the block's output tile: 64 or 128 rows, 128 or 256 columns
template <int BM>
__host__ __device__ constexpr int tile_m() { return BM < 128 ? 64 : 128; }
template <int BN>
__host__ __device__ constexpr int tile_n() { return BN < 256 ? 128 : 256; }
// columns of a consumer warpgroup's 64-row accumulator: the whole tile, or
// half of it where the tile has only 64 rows
template <int BM, int BN>
__host__ __device__ constexpr int wg_n() { return BM < 128 ? tile_n<BN>() / 2 : tile_n<BN>(); }
// one ring stage: an A slice (tile rows x 64) and a B slice (64 x tile columns)
template <int BM, int BN>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * (size_t)(tile_m<BM>() + tile_n<BN>()) * kDepth;
}
// the dynamic shared memory a block asks for: the ring, its barriers, and
// room to align the ring to 1024 bytes (the 128-byte swizzle's period)
template <int BM, int BN>
__host__ __device__ constexpr size_t smem_bytes(int lookahead) {
  return 1024 + kBarrierBytes + (size_t)(lookahead + 2) * stage_bytes<BM, BN>();
}

// output tile (i, j) of the persistent walk's idx-th tile: "mn" walks bands
// of gm tile rows, column by column inside a band; "nm" bands of gn tile
// columns, row by row
__device__ __forceinline__ void tile_coords(int idx, int order, int tm, int tn, int gm, int gn,
                                            int& i, int& j) {
  if (order == 0) {
    const int band = idx / (gm * tn);
    const int h = min(gm, tm - band * gm);
    const int r = idx - band * gm * tn;
    j = r / h;
    i = band * gm + r % h;
  } else {
    const int band = idx / (gn * tm);
    const int w = min(gn, tn - band * gn);
    const int r = idx - band * gn * tm;
    i = r / w;
    j = band * gn + r % w;
  }
}

template <int BM, int BN, int BK, int UNROLL>
__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             float* __restrict__ c, int M, int N, int K, int order, int scratch, int stages) {
  constexpr int TM = tile_m<BM>(), TN = tile_n<BN>(), WN = wg_n<BM, BN>();
  constexpr int kA = TM * kDepth;             // elements of a stage's A slice
  constexpr int kStage = (TM + TN) * kDepth;  // elements of a stage
  constexpr int kChunk = BK / kDepth;         // slices of a block_k chunk
  static_assert(BK % kDepth == 0, "block_k is a whole number of slices");
  extern __shared__ __align__(16) float smem[];
  bf16_t* const ring = reinterpret_cast<bf16_t*>(
      reinterpret_cast<char*>(smem) + ((1024 - (sm90::smem_addr(smem) & 1023)) & 1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * kStage);
  uint64_t* const empty = full + stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int tm = (M + TM - 1) / TM, tn = (N + TN - 1) / TN, n_tiles = tm * tn;
  // bands of at least block_m / TM tile rows ("mn") or block_n / TN tile
  // columns ("nm"), and wide enough that the tiles the resident blocks
  // hold at once span about as many bytes of A as of B: h bands of rows
  // with h * h * TM >= gridDim.x * TN (columns likewise), so a wave
  // streams neither operand from HBM again and again
  int gm = 1, gn = 1;
  while (gm * gm * TM < (int)gridDim.x * TN) ++gm;
  while (gn * gn * TN < (int)gridDim.x * TM) ++gn;
  gm = min(max(gm, BM / TM), tm);
  gn = min(max(gn, BN / TN), tn);
  const int S = (K + kDepth - 1) / kDepth;  // slices over all of K
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (wg == 0) {
    // the producer: one thread keeps the ring full, tile after tile
    sm90::setmaxnreg_dec<40>();
    if (t == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int i, j;
        tile_coords(tile, order, tm, tn, gm, gn, i, j);
        for (int s = 0; s < S; ++s, ++it) {
          const int st = it % stages;
          sm90::mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          bf16_t* as = ring + (size_t)st * kStage;
          sm90::mbar_arrive_expect_tx(&full[st], 2 * kStage);
          sm90::tma_load_2d(as, &ta, &full[st], s * kDepth, i * TM);
#pragma unroll
          for (int nb = 0; nb < TN / 64; ++nb)
            sm90::tma_load_2d(as + kA + nb * 64 * kDepth, &tb, &full[st], j * TN + nb * 64,
                              s * kDepth);
        }
      }
    }
  } else {
    // a consumer: 64 rows x WN columns of the tile on wgmma, fp32 accumulators
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int row0 = BM < 128 ? 0 : 64 * cw, col0 = BM < 128 ? WN * cw : 0;
    const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
    float acc[WN / 2];
    int it = 0;  // slices consumed, over every tile: the ring's position
    // one slice's products into acc (scale_d 0: the first overwrites it)
    auto issue = [&](int st, int scale_d) {
      const bf16_t* as = ring + (size_t)st * kStage + row0 * kDepth;
      const bf16_t* bs = ring + (size_t)st * kStage + kA + col0 * kDepth;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        sm90::Wgmma<WN>::template ss<1>(
            acc, sm90::smem_desc(as + kk * 16, 0, 1024, 128),
            sm90::smem_desc(bs + kk * 16 * 64, 64 * kDepth * 2, 1024, 128),
            kk == 0 ? scale_d : 1);
      sm90::wgmma_commit();
    };
    // a chunk is all of K (scratch 1) or block_k deep (scratch 0)
    const int chunk = scratch ? S : kChunk;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int i, j;
      tile_coords(tile, order, tm, tn, gm, gn, i, j);
      for (int c0 = 0; c0 < S; c0 += chunk) {
        const int c1 = min(S, c0 + chunk);
        int st = it % stages;
        sm90::mbar_wait(&full[st], (it / stages) & 1);
#pragma unroll
        for (int r = 0; r < WN / 2; ++r) sm90::fence_operand(acc[r]);
        issue(st, 0);
        ++it;
        for (int s = c0 + 1; s < c1; ++s, ++it) {
          const int prev = st;
          st = it % stages;
          sm90::mbar_wait(&full[st], (it / stages) & 1);
          issue(st, 1);
          // the previous slice's products are done: its stage goes back
          // to the producer while this slice's run on
          sm90::wgmma_wait<1>();
          if (t == 0) sm90::mbar_arrive(&empty[prev]);
        }
        sm90::wgmma_wait<0>();
        if (t == 0) sm90::mbar_arrive(&empty[st]);
#pragma unroll
        for (int r = 0; r < WN / 2; ++r) sm90::fence_operand(acc[r]);
        // the tile's (scratch 1) or the chunk's (scratch 0, read-modify-
        // write after the first chunk) outputs, two adjacent columns a
        // store: N is a multiple of 8 on this path
        const bool add = c0 > 0;
#pragma unroll
        for (int jj = 0; jj < WN / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = i * TM + row0 + 16 * warp + g + 8 * h;
            const int gc = j * TN + col0 + 8 * jj + 2 * q;
            if (gr < M && gc < N) {
              float2* o = reinterpret_cast<float2*>(c + (size_t)gr * N + gc);
              float2 v = make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
              if (add) {
                const float2 old = *o;
                v.x += old.x;
                v.y += old.y;
              }
              *o = v;
            }
          }
      }
    }
  }
}

// Host launcher: tensor maps of A (K-major boxes of 64 x tile rows) and B
// (64 x 64 boxes, n innermost), both 128-byte swizzled, and a persistent
// grid of at most the blocks resident on all SMs. The caller guarantees
// what TMA needs: K and N multiples of 8, a and b 16-byte aligned.
template <int BM, int BN, int BK, int UNROLL>
int launch(const bf16_t* a, const bf16_t* b, float* c, int M, int N, int K, int order,
           int scratch, int lookahead, void* stream) {
  if (lookahead < 0 || lookahead > 2) return (int)cudaErrorInvalidValue;
  constexpr int TM = tile_m<BM>(), TN = tile_n<BN>();
  CUtensorMap ta, tb;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M}, a_strides[1] = {(uint64_t)K * 2};
  const uint32_t a_box[2] = {kDepth, TM};
  int rc = sm90::make_tile_map(&ta, a, 2, a_dims, a_strides, a_box, 128);
  if (rc != 0) return rc;
  const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)K}, b_strides[1] = {(uint64_t)N * 2};
  const uint32_t b_box[2] = {64, kDepth};
  rc = sm90::make_tile_map(&tb, b, 2, b_dims, b_strides, b_box, 128);
  if (rc != 0) return rc;
  const auto kernel = matmul_wgmma<BM, BN, BK, UNROLL>;
  const size_t smem = smem_bytes<BM, BN>(lookahead);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  if (tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long fill = (long long)sms * per_sm;
  const long long blocks = tiles < fill ? tiles : fill;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(ta, tb, c, M, N, K, order,
                                                                   scratch, lookahead + 2);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace matmul

// Exported C symbols per instantiation and operand type:
//   int matmul_bm<BM>_bn<BN>_bk<BK>_u<UNROLL>[_bf16|_bf16_mma](a, b, c, M, N,
//                                     K, order, scratch, lookahead, stream)
// fp32 operands without a suffix; bf16 operands with `_bf16` (the wgmma
// kernel) or `_bf16_mma` (the mma.sync kernel, for operands TMA cannot
// describe); c is fp32. `..._bf16_smem(lookahead)` is the wgmma kernel's
// dynamic shared memory, as its launcher asks for it.
#define MATMUL_INSTANTIATE(BM, BN, BK, U)                                             \
  extern "C" int matmul_bm##BM##_bn##BN##_bk##BK##_u##U(                              \
      const float* a, const float* b, float* c, int M, int N, int K, int order,       \
      int scratch, int lookahead, void* stream) {                                     \
    return matmul::launch<float, BM, BN, BK, U>(a, b, c, M, N, K, order, scratch,     \
                                                lookahead, stream);                   \
  }
#define MATMUL_INSTANTIATE_BF16(BM, BN, BK, U)                                        \
  extern "C" int matmul_bm##BM##_bn##BN##_bk##BK##_u##U##_bf16(                       \
      const matmul::bf16_t* a, const matmul::bf16_t* b, float* c, int M, int N,       \
      int K, int order, int scratch, int lookahead, void* stream) {                   \
    return matmul::wg::launch<BM, BN, BK, U>(a, b, c, M, N, K, order, scratch,        \
                                             lookahead, stream);                      \
  }                                                                                   \
  extern "C" long long matmul_bm##BM##_bn##BN##_bk##BK##_u##U##_bf16_smem(            \
      int lookahead) {                                                                \
    return (long long)matmul::wg::smem_bytes<BM, BN>(lookahead);                      \
  }
#define MATMUL_INSTANTIATE_BF16_MMA(BM, BN, BK, U)                                    \
  extern "C" int matmul_bm##BM##_bn##BN##_bk##BK##_u##U##_bf16_mma(                   \
      const matmul::bf16_t* a, const matmul::bf16_t* b, float* c, int M, int N,       \
      int K, int order, int scratch, int lookahead, void* stream) {                   \
    return matmul::launch<matmul::bf16_t, BM, BN, BK, U>(a, b, c, M, N, K, order,     \
                                                         scratch, lookahead, stream); \
  }
