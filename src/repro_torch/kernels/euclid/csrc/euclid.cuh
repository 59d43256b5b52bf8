// Squared euclidean distances on Hopper (Streamcluster case study).
//
//   out[n, m] = sum_d (x[n, d] - c[m, d])^2       x: (N, D), c: (M, D) fp32
//
// Replaces the Pallas TPU kernel `euclid_pallas` (`_euclid_kernel` and
// `_euclid_kernel_noscratch`, src/repro/kernels/euclid/euclid.py). It
// computes what that kernel computes, point for point:
//
//   * BN x BM output tiles; `order` numbers them (0: n-major "nm", 1:
//     m-major "mn"), and blocks take them in that order;
//   * the TPU's sequential d grid axis becomes a loop inside the block
//     over ceil(D / BD) chunks; the final chunk reads zeros past D (the
//     Pallas `d_rem`), as the ragged N and M edges do;
//   * UNROLL splits each chunk into UNROLL sub-chunks whose partials are
//     computed one after the other and summed in order into the chunk's
//     total, which is added to the accumulator;
//   * VEC=1 forms each sub-chunk's partial as (||x||^2 + ||c||^2) - 2 x.c;
//     VEC=0 as the diff-square-sum (the paper's SISD variant);
//   * scratch=1 accumulates in registers and stores once; scratch=0
//     read-modify-writes the output after every chunk, as the noscratch
//     kernel writes o_ref every chunk;
//   * `lookahead` is the depth of the copy pipeline (below).
//
// What bounds it on an H100: 2*N*M*D operations against 4*(N*D + M*D +
// N*M) bytes. At Streamcluster's simlarge (16384 x 1024 x 128, 4.29 GFLOP)
// that is 0.064 ms of fp32 FMAs on the CUDA cores (67 TFLOP/s) and 0.023
// ms of bytes, so on the CUDA cores it is bound by operations. A TF32
// product keeps about three digits, which chip_smoke.py's limit (rtol
// 2e-5) refuses; so VEC=1 runs x.c in 3xTF32 on the tensor cores
// (sm90::mma_3xtf32, mma.sync m16n8k8: small*big + big*small + big*big
// in fp32), three TF32 products at 495 TFLOP/s, 0.026 ms at simlarge.
//
// The design:
//   * 256 threads, 8 warps in a 4 (n) x 2 (m) layout, hold a pass tile of
//     PN x PM outputs in registers, PN = min(BN, 128), PM = min(BM, 64):
//     a warp owns PN/4 x PM/2 outputs, 1-2 x 2-4 m16n8 fragments. Larger
//     tiles are walked in passes. With scratch=1 each pass runs over all
//     of D and stores once; with scratch=0 the passes run inside each
//     chunk.
//   * A persistent grid: as many blocks as the card holds resident (SMs x
//     blocks an SM, from the occupancy API), each walking tiles blockIdx.x,
//     + gridDim.x, ... in `order`'s numbering, so the copy ring below runs
//     on across tiles and a tile's stores overlap the next one's copies.
//   * Both operands are K-major (x rows and c rows are d-contiguous), so
//     slices of PN x S of x and PM x S of c (S = min(BD, 64) deep) are
//     staged row-major, rows padded to S + 4 floats so that each fragment
//     load (8 rows x 4 columns) hits 32 different banks; no transposing
//     stage. 64 deep halves the barriers of 32 and measured faster at
//     lookahead 0 and 1; at lookahead 2 the ring's 153 kB leaves one block
//     an SM, and the tuner weighs that. They go into a ring of `lookahead + 1` shared-memory stages
//     by cp.async: 16-byte copies where D is a multiple of 4 floats and
//     the base is 16-byte aligned, 4-byte copies elsewhere (D = 70), a
//     source size of 0 past every edge. While the warps compute on one
//     slice, `lookahead` later slices are in flight, across pass, chunk
//     and tile boundaries. One __syncthreads a slice (two at lookahead 0).
//     Each ring depth is its own kernel (template parameter LA), picked by
//     the launcher: with the depth a run-time value, the matmul and
//     attention rings raced on the card.
//   * The squared norms of a sub-chunk come from the fragments each lane
//     already loads: the four lanes of a fragment row hold its 8 columns
//     of a k-step, so each lane sums the squares it loaded in fp32 FMAs,
//     and two warp shuffles at the sub-chunk's end give the row's norm
//     (two more gather the norms of the lane's output columns). No extra
//     shared-memory pass and no extra barrier.
//   * A sub-chunk of 4 (block_d 16, unroll 4) runs the k8 product with its
//     upper four columns zero (in both operands' big and small halves):
//     exact, at twice the tensor work for those points, with no other
//     primitive.
//   * Fragments are split on the way from shared memory to the mma, by
//     truncation (sm90::tf32_split_trunc: two masks and a subtraction).
//     sm_90 has no single instruction for cvt.rna.tf32: it runs as a short
//     sequence of compares, adds and masks, and with x split by two warps
//     and c by four, the rounding split was most of the instructions the
//     warps issued per mma. Truncation costs about 2^-20 of each product
//     against 2^-22, far inside the limit. Partials stay in fp32 registers
//     and are never deeper than a sub-chunk (at most 128 here). Plain TF32
//     (one product) is never used.
//   * Two blocks an SM (__launch_bounds__(256, 2): at most 128 registers
//     a thread): a block of 8 warps alone left the chain from shared
//     memory through the split to the dependent mma.syncs poorly hidden.
//     ptxas then spills in the larger pass tiles (chip_smoke.py's build
//     report counts them); two blocks with spills measured faster than
//     one without.
//   * VEC=0 shares the staging and the fragment ownership: each lane
//     walks its rows and columns 4 deep with 16-byte shared-memory loads
//     and forms (x - c)^2 in fp32 FMAs on the CUDA cores.
//
// What bounds it now: instruction issue and latency more than the tensor
// cores' rate. Each product still costs a split and a norm FMA per
// operand value beside its three mma.syncs. Left for later: wgmma, which
// takes TF32 K-major operands from shared memory, as both of euclid's
// are (no per-warp split or register fragments), and TMA copies.
//
// Shared memory per block: (lookahead + 1) * (PN + PM) * (S + 4) floats,
// 7.5-153 kB (euclid/euclid.py `smem_bytes`, which the tuning space's
// Hopper rule counts).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace euclid {

constexpr int kThreads = 256;
constexpr int kWarpsN = 4;           // warps along n (x rows)
constexpr int kWarpsM = 2;           // warps along m (c rows)

template <int BN>
__host__ __device__ constexpr int pass_n() { return BN < 128 ? BN : 128; }
template <int BM>
__host__ __device__ constexpr int pass_m() { return BM < 64 ? BM : 64; }
// d depth of one staged slice
template <int BD>
__host__ __device__ constexpr int slice_depth() { return BD < 64 ? BD : 64; }

// shared memory of one ring stage, in bytes
template <int BN, int BM, int BD>
__host__ __device__ constexpr size_t stage_bytes() {
  return sizeof(float) * (size_t)(pass_n<BN>() + pass_m<BM>()) * (slice_depth<BD>() + 4);
}

// Stage rows [r0, r0 + ROWS) x d [k0, k0 + S) of src (rows_total x D,
// row-major) into dst[r * (S + 4) + k], zeros outside the matrix.
template <int ROWS, int S>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int rows_total,
                                           int r0, int k0, int D, bool vec, float* dst) {
  constexpr int LD = S + 4;
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * (S / 4); e += kThreads) {
      const int r = e / (S / 4), kk = (e % (S / 4)) * 4;
      const int gr = r0 + r, gk = k0 + kk;
      const int n = gr < rows_total ? max(0, min(4, D - gk)) : 0;
      sm90::cp_async16(dst + r * LD + kk, n ? src + (size_t)gr * D + gk : src, 4 * n);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * S; e += kThreads) {
      const int r = e / S, kk = e % S;
      const int gr = r0 + r, gk = k0 + kk;
      const bool in = gr < rows_total && gk < D;
      sm90::cp_async4(dst + r * LD + kk, in ? src + (size_t)gr * D + gk : src, in ? 4 : 0);
    }
  }
}

template <int BN, int BM, int BD, int UNROLL, int VEC, int LA>
__global__ void __launch_bounds__(kThreads, 2)
euclid_kernel(const float* __restrict__ x, const float* __restrict__ c,
              float* __restrict__ out, int N, int M, int D, int order, int scratch) {
  constexpr int PN = pass_n<BN>(), PM = pass_m<BM>();
  constexpr int S = slice_depth<BD>();
  constexpr int LD = S + 4;               // padded row: conflict-free fragments
  constexpr int WR = PN / kWarpsN;        // warp tile rows (16 or 32)
  constexpr int WC = PM / kWarpsM;        // warp tile columns (16 or 32)
  constexpr int MF = WR / 16;             // m16 fragments a warp
  constexpr int NF = WC / 8;              // n8 fragments a warp
  constexpr int kPassM = BM / PM;
  constexpr int kPasses = (BN / PN) * kPassM;
  constexpr int kSub = BD / UNROLL;       // sub-chunk depth
  constexpr int kChunkSlices = BD / S;
  // k step: the mma's 8 (4 for a 4-deep sub-chunk), or 4 floats on the
  // CUDA cores
  constexpr int kStep = VEC ? (kSub < 8 ? kSub : 8) : 4;
  constexpr int kStageFloats = (PN + PM) * LD;
  static_assert(BN % PN == 0 && BM % PM == 0 && BD % S == 0, "tile is not a multiple of the pass");
  static_assert(BD % UNROLL == 0 && kSub % 4 == 0, "sub-chunks must be 4-deep multiples");
  static_assert(S % kStep == 0 && (kSub <= S ? S % kSub : kSub % S) == 0,
                "sub-chunks must tile the slices");
  extern __shared__ __align__(16) float smem[];

  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = warp / kWarpsM, wc = warp % kWarpsM;
  constexpr int la = LA, stages = LA + 1;
  const int Sn = (D + BD - 1) / BD * kChunkSlices;  // slices over the chunks
  const int per_tile = kPasses * Sn;                // (pass, slice) items a tile
  // this block's tiles: blockIdx.x, + gridDim.x, ... (a persistent grid)
  const int tiles = n_tiles * m_tiles;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const long long T = (long long)my_tiles * per_tile;
  const bool vec_x = D % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_c = D % 4 == 0 && ((uintptr_t)c & 15) == 0;

  // item -> (pass origin r0, c0; slice j): tile after tile; in a tile,
  // pass-major with scratch, chunk-major without
  auto locate = [&](long long idx, int& r0, int& c0, int& j) {
    const int tile = (int)blockIdx.x + (int)(idx / per_tile) * (int)gridDim.x;
    const int r = (int)(idx % per_tile);
    int p;
    if (scratch) {
      p = r / Sn;
      j = r % Sn;
    } else {
      const int kc = r / (kPasses * kChunkSlices);
      const int rr = r - kc * kPasses * kChunkSlices;
      p = rr / kChunkSlices;
      j = kc * kChunkSlices + rr % kChunkSlices;
    }
    // `order` maps tile ids to tiles: 0 n-major ("nm"), 1 m-major ("mn")
    const int bi = order == 0 ? tile / m_tiles : tile % n_tiles;
    const int bj = order == 0 ? tile % m_tiles : tile / n_tiles;
    r0 = bi * BN + (p / kPassM) * PN;
    c0 = bj * BM + (p % kPassM) * PM;
  };
  auto issue = [&](long long idx, int slot) {
    int r0, c0, j;
    locate(idx, r0, c0, j);
    float* xs = smem + (size_t)slot * kStageFloats;
    stage_rows<PN, S>(x, N, r0, j * S, D, vec_x, xs);
    stage_rows<PM, S>(c, M, c0, j * S, D, vec_c, xs + PN * LD);
  };

  // this thread's outputs of a pass: rows r0 + wr*WR + mf*16 + g (+8),
  // columns c0 + wc*WC + nf*8 + 2q (+1); `add` read-modify-writes
  auto store = [&](int r0, int c0, float (*v)[NF][4], bool add) {
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = r0 + wr * WR + mf * 16 + g + 8 * h;
        if (gr >= N) continue;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int gc = c0 + wc * WC + nf * 8 + 2 * q;
          float* o = out + (size_t)gr * M + gc;
          float v0 = v[mf][nf][2 * h], v1 = v[mf][nf][2 * h + 1];
          if (gc + 1 < M && (M & 1) == 0) {  // 8-byte aligned pair
            if (add) {
              const float2 old = *reinterpret_cast<const float2*>(o);
              v0 += old.x;
              v1 += old.y;
            }
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            if (gc < M) o[0] = add ? o[0] + v0 : v0;
            if (gc + 1 < M) o[1] = add ? o[1] + v1 : v1;
          }
        }
      }
  };

  float part[MF][NF][4];                         // the open sub-chunk's partial
  float total[UNROLL > 1 ? MF : 1][NF][4];       // the chunk's total (UNROLL > 1)
  float acc[MF][NF][4];                          // over the chunks (scratch)
  float xn[MF][2], cn[NF];                       // this lane's share of the norms
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    xn[mf][0] = xn[mf][1] = 0.f;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mf][nf][i] = 0.f;
  }
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) cn[nf] = 0.f;

  for (int s = 0; s < la; ++s) {
    if (s < T) issue(s, s);
    sm90::cp_async_commit();
  }

#pragma unroll 1
  for (long long idx = 0; idx < T; ++idx) {
    if constexpr (la == 0) {
      __syncthreads();  // every warp is done with the only stage
      issue(idx, 0);
      sm90::cp_async_commit();
    }
    sm90::cp_async_wait(la == 0 ? 0 : la - 1);
    __syncthreads();  // item idx has landed; slot (idx - 1) % stages is free
    if constexpr (la > 0) {
      if (idx + la < T) issue(idx + la, (idx + la) % stages);
      sm90::cp_async_commit();
    }

    int r0, c0, j;
    locate(idx, r0, c0, j);
    const int sc = j % kChunkSlices;    // the slice's place in its chunk
    if (scratch && j == 0) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;
    }
    if constexpr (UNROLL > 1) {
      if (sc == 0) {
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int i = 0; i < 4; ++i) total[mf][nf][i] = 0.f;
      }
    }

    const float* xs = smem + (size_t)(idx % stages) * kStageFloats;
    const float* cs = xs + PN * LD;
#pragma unroll
    for (int kk = 0; kk < S; kk += kStep) {
      if constexpr (VEC) {
        uint32_t bb[NF][2], bsm[NF][2];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const float* col = cs + (wc * WC + nf * 8 + g) * LD + kk + q;
          const float b0 = col[0];
          const float b1 = kStep == 8 ? col[4] : 0.f;
          cn[nf] = fmaf(b0, b0, cn[nf]);
          if (kStep == 8) cn[nf] = fmaf(b1, b1, cn[nf]);
          sm90::tf32_split_trunc(b0, bb[nf][0], bsm[nf][0]);
          sm90::tf32_split_trunc(b1, bb[nf][1], bsm[nf][1]);
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const float* row = xs + (wr * WR + mf * 16 + g) * LD + kk + q;
          const float a0 = row[0], a1 = row[8 * LD];
          const float a2 = kStep == 8 ? row[4] : 0.f;
          const float a3 = kStep == 8 ? row[8 * LD + 4] : 0.f;
          xn[mf][0] = fmaf(a0, a0, xn[mf][0]);
          xn[mf][1] = fmaf(a1, a1, xn[mf][1]);
          if (kStep == 8) {
            xn[mf][0] = fmaf(a2, a2, xn[mf][0]);
            xn[mf][1] = fmaf(a3, a3, xn[mf][1]);
          }
          uint32_t ab[4], asm_[4];
          sm90::tf32_split_trunc(a0, ab[0], asm_[0]);
          sm90::tf32_split_trunc(a1, ab[1], asm_[1]);
          sm90::tf32_split_trunc(a2, ab[2], asm_[2]);
          sm90::tf32_split_trunc(a3, ab[3], asm_[3]);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            sm90::mma_3xtf32(part[mf][nf], ab, asm_, bb[nf], bsm[nf]);
        }
      } else {
        float4 xa[MF][2], ca[NF][2];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xa[mf][h] = *reinterpret_cast<const float4*>(
                xs + (wr * WR + mf * 16 + g + 8 * h) * LD + kk);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ca[nf][e] = *reinterpret_cast<const float4*>(
                cs + (wc * WC + nf * 8 + 2 * q + e) * LD + kk);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 a = xa[mf][i / 2], b = ca[nf][i % 2];
              float t = part[mf][nf][i], dl;
              dl = a.x - b.x; t = fmaf(dl, dl, t);
              dl = a.y - b.y; t = fmaf(dl, dl, t);
              dl = a.z - b.z; t = fmaf(dl, dl, t);
              dl = a.w - b.w; t = fmaf(dl, dl, t);
              part[mf][nf][i] = t;
            }
      }

      // does a sub-chunk end here? (kk + kStep is the slice's own offset)
      const bool sub_end = kSub <= S ? (kk + kStep) % kSub == 0
                                     : kk + kStep == S && ((sc + 1) * S) % kSub == 0;
      if (!sub_end) continue;
      if constexpr (VEC) {
        // the four lanes of a fragment row hold a quarter of its norm each
        float xsq[MF][2], csq[NF][2];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = xn[mf][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            xsq[mf][h] = v;
            xn[mf][h] = 0.f;
          }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          float v = cn[nf];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          // lanes of group g now hold column g's; this lane's columns are
          // 2q and 2q + 1, held by lanes 8q and 8q + 4
          csq[nf][0] = __shfl_sync(0xffffffffu, v, 8 * q);
          csq[nf][1] = __shfl_sync(0xffffffffu, v, 8 * q + 4);
          cn[nf] = 0.f;
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              part[mf][nf][i] = (xsq[mf][i / 2] + csq[nf][i % 2]) - 2.f * part[mf][nf][i];
      }
      if constexpr (UNROLL > 1) {
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              total[mf][nf][i] += part[mf][nf][i];
              part[mf][nf][i] = 0.f;
            }
      }
    }

    if (sc != kChunkSlices - 1) continue;
    // the chunk ends with this slice: its total is part (UNROLL = 1) or total
    float (*chunk_total)[NF][4] = part;
    if constexpr (UNROLL > 1) chunk_total = total;
    if (scratch) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mf][nf][i] += chunk_total[mf][nf][i];
      if (j == Sn - 1) store(r0, c0, acc, false);
    } else {
      store(r0, c0, chunk_total, j >= kChunkSlices);
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
template <int BN, int BM, int BD, int UNROLL, int VEC, int LA>
int launch_depth(const float* x, const float* c, float* out, int N, int M, int D,
                 int order, int scratch, int sms, void* stream) {
  auto kernel = euclid_kernel<BN, BM, BD, UNROLL, VEC, LA>;
  const size_t smem = (size_t)(LA + 1) * stage_bytes<BN, BM, BD>();
  // above 48 KB, dynamic shared memory must be opted in to; the attribute
  // belongs to the current device, so it is set on every such launch
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  // blocks resident on one SM (registers and shared memory), asked once
  // per instantiation (every card of a host alike)
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t occ =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (occ != cudaSuccess) return (int)occ;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: every resident block walks tiles until none is left
  const long long fill = (long long)sms * per_sm;
  const long long blocks = tiles < fill ? tiles : fill;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(x, c, out, N, M, D, order,
                                                                    scratch);
  return (int)cudaGetLastError();
}

template <int BN, int BM, int BD, int UNROLL, int VEC>
int launch(const float* x, const float* c, float* out, int N, int M, int D, int order,
           int scratch, int lookahead, int sms, void* stream) {
  switch (lookahead) {
    case 0: return launch_depth<BN, BM, BD, UNROLL, VEC, 0>(x, c, out, N, M, D, order, scratch, sms, stream);
    case 1: return launch_depth<BN, BM, BD, UNROLL, VEC, 1>(x, c, out, N, M, D, order, scratch, sms, stream);
    case 2: return launch_depth<BN, BM, BD, UNROLL, VEC, 2>(x, c, out, N, M, D, order, scratch, sms, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Load an instantiation's kernels (every ring depth) into the current
// context now instead of at their first launch.
template <int BN, int BM, int BD, int UNROLL, int VEC>
int load() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, euclid_kernel<BN, BM, BD, UNROLL, VEC, 0>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, euclid_kernel<BN, BM, BD, UNROLL, VEC, 1>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, euclid_kernel<BN, BM, BD, UNROLL, VEC, 2>);
  return (int)e;
}

}  // namespace euclid

// One exported C symbol per instantiation:
//   int euclid_bn<BN>_bm<BM>_bd<BD>_u<UNROLL>_v<VEC>(x, c, out, N, M, D,
//                                                   order, scratch, lookahead, sms, stream)
// its shared-memory footprint at a ring depth,
//   long long euclid_bn<BN>_..._v<VEC>_smem(lookahead),
// and the loader of its kernels, int euclid_bn<BN>_..._v<VEC>_load().
#define EUCLID_INSTANTIATE(BN, BM, BD, U, V)                                           \
  extern "C" int euclid_bn##BN##_bm##BM##_bd##BD##_u##U##_v##V(                       \
      const float* x, const float* c, float* out, int N, int M, int D, int order,     \
      int scratch, int lookahead, int sms, void* stream) {                             \
    return euclid::launch<BN, BM, BD, U, V>(x, c, out, N, M, D, order, scratch,       \
                                            lookahead, sms, stream);                  \
  }                                                                                    \
  extern "C" long long euclid_bn##BN##_bm##BM##_bd##BD##_u##U##_v##V##_smem(          \
      int lookahead) {                                                                 \
    return (long long)(lookahead + 1) * (long long)euclid::stage_bytes<BN, BM, BD>(); \
  }                                                                                    \
  extern "C" int euclid_bn##BN##_bm##BM##_bd##BD##_u##U##_v##V##_load() {              \
    return euclid::load<BN, BM, BD, U, V>();                                           \
  }
