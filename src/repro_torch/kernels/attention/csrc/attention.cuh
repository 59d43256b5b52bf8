// Causal flash attention (blockwise online softmax) on Hopper, GQA-aware,
// on the tensor cores: fp32 inputs in 3xTF32, bf16 inputs in bf16 (two
// kernels, each with its own note below the fp32 kernel:
// `wg::flash_wgmma` on wgmma and TMA, and `flash_kernel_bf16` on
// mma.sync for tensors TMA cannot describe).
//
//   out[b, t, h, :] = softmax_s(q[b, t, h, :] . k[b, s, h / G, :] * scale
//                               + mask) @ v[b, :, h / G, :]
//
//   q: (B, Tq, H, Dh), k, v: (B, Tkv, Hk, Dh), out like q; fp32 or bf16
//   (all four of one type); G = H / Hk;
//   Dh a template parameter (a multiple of 8; the library instantiates
//   16, 64 and 128, the head dims of the configs the port serves; the
//   wgmma kernel also q and k at 192 over v at 128, latent attention's
//   expanded prefill, where out is (B, Tq, H, 128)).
//   The Pallas kernel's BlockSpecs take the whole Dh, so it runs at any
//   Dh; here the launcher refuses a Dh it has no instantiation for.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (`_fa_kernel`,
// src/repro/kernels/attention/attention.py). It computes what that kernel
// computes:
//
//   * one block owns one (b * H + h, q tile of BQ rows) pair; the kv grid
//     axis of the TPU becomes a loop inside the block, with the running
//     max m, sum l and accumulator in fp32;
//   * the GQA fold: q head h reads kv head h / G;
//   * the causal mask with `q_offset` (q row t sits at position
//     q_offset + t), and the ragged kv tail (positions >= Tkv) masked to
//     -1e30 with zero k and v, as the Pallas kernel masks them;
//   * scores are q.k times `scale`; exponentials are expf (not the fast
//     intrinsic);
//   * `sched` is inert; `lookahead` is the depth of the copy pipeline.
//
// What bounds it on an H100: 4 * B * H * Tq * Tkv * Dh / 2 causal
// operations against the bytes of q, k, v and out, so at deepseek-7b's
// prefill (B = 4, T = 512, H = 32, Dh = 128; 8.6 GFLOP) it is bound by
// operations: 0.128 ms on the CUDA cores (67 TFLOP/s fp32), against
// scaled_dot_product_attention's 0.28 ms in fp32. TF32 products keep
// about three digits, which chip_smoke.py's limit refuses; so both
// products run in 3xTF32 (sm90::mma_3xtf32, mma.sync m16n8k8): three
// TF32 products at 495 TFLOP/s, 0.052 ms of tensor-core time.
//
// The design:
//   * 256 threads, 8 warps; the block walks its q tile 128 rows at a time,
//     two 64-row passes side by side, and each warp owns 16 q rows. A
//     warp splits its q rows once and keeps them in registers as TF32
//     big and small A fragments (Dh registers a thread), beside its
//     16 x Dh fp32 output accumulator (Dh / 2) and m and l for its rows.
//     At Dh 128 and 255 registers ptxas spills 364–392 bytes a thread;
//     splitting q at each use instead spilled less (124–180) and ran 8 %
//     slower. At Dh 64 and 16 the fragments take 96 and 24 registers.
//     At Dh 16 the score product is two k8 steps and P V two n8 tiles:
//     every fragment loop runs over Dh / 8.
//   * K and V are staged 32 keys at a time into a ring of `lookahead + 1`
//     shared-memory stages (256 * Dh bytes each, 32 kB at Dh 128) by
//     cp.async, 16 bytes a copy where
//     k and v are 16-byte aligned, 4 bytes otherwise; keys past Tkv are
//     zero-filled. Once a slice has landed, the block splits it into a
//     split slice of (big, small) TF32 pairs (66 kB at Dh 128, rows
//     padded to Dh + 4 pairs, so the 8-byte fragment loads hit 32 banks
//     at every Dh that is a multiple of 8): every element is
//     split once, not once for each of the 8 warps that read it. Two
//     __syncthreads a slice.
//   * For each slice a warp forms its 16 x 32 scores S = Q K^T in
//     registers (4 m16n8 fragments), masks and scales them, and updates
//     the online softmax per row with quad shuffles: no score tile in
//     shared memory. P moves from the accumulator's fragment layout to
//     the A operand's by eight warp shuffles per 8-key step, then
//     O = O * alpha + P V, again in 3xTF32.
//   * The causal skip is per warp: a warp skips every slice its 16 rows
//     cannot see (so every slice hidden from a whole 64-row pass), and
//     the block stages only the slices some warp needs. The online
//     softmax therefore updates per 32-key slice, not per BKV block: the
//     same function, rounded in another order. BKV selects the
//     instantiation (and the plain version's blocks) and changes no
//     slice the kernel computes.
//   * Registers, not shared memory, bound the warps an SM holds: at Dh
//     128 the q fragments and the accumulator take 192 of a thread's 255,
//     so a block of 8 warps fills an SM, and the kernel is bound by latency
//     more than by the tensor cores' rate.
//   * Each ring depth is its own kernel (template parameter LA), picked by
//     the launcher: with the depth a run-time value and wait_group's
//     count behind a switch, the ring raced on the card at lookahead 1.
// Precision: plain TF32 (one product) is never used. chip_smoke.py reads
// 0.34 of its limit (rtol 1e-5, atol 1e-5) over every instantiation;
// TF32 products read 134 times it.
// Left for later in fp32: wgmma (TF32 only K-major from shared memory, so V would
// need a transposing stage), TMA copies, warp specialisation.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attention {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;           // q rows a warp
constexpr int kIterRows = kWarps * kRows;  // 128 q rows an iteration
constexpr int kKs = 32;             // keys a slice
constexpr float kNegInf = -1e30f;

// a slice of K and of V as copied, in floats, at head dim DH
template <int DH>
__host__ __device__ constexpr int stage_floats() { return 2 * kKs * DH; }
// split rows, in (big, small) pairs
template <int DH>
__host__ __device__ constexpr int split_ld() { return DH + 4; }

// shared memory of one ring stage and of the split slice, in bytes (the
// tuning space's Hopper capacity rule counts lookahead + 1 stages and one
// split slice)
template <int DH>
__host__ __device__ constexpr size_t stage_bytes() { return sizeof(float) * stage_floats<DH>(); }
template <int DH>
__host__ __device__ constexpr size_t split_bytes() { return sizeof(uint2) * 2 * kKs * split_ld<DH>(); }
// bf16 operands travel as their 16-bit patterns; a bf16 stage holds 32
// keys of K and of V as copied, rows padded to DH + 8 values (no split
// slice: the fragments are read from the stage itself)
using bf16_t = uint16_t;
template <int DH>
__host__ __device__ constexpr int ld_bf16() { return DH + 8; }
template <int DH>
__host__ __device__ constexpr size_t stage_bytes_bf16() {
  return sizeof(bf16_t) * 2 * kKs * ld_bf16<DH>();
}

template <int DH, class T = float>
__host__ __device__ constexpr size_t smem_bytes(int lookahead) {
  if constexpr (sizeof(T) == 2) {
    return (size_t)(lookahead + 1) * stage_bytes_bf16<DH>();
  } else {
    return (size_t)(lookahead + 1) * stage_bytes<DH>() + split_bytes<DH>();
  }
}

// Slice s's 16 x 32 score fragments of a warp whose rows sit at
// positions qpos0 and qpos0 + 8: masked (causal, and keys past Tkv, to
// -1e30) and scaled, then the online softmax per row: the running max m
// and sum l updated (quad shuffles), the scores replaced by
// p = expf(score - m) in fp32, the accumulator o rescaled. Both kernels'.
template <int NV>
__device__ __forceinline__ void online_softmax(float (&sc)[kKs / 8][4], float (&m)[2],
                                               float (&l)[2], float (&o)[NV][4], int s,
                                               int qpos0, int qd, int Tkv, int causal,
                                               float scale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nf = 0; nf < kKs / 8; ++nf)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = s * kKs + nf * 8 + 2 * qd + (i & 1);
      const int qpos = qpos0 + 8 * (i >> 1);
      float x = sc[nf][i] * scale;
      if ((causal && qpos < kpos) || kpos >= Tkv) x = kNegInf;
      sc[nf][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int nf = 0; nf < kKs / 8; ++nf)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(sc[nf][i] - m[i >> 1]);
      sc[nf][i] = p;
      sum[i >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nv][i] *= alpha[i >> 1];
}

// x[0..3] as four (big, small) TF32 pairs at dst[0..3]
__device__ __forceinline__ void split4(const float* src, uint2* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  uint4 lo, hi;
  sm90::tf32_split(x.x, lo.x, lo.y);
  sm90::tf32_split(x.y, lo.z, lo.w);
  sm90::tf32_split(x.z, hi.x, hi.y);
  sm90::tf32_split(x.w, hi.z, hi.w);
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + 2) = hi;
}

// One kernel per ring depth LA (= lookahead), picked by the launcher: the
// ring's slot arithmetic and the wait_group count are compile-time
// constants, and each depth gets its own register allocation.
template <int DH, int BQ, int BKV, int LA>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int B, int Tq,
             int Tkv, int H, int Hk, int causal, int q_offset, float scale) {
  static_assert(BQ % kIterRows == 0 && BKV % kKs == 0,
                "blocks are multiples of the 128-row iteration and the 32-key slice");
  static_assert(DH % 8 == 0 && DH >= 8, "the head dim is a multiple of the k8 step");
  constexpr int kDh = DH;
  constexpr int kStageFloats = stage_floats<DH>();
  constexpr int kLdS = split_ld<DH>();
  extern __shared__ __align__(16) float smem[];
  uint2* const k2 = reinterpret_cast<uint2*>(smem + (LA + 1) * kStageFloats);
  uint2* const v2 = k2 + kKs * kLdS;

  const int n_q = (Tq + BQ - 1) / BQ;
  const int iq = blockIdx.x % n_q;
  const int bh = blockIdx.x / n_q;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  constexpr int la = LA, stages = LA + 1;
  const int n_kv = (Tkv + kKs - 1) / kKs;
  const size_t q_stride = (size_t)H * kDh;     // between consecutive t
  const size_t kv_stride = (size_t)Hk * kDh;
  const bool vec = (((uintptr_t)k | (uintptr_t)v) & 15) == 0;
  // the slices a run of q rows ending at `last` can see
  auto visible = [&](int last) {
    return causal ? min(n_kv, (q_offset + last) / kKs + 1) : n_kv;
  };

  auto issue = [&](int s, int slot) {
    float* ks = smem + (size_t)slot * kStageFloats;
    float* vs = ks + kKs * kDh;
    const int s0 = s * kKs;
    if (vec) {
      for (int e = tid; e < kKs * (kDh / 4); e += kThreads) {
        const int r = e / (kDh / 4), d = (e % (kDh / 4)) * 4;
        const bool in = s0 + r < Tkv;
        const size_t off = ((size_t)b * Tkv + s0 + r) * kv_stride + (size_t)hk * kDh + d;
        sm90::cp_async16(ks + r * kDh + d, in ? k + off : k, in ? 16 : 0);
        sm90::cp_async16(vs + r * kDh + d, in ? v + off : v, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kKs * kDh; e += kThreads) {
        const int r = e / kDh, d = e % kDh;
        const bool in = s0 + r < Tkv;
        const size_t off = ((size_t)b * Tkv + s0 + r) * kv_stride + (size_t)hk * kDh + d;
        sm90::cp_async4(ks + r * kDh + d, in ? k + off : k, in ? 4 : 0);
        sm90::cp_async4(vs + r * kDh + d, in ? v + off : v, in ? 4 : 0);
      }
    }
  };
  // the landed slice in ring slot `slot`, split once for every warp
  auto convert = [&](int slot) {
    const float* ks = smem + (size_t)slot * kStageFloats;
    const float* vs = ks + kKs * kDh;
    for (int e = tid; e < kKs * (kDh / 4); e += kThreads) {
      const int r = e / (kDh / 4), d = (e % (kDh / 4)) * 4;
      split4(ks + r * kDh + d, k2 + r * kLdS + d);
      split4(vs + r * kDh + d, v2 + r * kLdS + d);
    }
  };

  const int tile_end = min(iq * BQ + BQ, Tq);
#pragma unroll 1
  for (int q0 = iq * BQ; q0 < tile_end; q0 += kIterRows) {
    const int r0 = q0 + warp * kRows;  // this warp's first q row
    const int n_warp = r0 < Tq ? visible(min(r0 + kRows, Tq) - 1) : 0;
    const int n_slices = visible(min(q0 + kIterRows, Tq) - 1);

    // this warp's q rows as split A fragments, one per 8-wide d step
    uint32_t qb[kDh / 8][4], qs[kDh / 8][4];
#pragma unroll
    for (int ks = 0; ks < kDh / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + g + 8 * (i & 1), d = ks * 8 + qd + 4 * (i >> 1);
        const float x = t < Tq ? q[((size_t)b * Tq + t) * q_stride + (size_t)h * kDh + d] : 0.f;
        sm90::tf32_split(x, qb[ks][i], qs[ks][i]);
      }
    float o[kDh / 8][4];
#pragma unroll
    for (int nv = 0; nv < kDh / 8; ++nv)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nv][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    __syncthreads();  // the previous iteration is done with every stage
    for (int s = 0; s < la; ++s) {
      if (s < n_slices) issue(s, s);
      sm90::cp_async_commit();
    }
#pragma unroll 1
    for (int s = 0; s < n_slices; ++s) {
      if constexpr (la == 0) {
        issue(s, 0);  // slot 0 was split before the last barrier
        sm90::cp_async_commit();
      }
      sm90::cp_async_wait(la == 0 ? 0 : la - 1);
      // slice s has landed, and every warp is done with the split slice
      __syncthreads();
      if constexpr (la > 0) {
        if (s + la < n_slices) issue(s + la, (s + la) % stages);  // split already
        sm90::cp_async_commit();
      }
      convert(s % stages);
      __syncthreads();  // the split slice s is complete
      if (s >= n_warp) continue;  // hidden from all of this warp's rows

      // scores S = Q K^T: 16 rows x 32 keys, 4 fragments
      float sc[kKs / 8][4];
#pragma unroll
      for (int nf = 0; nf < kKs / 8; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nf][i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < kDh / 8; ++kd) {
#pragma unroll
        for (int nf = 0; nf < kKs / 8; ++nf) {
          const uint2* kr = k2 + (nf * 8 + g) * kLdS + kd * 8 + qd;
          const uint2 x0 = kr[0], x1 = kr[4];
          const uint32_t bb[2] = {x0.x, x1.x}, bs[2] = {x0.y, x1.y};
          sm90::mma_3xtf32(sc[nf], qb[kd], qs[kd], bb, bs);
        }
      }

      // mask, scale, and the online softmax per row (rows g and g + 8)
      online_softmax(sc, m, l, o, s, q_offset + r0 + g, qd, Tkv, causal, scale);

      // O += P V: P's accumulator fragments become A fragments by
      // shuffles (A[g][c] sits in lane 4g + c/2, register c % 2)
      const int src = (lane & ~3) | (qd >> 1);
      const bool odd = qd & 1;
#pragma unroll
      for (int kk = 0; kk < kKs / 8; ++kk) {
        float pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int from = src + 2 * half;
          const float x0 = __shfl_sync(0xffffffffu, sc[kk][0], from);
          const float x1 = __shfl_sync(0xffffffffu, sc[kk][1], from);
          const float y0 = __shfl_sync(0xffffffffu, sc[kk][2], from);
          const float y1 = __shfl_sync(0xffffffffu, sc[kk][3], from);
          pa[2 * half] = odd ? x1 : x0;
          pa[2 * half + 1] = odd ? y1 : y0;
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sm90::tf32_split(pa[i], ab[i], as[i]);
#pragma unroll
        for (int nv = 0; nv < kDh / 8; ++nv) {
          const uint2* vr = v2 + (kk * 8 + qd) * kLdS + nv * 8 + g;
          const uint2 x0 = vr[0], x1 = vr[4 * kLdS];
          const uint32_t bb[2] = {x0.x, x1.x}, bs[2] = {x0.y, x1.y};
          sm90::mma_3xtf32(o[nv], ab, as, bb, bs);
        }
      }
    }
    sm90::cp_async_wait(0);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + g + 8 * r;
      if (t >= Tq) continue;
      const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
      float* dst = out + ((size_t)b * Tq + t) * q_stride + (size_t)h * kDh + 2 * qd;
#pragma unroll
      for (int nv = 0; nv < kDh / 8; ++nv) {
        dst[nv * 8] = o[nv][2 * r] * inv_l;
        dst[nv * 8 + 1] = o[nv][2 * r + 1] * inv_l;
      }
    }
  }
}

// `flash_kernel_bf16` (symbols `_bf16_mma`), the bf16 kernel for tensors
// TMA cannot describe: q, k, v and out bf16, everything else as above
// (fp32 scores, masks, running max and sum, expf, fp32 accumulators).
// One m16n8k16 bf16 product (sm90::mma_bf16_m16n8k16, exact products)
// for S = Q K^T and one for P V: no split, no split slice. P is rounded
// to bf16 (nearest even) before P V, as the reference's
// `p.astype(v.dtype)`; the row sums take the unrounded p, as its
// `jnp.sum(p)` does; the output is acc / l rounded to bf16.
//   * a warp's q rows are A fragments in registers (Dh / 4 registers a
//     thread: two bf16 values each);
//   * K and V slices are staged as bf16 by cp.async (16-byte copies;
//     plain 2-byte loads and stores where k or v is not 16-byte aligned)
//     into a ring of `lookahead + 1` stages of 128 * (Dh + 8) bytes, rows
//     padded to Dh + 8 values: the K fragment registers are one 32-bit
//     load of two d-adjacent values each, conflict-free;
//   * S's accumulator fragments are already P's A fragments (keys 2q,
//     2q + 1 and 2q + 8, 2q + 9 of a 16-key step): packed, no shuffles;
//   * V is (keys, Dh), Dh contiguous, and the .col B fragment of P V
//     wants key-adjacent pairs: two 16-bit reads packed per register
//     (sm90::pack_u16x2), not ldmatrix.trans;
//   * one __syncthreads a slice (two at lookahead 0).
// What bounds it: at deepseek-7b's prefill (B 4, T 512, H 32, Dh 128,
// causal) 8.6 GFLOP at 989 TFLOP/s (0.0087 ms) against 67 MB (0.020 ms):
// bytes; at qwen3-moe's (Dh 64, 32 heads over 4) 0.0056 ms, bytes.
template <int DH, int BQ, int BKV, int LA>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                  const bf16_t* __restrict__ v, bf16_t* __restrict__ out, int B, int Tq,
                  int Tkv, int H, int Hk, int causal, int q_offset, float scale) {
  static_assert(BQ % kIterRows == 0 && BKV % kKs == 0,
                "blocks are multiples of the 128-row iteration and the 32-key slice");
  static_assert(DH % 16 == 0, "the head dim is a multiple of the k16 step");
  constexpr int kLd = ld_bf16<DH>();
  constexpr int kStage = 2 * kKs * kLd;  // elements of one ring stage
  extern __shared__ __align__(16) float smem[];
  bf16_t* const sm = reinterpret_cast<bf16_t*>(smem);

  const int n_q = (Tq + BQ - 1) / BQ;
  const int iq = blockIdx.x % n_q;
  const int bh = blockIdx.x / n_q;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  constexpr int la = LA, stages = LA + 1;
  const int n_kv = (Tkv + kKs - 1) / kKs;
  const size_t q_stride = (size_t)H * DH;
  const size_t kv_stride = (size_t)Hk * DH;
  const bool vec = (((uintptr_t)k | (uintptr_t)v) & 15) == 0;
  auto visible = [&](int last) {
    return causal ? min(n_kv, (q_offset + last) / kKs + 1) : n_kv;
  };

  auto issue = [&](int s, int slot) {
    bf16_t* ks = sm + (size_t)slot * kStage;
    bf16_t* vs = ks + kKs * kLd;
    const int s0 = s * kKs;
    if (vec) {
      for (int e = tid; e < kKs * (DH / 8); e += kThreads) {
        const int r = e / (DH / 8), d = (e % (DH / 8)) * 8;
        const bool in = s0 + r < Tkv;
        const size_t off = ((size_t)b * Tkv + s0 + r) * kv_stride + (size_t)hk * DH + d;
        sm90::cp_async16(ks + r * kLd + d, in ? k + off : k, in ? 16 : 0);
        sm90::cp_async16(vs + r * kLd + d, in ? v + off : v, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kKs * DH; e += kThreads) {
        const int r = e / DH, d = e % DH;
        const bool in = s0 + r < Tkv;
        const size_t off = ((size_t)b * Tkv + s0 + r) * kv_stride + (size_t)hk * DH + d;
        ks[r * kLd + d] = in ? k[off] : (bf16_t)0;
        vs[r * kLd + d] = in ? v[off] : (bf16_t)0;
      }
    }
  };
  auto ld32 = [](const bf16_t* p) { return *reinterpret_cast<const uint32_t*>(p); };

  const int tile_end = min(iq * BQ + BQ, Tq);
#pragma unroll 1
  for (int q0 = iq * BQ; q0 < tile_end; q0 += kIterRows) {
    const int r0 = q0 + warp * kRows;  // this warp's first q row
    const int n_warp = r0 < Tq ? visible(min(r0 + kRows, Tq) - 1) : 0;
    const int n_slices = visible(min(q0 + kIterRows, Tq) - 1);

    // this warp's q rows as A fragments, one per 16-wide d step
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + g + 8 * (i & 1), d = kd * 16 + 2 * qd + 8 * (i >> 1);
        const bf16_t* src = q + ((size_t)b * Tq + t) * q_stride + (size_t)h * DH + d;
        qa[kd][i] = t < Tq ? sm90::pack_u16x2(src[0], src[1]) : 0u;
      }
    float o[DH / 8][4];
#pragma unroll
    for (int nv = 0; nv < DH / 8; ++nv)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nv][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    __syncthreads();  // the previous iteration is done with every stage
    for (int s = 0; s < la; ++s) {
      if (s < n_slices) issue(s, s);
      sm90::cp_async_commit();
    }
#pragma unroll 1
    for (int s = 0; s < n_slices; ++s) {
      if constexpr (la == 0) {
        __syncthreads();  // every warp is done with the only stage
        issue(s, 0);
        sm90::cp_async_commit();
      }
      sm90::cp_async_wait(la == 0 ? 0 : la - 1);
      __syncthreads();  // slice s has landed; slot (s - 1) % stages is free
      if constexpr (la > 0) {
        if (s + la < n_slices) issue(s + la, (s + la) % stages);
        sm90::cp_async_commit();
      }
      if (s >= n_warp) continue;  // hidden from all of this warp's rows
      const bf16_t* ks = sm + (size_t)(s % stages) * kStage;
      const bf16_t* vs = ks + kKs * kLd;

      // scores S = Q K^T: 16 rows x 32 keys, 4 fragments
      float sc[kKs / 8][4];
#pragma unroll
      for (int nf = 0; nf < kKs / 8; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nf][i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
#pragma unroll
        for (int nf = 0; nf < kKs / 8; ++nf) {
          const bf16_t* kr = ks + (nf * 8 + g) * kLd + kd * 16 + 2 * qd;
          const uint32_t kb[2] = {ld32(kr), ld32(kr + 8)};
          sm90::mma_bf16_m16n8k16(sc[nf], qa[kd], kb);
        }

      online_softmax(sc, m, l, o, s, q_offset + r0 + g, qd, Tkv, causal, scale);

      // O += P V, 16 keys a step: P rounded to bf16 in the A layout
#pragma unroll
      for (int kk = 0; kk < kKs / 16; ++kk) {
        const uint32_t pa[4] = {sm90::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                                sm90::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                                sm90::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                sm90::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int nv = 0; nv < DH / 8; ++nv) {
          const bf16_t* vr = vs + (kk * 16 + 2 * qd) * kLd + nv * 8 + g;
          const uint32_t vb[2] = {sm90::pack_u16x2(vr[0], vr[kLd]),
                                  sm90::pack_u16x2(vr[8 * kLd], vr[9 * kLd])};
          sm90::mma_bf16_m16n8k16(o[nv], pa, vb);
        }
      }
    }
    sm90::cp_async_wait(0);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + g + 8 * r;
      if (t >= Tq) continue;
      const float lr = fmaxf(l[r], 1e-30f);
      bf16_t* dst = out + ((size_t)b * Tq + t) * q_stride + (size_t)h * DH + 2 * qd;
#pragma unroll
      for (int nv = 0; nv < DH / 8; ++nv)
        *reinterpret_cast<uint32_t*>(dst + nv * 8) =
            sm90::pack_bf16x2(o[nv][2 * r] / lr, o[nv][2 * r + 1] / lr);
    }
  }
}

// the kernel of one instantiation, by operand type
template <int DH, int BQ, int BKV, int LA>
constexpr auto kernel_for(const float*) { return flash_kernel<DH, BQ, BKV, LA>; }
template <int DH, int BQ, int BKV, int LA>
constexpr auto kernel_for(const bf16_t*) { return flash_kernel_bf16<DH, BQ, BKV, LA>; }

// Host launcher for one instantiation: on `stream`, allocates nothing,
// does not synchronise; returns the launch status (cudaGetLastError),
// which the Python wrapper turns into an exception.
template <class T, int DH, int BQ, int BKV, int LA>
int launch_depth(const T* q, const T* k, const T* v, T* out, int B,
                 int Tq, int Tkv, int H, int Hk, int causal, int q_offset, float scale,
                 void* stream) {
  const size_t smem = smem_bytes<DH, T>(LA);
  const auto kernel = kernel_for<DH, BQ, BKV, LA>(q);
  // above 48 KB, dynamic shared memory must be opted in to; the attribute
  // belongs to the current device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)B * H * ((Tq + BQ - 1) / BQ);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <class T, int DH, int BQ, int BKV>
int launch(const T* q, const T* k, const T* v, T* out, int B,
           int Tq, int Tkv, int H, int Hk, int causal, int q_offset, float scale,
           int lookahead, void* stream) {
  switch (lookahead) {
    case 0: return launch_depth<T, DH, BQ, BKV, 0>(q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, stream);
    case 1: return launch_depth<T, DH, BQ, BKV, 1>(q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, stream);
    case 2: return launch_depth<T, DH, BQ, BKV, 2>(q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------ the bf16 wgmma kernel (path "wgmma")
// `wg::flash_wgmma` (symbols `_bf16`), for q, k and v that TMA can describe
// (16-byte aligned; their rows, H * Dh and Hk * Dh values, always are):
// FA3's shape on Hopper's own machinery, the same function as
// `flash_kernel_bf16` above. Its bound is unchanged (deepseek-7b's
// prefill: 0.0087 ms of bf16 products against 0.020 ms of bytes).
//   * A persistent grid of at most as many blocks as are resident on the
//     SMs walks items of (b, h, block_q rows), the last q tiles first
//     (the heaviest when causal: `sched` is inert, this order is the
//     kernel's own), each item in 128-row units, its last unit first.
//   * A block is a producer warpgroup (setmaxnreg: 40 registers; at 24 its
//     walk spilled) and two consumer warpgroups of 64 q rows each (232).
//     One producer thread
//     loads a unit's q tile by TMA into its own buffer (full and empty
//     mbarriers), then K and V tiles of 64 keys (block_kv 64) or 128 (any
//     larger block_kv) into a ring of `lookahead + 1` stages, each with a
//     K-full, a V-full and an empty mbarrier, so S can start before V has
//     landed. Boxes are one head's rows of 16 or 64 values (Dh 128 takes
//     two boxes a tile: the encoder refuses a box wider than the 128-byte
//     swizzle), swizzled over their 32 or 128 bytes; TMA fills zeros past
//     Tq and Tkv, so the ragged q tile and kv tail need no masked copy.
//   * S = Q K^T by wgmma m64nKTk16 (sm90::Wgmma<KT>::ss), Q and K both
//     K-major (Dh contiguous) from shared memory; the mask (causal with
//     q_offset, keys past Tkv, -1e30), the scale and the online softmax
//     (expf, quad shuffles for the rows' max and sum) on the accumulator
//     layout in registers; P packed to bf16 (cvt.rn.bf16x2) straight from
//     the accumulators into wgmma's register A operand; O += P V by
//     wgmma m64nDHk16 (sm90::Wgmma<DH>::rs), V MN-major from shared
//     memory (the descriptor's transpose bit). The row sums take the
//     unrounded p; the output is O / l rounded to bf16, written from
//     registers.
//   * The two consumer warpgroups interleave on the tensor cores: one
//     runs its softmax while the other's products run. Only tiles that
//     reach the diagonal or the kv tail are masked element by element.
// What still holds it back: the softmax's fp32 work on the CUDA cores
// (expf, the mask, the max and sum) between a warpgroup's products; S,
// the softmax and P V run one after the other inside a warpgroup (FA3's
// pipelining, the next tile's S issued before this tile's P V, was
// slower here in a trial, with two P tiles live in registers); the q
// buffer is loaded only once both warpgroups are done with the previous
// unit; diagonal tiles are computed whole and masked.
namespace wg {

constexpr int kThreads = 384;       // a producer warpgroup and two consumer warpgroups
constexpr int kRows = 128;          // q rows of a unit: 64 for each consumer warpgroup
constexpr int kBarrierBytes = 128;  // q full/empty, and k full, v full, empty for <= 3 stages

// keys of a K (and V) tile: 64 at block_kv 64, else 128
template <int BKV>
__host__ __device__ constexpr int kv_tile() { return BKV < 128 ? 64 : 128; }
// values of a TMA box's row (16 or 64: at most one 128-byte swizzle span)
// and that row's bytes, the swizzle span
template <int DH>
__host__ __device__ constexpr int box_d() { return DH < 64 ? DH : 64; }
template <int DH>
__host__ __device__ constexpr int span() { return 2 * box_d<DH>(); }
// one ring stage: a K tile of head dim DH and a V tile of head dim DV
template <int DH, int BKV, int DV = DH>
__host__ __device__ constexpr size_t stage_bytes() { return 2 * (size_t)kv_tile<BKV>() * (DH + DV); }
// the dynamic shared memory a block asks for: the q tile of a unit, the
// ring, its barriers, and room to align everything to 1024 bytes
template <int DH, int BKV, int DV = DH>
__host__ __device__ constexpr size_t smem_bytes(int lookahead) {
  return 1024 + kBarrierBytes + 2 * (size_t)kRows * DH +
         (size_t)(lookahead + 1) * stage_bytes<DH, BKV, DV>();
}

// DV, the value head dim, is DH but for latent attention's expanded
// prefill (q and k [nope 128 | rope 64], v 128): a V tile then has fewer
// boxes than a K tile, O and the output DV columns. Both take boxes of 64
// values (one 128-byte swizzle span), so the tiles' layouts are alike.
template <int DH, int BQ, int BKV, int DV = DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16_t* __restrict__ out, int B, int Tq,
            int Tkv, int H, int Hk, int causal, int q_offset, float scale, int stages) {
  constexpr int KT = kv_tile<BKV>(), BX = box_d<DH>(), SW = span<DH>(), NC = DH / BX;
  constexpr int NCV = DV / BX;     // boxes of a V row
  constexpr int kQ = kRows * DH;   // elements of the q tile
  constexpr int kK = KT * DH;      // elements of a K tile
  constexpr int kV = KT * DV;      // elements of a V tile
  constexpr int kUnits = BQ / kRows;
  static_assert(DH % 16 == 0 && DH % BX == 0, "the head dim is whole boxes of k16 steps");
  static_assert(DV % 16 == 0 && DV % BX == 0 && box_d<DV>() == BX,
                "the value head dim is whole boxes of the same width");
  static_assert(BQ % kRows == 0, "block_q is a whole number of 128-row units");
  extern __shared__ __align__(16) float smem[];
  bf16_t* const qs = reinterpret_cast<bf16_t*>(
      reinterpret_cast<char*>(smem) + ((1024 - (sm90::smem_addr(smem) & 1023)) & 1023));
  bf16_t* const ring = qs + kQ;  // stage s: K at ring + s (kK + kV), V after it
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * (kK + kV));
  uint64_t* const q_empty = q_full + 1;
  uint64_t* const k_full = q_full + 2;
  uint64_t* const v_full = k_full + stages;
  uint64_t* const empty = v_full + stages;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 2);  // one arrival from each consumer warpgroup
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int n_qt = (Tq + BQ - 1) / BQ, n_kt = (Tkv + KT - 1) / KT;
  const int n_items = B * H * n_qt;
  // item x's u-th unit: the last q tiles (the heaviest when causal) first
  auto unit = [&](int x, int u, int& b, int& h, int& q0) {
    const int bh = x % (B * H);
    b = bh / H;
    h = bh % H;
    q0 = (n_qt - 1 - x / (B * H)) * BQ + u * kRows;
  };
  // the kv tiles a unit's rows can see
  auto visible = [&](int q0) {
    const int last = min(q0 + kRows, Tq) - 1;
    return causal ? min(n_kt, (q_offset + last) / KT + 1) : n_kt;
  };
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (wg == 0) {
    // the producer: one thread loads each unit's q tile, then its K and V tiles
    sm90::setmaxnreg_dec<40>();
    if (t == 0) {
      int it = 0, qi = 0;
      for (int x = blockIdx.x; x < n_items; x += gridDim.x)
        for (int u = kUnits - 1; u >= 0; --u) {
          int b, h, q0;
          unit(x, u, b, h, q0);
          if (q0 >= Tq) continue;
          const int hk = h / (H / Hk);
          sm90::mbar_wait(q_empty, (qi++ & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(q_full, 2 * kQ);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            sm90::tma_load_4d(qs + c * kRows * BX, &tq, q_full, c * BX, h, q0, b);
          const int n = visible(q0);
          for (int kt = 0; kt < n; ++kt, ++it) {
            const int st = it % stages;
            sm90::mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
            bf16_t* ks = ring + (size_t)st * (kK + kV);
            sm90::mbar_arrive_expect_tx(&k_full[st], 2 * kK);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              sm90::tma_load_4d(ks + c * KT * BX, &tk, &k_full[st], c * BX, hk, kt * KT, b);
            sm90::mbar_arrive_expect_tx(&v_full[st], 2 * kV);
#pragma unroll
            for (int c = 0; c < NCV; ++c)
              sm90::tma_load_4d(ks + kK + c * KT * BX, &tv, &v_full[st], c * BX, hk, kt * KT,
                                b);
          }
        }
    }
  } else {
    // a consumer: 64 q rows of each unit
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int warp = t / 32, g = (t % 32) / 4, qd = t % 4;
    const bf16_t* const qw = qs + 64 * cw * BX;  // this warpgroup's rows of every q box
    float sacc[KT / 2], o[DV / 2], m[2], l[2];
    uint32_t pa[KT / 16][4];  // P, rounded to bf16, in the register A operand's layout

    // S = Q K^T of the tile in stage st: 64 rows x KT keys, Q and K both
    // K-major in shared memory
    auto issue_s = [&](int st) {
      const bf16_t* ks = ring + (size_t)st * (kK + kV);
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < DH / 16; ++s) {
        const int c = s * 16 / BX, kin = s * 16 % BX;
        sm90::Wgmma<KT>::template ss<0>(
            sacc, sm90::smem_desc(qw + c * kRows * BX + kin, 0, 8 * SW, SW),
            sm90::smem_desc(ks + c * KT * BX + kin, 0, 8 * SW, SW), s > 0 ? 1 : 0);
      }
      sm90::wgmma_commit();
    };
    // O += P V with P from registers, V MN-major (Dh contiguous) in shared memory
    auto issue_pv = [&](int st) {
      const bf16_t* vs = ring + (size_t)st * (kK + kV) + kK;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        sm90::Wgmma<DV>::template rs<1>(
            o, pa[kk], sm90::smem_desc(vs + kk * 16 * BX, KT * SW, 8 * SW, SW), 1);
      sm90::wgmma_commit();
    };
    // tile kt's scores in sacc: mask (where the tile reaches the diagonal
    // or the kv tail), scale, and the online softmax per row (rows r0 and
    // r0 + 8: a row's keys lie in the four threads of a quad); O rescaled;
    // P rounded to bf16 into pa, in the register A operand's layout (keys
    // 16kk + 2q, +1 and +8, +9)
    auto softmax = [&](int kt, int r0, int row_lo) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) sm90::fence_operand(sacc[i]);
      const bool masked = (causal && kt * KT + KT - 1 > q_offset + row_lo) ||
                          kt * KT + KT > Tkv;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float xv = sacc[4 * j + i] * scale;
          if (masked) {
            const int kpos = kt * KT + 8 * j + 2 * qd + (i & 1);
            const int qpos = q_offset + r0 + 8 * (i >> 1);
            if ((causal && qpos < kpos) || kpos >= Tkv) xv = kNegInf;
          }
          sacc[4 * j + i] = xv;
          mx[i >> 1] = fmaxf(mx[i >> 1], xv);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const float p = expf(sacc[i] - m[(i >> 1) & 1]);
        sacc[i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) {
        sm90::fence_operand(o[i]);
        o[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = sm90::pack_bf16x2(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
    };

    int it = 0, qi = 0;
    for (int x = blockIdx.x; x < n_items; x += gridDim.x)
      for (int u = kUnits - 1; u >= 0; --u) {
        int b, h, q0;
        unit(x, u, b, h, q0);
        if (q0 >= Tq) continue;
        const int row_lo = q0 + 64 * cw;              // this warpgroup's first row
        const int r0 = row_lo + 16 * warp + g;        // this thread's rows: r0, r0 + 8
        sm90::mbar_wait(q_full, qi++ & 1);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
        m[0] = m[1] = kNegInf;
        l[0] = l[1] = 0.f;
        const int n = visible(q0);
        // one tile at a time: S, the softmax, P V; the two consumer
        // warpgroups interleave on the tensor cores
        for (int kt = 0; kt < n; ++kt, ++it) {
          const int st = it % stages;
          const uint32_t ph = (it / stages) & 1;
          sm90::mbar_wait(&k_full[st], ph);
          issue_s(st);
          sm90::wgmma_wait<0>();
          softmax(kt, r0, row_lo);
          sm90::mbar_wait(&v_full[st], ph);
          issue_pv(st);
          sm90::wgmma_wait<0>();
          if (t == 0) sm90::mbar_arrive(&empty[st]);
        }
        if (t == 0) sm90::mbar_arrive(q_empty);  // every S of the unit is done
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) sm90::fence_operand(o[i]);

#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= Tq) continue;
          const float lr = fmaxf(l[r], 1e-30f);
          bf16_t* dst = out + (((size_t)b * Tq + row) * H + h) * DV + 2 * qd;
#pragma unroll
          for (int j = 0; j < DV / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                sm90::pack_bf16x2(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
        }
      }
  }
}

// Host launcher: 4-d tensor maps (Dh, heads, positions, batch) of q, k and
// v (v's of DV values), boxes of one head's 16- or 64-value rows, swizzled
// over their span; a persistent grid of at most the blocks resident on all
// SMs. The caller guarantees what TMA needs: q, k and v 16-byte aligned.
template <int DH, int BQ, int BKV, int DV = DH>
int launch(const bf16_t* q, const bf16_t* k, const bf16_t* v, bf16_t* out, int B, int Tq,
           int Tkv, int H, int Hk, int causal, int q_offset, float scale, int lookahead,
           void* stream) {
  if (lookahead < 0 || lookahead > 2) return (int)cudaErrorInvalidValue;
  constexpr int BX = box_d<DH>();
  CUtensorMap tq, tk, tv;
  const uint64_t q_dims[4] = {(uint64_t)DH, (uint64_t)H, (uint64_t)Tq, (uint64_t)B};
  const uint64_t q_strides[3] = {2ull * DH, 2ull * H * DH, 2ull * Tq * H * DH};
  const uint32_t q_box[4] = {BX, 1, kRows, 1};
  int rc = sm90::make_tile_map(&tq, q, 4, q_dims, q_strides, q_box, span<DH>());
  const uint64_t kv_dims[4] = {(uint64_t)DH, (uint64_t)Hk, (uint64_t)Tkv, (uint64_t)B};
  const uint64_t kv_strides[3] = {2ull * DH, 2ull * Hk * DH, 2ull * Tkv * Hk * DH};
  const uint32_t kv_box[4] = {BX, 1, (uint32_t)kv_tile<BKV>(), 1};
  const uint64_t v_dims[4] = {(uint64_t)DV, (uint64_t)Hk, (uint64_t)Tkv, (uint64_t)B};
  const uint64_t v_strides[3] = {2ull * DV, 2ull * Hk * DV, 2ull * Tkv * Hk * DV};
  if (rc == 0) rc = sm90::make_tile_map(&tk, k, 4, kv_dims, kv_strides, kv_box, span<DH>());
  if (rc == 0) rc = sm90::make_tile_map(&tv, v, 4, v_dims, v_strides, kv_box, span<DH>());
  if (rc != 0) return rc;
  const auto kernel = flash_wgmma<DH, BQ, BKV, DV>;
  const size_t smem = smem_bytes<DH, BKV, DV>(lookahead);
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
  const long long items = (long long)B * H * ((Tq + BQ - 1) / BQ);
  if (items <= 0) return (int)cudaSuccess;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long fill = (long long)sms * per_sm;
  const long long blocks = items < fill ? items : fill;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, lookahead + 1);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace attention

// Exported C symbols per instantiation and type (fp32 without a suffix;
// bf16 q, k, v and out with `_bf16`, the wgmma kernel, or `_bf16_mma`, the
// mma.sync kernel for tensors TMA cannot describe; `_dv<DV>` where v's head
// dim differs from q's and k's, on the wgmma kernel only):
//   int attention_dh<DH>[_dv<DV>]_bq<BQ>_bkv<BKV>[_bf16|_bf16_mma](q, k, v,
//                                 out, B, Tq, Tkv, H, Hk, causal, q_offset,
//                                 scale, lookahead, stream)
//   long long attention_dh<DH>[_dv<DV>]_bq<BQ>_bkv<BKV>[_bf16|_bf16_mma]_smem(lookahead):
//     the dynamic shared memory of one block, as the launcher asks for it
#define ATTENTION_INSTANTIATE_T(DH, BQ, BKV, T, SFX)                                    \
  extern "C" int attention_dh##DH##_bq##BQ##_bkv##BKV##SFX(                             \
      const T* q, const T* k, const T* v, T* out, int B, int Tq, int Tkv, int H,        \
      int Hk, int causal, int q_offset, float scale, int lookahead, void* stream) {     \
    return attention::launch<T, DH, BQ, BKV>(q, k, v, out, B, Tq, Tkv, H, Hk, causal,   \
                                             q_offset, scale, lookahead, stream);       \
  }                                                                                     \
  extern "C" long long attention_dh##DH##_bq##BQ##_bkv##BKV##SFX##_smem(int lookahead) { \
    return (long long)attention::smem_bytes<DH, T>(lookahead);                          \
  }
#define ATTENTION_INSTANTIATE(DH, BQ, BKV) ATTENTION_INSTANTIATE_T(DH, BQ, BKV, float, )
#define ATTENTION_INSTANTIATE_BF16_MMA(DH, BQ, BKV) \
  ATTENTION_INSTANTIATE_T(DH, BQ, BKV, attention::bf16_t, _bf16_mma)
#define ATTENTION_INSTANTIATE_BF16(DH, BQ, BKV)                                          \
  extern "C" int attention_dh##DH##_bq##BQ##_bkv##BKV##_bf16(                            \
      const attention::bf16_t* q, const attention::bf16_t* k, const attention::bf16_t* v, \
      attention::bf16_t* out, int B, int Tq, int Tkv, int H, int Hk, int causal,         \
      int q_offset, float scale, int lookahead, void* stream) {                          \
    return attention::wg::launch<DH, BQ, BKV>(q, k, v, out, B, Tq, Tkv, H, Hk, causal,   \
                                              q_offset, scale, lookahead, stream);       \
  }                                                                                      \
  extern "C" long long attention_dh##DH##_bq##BQ##_bkv##BKV##_bf16_smem(int lookahead) { \
    return (long long)attention::wg::smem_bytes<DH, BKV>(lookahead);                     \
  }
#define ATTENTION_INSTANTIATE_BF16_DV(DH, DV, BQ, BKV)                                    \
  extern "C" int attention_dh##DH##_dv##DV##_bq##BQ##_bkv##BKV##_bf16(                    \
      const attention::bf16_t* q, const attention::bf16_t* k, const attention::bf16_t* v, \
      attention::bf16_t* out, int B, int Tq, int Tkv, int H, int Hk, int causal,         \
      int q_offset, float scale, int lookahead, void* stream) {                          \
    return attention::wg::launch<DH, BQ, BKV, DV>(q, k, v, out, B, Tq, Tkv, H, Hk,       \
                                                  causal, q_offset, scale, lookahead,    \
                                                  stream);                               \
  }                                                                                      \
  extern "C" long long attention_dh##DH##_dv##DV##_bq##BQ##_bkv##BKV##_bf16_smem(        \
      int lookahead) {                                                                   \
    return (long long)attention::wg::smem_bytes<DH, BKV, DV>(lookahead);                 \
  }
