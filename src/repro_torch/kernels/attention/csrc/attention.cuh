// Causal flash attention (blockwise online softmax) on Hopper, GQA-aware,
// on the tensor cores in 3xTF32.
//
//   out[b, t, h, :] = softmax_s(q[b, t, h, :] . k[b, s, h / G, :] * scale
//                               + mask) @ v[b, :, h / G, :]
//
//   q: (B, Tq, H, Dh), k, v: (B, Tkv, Hk, Dh), out like q; fp32; G = H / Hk;
//   Dh a template parameter (a multiple of 8; the library instantiates
//   16, 64 and 128, the head dims of the configs the port serves).
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
// Left for later: wgmma (TF32 only K-major from shared memory, so V would
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
template <int DH>
__host__ __device__ constexpr size_t smem_bytes(int lookahead) {
  return (size_t)(lookahead + 1) * stage_bytes<DH>() + split_bytes<DH>();
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
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nf = 0; nf < kKs / 8; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = s * kKs + nf * 8 + 2 * qd + (i & 1);
          const int qpos = q_offset + r0 + g + 8 * (i >> 1);
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
      for (int nv = 0; nv < kDh / 8; ++nv)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nv][i] *= alpha[i >> 1];

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

// Host launcher for one instantiation: on `stream`, allocates nothing,
// does not synchronise; returns the launch status (cudaGetLastError),
// which the Python wrapper turns into an exception.
template <int DH, int BQ, int BKV, int LA>
int launch_depth(const float* q, const float* k, const float* v, float* out, int B,
                 int Tq, int Tkv, int H, int Hk, int causal, int q_offset, float scale,
                 void* stream) {
  const size_t smem = smem_bytes<DH>(LA);
  // above 48 KB, dynamic shared memory must be opted in to; the attribute
  // belongs to the current device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<DH, BQ, BKV, LA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)B * H * ((Tq + BQ - 1) / BQ);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_kernel<DH, BQ, BKV, LA><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int DH, int BQ, int BKV>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Tq, int Tkv, int H, int Hk, int causal, int q_offset, float scale,
           int lookahead, void* stream) {
  switch (lookahead) {
    case 0: return launch_depth<DH, BQ, BKV, 0>(q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, stream);
    case 1: return launch_depth<DH, BQ, BKV, 1>(q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, stream);
    case 2: return launch_depth<DH, BQ, BKV, 2>(q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace attention

// Two exported C symbols per instantiation:
//   int attention_dh<DH>_bq<BQ>_bkv<BKV>(q, k, v, out, B, Tq, Tkv, H, Hk,
//                                        causal, q_offset, scale, lookahead,
//                                        stream)
//   long long attention_dh<DH>_bq<BQ>_bkv<BKV>_smem(lookahead): the dynamic
//     shared memory of one block, as the launcher asks for it
#define ATTENTION_INSTANTIATE(DH, BQ, BKV)                                              \
  extern "C" int attention_dh##DH##_bq##BQ##_bkv##BKV(                                  \
      const float* q, const float* k, const float* v, float* out, int B, int Tq,        \
      int Tkv, int H, int Hk, int causal, int q_offset, float scale, int lookahead,     \
      void* stream) {                                                                   \
    return attention::launch<DH, BQ, BKV>(q, k, v, out, B, Tq, Tkv, H, Hk, causal,      \
                                          q_offset, scale, lookahead, stream);          \
  }                                                                                     \
  extern "C" long long attention_dh##DH##_bq##BQ##_bkv##BKV##_smem(int lookahead) {     \
    return (long long)attention::smem_bytes<DH>(lookahead);                             \
  }
