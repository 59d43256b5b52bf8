// Causal flash attention (blockwise online softmax) on Hopper, GQA-aware.
//
//   out[b, t, h, :] = softmax_s(q[b, t, h, :] . k[b, s, h / G, :] * scale
//                               + mask) @ v[b, :, h / G, :]
//
//   q: (B, Tq, H, Dh), k, v: (B, Tkv, Hk, Dh), out like q; fp32; Dh = 128;
//   G = H / Hk.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (`_fa_kernel`,
// src/repro/kernels/attention/attention.py). It computes what that kernel
// computes:
//
//   * one block owns one (b * H + h, q tile of BQ rows) pair; the kv grid
//     axis of the TPU becomes a loop inside the block over kv blocks of
//     BKV rows, with the running max m, sum l and accumulator in fp32;
//   * the GQA fold: q head h reads kv head h / G;
//   * the causal mask with `q_offset` (q row t sits at position
//     q_offset + t), and the ragged kv tail (positions >= Tkv) masked to
//     -1e30 with zero k and v, as the Pallas kernel masks them;
//   * kv blocks that the causal mask hides from the whole q tile are
//     skipped: the loop ends at the last block any row of the tile can
//     see. (The Pallas kernel computes and then masks them.)
//   * scores are q.k times `scale`, exponentials expf (not the fast
//     intrinsic), products fp32 FMAs, never TF32: chip_smoke.py holds
//     every instantiation to a limit a TF32 product fails;
//   * `sched` and `lookahead` are inert.
//
// The block walks its BQ x BKV work in 64 x 64 sub-tiles: for each 64-row
// pass of the q tile, the kv loop stages a 64-row slice of K and V at a
// time, forms the 64x64 scores, updates m and l per row and rescales the
// pass's 64x128 accumulator (held in registers, 4 rows x 8 columns a
// thread). The online softmax is therefore updated per 64-key slice, not
// per BKV block: the same function, rounded in another order. Shared
// memory is the Q pass, one K and one V slice and the scores, about
// 119 kB whatever BQ and BKV: the TPU's whole blocks (BQ = 512 and
// BKV = 1024 at Dh = 128 take 2.8 MB) would not fit a Hopper block. BQ
// and BKV still decide the work: the number of blocks, and how much of
// the causal triangle's masked area a tile computes.
//
// What bounds it on an H100: 4 * B * H * Tq * Tkv * Dh / 2 causal fp32
// operations against the bytes of q, k, v and out, so at deepseek-7b's
// prefill (B = 4, T = 512, H = 32, Dh = 128) it is compute-bound on the
// CUDA cores (8.6 GFLOP, 0.128 ms at 67 TFLOP/s). The inner products keep
// two 16-byte shared-memory loads per 16 FMAs (scores) and three per 32
// (the value product). Later work: tensor-core products (wgmma in bf16 or
// TF32 behind a gated knob), TMA double buffering, a per-pass causal
// skip.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace attention {

constexpr int kThreads = 256;
constexpr int kDh = 128;        // head dim
constexpr int kQs = 64;         // q rows per pass
constexpr int kKs = 64;         // kv rows per slice
constexpr int kPad = 4;         // keeps rows 16-byte aligned
constexpr int kLdQ = kQs + kPad;   // qt[d][r]
constexpr int kLdK = kKs + kPad;   // kt[d][c]
constexpr int kLdV = kDh + kPad;   // vs[c][d]
constexpr int kLdP = kQs + kPad;   // pt[c][r]
constexpr float kNegInf = -1e30f;

// shared memory of one block, in bytes (what the tuning space's Hopper
// capacity rule counts)
constexpr size_t kSmemFloats = (size_t)kDh * kLdQ + (size_t)kDh * kLdK +
                               (size_t)kKs * kLdV + (size_t)kKs * kLdP + 3 * kQs;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

template <int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int B, int Tq,
             int Tkv, int H, int Hk, int causal, int q_offset, float scale) {
  static_assert(BQ % kQs == 0 && BKV % kKs == 0, "blocks are multiples of the 64-row slices");
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [kDh][kLdQ]
  float* kt = qt + kDh * kLdQ;        // [kDh][kLdK]
  float* vs = kt + kDh * kLdK;        // [kKs][kLdV]
  float* pt = vs + kKs * kLdV;        // [kKs][kLdP]
  float* m_s = pt + kKs * kLdP;       // [kQs]
  float* l_s = m_s + kQs;             // [kQs]
  float* a_s = l_s + kQs;             // [kQs] rescale factors

  const int n_q = (Tq + BQ - 1) / BQ;
  const int iq = blockIdx.x % n_q;
  const int bh = blockIdx.x / n_q;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // kv extent this tile can see: whole BKV blocks, up to the block holding
  // the tile's last visible key
  const int n_kv = (Tkv + BKV - 1) / BKV;
  int n_vis = n_kv;
  if (causal) {
    const int last_q = q_offset + min(iq * BQ + BQ, Tq) - 1;
    n_vis = last_q < 0 ? 0 : min(n_kv, last_q / BKV + 1);
  }
  const int kv_end = min(Tkv, n_vis * BKV);

  const size_t q_stride = (size_t)H * kDh;     // between consecutive t
  const size_t kv_stride = (size_t)Hk * kDh;

#pragma unroll 1
  for (int q0 = iq * BQ; q0 < min(iq * BQ + BQ, Tq); q0 += kQs) {
    __syncthreads();  // the previous pass is done with every buffer
    for (int e = tid; e < kQs * kDh; e += kThreads) {
      const int r = e / kDh, d = e % kDh;
      const int t = q0 + r;
      qt[d * kLdQ + r] = t < Tq ? q[((size_t)b * Tq + t) * q_stride + (size_t)h * kDh + d] : 0.f;
    }
    if (tid < kQs) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float o[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;

#pragma unroll 1
    for (int k0 = 0; k0 < kv_end; k0 += kKs) {
      __syncthreads();  // done with the previous slice's kt, vs, pt
      for (int e = tid; e < kKs * kDh; e += kThreads) {
        const int c = e / kDh, d = e % kDh;
        const int s = k0 + c;
        const size_t off = ((size_t)b * Tkv + s) * kv_stride + (size_t)hk * kDh + d;
        const bool in = s < Tkv;
        kt[d * kLdK + c] = in ? k[off] : 0.f;
        vs[c * kLdV + d] = in ? v[off] : 0.f;
      }
      __syncthreads();

      // scores of rows ty*4.. against keys tx*4.., masked, into pt[c][r]
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kDh; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLdQ + ty * 4);
        const float4 ka = *reinterpret_cast<const float4*>(kt + d * kLdK + tx * 4);
        const float qq[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kk[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = q_offset + q0 + ty * 4 + i;
          float s = sc[i][j] * scale;
          if ((causal && qpos < kpos) || kpos >= Tkv) s = kNegInf;
          cv[i] = s;
        }
        *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLdP + ty * 4) =
            make_float4(cv[0], cv[1], cv[2], cv[3]);
      }
      __syncthreads();

      // online softmax per row: 4 threads a row, 16 keys each
      {
        const int r = tid / 4, part = tid % 4;
        float mx = kNegInf;
#pragma unroll
        for (int c = part * 16; c < part * 16 + 16; ++c) mx = fmaxf(mx, pt[c * kLdP + r]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int c = part * 16; c < part * 16 + 16; ++c) {
          const float p = expf(pt[c * kLdP + r] - m_new);
          pt[c * kLdP + r] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          const float alpha = expf(m_old - m_new);
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p @ v: rows ty*4.., value columns tx*8..
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = a_s[ty * 4 + i];
      float pv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kKs; ++c) {
        const float4 pa = *reinterpret_cast<const float4*>(pt + c * kLdP + ty * 4);
        const float4 v0 = *reinterpret_cast<const float4*>(vs + c * kLdV + tx * 8);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + c * kLdV + tx * 8 + 4);
        const float pp[4] = {pa.x, pa.y, pa.z, pa.w};
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) pv[i][j] = fmaf(pp[i], vv[j], pv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = o[i][j] * al[i] + pv[i][j];
    }

    __syncthreads();  // l_s is final
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = q0 + r;
      if (t >= Tq) continue;
      const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
      float* dst = out + ((size_t)b * Tq + t) * q_stride + (size_t)h * kDh + tx * 8;
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[i][0] * inv_l, o[i][1] * inv_l, o[i][2] * inv_l, o[i][3] * inv_l);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(o[i][4] * inv_l, o[i][5] * inv_l, o[i][6] * inv_l, o[i][7] * inv_l);
    }
  }
}

// Host launcher for one instantiation: on `stream`, allocates nothing,
// does not synchronise; returns the launch status (cudaGetLastError),
// which the Python wrapper turns into an exception.
template <int BQ, int BKV>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Tq, int Tkv, int H, int Hk, int causal, int q_offset, float scale,
           void* stream) {
  // above 48 KB, dynamic shared memory must be opted in to; the attribute
  // belongs to the current device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<BQ, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)B * H * ((Tq + BQ - 1) / BQ);
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_kernel<BQ, BKV><<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      q, k, v, out, B, Tq, Tkv, H, Hk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace attention

// One exported C symbol per instantiation:
//   int attention_bq<BQ>_bkv<BKV>(q, k, v, out, B, Tq, Tkv, H, Hk, causal,
//                                 q_offset, scale, stream)
#define ATTENTION_INSTANTIATE(BQ, BKV)                                               \
  extern "C" int attention_bq##BQ##_bkv##BKV(                                        \
      const float* q, const float* k, const float* v, float* out, int B, int Tq,     \
      int Tkv, int H, int Hk, int causal, int q_offset, float scale, void* stream) { \
    return attention::launch<BQ, BKV>(q, k, v, out, B, Tq, Tkv, H, Hk, causal,       \
                                      q_offset, scale, stream);                      \
  }
