// Hopper primitives shared by the port's CUDA C++ kernels.
//
// Every piece of inline PTX the kernels use lives here, as a small
// __device__ __forceinline__ function, so that tests/cuda_emulator.h can
// supply host versions of exactly these functions:
//
//   * tf32_split: x -> (big, small), big = tf32(x), small = tf32(x - big),
//     both rounded to nearest, ties away (cvt.rna.tf32.f32);
//   * tf32_split_trunc: the same split by truncation (the low 13 mantissa
//     bits cleared), for finite x;
//   * mma_tf32_m16n8k8: D += A(16x8) B(8x8), TF32 in, fp32 accumulators
//     (mma.sync.aligned.m16n8k8.row.col), fragments in PTX's layout:
//     with g = lane / 4 and q = lane % 4,
//       a[0] = A[g][q], a[1] = A[g+8][q], a[2] = A[g][q+4], a[3] = A[g+8][q+4]
//       b[0] = B[q][g], b[1] = B[q+4][g]
//       d[0] = D[g][2q], d[1] = D[g][2q+1], d[2] = D[g+8][2q], d[3] = D[g+8][2q+1];
//   * mma_3xtf32: the fp32-accurate product on the tensor cores
//     (CUTLASS's OpMultiplyAddFastF32): small*big + big*small, then
//     big*big, accumulated in fp32; small*small (about 2^-22 of the
//     product) is dropped;
//   * cp.async of 16 bytes (.cg, past L1) and of 4 bytes (.ca), each with
//     a source size of 0..16 (0..4) bytes whose remainder is zero-filled:
//     masked edges read zeros without a branch around the copy;
//   * cp_async_commit and cp_async_wait(n), n in 0..2 dispatched through
//     a switch, since wait_group takes an immediate;
//   * mma_bf16_m16n8k16: D += A(16x16) B(16x8), bf16 in, fp32 accumulators
//     (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32). Each register
//     holds two bf16 values, the lower index in the low 16 bits; with g
//     and q as above,
//       a[0] = A[g][2q, 2q+1],   a[1] = A[g+8][2q, 2q+1],
//       a[2] = A[g][2q+8, 2q+9], a[3] = A[g+8][2q+8, 2q+9]
//       b[0] = B[2q, 2q+1][g],   b[1] = B[2q+8, 2q+9][g]
//       d as for m16n8k8. A bf16 x bf16 product is exact in fp32;
//   * pack_bf16x2(lo, hi): two fp32 values rounded to bf16 (to nearest,
//     ties to even) in one register, lo in the low half
//     (cvt.rn.bf16x2.f32);
//   * pack_u16x2(lo, hi): two 16-bit values (bf16 bits) in one register,
//     lo in the low half: an operand pair whose two values are not
//     adjacent in memory (the k pairs of a B fragment read from an
//     n-contiguous tile).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// The split by truncation: two bit masks and one subtraction (x - big is
// exact in fp32), where sm_90 runs each cvt.rna as a short sequence of
// compares, adds and masks, about three times the instructions for the
// pair. small*big + big*small + big*big then misses x*y by at most about
// 3 * 2^-20 of |x*y|, against 3 * 2^-22 with rounding: far inside an fp32
// check's limits (tests/test_torch_tf32.py). For finite x only.
__device__ __forceinline__ void tf32_split_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32_m16n8k8(float d[4], const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_3xtf32(float d[4], const uint32_t a_big[4],
                                           const uint32_t a_small[4],
                                           const uint32_t b_big[2],
                                           const uint32_t b_small[2]) {
  mma_tf32_m16n8k8(d, a_small, b_big);
  mma_tf32_m16n8k8(d, a_big, b_small);
  mma_tf32_m16n8k8(d, a_big, b_big);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's committed groups are in
// flight (0..2; more waits for all)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::); break;
  }
}

__device__ __forceinline__ void mma_bf16_m16n8k16(float d[4], const uint32_t a[4],
                                                  const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  // the first source goes to the upper half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t pack_u16x2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

}  // namespace sm90
