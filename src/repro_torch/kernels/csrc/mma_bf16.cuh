// Tensor-core building blocks for sm_90a kernels on bfloat16 tiles:
// cp.async staging into shared memory, ldmatrix fragment loads and the
// warp-level mma.sync.m16n8k16 product (bf16 operands, float32 sums).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), as the PTX ISA gives them:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2t, 2t+1]     a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k by n, "col"), two registers:
//     b0 = B[2t, 2t+1][g]     b1 = B[2t+8, 2t+9][g]
//   C and D (16 x 8, float32), four floats:
//     c0, c1 = C[g][2t, 2t+1] c2, c3 = C[g+8][2t, 2t+1]
// So the accumulators of two neighbouring n-tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product's k-step.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the
// shared-memory addresses of matrix i's rows, and register i of lane l
// receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i
// (with .trans: rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4).

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; when `valid` is
// false nothing is read and the 16 bytes are zero-filled (`src` must still
// be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes (one float) from global to shared memory, asynchronously, with
// the same zero fill when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A b on the tensor cores: A 16 x 16 bf16, b 16 x 8 bf16, d float32.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half: the
// element with the smaller column index of a fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as two bf16 pairs whose sum holds them to about 16 bits:
// `big` packs each float rounded to bf16 (as pack_bf16), `small` packs
// what that rounding left out, rounded in turn.  A product taken once with
// each carries a float32 operand into an mma.sync of bf16 operands.
__device__ __forceinline__ void pack_bf16_split(float lo, float hi, uint32_t& big,
                                                uint32_t& small) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(v);
  big = *reinterpret_cast<const uint32_t*>(&v);
  small = pack_bf16(lo - r.x, hi - r.y);
}

}  // namespace mma_bf16
