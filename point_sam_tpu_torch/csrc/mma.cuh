// Inline-PTX building blocks of the bf16 tensor-core kernels (K3 / K5 in
// attention.cu, K6 in attention_bwd.cu): cp.async copies into shared
// memory, ldmatrix fragment loads and mma.sync.m16n8k16 with fp32
// accumulation.
//
// Fragment layouts of m16n8k16 (lane = 4 g + t4, g = lane >> 2, t4 = lane & 3):
//   A [16 x 16], 4 x bf16x2: a0 (row g, cols 2 t4, 2 t4 + 1), a1 (row g + 8,
//     same cols), a2 (row g, cols 8 + 2 t4, + 1), a3 (row g + 8, those cols);
//   B [16 x 8], 2 x bf16x2: b0 (rows 2 t4, 2 t4 + 1, col g), b1 (rows 8 + 2 t4,
//     + 1, col g);
//   C [16 x 8], 4 x fp32: c0, c1 (row g, cols 2 t4, 2 t4 + 1), c2, c3 (row
//     g + 8, those cols).
// So the C tiles of two adjacent n8 column blocks, packed to bf16x2 in place
// (c0 c1 -> a0, c2 c3 -> a1 from the first, -> a2, a3 from the second), are
// the A fragment of one k16 step: a product's output feeds the next product
// without leaving the registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace psam {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; full == false reads nothing and
// writes 16 zero bytes (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

// 4 bytes global -> shared; full == false writes 4 zero bytes.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: m16n8k16, bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> bf16x2 with lo in the low half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace psam
