// Tensor-core and asynchronous-copy primitives of the mma.sync bodies
// (matmul.cu's GEMVs and tiles, split_attention.cuh's rows on tensor
// cores): mma.sync m16n8k16 with bf16 inputs and an f32 accumulator,
// ldmatrix fragment loads, the exact int8 -> bf16 widening, and 16-byte
// cp.async copies from global to shared memory.
#pragma once

#include <stdint.h>

namespace repro {

// d += a (16 x 16, row-major fragments) * b (16 x 8, column-major fragments).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b for rows 0-7 of the m16 tile only (split_attention.cuh's 8
// rows): a's rows 8-15 (registers 1 and 3) must be zero, and their
// accumulators start at zero and are discarded, so they hold no registers
// between calls.
__device__ __forceinline__ void mma_16816_top(float (&d)[2], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  float x, y;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %10};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(x), "=f"(y)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// bf16x2 of the two int8 bytes at bits [7:0] and [23:16] of w (other bits
// ignored), exactly: 0x4300 | (b & 0x7F) is 128 + (b & 0x7F), 0xC300 | (b &
// 0x80) is -(128 + (b & 0x80)), and their sum is b.
__device__ __forceinline__ uint32_t i8_bf16x2(uint32_t w) {
  const uint32_t hi = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t lo = (w & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(hi), "r"(0x3F803F80u), "r"(lo));
  return d;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then never read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace repro
