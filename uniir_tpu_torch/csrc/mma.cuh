// Warp-level tensor-core products (mma.sync) shared by the port's kernels.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
//   m16n8k16 bf16:  A regs a0 = (row g,   k 2t..2t+1)   a1 = (row g+8, k 2t..2t+1)
//                          a2 = (row g,   k 2t+8..+9)   a3 = (row g+8, k 2t+8..+9)
//                   B regs b0 = (k 2t..2t+1, col g)      b1 = (k 2t+8..+9, col g)
//   m16n8k32 s8:    A regs a0 = (row g, k 4t..4t+3)     a1 = (row g+8, k 4t..4t+3)
//                          a2 = (row g, k 4t+16..+19)   a3 = (row g+8, k 4t+16..+19)
//                   B regs b0 = (k 4t..4t+3, col g)      b1 = (k 4t+16..+19, col g)
//   C / D (both):   c0, c1 = (row g, col 2t, 2t+1)       c2, c3 = (row g+8, col 2t, 2t+1)
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace uniir {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half), .y = hi
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace uniir
