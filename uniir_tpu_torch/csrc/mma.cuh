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
//
// Swizzled head tiles (the attention kernels).  A tile holds rows of one head,
// 64 bf16 = 128 bytes = 8 chunks of 16 bytes each; chunk c of row r sits at
// byte r * 128 + ((c ^ (r & 7)) << 4): the tensor cores' 128-byte swizzle when
// the tile starts on a 1024-byte boundary (wgmma.cuh reads the tiles through
// descriptors), and free of bank conflicts for the staging warps, whose 8
// lanes write the 8 chunks of one row.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously (no register staging).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int TILE_ROW_BYTES = 128;  // one head's row: 64 bf16

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled head tile.
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  return row * TILE_ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

// Stage rows [0, rows) of one head of x (row stride W elements, `base` the
// head's first element) into a swizzled tile with cp.async; rows >= limit are
// zeroed by plain stores, so padding never reaches a product.  The caller
// commits the group, waits and synchronises.
__device__ __forceinline__ void stage_head_rows(unsigned char* tile, const __nv_bfloat16* __restrict__ x, size_t base,
                                                int W, int rows, int limit) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += blockDim.x) {
    const int row = idx >> 3, c = idx & 7;
    unsigned char* dst = tile + tile_offset(row, c);
    if (row < limit)
      cp_async16(smem_u32(dst), x + base + (size_t)row * W + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// The raw bf16 pairs of the A fragments (16 rows x 64, four k16 steps) of rows r0 .. r0+15 of one head
// of x, straight from device memory; rows >= limit read as zero (a select, so padding never
// reaches a product).
__device__ __forceinline__ void load_a_words(uint32_t (&w)[4][4], const __nv_bfloat16* __restrict__ x, size_t base,
                                             int W, int limit, int r0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + g + ((r & 1) ? 8 : 0);
      const int col = ks * 16 + 2 * t + ((r & 2) ? 8 : 0);
      w[ks][r] = row < limit ? *reinterpret_cast<const uint32_t*>(x + base + (size_t)row * W + col) : 0u;
    }
  }
}

// a = bf16(w * scale), pair by pair: the reference rounds q * bf16(scale) to bf16.
__device__ __forceinline__ void scale_words(uint32_t (&a)[4][4], const uint32_t (&w)[4][4], float scale) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[ks][r]);
      a[ks][r] = pack_bf16x2(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
    }
  }
}

// The C fragments of two adjacent n8 tiles are the A fragment of the next product.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x within 2 ulp: exp(s - m) is exp2_approx(fmaf(s, LOG2E, -m * LOG2E)), one FFMA and one MUFU a score.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace uniir
