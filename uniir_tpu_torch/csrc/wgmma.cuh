// Warpgroup tensor-core products (wgmma, sm_90a) for the attention kernels.
//
// wgmma.mma_async multiplies a 64-row A tile, here always in registers, by a B
// tile read from shared memory through a 64-bit matrix descriptor, and adds
// into fp32 accumulators spread over the warpgroup's 128 threads.  Warp w of
// the warpgroup owns rows 16 w .. 16 w + 15; within it the A registers and the
// accumulators have the m16n8k16 fragment layouts of mma.cuh (accumulator
// d[4 j + e] is element e of n8 tile j), so a product's accumulators pack
// straight into the next product's A operand.
//
// B tiles are the swizzled head tiles of mma.cuh: rows of 128 bytes, chunk c
// of row r at r * 128 + ((c ^ (r & 7)) << 4).  With the tile's base aligned to
// 1024 bytes that is the hardware's 128-byte swizzle, 8 rows an atom:
//   * K-major B (n = the tile's rows, k = a row's elements: q k^T reads K, g v^T
//     reads V so): stride between 8-row groups SBO = 1024 bytes; a k16 step
//     advances the start address by 32 bytes inside the row; N rows start at
//     the descriptor's address.
//   * MN-major B (k = the tile's rows, n = a row's 64 elements: p v reads V,
//     ds k reads K so; the "_bt" variants set the transpose-B bit): SBO = 1024
//     bytes is the stride between groups of 8 k rows; a k16 step advances the
//     start address by 16 rows = 2048 bytes.
// The leading byte offset is not used by either (one atom spans the whole
// 128-byte row) and is set to 1.
//
// Order of use: wgmma_fence() before the first product that reads registers
// written by ordinary instructions, wgmma_commit() after the last product of
// a batch, wgmma_wait<0>() before the accumulators are read.
#pragma once

#include <cstdint>

namespace uniir {

// Descriptor of a swizzled head tile (or of rows inside it) at shared address `addr`.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// What to add to a descriptor to start `rows` tile rows (128 bytes each) further on.
__device__ __forceinline__ uint64_t desc_rows(int rows) { return (uint64_t)(rows * (128 >> 4)); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of N accumulators across the asynchronous products.
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory writes of ordinary stores and cp.async become visible to wgmma (the async proxy)
// after this fence by the writing thread and a barrier.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// d (64 x N, fp32; N / 2 registers a thread) = A (64 x 16, registers) . B^T (N x 16 K-major in shared
// memory) + (scale_d ? d : 0), for N = 64 and N = 16: a score row of 8 c + 2 n8 tiles is c products
// of 64 keys and one of 16.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t (&a)[4], uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n16k16(float* d, const uint32_t (&a)[4], uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}

// d (64 x 64, fp32) = A (64 x 16, registers) . B (16 x 64 MN-major in shared memory) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16_bt(float* d, const uint32_t (&a)[4], uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}

// d (64 rows x 8 NT keys, as NT n8 tiles of 4 registers) = A (64 x 64, four k16 fragments) . B^T, B the
// K-major tile rows that `b_desc` starts at, each product over the four k16 steps: NT = 8 c + 2 (K1, K3:
// a padded row) is c products of 64 keys and one of 16; NT = 8 c (K10's main keys) is c products of 64.
template <int NT>
__device__ __forceinline__ void wgmma_row_kmajor(float (&d)[NT][4], const uint32_t (&a)[4][4], uint64_t b_desc) {
  static_assert(NT % 8 == 2 || NT % 8 == 0, "a score row is whole 64-key products, and perhaps one of 16 keys");
#pragma unroll
  for (int c = 0; c < NT / 8; ++c)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16(&d[8 * c][0], a[ks], b_desc + desc_rows(64 * c) + 2 * ks, ks > 0);
  if constexpr (NT % 8 == 2) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n16k16(&d[NT - 2][0], a[ks], b_desc + desc_rows(8 * (NT - 2)) + 2 * ks, ks > 0);
  }
}

}  // namespace uniir
