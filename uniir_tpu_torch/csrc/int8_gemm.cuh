// One Hopper main loop for the port's int8 products: int32
//   acc[m, n] = sum_k a[m, k] * b[n, k]
// over int8 a [M, K] and b [N, K], both K-contiguous (the activations and the
// state-dict weight layout), followed by an epilogue that the including kernel
// supplies as a template parameter.  It serves
//   * K5 (csrc/int8_matmul.cu), which replaces uniir_tpu/ops/quant_pallas.py
//     `_kernel` (fused_int8_matmul): epilogue DequantBf16;
//   * K6 (csrc/int8_mlp.cu), which replaces uniir_tpu/ops/mlp_pallas.py
//     `_kernel` (fused_int8_mlp): fc1 with ActQuantI8 (the int8 hidden),
//     then fc2 with DequantResBf16.
//
// What bounds it on an H100: operations.  At the CLIP-L shapes (M = 16448,
// K and N in {768 ... 4096}) a product does 670-890 operations a byte of
// device memory, above the int8 ridge of ~590.  A 128 x 256 tile carries 170
// operations a byte of L2 traffic, a 128 x 128 tile 128, so at small tiles L2
// is the bound (why the old K6, whose 32-row blocks re-read every weight, ran
// at L2's rate).  At K <= 1024 a tile has only 8 k steps, and its ramp-up and
// epilogue, which its own products cannot hide, are as long as its main loop.
//
// Design (one 128 x BN output tile a block):
//   * one producer thread keeps a ring of stages full with TMA
//     (cp.async.bulk.tensor.2d, 128-byte swizzle), each stage 128 rows of a
//     and BN rows of b, 128 bytes deep (four k32 products); rows past M or N
//     and bytes past K are zero-filled by TMA, which the sum does not see.
//     Full / empty mbarriers a stage.  The tensor maps are encoded on the host
//     with cuTensorMapEncodeTiled (a libcuda function), reached through
//     cudaGetDriverEntryPoint (runtime API: no -lcuda), and passed as
//     __grid_constant__ parameters;
//   * two consumer warpgroups each own 64 rows of the tile and issue
//     wgmma.mma_async.sync.aligned.m64n{BN}k32.s32.s8.s8 with both operands
//     K-major in shared memory (no transposed copy), one commit group a stage,
//     at most two groups in flight;
//   * the epilogue turns each accumulator pair into two outputs with the
//     including kernel's fp32 steps, stages the tile in the (then idle) ring
//     and writes it as 16-byte vectors, masked at the M and N edges.
// Two tiles (GemmConfig), chosen by shape in int8_gemm_tile:
//   * 128 x 128, two blocks an SM (288 threads: a lone producer warp; 96 KB
//     ring of 3 stages; ptxas: 91-96 registers, no spill): one block's ramp-up
//     and epilogue run under the other's products -- the faster tile at
//     K <= 3072;
//   * 128 x 256, one block an SM (384 threads: a producer warpgroup that
//     gives its registers to the consumers with setmaxnreg, 40 against 232;
//     192 KB ring of 4 stages; ptxas reports the launch bound's 168 a thread,
//     no spill; 128 int32 accumulators a consumer thread) -- the faster tile
//     at K = 4096, where the main loop is long.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace uniir {

constexpr int GEMM_BM = 128;  // rows of a block's output tile (two consumer warpgroups)
constexpr int GEMM_BK = 128;  // bytes of k a stage: one 128-byte swizzle row

// The two tiles: 128 x 128 with two blocks an SM, 128 x 256 with one (see the head of this file).
template <int BN>
struct GemmConfig {
  static constexpr int BLOCKS = BN == 128 ? 2 : 1;            // blocks an SM
  static constexpr int THREADS = BLOCKS == 1 ? 384 : 288;     // consumers 0-255, then the producer
  static constexpr int STAGE_BYTES = (GEMM_BM + BN) * GEMM_BK;
  static constexpr int STAGES = (BLOCKS == 1 ? 196608 : 98304) / STAGE_BYTES;  // 4 or 3
  // ring, barriers, and the slack that aligns the ring to 1024 bytes (the swizzle's atom)
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y) : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_fence_iregs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N int32, N / 2 registers a thread) = A (64 x 32 int8) . B^T (N x 32 int8) + (scale_d ? d : 0),
// both K-major in shared memory behind 128-byte-swizzle descriptors (wgmma.cuh: wgmma_desc).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int* d, uint64_t a_desc, uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32_s8(int* d, uint64_t a_desc, uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a_desc, uint64_t b_desc) {
  if constexpr (BN == 256) {
    wgmma_m64n256k32_s8(d, a_desc, b_desc, 1);
  } else {
    static_assert(BN == 128, "the main loop takes tiles 128 or 256 wide");
    wgmma_m64n128k32_s8(d, a_desc, b_desc, 1);
  }
}

// The epilogue `Epi` is a struct with
//   Params   the kernel's arguments, among them `void* out`: row-major [M, N] outputs;
//   Out      two neighbouring outputs packed (uint32_t: two bf16; uint16_t: two int8);
//   Row row(p, r, M), Column column(p, col): what a row / a column pair (col, col + 1) needs;
//   Out pair(p, row, column, acc0, acc1): the outputs at (r, col) and (r, col + 1).
// N % 8 == 0 (bf16 out) or N % 16 == 0 (int8 out), K % 16 == 0; any M.
template <int BN, class Epi>
__global__ void __launch_bounds__(GemmConfig<BN>::THREADS, GemmConfig<BN>::BLOCKS)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                 const typename Epi::Params p, int M, int N, int K) {
  using S = GemmConfig<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::STAGES * S::STAGE_BYTES);
  uint64_t* empty = full + S::STAGES;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * BN;
  const int steps = (K + GEMM_BK - 1) / GEMM_BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);       // the producer's expect_tx; TMA's bytes complete it
      mbar_init(&empty[s], 256);    // every consumer thread, once its products of the stage are done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load; a producer warpgroup hands its registers to the consumers
    if constexpr (S::BLOCKS == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int c = 0; c < steps; ++c) {
        const int s = c % S::STAGES;
        if (c >= S::STAGES) mbar_wait(&empty[s], (c / S::STAGES - 1) & 1);
        unsigned char* stage = smem + s * S::STAGE_BYTES;
        mbar_expect_tx(&full[s], S::STAGE_BYTES);  // zero-filled bytes count too
        tma_load_2d(stage, &map_a, &full[s], c * GEMM_BK, m0);
        tma_load_2d(stage + GEMM_BM * GEMM_BK, &map_b, &full[s], c * GEMM_BK, n0);
      }
    }
  } else {
    if constexpr (S::BLOCKS == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int c = 0; c < steps; ++c) {
      const int s = c % S::STAGES;
      mbar_wait(&full[s], (c / S::STAGES) & 1);
      const unsigned char* stage = smem + s * S::STAGE_BYTES;
      const uint64_t da = wgmma_desc(smem_u32(stage + wg * 64 * GEMM_BK));  // this warpgroup's 64 rows of a
      const uint64_t db = wgmma_desc(smem_u32(stage + GEMM_BM * GEMM_BK));  // all BN rows of b
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GEMM_BK / 32; ++ks) wgmma_s8<BN>(acc, da + 2 * ks, db + 2 * ks);  // +32 bytes of k
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand that stage back
      if (c > 0) mbar_arrive(&empty[(c - 1) % S::STAGES]);
    }
    wgmma_wait<0>();
    wgmma_fence_iregs<BN / 2>(acc);

    // epilogue: both warpgroups are past the ring, which now stages the output tile
    named_barrier(1, 256);
    using Out = typename Epi::Out;
    constexpr int OUT_BYTES = sizeof(Out) / 2;
    constexpr int ROW_BYTES = BN * OUT_BYTES;
    constexpr int STRIDE = ROW_BYTES + 16;  // a quad's pairs on distinct banks for all 8 rows of a warp
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    unsigned char* tile = smem + wg * 64 * STRIDE;
    // accumulator d[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 q + e of this warpgroup's 64 x BN
    const int r_local = 16 * warp + g, r0 = m0 + wg * 64 + r_local;
    const typename Epi::Row rows[2] = {Epi::row(p, r0, M), Epi::row(p, r0 + 8, M)};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (n0 + 8 * j < N) {  // an n8 tile is wholly inside or outside
        const int col_local = 8 * j + 2 * q;
        const typename Epi::Column cols = Epi::column(p, n0 + col_local);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<Out*>(tile + (r_local + 8 * h) * STRIDE + col_local * OUT_BYTES) =
              Epi::pair(p, rows[h], cols, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    named_barrier(2 + wg, 128);
    constexpr int VECS = ROW_BYTES / 16;  // 16-byte vectors a staged row
    unsigned char* out = static_cast<unsigned char*>(p.out);
#pragma unroll 4
    for (int i = tid; i < 64 * VECS; i += 128) {
      const int r = i / VECS, v = i % VECS;
      const int row = m0 + wg * 64 + r, col = n0 + v * (16 / OUT_BYTES);
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(out + ((size_t)row * N + col) * OUT_BYTES) =
            *reinterpret_cast<const uint4*>(tile + r * STRIDE + v * 16);
    }
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query: the libraries link no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// A map of a row-major int8 [rows, cols] (cols % 16 == 0, base 16-byte aligned) in boxes of
// box_rows x 128 bytes, 128-byte swizzled; reads past either edge are zero-filled.
inline bool encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)GEMM_BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Output tiles of one launch, as int8_gemm_tile picks them or a caller names them.
enum GemmTile { TILE_RULE = 0, TILE_128x256 = 1, TILE_128x128_TWO = 2 };

// Two blocks an SM at K < 4096; at K = 4096 128 x 256 tiles, where their blocks fill the SMs (K5 on the
// H100: the two-block tile 3-20 % faster at K = 768 ... 3072, 8 % slower at 4096; PERF.md).
inline int int8_gemm_tile(int M, int N, int K) {
  if (K < 4096) return TILE_128x128_TWO;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (long long)((M + GEMM_BM - 1) / GEMM_BM) * ((N + 255) / 256);
  return blocks >= sms ? TILE_128x256 : TILE_128x128_TWO;
}

template <int BN, class Epi>
cudaError_t launch_int8_gemm(const void* a, const void* b, int M, int N, int K, const typename Epi::Params& p,
                             cudaStream_t stream) {
  using S = GemmConfig<BN>;
  CUtensorMap map_a, map_b;
  if (!encode_rows(&map_a, a, M, K, GEMM_BM) || !encode_rows(&map_b, b, N, K, BN)) return cudaErrorInvalidValue;
  const auto kernel = int8_gemm_kernel<BN, Epi>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + GEMM_BM - 1) / GEMM_BM);
  kernel<<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(map_a, map_b, p, M, N, K);
  return cudaGetLastError();
}

// tile: a GemmTile, TILE_RULE for int8_gemm_tile's choice.  Nothing is launched for M == 0.
template <class Epi>
cudaError_t launch_int8_gemm(const void* a, const void* b, int M, int N, int K, const typename Epi::Params& p,
                             int tile, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (tile == TILE_RULE) tile = int8_gemm_tile(M, N, K);
  if (tile == TILE_128x256) return launch_int8_gemm<256, Epi>(a, b, M, N, K, p, stream);
  if (tile == TILE_128x128_TWO) return launch_int8_gemm<128, Epi>(a, b, M, N, K, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace uniir
