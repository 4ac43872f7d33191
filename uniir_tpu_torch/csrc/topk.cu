// K2, K4 and K11: the retrieval sweep's strided-bucket maxima.
//
// K2 replaces uniir_tpu/ops/topk_pallas.py::bucket_max_scores
//   (_make_bucket_max_kernel): bf16 queries x bf16 pool, fp32 accumulation.
// K4 replaces uniir_tpu/ops/topk_pallas.py::bucket_max_scores_i8
//   (_make_bucket_max_kernel_i8, per-row scales): int8 x int8 -> int32,
//   dequantised as (float(acc) * q_scale[query]) * pool_scale[row].
// K11 replaces the per-bucket-scale branch of the same function
//   (_bucket_max_kernel_i8b): the 16 members of a bucket share one scale, so
//   the bucket maximum is taken over the int32 accumulators and only the
//   maximum is dequantised, (float(max) * q_scale[query]) * bucket_scale[col].
//   Rows >= valid_n take the int32 sentinel -(2^31 - 1) before the maximum; a
//   bucket whose first member is >= valid_n writes the fp32 -3e38 after the
//   dequantisation (a dequantised sentinel could outrank true negative
//   scores).  Against K4 it saves two fp32 multiplies and a convert on 15 of
//   every 16 scores and a [N] scale read; the pool bytes are the same.
//
// All compute, for a pool of N rows (N a multiple of CHUNK = 2048), the
// [Q, N/16] fp32 maxima of the strided buckets of topk_pallas.py:13-15:
// member m (0..15) of bucket (i, l) is pool row i*2048 + m*128 + l, and the
// output column of that bucket is i*128 + l.  Rows >= valid_n score -3e38 by
// select.  The [Q, N] score matrix never exists: each block keeps its score
// tiles in registers and writes only the maxima.
//
// What bounds them on an H100.  At Q queries a sweep does 2*Q*D operations
// for every D-wide pool row: Q operations a byte of a bf16 pool (2*D bytes a
// row), 2*Q a byte of an int8 pool (D bytes).  The ridges are ~295
// operations a byte in bf16 (989 TFLOP/s over 3.35 TB/s) and ~591 in int8.
// On the 5.6M x 768 pool:
//   Q = 256 (near both ridges): K2 2.675 ms by bytes (8.6 GB of pool, 0.36 GB
//     of maxima), K4 1.398 ms by bytes;
//   Q = 1024, the search's batch (retrieval/search.py): both bound by
//     operations, K2 8.91 ms (8.8 TFLOP), K4 4.45 ms; only wgmma reaches that
//     rate.
// A tile of T queries meets each pool byte it fetches T times, so the pool is
// read from L2 Q/T times over: with the general kernels' 64-query tiles,
// 138 GB at Q = 1024 for K2, far more than the L2 gives in 8.9 ms.
//
// Design of K2, K4 and K11 (bucket_max_wgmma_kernel, one template; SweepOf
// holds what differs):
//   * a block holds its queries for its life, loaded once by TMA into shared
//     memory (K-major, 128-byte swizzle: 64 bf16 queries or 128 int8 ones,
//     96 KB each at D = 768), and walks pool chunks blockIdx.y, + gridDim.y,
//     ...: a persistent grid, one wave of clusters spread over the query
//     tiles, so the tiles of a chunk run side by side and share its L2 lines
//     (K11's block holds 128 int8 queries, as K4's);
//   * one producer thread keeps a ring of pool stages full with TMA (a stage
//     is SLABS slabs x 128 bytes of k; slab m of chunk c is rows c*2048 +
//     m*128 + 0..127, whose products land in the same accumulator layout for
//     every m), full / empty mbarriers; K2's two blocks form a cluster and
//     each fetches half of every stage for both (.multicast::cluster), so a
//     pool byte fetched from L2 meets 128 queries in either sweep; K4's pool
//     scales go to shared memory a chunk at a time (cp.async.bulk);
//   * the consumers multiply with wgmma, both operands from shared memory:
//     K2 one warpgroup on m64n256k16 over two slabs (A read once for 256
//     rows: shared memory, not the tensor cores, bounds a bf16 sweep with
//     64-row A tiles), K4 and K11 two warpgroups of 64 queries on m64n128k32
//     s8;
//   * the strided-bucket maximum is elementwise over the slabs' equal
//     accumulator layouts.  K4 alternates two accumulator sets: slab m + 1's
//     first products are issued before slab m is folded (convert, two
//     rounded multiplies), so the fold runs under the tensor cores; nothing
//     is in flight across a loop's back edge (ptxas serialises every wgmma
//     otherwise).  K11 alternates two sets as K4, folds with one integer max
//     an accumulator into int32 maxima and has no per-row scale stream (see
//     SweepOf<I8Bucket>).  Only a chunk that reaches valid_n selects -3e38
//     (K11: the int32 sentinel);
//   * a chunk's maxima go straight from registers to device memory as
//     16-byte vectors, each pair of neighbouring threads swapping one pair
//     of columns with a shuffle; K11 dequantises each maximum on the way,
//     with the chunk's 128 bucket scales read from L1 / L2.
// The wgmma kernel takes the widths whose query tile leaves a ring of at
// least 4 stages: bf16 D % 32 == 0 up to 768, int8 D % 64 == 0 up to 1152
// (UNIIR_SWEEP_MAX_D_*, set in _build.py::DEFINES and read by
// ops/topk.py::sweep_route).  Wider pools go to the general kernels below
// (a block per 64 queries x one chunk, 8 warps of mma.sync fed straight from
// device memory), the sweeps' first design.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "int8_gemm.cuh"  // TMA, mbarrier and tensor-map helpers, wgmma s8 products
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uniir::mma_bf16_16816;
using uniir::mma_s8_16832;

constexpr int CHUNK = 2048;
constexpr int LANES = 128;            // buckets per chunk
constexpr int GROUP = CHUNK / LANES;  // members per bucket
constexpr int WARPS = 8;              // 16 bucket lanes each
constexpr int QT = 64;                // queries per block (4 m16 tiles)
constexpr float NEG = -3e38f;         // the reference's padding score

// Query tile rows are padded by 64 bytes so a quarter warp's 16-byte loads
// of two rows fall on disjoint banks.
constexpr int PAD_BYTES = 64;

__device__ __forceinline__ void load_query_tile(unsigned char* qs, const unsigned char* queries, int Q, int q0,
                                                int row_bytes, int stride) {
  const int vecs = row_bytes / 16;
  for (int idx = threadIdx.x; idx < QT * vecs; idx += blockDim.x) {
    const int r = idx / vecs, c = idx % vecs;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + r < Q) x = *reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * row_bytes + c * 16);
    *reinterpret_cast<uint4*>(qs + r * stride + c * 16) = x;
  }
}

// Writes this warp's maxima: rows q0 + qt*16 + {g, g+8}, columns
// chunk*128 + lane0 + nt*8 + 2t + {0, 1}.
__device__ __forceinline__ void store_maxima(float* out, const float (&mx)[4][2][4], int Q, int NB, int q0,
                                             int col0, int g, int t) {
#pragma unroll
  for (int qt = 0; qt < 4; ++qt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      const int r_lo = q0 + qt * 16 + g, r_hi = r_lo + 8;
      if (r_lo < Q) *reinterpret_cast<float2*>(out + (size_t)r_lo * NB + col) = make_float2(mx[qt][nt][0], mx[qt][nt][1]);
      if (r_hi < Q) *reinterpret_cast<float2*>(out + (size_t)r_hi * NB + col) = make_float2(mx[qt][nt][2], mx[qt][nt][3]);
    }
  }
}

// The general kernels: one block per (query tile of 64, pool chunk), query tiles of one chunk
// launched next to each other so repeated chunk reads hit L2.  The query tile sits in shared memory; each
// of 8 warps owns 16 bucket lanes (two n8 tiles) and walks the 16 bucket members m, loading pool rows
// straight from global memory as 16-byte vectors into mma.sync B fragments.  Because a dot product does not
// care how its k axis is ordered, lane t takes 8 consecutive features (16 for int8) and both operands use
// the same k permutation, so every global load is a full 16-byte vector.  The running max over m is
// elementwise across C fragments of equal layout.
__global__ void __launch_bounds__(WARPS * 32)
bucket_max_bf16_kernel(const bf16* __restrict__ queries, const bf16* __restrict__ pool, float* __restrict__ out,
                       int Q, int D, int NB, int valid_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = D * 2 + PAD_BYTES;
  const int q0 = blockIdx.x * QT, chunk = blockIdx.y;
  load_query_tile(smem, reinterpret_cast<const unsigned char*>(queries), Q, q0, D * 2, stride);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lane0 = warp * 16;  // first bucket lane of this warp

  float mx[4][2][4];
#pragma unroll
  for (int qt = 0; qt < 4; ++qt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mx[qt][nt][0] = mx[qt][nt][1] = mx[qt][nt][2] = mx[qt][nt][3] = -INFINITY;

  for (int m = 0; m < GROUP; ++m) {
    const int row0 = chunk * CHUNK + m * LANES + lane0;  // pool row of column 0 of n-tile 0
    float acc[4][2][4];
#pragma unroll
    for (int qt = 0; qt < 4; ++qt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) acc[qt][nt][0] = acc[qt][nt][1] = acc[qt][nt][2] = acc[qt][nt][3] = 0.f;

    const bf16* prow0 = pool + (size_t)(row0 + g) * D + 8 * t;
    const bf16* prow1 = prow0 + (size_t)8 * D;
    for (int k0 = 0; k0 < D; k0 += 32) {
      const uint4 b0 = *reinterpret_cast<const uint4*>(prow0 + k0);
      const uint4 b1 = *reinterpret_cast<const uint4*>(prow1 + k0);
#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
        const unsigned char* qa = smem + (qt * 16 + g) * stride + (k0 + 8 * t) * 2;
        const uint4 lo = *reinterpret_cast<const uint4*>(qa);
        const uint4 hi = *reinterpret_cast<const uint4*>(qa + 8 * stride);
        const uint32_t a_first[4] = {lo.x, hi.x, lo.y, hi.y};
        const uint32_t a_second[4] = {lo.z, hi.z, lo.w, hi.w};
        mma_bf16_16816(acc[qt][0], a_first, b0.x, b0.y);
        mma_bf16_16816(acc[qt][0], a_second, b0.z, b0.w);
        mma_bf16_16816(acc[qt][1], a_first, b1.x, b1.y);
        mma_bf16_16816(acc[qt][1], a_second, b1.z, b1.w);
      }
    }
#pragma unroll
    for (int qt = 0; qt < 4; ++qt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int prow = row0 + nt * 8 + 2 * t + (e & 1);
          mx[qt][nt][e] = fmaxf(mx[qt][nt][e], prow < valid_n ? acc[qt][nt][e] : NEG);
        }
  }
  store_maxima(out, mx, Q, NB, q0, chunk * LANES + lane0, g, t);
}

__global__ void __launch_bounds__(WARPS * 32)
bucket_max_i8_kernel(const int8_t* __restrict__ queries, const float* __restrict__ q_scale,
                     const int8_t* __restrict__ pool, const float* __restrict__ pool_scale, float* __restrict__ out,
                     int Q, int D, int NB, int valid_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = D + PAD_BYTES;
  const int q0 = blockIdx.x * QT, chunk = blockIdx.y;
  load_query_tile(smem, reinterpret_cast<const unsigned char*>(queries), Q, q0, D, stride);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lane0 = warp * 16;

  float qs[4][2];  // query scales of rows g and g+8 of each m16 tile
#pragma unroll
  for (int qt = 0; qt < 4; ++qt) {
    const int r = q0 + qt * 16 + g;
    qs[qt][0] = r < Q ? q_scale[r] : 1.f;
    qs[qt][1] = r + 8 < Q ? q_scale[r + 8] : 1.f;
  }

  float mx[4][2][4];
#pragma unroll
  for (int qt = 0; qt < 4; ++qt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mx[qt][nt][0] = mx[qt][nt][1] = mx[qt][nt][2] = mx[qt][nt][3] = -INFINITY;

  for (int m = 0; m < GROUP; ++m) {
    const int row0 = chunk * CHUNK + m * LANES + lane0;
    int acc[4][2][4];
#pragma unroll
    for (int qt = 0; qt < 4; ++qt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) acc[qt][nt][0] = acc[qt][nt][1] = acc[qt][nt][2] = acc[qt][nt][3] = 0;

    const int8_t* prow0 = pool + (size_t)(row0 + g) * D + 16 * t;
    const int8_t* prow1 = prow0 + (size_t)8 * D;
    for (int k0 = 0; k0 < D; k0 += 64) {
      const uint4 b0 = *reinterpret_cast<const uint4*>(prow0 + k0);
      const uint4 b1 = *reinterpret_cast<const uint4*>(prow1 + k0);
#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
        const unsigned char* qa = smem + (qt * 16 + g) * stride + k0 + 16 * t;
        const uint4 lo = *reinterpret_cast<const uint4*>(qa);
        const uint4 hi = *reinterpret_cast<const uint4*>(qa + 8 * stride);
        const uint32_t a_first[4] = {lo.x, hi.x, lo.y, hi.y};
        const uint32_t a_second[4] = {lo.z, hi.z, lo.w, hi.w};
        mma_s8_16832(acc[qt][0], a_first, b0.x, b0.y);
        mma_s8_16832(acc[qt][0], a_second, b0.z, b0.w);
        mma_s8_16832(acc[qt][1], a_first, b1.x, b1.y);
        mma_s8_16832(acc[qt][1], a_second, b1.z, b1.w);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int prow = row0 + nt * 8 + 2 * t;
      const float ps0 = pool_scale[prow], ps1 = pool_scale[prow + 1];
#pragma unroll
      for (int qt = 0; qt < 4; ++qt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = __fmul_rn(__fmul_rn((float)acc[qt][nt][e], qs[qt][e >> 1]), (e & 1) ? ps1 : ps0);
          mx[qt][nt][e] = fmaxf(mx[qt][nt][e], prow + (e & 1) < valid_n ? s : NEG);
        }
    }
  }
  store_maxima(out, mx, Q, NB, q0, chunk * LANES + lane0, g, t);
}

constexpr int SENTINEL = -2147483647;  // the reference's int32 mask value, -(2^31 - 1)

// Two blocks an SM (at most 128 registers a thread), as K4 gets: the sweep
// hides its global-load latency with resident warps.
__global__ void __launch_bounds__(WARPS * 32, 2)
bucket_max_i8b_kernel(const int8_t* __restrict__ queries, const float* __restrict__ q_scale,
                      const int8_t* __restrict__ pool, const float* __restrict__ bucket_scale,
                      float* __restrict__ out, int Q, int D, int NB, int valid_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = D + PAD_BYTES;
  const int q0 = blockIdx.x * QT, chunk = blockIdx.y;
  load_query_tile(smem, reinterpret_cast<const unsigned char*>(queries), Q, q0, D, stride);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lane0 = warp * 16;

  int mx[4][2][4];  // running int32 maxima: the members of a bucket share their scale
#pragma unroll
  for (int qt = 0; qt < 4; ++qt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mx[qt][nt][0] = mx[qt][nt][1] = mx[qt][nt][2] = mx[qt][nt][3] = SENTINEL;

  for (int m = 0; m < GROUP; ++m) {
    const int row0 = chunk * CHUNK + m * LANES + lane0;
    int acc[4][2][4];
#pragma unroll
    for (int qt = 0; qt < 4; ++qt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) acc[qt][nt][0] = acc[qt][nt][1] = acc[qt][nt][2] = acc[qt][nt][3] = 0;

    const int8_t* prow0 = pool + (size_t)(row0 + g) * D + 16 * t;
    const int8_t* prow1 = prow0 + (size_t)8 * D;
    for (int k0 = 0; k0 < D; k0 += 64) {
      const uint4 b0 = *reinterpret_cast<const uint4*>(prow0 + k0);
      const uint4 b1 = *reinterpret_cast<const uint4*>(prow1 + k0);
#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
        const unsigned char* qa = smem + (qt * 16 + g) * stride + k0 + 16 * t;
        const uint4 lo = *reinterpret_cast<const uint4*>(qa);
        const uint4 hi = *reinterpret_cast<const uint4*>(qa + 8 * stride);
        const uint32_t a_first[4] = {lo.x, hi.x, lo.y, hi.y};
        const uint32_t a_second[4] = {lo.z, hi.z, lo.w, hi.w};
        mma_s8_16832(acc[qt][0], a_first, b0.x, b0.y);
        mma_s8_16832(acc[qt][0], a_second, b0.z, b0.w);
        mma_s8_16832(acc[qt][1], a_first, b1.x, b1.y);
        mma_s8_16832(acc[qt][1], a_second, b1.z, b1.w);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int prow = row0 + nt * 8 + 2 * t;
#pragma unroll
      for (int qt = 0; qt < 4; ++qt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[qt][nt][e] = max(mx[qt][nt][e], prow + (e & 1) < valid_n ? acc[qt][nt][e] : SENTINEL);
    }
  }

  // One convert and (max * q_scale) * bucket_scale per output, each multiply
  // rounded on its own; an all-padding bucket writes NEG.  Converted and
  // stored tile by tile, so no second [4][2][4] array is live beside `mx`.
  const int col0 = chunk * LANES + lane0;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int bl = lane0 + nt * 8 + 2 * t;  // bucket lane of element 0; its first member is row chunk*CHUNK + bl
    const float bs0 = bucket_scale[chunk * LANES + bl], bs1 = bucket_scale[chunk * LANES + bl + 1];
    const bool ok0 = chunk * CHUNK + bl < valid_n, ok1 = chunk * CHUNK + bl + 1 < valid_n;
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) {
      const int r_lo = q0 + qt * 16 + g, r_hi = r_lo + 8;
      const float qs_lo = r_lo < Q ? q_scale[r_lo] : 1.f, qs_hi = r_hi < Q ? q_scale[r_hi] : 1.f;
      const float d0 = ok0 ? __fmul_rn(__fmul_rn((float)mx[qt][nt][0], qs_lo), bs0) : NEG;
      const float d1 = ok1 ? __fmul_rn(__fmul_rn((float)mx[qt][nt][1], qs_lo), bs1) : NEG;
      const float d2 = ok0 ? __fmul_rn(__fmul_rn((float)mx[qt][nt][2], qs_hi), bs0) : NEG;
      const float d3 = ok1 ? __fmul_rn(__fmul_rn((float)mx[qt][nt][3], qs_hi), bs1) : NEG;
      const int col = col0 + nt * 8 + 2 * t;
      if (r_lo < Q) *reinterpret_cast<float2*>(out + (size_t)r_lo * NB + col) = make_float2(d0, d1);
      if (r_hi < Q) *reinterpret_cast<float2*>(out + (size_t)r_hi * NB + col) = make_float2(d2, d3);
    }
  }
}

// ------------------------------------------ K2 / K4 / K11: the wgmma sweep

constexpr int SWEEP_MAX_STAGES = 8;
constexpr int SWEEP_MIN_STAGES = 4;       // the ring every width the wgmma kernel takes leaves at least
constexpr int SWEEP_SMEM_LIMIT = 232448;  // shared memory a block may have on an H100
constexpr int SWEEP_BARRIER_BYTES = 256;  // full / empty a stage, the query tile's, two chunk-scale slots' pairs

// d (64 x 256 fp32, 128 registers a thread) = A (64 x 16 bf16) . B^T (256 x 16 bf16) + (scale_d ? d : 0),
// both K-major in shared memory behind 128-byte-swizzle descriptors (wgmma.cuh: wgmma_desc).
__device__ __forceinline__ void wgmma_m64n256k16_bf16_ss(float* d, uint64_t a_desc, uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// The shape of each sweep.  A block holds QROWS queries for its life; CONSUMERS warpgroups each multiply 64 of
// them by SLABS slabs of the pool (SLABS * 128 rows: one stage's rows) with one wgmma a k step; a cluster of
// CLUSTER blocks (along the queries) fetches each stage once from L2 for all of them, so every pool byte
// fetched meets QROWS * CLUSTER = 128 queries.  Shared memory (128 B a clock an SM) carries, per stage, the
// TMA write, one wgmma read of it a warpgroup, and 64 rows of A a product; at the tensor cores' rate that is
//   K2 (bf16, 64 queries, one warpgroup, m64n256 over two slabs): 144 B a clock (two warpgroups on m64n64
//       halves would need 192, which holds the tensor cores to 67 %);
//   K4 (int8, 128 queries, two warpgroups on m64n128): 128 B a clock, and registers for two accumulator
//       sets, so the dequantising fold of one slab runs under the next slab's products;
//   K11 (int8 with one scale a bucket; tag I8Bucket): K4's shape and two accumulator sets, with int32 maxima
//       (Max = int), no per-row scale stream (SCALED = false) and the dequantisation at the store (BUCKET),
//       the chunk's bucket scales read there from L1 / L2.  On an H100 both alternatives were slower at 1024
//       queries: one accumulator set, as K2 (its fold is as short), and the bucket scales streamed into
//       shared memory a chunk at a time, as K4's row scales.
// Elem is the pool's element type.
struct I8Bucket {};
template <class Tag>
struct SweepOf;
template <>
struct SweepOf<bf16> {
  using Elem = bf16;
  using Acc = float;
  using Max = float;
  static constexpr int QROWS = 64, CONSUMERS = 1, SLABS = 2, CLUSTER = 2, MAX_D = UNIIR_SWEEP_MAX_D_BF16;
  static constexpr int STAGE = SLABS * LANES * 128, THREADS = 128 * (CONSUMERS + 1);
  static constexpr bool SCALED = false, TWO_ACC = false, BUCKET = false;
  __device__ static void mma(float* d, uint64_t a, uint64_t b, int scale_d) { wgmma_m64n256k16_bf16_ss(d, a, b, scale_d); }
  __device__ static void fence_acc(float* d) { uniir::wgmma_fence_regs<128>(d); }
};
template <>
struct SweepOf<int8_t> {
  using Elem = int8_t;
  using Acc = int;
  using Max = float;
  static constexpr int QROWS = 128, CONSUMERS = 2, SLABS = 1, CLUSTER = 1, MAX_D = UNIIR_SWEEP_MAX_D_I8;
  static constexpr int STAGE = SLABS * LANES * 128, THREADS = 128 * (CONSUMERS + 1);
  static constexpr bool SCALED = true, TWO_ACC = true, BUCKET = false;
  __device__ static void mma(int* d, uint64_t a, uint64_t b, int scale_d) { uniir::wgmma_m64n128k32_s8(d, a, b, scale_d); }
  __device__ static void fence_acc(int* d) { uniir::wgmma_fence_iregs<64>(d); }
};
template <>
struct SweepOf<I8Bucket> : SweepOf<int8_t> {
  using Max = int;
  static constexpr bool SCALED = false, BUCKET = true;
};

// Shared-memory plan of a launch (the same on host and device): the query tile as `kb` boxes of QROWS rows x
// 128 bytes, K4's two chunk-scale slots, the ring, the barriers, and the slack that aligns it all to 1024 bytes.
struct SweepPlan {
  int kb, stages, smem;
};
template <class Tag>
__host__ __device__ constexpr SweepPlan sweep_plan(int D) {
  using S = SweepOf<Tag>;
  constexpr int STAGE = S::STAGE;
  const int kb = (D * (int)sizeof(typename S::Elem) + 127) / 128;
  const int fixed = 1024 + kb * S::QROWS * 128 + (S::SCALED ? 2 * CHUNK * 4 : 0) + SWEEP_BARRIER_BYTES;
  int stages = (SWEEP_SMEM_LIMIT - fixed) / STAGE;
  stages = stages > SWEEP_MAX_STAGES ? SWEEP_MAX_STAGES : stages;
  return {kb, stages, fixed + stages * STAGE};
}
// The widest D each sweep takes (MAX_D) is set once, in uniir_tpu_torch/_build.py::DEFINES, which
// ops/topk.py::sweep_route reads too; here it is held to the ring it must leave.
static_assert(sweep_plan<bf16>(SweepOf<bf16>::MAX_D).stages >= SWEEP_MIN_STAGES, "bf16 MAX_D leaves too short a ring");
static_assert(sweep_plan<int8_t>(SweepOf<int8_t>::MAX_D).stages >= SWEEP_MIN_STAGES, "int8 MAX_D leaves too short a ring");
static_assert(sweep_plan<I8Bucket>(SweepOf<I8Bucket>::MAX_D).stages >= SWEEP_MIN_STAGES, "int8 MAX_D leaves too short a ring");

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of both blocks; orders what came before (barrier inits, remote arrivals) with what follows.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// As uniir::tma_load_2d, the box landing at the same offset of every block in `mask` and completing bytes on the
// barrier at the same offset of each.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n"
      ::"r"(uniir::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(uniir::smem_u32(bar)), "r"(x), "r"(y),
      "h"(mask) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(uniir::smem_u32(dst)), "l"(src), "r"(bytes), "r"(uniir::smem_u32(bar)) : "memory");
}
// One arrival a consumer warp on this block's barrier (the chunk-scale slots count 8) ...
__device__ __forceinline__ void arrive_warp(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) uniir::mbar_arrive(bar);
}
// ... and on the same barrier of every block of the cluster (the ring's empty barriers count 8 a block: a
// stage is refilled in all of them at once).  The arrival's release is the CTA's, as CUTLASS's pipelines
// signal a peer: a cluster-scope release on every arrival made the sweep several times slower on an H100.
template <int CLUSTER>
__device__ __forceinline__ void arrive_warp_cluster(uint64_t* bar) {
  if constexpr (CLUSTER == 1) {
    arrive_warp(bar);
  } else {
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(uniir::smem_u32(bar)), "r"(r));
        asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
      }
    }
  }
}

// A consumer warpgroup's walk over the ring: wait for a stage, issue its four k steps as one commit group,
// then wait for the group before it and hand that group's stage back to the producers.
struct RingCursor {
  uint64_t* full;
  uint64_t* empty;
  int stages, s = 0, phase = 0, held = -1;

  template <class S, class Acc>
  __device__ __forceinline__ void consume(Acc* acc, uint64_t a_desc, uint64_t b_desc, bool first) {
    uniir::mbar_wait(&full[s], phase);
    uniir::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // +32 bytes of k each
      S::mma(acc, a_desc + 2 * ks, b_desc + (uint64_t)(s * (S::STAGE / 16)) + 2 * ks,
             (first && ks == 0) ? 0 : 1);
    uniir::wgmma_commit();
    uniir::wgmma_wait<1>();
    release<S>();
    held = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  template <class S>
  __device__ __forceinline__ void release() {
    if (held >= 0) arrive_warp_cluster<S::CLUSTER>(&empty[held]);
    held = -1;
  }
  // every group done; the last stage handed back
  template <class S>
  __device__ __forceinline__ void drain() {
    uniir::wgmma_wait<0>();
    release<S>();
  }
};

// Folds one product's accumulators (SLABS slabs) into the running maxima: accumulator 4 j + 2 h + e is query
// row 16 warp + g + 8 h of the warpgroup's 64 and stage row 8 j + 2 q + e, that is slab j / 16, bucket lane
// 8 (j % 16) + 2 q + e, whose running maximum is mx[4 (j % 16) + 2 h + e]; its pool row is row0 + the stage
// row.  K4 dequantises first, (float(acc) * q_scale) * pool_scale, each multiply rounded on its own; MASK
// selects -3e38 for rows >= valid_n (only in a chunk that reaches valid_n).  K11 (BUCKET) takes the int32
// maximum of the raw accumulators, the sentinel for rows >= valid_n.
template <class S, bool MASK>
__device__ __forceinline__ void fold_slabs(typename S::Max* mx, const typename S::Acc* acc, int row0, int valid_n,
                                           int q, const float* slab_scale, const float* qs) {
#pragma unroll
  for (int j = 0; j < S::SLABS * LANES / 8; ++j) {
    float2 ps = make_float2(1.f, 1.f);
    if constexpr (S::SCALED) ps = *reinterpret_cast<const float2*>(slab_scale + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        if constexpr (S::BUCKET) {
          int v = acc[i];
          if constexpr (MASK) v = row0 + 8 * j + 2 * q + e < valid_n ? v : SENTINEL;
          mx[i % 64] = max(mx[i % 64], v);
        } else {
          float v;
          if constexpr (S::SCALED)
            v = __fmul_rn(__fmul_rn((float)acc[i], qs[h]), e ? ps.y : ps.x);
          else
            v = acc[i];
          if constexpr (MASK) v = row0 + 8 * j + 2 * q + e < valid_n ? v : NEG;
          mx[i % 64] = fmaxf(mx[i % 64], v);
        }
      }
  }
}

// pool_scale: K4's [N] row scales, K11's [N / 16] bucket scales (indexed like the output columns), K2 none.
template <class Tag>
__global__ void __cluster_dims__(SweepOf<Tag>::CLUSTER, 1, 1) __launch_bounds__(SweepOf<Tag>::THREADS, 1)
bucket_max_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_pool,
                        const float* __restrict__ q_scale, const float* __restrict__ pool_scale,
                        float* __restrict__ out, int Q, int NB, int valid_n, int n_chunks, int kb_count, int stages) {
  using S = SweepOf<Tag>;
  using Acc = typename S::Acc;
  using Max = typename S::Max;
  constexpr int NACC = S::SLABS * LANES / 2;  // accumulators a thread, 64 of them a slab
  constexpr int STAGE = S::STAGE;  // SLABS slabs' rows x 128 bytes of k
  constexpr int PRODUCER = 128 * S::CONSUMERS;  // the thread that issues every load
  constexpr int QBOX = S::QROWS * 128;
  constexpr int SCALE_BYTES = S::SCALED ? 2 * CHUNK * 4 : 0;
  constexpr int K_STEP = 128 / (int)sizeof(typename S::Elem);  // elements of k a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qtile = smem;
  float* scales = reinterpret_cast<float*>(smem + kb_count * QBOX);  // [2][CHUNK]: K4's slots, chunk by chunk
  unsigned char* ring = smem + kb_count * QBOX + SCALE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + SWEEP_MAX_STAGES;
  uint64_t* qfull = empty + SWEEP_MAX_STAGES;
  uint64_t* sfull = qfull + 1;
  uint64_t* sempty = sfull + 2;
  const int q0 = blockIdx.x * S::QROWS;  // the cluster's blocks hold neighbouring query tiles
  const int rank = (int)cluster_rank();
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      uniir::mbar_init(&full[s], 1);                  // this block's expect_tx; both blocks' TMA bytes complete it
      uniir::mbar_init(&empty[s], 4 * S::CONSUMERS * S::CLUSTER);  // every consumer warp of the cluster
    }
    uniir::mbar_init(qfull, 1);
    for (int i = 0; i < 2; ++i) {
      uniir::mbar_init(&sfull[i], 1);
      uniir::mbar_init(&sempty[i], 4 * S::CONSUMERS);  // every consumer warp of this block, after the chunk
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // no block multicasts into, or arrives on, a barrier its partners have not initialised
  if constexpr (S::CLUSTER > 1)
    cluster_sync();
  else
    __syncthreads();

  if (wg == S::CONSUMERS) {
    // producer: one thread issues every load; two consumer warpgroups get its registers
    if constexpr (S::CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == PRODUCER) {
      uniir::mbar_expect_tx(qfull, kb_count * QBOX);  // rows past Q are zero-filled, and count
      for (int kb = 0; kb < kb_count; ++kb) uniir::tma_load_2d(qtile + kb * QBOX, &map_q, qfull, kb * K_STEP, q0);
      int s = 0, use = 0, ci = 0;
      for (int c = blockIdx.y; c < n_chunks; c += gridDim.y, ++ci) {
        if constexpr (S::SCALED) {
          const int slot = ci & 1;
          if (ci >= 2) uniir::mbar_wait(&sempty[slot], ((ci >> 1) - 1) & 1);
          uniir::mbar_expect_tx(&sfull[slot], CHUNK * 4);
          bulk_load(scales + slot * CHUNK, pool_scale + (size_t)c * CHUNK, CHUNK * 4, &sfull[slot]);
        }
        for (int m = 0; m < GROUP; m += S::SLABS) {
          for (int kb = 0; kb < kb_count; ++kb) {
            if (use > 0) uniir::mbar_wait(&empty[s], (use - 1) & 1);  // every block is done with the stage
            uniir::mbar_expect_tx(&full[s], STAGE);
            // this block fetches its share of the stage's rows, for every block of the cluster
            constexpr int PART = S::SLABS * LANES / S::CLUSTER;
            if constexpr (S::CLUSTER > 1)
              tma_load_2d_multicast(ring + s * STAGE + rank * PART * 128, &map_pool, &full[s], kb * K_STEP,
                                    c * CHUNK + m * LANES + rank * PART, (uint16_t)((1 << S::CLUSTER) - 1));
            else
              uniir::tma_load_2d(ring + s * STAGE, &map_pool, &full[s], kb * K_STEP, c * CHUNK + m * LANES);
            if (++s == stages) {
              s = 0;
              ++use;
            }
          }
        }
      }
    }
  } else {
    if constexpr (S::CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int r_lo = q0 + 64 * wg + 16 * warp + g;  // this thread's query rows: r_lo and r_lo + 8
    float qs[2] = {1.f, 1.f};
    if constexpr (S::SCALED || S::BUCKET) {
      qs[0] = r_lo < Q ? q_scale[r_lo] : 1.f;
      qs[1] = r_lo + 8 < Q ? q_scale[r_lo + 8] : 1.f;
    }
    const uint64_t a_desc = uniir::wgmma_desc(uniir::smem_u32(qtile + 64 * wg * 128));  // this warpgroup's rows
    const uint64_t b_desc = uniir::wgmma_desc(uniir::smem_u32(ring));
    RingCursor cur{full, empty, stages};
    uniir::mbar_wait(qfull, 0);

    Acc acc_a[NACC], acc_b[S::TWO_ACC ? NACC : 1];
    Max mx[64];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc_a[i] = 0;
#pragma unroll
    for (int i = 0; i < (S::TWO_ACC ? NACC : 1); ++i) acc_b[i] = 0;
    int ci = 0;
    for (int c = blockIdx.y; c < n_chunks; c += gridDim.y, ++ci) {
      const bool masked = (c + 1) * CHUNK > valid_n;  // only a chunk that reaches valid_n selects
      const float* sc = scales + (ci & 1) * CHUNK;
      if constexpr (S::SCALED) uniir::mbar_wait(&sfull[ci & 1], (ci >> 1) & 1);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if constexpr (S::BUCKET)
          mx[i] = SENTINEL;
        else
          mx[i] = -INFINITY;
      }
      auto fold = [&](const Acc* acc, int m) {
        const int row0 = c * CHUNK + m * LANES;
        if (masked)
          fold_slabs<S, true>(mx, acc, row0, valid_n, q, sc + m * LANES, qs);
        else
          fold_slabs<S, false>(mx, acc, row0, valid_n, q, sc + m * LANES, qs);
      };
      if constexpr (!S::TWO_ACC) {
        // K2: one product of SLABS slabs at a time; its fold is a maximum an accumulator, short
        for (int m = 0; m < GROUP; m += S::SLABS) {
          cur.consume<S>(acc_a, a_desc, b_desc, true);
          for (int kb = 1; kb < kb_count; ++kb) cur.consume<S>(acc_a, a_desc + kb * (QBOX / 16), b_desc, false);
          cur.drain<S>();
          S::fence_acc(acc_a);
          fold(acc_a, m);
        }
      } else {
        for (int m = 0; m < GROUP; m += 2) {
          // slab m into acc_a; under its first stage's products, fold slab m - 1 (acc_b)
          cur.consume<S>(acc_a, a_desc, b_desc, true);
          if (m > 0) {
            S::fence_acc(acc_b);
            fold(acc_b, m - 1);
          }
          for (int kb = 1; kb < kb_count; ++kb) cur.consume<S>(acc_a, a_desc + kb * (QBOX / 16), b_desc, false);
          // slab m + 1 into acc_b; under its first stage's products, fold slab m (acc_a)
          cur.consume<S>(acc_b, a_desc, b_desc, true);
          S::fence_acc(acc_a);
          fold(acc_a, m);
          for (int kb = 1; kb < kb_count; ++kb) cur.consume<S>(acc_b, a_desc + kb * (QBOX / 16), b_desc, false);
          // no product in flight across the loop's back edge: ptxas would serialise every wgmma otherwise
          cur.drain<S>();
        }
        S::fence_acc(acc_b);
        fold(acc_b, GROUP - 1);
      }
      if constexpr (S::SCALED) arrive_warp(&sempty[ci & 1]);

      // the chunk's maxima of row h's columns 8 j + 2 q + {0, 1}; K11 dequantises each, (float(max) *
      // q_scale) * bucket_scale, each multiply rounded on its own, and writes NEG for a bucket whose first
      // member (row c * CHUNK + its column) is >= valid_n: a dequantised sentinel could outrank true scores
      const float* bucket_scale = pool_scale + (size_t)c * LANES;
      auto pair = [&](int j, int h) -> float2 {
        const int i = 4 * j + 2 * h;
        if constexpr (S::BUCKET) {
          const int col = 8 * j + 2 * q;
          const float2 bs = __ldg(reinterpret_cast<const float2*>(bucket_scale + col));
          const bool ok0 = c * CHUNK + col < valid_n, ok1 = c * CHUNK + col + 1 < valid_n;
          return make_float2(ok0 ? __fmul_rn(__fmul_rn((float)mx[i], qs[h]), bs.x) : NEG,
                             ok1 ? __fmul_rn(__fmul_rn((float)mx[i + 1], qs[h]), bs.y) : NEG);
        } else {
          return make_float2(mx[i], mx[i + 1]);
        }
      };
      // the quad's threads q and q ^ 1 swap one column pair, so each holds four neighbouring columns (n8 tile j
      // for even q, j + 1 for odd q) and writes one 16-byte vector
      const bool odd = q & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r_lo + 8 * h;
        float* dst = out + (size_t)row * NB + (size_t)c * LANES + 2 * (q & ~1);
#pragma unroll
        for (int j = 0; j < LANES / 8; j += 2) {
          const float2 a = pair(j, h);
          const float2 b = pair(j + 1, h);
          const float2 send = odd ? a : b;
          const float rx = __shfl_xor_sync(0xffffffffu, send.x, 1), ry = __shfl_xor_sync(0xffffffffu, send.y, 1);
          const float4 v = odd ? make_float4(rx, ry, b.x, b.y) : make_float4(a.x, a.y, rx, ry);
          if (row < Q) *reinterpret_cast<float4*>(dst + 8 * (j + odd)) = v;
        }
      }
    }
  }
  if constexpr (S::CLUSTER > 1) cluster_sync();  // a partner may still multicast into this block or arrive on it
}

// A map of a row-major [rows, cols] matrix of T (a row 16-byte aligned) in boxes of box_rows x 128 bytes,
// 128-byte swizzled; reads past either edge are zero-filled.
template <class T>
inline bool encode_sweep_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const uniir::EncodeTiled encode = uniir::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Tag>
cudaError_t launch_sweep(const void* queries, const float* q_scale, const void* pool, const float* pool_scale,
                         void* out, int Q, int N, int D, int valid_n, cudaStream_t stream) {
  using S = SweepOf<Tag>;
  using T = typename S::Elem;
  if (D > S::MAX_D) return cudaErrorInvalidValue;  // the general kernels take this width
  const SweepPlan plan = sweep_plan<Tag>(D);
  if (Q == 0) return cudaSuccess;
  CUtensorMap map_q, map_pool;
  if (!encode_sweep_map<T>(&map_q, queries, Q, D, S::QROWS) ||
      !encode_sweep_map<T>(&map_pool, pool, N, D, S::SLABS * LANES / S::CLUSTER))
    return cudaErrorInvalidValue;
  const auto kernel = bucket_max_wgmma_kernel<Tag>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Q + S::CLUSTER * S::QROWS - 1) / (S::CLUSTER * S::QROWS) * S::CLUSTER;
  const int n_chunks = N / CHUNK;
  // one wave of persistent clusters: as many as the card holds at once (a cluster's blocks share a GPC, so
  // that can be fewer than SMs / 2), spread over the query tiles
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles, 1);
  config.blockDim = dim3(S::THREADS);
  config.dynamicSmemBytes = plan.smem;
  config.stream = stream;
  int clusters = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (occ != cudaSuccess) return occ;
  int walkers = clusters / (tiles / S::CLUSTER);  // blocks a query tile
  walkers = walkers < 1 ? 1 : (walkers > n_chunks ? n_chunks : walkers);
  kernel<<<dim3(tiles, walkers), S::THREADS, plan.smem, stream>>>(
      map_q, map_pool, q_scale, pool_scale, static_cast<float*>(out), Q, N / GROUP, valid_n, n_chunks, plan.kb,
      plan.stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: queries [Q, D] bf16, pool [N, D] bf16 (N % 2048 == 0, D % 32 == 0, D <= 768),
// out [Q, N/16] fp32, all contiguous and 16-byte aligned on the device.
int uniir_bucket_max_bf16(const void* queries, const void* pool, void* out, int Q, int N, int D, int valid_n,
                          void* stream) {
  return (int)launch_sweep<bf16>(queries, nullptr, pool, nullptr, out, Q, N, D, valid_n, (cudaStream_t)stream);
}

// K4: queries [Q, D] int8 + q_scale [Q] fp32, pool [N, D] int8 + pool_scale [N]
// fp32 (N % 2048 == 0, D % 64 == 0, D <= 1152), out [Q, N/16] fp32.
int uniir_bucket_max_i8(const void* queries, const void* q_scale, const void* pool, const void* pool_scale, void* out,
                        int Q, int N, int D, int valid_n, void* stream) {
  return (int)launch_sweep<int8_t>(queries, static_cast<const float*>(q_scale), pool,
                                   static_cast<const float*>(pool_scale), out, Q, N, D, valid_n, (cudaStream_t)stream);
}

// K2's general-width kernel: as uniir_bucket_max_bf16 for any D % 32 == 0.
int uniir_bucket_max_bf16_general(const void* queries, const void* pool, void* out, int Q, int N, int D, int valid_n,
                                  void* stream) {
  const int smem = QT * (D * 2 + PAD_BYTES);
  cudaError_t err = cudaFuncSetAttribute(bucket_max_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + QT - 1) / QT, N / CHUNK);
  bucket_max_bf16_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(queries), static_cast<const bf16*>(pool), static_cast<float*>(out), Q, D,
      N / GROUP, valid_n);
  return (int)cudaGetLastError();
}

// K4's general-width kernel: as uniir_bucket_max_i8 for any D % 64 == 0.
int uniir_bucket_max_i8_general(const void* queries, const void* q_scale, const void* pool, const void* pool_scale,
                                void* out, int Q, int N, int D, int valid_n, void* stream) {
  const int smem = QT * (D + PAD_BYTES);
  cudaError_t err = cudaFuncSetAttribute(bucket_max_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + QT - 1) / QT, N / CHUNK);
  bucket_max_i8_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(queries), static_cast<const float*>(q_scale), static_cast<const int8_t*>(pool),
      static_cast<const float*>(pool_scale), static_cast<float*>(out), Q, D, N / GROUP, valid_n);
  return (int)cudaGetLastError();
}

// K11: as uniir_bucket_max_i8 with one scale per strided bucket: bucket_scale [N/16] fp32, indexed like the
// output columns.
int uniir_bucket_max_i8b(const void* queries, const void* q_scale, const void* pool, const void* bucket_scale,
                         void* out, int Q, int N, int D, int valid_n, void* stream) {
  return (int)launch_sweep<I8Bucket>(queries, static_cast<const float*>(q_scale), pool,
                                     static_cast<const float*>(bucket_scale), out, Q, N, D, valid_n,
                                     (cudaStream_t)stream);
}

// K11's general-width kernel: as uniir_bucket_max_i8b for any D % 64 == 0.
int uniir_bucket_max_i8b_general(const void* queries, const void* q_scale, const void* pool, const void* bucket_scale,
                                 void* out, int Q, int N, int D, int valid_n, void* stream) {
  const int smem = QT * (D + PAD_BYTES);
  cudaError_t err = cudaFuncSetAttribute(bucket_max_i8b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + QT - 1) / QT, N / CHUNK);
  bucket_max_i8b_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(queries), static_cast<const float*>(q_scale), static_cast<const int8_t*>(pool),
      static_cast<const float*>(bucket_scale), static_cast<float*>(out), Q, D, N / GROUP, valid_n);
  return (int)cudaGetLastError();
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
