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
//   every 16 scores and a [N] scale read; the pool bytes, which bound the
//   sweep, are the same.
//
// All compute, for a pool of N rows (N a multiple of CHUNK = 2048), the
// [Q, N/16] fp32 maxima of the strided buckets of topk_pallas.py:13-15:
// member m (0..15) of bucket (i, l) is pool row i*2048 + m*128 + l, and the
// output column of that bucket is i*128 + l.  Rows >= valid_n score -3e38 by
// select.  The [Q, N] score matrix never exists: each block keeps its score
// tiles in registers and writes only the maxima.
//
// What bounds them on an H100: one full read of the pool (8.6 GB bf16 or
// 4.3 GB int8 at 5.6M x 768) against 2*Q*N*D operations -- at Q = 256 the
// sweep is HBM-bound (about 150 ops per bf16 pool byte, below the ~295 at
// which the tensor cores would bind).  Design: one block per (query tile of
// 64, pool chunk of 2048 rows), query tiles of one chunk launched next to
// each other so repeated chunk reads hit L2.  The query tile sits in shared
// memory; each of 8 warps owns 16 bucket lanes (two n8 tiles) and walks the
// 16 bucket members m, loading pool rows straight from global memory as
// 16-byte vectors into mma.sync B fragments.  Because a dot product does not
// care how its k axis is ordered, lane t takes 8 consecutive features (16
// for int8) and both operands use the same k permutation, so every global
// load is a full 16-byte vector.  The running max over m is elementwise
// across C fragments of equal layout.  TMA/wgmma pipelining is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

}  // namespace

extern "C" {

// queries [Q, D] bf16, pool [N, D] bf16 (N % 2048 == 0, D % 32 == 0),
// out [Q, N/16] fp32, all contiguous on the device.
int uniir_bucket_max_bf16(const void* queries, const void* pool, void* out, int Q, int N, int D, int valid_n,
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

// queries [Q, D] int8 + q_scale [Q] fp32, pool [N, D] int8 + pool_scale [N]
// fp32 (N % 2048 == 0, D % 64 == 0), out [Q, N/16] fp32.
int uniir_bucket_max_i8(const void* queries, const void* q_scale, const void* pool, const void* pool_scale, void* out,
                        int Q, int N, int D, int valid_n, void* stream) {
  const int smem = QT * (D + PAD_BYTES);
  cudaError_t err = cudaFuncSetAttribute(bucket_max_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + QT - 1) / QT, N / CHUNK);
  bucket_max_i8_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(queries), static_cast<const float*>(q_scale), static_cast<const int8_t*>(pool),
      static_cast<const float*>(pool_scale), static_cast<float*>(out), Q, D, N / GROUP, valid_n);
  return (int)cudaGetLastError();
}

// K11: as uniir_bucket_max_i8 with one scale per strided bucket:
// bucket_scale [N/16] fp32, indexed like the output columns.
int uniir_bucket_max_i8b(const void* queries, const void* q_scale, const void* pool, const void* bucket_scale,
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
