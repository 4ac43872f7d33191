// K5: int8 x int8 -> int32 matrix product with a fused dequantising epilogue.
//
// Replaces uniir_tpu/ops/quant_pallas.py::fused_int8_matmul (_int8_matmul_2d,
// _kernel): the quantised Dense layer of int8 serving,
//
//   out[m, n] = bf16( dequant( sum_k xq[m, k] * wq[n, k] ) + bias[n] )
//
// with xq [M, K] int8 activations, wq [N, K] int8 weights (the state-dict
// layout: both operands are K-contiguous, the "row.col" pair mma.sync takes)
// and fp32 scales.  Two epilogues, each step rounded on its own (no fused
// multiply-add), so the plain PyTorch twin reproduces them bit for bit:
//   per-row scales (dynamic mode):  (float(acc) * a[m]) * w[n] + b[n]
//   one static scale:               float(acc) * (a * w[n]) + b[n]
// Activation quantisation stays outside the kernel, as in the TPU design.
// The int32 accumulator never reaches device memory.
//
// What bounds it on an H100: operations.  At the CLIP-L shapes (M = 16448,
// K and N in {1024, 3072, 4096}) the product does 670-890 operations per
// byte moved, above the card's int8 ridge of ~590; a mma.sync kernel is
// bound by the rate of its tensor-core instructions, under the wgmma rate.
// Design: a 128 x 128 output tile per block of 8 warps (2 x 4, each 64 x 32),
// k walked in 64-byte steps through a 4-stage cp.async ring in shared memory
// (16 KB a stage).  A dot product does not care how its k axis is ordered, so
// lane t of a quad takes 16 consecutive bytes of a step for both operands:
// every shared-memory read is one conflict-free 16-byte vector feeding two
// m16n8k32 products.  Tails: rows past M or N are clamped on load and masked
// on store, and a half step past K is zero-filled by cp.async, so any M, any
// K % 32 == 0 and any N % 8 == 0 run without a padded copy.  The bf16 tile
// is staged through shared memory and written as 16-byte vectors.
// wgmma / TMA pipelining is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uniir::mma_s8_16832;
using uniir::pack_bf16x2;

constexpr int BM = 128, BN = 128;  // output tile of a block
constexpr int BK = 64;             // bytes of k per pipeline stage
constexpr int STAGES = 4;
constexpr int WARPS_N = 4;         // warps: 2 (m) x 4 (n), each 64 x 32
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * BK;
constexpr int OUT_STRIDE = BN + 8;  // bf16 per staged output row: 272 bytes, conflict-free

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes < 16 zero-fills the rest of the 16-byte destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ a_rows,
                   float a_static, const float* __restrict__ w_scale, const float* __restrict__ bias,
                   bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int chunks = (K + BK - 1) / BK;

  // one stage: BM rows of x then BN rows of w, 64 bytes each, as 16-byte vectors
  auto load_stage = [&](int stage, int chunk) {
    unsigned char* sa = smem + stage * STAGE_BYTES;
    const int k0 = chunk * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;  // i < 2: x rows, else w rows
      const bool is_w = i >= 2;
      const int r = (idx & 511) >> 2, c = idx & 3;
      const int kb = k0 + c * 16;
      const int bytes = kb < K ? 16 : 0;
      const int row = is_w ? min(n0 + r, N - 1) : min(m0 + r, M - 1);
      const int8_t* src = (is_w ? w : x) + (size_t)row * K + (bytes ? kb : 0);
      cp_async16(sa + (is_w ? BM * BK : 0) + r * BK + c * 16, src, bytes);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load_stage(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();              // ... for every thread, and stage (c - 1) % STAGES is free
    if (c + STAGES - 1 < chunks) load_stage((c + STAGES - 1) % STAGES, c + STAGES - 1);
    cp_async_commit();

    const unsigned char* sa = smem + (c % STAGES) * STAGE_BYTES + (wm * 64 + g) * BK + 16 * t;
    const unsigned char* sb = smem + (c % STAGES) * STAGE_BYTES + BM * BK + (wn * 32 + g) * BK + 16 * t;
    uint4 b[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) b[nt] = *reinterpret_cast<const uint4*>(sb + nt * 8 * BK);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint4 lo = *reinterpret_cast<const uint4*>(sa + mt * 16 * BK);
      const uint4 hi = *reinterpret_cast<const uint4*>(sa + (mt * 16 + 8) * BK);
      const uint32_t a_first[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a_second[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_s8_16832(acc[mt][nt], a_first, b[nt].x, b[nt].y);
        mma_s8_16832(acc[mt][nt], a_second, b[nt].z, b[nt].w);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the bf16 tile in it

  bf16* so = reinterpret_cast<bf16*>(smem);
  const bool per_row = a_rows != nullptr;
  float a_row[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      a_row[mt][half] = per_row ? (row < M ? a_rows[row] : 0.f) : a_static;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col_local = wn * 32 + nt * 8 + 2 * t;
    const int col = n0 + col_local;
    const bool live = col < N;  // N is even and col is even: col + 1 < N too
    const float ws0 = live ? w_scale[col] : 0.f, ws1 = live ? w_scale[col + 1] : 0.f;
    const float b0 = (live && bias) ? bias[col] : 0.f, b1 = (live && bias) ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float a = a_row[mt][half];
        const float v0 = (float)acc[mt][nt][half * 2], v1 = (float)acc[mt][nt][half * 2 + 1];
        float y0, y1;
        if (per_row) {
          y0 = __fmul_rn(__fmul_rn(v0, a), ws0);
          y1 = __fmul_rn(__fmul_rn(v1, a), ws1);
        } else {
          y0 = __fmul_rn(v0, __fmul_rn(a, ws0));
          y1 = __fmul_rn(v1, __fmul_rn(a, ws1));
        }
        if (bias) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        const int row_local = wm * 64 + mt * 16 + g + half * 8;
        *reinterpret_cast<uint32_t*>(so + row_local * OUT_STRIDE + col_local) = pack_bf16x2(y0, y1);
      }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM * (BN / 8) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / (BN / 8), c = idx % (BN / 8);
    const int row = m0 + r, col = n0 + c * 8;
    if (row < M && col < N)  // N % 8 == 0: a vector is wholly inside or outside
      *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = *reinterpret_cast<const uint4*>(so + r * OUT_STRIDE + c * 8);
  }
}

}  // namespace

extern "C" {

// x [M, K] int8, w [N, K] int8 (both contiguous, 16-byte aligned, K % 32 == 0),
// a_rows [M] fp32 per-row scales or null (then a_static is the one scale),
// w_scale [N] fp32, bias [N] fp32 or null, out [M, N] bf16 (N % 8 == 0).
int uniir_int8_matmul(const void* x, const void* w, const void* a_rows, float a_static, const void* w_scale,
                      const void* bias, void* out, int M, int N, int K, void* stream) {
  const int smem = STAGES * STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(a_rows), a_static,
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
