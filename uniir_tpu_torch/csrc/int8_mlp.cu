// K6: the fused static-int8 MLP half-block of a pre-LN transformer layer.
//
// Replaces uniir_tpu/ops/mlp_pallas.py::fused_int8_mlp (_kernel):
//
//   out = bf16( res + fc2( quant_a2( act( fc1( quant_a1(h) ) ) ) ) )
//
//   xq  = clip(round(float(h) * (1/a1)))                int8 [M, W]
//   hf  = float(xq . w1^T) * s1 + b1                    s1 = a1 * w1_scale, fp32 [M, H]
//   hq  = clip(round(act(hf) * (1/a2)))                 int8 [M, H]
//   y   = float(hq . w2^T) * (a2 * w2_scale) + b2       fp32 [M, W]
//   out = bf16(y + float(res))
//
// with h, res [M, W] bf16, w1 [H, W] and w2 [W, H] int8 in the state-dict
// layout (K-contiguous, the "col" operand of mma.sync), H = 4W.  Every fp32
// step of the two epilogues is rounded on its own, as in the plain PyTorch
// twin; the integer sums are exact (4096 * 127^2 < 2^31).  The [M, H] hidden
// exists only as int8 in shared memory.
//
// What bounds it on an H100: operations (2 * 2*M*W*H against three [M, W]
// bf16 tensors and 2*W*H weight bytes).  The TPU kernel keeps both weight
// matrices whole in on-chip memory; a Hopper block has 227 KB, so here a
// block owns 32 rows and keeps what is private to them on chip -- xq
// (32 x W) and the whole quantised hidden (32 x H: 128 KB at H = 4096) --
// and streams w1, then w2, from L2 (8 MB at W = 1024: resident in the 50 MB
// L2) straight into mma.sync B fragments as 16-byte vectors.  Each of 16
// warps owns 32 output columns at a time and all 32 rows, so no weight byte
// is read twice by a block and nothing is shared between warps but the two
// int8 row blocks.  As in K5, lane t of a quad takes 16 consecutive bytes of
// a 64-byte k step for both operands.  The price of the row block of 32 is
// that every block reads all weights: M/32 * 2*W*H bytes of L2 traffic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uniir::mma_s8_16832;
using uniir::pack_bf16x2;

constexpr int TM = 32;      // rows per block (two m16 tiles)
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 4;       // n8 tiles per warp step: 32 output columns

enum Act { QUICK_GELU = 0, GELU = 1, GELU_TANH = 2 };

__device__ __forceinline__ float activate(int act, float x) {
  if (act == QUICK_GELU) return x * (1.f / (1.f + expf(-(1.702f * x))));
  if (act == GELU) return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
  const float inner = 0.79788456080286535588f * (x + 0.044715f * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float quantise(float x) { return fminf(fmaxf(rintf(x), -127.f), 127.f); }

// Bytes per shared-memory row of an int8 [TM, k] operand: k plus the padding
// that makes the stride 4 mod 8 in 16-byte units, so the 16-byte loads of a
// quarter warp (rows g, g + 1; t = 0..3) fall on all 32 banks.
__host__ __device__ inline int row_stride(int k) { return k + ((12 - (k / 16) % 8) % 8) * 16; }

// acc[mt][nt] = a[TM, K] (shared memory, int8) . w[n_base + nt*8 .. +8, K]^T (global, int8)
__device__ __forceinline__ void rows_gemm(int (&acc)[2][NT][4], const unsigned char* a, int a_stride,
                                          const int8_t* __restrict__ w, int K, int n_base, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
  const int8_t* wrow = w + (size_t)(n_base + g) * K + 16 * t;
  const unsigned char* arow = a + g * a_stride + 16 * t;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 64) {
    // K % 32 == 0: in a last half step lanes t >= 2 are past K; zero weights
    // cancel whatever the padded activation row holds there
    const bool live = k0 + 16 * t < K;
    uint4 b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      b[nt] = live ? __ldg(reinterpret_cast<const uint4*>(wrow + (size_t)nt * 8 * K + k0)) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint4 lo = *reinterpret_cast<const uint4*>(arow + mt * 16 * a_stride + k0);
      const uint4 hi = *reinterpret_cast<const uint4*>(arow + (mt * 16 + 8) * a_stride + k0);
      const uint32_t a_first[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a_second[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_s8_16832(acc[mt][nt], a_first, b[nt].x, b[nt].y);
        mma_s8_16832(acc[mt][nt], a_second, b[nt].z, b[nt].w);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
int8_mlp_kernel(const bf16* __restrict__ h, const bf16* __restrict__ res, const int8_t* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1, const int8_t* __restrict__ w2,
                const float* __restrict__ s2, const float* __restrict__ b2, bf16* __restrict__ out, int M, int W,
                int H, float inv_a1, float inv_a2, float a2, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = row_stride(W), hs = row_stride(H);
  unsigned char* xq = smem;            // [TM][xs] int8
  unsigned char* hq = smem + TM * xs;  // [TM][hs] int8
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // phase 0: quantise this block's rows of h; rows past M are zeros
  const int vecs = W / 8;
  for (int idx = tid; idx < TM * vecs; idx += THREADS) {
    const int r = idx / vecs, c = idx % vecs;
    uint2 q = make_uint2(0, 0);
    if (m0 + r < M) {
      const uint4 v = *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * W + c * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      unsigned char bytes[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        bytes[i] = (unsigned char)(signed char)(int)quantise(__fmul_rn(__bfloat162float(e[i]), inv_a1));
      q = *reinterpret_cast<const uint2*>(bytes);
    }
    *reinterpret_cast<uint2*>(xq + r * xs + c * 8) = q;
  }
  __syncthreads();

  int acc[2][NT][4];
  // phase 1: the quantised hidden, 32 columns of it per warp step
  for (int n0 = warp * NT * 8; n0 < H; n0 += WARPS * NT * 8) {
    rows_gemm(acc, xq, xs, w1, W, n0, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      const float sc0 = s1[col], sc1 = s1[col + 1], bi0 = b1[col], bi1 = b1[col + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float f0 = __fadd_rn(__fmul_rn((float)acc[mt][nt][half * 2], sc0), bi0);
          const float f1 = __fadd_rn(__fmul_rn((float)acc[mt][nt][half * 2 + 1], sc1), bi1);
          const int q0 = (int)quantise(__fmul_rn(activate(act, f0), inv_a2));
          const int q1 = (int)quantise(__fmul_rn(activate(act, f1), inv_a2));
          const unsigned short two = (unsigned short)((q0 & 0xff) | ((q1 & 0xff) << 8));
          *reinterpret_cast<unsigned short*>(hq + (mt * 16 + g + half * 8) * hs + col) = two;
        }
    }
  }
  __syncthreads();

  // phase 2: fc2, dequantise, add the residual, write bf16
  for (int n0 = warp * NT * 8; n0 < W; n0 += WARPS * NT * 8) {
    rows_gemm(acc, hq, hs, w2, H, n0, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      const float sc0 = __fmul_rn(a2, s2[col]), sc1 = __fmul_rn(a2, s2[col + 1]);
      const float bi0 = b2[col], bi1 = b2[col + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + mt * 16 + g + half * 8;
          if (row < M) {
            const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * W + col);
            const float y0 = __fadd_rn(__fmul_rn((float)acc[mt][nt][half * 2], sc0), bi0);
            const float y1 = __fadd_rn(__fmul_rn((float)acc[mt][nt][half * 2 + 1], sc1), bi1);
            *reinterpret_cast<uint32_t*>(out + (size_t)row * W + col) =
                pack_bf16x2(__fadd_rn(y0, __low2float(r2)), __fadd_rn(y1, __high2float(r2)));
          }
        }
    }
  }
}

}  // namespace

extern "C" {

// h, res, out [M, W] bf16; w1 [H, W], w2 [W, H] int8; s1 (= a1 * w1_scale),
// b1 [H] fp32; s2 (= w2_scale), b2 [W] fp32; all contiguous and 16-byte
// aligned; W % 32 == 0, H % 32 == 0; act 0 quick_gelu, 1 gelu, 2 gelu_tanh.
int uniir_int8_mlp(const void* h, const void* res, const void* w1, const void* s1, const void* b1, const void* w2,
                   const void* s2, const void* b2, void* out, int M, int W, int H, float inv_a1, float inv_a2,
                   float a2, int act, void* stream) {
  const int smem = TM * (row_stride(W) + row_stride(H));
  cudaError_t err = cudaFuncSetAttribute(int8_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int8_mlp_kernel<<<(M + TM - 1) / TM, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(res), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<bf16*>(out), M, W, H, inv_a1,
      inv_a2, a2, act);
  return (int)cudaGetLastError();
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
