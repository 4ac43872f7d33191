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
// layout (K-contiguous, as wgmma reads both operands), H = 4W.  Every fp32
// step of the two epilogues is rounded on its own, as in the plain PyTorch
// twin; the integer sums are exact (4096 * 127^2 < 2^31).
//
// What bounds it on an H100: operations (2 * 2*M*W*H against three [M, W]
// bf16 tensors and 2*W*H weight bytes).  The TPU kernel keeps both weight
// matrices and a row block's whole hidden in on-chip memory.  On this card
// that forced 32-row blocks (the hidden of 32 rows is 128 KB at H = 4096),
// each of which read every weight byte from L2: M/32 * 2*W*H bytes, L2's
// rate.  So the hidden leaves the chip, but only as int8: three launches on
// one stream,
//   1. quantise_rows_kernel: xq = quant_a1(h), 16-byte vectors (wgmma reads
//      int8 operands from shared memory, and TMA copies bytes unchanged);
//   2. int8_gemm.cuh's main loop over xq, w1 with ActQuantI8: the int8 hidden;
//   3. the same main loop over hq, w2 with DequantResBf16: the output.
// xq and hq are each written once and read once: 2 * M * (W + H) bytes more
// than on chip (168 MB at M = 16448, W = 1024: ~0.05 ms at 3.35 TB/s), after
// which both products run at full tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "int8_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uniir::pack_bf16x2;

enum Act { QUICK_GELU = 0, GELU = 1, GELU_TANH = 2 };

__device__ __forceinline__ float activate(int act, float x) {
  if (act == QUICK_GELU) return x * (1.f / (1.f + expf(-(1.702f * x))));
  if (act == GELU) return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
  const float inner = 0.79788456080286535588f * (x + 0.044715f * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float quantise(float x) { return fminf(fmaxf(rintf(x), -127.f), 127.f); }

// xq = clip(round(float(h) * inv_a1)), 8 values a thread
__global__ void quantise_rows_kernel(const bf16* __restrict__ h, int8_t* __restrict__ xq, long long vecs,
                                     float inv_a1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= vecs) return;
  const uint4 v = reinterpret_cast<const uint4*>(h)[i];
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t byte = (uint32_t)(int)quantise(__fmul_rn(__bfloat162float(e[k]), inv_a1)) & 0xffu;
    word[k / 4] |= byte << (8 * (k % 4));
  }
  reinterpret_cast<uint2*>(xq)[i] = make_uint2(word[0], word[1]);
}

// fc1: f = acc * s1[n] + b1[n], then the int8 hidden clip(round(act(f) * inv_a2))
struct ActQuantI8 {
  struct Params {
    const float* s1;  // [H] = a1 * w1_scale
    const float* b1;  // [H]
    float inv_a2;
    int act;
    void* out;  // int8 [M, H]
  };
  using Out = uint16_t;
  struct Row {};
  struct Column {
    float s0, s1, b0, b1;
  };
  __device__ static Row row(const Params&, int, int) { return {}; }
  __device__ static Column column(const Params& p, int col) {
    return {p.s1[col], p.s1[col + 1], p.b1[col], p.b1[col + 1]};
  }
  __device__ static Out pair(const Params& p, const Row&, const Column& c, int acc0, int acc1) {
    const float f0 = __fadd_rn(__fmul_rn((float)acc0, c.s0), c.b0);
    const float f1 = __fadd_rn(__fmul_rn((float)acc1, c.s1), c.b1);
    const int q0 = (int)quantise(__fmul_rn(activate(p.act, f0), p.inv_a2));
    const int q1 = (int)quantise(__fmul_rn(activate(p.act, f1), p.inv_a2));
    return (Out)((q0 & 0xff) | ((q1 & 0xff) << 8));
  }
};

// fc2: bf16((acc * (a2 * w2_scale[n]) + b2[n]) + res[m, n])
struct DequantResBf16 {
  struct Params {
    float a2;
    const float* s2;  // [W] = w2_scale
    const float* b2;  // [W]
    const bf16* res;  // [M, W]
    int width;
    void* out;  // bf16 [M, W]
  };
  using Out = uint32_t;
  struct Row {
    const bf16* res;  // the row's residual, or null past M
  };
  struct Column {
    float s0, s1, b0, b1;
    int col;
  };
  __device__ static Row row(const Params& p, int r, int M) {
    return {r < M ? p.res + (size_t)r * p.width : nullptr};
  }
  __device__ static Column column(const Params& p, int col) {
    return {__fmul_rn(p.a2, p.s2[col]), __fmul_rn(p.a2, p.s2[col + 1]), p.b2[col], p.b2[col + 1], col};
  }
  __device__ static Out pair(const Params&, const Row& r, const Column& c, int acc0, int acc1) {
    if (r.res == nullptr) return 0;
    const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(r.res + c.col);
    const float y0 = __fadd_rn(__fmul_rn((float)acc0, c.s0), c.b0);
    const float y1 = __fadd_rn(__fmul_rn((float)acc1, c.s1), c.b1);
    return pack_bf16x2(__fadd_rn(y0, __low2float(r2)), __fadd_rn(y1, __high2float(r2)));
  }
};

}  // namespace

extern "C" {

// h, res, out [M, W] bf16; w1 [H, W], w2 [W, H] int8; s1 (= a1 * w1_scale),
// b1 [H] fp32; s2 (= w2_scale), b2 [W] fp32; scratch xq [M, W] and hq [M, H]
// int8; all contiguous and 16-byte aligned; W % 32 == 0, H % 32 == 0; act 0
// quick_gelu, 1 gelu, 2 gelu_tanh.
int uniir_int8_mlp(const void* h, const void* res, const void* w1, const void* s1, const void* b1, const void* w2,
                   const void* s2, const void* b2, void* xq, void* hq, void* out, int M, int W, int H, float inv_a1,
                   float inv_a2, float a2, int act, void* stream) {
  if (M == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long vecs = (long long)M * W / 8;
  quantise_rows_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, s>>>(static_cast<const bf16*>(h),
                                                                     static_cast<int8_t*>(xq), vecs, inv_a1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ActQuantI8::Params fc1{static_cast<const float*>(s1), static_cast<const float*>(b1), inv_a2, act, hq};
  err = uniir::launch_int8_gemm<ActQuantI8>(xq, w1, M, H, W, fc1, 0, s);
  if (err != cudaSuccess) return (int)err;
  const DequantResBf16::Params fc2{a2, static_cast<const float*>(s2), static_cast<const float*>(b2),
                                   static_cast<const bf16*>(res), W, out};
  return (int)uniir::launch_int8_gemm<DequantResBf16>(hq, w2, M, W, H, fc2, 0, s);
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
