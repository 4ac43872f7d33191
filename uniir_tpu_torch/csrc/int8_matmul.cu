// K5: int8 x int8 -> int32 matrix product with a fused dequantising epilogue.
//
// Replaces uniir_tpu/ops/quant_pallas.py::fused_int8_matmul (_int8_matmul_2d,
// _kernel): the quantised Dense layer of int8 serving,
//
//   out[m, n] = bf16( dequant( sum_k xq[m, k] * wq[n, k] ) + bias[n] )
//
// with xq [M, K] int8 activations, wq [N, K] int8 weights (the state-dict
// layout: both operands K-contiguous, the K-major pair wgmma reads from
// shared memory) and fp32 scales.  Two epilogues, each step rounded on its
// own (no fused multiply-add), so the plain PyTorch twin reproduces them bit
// for bit:
//   per-row scales (dynamic mode):  (float(acc) * a[m]) * w[n] + b[n]
//   one static scale:               float(acc) * (a * w[n]) + b[n]
// Activation quantisation stays outside the kernel, as in the TPU design.
// The int32 accumulator never reaches device memory.
//
// What bounds it on an H100: operations (670-890 a byte at the CLIP-L
// shapes, above the int8 ridge).  The product is int8_gemm.cuh's main loop:
// TMA into a 128-byte-swizzled ring fed by one producer thread, two consumer
// warpgroups on wgmma m64n{256,128}k32 s8, the bf16 tile staged in the ring
// and written as 16-byte vectors.  Any M, K % 32 == 0, N % 8 == 0; a column
// range of the weight starts lo * K bytes in (16-byte aligned).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "int8_gemm.cuh"

namespace {

using uniir::pack_bf16x2;

struct DequantBf16 {
  struct Params {
    const float* a_rows;  // [M] per-row scales, or null: then a_static is the one scale
    float a_static;
    const float* w_scale;  // [N]
    const float* bias;     // [N] or null
    void* out;             // bf16 [M, N]
  };
  using Out = uint32_t;
  struct Row {
    float a;
  };
  struct Column {
    float s0, s1, b0, b1;  // the scale each column's sum is multiplied by last; the bias
  };
  __device__ static Row row(const Params& p, int r, int M) {
    return {p.a_rows ? (r < M ? p.a_rows[r] : 0.f) : p.a_static};
  }
  __device__ static Column column(const Params& p, int col) {
    const float w0 = p.w_scale[col], w1 = p.w_scale[col + 1];
    const bool per_row = p.a_rows != nullptr;
    return {per_row ? w0 : __fmul_rn(p.a_static, w0), per_row ? w1 : __fmul_rn(p.a_static, w1),
            p.bias ? p.bias[col] : 0.f, p.bias ? p.bias[col + 1] : 0.f};
  }
  __device__ static Out pair(const Params& p, const Row& r, const Column& c, int acc0, int acc1) {
    float y0 = (float)acc0, y1 = (float)acc1;
    if (p.a_rows) {
      y0 = __fmul_rn(y0, r.a);
      y1 = __fmul_rn(y1, r.a);
    }
    y0 = __fmul_rn(y0, c.s0);
    y1 = __fmul_rn(y1, c.s1);
    if (p.bias) {
      y0 = __fadd_rn(y0, c.b0);
      y1 = __fadd_rn(y1, c.b1);
    }
    return pack_bf16x2(y0, y1);
  }
};

}  // namespace

extern "C" {

// x [M, K] int8, w [N, K] int8 (both contiguous, 16-byte aligned, K % 32 == 0),
// a_rows [M] fp32 per-row scales or null (then a_static is the one scale),
// w_scale [N] fp32, bias [N] fp32 or null, out [M, N] bf16 (N % 8 == 0);
// tile a uniir::GemmTile: 0 for the rule by shape.
int uniir_int8_matmul(const void* x, const void* w, const void* a_rows, float a_static, const void* w_scale,
                      const void* bias, void* out, int M, int N, int K, int tile, void* stream) {
  const DequantBf16::Params p{static_cast<const float*>(a_rows), a_static, static_cast<const float*>(w_scale),
                              static_cast<const float*>(bias), out};
  return (int)uniir::launch_int8_gemm<DequantBf16>(x, w, M, N, K, p, tile, (cudaStream_t)stream);
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
