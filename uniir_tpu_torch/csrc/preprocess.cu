// K7: fused image preprocessing, uint8 NHWC in, normalised NHWC out.
//
// Replaces uniir_tpu/ops/image_ops.py::pallas_fused_preprocess (its `kernel`
// body): per image b and channel c
//   out[b, :, :, c] = ((A_h @ (img[b, :, :, c] * (1/255))) @ A_w^T - mean_c) * (1/std_c)
// with the [O, H] and [O, W] resize matrices of `resize_matrix` (bilinear or
// bicubic, PIL window semantics), every product and sum in fp32 (plain FMAs
// on the CUDA cores; TF32 would miss the 1e-4 tolerance), the result cast to
// fp32 or bf16 on the store.  The kernel reads the uint8 NHWC batch as it
// comes from the host and writes NHWC: the TPU version's planar transposes
// before and after its kernel have no purpose here, and no torch pass runs
// around the launch.
//
// What bounds it on an H100: multiplied densely, as the Pallas body does,
// a batch of 64 at 256 -> 224 is 10.6 GFLOP of fp32 against 51 MB moved, so
// the bound is the fp32 rate of the CUDA cores, not memory.  (The matrices
// are banded, 3-6 taps a row; using that is later work.)
//
// Design.  Neither the fp32 plane (256 KB) nor the [O, W] intermediate
// (224 KB) fits a block's 227 KB, so a block owns one (strip of R = 32
// output rows, channel, image):
//   * the uint8 plane of its channel (64 KB at 256 x 256) and its strip of
//     A_h^T ([H, R] fp32) sit in shared memory;
//   * step 1 forms the strip T = A_h[r0:r0+R] @ plane of the intermediate,
//     [W, R] fp32 in shared memory (never in device memory): a thread owns
//     one column w and 16 of the 32 rows in registers, converts each pixel
//     once per h and reads its A_h taps as broadcast float4s;
//   * step 2 streams A_w^T ([W, O], 224 KB, resident in L2 for every block)
//     by coalesced loads: a thread owns one output column p and 16 rows,
//     reads T as broadcast float4s, and applies (x - mean_c) * inv_std_c on
//     the store.
// Sums run over h (then w) in ascending order, one fp32 FMA a term.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int R = 32;       // output rows per block
constexpr int RH = R / 2;   // rows a thread accumulates
constexpr int TS = R + 4;   // row stride of T in floats: conflict-free float4 stores, 16-byte aligned

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float x);
template <>
__device__ __forceinline__ float cast_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// byte k (0..11) of three little-endian words
__device__ __forceinline__ uint32_t byte_of(uint32_t w0, uint32_t w1, uint32_t w2, int k) {
  const uint32_t w = k < 4 ? w0 : (k < 8 ? w1 : w2);
  return (w >> ((k & 3) * 8)) & 0xffu;
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const uint8_t* __restrict__ img, const float* __restrict__ ahT, const float* __restrict__ awT,
                  OutT* __restrict__ out, int H, int W, int O, float inv255, float3 mean, float3 inv_std) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* AhT = reinterpret_cast<float*>(smem);          // [H][R]: A_h[r0 + r][h] at h * R + r
  float* Ts = AhT + (size_t)H * R;                      // [W][TS]: T[r][w] at w * TS + r
  uint8_t* plane = reinterpret_cast<uint8_t*>(Ts + (size_t)W * TS);  // [H][W], this block's channel
  const int r0 = blockIdx.x * R, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  // this strip of A_h^T; rows past O are zero
  for (int idx = tid; idx < H * R; idx += THREADS) {
    const int h = idx / R, r = idx % R;
    AhT[idx] = (r0 + r < O) ? ahT[(size_t)h * O + r0 + r] : 0.f;
  }
  // channel c of image b, as bytes
  const int n = H * W;
  const uint8_t* src = img + (size_t)b * n * 3;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    // four pixels (12 bytes) a step: three word loads, one word stored
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* p32 = reinterpret_cast<uint32_t*>(plane);
    for (int i = tid; i < n / 4; i += THREADS) {
      const uint32_t w0 = s32[3 * i], w1 = s32[3 * i + 1], w2 = s32[3 * i + 2];
      p32[i] = byte_of(w0, w1, w2, c) | (byte_of(w0, w1, w2, 3 + c) << 8) | (byte_of(w0, w1, w2, 6 + c) << 16) |
               (byte_of(w0, w1, w2, 9 + c) << 24);
    }
  } else {
    for (int i = tid; i < n; i += THREADS) plane[i] = src[(size_t)i * 3 + c];
  }
  __syncthreads();

  // step 1: T[r][w] = sum_h A_h[r0 + r][h] * (img[h][w] * (1/255))
  for (int idx = tid; idx < 2 * W; idx += THREADS) {
    const int half = idx / W, w = idx - half * W;
    float acc[RH];
#pragma unroll
    for (int j = 0; j < RH; ++j) acc[j] = 0.f;
    const float* a = AhT + half * RH;
    for (int h = 0; h < H; ++h) {
      const float x = __fmul_rn((float)plane[h * W + w], inv255);
      const float4* a4 = reinterpret_cast<const float4*>(a + h * R);
#pragma unroll
      for (int i = 0; i < RH / 4; ++i) {
        const float4 v = a4[i];
        acc[4 * i + 0] = fmaf(v.x, x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(v.y, x, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(v.z, x, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(v.w, x, acc[4 * i + 3]);
      }
    }
    float4* t4 = reinterpret_cast<float4*>(Ts + (size_t)w * TS + half * RH);
#pragma unroll
    for (int i = 0; i < RH / 4; ++i) t4[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();

  // step 2: out[r][p] = (sum_w T[r][w] * A_w[p][w] - mean_c) * inv_std_c
  const float m = c == 0 ? mean.x : (c == 1 ? mean.y : mean.z);
  const float s = c == 0 ? inv_std.x : (c == 1 ? inv_std.y : inv_std.z);
  for (int idx = tid; idx < 2 * O; idx += THREADS) {
    const int half = idx / O, p = idx - half * O;
    float acc[RH];
#pragma unroll
    for (int j = 0; j < RH; ++j) acc[j] = 0.f;
    const float* tcol = Ts + half * RH;
    for (int w = 0; w < W; ++w) {
      const float a = __ldg(awT + (size_t)w * O + p);
      const float4* t4 = reinterpret_cast<const float4*>(tcol + (size_t)w * TS);
#pragma unroll
      for (int i = 0; i < RH / 4; ++i) {
        const float4 v = t4[i];
        acc[4 * i + 0] = fmaf(v.x, a, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(v.y, a, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(v.z, a, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(v.w, a, acc[4 * i + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      const int r = r0 + half * RH + j;
      if (r < O) out[(((size_t)b * O + r) * O + p) * 3 + c] = cast_out<OutT>(__fmul_rn(__fsub_rn(acc[j], m), s));
    }
  }
}

template <typename OutT>
int launch(const void* img, const void* ahT, const void* awT, void* out, int B, int H, int W, int O, float inv255,
           float3 mean, float3 inv_std, void* stream) {
  const int smem = (H * R + W * TS) * (int)sizeof(float) + H * W;
  cudaError_t err = cudaFuncSetAttribute(preprocess_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((O + R - 1) / R, 3, B);
  preprocess_kernel<OutT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const float*>(ahT), static_cast<const float*>(awT),
      static_cast<OutT*>(out), H, W, O, inv255, mean, inv_std);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: contiguous uint8 [B, H, W, 3]; ahT: fp32 [H, O] (A_h transposed); awT:
// fp32 [W, O]; out: contiguous [B, O, O, 3], bf16 if out_bf16 else fp32.
// Launches on `stream`; returns the CUDA error code of the launch.  The
// wrapper in ops/image_ops.py computes the same shared-memory size.
int uniir_fused_preprocess(const void* img, const void* ahT, const void* awT, void* out, int B, int H, int W, int O,
                           int out_bf16, float inv255, float m0, float m1, float m2, float s0, float s1, float s2,
                           void* stream) {
  const float3 mean = make_float3(m0, m1, m2), inv_std = make_float3(s0, s1, s2);
  if (out_bf16) return launch<__nv_bfloat16>(img, ahT, awT, out, B, H, W, O, inv255, mean, inv_std, stream);
  return launch<float>(img, ahT, awT, out, B, H, W, O, inv255, mean, inv_std, stream);
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
