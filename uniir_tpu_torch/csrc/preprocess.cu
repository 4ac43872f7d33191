// K7: fused image preprocessing, uint8 NHWC in, normalised NHWC out.
//
// Replaces uniir_tpu/ops/image_ops.py::pallas_fused_preprocess (its `kernel`
// body): per image b and channel c
//   out[b, :, :, c] = ((A_h @ (img[b, :, :, c] * (1/255))) @ A_w^T - mean_c) * (1/std_c)
// with the [O, H] and [O, W] resize matrices of `resize_matrix` (bilinear or
// bicubic, PIL window semantics), every product and sum in fp32 (plain FMAs
// on the CUDA cores; TF32 would miss the 1e-4 tolerance), the result cast to
// fp32 or bf16 on the store.  The kernels read the uint8 NHWC batch as it
// comes from the host and write NHWC: the TPU version's planar transposes
// before and after its kernel have no purpose here, and no torch pass runs
// around the launch.
//
// What bounds it on an H100: bytes.  The resize matrices are banded: 256 ->
// 224 has 3-5 non-zero taps a row in bicubic (1018 of 57344 entries), 2-3 in
// bilinear.  A batch of 64 at 256 -> 224 moves 12.6 MB of uint8 and writes
// 19.3 MB of bf16 (9.6 us at 3.35 TB/s); its taps are 0.19 GFLOP of fp32
// (2.8 us at 67 TFLOP/s).  Multiplied densely, as the Pallas body does on the
// TPU's matrix unit, the same batch is 10.6 GFLOP.
//
// Two kernels, one chosen by ops/image_ops.py::preprocess_route:
//   * preprocess_band_kernel ("band"): only the taps.  The wrapper hands it
//     each matrix as a band: the first source index of each output row and a
//     fixed-width row of TAPS weights from that index on, copied from the
//     matrix (expanding the band gives the matrix back bit for bit); the
//     first indices never decrease, so a strip's source rows run from its
//     first row's window start to its last row's window end.  A block
//     owns one (strip of R = 4 output rows, image), all three channels:
//       - it loads the strip's source rows (about R * H / O + TAPS_h rows,
//         contiguous NHWC bytes) once with 16-byte loads into shared memory,
//         as bytes;
//       - the vertical pass treats a row as W * 3 independent columns (no
//         channel de-interleave): a thread takes a word of four columns, turns
//         each byte into px * (1/255) as it reads it (2^23 + px - 2^23 is px
//         exactly, then one rounded multiply) and makes TAPS_h FMAs a value
//         into a [R, W * 3] fp32 intermediate in shared memory;
//       - the horizontal pass gives each thread one output pixel p (its three
//         channels) of the strip's rows: TAPS_w FMAs a value over columns
//         (first_w[p] + j) * 3 + c, then (x - mean_c) * inv_std_c, staged in
//         shared memory (over the source bytes) as the strip's NHWC rows;
//       - the strip's output rows are one contiguous range of the output,
//         written as 16-byte vectors.
//     22.5 KB of shared memory and 128 threads a block at 256 -> 224: eight
//     blocks an SM.  On an H100 the kernel is bound by latency between its
//     phases rather than by bytes: fp32 source rows (3 blocks an SM), strips
//     of 8 rows of 256 threads, and a persistent block that loads the next
//     strip under the current one's passes were all slower.
//   * preprocess_dense_kernel ("dense", the general route where the band's
//     strip does not fit, e.g. a strong downscale): the whole products, a
//     block per (strip of 32 output rows, channel, image); the uint8 plane of
//     its channel and the strip of A_h^T sit in shared memory, the [W, 32]
//     strip of the intermediate too, and A_w^T streams from L2.
// The rounding points are the same in both, so the two are bit-equal:
// __fmul_rn(px, 1/255), the vertical sum over h in ascending order, then the
// horizontal sum over w in ascending order, one fmaf a term, then
// __fmul_rn(__fsub_rn(acc, mean), inv_std).  A zero tap that the band skips
// adds +0 or -0 to a sum: it can change only the sign of a zero sum, which
// the subtraction of the mean erases.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float x);
template <>
__device__ __forceinline__ float cast_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float channel_of(float3 v, int c) { return c == 0 ? v.x : (c == 1 ? v.y : v.z); }

// ------------------------------------------------------------ the band kernel

constexpr int BAND_THREADS = 128;
constexpr int BAND_BLOCKS = 8;  // blocks an SM: 64 registers a thread, 23 KB of shared memory a block at 256 -> 224
constexpr int BAND_R = 4;       // output rows a block (ops/image_ops.py: BAND_ROWS)
constexpr int BAND_RG = 4;      // output rows a thread's item holds in registers
constexpr int BAND_U = 4;       // 16-byte loads a thread keeps in flight

// Shared memory of a launch, on the host and the device alike: the strip's source rows as bytes [rows_in, CS]
// (CS = W * 3 rounded up to 4 bytes) or, once the vertical pass is done, its staged output rows [R, O * 3],
// whichever is larger, then the intermediate T [R, CS] fp32; each region a multiple of 16 bytes.
// ops/image_ops.py::band_smem_bytes computes the same for fp32 output.
__host__ __device__ inline int band_cs(int W) { return (W * 3 + 3) & ~3; }
template <typename OutT>
__host__ __device__ inline int band_strip_bytes(int W, int O, int rows_in) {
  const int src = rows_in * band_cs(W), staged = BAND_R * O * 3 * (int)sizeof(OutT);
  return ((src > staged ? src : staged) + 15) & ~15;
}
template <typename OutT>
__host__ __device__ inline int band_smem_bytes(int W, int O, int rows_in) {
  return band_strip_bytes<OutT>(W, O, rows_in) + BAND_R * band_cs(W) * 4;
}

// byte k of a word as px * (1/255): the byte as an exact fp32 (2^23 + px - 2^23), then one rounded multiply
__device__ __forceinline__ float px_of(uint32_t word, int k, float inv255) {
  return __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | ((word >> (8 * k)) & 0xffu)), 8388608.f), inv255);
}

// img: [B, H, W, 3] uint8.  first_h [O] / w_h [O, taps_h]: A_h's band (A_h[r][first_h[r] + j] = w_h[r][j],
// first_h[r] + taps_h <= H, first_h non-decreasing); first_w / w_w: A_w's.  rows_in: the most source rows a
// strip reads.
template <typename OutT>
__global__ void __launch_bounds__(BAND_THREADS, BAND_BLOCKS)
preprocess_band_kernel(const uint8_t* __restrict__ img, const int* __restrict__ first_h,
                       const float* __restrict__ w_h, const int* __restrict__ first_w,
                       const float* __restrict__ w_w, OutT* __restrict__ out, int H, int W, int O, int taps_h,
                       int taps_w, int rows_in, float inv255, float3 mean, float3 inv_std) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = W * 3, CS = band_cs(W), CS4 = CS / 4;
  unsigned char* X = smem;  // [rows, CS] source bytes; later the staged output
  float* T = reinterpret_cast<float*>(smem + band_strip_bytes<OutT>(W, O, rows_in));  // [R, CS]
  const int r0 = blockIdx.x * BAND_R, b = blockIdx.y, tid = threadIdx.x;
  const int nr = min(BAND_R, O - r0);
  const int lo = first_h[r0], n_in = first_h[r0 + nr - 1] + taps_h - lo;

  // 1. the strip's source rows: one contiguous range of n_in * C bytes, 16 bytes a load where rows allow
  const uint8_t* src = img + ((size_t)b * H + lo) * C;
  if ((C & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // CS == C here, so byte k of the range is X[k]
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    const int n16 = n_in * C / 16;
    for (int i0 = tid; i0 < n16; i0 += BAND_THREADS * BAND_U) {
      uint4 v[BAND_U];
#pragma unroll
      for (int u = 0; u < BAND_U; ++u)
        if (i0 + u * BAND_THREADS < n16) v[u] = __ldg(s16 + i0 + u * BAND_THREADS);
#pragma unroll
      for (int u = 0; u < BAND_U; ++u)
        if (i0 + u * BAND_THREADS < n16) reinterpret_cast<uint4*>(X)[i0 + u * BAND_THREADS] = v[u];
    }
  } else {
    for (int k = tid; k < n_in * CS; k += BAND_THREADS) {
      const int row = k / CS, col = k - row * CS;
      X[k] = col < C ? src[(size_t)row * C + col] : 0;
    }
  }
  __syncthreads();

  // 2. vertical: T[r][col] = sum_j w_h[r0 + r][j] * (X[first_h[r0 + r] - lo + j][col] * (1/255)), j ascending;
  // a thread takes four columns (one word of bytes) of BAND_RG rows
  float4* T4 = reinterpret_cast<float4*>(T);
  for (int item = tid; item < (BAND_R / BAND_RG) * CS4; item += BAND_THREADS) {
    const int g = item / CS4, q = item - g * CS4;
#pragma unroll
    for (int rr = 0; rr < BAND_RG; ++rr) {
      const int r = g * BAND_RG + rr;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        const float* wr = w_h + (size_t)(r0 + r) * taps_h;
        const uint32_t* x = reinterpret_cast<const uint32_t*>(X) + (size_t)(first_h[r0 + r] - lo) * CS4 + q;
        for (int j = 0; j < taps_h; ++j) {
          const float a = __ldg(wr + j);
          const uint32_t u = x[(size_t)j * CS4];
          acc.x = fmaf(a, px_of(u, 0, inv255), acc.x);
          acc.y = fmaf(a, px_of(u, 1, inv255), acc.y);
          acc.z = fmaf(a, px_of(u, 2, inv255), acc.z);
          acc.w = fmaf(a, px_of(u, 3, inv255), acc.w);
        }
      }
      T4[(size_t)r * CS4 + q] = acc;
    }
  }
  __syncthreads();

  // 3. horizontal: out[r][p][c] = (sum_j w_w[p][j] * T[r][(first_w[p] + j) * 3 + c] - mean_c) * inv_std_c,
  // j ascending, staged as the strip's NHWC rows over the source bytes (no longer read)
  OutT* stage = reinterpret_cast<OutT*>(X);
  for (int item = tid; item < (BAND_R / BAND_RG) * O; item += BAND_THREADS) {
    const int g = item / O, p = item - g * O;
    float acc[BAND_RG][3];
#pragma unroll
    for (int rr = 0; rr < BAND_RG; ++rr) acc[rr][0] = acc[rr][1] = acc[rr][2] = 0.f;
    const float* wp = w_w + (size_t)p * taps_w;
    const float* t = T + (size_t)g * BAND_RG * CS + first_w[p] * 3;
    for (int j = 0; j < taps_w; ++j) {
      const float a = __ldg(wp + j);
#pragma unroll
      for (int rr = 0; rr < BAND_RG; ++rr)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[rr][c] = fmaf(t[(size_t)rr * CS + 3 * j + c], a, acc[rr][c]);
    }
#pragma unroll
    for (int rr = 0; rr < BAND_RG; ++rr) {
      const int r = g * BAND_RG + rr;
      if (r < nr)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          stage[((size_t)r * O + p) * 3 + c] =
              cast_out<OutT>(__fmul_rn(__fsub_rn(acc[rr][c], channel_of(mean, c)), channel_of(inv_std, c)));
    }
  }
  __syncthreads();

  // 4. the strip's rows are one contiguous range of the output
  OutT* dst = out + ((size_t)b * O + r0) * O * 3;
  const int n_out = nr * O * 3;
  if (((n_out * (int)sizeof(OutT)) & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* s16 = reinterpret_cast<const uint4*>(stage);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n_out * (int)sizeof(OutT) / 16; i += BAND_THREADS) d16[i] = s16[i];
  } else {
    for (int i = tid; i < n_out; i += BAND_THREADS) dst[i] = stage[i];
  }
}

// ----------------------------------------------------------- the dense kernel

constexpr int DENSE_THREADS = 512;
constexpr int DR = 32;       // output rows per block
constexpr int DRH = DR / 2;  // rows a thread accumulates
constexpr int DTS = DR + 4;  // row stride of T in floats: conflict-free float4 stores, 16-byte aligned

// byte k (0..11) of three little-endian words
__device__ __forceinline__ uint32_t byte_of(uint32_t w0, uint32_t w1, uint32_t w2, int k) {
  const uint32_t w = k < 4 ? w0 : (k < 8 ? w1 : w2);
  return (w >> ((k & 3) * 8)) & 0xffu;
}

template <typename OutT>
__global__ void __launch_bounds__(DENSE_THREADS)
preprocess_dense_kernel(const uint8_t* __restrict__ img, const float* __restrict__ ahT, const float* __restrict__ awT,
                        OutT* __restrict__ out, int H, int W, int O, float inv255, float3 mean, float3 inv_std) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* AhT = reinterpret_cast<float*>(smem);         // [H][DR]: A_h[r0 + r][h] at h * DR + r
  float* Ts = AhT + (size_t)H * DR;                      // [W][DTS]: T[r][w] at w * DTS + r
  uint8_t* plane = reinterpret_cast<uint8_t*>(Ts + (size_t)W * DTS);  // [H][W], this block's channel
  const int r0 = blockIdx.x * DR, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  // this strip of A_h^T; rows past O are zero
  for (int idx = tid; idx < H * DR; idx += DENSE_THREADS) {
    const int h = idx / DR, r = idx % DR;
    AhT[idx] = (r0 + r < O) ? ahT[(size_t)h * O + r0 + r] : 0.f;
  }
  // channel c of image b, as bytes
  const int n = H * W;
  const uint8_t* src = img + (size_t)b * n * 3;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    // four pixels (12 bytes) a step: three word loads, one word stored
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* p32 = reinterpret_cast<uint32_t*>(plane);
    for (int i = tid; i < n / 4; i += DENSE_THREADS) {
      const uint32_t w0 = s32[3 * i], w1 = s32[3 * i + 1], w2 = s32[3 * i + 2];
      p32[i] = byte_of(w0, w1, w2, c) | (byte_of(w0, w1, w2, 3 + c) << 8) | (byte_of(w0, w1, w2, 6 + c) << 16) |
               (byte_of(w0, w1, w2, 9 + c) << 24);
    }
  } else {
    for (int i = tid; i < n; i += DENSE_THREADS) plane[i] = src[(size_t)i * 3 + c];
  }
  __syncthreads();

  // step 1: T[r][w] = sum_h A_h[r0 + r][h] * (img[h][w] * (1/255))
  for (int idx = tid; idx < 2 * W; idx += DENSE_THREADS) {
    const int half = idx / W, w = idx - half * W;
    float acc[DRH];
#pragma unroll
    for (int j = 0; j < DRH; ++j) acc[j] = 0.f;
    const float* a = AhT + half * DRH;
    for (int h = 0; h < H; ++h) {
      const float x = __fmul_rn((float)plane[h * W + w], inv255);
      const float4* a4 = reinterpret_cast<const float4*>(a + h * DR);
#pragma unroll
      for (int i = 0; i < DRH / 4; ++i) {
        const float4 v = a4[i];
        acc[4 * i + 0] = fmaf(v.x, x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(v.y, x, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(v.z, x, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(v.w, x, acc[4 * i + 3]);
      }
    }
    float4* t4 = reinterpret_cast<float4*>(Ts + (size_t)w * DTS + half * DRH);
#pragma unroll
    for (int i = 0; i < DRH / 4; ++i) t4[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();

  // step 2: out[r][p] = (sum_w T[r][w] * A_w[p][w] - mean_c) * inv_std_c
  const float m = c == 0 ? mean.x : (c == 1 ? mean.y : mean.z);
  const float s = c == 0 ? inv_std.x : (c == 1 ? inv_std.y : inv_std.z);
  for (int idx = tid; idx < 2 * O; idx += DENSE_THREADS) {
    const int half = idx / O, p = idx - half * O;
    float acc[DRH];
#pragma unroll
    for (int j = 0; j < DRH; ++j) acc[j] = 0.f;
    const float* tcol = Ts + half * DRH;
    for (int w = 0; w < W; ++w) {
      const float a = __ldg(awT + (size_t)w * O + p);
      const float4* t4 = reinterpret_cast<const float4*>(tcol + (size_t)w * DTS);
#pragma unroll
      for (int i = 0; i < DRH / 4; ++i) {
        const float4 v = t4[i];
        acc[4 * i + 0] = fmaf(v.x, a, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(v.y, a, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(v.z, a, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(v.w, a, acc[4 * i + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < DRH; ++j) {
      const int r = r0 + half * DRH + j;
      if (r < O) out[(((size_t)b * O + r) * O + p) * 3 + c] = cast_out<OutT>(__fmul_rn(__fsub_rn(acc[j], m), s));
    }
  }
}

template <typename OutT>
int launch_band(const void* img, const void* first_h, const void* w_h, const void* first_w, const void* w_w,
                void* out, int B, int H, int W, int O, int taps_h, int taps_w, int rows_in, float inv255,
                float3 mean, float3 inv_std, void* stream) {
  const int smem = band_smem_bytes<OutT>(W, O, rows_in);
  cudaError_t err =
      cudaFuncSetAttribute(preprocess_band_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((O + BAND_R - 1) / BAND_R, B);
  preprocess_band_kernel<OutT><<<grid, BAND_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(first_h), static_cast<const float*>(w_h),
      static_cast<const int*>(first_w), static_cast<const float*>(w_w), static_cast<OutT*>(out), H, W, O, taps_h,
      taps_w, rows_in, inv255, mean, inv_std);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_dense(const void* img, const void* ahT, const void* awT, void* out, int B, int H, int W, int O,
                 float inv255, float3 mean, float3 inv_std, void* stream) {
  const int smem = (H * DR + W * DTS) * (int)sizeof(float) + H * W;
  cudaError_t err =
      cudaFuncSetAttribute(preprocess_dense_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((O + DR - 1) / DR, 3, B);
  preprocess_dense_kernel<OutT><<<grid, DENSE_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const float*>(ahT), static_cast<const float*>(awT),
      static_cast<OutT*>(out), H, W, O, inv255, mean, inv_std);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The band kernel.  img: contiguous uint8 [B, H, W, 3]; first_h: int32 [O], w_h: fp32 [O, taps_h] (A_h's
// band), first_w / w_w: A_w's; rows_in: the most source rows a strip of 4 output rows reads; out:
// contiguous [B, O, O, 3], bf16 if out_bf16 else fp32.  Launches on `stream`; returns the CUDA error code of
// the launch.  ops/image_ops.py computes the same shared-memory size.
int uniir_fused_preprocess(const void* img, const void* first_h, const void* w_h, const void* first_w,
                           const void* w_w, void* out, int B, int H, int W, int O, int taps_h, int taps_w,
                           int rows_in, int out_bf16, float inv255, float m0, float m1, float m2, float s0, float s1,
                           float s2, void* stream) {
  const float3 mean = make_float3(m0, m1, m2), inv_std = make_float3(s0, s1, s2);
  if (out_bf16)
    return launch_band<__nv_bfloat16>(img, first_h, w_h, first_w, w_w, out, B, H, W, O, taps_h, taps_w, rows_in,
                                      inv255, mean, inv_std, stream);
  return launch_band<float>(img, first_h, w_h, first_w, w_w, out, B, H, W, O, taps_h, taps_w, rows_in, inv255,
                            mean, inv_std, stream);
}

// The dense kernel.  ahT: fp32 [H, O] (A_h transposed); awT: fp32 [W, O]; the rest as above.
int uniir_fused_preprocess_dense(const void* img, const void* ahT, const void* awT, void* out, int B, int H, int W,
                                 int O, int out_bf16, float inv255, float m0, float m1, float m2, float s0, float s1,
                                 float s2, void* stream) {
  const float3 mean = make_float3(m0, m1, m2), inv_std = make_float3(s0, s1, s2);
  if (out_bf16) return launch_dense<__nv_bfloat16>(img, ahT, awT, out, B, H, W, O, inv255, mean, inv_std, stream);
  return launch_dense<float>(img, ahT, awT, out, B, H, W, O, inv255, mean, inv_std, stream);
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
