// K1, K8, K9: fused attention forward over model-native [B, L, H*D] bf16 tensors.
//
// K1 replaces uniir_tpu/ops/attention_pallas.py::mha_paired_stack
// (_paired_stack_kernel), reached from uniir_tpu/models/layers.py:208-216 on
// every block but the pooled last one of the CLIP towers and of the BLIP ViT.
// K8 and K9 replace mha_nocausal (_attn_kernel, over [B, L, H, D], which is
// the same memory) and mha_paired (_paired_kernel) of the same file: the
// NORM_FIRST variant of the kernel below, described after K1.
//
// Computes, per (batch, head): out = softmax(q k^T * scale) v with
//   * q rounded to bf16 after the scale multiply (as the TPU kernel does),
//   * fp32 scores, fp32 row max and fp32 row sum,
//   * unnormalised probabilities rounded to bf16 for the PV product,
//     fp32 accumulation, then a multiply by 1/rowsum,
//   * keys >= l_valid, and future keys when causal, masked by SELECT (never
//     by multiplying with 0), V rows >= l_valid zeroed by select.
// Scores and probabilities never reach device memory.
//
// What bounds it on an H100: at CLIP shapes (L=257/77, D=64) the work is
// small matrix products plus an exp per score; the kernel is latency- and
// issue-bound, not HBM-bound (q, k, v, o are read or written once).  Design:
// one block per (query tile of 64 rows, head, batch); K and V^T for all of L
// sit in shared memory (~75 KB at L=257, above the 48 KB default, hence the
// dynamic shared-memory attribute), read [B, L, H*D] in place with no
// transpose in device memory.  Each warp owns 16 query rows, keeps its Q
// fragments in registers and runs mma.sync m16n8k16 (bf16 in, fp32 out).
// Softmax is two-pass over the keys (pass 1: row max; pass 2: recompute the
// scores, exp, row sum and PV), which reproduces the reference kernel's
// rounding points exactly at the price of 1.5x the QK^T work.  A faster
// wgmma/TMA version is later work.
//
// NORM_FIRST (K8 / K9) keeps the other two Pallas kernels' rounding points:
//   * q is NOT pre-scaled: s = fp32(q k^T) * scale, in fp32 after the product,
//   * masked keys -> -1e30, fp32 row max, e = exp(s - max), fp32 row sum,
//   * p = bf16(e / rowsum): normalised BEFORE the PV product,
//   * o = fp32-accumulated p v, cast to bf16 with no further multiply.
// The row sum must be known before the first p is formed, so this variant
// walks the keys three times (max; sum; p v): 2x the QK^T work.  Same tiles,
// same shared-memory layout, same launch geometry as K1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uniir::mma_bf16_16816;
using uniir::pack_bf16x2;

constexpr int D = 64;          // head dim (the wrapper checks)
constexpr int WARPS = 4;
constexpr int QT = 16 * WARPS;  // query rows per block
constexpr int KS = D + 8;       // K row stride in shared memory (conflict-free B loads)
constexpr float NEG = -1e30f;   // the reference kernel's mask value

template <bool NORM_FIRST>
__global__ void __launch_bounds__(WARPS * 32)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ o, int L, int H, int l_valid, int causal, float scale, int l_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [l_pad][KS]
  bf16* Vt = Ks + l_pad * KS;                // [D][VS], V transposed
  const int VS = l_pad + 8;
  const int W = H * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * L * W + (size_t)h * D;

  // K rows and V^T for every key of this (batch, head).  Rows >= L are zero;
  // V rows >= l_valid are zeroed by select so padding can never reach PV.
  for (int idx = threadIdx.x; idx < l_pad * (D / 8); idx += blockDim.x) {
    const int row = idx / (D / 8), c = idx % (D / 8);
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (row < L) {
      kv = *reinterpret_cast<const uint4*>(k + base + (size_t)row * W + c * 8);
      if (row < l_valid) vv = *reinterpret_cast<const uint4*>(v + base + (size_t)row * W + c * 8);
    }
    *reinterpret_cast<uint4*>(Ks + row * KS + c * 8) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * VS + row] = ve[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QT + warp * 16;
  if (q0 >= L) return;  // no block-wide barrier follows
  const int row_lo = q0 + g, row_hi = q0 + g + 8;

  // Q fragments: K1 scales and rounds to bf16 (q * bf16(scale) in the
  // reference); NORM_FIRST takes q as it is and scales the fp32 scores.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? row_hi : row_lo;
      const int col = ks * 16 + 2 * t + ((r & 2) ? 8 : 0);
      float lo = 0.f, hi = 0.f;
      if (row < L) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(q + base + (size_t)row * W + col);
        lo = __bfloat162float(x.x);
        hi = __bfloat162float(x.y);
        if (!NORM_FIRST) { lo *= scale; hi *= scale; }
      }
      qa[ks][r] = pack_bf16x2(lo, hi);
    }
  }

  // Key blocks past l_valid (and, when causal, past this warp's last row)
  // are fully masked: they add exp(NEG - m) = 0 exactly, so skip them.
  int kmax = l_valid;
  if (causal) kmax = min(kmax, q0 + 16);
  const int kend = (kmax + 15) / 16 * 16;
  // NORM_FIRST scales the fp32 score; __fmul_rn keeps the product a rounding
  // point of its own (no contraction into the subtraction of the row max).
  // K1 folded the scale into q.
  auto scaled = [scale](float x) { return NORM_FIRST ? __fmul_rn(x, scale) : x; };

  // Pass 1: row maxima of the masked scores.
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int n0 = 0; n0 < kend; n0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* kr = Ks + (n0 + g) * KS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
      mma_bf16_16816(s, qa[ks], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + 2 * t + (e & 1);
      const int row = e < 2 ? row_lo : row_hi;
      const bool keep = key < l_valid && (!causal || key <= row);
      const float val = keep ? scaled(s[e]) : NEG;
      if (e < 2) m_lo = fmaxf(m_lo, val); else m_hi = fmaxf(m_hi, val);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }

  // NORM_FIRST only: the fp32 row sums of e = exp(s - m), before any p is formed.
  float l_lo = 0.f, l_hi = 0.f;
  if (NORM_FIRST) {
    for (int n0 = 0; n0 < kend; n0 += 8) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kr = Ks + (n0 + g) * KS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
        mma_bf16_16816(s, qa[ks], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool keep = key < l_valid && (!causal || key <= row);
        const float p = keep ? expf(scaled(s[e]) - (e < 2 ? m_lo : m_hi)) : 0.f;
        if (e < 2) l_lo += p; else l_hi += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
  }

  // Last pass: e = exp(s - m) in fp32; K1 sums the rows here and feeds
  // bf16(e) to the PV product, NORM_FIRST feeds bf16(e / rowsum).
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int n0 = 0; n0 < kend; n0 += 16) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* kr = Ks + (n0 + 8 * j + g) * KS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
        mma_bf16_16816(s[j], qa[ks], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool keep = key < l_valid && (!causal || key <= row);
        const float p = keep ? expf(scaled(s[j][e]) - (e < 2 ? m_lo : m_hi)) : 0.f;
        if (NORM_FIRST) {
          s[j][e] = p / (e < 2 ? l_lo : l_hi);
        } else {
          s[j][e] = p;
          if (e < 2) l_lo += p; else l_hi += p;
        }
      }
    }
    // The score C fragments of keys [n0, n0+16) are the A fragment of PV.
    const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]), pack_bf16x2(s[0][2], s[0][3]),
                            pack_bf16x2(s[1][0], s[1][1]), pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const bf16* vr = Vt + (dn * 8 + g) * VS + n0 + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
      mma_bf16_16816(acc[dn], pa, b0, b1);
    }
  }
  if (!NORM_FIRST) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
  }
  const float inv_lo = NORM_FIRST ? 1.f : 1.f / l_lo, inv_hi = NORM_FIRST ? 1.f : 1.f / l_hi;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row_lo * W + col) =
          pack_bf16x2(acc[dn][0] * inv_lo, acc[dn][1] * inv_lo);
    if (row_hi < L)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row_hi * W + col) =
          pack_bf16x2(acc[dn][2] * inv_hi, acc[dn][3] * inv_hi);
  }
}

// Shared memory the kernel needs at sequence length L (bytes); the wrapper
// in ops/attention.py computes the same bound to refuse too long a sequence.
int smem_bytes(int L) {
  const int l_pad = (L + 15) / 16 * 16;
  return l_pad * KS * 2 + D * (l_pad + 8) * 2;
}

template <bool NORM_FIRST>
int launch(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int l_valid, int causal,
           float scale, void* stream) {
  const int l_pad = (L + 15) / 16 * 16;
  const int smem = smem_bytes(L);
  cudaError_t err =
      cudaFuncSetAttribute(attention_fwd_kernel<NORM_FIRST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + QT - 1) / QT, H, B);
  attention_fwd_kernel<NORM_FIRST><<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      L, H, l_valid, causal, scale, l_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous [B, L, H*64] bf16 on the device.  Launches on
// `stream`; returns the CUDA error code of the launch (0 on success).
int uniir_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int l_valid,
                        int causal, float scale, void* stream) {
  return launch<false>(q, k, v, o, B, L, H, l_valid, causal, scale, stream);
}

// K8 / K9: the same tensors through the NORM_FIRST rounding points; `scale`
// is the fp32 scale applied to the scores (q is not pre-scaled).
int uniir_attention_norm_first_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H,
                                   int l_valid, int causal, float scale, void* stream) {
  return launch<true>(q, k, v, o, B, L, H, l_valid, causal, scale, stream);
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
