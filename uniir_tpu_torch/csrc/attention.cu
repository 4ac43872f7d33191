// K1: fused attention forward over model-native [B, L, H*D] bf16 tensors.
//
// Replaces uniir_tpu/ops/attention_pallas.py::mha_paired_stack
// (_paired_stack_kernel), reached from uniir_tpu/models/layers.py:208-216 on
// every block but the pooled last one of both CLIP towers.
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

  // Q fragments, scaled and rounded to bf16 (q * bf16(scale) in the reference).
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
        lo = __bfloat162float(x.x) * scale;
        hi = __bfloat162float(x.y) * scale;
      }
      qa[ks][r] = pack_bf16x2(lo, hi);
    }
  }

  // Key blocks past l_valid (and, when causal, past this warp's last row)
  // are fully masked: they add exp(NEG - m) = 0 exactly, so skip them.
  int kmax = l_valid;
  if (causal) kmax = min(kmax, q0 + 16);
  const int kend = (kmax + 15) / 16 * 16;

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
      const float val = keep ? s[e] : NEG;
      if (e < 2) m_lo = fmaxf(m_lo, val); else m_hi = fmaxf(m_hi, val);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }

  // Pass 2: e = exp(s - m) in fp32, fp32 row sums, bf16(e) @ V in fp32.
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;
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
        const float p = keep ? expf(s[j][e] - (e < 2 ? m_lo : m_hi)) : 0.f;
        s[j][e] = p;
        if (e < 2) l_lo += p; else l_hi += p;
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
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
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

}  // namespace

extern "C" {

// q, k, v, o: contiguous [B, L, H*64] bf16 on the device.  Launches on
// `stream`; returns the CUDA error code of the launch (0 on success).
int uniir_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int l_valid,
                        int causal, float scale, void* stream) {
  const int l_pad = (L + 15) / 16 * 16;
  const int smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + QT - 1) / QT, H, B);
  attention_fwd_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      L, H, l_valid, causal, scale, l_pad);
  return (int)cudaGetLastError();
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
