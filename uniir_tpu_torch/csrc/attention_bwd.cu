// K3: fused attention backward over model-native [B, L, H*D] bf16 tensors.
//
// Replaces uniir_tpu/ops/attention_pallas.py::mha_paired_stack_bwd
// (_paired_stack_bwd_kernel), the backward of K1 that every CLIP training
// step reaches through the custom_vjp `paired_attention`.
//
// Computes, per (batch, head), with the reference kernel's rounding points:
//   qs = bf16(q * bf16(scale)); rows >= l_valid of q, k, v and g zeroed by select
//   s  = qs k^T in fp32; keys >= l_valid (and future keys when causal) -> NEG by select
//   p  = exp(s - rowmax) / rowsum, fp32
//   dv = bf16(p)^T g                    dp = g v^T
//   ds = bf16(p * (dp - rowsum(p * dp)))
//   dq = (ds k) * scale (fp32, after the product)      dk = ds^T qs
// with bf16 operands and fp32 accumulation in every product.  No [L, L]
// tensor reaches device memory.
//
// What bounds it on an H100: at CLIP shapes (L=257/77, D=64) the work is
// small matrix products plus an exp per score, recomputed several times;
// q, k, v, g, dq, dk, dv are each read or written a few times, so the kernel
// is issue-bound on mma.sync and the exp/select work, not HBM-bound.
// Design (flash-attention-2 style, two launches, no atomics):
//   1. attention_bwd_dq_kernel, one block per (64-query tile, head, batch):
//      K, V and K^T of all L keys sit in shared memory (114 KB at L=257);
//      each warp owns 16 query rows with its Q and G fragments in registers.
//      Pass 1 takes the fp32 row max, pass 2 the row sum of e = exp(s - m)
//      and of e * dp, pass 3 recomputes p = e / rowsum and ds and
//      accumulates dq = ds k in registers.  The row max, row sum and
//      delta = sum(e * dp) / rowsum go to a small fp32 scratch [3, B, H, L].
//      (The reference sums p * dp with p = e / rowsum; dividing once after
//      the sum differs by a few fp32 ulps of delta.)
//   2. attention_bwd_dkdv_kernel, one block per (64-key tile, head, batch):
//      each warp owns 16 keys with its K and V fragments in registers and
//      walks the queries in 64-row chunks staged in shared memory (row-major
//      and transposed, so every B fragment is one 32-bit load).  It
//      recomputes s^T and dp^T, takes p and ds with the scratch's row
//      statistics, and accumulates dv = bf16(p)^T g and dk = ds^T qs in fp32
//      registers.  Each dk / dv element is owned by one thread: the sums are
//      deterministic.
// A faster wgmma/TMA version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uniir::mma_bf16_16816;
using uniir::pack_bf16x2;

constexpr int D = 64;          // head dim (the wrapper checks)
constexpr int WARPS = 4;
constexpr int TILE = 16 * WARPS;  // query rows (dq pass) or key rows (dk/dv pass) per block
constexpr int RS = D + 8;      // row stride of [rows][D] and [D][TILE] tiles in shared memory
constexpr float NEG = -1e30f;  // the reference kernel's mask value

// A fragments of rows r0..r0+15 of one head of a [L, H*D] tensor, times
// `scale` and rounded to bf16.  Rows >= l_valid are zero by select.
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* __restrict__ x, size_t base, int W,
                                       int r0, int l_valid, float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + g + ((r & 1) ? 8 : 0);
      const int col = ks * 16 + 2 * t + ((r & 2) ? 8 : 0);
      float lo = 0.f, hi = 0.f;
      if (row < l_valid) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + base + (size_t)row * W + col);
        lo = __bfloat162float(v.x) * scale;
        hi = __bfloat162float(v.y) * scale;
      }
      a[ks][r] = pack_bf16x2(lo, hi);
    }
  }
}

// c += A (16 x D, registers) . rows[n0 .. n0+8)^T, with `rows` a [.][RS]
// row-major tile in shared memory: the B fragment (k = d, n = row) is one
// 32-bit load per register.
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[D / 16][4], const bf16* rows, int n0) {
  const int lane = threadIdx.x % 32;
  const bf16* r = rows + (n0 + (lane >> 2)) * RS + 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(r + ks * 16);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(r + ks * 16 + 8);
    mma_bf16_16816(c, a[ks], b0, b1);
  }
}

// acc[dn] += A (16 x 16, registers) . cols[.., k0 .. k0+16) for the D / 8
// column blocks of a [D][stride] transposed tile in shared memory.
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const uint32_t (&a)[4], const bf16* cols, int stride,
                                         int k0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const bf16* c = cols + (dn * 8 + (lane >> 2)) * stride + k0 + 2 * (lane & 3);
    mma_bf16_16816(acc[dn], a, *reinterpret_cast<const uint32_t*>(c), *reinterpret_cast<const uint32_t*>(c + 8));
  }
}

// The C fragments of two adjacent n8 tiles are the A fragment of the next product.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__global__ void __launch_bounds__(WARPS * 32)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ g, bf16* __restrict__ dq, float* __restrict__ stats, int B, int L,
                        int H, int l_valid, int causal, float qscale, float dq_scale, int l_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [l_pad][RS]
  bf16* Vs = Ks + l_pad * RS;                // [l_pad][RS]
  bf16* Kt = Vs + l_pad * RS;                // [D][KTS], K transposed
  const int KTS = l_pad + 8;
  const int W = H * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * L * W + (size_t)h * D;

  // K, V and K^T of every key; rows >= l_valid are zero by select, so
  // padding can never reach a product (0 * NaN = NaN).
  for (int idx = threadIdx.x; idx < l_pad * (D / 8); idx += blockDim.x) {
    const int row = idx / (D / 8), c = idx % (D / 8);
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (row < l_valid) {
      kv = *reinterpret_cast<const uint4*>(k + base + (size_t)row * W + c * 8);
      vv = *reinterpret_cast<const uint4*>(v + base + (size_t)row * W + c * 8);
    }
    *reinterpret_cast<uint4*>(Ks + row * RS + c * 8) = kv;
    *reinterpret_cast<uint4*>(Vs + row * RS + c * 8) = vv;
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Kt[(c * 8 + i) * KTS + row] = ke[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TILE + warp * 16;
  if (q0 >= L) return;  // no block-wide barrier follows
  const int row_lo = q0 + (lane >> 2), row_hi = row_lo + 8;

  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a(qa, q, base, W, q0, l_valid, qscale);
  load_a(ga, g, base, W, q0, l_valid, 1.f);

  // Key blocks past l_valid (and, when causal, past this warp's last row)
  // are fully masked: p = 0 there exactly, so skip them.
  int kmax = l_valid;
  if (causal) kmax = min(kmax, q0 + 16);
  const int kend = (kmax + 15) / 16 * 16;

  // Pass 1: row maxima of the masked scores.
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int n0 = 0; n0 < kend; n0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    mma_rows(s, qa, Ks, n0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + 2 * t + (e & 1);
      const int row = e < 2 ? row_lo : row_hi;
      const float val = (key < l_valid && (!causal || key <= row)) ? s[e] : NEG;
      if (e < 2) m_lo = fmaxf(m_lo, val); else m_hi = fmaxf(m_hi, val);
    }
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);

  // Pass 2: row sums of e = exp(s - m) and of e * dp, dp = g v^T.
  float l_lo = 0.f, l_hi = 0.f, ed_lo = 0.f, ed_hi = 0.f;
  for (int n0 = 0; n0 < kend; n0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    mma_rows(s, qa, Ks, n0);
    mma_rows(dp, ga, Vs, n0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + 2 * t + (e & 1);
      const int row = e < 2 ? row_lo : row_hi;
      const bool keep = key < l_valid && (!causal || key <= row);
      const float p = keep ? expf(s[e] - (e < 2 ? m_lo : m_hi)) : 0.f;
      const float pdp = keep ? p * dp[e] : 0.f;
      if (e < 2) { l_lo += p; ed_lo += pdp; } else { l_hi += p; ed_hi += pdp; }
    }
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float delta_lo = quad_sum(ed_lo) / l_lo, delta_hi = quad_sum(ed_hi) / l_hi;

  // Pass 3: p = e / rowsum, ds = bf16(p * (dp - delta)), dq += ds k.
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int n0 = 0; n0 < kend; n0 += 16) {
    float ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows(s, qa, Ks, n0 + 8 * j);
      mma_rows(dp, ga, Vs, n0 + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool keep = key < l_valid && (!causal || key <= row);
        const float p = keep ? expf(s[e] - (e < 2 ? m_lo : m_hi)) / (e < 2 ? l_lo : l_hi) : 0.f;
        ds[j][e] = keep ? p * (dp[e] - (e < 2 ? delta_lo : delta_hi)) : 0.f;
      }
    }
    uint32_t da[4];
    c_to_a(da, ds);
    mma_cols(acc, da, Kt, KTS, n0);
  }

#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row_lo * W + col) =
          pack_bf16x2(acc[dn][0] * dq_scale, acc[dn][1] * dq_scale);
    if (row_hi < L)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row_hi * W + col) =
          pack_bf16x2(acc[dn][2] * dq_scale, acc[dn][3] * dq_scale);
  }
  if (t == 0) {
    const size_t n = (size_t)B * H * L, srow = ((size_t)b * H + h) * L;
    if (row_lo < L) {
      stats[srow + row_lo] = m_lo;
      stats[n + srow + row_lo] = l_lo;
      stats[2 * n + srow + row_lo] = delta_lo;
    }
    if (row_hi < L) {
      stats[srow + row_hi] = m_hi;
      stats[n + srow + row_hi] = l_hi;
      stats[2 * n + srow + row_hi] = delta_hi;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ g, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          const float* __restrict__ stats, int B, int L, int H, int l_valid, int causal,
                          float qscale) {
  // one chunk of TILE queries: qs and g row-major ([query][RS]) and
  // transposed ([d][RS]), with the queries' row statistics
  __shared__ __align__(16) bf16 Qs[TILE * RS], Gs[TILE * RS], Qt[D * RS], Gt[D * RS];
  __shared__ float Ms[TILE], Ls[TILE], Ds[TILE];
  const int W = H * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * L * W + (size_t)h * D;
  const size_t n = (size_t)B * H * L, srow = ((size_t)b * H + h) * L;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gk = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x * TILE, k0 = kb + warp * 16;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a(ka, k, base, W, k0, l_valid, 1.f);
  load_a(va, v, base, W, k0, l_valid, 1.f);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  // Queries before the block's first key see none of its keys when causal;
  // queries >= l_valid have zero q and g and add nothing.
  for (int c0 = causal ? kb : 0; c0 < l_valid; c0 += TILE) {
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < TILE * (D / 8); idx += blockDim.x) {
      const int r = idx / (D / 8), c = idx % (D / 8), row = c0 + r;
      uint4 qv = make_uint4(0, 0, 0, 0), gv = make_uint4(0, 0, 0, 0);
      if (row < l_valid) {
        qv = *reinterpret_cast<const uint4*>(q + base + (size_t)row * W + c * 8);
        gv = *reinterpret_cast<const uint4*>(g + base + (size_t)row * W + c * 8);
      }
      bf16* qe = reinterpret_cast<bf16*>(&qv);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qe[i] = __float2bfloat16_rn(__bfloat162float(qe[i]) * qscale);
        Qt[(c * 8 + i) * RS + r] = qe[i];
        Gt[(c * 8 + i) * RS + r] = ge[i];
      }
      *reinterpret_cast<uint4*>(Qs + r * RS + c * 8) = qv;
      *reinterpret_cast<uint4*>(Gs + r * RS + c * 8) = gv;
    }
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
      const int row = c0 + r;
      const bool ok = row < l_valid;
      Ms[r] = ok ? stats[srow + row] : 0.f;
      Ls[r] = ok ? stats[n + srow + row] : 1.f;
      Ds[r] = ok ? stats[2 * n + srow + row] : 0.f;
    }
    __syncthreads();
    if (k0 >= l_valid) continue;  // keys past l_valid get zero gradients

    for (int qt = 0; qt < TILE && c0 + qt < l_valid; qt += 16) {
      if (causal && c0 + qt + 15 < k0) continue;  // every query before every key
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        mma_rows(s[j], ka, Qs, qt + 8 * j);   // s^T: keys x queries
        mma_rows(dp[j], va, Gs, qt + 8 * j);  // dp^T
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + gk + (e < 2 ? 0 : 8);
          const int qi = qt + 8 * j + 2 * t + (e & 1), qrow = c0 + qi;
          const bool keep = key < l_valid && qrow < l_valid && (!causal || key <= qrow);
          const float p = keep ? expf(s[j][e] - Ms[qi]) / Ls[qi] : 0.f;
          dp[j][e] = keep ? p * (dp[j][e] - Ds[qi]) : 0.f;
          s[j][e] = p;
        }
      }
      uint32_t pa[4], da[4];
      c_to_a(pa, s);
      c_to_a(da, dp);
      mma_cols(dv_acc, pa, Gt, RS, qt);  // dv += bf16(p)^T g
      mma_cols(dk_acc, da, Qt, RS, qt);  // dk += ds^T qs
    }
  }

  const int row_lo = k0 + gk, row_hi = row_lo + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)row_lo * W + col) = pack_bf16x2(dk_acc[dn][0], dk_acc[dn][1]);
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)row_lo * W + col) = pack_bf16x2(dv_acc[dn][0], dv_acc[dn][1]);
    }
    if (row_hi < L) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)row_hi * W + col) = pack_bf16x2(dk_acc[dn][2], dk_acc[dn][3]);
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)row_hi * W + col) = pack_bf16x2(dv_acc[dn][2], dv_acc[dn][3]);
    }
  }
}

// Shared memory the dq kernel needs at sequence length L (bytes); the
// wrapper in ops/attention.py computes the same bound to refuse too long a
// sequence.
int dq_smem_bytes(int L) {
  const int l_pad = (L + 15) / 16 * 16;
  return 2 * l_pad * RS * 2 + D * (l_pad + 8) * 2;
}

}  // namespace

extern "C" {

// q, k, v, g, dq, dk, dv: contiguous [B, L, H*64] bf16 on the device;
// stats: fp32 scratch of 3 * B * H * L.  Launches both kernels on `stream`;
// returns the CUDA error code of the launches (0 on success).
int uniir_attention_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
                        void* stats, int B, int L, int H, int l_valid, int causal, float qscale, float dq_scale,
                        void* stream) {
  const int l_pad = (L + 15) / 16 * 16;
  const int smem = dq_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TILE - 1) / TILE, H, B);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* gp = static_cast<const bf16*>(g);
  attention_bwd_dq_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dq), static_cast<float*>(stats), B, L, H, l_valid, causal, qscale, dq_scale,
      l_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<const float*>(stats), B, L, H,
      l_valid, causal, qscale);
  return (int)cudaGetLastError();
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
