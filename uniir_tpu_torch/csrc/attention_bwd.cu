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
// Two kernels compute it; ops/attention.py::backward_route picks one by shape
// before the launch.
//
// attention_fused_bwd_kernel (L <= 272: every length the models train at).
// What bounded K3 on an H100 was neither HBM (seven tensors move once: 0.07 ms
// at CLIP's vision shape) nor the tensor cores' peak (43 GFLOP: 0.04 ms) but
// how the products were fed.  The general kernels below stage K, V and a
// scalar-store K^T (114 KB) once a 64-query tile, five times a head at
// L = 257, then Q, G and their transposes chunk by chunk, with nothing in
// flight meanwhile, and compute ten L x L x D products for the five the
// function has, with three exp and a division a score.  Design:
//   * one block (one warpgroup) per (batch, head), two row-major tiles of up
//     to 320 rows in the 128-byte swizzle (mma.cuh; 86 KB with the row
//     statistics, so two blocks fit an SM and one stages while the other
//     computes): K and V for phase A (two cp.async groups: the V copy runs
//     under the first q k^T), then qs = bf16(q * bf16(scale)) (through
//     registers, for its scale) and G for phase B; rows >= l_valid zero;
//   * wgmma for every product (wgmma.cuh), A in registers: the 16 rows a warp
//     owns come straight from device memory in fragment layout, a tile ahead;
//     B is a tile read through its descriptor, K-major for q k^T, g v^T, k q^T
//     and v g^T, through the transposed-B descriptor for ds k, p^T g and
//     ds^T q.  No transposed copy, no ldmatrix;
//   * phase A walks the 64-query tiles with a tile's fp32 score row in
//     registers (NT n8 tiles, a template parameter): q k^T once, the exact row
//     max, e = exp(s - m), the row sum; then dp = g v^T 64 keys at a time for
//     delta = sum(e dp) / rowsum; then dp again with ds = bf16(p (dp - delta))
//     packed from the accumulators into the A operand of dq = (ds k) scale.
//     The row statistics (max and rowsum as one exponent offset, and delta)
//     go to 2.5 KB of shared memory, not to a scratch in device memory;
//   * phase B walks the 64-key tiles with K and V fragments in registers and
//     the queries 64 at a time: s^T and dp^T, p = e / rowsum as one FFMA and
//     one ex2.approx from the shared statistics, ds, then dv += bf16(p)^T g and
//     dk += ds^T qs, whose products run under the next chunk's s^T and dp^T.
// Eight products for the general kernels' ten, two exp a score for three,
// one reciprocal a row for a division a score, one launch for two.  Every
// output element is owned by one thread and summed in a fixed order: the
// result is deterministic (dq as a second walk over the owned queries, not
// as shared-memory adds from the key owners, which would save a product and
// make the sums' order change from run to run).  p = e * (1 / rowsum) and
// exp through ex2.approx differ from the twin's e / rowsum by a few fp32
// ulps, far below the bf16 rounding of p and ds.  What bounds it now (0.355 ms
// at [64,257,1024]; with mma.sync + ldmatrix and the same structure 0.433):
// about 13 ALU instructions a score over 89 M scores a phase, the ten
// commit-and-wait round trips a query tile that the 64-key dp chunks cost,
// the restaging between the phases, and the fifth tile of L = 257, whose one
// valid row and one valid key cost a full tile of products.  Next: the next
// dp chunk issued under this one's arithmetic, and a persistent block that
// loads the next head under this one.
//
// The general-length K3 (272 < L <= 544; flash-attention-2 style, two
// launches, no atomics):
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace uniir;

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
    c_to_a(da, ds[0], ds[1]);
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
      c_to_a(pa, s[0], s[1]);
      c_to_a(da, dp[0], dp[1]);
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

// K3 for L <= 272: see the file header.  NT = the n8 key tiles of a score row
// (l_valid <= 8 NT, and > 8 (NT - 8) for the smallest instantiation that holds
// it, so only the last 8 tiles can hold a key >= l_valid and select; CAUSAL
// tests every tile that reaches the diagonal).  Block (head, batch) of one
// warpgroup; two blocks an SM.

// Rows r0 + g and r0 + g + 8 (those below L) of one head of a [L, H*D] gradient, from C fragments.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, size_t base, int W, int L, int r0,
                                           const float (&acc)[D / 8][4], float scale) {
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int row_lo = r0 + (lane >> 2), row_hi = row_lo + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row_lo * W + col) =
          pack_bf16x2(acc[dn][0] * scale, acc[dn][1] * scale);
    if (row_hi < L)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row_hi * W + col) =
          pack_bf16x2(acc[dn][2] * scale, acc[dn][3] * scale);
  }
}

// d (64 rows x 8 N8 columns) = A (64 x 64, registers) . B^T, B the N8 * 8 K-major tile rows at `desc`
// (N8 = 8 or 2), waited for: the accumulators are ready on return.
template <int N8>
__device__ __forceinline__ void product_kmajor(float (&d)[N8][4], const uint32_t (&a)[D / 16][4], uint64_t desc) {
  static_assert(N8 == 8 || N8 == 2, "64 or 16 tile rows");
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if constexpr (N8 == 8) wgmma_m64n64k16(&d[0][0], a[ks], desc + 2 * ks, ks > 0);
    if constexpr (N8 == 2) wgmma_m64n16k16(&d[0][0], a[ks], desc + 2 * ks, ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs<4 * N8>(&d[0][0]);
}

template <int NT, bool CAUSAL>
__global__ void __launch_bounds__(128, 2)
attention_fused_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const bf16* __restrict__ g, bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int L, int H, int l_valid, float qscale, float dq_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kpad = NT * 8;                     // keys staged in phase A
  constexpr int TROWS = (kpad + 63) / 64 * 64;     // tile rows: phase B walks the queries 64 at a time
  constexpr int tile_bytes = TROWS * TILE_ROW_BYTES;
  // the first n8 tile that can hold a key >= l_valid: the smallest instantiation is picked, so
  // l_valid > 8 (NT - 8), except that the smallest of all (NT = 10) also takes the shortest rows
  constexpr int EDGE = NT > 10 ? NT - 8 : 0;
  // the hardware's swizzle is a function of the address: the tiles start on a 1024-byte boundary
  unsigned char* T0 = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);  // phase A: K; phase B: qs
  unsigned char* T1 = T0 + tile_bytes;                                   // phase A: V; phase B: G
  float* Cs = reinterpret_cast<float*>(T1 + tile_bytes);  // (row max) log2e + log2(row sum): p = 2^(s log2e - c)
  float* Ds = Cs + TROWS;                                 // delta = sum(p * dp)
  const int W = H * D;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * L * W + (size_t)h * D;

  // rows >= l_valid of all four tensors are zero by select (here and in
  // load_a_words), so padding never reaches a product
  stage_head_rows(T0, k, base, W, kpad, l_valid);
  cp_async_commit();
  stage_head_rows(T1, v, base, W, kpad, l_valid);
  cp_async_commit();
  for (int i = threadIdx.x; i < TROWS; i += blockDim.x) Cs[i] = Ds[i] = 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;
  const uint64_t d0 = wgmma_desc(smem_u32(T0)), d1 = wgmma_desc(smem_u32(T1));
  const int ntiles = (l_valid + 63) / 64;  // 64-row tiles that hold a valid row

  cp_async_wait<1>();  // K has landed
  fence_proxy_async();
  __syncthreads();

  // ---- phase A: the warpgroup walks the query tiles: row statistics and dq
  // (each warp's q and g fragments are read from device memory a tile ahead)
  uint32_t qraw[D / 16][4], graw[D / 16][4];
  load_a_words(qraw, q, base, W, l_valid, warp * 16);
  load_a_words(graw, g, base, W, l_valid, warp * 16);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int wq0 = tile * 64 + warp * 16;  // this warp's 16 rows of the tile
    const bool active = wq0 < l_valid;      // warp-uniform: a warp with no valid row skips the arithmetic
    const int row_lo = wq0 + gr, row_hi = row_lo + 8;
    uint32_t qa[D / 16][4], ga[D / 16][4];
    scale_words(qa, qraw, qscale);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) ga[ks][r] = graw[ks][r];

    float s[NT][4];  // the scores, then e = exp(s - m), then ds
    wgmma_fence();
    wgmma_row_kmajor<NT>(s, qa, d0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs<4 * NT>(&s[0][0]);

    float l_lo = 1.f, l_hi = 1.f, m_lo = -INFINITY, m_hi = -INFINITY;
    if (active) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (CAUSAL ? (j * 8 + 8 > l_valid || j * 8 + 7 > wq0) : j >= EDGE) {  // a tile that may hold a masked key
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_lo : row_hi;
            const bool keep = key < l_valid && (!CAUSAL || key <= row);
            s[j][e] = keep ? s[j][e] : NEG;
          }
        }
        m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
        m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
      }
      // exp(s - m) = 2^(s log2e - m log2e): one FFMA and one ex2.approx a score
      m_lo = quad_max(m_lo) * LOG2E;
      m_hi = quad_max(m_hi) * LOG2E;
      l_lo = l_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2_approx(fmaf(s[j][0], LOG2E, -m_lo));  // a masked key: 2^(NEG log2e - m) = 0 exactly
        s[j][1] = exp2_approx(fmaf(s[j][1], LOG2E, -m_lo));
        s[j][2] = exp2_approx(fmaf(s[j][2], LOG2E, -m_hi));
        s[j][3] = exp2_approx(fmaf(s[j][3], LOG2E, -m_hi));
        l_lo += s[j][0] + s[j][1];
        l_hi += s[j][2] + s[j][3];
      }
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
    }
    if (tile == 0) {
      cp_async_wait<0>();  // V has landed, under the first tile's q k^T and softmax
      fence_proxy_async();
      __syncthreads();
    }

    // delta = sum(e * dp) / rowsum, dp = g v^T, 64 keys at a time (and the last 16)
    float ed_lo = 0.f, ed_hi = 0.f;
#pragma unroll
    for (int c = 0; c < NT / 8; ++c) {
      float dp[8][4];
      product_kmajor<8>(dp, ga, d1 + desc_rows(64 * c));
      if (active) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ed_lo += s[8 * c + j][0] * dp[j][0] + s[8 * c + j][1] * dp[j][1];
          ed_hi += s[8 * c + j][2] * dp[j][2] + s[8 * c + j][3] * dp[j][3];
        }
      }
    }
    {
      float dp[2][4];
      product_kmajor<2>(dp, ga, d1 + desc_rows(8 * (NT - 2)));
      if (active) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ed_lo += s[NT - 2 + j][0] * dp[j][0] + s[NT - 2 + j][1] * dp[j][1];
          ed_hi += s[NT - 2 + j][2] * dp[j][2] + s[NT - 2 + j][3] * dp[j][3];
        }
      }
    }
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const float delta_lo = quad_sum(ed_lo) * inv_lo, delta_hi = quad_sum(ed_hi) * inv_hi;
    // p (dp - delta) = e (dp / rowsum - delta / rowsum): one FFMA and one multiply a score
    const float nd_lo = -delta_lo * inv_lo, nd_hi = -delta_hi * inv_hi;

    // ds = bf16(p * (dp - delta)) with p = e / rowsum (0 at a masked key), packed as the A operand of dq = ds k
    uint32_t da[NT / 2][4];
#pragma unroll
    for (int c = 0; c < NT / 8; ++c) {
      float dp[8][4];
      product_kmajor<8>(dp, ga, d1 + desc_rows(64 * c));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[8 * c + j][0] *= fmaf(dp[j][0], inv_lo, nd_lo);
        s[8 * c + j][1] *= fmaf(dp[j][1], inv_lo, nd_lo);
        s[8 * c + j][2] *= fmaf(dp[j][2], inv_hi, nd_hi);
        s[8 * c + j][3] *= fmaf(dp[j][3], inv_hi, nd_hi);
      }
#pragma unroll
      for (int kk = 4 * c; kk < 4 * c + 4; ++kk) c_to_a(da[kk], s[2 * kk], s[2 * kk + 1]);
    }
    {
      float dp[2][4];
      product_kmajor<2>(dp, ga, d1 + desc_rows(8 * (NT - 2)));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[NT - 2 + j][0] *= fmaf(dp[j][0], inv_lo, nd_lo);
        s[NT - 2 + j][1] *= fmaf(dp[j][1], inv_lo, nd_lo);
        s[NT - 2 + j][2] *= fmaf(dp[j][2], inv_hi, nd_hi);
        s[NT - 2 + j][3] *= fmaf(dp[j][3], inv_hi, nd_hi);
      }
      c_to_a(da[NT / 2 - 1], s[NT - 2], s[NT - 1]);
    }
    if (!active) {  // its scores were never masked or exponentiated: feed zeros
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) da[kk][0] = da[kk][1] = da[kk][2] = da[kk][3] = 0u;
    }
    float acc[D / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) wgmma_m64n64k16_bt(&acc[0][0], da[kk], d0 + desc_rows(16 * kk), kk > 0);
    wgmma_commit();
    load_a_words(qraw, q, base, W, l_valid, wq0 + 64);  // the next tile's rows, under this product
    load_a_words(graw, g, base, W, l_valid, wq0 + 64);
    wgmma_wait<0>();
    wgmma_fence_regs<D / 2>(&acc[0][0]);
    store_rows(dq, base, W, L, wq0, acc, dq_scale);
    if (active && t == 0) {
      Cs[row_lo] = m_lo + log2f(l_lo);
      Ds[row_lo] = delta_lo;
      Cs[row_hi] = m_hi + log2f(l_hi);
      Ds[row_hi] = delta_hi;
    }
  }
  __syncthreads();  // every row's statistics are in shared memory, and K and V are consumed

  // the two tiles now take qs (through registers, for its scale) and G
  stage_head_rows(T1, g, base, W, TROWS, l_valid);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < TROWS * 8; idx += blockDim.x) {
    const int row = idx >> 3, c = idx & 7;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < l_valid) {
      x = *reinterpret_cast<const uint4*>(q + base + (size_t)row * W + c * 8);
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
    }
    *reinterpret_cast<uint4*>(T0 + tile_offset(row, c)) = x;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // ---- phase B: the warpgroup walks the key tiles: dk and dv
  // (k and v fragments a tile ahead, in the registers phase A read q and g into)
  load_a_words(qraw, k, base, W, l_valid, warp * 16);
  load_a_words(graw, v, base, W, l_valid, warp * 16);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int wk0 = tile * 64 + warp * 16;  // this warp's 16 keys of the tile
    const bool active = wk0 < l_valid;
    uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ka[ks][r] = qraw[ks][r];
        va[ks][r] = graw[ks][r];
      }
    }
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
    uint32_t pa[4][4], da[4][4];

    // queries before the tile's first key see none of its keys when causal;
    // queries >= l_valid have zero qs and g and add nothing
    const int qc0 = CAUSAL ? tile : 0;
    for (int qc = qc0; qc < ntiles; ++qc) {
      float p[8][4], ds[8][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // s^T: keys x queries
        wgmma_m64n64k16(&p[0][0], ka[ks], d0 + desc_rows(64 * qc) + 2 * ks, ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // dp^T
        wgmma_m64n64k16(&ds[0][0], va[ks], d1 + desc_rows(64 * qc) + 2 * ks, ks > 0);
      wgmma_commit();
      wgmma_wait<0>();  // these, and the last chunk's dv / dk products, which read pa and da
      wgmma_fence_regs<32>(&p[0][0]);
      wgmma_fence_regs<32>(&ds[0][0]);
      if (active) {
        const bool masked = tile * 64 + 64 > l_valid || qc * 64 + 64 > l_valid || (CAUSAL && qc == tile);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qi = qc * 64 + 8 * j + 2 * t;
          const float2 c2 = *reinterpret_cast<const float2*>(Cs + qi);
          const float2 d2 = *reinterpret_cast<const float2*>(Ds + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float c = (e & 1) ? c2.y : c2.x, delta = (e & 1) ? d2.y : d2.x;
            const float pe = exp2_approx(fmaf(p[j][e], LOG2E, -c));  // e / rowsum
            p[j][e] = pe;
            ds[j][e] = pe * (ds[j][e] - delta);
          }
          if (masked) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = wk0 + gr + (e < 2 ? 0 : 8);
              const int qrow = qi + (e & 1);
              const bool keep = key < l_valid && qrow < l_valid && (!CAUSAL || key <= qrow);
              p[j][e] = keep ? p[j][e] : 0.f;
              ds[j][e] = keep ? ds[j][e] : 0.f;
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          c_to_a(pa[kk], p[2 * kk], p[2 * kk + 1]);
          c_to_a(da[kk], ds[2 * kk], ds[2 * kk + 1]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = da[kk][0] = da[kk][1] = da[kk][2] = da[kk][3] = 0u;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dv += bf16(p)^T g
        wgmma_m64n64k16_bt(&dv_acc[0][0], pa[kk], d1 + desc_rows(64 * qc + 16 * kk), qc > qc0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dk += ds^T qs
        wgmma_m64n64k16_bt(&dk_acc[0][0], da[kk], d0 + desc_rows(64 * qc + 16 * kk), qc > qc0 || kk > 0);
      wgmma_commit();
    }
    load_a_words(qraw, k, base, W, l_valid, wk0 + 64);  // the next tile's keys, under the last products
    load_a_words(graw, v, base, W, l_valid, wk0 + 64);
    wgmma_wait<0>();
    wgmma_fence_regs<D / 2>(&dk_acc[0][0]);
    wgmma_fence_regs<D / 2>(&dv_acc[0][0]);
    store_rows(dk, base, W, L, wk0, dk_acc, 1.f);
    store_rows(dv, base, W, L, wk0, dv_acc, 1.f);
  }

  // rows past the tiles that hold a valid row get zero gradients
  for (int idx = threadIdx.x; idx < (L - ntiles * 64) * 8; idx += blockDim.x) {
    const size_t at = base + (size_t)(ntiles * 64 + (idx >> 3)) * W + (idx & 7) * 8;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dq + at) = zero;
    *reinterpret_cast<uint4*>(dk + at) = zero;
    *reinterpret_cast<uint4*>(dv + at) = zero;
  }
}

template <int NT, bool CAUSAL>
int launch_fused_variant(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk, void* dv, int B,
                         int L, int H, int l_valid, float qscale, float dq_scale, void* stream) {
  constexpr int TROWS = (NT * 8 + 63) / 64 * 64;
  // two tiles, two rows of statistics and the slack to align the tiles
  const int smem = 2 * TROWS * TILE_ROW_BYTES + 2 * TROWS * (int)sizeof(float) + 1024;
  cudaError_t err = cudaFuncSetAttribute(attention_fused_bwd_kernel<NT, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_fused_bwd_kernel<NT, CAUSAL><<<dim3(H, B), 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H,
      l_valid, qscale, dq_scale);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_fused(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk, void* dv, int B, int L,
                 int H, int l_valid, int causal, float qscale, float dq_scale, void* stream) {
  return causal ? launch_fused_variant<NT, true>(q, k, v, g, dq, dk, dv, B, L, H, l_valid, qscale, dq_scale, stream)
                : launch_fused_variant<NT, false>(q, k, v, g, dq, dk, dv, B, L, H, l_valid, qscale, dq_scale, stream);
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

// K3 for L <= 272 (the wrapper checks).  q, k, v, g, dq, dk, dv: contiguous
// [B, L, H*64] bf16 on the device; qscale is bf16(scale), dq_scale the fp32
// scale.  One launch on `stream`; returns its CUDA error code (0 on success).
int uniir_attention_fused_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
                              int B, int L, int H, int l_valid, int causal, float qscale, float dq_scale,
                              void* stream) {
  const int nt = (l_valid + 7) / 8;  // n8 key tiles; the smallest instantiation that holds them
  if (L > 272 || l_valid < 1 || l_valid > L) return (int)cudaErrorInvalidValue;
  if (nt <= 10) return launch_fused<10>(q, k, v, g, dq, dk, dv, B, L, H, l_valid, causal, qscale, dq_scale, stream);
  if (nt <= 18) return launch_fused<18>(q, k, v, g, dq, dk, dv, B, L, H, l_valid, causal, qscale, dq_scale, stream);
  if (nt <= 26) return launch_fused<26>(q, k, v, g, dq, dk, dv, B, L, H, l_valid, causal, qscale, dq_scale, stream);
  return launch_fused<34>(q, k, v, g, dq, dk, dv, B, L, H, l_valid, causal, qscale, dq_scale, stream);
}

// The general-length K3.  q, k, v, g, dq, dk, dv: contiguous [B, L, H*64] bf16 on the device;
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
