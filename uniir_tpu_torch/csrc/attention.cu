// K1, K8, K9, K10: fused attention forward over model-native [B, L, H*D] bf16 tensors.
//
// K1 replaces uniir_tpu/ops/attention_pallas.py::mha_paired_stack
// (_paired_stack_kernel), reached from uniir_tpu/models/layers.py:208-216 on
// every block but the pooled last one of the CLIP towers and of the BLIP ViT.
// K8 and K9 replace mha_nocausal (_attn_kernel, over [B, L, H, D], which is
// the same memory) and mha_paired (_paired_kernel) of the same file: the
// NORM_FIRST variant of the general-length kernel below, described after K1.
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
// Two kernels compute it; ops/attention.py::forward_route picks one by shape
// before the launch.
//
// attention_fused_fwd_kernel (L <= 272: every length the models use).  What
// bounded K1 on an H100 was neither HBM (q, k, v, o move once: 0.04 ms at
// CLIP's vision shape) nor the tensor cores (17 GFLOP: 0.02 ms) but how the
// products were fed: the general kernel below stages a head's K and V five
// times at L = 257 (once a 64-row tile, the fifth for one valid row), through
// a bank-conflicted scalar transpose, with nothing in flight meanwhile, and
// computes q k^T twice.  Design:
//   * one block (one warpgroup) per (batch, head) stages the head's K and V
//     once, with 16-byte cp.async into row-major tiles in the 128-byte
//     swizzle (mma.cuh), K and V as two groups so that the V copy runs under
//     the first q k^T and softmax; 70 KB and 231 registers: two blocks an SM,
//     one staging or in its softmax while the other's products run;
//   * wgmma for both products (wgmma.cuh), m64nNk16 with A in registers: q k^T
//     reads the K tile as a K-major B operand through its descriptor, p v
//     reads the V tile row-major through the transposed-B descriptor.  No
//     transposed copy, no ldmatrix, no B fragment in registers;
//   * the warpgroup walks the head's 64-query tiles and keeps a tile's whole
//     fp32 score row in registers (NT n8 tiles, a template parameter: 136
//     registers a thread at 272 keys, as four products of 64 keys and one of 16): q k^T once,
//     the exact row max, e = exp(s - m) as one FFMA and one ex2.approx, the
//     fp32 row sum, bf16(e) straight from the accumulators into the A operand
//     of p v, one multiply by 1 / rowsum.  These are the twin's rounding
//     points, with the fp32 sums in another order and exp within 2 ulp of
//     fp32 (far below the bf16 rounding of e): two products where the general
//     kernel does three;
//   * q is read from device memory in fragment layout a tile ahead, so the
//     loads fly under the current tile's softmax;
//   * keys past l_valid are masked by select only in the last n8 tiles, which
//     alone can hold one; a warp whose 16 rows are all past L (three of four
//     in the fifth tile of L = 257) skips the softmax and feeds zeros.
// What bounds it now (0.090 ms at [64,257,1024]; measured by leaving parts
// out of the version that took 0.103 ms, before q was read a tile ahead): the
// staging alone is 0.024 ms, near HBM's rate; the softmax's ALU work (max,
// FFMA, ex2, sum, pack: 89 M scores) is 0.045 ms, of which ex2 is 0.013; the
// fifth tile, one valid row, costs 13 %.  The products are the small part:
// going from mma.sync + ldmatrix (0.120 ms) to wgmma freed issue slots more
// than tensor time.  Next: a persistent block that loads the next head under
// this one, and two warpgroups that share one staging.
//
// attention_fwd_kernel<false> (the general-length K1, 272 < L <= 848): one
// block per (query tile of 64 rows, head, batch); K and V^T for all of L sit
// in shared memory (75 KB at L=257, 232 KB at L=848), V transposed by scalar
// stores; each warp owns 16 query rows and runs mma.sync with 32-bit
// shared-memory B fragments.  Softmax is two-pass over the keys (pass 1: row
// max; pass 2: recompute the scores, exp, row sum and PV): the same rounding
// points at 1.5x the QK^T work, with registers that do not grow with L.
//
// NORM_FIRST (K8 / K9) keeps the other two Pallas kernels' rounding points:
//   * q is NOT pre-scaled: s = fp32(q k^T) * scale, in fp32 after the product,
//   * masked keys -> -1e30, fp32 row max, e = exp(s - max), fp32 row sum,
//   * p = bf16(e / rowsum): normalised BEFORE the PV product,
//   * o = fp32-accumulated p v, cast to bf16 with no further multiply.
// The row sum must be known before the first p is formed, so this variant
// walks the keys three times (max; sum; p v): 2x the QK^T work.  Same tiles,
// same shared-memory layout, same launch geometry as K1.
//
// K10 (attention_splitk_kernel) replaces _paired_stack_splitk_kernel of the
// same file, which mha_paired_stack selects (UNIIR_ATTN_SPLITK=1) for a
// non-causal call whose valid length is one past a multiple of 128: CLIP's
// vision tower, L = 257.  It is K1's function with the last key taken out of
// the tensor-core products and folded in as a rank-1 term, at these rounding
// points (attention_pallas.py:352-403):
//   * s_main = fp32 tensor-core scores over the first Km = l_valid - 1 keys,
//     every column valid: no mask, and no padded key tile (K1 pads 257 keys
//     to 272; 256 is 16 whole tiles),
//   * s_last = the fp32 sum over the head's 64 lanes of bf16(q * k_last): each
//     product is rounded to bf16 before the sum,
//   * m = max(max(s_main), s_last); rsum = sum(exp(s_main - m)), then
//     + exp(s_last - m),
//   * o = (fp32(bf16(e) v_main) + fp32(bf16(bf16(e_last) * v_last))) / rsum.
// On the TPU this saved a third 128-lane key tile; here it saves one
// mostly-masked 16-key tile of 17 and the per-score mask selects, at the
// price of a few CUDA-core products per row.  Same tiles and launch geometry
// as K1; the last K and V rows sit in shared memory beside the main block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace uniir;

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

// K10: see the file header.  km = l_valid - 1 is a multiple of 128 (the
// wrapper checks), so the main block is whole 16-key tiles.
__global__ void __launch_bounds__(WARPS * 32)
attention_splitk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        bf16* __restrict__ o, int L, int H, int km, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [km][KS]
  bf16* Vt = Ks + km * KS;                   // [D][VS], V transposed
  const int VS = km + 8;
  bf16* last = Vt + D * VS;                  // k_last[D], v_last[D]: row km of K and of V
  const int W = H * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * L * W + (size_t)h * D;

  for (int idx = threadIdx.x; idx < km * (D / 8); idx += blockDim.x) {
    const int row = idx / (D / 8), c = idx % (D / 8);
    *reinterpret_cast<uint4*>(Ks + row * KS + c * 8) = *reinterpret_cast<const uint4*>(k + base + (size_t)row * W + c * 8);
    const uint4 vv = *reinterpret_cast<const uint4*>(v + base + (size_t)row * W + c * 8);
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * VS + row] = ve[i];
  }
  if (threadIdx.x < 2 * (D / 8)) {
    const int which = threadIdx.x / (D / 8), c = threadIdx.x % (D / 8);
    const bf16* src = which ? v : k;
    *reinterpret_cast<uint4*>(last + which * D + c * 8) =
        *reinterpret_cast<const uint4*>(src + base + (size_t)km * W + c * 8);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QT + warp * 16;
  if (q0 >= L) return;  // no block-wide barrier follows
  const int row_lo = q0 + g, row_hi = q0 + g + 8;

  // Q fragments, scaled and rounded to bf16 as in K1, and the last key's
  // score: each q * k_last product is exact in fp32 (two 8-bit mantissas)
  // and rounded to bf16 on its own before the fp32 sum over the 64 lanes.
  uint32_t qa[D / 16][4];
  float sl_lo = 0.f, sl_hi = 0.f;
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
      const __nv_bfloat162 qs = __floats2bfloat162_rn(lo, hi);
      qa[ks][r] = *reinterpret_cast<const uint32_t*>(&qs);
      const float p0 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(qs.x), __bfloat162float(last[col]))));
      const float p1 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(qs.y), __bfloat162float(last[col + 1]))));
      if (r & 1) sl_hi += p0 + p1; else sl_lo += p0 + p1;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sl_lo += __shfl_xor_sync(0xffffffffu, sl_lo, off);
    sl_hi += __shfl_xor_sync(0xffffffffu, sl_hi, off);
  }

  // Pass 1: row maxima over the main block, then the last key's score.
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int n0 = 0; n0 < km; n0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* kr = Ks + (n0 + g) * KS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
      mma_bf16_16816(s, qa[ks], b0, b1);
    }
    m_lo = fmaxf(m_lo, fmaxf(s[0], s[1]));
    m_hi = fmaxf(m_hi, fmaxf(s[2], s[3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }
  m_lo = fmaxf(m_lo, sl_lo);
  m_hi = fmaxf(m_hi, sl_hi);

  // Pass 2: e = exp(s - m) in fp32, summed by row; bf16(e) feeds the PV product.
  float l_lo = 0.f, l_hi = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int n0 = 0; n0 < km; n0 += 16) {
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
        s[j][e] = expf(s[j][e] - (e < 2 ? m_lo : m_hi));
        if (e < 2) l_lo += s[j][e]; else l_hi += s[j][e];
      }
    }
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
  // The last key: its term joins the row sum after the main block's, and its
  // value row enters as bf16(bf16(e_last) * v_last), one rounded product each.
  const float e_lo = expf(sl_lo - m_lo), e_hi = expf(sl_hi - m_hi);
  l_lo += e_lo;
  l_hi += e_hi;
  const float p_lo = __bfloat162float(__float2bfloat16_rn(e_lo)), p_hi = __bfloat162float(__float2bfloat16_rn(e_hi));
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const bf16* v_last = last + D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    const float v0 = __bfloat162float(v_last[col]), v1 = __bfloat162float(v_last[col + 1]);
    const float t00 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(p_lo, v0)));
    const float t01 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(p_lo, v1)));
    const float t10 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(p_hi, v0)));
    const float t11 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(p_hi, v1)));
    if (row_lo < L)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row_lo * W + col) =
          pack_bf16x2(__fmul_rn(__fadd_rn(acc[dn][0], t00), inv_lo), __fmul_rn(__fadd_rn(acc[dn][1], t01), inv_lo));
    if (row_hi < L)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row_hi * W + col) =
          pack_bf16x2(__fmul_rn(__fadd_rn(acc[dn][2], t10), inv_hi), __fmul_rn(__fadd_rn(acc[dn][3], t11), inv_hi));
  }
}

// K1 for L <= 272: see the file header.  NT = the n8 key tiles of a score row
// (l_valid <= 8 NT, and > 8 (NT - 8) for the smallest instantiation that holds
// it, so only the last 8 tiles can hold a key >= l_valid and select; CAUSAL
// tests every tile that reaches the diagonal).  Block (head, batch) of one
// warpgroup, which walks the head's 64-query tiles; two blocks an SM.
template <int NT, bool CAUSAL>
__global__ void __launch_bounds__(128, 2)
attention_fused_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           bf16* __restrict__ o, int L, int H, int l_valid, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kpad = NT * 8;  // keys staged
  constexpr int EDGE = NT > 10 ? NT - 8 : 0;
  // the hardware's swizzle is a function of the address: the tiles start on a 1024-byte boundary
  unsigned char* Ks = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* Vs = Ks + kpad * TILE_ROW_BYTES;
  const int W = H * D;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * L * W + (size_t)h * D;

  // rows >= l_valid are zero: a masked key's score is never NaN and padding never reaches PV
  stage_head_rows(Ks, k, base, W, kpad, l_valid);
  cp_async_commit();
  stage_head_rows(Vs, v, base, W, kpad, l_valid);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint64_t k_desc = wgmma_desc(smem_u32(Ks)), v_desc = wgmma_desc(smem_u32(Vs));

  cp_async_wait<1>();  // K has landed
  fence_proxy_async();
  __syncthreads();
  uint32_t qraw[D / 16][4];
  load_a_words(qraw, q, base, W, L, warp * 16);
  for (int q0 = 0; q0 < L; q0 += 64) {
    const int wq0 = q0 + warp * 16;  // this warp's 16 rows of the tile
    const int row_lo = wq0 + g, row_hi = wq0 + g + 8;
    // Q fragments, scaled and rounded to bf16 (q * bf16(scale) in the reference), from the raw
    // words loaded a tile ahead
    uint32_t qa[D / 16][4];
    scale_words(qa, qraw, scale);
    float s[NT][4];
    wgmma_fence();
    wgmma_row_kmajor<NT>(s, qa, k_desc);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs<4 * NT>(&s[0][0]);
    load_a_words(qraw, q, base, W, L, wq0 + 64);  // the next tile's rows: the loads fly under this tile's softmax

    uint32_t pa[NT / 2][4];
    float l_lo = 0.f, l_hi = 0.f;
    if (wq0 < L) {  // warp-uniform: a warp with no valid row skips the softmax
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (CAUSAL ? (j * 8 + 8 > l_valid || j * 8 + 7 > wq0) : j >= EDGE) {
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
      const float c_lo = quad_max(m_lo) * LOG2E, c_hi = quad_max(m_hi) * LOG2E;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
          s[j][0] = exp2_approx(fmaf(s[j][0], LOG2E, -c_lo));
          s[j][1] = exp2_approx(fmaf(s[j][1], LOG2E, -c_lo));
          s[j][2] = exp2_approx(fmaf(s[j][2], LOG2E, -c_hi));
          s[j][3] = exp2_approx(fmaf(s[j][3], LOG2E, -c_hi));
          l_lo += s[j][0] + s[j][1];
          l_hi += s[j][2] + s[j][3];
        }
        c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    }
    if (q0 == 0) {
      cp_async_wait<0>();  // V has landed, under the first tile's q k^T and softmax
      fence_proxy_async();
      __syncthreads();
    }
    float acc[D / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_m64n64k16_bt(&acc[0][0], pa[kk], v_desc + desc_rows(16 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs<D / 2>(&acc[0][0]);
    const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
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
}

template <int NT>
int launch_fused(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int l_valid, int causal,
              float scale, void* stream) {
  const int smem = 2 * NT * 8 * TILE_ROW_BYTES + 1024;  // two tiles and the slack to align them
  auto kern = causal ? attention_fused_fwd_kernel<NT, true> : attention_fused_fwd_kernel<NT, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, B), 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      L, H, l_valid, scale);
  return (int)cudaGetLastError();
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

// K1 for L <= 272 (the wrapper checks).  q, k, v, o: contiguous [B, L, H*64]
// bf16 on the device; `scale` is bf16(scale).  Launches on `stream`; returns
// the CUDA error code of the launch (0 on success).
int uniir_attention_fused_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int l_valid,
                              int causal, float scale, void* stream) {
  const int nt = (l_valid + 7) / 8;  // n8 key tiles; the smallest instantiation that holds them
  if (L > 272 || l_valid < 1 || l_valid > L) return (int)cudaErrorInvalidValue;
  if (nt <= 10) return launch_fused<10>(q, k, v, o, B, L, H, l_valid, causal, scale, stream);
  if (nt <= 18) return launch_fused<18>(q, k, v, o, B, L, H, l_valid, causal, scale, stream);
  if (nt <= 26) return launch_fused<26>(q, k, v, o, B, L, H, l_valid, causal, scale, stream);
  return launch_fused<34>(q, k, v, o, B, L, H, l_valid, causal, scale, stream);
}

// The general-length K1: the same tensors and arguments, any L whose K and
// V^T fit one block's shared memory (the wrapper checks).
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

// K10: as uniir_attention_fwd for a non-causal call with l_valid % 128 == 1
// and l_valid > 128 (the wrapper checks); `scale` is bf16(scale) as for K1.
int uniir_attention_splitk_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int l_valid,
                               float scale, void* stream) {
  const int km = l_valid - 1;
  const int smem = km * KS * 2 + D * (km + 8) * 2 + 2 * D * 2;
  cudaError_t err = cudaFuncSetAttribute(attention_splitk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + QT - 1) / QT, H, B);
  attention_splitk_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o), L, H,
      km, scale);
  return (int)cudaGetLastError();
}

const char* uniir_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
