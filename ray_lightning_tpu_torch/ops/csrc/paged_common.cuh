// Device code shared by the two paged-attention kernels
// (paged_attention.cu: decode, paged_prefill.cu: chunked prefill).
//
// `merge_partials` serves the prefill, which may cut a row's cache walk
// into n_split ranges, each left by its block as an unnormalised partial
// (acc, m, l) per query row in f32 scratch, [rows, n_split, HD] and
// [rows, n_split, 2]; it combines them and writes the bf16 output. (The
// decode merges its ranges inside one cluster, in shared memory.)
//
// `WarpRows` serves the decode: a warp owns 16 query rows, one m16 tile of
// the tensor-core product (mma.sync m16n8k16, bf16 in, f32 accumulate);
// rows are the query heads that share the KV head (GQA in place: each K/V
// tile is read once for all of them), and it folds in 16-position tiles
// of K and V staged in shared memory with padded rows, read by ldmatrix.
//
// Masking follows the TPU kernels: invisible scores take the -1e30
// sentinel BEFORE the running max, and their probabilities are zeroed
// explicitly (a fully masked tile would otherwise give
// exp(-1e30 - -1e30) = 1 and weight scratch garbage at full probability).
// The running max and sum stay f32; the unnormalised probabilities are
// rounded to bf16 for the PV product, as the masked-SDPA reference rounds
// its probabilities.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rltt {

constexpr float kNegInf = -1e30f;  // never true -inf: exp(-inf - -inf) = nan
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8, and gets in r[j] its fragment of matrix j
// (rows lane / 4, columns 2 (lane % 4) and + 1; with .trans the matrix is
// read transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// One warp's 16 query rows: lane (g, tig) = (lane / 4, lane % 4) holds
// fragment rows g and g + 8. Each row sees cache positions lo <= kv < hi.
// Scores are kept pre-scaled by scale * log2(e), so m is in log2 units and
// the exponentials are exp2f.
template <int HD>
struct WarpRows {
  static constexpr int KK = HD / 16;  // k-steps of the QK^T product
  static constexpr int DT = HD / 8;   // n-tiles of the PV product
  static constexpr int kStride = HD + 8;
  uint32_t qf[KK][4];
  float o[DT][4];
  float m[2], l[2];
  int hi[2];
  bool live[2];

  // q rows for fragment rows g and g + 8 (read only where live)
  __device__ __forceinline__ void init(const __nv_bfloat16* qa,
                                       const __nv_bfloat16* qb, int tig) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int d = kk * 16 + tig * 2;
      qf[kk][0] = live[0] ? ld2(qa + d) : 0u;
      qf[kk][1] = live[1] ? ld2(qb + d) : 0u;
      qf[kk][2] = live[0] ? ld2(qa + d + 8) : 0u;
      qf[kk][3] = live[1] ? ld2(qb + d + 8) : 0u;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // Fold in the 16 cache positions kv0 .. kv0 + 15 staged at sk and sv
  // ([16][kStride] each); the K and V fragments come by ldmatrix.
  __device__ __forceinline__ void tile(const __nv_bfloat16* __restrict__ sk,
                                       const __nv_bfloat16* __restrict__ sv,
                                       int kv0, int lo, float scale_log2, int lane) {
    const int g = lane >> 2, tig = lane & 3, r8 = lane & 7, mi = lane >> 3;
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {  // S = Q K^T, two n-tiles of 8 keys
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < KK / 2; ++k2) {  // two k-steps a load
        uint32_t b[4];
        ldsm_x4(b, sk + (nt * 8 + r8) * kStride + k2 * 32 + mi * 8);
        mma_bf16(s[nt], qf[2 * k2], b[0], b[1]);
        mma_bf16(s[nt], qf[2 * k2 + 1], b[2], b[3]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kv = kv0 + nt * 8 + tig * 2 + e;
          const bool vis = live[h2] && kv >= lo && kv < hi[h2];
          float& x = s[nt][2 * h2 + e];
          x = vis ? x * scale_log2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));  // the row's 4 lanes
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      corr[h2] = exp2f(m[h2] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * h2 + e];
          x = x == kNegInf ? 0.f : exp2f(x - m_new);
          sum += x;
        }
      }
      l[h2] = l[h2] * corr[h2] + sum;  // this lane's part; see reduce_l
      m[h2] = m_new;
    }
    // O = O * corr + P V, P taken straight from the S fragments, V's
    // fragments by a transposing ldmatrix (two n-tiles a load)
    const uint32_t pf[4] = {pack2(s[0][0], s[0][1]), pack2(s[0][2], s[0][3]),
                            pack2(s[1][0], s[1][1]), pack2(s[1][2], s[1][3])};
#pragma unroll
    for (int d2 = 0; d2 < DT / 2; ++d2) {
      uint32_t b[4];
      ldsm_x4_t(b, sv + ((mi & 1) * 8 + r8) * kStride + (2 * d2 + (mi >> 1)) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float(&od)[4] = o[2 * d2 + j];
        od[0] *= corr[0];
        od[1] *= corr[0];
        od[2] *= corr[1];
        od[3] *= corr[1];
        mma_bf16(od, pf, b[2 * j], b[2 * j + 1]);
      }
    }
  }

  // Sum each row's l over its 4 lanes (after the last tile).
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      l[h2] += __shfl_xor_sync(kFull, l[h2], 1);
      l[h2] += __shfl_xor_sync(kFull, l[h2], 2);
    }
  }
};

// Merge the n_split partials of one query row (blockIdx.x: a decode
// slot's head, or a prefill token's head), one thread per head-dim
// element; m is in natural-log units. An empty split holds m = -1e30,
// l = 0, acc = 0 and weighs nothing; a row that saw nothing anywhere
// writes zeros.
template <int HD>
__global__ void __launch_bounds__(HD)
merge_partials(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               __nv_bfloat16* __restrict__ out, int n_split) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float wgt = expf(ml[2 * s] - mx);
    l = fmaf(wgt, ml[2 * s + 1], l);
    a = fmaf(wgt, part_acc[(row * n_split + s) * HD + d], a);
  }
  out[row * HD + d] = __float2bfloat16(l == 0.f ? 0.f : a / l);
}

}  // namespace rltt
