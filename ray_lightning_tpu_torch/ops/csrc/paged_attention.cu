// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_lightning_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (driven by `paged_attention_pallas`): one query token
// per slot, q [C, H, HD], attends over the pool blocks its block table
// names, pool [n_blocks, P, Hkv, HD] bf16, tables [C, M] int32, with the
// mask pad[c] <= kv_pos < lengths[c]; output [C, H, HD] bf16, zeros for a
// slot that sees nothing.
//
// Bound on the H100: bytes. Every visible K and V position is read once
// (2 * length * Hkv * HD * 2 bytes per slot) against 4 FLOPs per byte for
// each of the n_rep query heads that share it, far below the card's ~295
// FLOPs per byte, so the least time is the KV bytes over 3.35 TB/s.
//
// Design: what the TPU kernel ran as a sequential grid over (slot, KV
// block) becomes many small independent thread blocks, because at the
// serving shape (C = 4 slots, Hkv = 8) one block per (slot, KV head)
// would leave most of the 132 SMs idle and each SM short of loads in
// flight. The cache is cut into n_split ranges of 16-position tiles, and
// each (range, KV head, slot) is one single-warp block: its 16 fragment
// rows hold the n_rep query heads of the KV head (GQA in place, the rest
// of the m16 tile idle), and it walks only the tiles of its range that
// hold visible positions, the next tile's loads in flight while this
// tile's tensor-core products run (paged_common.cuh). Each block leaves an
// unnormalised partial (acc, m, l) per query head in f32 scratch; a small
// second kernel (paged_common.cuh `merge_partials`, shared with the
// prefill) merges the n_split partials of each (slot, head) and writes the
// bf16 output.
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ pool_k,
               const __nv_bfloat16* __restrict__ pool_v,
               const int* __restrict__ tables, const int* __restrict__ lengths,
               const int* __restrict__ pad, float* __restrict__ part_acc,
               float* __restrict__ part_ml, int H, int Hkv, int P, int M,
               int n_split, int tps, float scale) {
  using Fetch = rltt::TileFetch<HD, kThreads>;
  __shared__ __align__(16) __nv_bfloat16 sk[rltt::kKeys * Fetch::kStride];
  __shared__ __align__(16) __nv_bfloat16 sv[rltt::kKeys * Fetch::kStride];
  const int sp = blockIdx.x, kvh = blockIdx.y, c = blockIdx.z;
  const int g = threadIdx.x >> 2, tig = threadIdx.x & 3;
  const int n_rep = H / Hkv;
  const int length = lengths[c];
  const int lo = pad[c];

  // fragment rows g and g + 8 are query heads kvh * n_rep + g (+ 8)
  rltt::WarpRows<HD> w;
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = g + 8 * h2;
    w.live[h2] = r < n_rep;
    w.hi[h2] = length;
    qrow[h2] = q + ((int64_t)c * H + kvh * n_rep + (w.live[h2] ? r : 0)) * HD;
  }
  w.init(qrow[0], qrow[1], tig);

  // this split's tiles, cut to those holding visible positions
  const int kv_limit = M * P;
  const int t_end = min((kv_limit + rltt::kKeys - 1) / rltt::kKeys,
                        (sp + 1) * tps);
  const int t_lo = max(sp * tps, lo / rltt::kKeys);
  const int t_hi = min(t_end, (length + rltt::kKeys - 1) / rltt::kKeys);
  const int* trow = tables + (int64_t)c * M;
  Fetch next;
  if (t_lo < t_hi) next.fetch(pool_k, pool_v, trow, P, Hkv, kvh, t_lo, kv_limit);
  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();  // the previous tile is fully consumed
    next.store(sk, sv);
    __syncthreads();
    if (t + 1 < t_hi) next.fetch(pool_k, pool_v, trow, P, Hkv, kvh, t + 1, kv_limit);
    w.tile(sk, sv, t * rltt::kKeys, lo, scale, g, tig);
  }
  w.reduce_l();
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (!w.live[h2]) continue;
    const int64_t idx = ((int64_t)c * H + kvh * n_rep + g + 8 * h2) * n_split + sp;
#pragma unroll
    for (int dt = 0; dt < rltt::WarpRows<HD>::DT; ++dt) {
      float* a = part_acc + idx * HD + dt * 8 + tig * 2;
      a[0] = w.o[dt][2 * h2];
      a[1] = w.o[dt][2 * h2 + 1];
    }
    if (tig == 0) {
      part_ml[idx * 2] = w.m[h2];
      part_ml[idx * 2 + 1] = w.l[h2];
    }
  }
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* tables, const void* lengths, const void* pad,
           void* part_acc, void* part_ml, void* out, int C, int H, int Hkv,
           int P, int M, int n_split, int tps, float scale, cudaStream_t stream) {
  const dim3 grid(n_split, Hkv, C);
  decode_partial<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(pad),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, Hkv, P, M,
      n_split, tps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rltt::merge_partials<HD><<<C * H, HD, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launches (0 = ok).
// `pad` is never null (the wrapper passes zeros). `tps` is the number of
// 16-position tiles per split. Scratch: part_acc [C, H, n_split, HD] f32,
// part_ml [C, H, n_split, 2] f32.
extern "C" int paged_decode_bf16(const void* q, const void* pool_k,
                                 const void* pool_v, const void* tables,
                                 const void* lengths, const void* pad,
                                 void* part_acc, void* part_ml, void* out,
                                 int C, int H, int Hkv, int HD, int P, int M,
                                 int n_split, int tps, float scale,
                                 void* stream) {
  if (H % Hkv != 0 || H / Hkv > 16 || P < 1 || n_split < 1 || tps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(q, pool_k, pool_v, tables, lengths, pad, part_acc, part_ml,
                       out, C, H, Hkv, P, M, n_split, tps, scale, st);
  if (HD == 64)
    return launch<64>(q, pool_k, pool_v, tables, lengths, pad, part_acc, part_ml,
                      out, C, H, Hkv, P, M, n_split, tps, scale, st);
  return (int)cudaErrorInvalidValue;
}
