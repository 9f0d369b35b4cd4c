// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_lightning_tpu/ops/pallas/paged_prefill.py
// `_prefill_kernel` (driven by `paged_prefill_pallas`): each group row b
// brings a CH-token query chunk, q [B, CH, H, HD] bf16, whose token j sits
// at cache position pos + j and attends causally to that row's table-named
// pool blocks, pool [n_blocks, P, Hkv, HD] bf16, tables [B, M] int32, with
// the mask pad[b] <= kv_pos <= pos + j. The chunk's own K/V is already in
// the pool (write-then-attend). A query that is itself a pad column sees
// nothing and writes zeros. Output [B, CH, H, HD] bf16.
//
// Bound on the H100: operations at the serving chunk. Each K/V element
// pair (4 bytes) meets 4 FLOPs for each of the CH * n_rep query rows that
// see it; at CH = 128, n_rep = 4 that is ~512 FLOPs per byte read, above
// the card's ~295, so the least time is the FLOPs over 989 TFLOP/s (the
// smoke script computes both bounds per shape and names the larger).
//
// Design: both products run on the tensor cores (paged_common.cuh),
// flash-attention-2 style. One thread block per (query tile, KV head,
// group row) holds 64 query rows: the 64 / n_rep chunk tokens of the tile
// times the n_rep query heads that share the KV head, so each K/V tile is
// read once for all of them. Each of its four warps owns 16 rows, whose Q
// fragments, output accumulator and online-softmax state stay in registers
// for the whole walk. The block walks the row's cache from the first tile
// not wholly under the pad to the last one its final query may see, the
// next tile's loads in flight while this tile's products run. Nothing is
// carried between blocks, so there is no second pass.
#include "paged_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block

template <int HD>
__global__ void __launch_bounds__(kThreads)
prefill_mma(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ pool_k,
            const __nv_bfloat16* __restrict__ pool_v,
            const int* __restrict__ tables, const int* __restrict__ pad,
            __nv_bfloat16* __restrict__ out, int CH, int H, int Hkv, int P,
            int M, int pos, int bq, float scale) {
  using Fetch = rltt::TileFetch<HD, kThreads>;
  __shared__ __align__(16) __nv_bfloat16 sk[rltt::kKeys * Fetch::kStride];
  __shared__ __align__(16) __nv_bfloat16 sv[rltt::kKeys * Fetch::kStride];
  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int n_rep = H / Hkv;
  const int j0 = qt * bq;
  const int lo = pad[b];

  // fragment rows g and g + 8 of this warp: row r of the tile is chunk
  // token j0 + r / n_rep, query head kvh * n_rep + r % n_rep
  rltt::WarpRows<HD> w;
  __nv_bfloat16* orow[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = warp * 16 + g + 8 * h2;
    const int j = j0 + r / n_rep;
    w.live[h2] = r < bq * n_rep && j < CH;
    w.hi[h2] = pos + j + 1;  // causal: sees positions <= pos + j
    const int64_t off = (((int64_t)b * CH + (w.live[h2] ? j : 0)) * H
                         + kvh * n_rep + r % n_rep) * HD;
    qrow[h2] = q + off;
    orow[h2] = out + off;
  }
  w.init(qrow[0], qrow[1], tig);

  const int q_end = pos + min(CH, j0 + bq) - 1;  // the tile's last query
  const int kv_limit = M * P;
  const int t_lo = lo / rltt::kKeys;
  const int t_hi = min((kv_limit + rltt::kKeys - 1) / rltt::kKeys,
                       q_end / rltt::kKeys + 1);
  const int* trow = tables + (int64_t)b * M;
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
    const float inv = w.l[h2] == 0.f ? 0.f : 1.f / w.l[h2];
#pragma unroll
    for (int dt = 0; dt < rltt::WarpRows<HD>::DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow[h2] + dt * 8 + tig * 2) =
          rltt::pack2(w.o[dt][2 * h2] * inv, w.o[dt][2 * h2 + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* tables, const void* pad, void* out, int B, int CH, int H,
           int Hkv, int P, int M, int pos, int bq, float scale,
           cudaStream_t stream) {
  const dim3 grid((CH + bq - 1) / bq, Hkv, B);
  prefill_mma<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(pad), static_cast<__nv_bfloat16*>(out), CH, H, Hkv, P,
      M, pos, bq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// `pad` is never null (the wrapper passes zeros); bq * (H / Hkv) <= 64.
extern "C" int paged_prefill_bf16(const void* q, const void* pool_k,
                                  const void* pool_v, const void* tables,
                                  const void* pad, void* out, int B, int CH,
                                  int H, int Hkv, int HD, int P, int M, int pos,
                                  int bq, float scale, void* stream) {
  if (H % Hkv != 0 || bq < 1 || bq * (H / Hkv) > kRows || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(q, pool_k, pool_v, tables, pad, out, B, CH, H, Hkv, P, M,
                       pos, bq, scale, st);
  if (HD == 64)
    return launch<64>(q, pool_k, pool_v, tables, pad, out, B, CH, H, Hkv, P, M,
                      pos, bq, scale, st);
  return (int)cudaErrorInvalidValue;
}
