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
// Design. One block per (KV range, query tile, KV head, group row) is one
// warpgroup holding 64 query rows: the 64 / n_rep chunk tokens of the tile
// times the n_rep query heads that share the KV head, so each K/V tile is
// read once for all of them. At the serving chunk one block per (query
// tile, KV head) would be 64 blocks for 132 SMs, each walking the whole
// cache alone; so, as in the decode, the walk is split into n_split ranges
// of 64-position tiles (ops/kernels/paged_prefill.py `split_plan`), each
// block leaves an unnormalised partial (acc, m, l) per row in f32 scratch,
// and paged_common.cuh `merge_partials` combines them. With one range the
// block writes the output itself and no merge is launched.
//   * Tiles arrive by cp.async, 16 bytes a thread, two stages deep, into
//     the 128-byte-swizzled layout wgmma reads (hopper_common.cuh); each
//     row's pool block is looked up in the row's table, so any block size
//     works. The Q tile comes the same way with the first tile.
//   * S = Q K^T on wgmma with both operands in shared memory; the online
//     softmax once per tile in f32 registers on scores pre-scaled by
//     scale * log2(e) (exp2f), mask arithmetic only on tiles that cross
//     the pad, the diagonal or the table's end; the probabilities rounded
//     to bf16 in registers as the A operand of O += P V, whose B operand is
//     the V tile read MN-major.
#include "hopper_common.cuh"
#include "paged_common.cuh"

namespace {

using namespace rltt::sm90;

template <int HD>
struct Prefill {
  static constexpr int kRows = 64;    // query rows per block: one warpgroup
  static constexpr int kN = 64;       // cache positions per KV tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kKVBytes = kN * HD * 2;  // one of K or V
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
};

template <int HD>
__global__ void __launch_bounds__(Prefill<HD>::kThreads)
prefill_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ pool_k,
              const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ tables,
              const int* __restrict__ pad, float* __restrict__ part_acc,
              float* __restrict__ part_ml, __nv_bfloat16* __restrict__ out, int CH, int H,
              int Hkv, int P, int M, int pos, int bq, int n_split, int tps,
              float scale_log2) {
  using C = Prefill<HD>;
  constexpr int kVec = HD / 8;  // 16-byte chunks in a row
  unsigned char* smem = smem_base();
  const uint32_t q_addr = smem_u32(smem);       // [HD / 64][kRows][64]
  const uint32_t kv_addr = q_addr + C::kQBytes;  // stage s: K then V, [HD / 64][kN][64] each
  const int sp = blockIdx.x, qt = blockIdx.y;
  const int kvh = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_rep = H / Hkv;
  const int j0 = qt * bq;
  const int lo = pad[b];
  const int kv_limit = M * P;
  const int* trow = tables + (int64_t)b * M;

  // fragment rows g and g + 8 of this warp: row r of the tile is chunk
  // token j0 + r / n_rep, query head kvh * n_rep + r % n_rep; it sees
  // positions lo <= kv < hi
  int hi[2];
  bool live[2];
  int64_t row_id[2];  // (b * CH + j) * H + head
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = warp * 16 + g + 8 * h2;
    const int j = j0 + r / n_rep;
    live[h2] = r < bq * n_rep && j < CH;
    hi[h2] = live[h2] ? min(kv_limit, pos + j + 1) : 0;
    row_id[h2] = ((int64_t)b * CH + j) * H + kvh * n_rep + r % n_rep;
  }

  // this range's tiles, cut to those holding positions a row may see
  const int hi_max = min(kv_limit, pos + min(CH, j0 + bq));
  const int hi_min = min(kv_limit, pos + j0 + 1);  // the block's first token's
  const int t_lo = max(sp * tps, lo / C::kN);
  const int t_hi = min((sp + 1) * tps, (hi_max + C::kN - 1) / C::kN);

  auto load_tile = [&](int t, int s) {
    const uint32_t k_dst = kv_addr + s * 2 * C::kKVBytes, v_dst = k_dst + C::kKVBytes;
#pragma unroll
    for (int it = 0; it < C::kN * kVec / C::kThreads; ++it) {
      const int i = threadIdx.x + it * C::kThreads;
      const int r = i / kVec, c = i % kVec;
      const int kv = t * C::kN + r;
      const bool ok = kv < kv_limit;
      const int64_t row = ok ? ((int64_t)trow[kv / P] * P + kv % P) * Hkv + kvh : 0;
      cp_async16(k_dst + swizzled(C::kN, r, c), pool_k + row * HD + c * 8, ok);
      cp_async16(v_dst + swizzled(C::kN, r, c), pool_v + row * HD + c * 8, ok);
    }
  };

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (t_lo < t_hi) {
    // the Q tile travels with the first KV tile
#pragma unroll
    for (int it = 0; it < C::kRows * kVec / C::kThreads; ++it) {
      const int i = threadIdx.x + it * C::kThreads;
      const int r = i / kVec, c = i % kVec;
      const int j = j0 + r / n_rep;
      const bool ok = r < bq * n_rep && j < CH;
      const __nv_bfloat16* src =
          q + (((int64_t)b * CH + (ok ? j : 0)) * H + kvh * n_rep + r % n_rep) * HD + c * 8;
      cp_async16(q_addr + swizzled(C::kRows, r, c), src, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < C::kStages; ++s) {
    if (t_lo + s < t_hi) load_tile(t_lo + s, s);
    cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int s = (t - t_lo) % C::kStages;
    cp_async_wait<C::kStages - 1>();  // tile t (and Q) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t k_addr = kv_addr + s * 2 * C::kKVBytes;
    const uint32_t v_addr = k_addr + C::kKVBytes;
    const int kv0 = t * C::kN;

    float sc[C::kN / 2];
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, desc_k(q_addr, C::kRows, kk), desc_k(k_addr, C::kN, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the online softmax, once per tile, in log2 units
    const bool edge = kv0 < lo || kv0 + C::kN > hi_min;
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h2 + e];
          const int kv = kv0 + 8 * j + 2 * t4 + e;
          x *= scale_log2;
          if (edge && (kv < lo || kv >= hi[h2])) x = kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the row's 4 lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      corr[h2] = exp2f(m[h2] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h2 + e];
          x = edge && x == kNegInf ? 0.f : exp2f(x - m_new);
          sum += x;
        }
      l[h2] = l[h2] * corr[h2] + sum;  // this lane's part; summed at the end
      m[h2] = m_new;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P from registers, V MN-major from shared memory
    uint32_t pf[C::kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::kN / 16; ++kk) to_a(sc, kk, pf[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kN / 16; ++kk) wgmma_rs(acc, pf[kk], desc_mn(v_addr, C::kN, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every warp is done with stage s
    if (t + C::kStages < t_hi) load_tile(t + C::kStages, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (!live[h2]) continue;
    if (n_split == 1) {  // the whole walk: normalise and write
      const float inv = l[h2] == 0.f ? 0.f : 1.f / l[h2];
      __nv_bfloat16* orow = out + row_id[h2] * HD + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack2(acc[4 * j + 2 * h2] * inv, acc[4 * j + 2 * h2 + 1] * inv);
      continue;
    }
    const int64_t idx = row_id[h2] * n_split + sp;
    float* a = part_acc + idx * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(a + 8 * j) = make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
    if (t4 == 0) {  // m in natural-log units, as merge_partials reads it
      part_ml[idx * 2] = m[h2] == kNegInf ? kNegInf : m[h2] * kLn2;
      part_ml[idx * 2 + 1] = l[h2];
    }
  }
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* tables,
           const void* pad, void* part_acc, void* part_ml, void* out, int B, int CH, int H,
           int Hkv, int P, int M, int pos, int bq, int n_split, int tps, float scale,
           cudaStream_t stream) {
  using C = Prefill<HD>;
  static bool configured = false;
  if (int err = rltt::sm90_host::allow_smem(prefill_wgmma<HD>, C::kSmem, configured)) return err;
  const dim3 grid(n_split, (CH + bq - 1) / bq, Hkv * B);
  prefill_wgmma<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(pad), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), CH, H, Hkv, P, M, pos, bq, n_split, tps,
      scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  rltt::merge_partials<HD><<<B * CH * H, HD, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launches (0 = ok).
// `pad` is never null (the wrapper passes zeros); bq * (H / Hkv) <= 64.
// The walk is cut into n_split ranges of `tps` 64-position tiles; with
// n_split > 1 the scratch part_acc [B, CH, H, n_split, HD] f32 and part_ml
// [B, CH, H, n_split, 2] f32 take the partials and a merge kernel follows.
extern "C" int paged_prefill_bf16(const void* q, const void* pool_k, const void* pool_v,
                                  const void* tables, const void* pad, void* part_acc,
                                  void* part_ml, void* out, int B, int CH, int H, int Hkv,
                                  int HD, int P, int M, int pos, int bq, int n_split, int tps,
                                  float scale, void* stream) {
  if (B < 1 || CH < 1 || Hkv < 1 || H % Hkv != 0 || bq < 1 || bq * (H / Hkv) > 64 || P < 1 ||
      pos < 0 || n_split < 1 || tps < 1 || Hkv * B > 65535 ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(q, pool_k, pool_v, tables, pad, part_acc, part_ml, out, B, CH, H, Hkv, P,
                       M, pos, bq, n_split, tps, scale, st);
  if (HD == 64)
    return launch<64>(q, pool_k, pool_v, tables, pad, part_acc, part_ml, out, B, CH, H, Hkv, P, M,
                      pos, bq, n_split, tps, scale, st);
  return (int)cudaErrorInvalidValue;
}
