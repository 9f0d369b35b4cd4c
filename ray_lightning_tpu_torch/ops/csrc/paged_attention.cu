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
// FLOPs per byte, so the least time is the visible K/V bytes over
// 3.35 TB/s (7.8 us at the serving shape: 4 slots of 4096 / 1537 / 700 /
// 33 positions, 8 KV heads of 128). What stands between a kernel and that
// bound is bytes in flight, work spread over the SMs, and fixed costs
// (launches, q loads, partial writes) against little work. The design:
//
//   1. One launch per call. Each (slot, KV head) is one thread-block
//      cluster of R blocks (R from the wrapper's `decode_plan`: 8 at the
//      serving shape, where 16 measured slower; at most 16, and above 8
//      the cluster is non-portable). Each block walks one run of
//      the cache and leaves its partial (acc, m, l) for the n_rep query
//      heads in its own shared memory; after a cluster barrier every block
//      reads its peers' partials through distributed shared memory, merges
//      its share of the output elements in range order and writes them in
//      bf16. No f32 scratch in device memory, no second kernel, and the
//      result does not depend on which block finishes first.
//   2. Ranges from the device's lengths. A block reads lengths[c] and
//      pad[c] and cuts the visible span [pad, length) into R near-equal
//      runs of whole 64-position tiles (`run_of`, twin of the wrapper's
//      `decode_ranges`); it walks only its own run, so no block walks
//      positions that no head can see, and an empty run does no loads and
//      contributes (m = -1e30, l = 0).
//   3. A deep walk. A block first stages its run's block-table entries in
//      shared memory in one coalesced read, so the table lookup leaves the
//      inner loop. Each of its four warps owns 16 positions of every tile
//      and keeps a ring of its sub-tiles in flight: each lane issues one
//      `cp.async.bulk` of a 256-byte K or V row into padded shared memory,
//      completing on the warp's own mbarrier for that stage, so no warp
//      ever waits on another during the walk (no per-tile
//      __syncthreads). The ring is two tiles deep: 72 KB a block, so
//      three blocks fit an SM and an H100 holds 45 clusters of 8 at once,
//      all 32 of the serving call. Three tiles (107 KB, two blocks an SM)
//      leave room for 30, so the call runs in two waves: no faster at the
//      serving shape and slower where little is visible (chip_variants.py
//      "3 stages"; PERF.md). Per SM the bytes in flight are the same,
//      3 blocks x 2 tiles x 32 KB.
//
// A warp holds the n_rep query heads of its KV head as the rows of one
// m16 tile of mma.sync m16n8k16 (paged_common.cuh `WarpRows`): the
// product is not the limit, so wgmma's 64-row tiles would only idle. The
// four warps' partials merge in shared memory before the cluster merge.
#include <cooperative_groups.h>

#include "hopper_common.cuh"
#include "paged_common.cuh"

namespace {

namespace cg = cooperative_groups;
using rltt::sm90::fence_barrier_init;
using rltt::sm90::kLog2e;
using rltt::sm90::fence_proxy_async;
using rltt::sm90::mbar_arrive_expect_tx;
using rltt::sm90::mbar_init;
using rltt::sm90::mbar_wait;
using rltt::sm90::smem_u32;

template <int HD>
struct Decode {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = 64;     // cache positions per tile, 16 a warp
  static constexpr int kStages = 2;    // tiles in flight per warp (see 3. above)
  static constexpr int kMaxRanges = 16;
  static constexpr int kStride = HD + 8;  // bf16 per staged row (bank padding)
  static constexpr int kRowBytes = HD * 2;
  static constexpr int kKVBytes = kTile * kStride * 2;  // K (or V) of a stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kTab = 512;  // staged table entries
  static constexpr int kSmem = kRing + kTab * 4 + kWarps * kStages * 8;
  // after the walk the ring holds the merge's partials (f32): per warp
  // [16 rows][HD] acc and [16][2] (m, l), then the block's own
  static constexpr int kWarpAcc = 0;
  static constexpr int kWarpML = kWarpAcc + kWarps * 16 * HD * 4;
  static constexpr int kBlockAcc = kWarpML + kWarps * 16 * 2 * 4;
  static constexpr int kBlockML = kBlockAcc + 16 * HD * 4;
  static_assert(kBlockML + 16 * 2 * 4 <= kRing, "the merge fits in the ring");
};

// One `bytes`-long row from device memory into this block's shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_row(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Tiles [lo, hi) of run `r` of `R` over the visible span [pad, length) of
// a cache of `kv_limit` positions (twin: paged_attention.py
// `decode_ranges`).
template <int kTile>
__device__ __forceinline__ int2 run_of(int length, int pad, int kv_limit, int r, int R) {
  const int lo = max(pad, 0), hi = max(0, min(length, kv_limit));
  const int t0 = lo / kTile;
  const int n = hi > lo ? (hi + kTile - 1) / kTile - t0 : 0;
  return make_int2(t0 + r * n / R, t0 + (r + 1) * n / R);
}

template <int HD>
__global__ void __launch_bounds__(Decode<HD>::kThreads)
decode_cluster(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ pool_k,
               const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ tables,
               const int* __restrict__ lengths, const int* __restrict__ pad,
               __nv_bfloat16* __restrict__ out, int H, int Hkv, int P, int M, float scale_log2) {
  using D = Decode<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y, c = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int n_rep = H / Hkv;
  const int kv_limit = M * P;
  const int lo = max(pad[c], 0), hi = max(0, min(lengths[c], kv_limit));
  const int2 run = run_of<D::kTile>(lengths[c], pad[c], kv_limit, rank, R);
  const int t_lo = run.x, n_tiles = run.y - run.x;

  // fragment rows g and g + 8 are query heads kvh * n_rep + g (+ 8); their
  // q loads are in flight while the table is staged
  rltt::WarpRows<HD> w;
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = g + 8 * h2;
    w.live[h2] = r < n_rep;
    w.hi[h2] = hi;
    qrow[h2] = q + ((int64_t)c * H + kvh * n_rep + (w.live[h2] ? r : 0)) * HD;
  }
  w.init(qrow[0], qrow[1], tig);

  // the run's table entries, staged once (the first kTab; a longer run,
  // which only P < 8 at 4096 positions gives, reads the rest from L2)
  int* stab = reinterpret_cast<int*>(smem + D::kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D::kRing + D::kTab * 4) + warp * D::kStages;
  const int* trow = tables + (int64_t)c * M;
  const int e0 = t_lo * D::kTile / P;
  const int n_e =
      n_tiles > 0 ? min(D::kTab, (min(run.y * D::kTile, kv_limit) - 1) / P + 1 - e0) : 0;
  for (int i = threadIdx.x; i < n_e; i += D::kThreads) stab[i] = trow[e0 + i];
  if (lane < D::kStages) mbar_init(&full[lane], 1);
  fence_barrier_init();
  __syncthreads();

  // tile i of the run into stage i % kStages: lane l brings row l % 16 of
  // this warp's 16 positions, of K (l < 16) or V. Positions past the
  // table repeat its last row (finite, and masked).
  auto issue = [&](int i) {
    uint64_t* bar = &full[i % D::kStages];
    if (lane == 0) mbar_arrive_expect_tx(bar, 32 * D::kRowBytes);
    __syncwarp();
    const int row = 16 * warp + (lane & 15);
    const int kv = min((t_lo + i) * D::kTile + row, kv_limit - 1);
    const int e = kv / P;
    const int blk = e - e0 < D::kTab ? stab[e - e0] : __ldg(trow + e);
    const int64_t src = ((int64_t)blk * P + kv % P) * Hkv + kvh;
    unsigned char* dst = smem + (i % D::kStages) * D::kStageBytes + (lane < 16 ? 0 : D::kKVBytes) +
                         row * D::kStride * 2;
    fence_proxy_async();  // this stage's earlier reads come before the copy
    bulk_row(dst, (lane < 16 ? pool_k : pool_v) + src * HD, D::kRowBytes, bar);
  };

  for (int i = 0; i < n_tiles && i < D::kStages; ++i) issue(i);
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(&full[i % D::kStages], (i / D::kStages) & 1);
    const __nv_bfloat16* sk = reinterpret_cast<const __nv_bfloat16*>(
                                  smem + (i % D::kStages) * D::kStageBytes) +
                              16 * warp * D::kStride;
    w.tile(sk, sk + D::kKVBytes / 2, (t_lo + i) * D::kTile + 16 * warp, lo, scale_log2, lane);
    __syncwarp();  // every lane is done with the stage before it refills
    if (i + D::kStages < n_tiles) issue(i + D::kStages);
  }
  w.reduce_l();

  // the four warps' partials, merged in warp order into the block's
  __syncthreads();  // every warp is done with the ring
  float* wacc = reinterpret_cast<float*>(smem + D::kWarpAcc);
  float* wml = reinterpret_cast<float*>(smem + D::kWarpML);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = g + 8 * h2;
    if (r >= n_rep) continue;
    float* a = wacc + (warp * 16 + r) * HD + tig * 2;
#pragma unroll
    for (int dt = 0; dt < rltt::WarpRows<HD>::DT; ++dt) {
      a[dt * 8] = w.o[dt][2 * h2];
      a[dt * 8 + 1] = w.o[dt][2 * h2 + 1];
    }
    if (tig == 0) {
      wml[(warp * 16 + r) * 2] = w.m[h2];
      wml[(warp * 16 + r) * 2 + 1] = w.l[h2];
    }
  }
  __syncthreads();
  float* bacc = reinterpret_cast<float*>(smem + D::kBlockAcc);
  float* bml = reinterpret_cast<float*>(smem + D::kBlockML);
  const int n_out = n_rep * HD;
  for (int e = threadIdx.x; e < n_out; e += D::kThreads) {
    const int r = e / HD;
    float mx = rltt::kNegInf;
#pragma unroll
    for (int k = 0; k < D::kWarps; ++k) mx = fmaxf(mx, wml[(k * 16 + r) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int k = 0; k < D::kWarps; ++k) {
      const float wgt = exp2f(wml[(k * 16 + r) * 2] - mx);
      l = fmaf(wgt, wml[(k * 16 + r) * 2 + 1], l);
      a = fmaf(wgt, wacc[(k * 16 + r) * HD + e % HD], a);
    }
    bacc[e] = a;
    if (e % HD == 0) {
      bml[2 * r] = mx;
      bml[2 * r + 1] = l;
    }
  }

  // the cluster's R partials, merged in range order: this block writes
  // output elements [rank * share, (rank + 1) * share) of the n_rep heads
  cluster.sync();  // every block's partial is in its shared memory
  const int share = (n_out + R - 1) / R;
  for (int e = rank * share + threadIdx.x; e < min(n_out, (rank + 1) * share);
       e += D::kThreads) {
    const int r = e / HD;
    float pm[D::kMaxRanges], pl[D::kMaxRanges], pa[D::kMaxRanges];
#pragma unroll
    for (int s = 0; s < D::kMaxRanges; ++s) {
      if (s >= R) break;
      const float* peer_ml = cluster.map_shared_rank(bml, s);
      pm[s] = peer_ml[2 * r];
      pl[s] = peer_ml[2 * r + 1];
      pa[s] = cluster.map_shared_rank(bacc, s)[e];
    }
    float mx = rltt::kNegInf;
#pragma unroll
    for (int s = 0; s < D::kMaxRanges; ++s)
      if (s < R) mx = fmaxf(mx, pm[s]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < D::kMaxRanges; ++s) {
      if (s < R) {
        const float wgt = exp2f(pm[s] - mx);
        l = fmaf(wgt, pl[s], l);
        a = fmaf(wgt, pa[s], a);
      }
    }
    out[((int64_t)c * H + kvh * n_rep + r) * HD + e % HD] = __float2bfloat16(l == 0.f ? 0.f : a / l);
  }
  cluster.sync();  // peers may still be reading this block's partial
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* tables,
           const void* lengths, const void* pad, void* out, int C, int H, int Hkv, int P, int M,
           int R, float scale, cudaStream_t stream) {
  using D = Decode<HD>;
  static bool smem_set = false, wide_set = false;
  if (int err = rltt::sm90_host::allow_smem(decode_cluster<HD>, D::kSmem, smem_set)) return err;
  if (R > 8 && !wide_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_cluster<HD>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, Hkv, C);
  cfg.blockDim = dim3(D::kThreads);
  cfg.dynamicSmemBytes = D::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_cluster<HD>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k), static_cast<const __nv_bfloat16*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const int*>(pad), static_cast<__nv_bfloat16*>(out), H, Hkv, P, M,
      scale * kLog2e);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok). `pad`
// is never null (the wrapper passes zeros). Each (slot, KV head) is one
// cluster of `ranges` blocks, 1 <= ranges <= 16.
extern "C" int paged_decode_bf16(const void* q, const void* pool_k, const void* pool_v,
                                 const void* tables, const void* lengths, const void* pad,
                                 void* out, int C, int H, int Hkv, int HD, int P, int M,
                                 int ranges, float scale, void* stream) {
  if (C < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 || P < 1 || M < 1 || C > 65535 ||
      Hkv > 65535 || ranges < 1 || ranges > Decode<128>::kMaxRanges)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(q, pool_k, pool_v, tables, lengths, pad, out, C, H, Hkv, P, M, ranges,
                       scale, st);
  if (HD == 64)
    return launch<64>(q, pool_k, pool_v, tables, lengths, pad, out, C, H, Hkv, P, M, ranges, scale,
                      st);
  return (int)cudaErrorInvalidValue;
}
