// Flash-attention backward for Hopper (sm_90a): two kernels, two passes.
//
// Replace the TPU kernels ray_lightning_tpu/ops/pallas/flash.py
// `_bwd_dkv_kernel` (pass 1 of `_bwd`) and `_bwd_dq_kernel` (pass 2). Both
// recompute the probabilities from the forward's lse, P = exp(S * scale -
// lse) with S = Q K^T (zero where masked), and with dP = dO V^T and
// dS = P * (dP - delta) * scale, where delta = rowsum(dO * O) is computed
// outside (one torch reduction, as the TPU wrapper computes it outside):
//
//   pass 1 (flash_bwd_dkv): dV = P^T dO, dK = dS^T Q, per KV tile;
//   pass 2 (flash_bwd_dq):  dQ = dS K, per query tile.
//
// Layouts as flash_fwd.cu: q, o, do, dq [B, Sq, H, HD]; k, v, dk, dv
// [B, Sk, Hkv, HD] bf16; lse and delta [B, H, Sq] f32.
//
// Bound on the H100: operations. Pass 1 does four products over every
// visible (query, key) pair and pass 2 three, 2 * HD FLOPs each; both
// read each K/V element once per visible query row, far above the card's
// ~295 FLOPs per byte at the training shape.
//
// Design. The TPU grid carries each accumulator in VMEM scratch across an
// inner grid axis; here a block owns its output tile and loops over the
// other axis itself, so nothing crosses blocks and no atomics are needed
// (the backward is deterministic, as on the TPU).
//
//   * dK/dV: one block per (64-key tile, KV head, batch row). It walks all
//     n_rep query heads that share the KV head and every query tile that
//     can see its keys (the causal skip), so dK and dV are summed over the
//     GQA group in f32 registers and written once at [B, Sk, Hkv, HD]; the
//     TPU kernel writes per-query-head [B, H, Sk, HD] and sums outside. A
//     warp owns 16 keys: S^T = K Q^T and dP^T = V dO^T put keys on the
//     fragment rows, so P^T and dS^T leave the accumulators already in the
//     A-operand layout of dV += P^T dO and dK += dS^T Q (no shared-memory
//     round trip). Each query tile (Q, dO, lse, delta) arrives by cp.async
//     two stages deep and is consumed 16 query rows at a time.
//   * dQ: one block per (64-row query tile, head, batch row), four warps of
//     16 rows whose Q and dO fragments, lse, delta and f32 dQ accumulator
//     stay in registers while the block walks the KV tiles its last query
//     can see, two stages deep, 16 keys at a time.
//
// P and dS are rounded to bf16 as tensor-core operands; every sum is f32.
#include "flash_common.cuh"

namespace {

template <int HD>
struct Frag {
  static constexpr int KK = HD / 16;  // k-steps over the head dimension
  static constexpr int DT = HD / 8;   // n-tiles over the head dimension
  static constexpr int kStride = HD + 8;
  static constexpr int kTile = rltt::kTileRows * kStride;
};

template <int HD>
__global__ void __launch_bounds__(rltt::kFlashThreads)
flash_bwd_dkv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
              int H, int Hkv, int causal, int q_offset, float scale) {
  using F = Frag<HD>;
  constexpr int S = F::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [K | V | stage 0: Q, dO | stage 1: Q, dO | stage 0: lse, delta | stage 1: lse, delta]
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + F::kTile;
  __nv_bfloat16* sqd = sv + F::kTile;
  float* sld = reinterpret_cast<float*>(sqd + 4 * F::kTile);
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int n_rep = H / Hkv;
  const int kv0 = kt * rltt::kTileRows;
  const int nq = (Sq + rltt::kTileRows - 1) / rltt::kTileRows;
  // the first query tile whose last row sees this KV tile's first key
  int qt_lo = 0;
  if (causal)
    while (qt_lo < nq && q_offset + min(Sq, (qt_lo + 1) * rltt::kTileRows) - 1 < kv0) ++qt_lo;
  const int per_head = nq - qt_lo;
  const int n_items = n_rep * per_head;

  const int64_t kv_stride = (int64_t)Hkv * HD, q_stride = (int64_t)H * HD;
  rltt::load_tile_async<HD>(sk, k + ((int64_t)b * Sk * Hkv + kvh) * HD, kv_stride, kv0, Sk);
  rltt::load_tile_async<HD>(sv, v + ((int64_t)b * Sk * Hkv + kvh) * HD, kv_stride, kv0, Sk);
  rltt::cp_async_commit();
  auto fetch = [&](int it) {
    const int h = kvh * n_rep + it / per_head, qt = qt_lo + it % per_head;
    __nv_bfloat16* sq = sqd + (it & 1) * 2 * F::kTile;
    const int64_t off = ((int64_t)b * Sq * H + h) * HD;
    rltt::load_tile_async<HD>(sq, q + off, q_stride, qt * rltt::kTileRows, Sq);
    rltt::load_tile_async<HD>(sq + F::kTile, dout + off, q_stride, qt * rltt::kTileRows, Sq);
    float* sl = sld + (it & 1) * 2 * rltt::kTileRows;
    const int64_t voff = ((int64_t)b * H + h) * Sq;
    rltt::load_vec_async(sl, lse + voff, qt * rltt::kTileRows, Sq);
    rltt::load_vec_async(sl + rltt::kTileRows, delta + voff, qt * rltt::kTileRows, Sq);
    rltt::cp_async_commit();
  };

  float dk_acc[F::DT][4], dv_acc[F::DT][4];
#pragma unroll
  for (int dt = 0; dt < F::DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  const int kr0 = warp * 16;  // this warp's keys within the tile: kr0 + g, + 8

  if (n_items > 0) fetch(0);
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      fetch(it + 1);
      rltt::cp_async_wait<1>();
    } else {
      rltt::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sq = sqd + (it & 1) * 2 * F::kTile;
    const __nv_bfloat16* sdo = sq + F::kTile;
    const float* sl = sld + (it & 1) * 2 * rltt::kTileRows;
    const float* sd = sl + rltt::kTileRows;
    const int i0 = (qt_lo + it % per_head) * rltt::kTileRows;
#pragma unroll 1
    for (int c = 0; c < rltt::kTileRows / 16; ++c) {  // 16 query rows at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < F::KK; ++kk) {
        uint32_t ak[4], av[4];
        rltt::row_frag<HD>(sk, kr0, kk * 16, g, tig, ak);
        rltt::row_frag<HD>(sv, kr0, kk * 16, g, tig, av);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* qr = sq + (c * 16 + nt * 8 + g) * S + kk * 16 + tig * 2;
          rltt::mma_bf16(s[nt], ak, rltt::ld2(qr), rltt::ld2(qr + 8));
          const __nv_bfloat16* dr = sdo + (c * 16 + nt * 8 + g) * S + kk * 16 + tig * 2;
          rltt::mma_bf16(dp[nt], av, rltt::ld2(dr), rltt::ld2(dr + 8));
        }
      }
      // element (key kr0 + g + 8 * h2, query c * 16 + nt * 8 + tig * 2 + e)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c * 16 + nt * 8 + tig * 2 + e;
            const int qi = i0 + col, key = kv0 + kr0 + g + 8 * h2;
            const bool vis = qi < Sq && key < Sk && (!causal || q_offset + qi >= key);
            const float p = vis ? expf(s[nt][2 * h2 + e] * scale - sl[col]) : 0.f;
            s[nt][2 * h2 + e] = p;
            dp[nt][2 * h2 + e] = p * (dp[nt][2 * h2 + e] - sd[col]) * scale;
          }
      const uint32_t pf[4] = {rltt::pack2(s[0][0], s[0][1]), rltt::pack2(s[0][2], s[0][3]),
                              rltt::pack2(s[1][0], s[1][1]), rltt::pack2(s[1][2], s[1][3])};
      const uint32_t df[4] = {rltt::pack2(dp[0][0], dp[0][1]), rltt::pack2(dp[0][2], dp[0][3]),
                              rltt::pack2(dp[1][0], dp[1][1]), rltt::pack2(dp[1][2], dp[1][3])};
#pragma unroll
      for (int dt = 0; dt < F::DT; ++dt) {
        uint32_t b0, b1;
        rltt::col_frag<HD>(sdo, c * 16, dt * 8 + g, tig, b0, b1);
        rltt::mma_bf16(dv_acc[dt], pf, b0, b1);
        rltt::col_frag<HD>(sq, c * 16, dt * 8 + g, tig, b0, b1);
        rltt::mma_bf16(dk_acc[dt], df, b0, b1);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  rltt::cp_async_wait<0>();  // the K/V group, when there was no item

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = kv0 + kr0 + g + 8 * h2;
    if (key >= Sk) continue;
    const int64_t off = (((int64_t)b * Sk + key) * Hkv + kvh) * HD + tig * 2;
#pragma unroll
    for (int dt = 0; dt < F::DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) =
          rltt::pack2(dk_acc[dt][2 * h2], dk_acc[dt][2 * h2 + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) =
          rltt::pack2(dv_acc[dt][2 * h2], dv_acc[dt][2 * h2 + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(rltt::kFlashThreads)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int causal,
             int q_offset, float scale) {
  using F = Frag<HD>;
  constexpr int S = F::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][K | V]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int kvh = h / (H / Hkv);
  const int i0 = qt * rltt::kTileRows;

  int qi[2];
  bool live[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    qi[h2] = i0 + warp * 16 + g + 8 * h2;
    live[h2] = qi[h2] < Sq;
    const int64_t voff = ((int64_t)b * H + h) * Sq + qi[h2];
    row_lse[h2] = live[h2] ? lse[voff] : 0.f;
    row_delta[h2] = live[h2] ? delta[voff] : 0.f;
  }
  // Q and dO fragments of rows g and g + 8 (zeros where not live)
  uint32_t qf[F::KK][4], df[F::KK][4];
  {
    const __nv_bfloat16* qa = q + (((int64_t)b * Sq + (live[0] ? qi[0] : 0)) * H + h) * HD;
    const __nv_bfloat16* qb = q + (((int64_t)b * Sq + (live[1] ? qi[1] : 0)) * H + h) * HD;
    const __nv_bfloat16* da = dout + (qa - q);
    const __nv_bfloat16* db = dout + (qb - q);
#pragma unroll
    for (int kk = 0; kk < F::KK; ++kk) {
      const int d = kk * 16 + tig * 2;
      qf[kk][0] = live[0] ? rltt::ld2(qa + d) : 0u;
      qf[kk][1] = live[1] ? rltt::ld2(qb + d) : 0u;
      qf[kk][2] = live[0] ? rltt::ld2(qa + d + 8) : 0u;
      qf[kk][3] = live[1] ? rltt::ld2(qb + d + 8) : 0u;
      df[kk][0] = live[0] ? rltt::ld2(da + d) : 0u;
      df[kk][1] = live[1] ? rltt::ld2(db + d) : 0u;
      df[kk][2] = live[0] ? rltt::ld2(da + d + 8) : 0u;
      df[kk][3] = live[1] ? rltt::ld2(db + d + 8) : 0u;
    }
  }
  float dq_acc[F::DT][4];
#pragma unroll
  for (int dt = 0; dt < F::DT; ++dt) dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  const int n_tiles = rltt::kv_tiles_seen((Sk + rltt::kTileRows - 1) / rltt::kTileRows,
                                          causal, q_offset, min(Sq, i0 + rltt::kTileRows) - 1);
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const __nv_bfloat16* kbase = k + ((int64_t)b * Sk * Hkv + kvh) * HD;
  const __nv_bfloat16* vbase = v + ((int64_t)b * Sk * Hkv + kvh) * HD;
  auto fetch = [&](int t) {
    __nv_bfloat16* sk = smem + (t & 1) * 2 * F::kTile;
    rltt::load_tile_async<HD>(sk, kbase, kv_stride, t * rltt::kTileRows, Sk);
    rltt::load_tile_async<HD>(sk + F::kTile, vbase, kv_stride, t * rltt::kTileRows, Sk);
    rltt::cp_async_commit();
  };
  if (n_tiles > 0) fetch(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      rltt::cp_async_wait<1>();
    } else {
      rltt::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sk = smem + (t & 1) * 2 * F::kTile;
    const __nv_bfloat16* sv = sk + F::kTile;
#pragma unroll 1
    for (int sub = 0; sub < rltt::kTileRows / 16; ++sub) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        const __nv_bfloat16* kr = sk + (sub * 16 + nt * 8 + g) * S + tig * 2;
        const __nv_bfloat16* vr = sv + (sub * 16 + nt * 8 + g) * S + tig * 2;
#pragma unroll
        for (int kk = 0; kk < F::KK; ++kk) {
          rltt::mma_bf16(s[nt], qf[kk], rltt::ld2(kr + kk * 16), rltt::ld2(kr + kk * 16 + 8));
          rltt::mma_bf16(dp[nt], df[kk], rltt::ld2(vr + kk * 16), rltt::ld2(vr + kk * 16 + 8));
        }
      }
      // element (query row g + 8 * h2, key sub * 16 + nt * 8 + tig * 2 + e)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = t * rltt::kTileRows + sub * 16 + nt * 8 + tig * 2 + e;
            const bool vis = live[h2] && key < Sk && (!causal || q_offset + qi[h2] >= key);
            const float p = vis ? expf(s[nt][2 * h2 + e] * scale - row_lse[h2]) : 0.f;
            dp[nt][2 * h2 + e] = p * (dp[nt][2 * h2 + e] - row_delta[h2]) * scale;
          }
      const uint32_t dsf[4] = {rltt::pack2(dp[0][0], dp[0][1]), rltt::pack2(dp[0][2], dp[0][3]),
                               rltt::pack2(dp[1][0], dp[1][1]), rltt::pack2(dp[1][2], dp[1][3])};
#pragma unroll
      for (int dt = 0; dt < F::DT; ++dt) {
        uint32_t b0, b1;
        rltt::col_frag<HD>(sk, sub * 16, dt * 8 + g, tig, b0, b1);
        rltt::mma_bf16(dq_acc[dt], dsf, b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (!live[h2]) continue;
    __nv_bfloat16* row = dq + (((int64_t)b * Sq + qi[h2]) * H + h) * HD + tig * 2;
#pragma unroll
    for (int dt = 0; dt < F::DT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          rltt::pack2(dq_acc[dt][2 * h2], dq_acc[dt][2 * h2 + 1]);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
               int causal, int q_offset, float scale, cudaStream_t stream) {
  const int smem = 6 * Frag<HD>::kTile * (int)sizeof(__nv_bfloat16)
                   + 4 * rltt::kTileRows * (int)sizeof(float);
  static bool configured = false;
  if (int err = set_smem(flash_bwd_dkv<HD>, smem, configured)) return err;
  const dim3 grid((Sk + rltt::kTileRows - 1) / rltt::kTileRows, Hkv, B);
  flash_bwd_dkv<HD><<<grid, rltt::kFlashThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, Hkv, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Sk, int H, int Hkv, int causal,
              int q_offset, float scale, cudaStream_t stream) {
  const int smem = 4 * Frag<HD>::kTile * (int)sizeof(__nv_bfloat16);
  static bool configured = false;
  if (int err = set_smem(flash_bwd_dq<HD>, smem, configured)) return err;
  const dim3 grid((Sq + rltt::kTileRows - 1) / rltt::kTileRows, H, B);
  flash_bwd_dq<HD><<<grid, rltt::kFlashThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, Hkv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

bool valid(int B, int Sq, int Sk, int H, int Hkv) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && Hkv >= 1 && H % Hkv == 0;
}

}  // namespace

// Pass 1: dk, dv [B, Sk, Hkv, HD]. Launch on `stream`; returns the
// cudaError_t of the launch (0 = ok).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
                                  int HD, int causal, int q_offset, float scale,
                                  void* stream) {
  if (!valid(B, Sq, Sk, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                           q_offset, scale, st);
  if (HD == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                          q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Pass 2: dq [B, Sq, H, HD].
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int Sq, int Sk, int H, int Hkv, int HD,
                                 int causal, int q_offset, float scale, void* stream) {
  if (!valid(B, Sq, Sk, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, q_offset,
                          scale, st);
  if (HD == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, q_offset,
                         scale, st);
  return (int)cudaErrorInvalidValue;
}
