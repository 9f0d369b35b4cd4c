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
//   * dK/dV (FlashAttention-3's dK/dV half, without its dQ atomics): one
//     block per (128-key tile, KV head, batch row), key tile 0 (the one
//     every causal query tile sees) launched first. Warpgroup 0 is the
//     producer: after giving up its registers (setmaxnreg) it loads K and
//     V once by TMA, then streams the 64-row Q and dO tiles of all n_rep
//     query heads that share the KV head and of every query tile that can
//     see the keys (the causal skip) through a two-stage TMA ring guarded
//     by full and empty mbarriers; a second producer warp stores each
//     tile's lse (times log2 e) and delta beside it. Warpgroups 1 and 2 own
//     64 keys each: S^T = K Q^T and dP^T = V dO^T on wgmma from shared
//     memory put keys on the accumulator rows, so P^T and dS^T, computed
//     in f32 registers (exp2f; mask arithmetic only on tiles that cross
//     the diagonal or a sequence end), are rounded to bf16 in registers as
//     the A operands of dV += P^T dO and dK += dS^T Q, whose B operands
//     are the dO and Q tiles read MN-major. dK and dV are summed over the
//     GQA group in f32 registers and written once at [B, Sk, Hkv, HD]; the
//     TPU kernel writes per-query-head [B, H, Sk, HD] and sums outside.
//   * dQ (the forward's design with two score products): one block per
//     (128-row query tile, head, batch row), the last query tiles (the
//     longest causal walks) launched first. The producer warpgroup loads
//     the Q and dO tiles once by TMA, then streams the K and V tiles its
//     last query can see (64 keys each) through a two-stage TMA ring
//     guarded by full and empty mbarriers. Warpgroups 1 and 2 own 64 query
//     rows each, whose lse (times log2 e) and delta stay in registers for
//     the whole walk: S = Q K^T and dP = dO V^T on wgmma from shared
//     memory, P (exp2f on pre-scaled scores) computed while dP is on the
//     tensor cores, dS formed in f32 registers (mask arithmetic only on
//     tiles that cross the diagonal or a sequence end) and rounded to bf16
//     in registers as the A operand of dQ += dS K, whose B operand is the
//     K tile read MN-major. dQ is written in bf16 once.
//
// P and dS are rounded to bf16 as tensor-core operands; every sum is f32.
#include "hopper_common.cuh"

namespace {

template <int HD>
struct Dkv {
  static constexpr int kWG = 2;        // consumer warpgroups
  static constexpr int kN = 64 * kWG;  // keys per block
  static constexpr int kM = 64;        // query rows per streamed tile
  static constexpr int kStages = 2;
  static constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
  static constexpr int kConsumerRegs = 240;  // fits the 384 x 168 the launch gets
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kKVBytes = kN * HD * 2;  // one of K or V
  static constexpr int kQBytes = kM * HD * 2;   // one of Q or dO
  static constexpr int kVecBytes = 2 * kM * 4;  // lse * log2 e, delta
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmem =
      1024 + 2 * kKVBytes + kStages * (2 * kQBytes + kVecBytes) + 8 * kBars;
};

template <int HD>
__global__ void __launch_bounds__(Dkv<HD>::kThreads, 1)
flash_bwd_dkv(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
              __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
              int H, int Hkv, int causal, int q_offset, float scale, float scale_log2) {
  using namespace rltt::sm90;
  using C = Dkv<HD>;
  unsigned char* smem = smem_base();
  unsigned char* sk = smem;                     // [HD / 64][kN][64]
  unsigned char* sv = sk + C::kKVBytes;
  unsigned char* sqd = sv + C::kKVBytes;        // stage s: Q then dO, [HD / 64][kM][64] each
  float* svec = reinterpret_cast<float*>(sqd + C::kStages * 2 * C::kQBytes);  // stage s: [2][kM]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(svec + C::kStages * 2 * C::kM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::kStages;

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;  // key tile 0 first
  const int n_rep = H / Hkv;
  const int kv0 = kt * C::kN;
  const int nq = (Sq + C::kM - 1) / C::kM;
  // the first query tile whose last row sees this KV tile's first key
  int qt_lo = 0;
  if (causal)
    while (qt_lo < nq && q_offset + min(Sq, (qt_lo + 1) * C::kM) - 1 < kv0) ++qt_lo;
  const int per_head = nq - qt_lo;
  const int n_items = n_rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1 + 32);      // the loading thread, the vector warp
      mbar_init(&empty[s], 4 * C::kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: warp 0 loads tiles, warp 1 vectors
    regs_dec<C::kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::kKVBytes);
      load_rows<HD>(sk, &tm_k, kv_full, C::kN, kvh, kv0, b);
      load_rows<HD>(sv, &tm_v, kv_full, C::kN, kvh, kv0, b);
      int h = kvh * n_rep, qt = qt_lo;  // item it's query head and tile
      for (int it = 0; it < n_items; ++it) {
        const int s = it % C::kStages;
        mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::kQBytes);
        unsigned char* sq = sqd + s * 2 * C::kQBytes;
        load_rows<HD>(sq, &tm_q, &full[s], C::kM, h, qt * C::kM, b);
        load_rows<HD>(sq + C::kQBytes, &tm_do, &full[s], C::kM, h, qt * C::kM, b);
        if (++qt == qt_lo + per_head) {
          qt = qt_lo;
          ++h;
        }
      }
    } else if (warp == 1) {  // each tile's lse * log2 e and delta beside it
      int h = kvh * n_rep, qt = qt_lo;
      for (int it = 0; it < n_items; ++it) {
        const int s = it % C::kStages;
        mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        float* sl = svec + s * 2 * C::kM;
        const int64_t voff = ((int64_t)b * H + h) * Sq;
        for (int r = lane; r < C::kM; r += 32) {
          const int qi = qt * C::kM + r;
          sl[r] = qi < Sq ? lse[voff + qi] * kLog2e : 0.f;
          sl[C::kM + r] = qi < Sq ? delta[voff + qi] : 0.f;
        }
        mbar_arrive(&full[s]);
        if (++qt == qt_lo + per_head) {
          qt = qt_lo;
          ++h;
        }
      }
    }
    return;
  }

  // consumer warpgroups
  regs_inc<C::kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = kv0 + cw * 64;  // this warpgroup's first key
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_addr = smem_u32(sk) + cw * 64 * 128;
  const uint32_t v_addr = smem_u32(sv) + cw * 64 * 128;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_items; ++it) {
    const int qt = qt_lo + it % per_head;
    const int i0 = qt * C::kM;
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    if (kw0 < Sk && (!causal || q_offset + min(Sq, i0 + C::kM) - 1 >= kw0)) {
      const uint32_t q_addr = smem_u32(sqd + s * 2 * C::kQBytes);
      const uint32_t do_addr = q_addr + C::kQBytes;
      float st[32], dpt[32];  // S^T, dP^T: 64 keys x 64 queries
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      // four products in turn, each overlapping the arithmetic that
      // follows the one before: S^T, dP^T; P^T while dP^T runs; dV while
      // dS^T is computed; dK
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(st, desc_k(k_addr, C::kN, kk), desc_k(q_addr, C::kM, kk), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dpt, desc_k(v_addr, C::kN, kk), desc_k(do_addr, C::kM, kk), 1);
      wgmma_commit();
      fence_regs(dpt);
      wgmma_wait<1>();
      fence_regs(st);

      // element i = 4 j + 2 h2 + e: key kw0 + 16 warp + g + 8 h2, query
      // i0 + 8 j + 2 t4 + e
      const float* sl = svec + s * 2 * C::kM;
      const float* sd = sl + C::kM;
      const bool edge = i0 + C::kM > Sq || kw0 + 64 > Sk || (causal && q_offset + i0 < kw0 + 63);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h2 + e, col = 8 * j + 2 * t4 + e;
            const int qi = i0 + col, key = kw0 + warp * 16 + g + 8 * h2;
            const bool vis = !edge || (qi < Sq && key < Sk && (!causal || q_offset + qi >= key));
            st[i] = vis ? exp2f(st[i] * scale_log2 - sl[col]) : 0.f;
          }
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_a(st, kk, pf[kk]);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc, pf[kk], desc_mn(do_addr, C::kM, kk), 1);
      wgmma_commit();
      fence_regs(dv_acc);
      wgmma_wait<1>();
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, col = 8 * j + 2 * t4 + (e & 1);
          dpt[i] = st[i] * (dpt[i] - sd[col]) * scale;
        }
      uint32_t df[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_a(dpt, kk, df[kk]);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc, df[kk], desc_mn(q_addr, C::kM, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = kw0 + warp * 16 + g + 8 * h2;
    if (key >= Sk) continue;
    const int64_t off = (((int64_t)b * Sk + key) * Hkv + kvh) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack2(dk_acc[4 * j + 2 * h2], dk_acc[4 * j + 2 * h2 + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack2(dv_acc[4 * j + 2 * h2], dv_acc[4 * j + 2 * h2 + 1]);
    }
  }
}

template <int HD>
struct Dq {
  static constexpr int kWG = 2;        // consumer warpgroups
  static constexpr int kM = 64 * kWG;  // query rows per block
  static constexpr int kN = 64;        // keys per streamed K/V tile
  static constexpr int kStages = 2;
  static constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
  static constexpr int kConsumerRegs = 240;  // fits the 384 x 168 the launch gets
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = kM * HD * 2;   // one of Q or dO
  static constexpr int kKVBytes = kN * HD * 2;  // one of K or V
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

template <int HD>
__global__ void __launch_bounds__(Dq<HD>::kThreads, 1)
flash_bwd_dq(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
             __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int causal,
             int q_offset, float scale, float scale_log2) {
  using namespace rltt::sm90;
  using C = Dq<HD>;
  unsigned char* smem = smem_base();
  unsigned char* sq = smem;                     // [HD / 64][kM][64]
  unsigned char* sdo = sq + C::kQBytes;         // the same for dO
  unsigned char* skv = sdo + C::kQBytes;        // stage s: K then V, [HD / 64][kN][64] each
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + 2 * C::kStages * C::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest causal walks first
  const int kvh = h / (H / Hkv);
  const int i0 = qt * C::kM;
  const int n_tiles = kv_tiles_seen<C::kN>((Sk + C::kN - 1) / C::kN, causal, q_offset,
                                           min(Sq, i0 + C::kM) - 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
      load_rows<HD>(sq, &tm_q, q_full, C::kM, h, i0, b);
      load_rows<HD>(sdo, &tm_do, q_full, C::kM, h, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages;
        mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::kKVBytes);
        unsigned char* sk = skv + s * 2 * C::kKVBytes;
        load_rows<HD>(sk, &tm_k, &full[s], C::kN, kvh, t * C::kN, b);
        load_rows<HD>(sk + C::kKVBytes, &tm_v, &full[s], C::kN, kvh, t * C::kN, b);
      }
    }
    return;
  }

  // consumer warpgroups
  regs_inc<C::kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = i0 + cw * 64;            // this warpgroup's first query row
  const int r_hi = min(Sq, r_lo + 64) - 1;  // and its last live one
  // the rows' own lse (times log2 e) and delta stay in registers: a
  // block's rows are fixed for its whole walk
  int qi[2], hi[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    qi[h2] = r_lo + warp * 16 + g + 8 * h2;
    const bool live = qi[h2] < Sq;
    hi[h2] = !live ? 0 : causal ? min(Sk, q_offset + qi[h2] + 1) : Sk;  // sees keys < hi
    const int64_t voff = ((int64_t)b * H + h) * Sq + qi[h2];
    row_lse[h2] = live ? lse[voff] * kLog2e : 0.f;
    row_delta[h2] = live ? delta[voff] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(sq) + cw * 64 * 128;
  const uint32_t do_addr = smem_u32(sdo) + cw * 64 * 128;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    mbar_wait(&full[s], (t / C::kStages) & 1);
    const int kv0 = t * C::kN;
    if (r_hi >= r_lo && (!causal || kv0 <= q_offset + r_hi)) {
      const uint32_t k_addr = smem_u32(skv + s * 2 * C::kKVBytes);
      const uint32_t v_addr = k_addr + C::kKVBytes;
      float sc[C::kN / 2], dp[C::kN / 2];  // S and dP: 64 queries x kN keys
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      // S = Q K^T and dP = dO V^T; P is computed while dP is on the
      // tensor cores
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, desc_k(q_addr, C::kM, kk), desc_k(k_addr, C::kN, kk), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dp, desc_k(do_addr, C::kM, kk), desc_k(v_addr, C::kN, kk), 1);
      wgmma_commit();
      fence_regs(dp);
      wgmma_wait<1>();
      fence_regs(sc);

      // element i = 4 j + 2 h2 + e: query qi[h2], key kv0 + 8 j + 2 t4 + e
      const bool edge = kv0 + C::kN > Sk || r_lo + 64 > Sq ||
                        (causal && q_offset + r_lo < kv0 + C::kN - 1);
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h2 + e];
            const bool vis = !edge || kv0 + 8 * j + 2 * t4 + e < hi[h2];
            x = vis ? exp2f(x * scale_log2 - row_lse[h2]) : 0.f;
          }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = sc[i] * (dp[i] - row_delta[e >> 1]) * scale;
        }

      // dQ += dS K: dS from registers, K MN-major from shared memory
      uint32_t df[C::kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::kN / 16; ++kk) to_a(dp, kk, df[kk]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kN / 16; ++kk) wgmma_rs(acc, df[kk], desc_mn(k_addr, C::kN, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (qi[h2] >= Sq) continue;
    __nv_bfloat16* row = dq + (((int64_t)b * Sq + qi[h2]) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
  }
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
               int causal, int q_offset, float scale, cudaStream_t stream) {
  using C = Dkv<HD>;
  using rltt::sm90_host::rows_map;
  static bool configured = false;
  if (int err = rltt::sm90_host::allow_smem(flash_bwd_dkv<HD>, C::kSmem, configured)) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = rows_map(&tq, q, B, Sq, H, HD, C::kM)) return err;
  if (int err = rows_map(&tk, k, B, Sk, Hkv, HD, C::kN)) return err;
  if (int err = rows_map(&tv, v, B, Sk, Hkv, HD, C::kN)) return err;
  if (int err = rows_map(&tdo, dout, B, Sq, H, HD, C::kM)) return err;
  const dim3 grid(Hkv, B, (Sk + C::kN - 1) / C::kN);
  flash_bwd_dkv<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, Hkv, causal,
      q_offset, scale, scale * rltt::sm90::kLog2e);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Sk, int H, int Hkv, int causal,
              int q_offset, float scale, cudaStream_t stream) {
  using C = Dq<HD>;
  using rltt::sm90_host::rows_map;
  static bool configured = false;
  if (int err = rltt::sm90_host::allow_smem(flash_bwd_dq<HD>, C::kSmem, configured)) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = rows_map(&tq, q, B, Sq, H, HD, C::kM)) return err;
  if (int err = rows_map(&tk, k, B, Sk, Hkv, HD, C::kN)) return err;
  if (int err = rows_map(&tv, v, B, Sk, Hkv, HD, C::kN)) return err;
  if (int err = rows_map(&tdo, dout, B, Sq, H, HD, C::kM)) return err;
  const dim3 grid(H, B, (Sq + C::kM - 1) / C::kM);
  flash_bwd_dq<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, Hkv, causal, q_offset, scale,
      scale * rltt::sm90::kLog2e);
  return (int)cudaGetLastError();
}

bool valid(int B, int Sq, int Sk, int H, int Hkv) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && Hkv >= 1 && H % Hkv == 0 && B <= 65535;
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
