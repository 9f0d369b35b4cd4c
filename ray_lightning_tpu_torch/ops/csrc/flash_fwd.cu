// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_lightning_tpu/ops/pallas/flash.py `_fwd_kernel`
// (driven by `_fwd`): q [B, Sq, H, HD], k and v [B, Sk, Hkv, HD] bf16, causal
// (query i sees keys kv <= q_offset + i) or full; writes o [B, Sq, H, HD]
// bf16 and lse [B, H, Sq] f32, the natural-log logsumexp of the scaled
// scores that the backward recomputes the probabilities from. A query that
// sees no key writes zeros and lse = -1e30 (the TPU kernel's l == 0 guard).
// GQA reads KV head h / (H / Hkv) in place.
//
// Bound on the H100: operations. Each K/V element pair (4 bytes) meets
// 4 FLOPs for each of the Sq query rows that see it: at the training shape
// (Sq = Sk = 2048, causal) about 1000 FLOPs per byte, over three times the
// card's ~295, so the least time is the FLOPs over 989 TFLOP/s, and only
// wgmma reaches the tensor cores' full rate.
//
// Design (FlashAttention-3's forward, without its intra-warpgroup
// overlap). The TPU grid walks KV tiles in sequence with (acc, m, l) in
// VMEM scratch; here one block owns a 128-row query tile of one head and
// walks the KV tiles itself, its state in registers:
//   * warpgroup 0 is the producer: after giving up its registers
//     (setmaxnreg), one thread loads the Q tile once and then each K and V
//     tile (64 keys at HD 128, 128 at HD 64) by TMA into a two-stage
//     ring, each stage guarded by a full and an empty mbarrier;
//   * warpgroups 1 and 2 own 64 query rows each: S = Q K^T on wgmma with
//     both operands in swizzled shared memory, the online softmax once per
//     KV tile in f32 registers on scores pre-scaled by scale * log2(e)
//     (exp2f), the probabilities rounded to bf16 in registers as the A
//     operand of O += P V, whose B operand is the V tile read MN-major;
//   * only tiles that cross the diagonal or the sequence end do mask
//     arithmetic: the -1e30 sentinel on masked scores before the running
//     max, and masked probabilities zeroed explicitly;
//   * a causal block stops at the last tile its final query sees, and the
//     last query tiles (the longest walks) are launched first.
#include "hopper_common.cuh"

namespace {

using namespace rltt::sm90;

template <int HD>
struct Fwd {
  static constexpr int kWG = 2;          // consumer warpgroups
  static constexpr int kM = 64 * kWG;    // query rows per block
  // keys per KV tile: at each head size the faster of 64 and 128 on the
  // H100 (chip_smoke.py's flash cases, PERF.md)
  static constexpr int kN = HD == 64 ? 128 : 64;
  static constexpr int kStages = 2;
  static constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
  static constexpr int kConsumerRegs = 240;  // fits the 384 x 168 the launch gets
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = kM * HD * 2;
  static constexpr int kKVBytes = kN * HD * 2;  // one of K or V
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::kThreads, 1)
flash_fwd(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
          __grid_constant__ const CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
          float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int causal, int q_offset,
          float scale_log2) {
  using C = Fwd<HD>;
  unsigned char* smem = smem_base();
  unsigned char* sq = smem;                 // [HD / 64][kM][64]
  unsigned char* skv = smem + C::kQBytes;   // stage s: K then V, [HD / 64][kN][64] each
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
      mbar_arrive_expect_tx(q_full, C::kQBytes);
      load_rows<HD>(sq, &tm_q, q_full, C::kM, h, i0, b);
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
  const int r_lo = i0 + cw * 64;          // this warpgroup's first query row
  const int r_hi = min(Sq, r_lo + 64) - 1;  // and its last live one
  int qi[2], hi[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    qi[h2] = r_lo + warp * 16 + g + 8 * h2;
    hi[h2] = causal ? min(Sk, q_offset + qi[h2] + 1) : Sk;  // sees keys < hi
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sq) + cw * 64 * 128;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    mbar_wait(&full[s], (t / C::kStages) & 1);
    const int kv0 = t * C::kN;
    if (r_hi >= r_lo && (!causal || kv0 <= q_offset + r_hi)) {
      const uint32_t k_addr = smem_u32(skv + s * 2 * C::kKVBytes);
      const uint32_t v_addr = k_addr + C::kKVBytes;
      float sc[C::kN / 2];
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, desc_k(q_addr, C::kM, kk), desc_k(k_addr, C::kN, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // the online softmax, once per tile, in log2 units
      const bool edge = kv0 + C::kN > Sk || (causal && q_offset + r_lo < kv0 + C::kN - 1);
      float corr[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < C::kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h2 + e];
            x *= scale_log2;
            if (edge && kv0 + 8 * j + 2 * t4 + e >= hi[h2]) x = kNegInf;
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
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (qi[h2] >= Sq) continue;
    const float inv = l[h2] == 0.f ? 0.f : 1.f / l[h2];
    __nv_bfloat16* orow = o + (((int64_t)b * Sq + qi[h2]) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack2(acc[4 * j + 2 * h2] * inv, acc[4 * j + 2 * h2 + 1] * inv);
    if (t4 == 0)
      lse[((int64_t)b * H + h) * Sq + qi[h2]] =
          l[h2] == 0.f ? kNegInf : (m[h2] + log2f(l[h2])) * kLn2;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
           int Sk, int H, int Hkv, int causal, int q_offset, float scale, cudaStream_t stream) {
  using C = Fwd<HD>;
  static bool configured = false;
  if (int err = rltt::sm90_host::allow_smem(flash_fwd<HD>, C::kSmem, configured)) return err;
  CUtensorMap tq, tk, tv;
  if (int err = rltt::sm90_host::rows_map(&tq, q, B, Sq, H, HD, C::kM)) return err;
  if (int err = rltt::sm90_host::rows_map(&tk, k, B, Sk, Hkv, HD, C::kN)) return err;
  if (int err = rltt::sm90_host::rows_map(&tv, v, B, Sk, Hkv, HD, C::kN)) return err;
  const dim3 grid(H, B, (Sq + C::kM - 1) / C::kM);
  flash_fwd<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Sk, H, Hkv,
      causal, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int Sq, int Sk, int H, int Hkv, int HD,
                              int causal, int q_offset, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, q_offset, scale, st);
  if (HD == 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
