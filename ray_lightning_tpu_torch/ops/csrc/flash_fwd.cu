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
// card's ~295, so the least time is the FLOPs over 989 TFLOP/s.
//
// Design: the TPU grid walks KV tiles in sequence with (acc, m, l) in VMEM
// scratch that persists across grid steps; blocks on this card run in no
// order, so one block owns a 64-row query tile of one head and walks the
// KV tiles itself, its state in registers. Four warps own 16 query rows
// each (paged_common.cuh WarpRows: Q fragments, the f32 output accumulator
// and the online-softmax state stay in registers for the whole walk). K/V
// tiles of 64 keys arrive by cp.async two stages deep; each is folded in
// as four 16-key steps: S = Q K^T on the tensor cores, the -1e30 sentinel
// on masked scores before the running max, masked probabilities zeroed
// explicitly, the unnormalised probabilities rounded to bf16 and fed from
// the S fragments straight into the P V product. A causal block stops at
// the last tile its final query sees (the TPU kernel's predicated skip).
#include "flash_common.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(rltt::kFlashThreads)
flash_fwd(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
          float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int causal,
          int q_offset, float scale) {
  constexpr int kStride = HD + 8;
  constexpr int kTile = rltt::kTileRows * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][K | V]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int kvh = h / (H / Hkv);
  const int i0 = qt * rltt::kTileRows;

  rltt::WarpRows<HD> w;
  int qi[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    qi[h2] = i0 + warp * 16 + g + 8 * h2;
    w.live[h2] = qi[h2] < Sq;
    w.hi[h2] = causal ? min(Sk, q_offset + qi[h2] + 1) : Sk;
    qrow[h2] = q + (((int64_t)b * Sq + (w.live[h2] ? qi[h2] : 0)) * H + h) * HD;
  }
  w.init(qrow[0], qrow[1], tig);

  const int n_tiles = rltt::kv_tiles_seen((Sk + rltt::kTileRows - 1) / rltt::kTileRows,
                                          causal, q_offset, min(Sq, i0 + rltt::kTileRows) - 1);
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const __nv_bfloat16* kbase = k + ((int64_t)b * Sk * Hkv + kvh) * HD;
  const __nv_bfloat16* vbase = v + ((int64_t)b * Sk * Hkv + kvh) * HD;
  auto fetch = [&](int t) {
    __nv_bfloat16* sk = smem + (t & 1) * 2 * kTile;
    rltt::load_tile_async<HD>(sk, kbase, kv_stride, t * rltt::kTileRows, Sk);
    rltt::load_tile_async<HD>(sk + kTile, vbase, kv_stride, t * rltt::kTileRows, Sk);
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
    __syncthreads();  // tile t is in shared memory for every warp
    const __nv_bfloat16* sk = smem + (t & 1) * 2 * kTile;
    const __nv_bfloat16* sv = sk + kTile;
#pragma unroll
    for (int sub = 0; sub < rltt::kTileRows / rltt::kKeys; ++sub)
      w.tile(sk + sub * rltt::kKeys * kStride, sv + sub * rltt::kKeys * kStride,
             t * rltt::kTileRows + sub * rltt::kKeys, 0, scale, g, tig);
    __syncthreads();  // tile t is consumed before its buffer is refilled
  }
  w.reduce_l();
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (!w.live[h2]) continue;
    const float l = w.l[h2];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    __nv_bfloat16* orow = o + (((int64_t)b * Sq + qi[h2]) * H + h) * HD;
#pragma unroll
    for (int dt = 0; dt < rltt::WarpRows<HD>::DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          rltt::pack2(w.o[dt][2 * h2] * inv, w.o[dt][2 * h2 + 1] * inv);
    if (tig == 0)
      lse[((int64_t)b * H + h) * Sq + qi[h2]] = w.m[h2] + logf(l == 0.f ? 1.f : l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
           int Sk, int H, int Hkv, int causal, int q_offset, float scale, cudaStream_t stream) {
  const int smem = 2 * 2 * rltt::kTileRows * (HD + 8) * (int)sizeof(__nv_bfloat16);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + rltt::kTileRows - 1) / rltt::kTileRows, H, B);
  flash_fwd<HD><<<grid, rltt::kFlashThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int Sq, int Sk, int H, int Hkv, int HD,
                              int causal, int q_offset, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, q_offset, scale, st);
  if (HD == 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
