// The AdamW step over many tensors in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel. In the JAX package the update is optax's
// `adamw(mu_dtype=...)` (ray_lightning_tpu/models/llama.py
// `LlamaModule.configure_optimizers`), which XLA fuses; no PyTorch
// optimizer has its semantics: optax computes the update from the f32 new
// first moment and only then rounds that moment to `mu_dtype` for storage,
// while torch's fused AdamW keeps its moments in the parameters' dtype and a
// `_foreach` chain would make about ten passes over the state. This kernel
// is that update, one pass:
//
//   m' = (1 - b1) * g + [b1 * m]     [b1 * m] is a product in bf16, as
//                                    JAX's weak-typed scalar keeps it with
//                                    a bf16 m: b1 rounds to bf16 and so
//                                    does the product
//   v' = (1 - b2) * g * g + b2 * v   (f32)
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p,
//        bc1 = 1 - b1^t, bc2 = 1 - b2^t, t the tensor's step + 1
//   p' = p + (-lr) * u;  store p', round(m') to bf16, v'
//
// every operation rounded on its own (the _rn intrinsics: no contraction
// into an fma), in optax's order, so the plain PyTorch version
// (ops/kernels/adamw.py `adamw_step_plain`) gives the same bits but for
// the powers in bc1 and bc2.
//
// The learning rate, the skip flag and each tensor's step count are read
// from device memory: the schedule (`core/schedule.py` DeviceLambdaLR)
// writes the lr, the trainguard writes `found_inf`, and a launch with
// found_inf != 0 returns before touching anything (parameters, moments and
// step counts stay as they were; no host read). The block that finishes
// a tensor's last chunk writes its step + 1 (a per-tensor counter of
// finished chunks, reset by that block for the next launch).
//
// Bound on the H100: bytes. An element reads p, g, m, v and writes p, m,
// v: 24 bytes (the first moment bf16, the rest f32), about 13.8
// ms for the 1.92 G elements of a 4-layer Llama-3-8B at 3.35 TB/s. The
// design is plain streaming: the tensors' pointers travel in the launch's
// parameters (no host-to-device copy, so no sync), every tensor is cut
// into 64K-element chunks, a grid of a few blocks per SM walks the chunks
// of all tensors, and a chunk moves 16-byte words (4 elements; the bf16
// moment in 8-byte words) where its tensor's pointers are aligned, one
// element at a time where they are not. The first moment is bf16 only:
// an f32 one is torch's fused AdamW's state (`LlamaModule` uses that).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxTensors = 128;  // pointers a launch carries (6 KB of parameters)
constexpr int kThreads = 512;
constexpr int64_t kChunk = 65536;  // elements a block works through at a time

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  __nv_bfloat16* m[kMaxTensors];
  float* v[kMaxTensors];
  float* step[kMaxTensors];
  int64_t numel[kMaxTensors];
};

struct Hyper {
  float b1;
  float b1m;   // b1 rounded to bf16
  float omb1;  // 1 - b1, rounded once from the exact difference (the host's)
  float b2, omb2, eps, wd;
};

struct Scalars {
  float neg_lr, bc1, bc2;
};

__device__ __forceinline__ void update(float& p, float g, __nv_bfloat16& m, float& v,
                                       const Hyper& h, const Scalars& s) {
  // [b1 * m] in bf16: exact in f32, then rounded
  const float mdec =
      __bfloat162float(__float2bfloat16_rn(__fmul_rn(h.b1m, __bfloat162float(m))));
  const float mn = __fadd_rn(__fmul_rn(h.omb1, g), mdec);
  const float vn = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float mhat = __fdiv_rn(mn, s.bc1);
  const float vhat = __fdiv_rn(vn, s.bc2);
  float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
  m = __float2bfloat16_rn(mn);
  v = vn;
}

__global__ void __launch_bounds__(kThreads)
    adamw_chunks(const __grid_constant__ Table t, int n, int* __restrict__ done,
                 const float* __restrict__ lr, const float* __restrict__ found_inf, Hyper h) {
  if (found_inf != nullptr && *found_inf != 0.f) return;
  __shared__ int64_t start[kMaxTensors + 1];  // each tensor's first chunk
  __shared__ int s_i;
  __shared__ float s_step;
  if (threadIdx.x == 0) {
    int64_t s = 0;
    for (int i = 0; i < n; ++i) {
      start[i] = s;
      s += t.numel[i] > 0 ? (t.numel[i] + kChunk - 1) / kChunk : 1;
    }
    start[n] = s;
  }
  __syncthreads();
  const int64_t total = start[n];
  const float neg_lr = -*lr;
  for (int64_t c = blockIdx.x; c < total; c += gridDim.x) {
    if (threadIdx.x == 0) {
      int lo = 0, hi = n - 1;  // the last tensor whose first chunk is <= c
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (start[mid] <= c) lo = mid; else hi = mid - 1;
      }
      s_i = lo;
      s_step = *t.step[lo] + 1.f;
    }
    __syncthreads();
    const int i = s_i;
    const float step = s_step;
    const Scalars s{neg_lr, __fsub_rn(1.f, powf(h.b1, step)), __fsub_rn(1.f, powf(h.b2, step))};
    const int64_t lo = (c - start[i]) * kChunk;
    const int64_t hi = min(lo + kChunk, t.numel[i]);
    float* P = t.p[i];
    const float* G = t.g[i];
    __nv_bfloat16* M = t.m[i];
    float* V = t.v[i];
    const bool vec = ((uintptr_t)P | (uintptr_t)G | (uintptr_t)V) % 16 == 0 &&
                     (uintptr_t)M % 8 == 0;
    int64_t e0 = lo;
    if (vec) {
      const int64_t w_hi = lo / 4 + (hi - lo) / 4;
      for (int64_t w = lo / 4 + threadIdx.x; w < w_hi; w += blockDim.x) {
        float4 pw = reinterpret_cast<float4*>(P)[w];
        const float4 gw = __ldg(reinterpret_cast<const float4*>(G) + w);
        float4 vw = reinterpret_cast<float4*>(V)[w];
        uint2 mw = reinterpret_cast<uint2*>(M)[w];  // four bf16 moments
        __nv_bfloat16* mv = reinterpret_cast<__nv_bfloat16*>(&mw);
        update(pw.x, gw.x, mv[0], vw.x, h, s);
        update(pw.y, gw.y, mv[1], vw.y, h, s);
        update(pw.z, gw.z, mv[2], vw.z, h, s);
        update(pw.w, gw.w, mv[3], vw.w, h, s);
        reinterpret_cast<float4*>(P)[w] = pw;
        reinterpret_cast<float4*>(V)[w] = vw;
        reinterpret_cast<uint2*>(M)[w] = mw;
      }
      e0 = w_hi * 4;
    }
    for (int64_t e = e0 + threadIdx.x; e < hi; e += blockDim.x) {
      float pe = P[e], ve = V[e];
      __nv_bfloat16 me = M[e];
      update(pe, G[e], me, ve, h, s);
      P[e] = pe;
      M[e] = me;
      V[e] = ve;
    }
    __syncthreads();  // the chunk is done, and s_i / s_step are free again
    if (threadIdx.x == 0) {
      __threadfence();
      const int n_chunks = (int)(start[i + 1] - start[i]);
      if (atomicAdd(&done[i], 1) == n_chunks - 1) {
        *t.step[i] = step;  // every chunk of this tensor has read the old count
        done[i] = 0;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// `table` is host memory: n (<= 128) pointers each of p, g, m, v, step,
// then n element counts, each array kMaxTensors long. `done` is n int32
// counters on the device, zero before the first launch. `found_inf` may be
// null. The m pointers are bf16, the rest f32.
extern "C" int adamw_step(const uint64_t* table, int n, void* done, const void* lr,
                          const void* found_inf, float b1, float b1m, float omb1, float b2,
                          float omb2, float eps, float wd, void* stream) {
  if (n < 1 || n > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < n; ++i) {
    t.p[i] = reinterpret_cast<float*>(table[0 * kMaxTensors + i]);
    t.g[i] = reinterpret_cast<const float*>(table[1 * kMaxTensors + i]);
    t.m[i] = reinterpret_cast<__nv_bfloat16*>(table[2 * kMaxTensors + i]);
    t.v[i] = reinterpret_cast<float*>(table[3 * kMaxTensors + i]);
    t.step[i] = reinterpret_cast<float*>(table[4 * kMaxTensors + i]);
    t.numel[i] = (int64_t)table[5 * kMaxTensors + i];
  }
  for (int i = n; i < kMaxTensors; ++i) {
    t.p[i] = nullptr;
    t.g[i] = nullptr;
    t.m[i] = nullptr;
    t.v[i] = nullptr;
    t.step[i] = nullptr;
    t.numel[i] = 0;
  }
  const Hyper h{b1, b1m, omb1, b2, omb2, eps, wd};
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t chunks = 0;
  for (int i = 0; i < n; ++i) chunks += t.numel[i] > 0 ? (t.numel[i] + kChunk - 1) / kChunk : 1;
  const int blocks = (int)std::min<int64_t>(chunks, (int64_t)sms * (2048 / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* d = static_cast<int*>(done);
  const float* l = static_cast<const float*>(lr);
  const float* f = static_cast<const float*>(found_inf);
  adamw_chunks<<<blocks, kThreads, 0, st>>>(t, n, d, l, f, h);
  return (int)cudaGetLastError();
}
