// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_lightning_tpu/ops/pallas/rmsnorm.py `_kernel`
// (driven by `_rmsnorm_fwd_2d`): y = x * rsqrt(mean(x^2) + eps) * w over
// the last axis, in f32, cast back to x's dtype. x [N, D] is bf16, f16 or
// f32; w [D] is x's dtype or f32 (the Llama models keep their gains in
// f32).
//
// Bound on the H100: bytes, 2 * N * D * sizeof(x) + D * sizeof(w) over
// 3.35 TB/s: 0.02 us at the decode shape (N 4, D 4096, bf16) and 20 us at
// the training shape (N 4096). At the decode shape the kernel is all fixed
// cost: the launch, one round trip to device memory and the reduction. So
// the design is about where that cost goes:
//
//   * Issue order. Every thread issues all of its loads, x and w, before
//     the reduction, so one memory round trip serves the row; nothing
//     waits on the sum but the multiply and the store (chip_variants.py
//     "w after the sum" is slower at D 4096, at every N).
//   * Vector width. 16-byte loads and stores of x and y: a row whose start
//     is not 16-byte aligned (D not a multiple of 8 in bf16) peels a
//     scalar head, and a scalar tail ends any row; w comes in 16-byte
//     words too where its columns line up, else element by element.
//   * One block a row, at every N: 256 threads for D 4096 in bf16, two
//     vectors each, the sum a warp shuffle plus one shared-memory step. A
//     warp per row over a grid sized to the SMs, which needs no shared
//     memory, measured slower at N 4096 than a block a row (PERF.md).
//   * The host path is one ctypes call with plain integers (the wrapper's
//     cost per call is measured beside the kernel in chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// VEC values of T in registers, moved in 16-byte words.
template <typename T, int VEC>
struct alignas(16) Pack {
  static_assert(VEC * sizeof(T) % 16 == 0, "whole 16-byte words");
  static constexpr int kWords = VEC * sizeof(T) / 16;
  T v[VEC];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      reinterpret_cast<uint4*>(v)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(v)[i];
  }
  __device__ __forceinline__ float sumsq() const {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s = fmaf(to_f(v[i]), to_f(v[i]), s);
    return s;
  }
};

// x's vector width: 16 bytes
template <typename TX>
constexpr int kVec = 16 / sizeof(TX);
constexpr int kPer = 2;             // vectors a thread keeps between sum and write
constexpr int kMaxThreads = 512;    // longer rows loop over the rest

// w's VEC values at column c: 16-byte words where they line up.
template <typename TW, int VEC>
__device__ __forceinline__ void load_w(Pack<TW, VEC>& p, const TW* __restrict__ w, bool aligned) {
  if (aligned) {
    p.load(w);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p.v[e] = w[e];
  }
}

// One block per row. Columns [0, head) and [head + nvec * VEC, D) are
// scalars; the nvec vectors between them start 16-byte aligned in x and
// out, up to kPer of them a thread kept in registers between the sum and
// the write.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxThreads) rms_rows(const TX* __restrict__ x,
                                                        const TW* __restrict__ w,
                                                        TX* __restrict__ out, int D, bool vec,
                                                        float eps) {
  constexpr int VEC = kVec<TX>;
  __shared__ float red[kMaxThreads / 32];
  const int t = threadIdx.x, G = blockDim.x;
  x += (int64_t)blockIdx.x * D;
  out += (int64_t)blockIdx.x * D;
  const int head = vec ? min(D, (int)((16 - (uintptr_t)x % 16) % 16 / sizeof(TX))) : D;
  const int nvec = (D - head) / VEC;
  const int tail = head + nvec * VEC;
  const bool w_vec = ((uintptr_t)(w + head) % 16) == 0;
  const TX* xb = x + head;
  const TW* wb = w + head;

  // every load before the reduction
  Pack<TX, VEC> xv[kPer];
  Pack<TW, VEC> wv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = t + k * G;
    if (i < nvec) {
      xv[k].load(xb + (int64_t)i * VEC);
      load_w(wv[k], wb + (int64_t)i * VEC, w_vec);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (t + k * G < nvec) ss += xv[k].sumsq();
  for (int i = t + kPer * G; i < nvec; i += G) {  // rows wider than the registers
    Pack<TX, VEC> p;
    p.load(xb + (int64_t)i * VEC);
    ss += p.sumsq();
  }
#pragma unroll 4
  for (int j = t; j < head; j += G) {  // the scalar head
    const float v = to_f(x[j]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll 4
  for (int j = tail + t; j < D; j += G) {  // the scalar tail
    const float v = to_f(x[j]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (t % 32 == 0) red[t / 32] = ss;
  __syncthreads();
  ss = 0.f;
  for (int k = 0; k < G / 32; ++k) ss += red[k];  // every thread, in warp order
  const float rstd = rsqrtf(ss / (float)D + eps);

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = t + k * G;
    if (i < nvec) {
      Pack<TX, VEC> y;
#pragma unroll
      for (int e = 0; e < VEC; ++e) y.v[e] = from_f<TX>(to_f(xv[k].v[e]) * rstd * to_f(wv[k].v[e]));
      y.store(out + head + (int64_t)i * VEC);
    }
  }
  for (int i = t + kPer * G; i < nvec; i += G) {
    Pack<TX, VEC> p, y;
    Pack<TW, VEC> q;
    p.load(xb + (int64_t)i * VEC);
    load_w(q, wb + (int64_t)i * VEC, w_vec);
#pragma unroll
    for (int e = 0; e < VEC; ++e) y.v[e] = from_f<TX>(to_f(p.v[e]) * rstd * to_f(q.v[e]));
    y.store(out + head + (int64_t)i * VEC);
  }
  for (int j = t; j < head; j += G) out[j] = from_f<TX>(to_f(x[j]) * rstd * to_f(w[j]));
  for (int j = tail + t; j < D; j += G) out[j] = from_f<TX>(to_f(x[j]) * rstd * to_f(w[j]));
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int N, int D, float eps,
           cudaStream_t stream) {
  constexpr int VEC = kVec<TX>;
  // x and out rows share their alignment when their bases do
  const bool vec = ((uintptr_t)x - (uintptr_t)out) % 16 == 0 && (uintptr_t)x % sizeof(TX) == 0;
  const int work = vec ? (D / VEC + kPer - 1) / kPer : (D + 7) / 8;
  const int threads = min(kMaxThreads, max(32, (work + 31) / 32 * 32));
  rms_rows<TX, TW><<<N, threads, 0, stream>>>(static_cast<const TX*>(x), static_cast<const TW*>(w),
                                               static_cast<TX*>(out), D, vec, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// Dtype codes: 0 float32, 1 bfloat16, 2 float16; w is x's dtype or
// float32.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int N, int D, int x_dtype,
                           int w_dtype, float eps, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w32 = w_dtype == 0;
  if (!w32 && w_dtype != x_dtype) return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0:
      return launch<float, float>(x, w, out, N, D, eps, st);
    case 1:
      return w32 ? launch<__nv_bfloat16, float>(x, w, out, N, D, eps, st)
                 : launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, N, D, eps, st);
    case 2:
      return w32 ? launch<__half, float>(x, w, out, N, D, eps, st)
                 : launch<__half, __half>(x, w, out, N, D, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
