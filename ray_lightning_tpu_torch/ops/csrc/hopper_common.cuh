// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu: forward; flash_bwd.cu: dK/dV and dQ), the paged prefill
// (paged_prefill.cu) and the paged decode (paged_attention.cu, which uses
// only the mbarriers): TMA tile loads tracked by mbarriers, cp.async
// copies into the same swizzled layout (for tiles gathered through a block
// table), warpgroup matrix multiplies (wgmma) on operands in
// 128-byte-swizzled shared memory, and the register hand-over between a
// producer warpgroup and its consumers (setmaxnreg).
//
// Tile layout. A [B, S, heads, HD] bf16 tensor is read through a 4-D TMA
// map (HD, heads, S, B) whose box is 64 columns x 1 head x `rows` rows x 1,
// so one load brings `rows` rows of one head, 128 bytes each, into shared
// memory with the 128-byte swizzle; rows past S arrive as zeros. An HD-128
// row is two such boxes, stored one after the other ([HD / 64][rows][64]).
// Every tile starts on a 1024-byte boundary (8 rows x 128 bytes, one
// swizzle atom), so the wgmma descriptors below need no base offset.
//
// Operand descriptors (64-bit, PTX ISA "matrix descriptor"): start address
// >> 4 in bits 0-13, leading byte offset >> 4 in bits 16-29, stride byte
// offset >> 4 in bits 32-45, swizzle mode in bits 62-63 (1 = 128 bytes).
//   * K-major (the product's depth runs along the stored rows: Q, K, V, dO
//     as the A operand or as the B operand of S = Q K^T): 8-row groups
//     1024 bytes apart (SBO); a k-step of 16 columns is 32 bytes along the
//     swizzled row, and the next 64 columns are the next box.
//   * MN-major (the depth runs down the stored rows: V in O += P V, dO and
//     Q in dV += P^T dO and dK += dS^T Q; wgmma's transpose bit set): 8
//     depth rows of 128 bytes make one 1024-byte atom, the next 8 rows are
//     the next atom (SBO = 1024); the output columns 64-127 are the next
//     box (LBO = the box's size); a k-step of 16 rows is 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rltt {
namespace sm90 {

constexpr float kNegInf = -1e30f;  // masked-score sentinel, never true -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBoxCols = 64;       // bf16 columns in one 128-byte swizzled row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to the swizzle atom (the launch
// asks for 1024 bytes more than the kernel uses).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. On a fresh barrier
// parity 1 counts as completed, so a producer's first wait on an empty
// slot passes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

// One box of a 4-D map at coordinates (c0, c1, c2, c3), innermost first,
// into dst; completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `rows` rows of head `head`, from row `row0` of batch row `b`, all HD
// columns, into dst [HD / 64][rows][64].
template <int HD>
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int rows, int head, int row0, int b) {
#pragma unroll
  for (int x = 0; x < HD / kBoxCols; ++x)
    tma_load_4d(static_cast<unsigned char*>(dst) + x * rows * 128, map, bar, x * kBoxCols, head,
                row0, b);
}

// ---- cp.async into the same layout ---------------------------------------------

// Where 16-byte chunk c (of HD / 8) of row r lands in a [HD / 64][rows][64]
// tile with the 128-byte swizzle, as TMA writes it: the chunk's index
// within its 128-byte row is XORed with the row's index within its
// 8-row atom.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes from device memory to shared address dst, or 16 zeros when
// !pred (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory writes (st.shared, cp.async)
// visible to the async proxy that wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warp specialisation -----------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A or B operand, K-major: k-step kk of a [HD / 64][rows][64] tile at addr.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int rows, int kk) {
  return desc_sw128(addr + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// B operand, MN-major: depth rows 16 kk .. 16 kk + 15 of such a tile.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int rows, int kk) {
  return desc_sw128(addr + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout (m64nN, per warpgroup): warp w of the group holds rows
// 16 w + g and 16 w + g + 8 (g = lane / 4); d[4 j + e] is row 16 w + g,
// column 8 j + 2 (lane % 4) + e, and d[4 j + 2 + e] the same column of row
// + 8. A register A operand (m64k16) has mma.sync's m16n8k16 A layout per
// warp, so columns 16 kk .. 16 kk + 15 of an accumulator are k-step kk's
// A fragment once rounded to bf16 (to_a).
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2(d[8 * kk + 6], d[8 * kk + 7]);
}

// D[64 x 64] (+)= A B, A and B from shared memory (both K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A B, A and B from shared memory (both K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A B, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D[64 x 128] += A B, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The last KV tile (of kN keys) a causal query tile ending at query q_last
// can see is the one holding position q_offset + q_last; all of them when
// the attention is full. Returns the number of KV tiles to walk.
template <int kN>
__device__ __forceinline__ int kv_tiles_seen(int n_kv_tiles, int causal, int q_offset,
                                             int q_last) {
  if (!causal) return n_kv_tiles;
  const int kv_end = q_offset + q_last;
  return kv_end < 0 ? 0 : min(n_kv_tiles, kv_end / kN + 1);
}

}  // namespace sm90

// ---- host: TMA maps ------------------------------------------------------------

namespace sm90_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; reach it through the
// runtime, so the libraries need not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a [B, S, heads, hd] bf16 tensor, boxes of `rows` rows x 64
// columns of one head, 128-byte swizzle, zeros past S. Returns a
// cudaError_t (0 = ok).
inline int rows_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd,
                    int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)sm90::kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dim,
                        stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allow `smem` bytes of dynamic shared memory for `kernel`, once.
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

}  // namespace sm90_host
}  // namespace rltt
