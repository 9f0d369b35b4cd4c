// Device code of the mma.sync flash-attention kernel, dQ (flash_bwd.cu;
// the forward and dK/dV use hopper_common.cuh).
//
// Layout: the framework's [B, S, H, HD] bf16 tensors, read in place (row i
// of head h sits at ((b * S + i) * H + h) * HD); lse and delta are f32
// [B, H, Sq]. A block moves 64-row tiles of one head between device memory
// and shared memory with cp.async (16 bytes a thread, zero-filled past the
// sequence's end), two stages deep, so the next tile's copy is in flight
// while this tile's tensor-core products run. Tiles are stored as
// [64][HD + 8]: the padding puts the fragment reads of one warp on
// distinct banks. Every product is mma.sync m16n8k16 (bf16 in, f32
// accumulate) in the flash-attention-2 register layout of
// paged_common.cuh.
#pragma once

#include "paged_common.cuh"

namespace rltt {

constexpr int kTileRows = 64;  // query rows or keys per tile: 4 warps x 16
constexpr int kFlashWarps = 4;
constexpr int kFlashThreads = kFlashWarps * 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + 64) of one head, consecutive rows `row_stride` elements
// apart, into dst [64][HD + 8]; rows at or past `n_rows` become zeros.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int64_t row_stride, int r0, int n_rows) {
  constexpr int kVec = HD / 8;
  constexpr int kPer = kTileRows * kVec / kFlashThreads;
  static_assert(kPer * kFlashThreads == kTileRows * kVec, "threads must split a tile");
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kFlashThreads;
    const int r = idx / kVec, c = idx % kVec;
    const bool ok = r0 + r < n_rows;
    const __nv_bfloat16* g = src + (ok ? (int64_t)(r0 + r) * row_stride : 0) + c * 8;
    cp_async16(dst + r * (HD + 8) + c * 8, g, ok);
  }
}

// B fragment of a product whose k index runs down the rows of a
// shared-memory tile [rows][HD + 8] and whose n index runs along them:
// rows k0 + tig * 2 (+1, +8, +9), column n.
template <int HD>
__device__ __forceinline__ void col_frag(const __nv_bfloat16* tile, int k0, int n, int tig,
                                         uint32_t& b0, uint32_t& b1) {
  constexpr int S = HD + 8;
  const __nv_bfloat16* c = tile + (k0 + tig * 2) * S + n;
  b0 = pack2(c[0], c[S]);
  b1 = pack2(c[8 * S], c[9 * S]);
}

// The last KV tile a causal query tile ending at query index q_last can
// see is the one holding position q_offset + q_last; n_kv_tiles when the
// attention is full. Returns the number of KV tiles to walk.
__device__ __forceinline__ int kv_tiles_seen(int n_kv_tiles, int causal, int q_offset,
                                             int q_last) {
  if (!causal) return n_kv_tiles;
  const int kv_end = q_offset + q_last;
  return kv_end < 0 ? 0 : min(n_kv_tiles, kv_end / kTileRows + 1);
}

}  // namespace rltt
