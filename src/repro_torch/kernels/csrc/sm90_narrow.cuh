// Staging helpers of the sm_90a kernels at head dims 16 and 32 (the
// ``sm90n`` route: csrc/flash_fwd_sm90_narrow.cu and
// csrc/flash_bwd_sm90_narrow.cu), beside csrc/sm90_common.cuh.
//
// Layout contract.  A staged tile is R rows of D bf16 values, each row its
// own D * 2 bytes (64 at D 32, 32 at D 16), written by TMA with the swizzle
// of that span (64- or 32-byte) from a tensor map whose box is a whole row
// wide; sm90_common.cuh's layout (one 64-column chunk a row, 128-byte
// swizzle, zeros past D) would take twice the shared memory for the same
// results.  The wgmma descriptors of such a tile take layout type 2 (64-byte
// swizzle) or 3 (32-byte), 8-row groups 8 rows apart.
#pragma once

#include "sm90_common.cuh"

namespace {

// Bytes of a staged row at head dim D, swizzled over that span: 64 at D 32,
// 32 at D 16.
template <int D>
__host__ __device__ constexpr int row_bytes() {
  return 2 * D;
}

// Bytes of a staged R-row tile.
template <int D, int R = kTile>
__host__ __device__ constexpr int ntile_bytes() {
  return R * row_bytes<D>();
}

// wgmma descriptor of a tile whose rows are swizzled over row_bytes<D>()
// (layout type 2, 3: the 64-, 32-byte swizzle); 8-row groups lie 8 rows
// apart.
template <int D>
__device__ __forceinline__ uint64_t ndesc(uint32_t addr, uint32_t lbo) {
  constexpr int rb = row_bytes<D>();
  static_assert(rb == 64 || rb == 32, "rows of 64 or 32 bytes");
  constexpr uint64_t layout = rb == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * rb >> 4) << 32) | (layout << 62);
}

// A tile as a K-major operand (K = D): k step kk 32 bytes into each row.
template <int D>
__device__ __forceinline__ uint64_t ndesc_k(uint32_t tile, int kk) {
  return ndesc<D>(tile + kk * 32, 16);
}

// An R-row tile as an MN-major operand (K = the rows, N = D): k step kk 16
// rows down.
template <int D, int R>
__device__ __forceinline__ uint64_t ndesc_mn(uint32_t tile, int kk) {
  return ndesc<D>(tile + kk * 16 * row_bytes<D>(), ntile_bytes<D, R>());
}

// Two R-row tiles of one (row, head), ``m0``'s at dst and ``m1``'s after
// it, completing on ``bar`` (one TMA box each).
template <int D, int R = kTile>
__device__ __forceinline__ void ntma_pair(uint32_t dst, const CUtensorMap* m0,
                                          const CUtensorMap* m1,
                                          uint64_t* bar, int row, int head) {
  mbar_expect_tx(bar, 2 * ntile_bytes<D, R>());
  tma_box(dst, m0, bar, 0, row, head);
  tma_box(dst + ntile_bytes<D, R>(), m1, bar, 0, row, head);
}

}  // namespace
