// Device and host helpers shared by the sm_90a flash-attention kernels
// (csrc/flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu): the BandMask
// predicates, mbarriers, TMA, wgmma descriptors and products (inline PTX),
// the accumulator store, and the host-side tensor-map encoder.
//
// Layout contract.  Every staged tile is 64 rows of D bf16 values, written
// by TMA with the 128-byte swizzle in D/64 chunks of 64 x 64 (8 KB each),
// 1024-byte aligned.  ``desc_k`` reads such a tile as a K-major operand
// (K = D), ``desc_mn`` as an MN-major one (K = the 64 rows).  The wgmma
// accumulator of a thread holds rows 16*warp + lane/4 (+8) and columns
// 8*j + 2*(lane%4) (+1); packed to bf16 pairs it is the A fragment of the
// next product.  The mask predicates take any argument struct with the
// fields lq, lk, kv_valid, q_off_lo, q_off_hi, k_off_lo, k_off_hi, q_seg,
// k_seg, causal, window, packed and doc_skip.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;          // rows of every staged tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kChunk = kTile * 128;  // 64 rows x 64 bf16: one swizzle span
constexpr int kDocAbsent = 0x7fffffff;
constexpr long long kWaitCycles = 1LL << 33;
// Error codes beside cudaError_t's.
constexpr int kErrEntryPoint = 30000;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 20000;       // + its CUresult

// Bytes of one staged 64 x D bf16 tile.
template <int D>
__host__ __device__ constexpr int tile_bytes() { return kTile * D * 2; }

// ---------------------------------------------------------------------------
// The mask (as in csrc/flash_bwd.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int logical_pos(int idx, int lo, int hi, int seg) {
  return seg == 0 ? idx + hi : idx + (idx < seg ? lo : hi);
}

// ``_run_predicate`` at tile edges: logical positions and the doc-start
// table are nondecreasing in the physical index, so a tile's extrema sit
// at its edges.
template <class A>
__device__ __forceinline__ bool tile_runs(const A& a, int q0, int k0,
                                          int doc_first) {
  const int q_first = logical_pos(q0, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int q_last =
      logical_pos(q0 + kTile - 1, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int k_first = logical_pos(k0, a.k_off_lo, a.k_off_hi, a.k_seg);
  const int k_last =
      logical_pos(k0 + kTile - 1, a.k_off_lo, a.k_off_hi, a.k_seg);
  bool run = k0 < a.kv_valid;
  if (a.causal) run = run && k_first <= q_last;
  if (a.window >= 0) run = run && k_last >= q_first - (a.window - 1);
  if (a.packed && a.doc_skip) run = run && k_last >= doc_first;
  return run;
}

// Whether every (row, key) pair of the tile is visible, so the per-element
// test can be skipped; ``doc_last`` is the tile's last row's doc start.
template <class A>
__device__ __forceinline__ bool tile_full(const A& a, int q0, int k0,
                                          int doc_last) {
  if (q0 + kTile > a.lq || k0 + kTile > a.lk || k0 + kTile > a.kv_valid)
    return false;
  if (!a.causal && a.window < 0) return true;
  const int q_first = logical_pos(q0, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int q_last =
      logical_pos(q0 + kTile - 1, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int k_first = logical_pos(k0, a.k_off_lo, a.k_off_hi, a.k_seg);
  const int k_last =
      logical_pos(k0 + kTile - 1, a.k_off_lo, a.k_off_hi, a.k_seg);
  bool full = true;
  if (a.causal) full = full && k_last <= q_first;
  if (a.packed) full = full && k_first >= doc_last;
  if (a.window >= 0) full = full && k_first >= q_last - (a.window - 1);
  return full;
}

// Whether query row ``row`` (logical ``qlog``, doc start ``qdoc``) sees key
// ``col``.
template <class A>
__device__ __forceinline__ bool visible(const A& a, int row, int qlog,
                                        int qdoc, int col) {
  bool ok = row < a.lq && col < a.lk && col < a.kv_valid;
  if (a.causal || a.window >= 0) {
    const int kl = logical_pos(col, a.k_off_lo, a.k_off_hi, a.k_seg);
    if (a.causal) ok = ok && kl <= qlog;
    if (a.packed) ok = ok && kl >= qdoc;
    if (a.window >= 0) ok = ok && kl >= qlog - (a.window - 1);
  }
  return ok;
}

// The next K tile after ``kt`` that the band reaches from q tile q0; ``nk``
// when none is left.
template <class A>
__device__ __forceinline__ int next_k_tile(const A& a, int q0,
                                           int doc_first, int kt, int nk) {
  for (++kt; kt < nk; ++kt)
    if (tile_runs(a, q0, kt * kTile, doc_first)) return kt;
  return nk;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitCycles) {
      __trap();
    }
  }
}

// One 64 x 64 box of a (heads, rows, D) tensor map into shared memory.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(head), "r"(smem_u32(bar))
      : "memory");
}

// A 64-row tile (D/64 chunks of 64 x 64, each swizzled in 128-byte rows).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_box(dst + c * kChunk, map, bar, c * 64, row, head);
}

// Two 64-row tiles of one (row, head), ``m0``'s at dst and ``m1``'s after
// it, completing on ``bar``.
template <int D>
__device__ __forceinline__ void tma_pair(uint32_t dst, const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint64_t* bar,
                                         int row, int head) {
  mbar_expect_tx(bar, 2 * tile_bytes<D>());
  tma_tile<D>(dst, m0, bar, row, head);
  tma_tile<D>(dst + tile_bytes<D>(), m1, bar, row, head);
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A tile as a K-major operand (rows = M or N, columns = K = D): k step kk
// covers columns 16kk..16kk+15, 32 bytes into the swizzled row.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + (kk >> 2) * kChunk + (kk & 3) * 32, 16, 1024);
}

// A tile as an MN-major operand (rows = K, columns = N = D): k step kk
// covers rows 16kk..16kk+15; the 64-column chunks lie kChunk apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kChunk, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// ---- wgmma (generated operand lists) ----

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major (no transpose); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory K-major
// (no transpose); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

// Stores a 64 x D fp32 accumulator as bf16 rows ``row0 + 16*warp + lane/4
// (+8)`` of a (rows, D) matrix, skipping rows at or past ``rows``.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           int row_a, int rows, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + static_cast<size_t>(row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and error strings
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over a contiguous (heads, rows, d) bf16 tensor: boxes of 64 rows x
// 64 columns of one head, 128-byte swizzle, zeros past the edges.
int make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int d) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrEntryPoint;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// The text of a launch's return code: a cudaError_t or one of the codes
// above.
const char* sm90_error_string(int err) {
  if (err == kErrEntryPoint)
    return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (err >= kErrEncode && err < kErrEntryPoint)
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code "
           "- 20000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
