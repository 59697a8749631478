// Flash-attention backward for Hopper's tensor cores (sm_90a), written by
// hand in CUDA C++: the bf16 dq kernel and the bf16 dk/dv kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289) and
// ::_dkv_kernel (:331), the Pallas TPU kernels launched by ``_bwd``, for
// bf16 operands at D = 64 and 128.  fp32 operands, and bf16 at a head dim
// below 64, keep the FMA kernels of csrc/flash_bwd.cu.  Same function and
// folded layout as those: q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) bf16; lse
// and dsum = rowsum(dO * O) (B*Hq, Lq) fp32; GQA: q row b reads KV row
// b / group.  P = exp(s - lse) on visible keys (a row whose lse is -1e30
// uses shift 0 and sees no key); dS = P * (dO.V^T - dsum), times
// (1 - (s_c/cap)^2) under a softcap, times the scale; dq = dS.K,
// dk = dS^T.Q, dv = P^T.dO.  The mask (kv_valid, causal, window, packed
// documents from the five band ints, q_seg / k_seg and the doc table) and
// the whole-tile skip are the other kernels', all plain launch arguments.
//
// What bounds it on an H100.  Compute: dq is three products of 2*L*L*D
// FLOPs a head (s, dP, dS.K), dk/dv four (s, dP, P^T.dO, dS^T.Q), halved
// under causal, against 989 TFLOP/s of bf16 tensor-core throughput (at
// B=2, L=4096, Hq=16, D=128 causal: 206.2 and 274.9 GFLOP, 0.2085 and
// 0.2780 ms).  The bytes (each operand read once) are far below that.
//
// Design.
//   Products.  Every product is a bf16 ``wgmma.mma_async`` with fp32
//   accumulation, issued by one warpgroup (128 threads) that owns a 64-row
//   tile.  dk/dv: a block owns 64 keys of one KV head and walks all
//   group * nq q tiles of its query heads, so the GQA sum stays in
//   registers: S^T = K.Q^T and dP^T = V.dO^T (A = K/V, B = Q/dO, both
//   K-major in shared memory), then P^T and dS^T in registers, then
//   dV += P^T.dO and dK += dS^T.Q with A taken from registers (the
//   accumulator fragment of S^T rounded to bf16 is the A fragment of the
//   next product) and B = dO/Q read MN-major (wgmma's transpose bit), so
//   no shared memory holds P or dS.  dq: a block owns 64 q rows and walks
//   the K tiles: S = Q.K^T, dP = dO.V^T, then dQ += dS.K with dS from
//   registers and K MN-major.  Registers a thread at D = 128: dK and dV
//   128, S^T and dP^T 64 (dq: dQ 64, S and dP 64).  No atomics: the result
//   is deterministic.
//   Numerics.  P and dS are rounded to bf16 before the second products
//   (the TPU kernel keeps them in fp32); the sums stay fp32.
//   Staging.  The tiles the loop walks (Q/dO for dk/dv, K/V for dq) come
//   through a ring of two stages, filled by TMA (cp.async.bulk.tensor)
//   with the 128-byte swizzle that wgmma's descriptors read, completing
//   on mbarriers; the next-but-one tile is requested as soon as a stage is
//   free, so loads overlap the math.  A 3-D tensor map per operand
//   (D, rows, heads) zero-fills rows past Lq / Lk, so the ragged edge
//   needs no padding.  The maps are encoded on the host for each launch
//   with cuTensorMapEncodeTiled, fetched from the driver through
//   cudaGetDriverEntryPoint(ByVersion) so the library links against the
//   CUDA runtime only (no -lcuda).  A wait that never completes traps
//   after about 4 s of clock instead of hanging the card.
//   Occupancy.  96 KB of tiles at D = 128 (99.9 KB with the stats, the
//   barriers and the alignment slack) and 128 threads: two blocks an SM.
//   The grid puts the tile index on its slow axis, heaviest first under
//   causal (key tile 0 for dk/dv, the last q tile for dq), so the long
//   blocks start first and the short ones fill the tail.
//   Masks.  A tile the band cannot reach is skipped (``tile_runs``); a
//   tile wholly inside the band, window, kv_valid, lengths and document
//   (``tile_full``) skips the per-element test; only tiles an edge crosses
//   apply it, on the accumulator fragment (row 16*warp + lane/4 (+8),
//   column 8*j + 2*(lane%4) (+1)).
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dq_sm90_kernel<64>   138, 0      flash_dkv_sm90_kernel<64>  168, 0
//   flash_dq_sm90_kernel<128>  171, 0      flash_dkv_sm90_kernel<128> 234, 0
// (no stack frame), under the 255 that two 128-thread blocks an SM allow.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;          // rows of every staged tile; keys of a
                                   // dk/dv block, q rows of a dq block
constexpr int kThreads = 128;      // one warpgroup
constexpr int kChunk = kTile * 128;  // 64 rows x 64 bf16: one swizzle span
constexpr int kDocAbsent = 0x7fffffff;
constexpr long long kWaitCycles = 1LL << 33;
// Error codes beside cudaError_t's.
constexpr int kErrEntryPoint = 30000;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 20000;       // + its CUresult

struct Args {
  const float* lse;              // (B*Hq, Lq)
  const float* dsum;             // (B*Hq, Lq)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int* doc;                // (B, Lq) per-row doc start, or null
  int bh, group, lq, lk, q_mult;
  int q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg, k_seg;
  int causal, window, packed, doc_skip;   // window < 0: no window
  float softcap, scale;
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base): two
// fixed tiles, two stages of two tiles, 64 shifts and 64 dsums, three
// mbarriers (the stages', then the fixed tiles').
template <int D>
struct Smem {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kStage = 2 * kTileBytes;   // stage s at kStage*(1+s)
  static constexpr int kStats = 6 * kTileBytes;
  static constexpr int kBars = kStats + 2 * kTile * 4;
  static constexpr int kBytes = kBars + 3 * 8 + 1024;   // + alignment slack
};

// ---------------------------------------------------------------------------
// The mask (as in csrc/flash_bwd.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int logical_pos(int idx, int lo, int hi, int seg) {
  return seg == 0 ? idx + hi : idx + (idx < seg ? lo : hi);
}

// ``_run_predicate`` at tile edges: logical positions and the doc-start
// table are nondecreasing in the physical index, so a tile's extrema sit
// at its edges.
__device__ __forceinline__ bool tile_runs(const Args& a, int q0, int k0,
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
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0,
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
__device__ __forceinline__ bool visible(const Args& a, int row, int qlog,
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

// (p, ds) of one score from the raw product q.k, the row's shift times
// log2(e), its dsum, and dO.v.
__device__ __forceinline__ void p_ds(const Args& a, float qk, float shift_l2,
                                     float dsum, float dp, float& p,
                                     float& ds) {
  if (a.softcap != 0.f) {
    const float t = tanhf(qk * a.scale / a.softcap);
    p = exp2f(a.softcap * kLog2e * t - shift_l2);
    ds = p * (dp - dsum) * (a.scale * (1.f - t * t));
  } else {
    p = exp2f(fmaf(qk, a.scale * kLog2e, -shift_l2));
    ds = p * (dp - dsum) * a.scale;
  }
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
  mbar_expect_tx(bar, 2 * Smem<D>::kTileBytes);
  tma_tile<D>(dst, m0, bar, row, head);
  tma_tile<D>(dst + Smem<D>::kTileBytes, m1, bar, row, head);
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
// dk / dv
// ---------------------------------------------------------------------------

// The next q step after ``g`` (q row bkv*group + g/nq, q tile g%nq) whose
// tile the band reaches from key tile k0; ``steps`` when none is left.
__device__ __forceinline__ int next_q_step(const Args& a, int k0, int bkv,
                                           int g, int nq) {
  const int steps = a.group * nq;
  for (++g; g < steps; ++g) {
    const int b = bkv * a.group + g / nq;
    const int q0 = (g % nq) * kTile;
    const int doc_first =
        a.packed ? a.doc[static_cast<size_t>(b / a.q_mult) * a.lq + q0] : 0;
    if (tile_runs(a, q0, k0, doc_first)) return g;
  }
  return steps;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const Args a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kTileBytes;
  float* s_shift = reinterpret_cast<float*>(smem + L::kStats);
  float* s_dsum = s_shift + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int nq = (a.lq + kTile - 1) / kTile;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * warp + (lane >> 2);   // accumulator rows
  const int key_b = key_a + 8;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  int g = next_q_step(a, k0, bkv, -1, nq);          // block-uniform
  if (g < steps) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int gn = next_q_step(a, k0, bkv, g, nq);
    if (tid == 0) {               // K, V; Q and dO of steps g, gn
      tma_pair<D>(sK, &tm_k, &tm_v, &bars[2], k0, bkv);
      tma_pair<D>(sK + L::kStage, &tm_q, &tm_do, &bars[0], (g % nq) * kTile,
                  bkv * a.group + g / nq);
      if (gn < steps)
        tma_pair<D>(sK + 2 * L::kStage, &tm_q, &tm_do, &bars[1],
                    (gn % nq) * kTile, bkv * a.group + gn / nq);
    }
    mbar_wait(&bars[2], 0);

    for (int it = 0; g < steps; ++it) {
      const int s = it & 1;
      const int b = bkv * a.group + g / nq;
      const int q0 = (g % nq) * kTile;
      const uint32_t sQ = sK + L::kStage * (1 + s);
      const uint32_t sDO = sQ + L::kTileBytes;
      float lse_v = kNegInf, dsum_v = 0.f;
      if (tid < kTile && q0 + tid < a.lq) {
        lse_v = a.lse[static_cast<size_t>(b) * a.lq + q0 + tid];
        dsum_v = a.dsum[static_cast<size_t>(b) * a.lq + q0 + tid];
      }
      mbar_wait(&bars[s], (it >> 1) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns q rows.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, desc_k(sK, kk), desc_k(sQ, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k(sV, kk), desc_k(sDO, kk), kk);
      wgmma_commit();
      if (tid < kTile) {
        s_shift[tid] = (lse_v <= kNegInf / 2 ? 0.f : lse_v) * kLog2e;
        s_dsum[tid] = dsum_v;
      }
      __syncthreads();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      const int* docp =
          a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq
                   : nullptr;
      const bool full = tile_full(
          a, q0, k0, a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0);
      // P^T and dS^T as the A fragments of the next products: k step kk
      // takes accumulator column blocks j = 2kk, 2kk+1.
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = half ? key_b : key_a;
          float p2[2], ds2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * half + h;
            const int c = 8 * j + 2 * (lane & 3) + h;
            p_ds(a, st[i], s_shift[c], s_dsum[c], dpt[i], p2[h], ds2[h]);
            if (!full) {
              const int row = q0 + c;
              const int qlog =
                  logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
              const int qdoc =
                  (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
              if (!visible(a, row, qlog, qdoc, key)) p2[h] = ds2[h] = 0.f;
            }
          }
          pa[j >> 1][(j & 1) * 2 + half] = pack_bf16(p2[0], p2[1]);
          dsa[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
        }
      }

      // dV += P^T.dO and dK += dS^T.Q (B MN-major: K = the 64 q rows).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], desc_mn(sDO, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, dsa[kk], desc_mn(sQ, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      __syncthreads();               // stage s and the stats are free
      const int ga = gn < steps ? next_q_step(a, k0, bkv, gn, nq) : steps;
      if (tid == 0 && ga < steps)
        tma_pair<D>(sQ, &tm_q, &tm_do, &bars[s], (ga % nq) * kTile,
                    bkv * a.group + ga / nq);
      g = gn;
      gn = ga;
    }
  }
  const size_t base = static_cast<size_t>(bkv) * a.lk * D;
  store_rows<D>(a.dk + base, dk, key_a, a.lk, lane);
  store_rows<D>(a.dv + base, dv, key_a, a.lk, lane);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// The next K tile after ``kt`` that the band reaches from q tile q0; ``nk``
// when none is left.
__device__ __forceinline__ int next_k_tile(const Args& a, int q0,
                                           int doc_first, int kt, int nk) {
  for (++kt; kt < nk; ++kt)
    if (tile_runs(a, q0, kt * kTile, doc_first)) return kt;
  return nk;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Args a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sDO = sQ + L::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + kTile - 1) / kTile;
  const int row_a = q0 + 16 * warp + (lane >> 2);   // accumulator rows
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  int kt = next_k_tile(a, q0, doc_first, -1, nk);   // block-uniform
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int kn = next_k_tile(a, q0, doc_first, kt, nk);
    if (tid == 0) {               // Q, dO; K and V of tiles kt, kn
      tma_pair<D>(sQ, &tm_q, &tm_do, &bars[2], q0, b);
      tma_pair<D>(sQ + L::kStage, &tm_k, &tm_v, &bars[0], kt * kTile, bkv);
      if (kn < nk)
        tma_pair<D>(sQ + 2 * L::kStage, &tm_k, &tm_v, &bars[1], kn * kTile,
                    bkv);
    }
    float shift_l2[2], dsum[2];
    int qlog[2], qdoc[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      const bool in = row < a.lq;
      const float lse = in ? a.lse[static_cast<size_t>(b) * a.lq + row]
                           : kNegInf;
      shift_l2[half] = (lse <= kNegInf / 2 ? 0.f : lse) * kLog2e;
      dsum[half] = in ? a.dsum[static_cast<size_t>(b) * a.lq + row] : 0.f;
      qlog[half] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      qdoc[half] = (a.packed && in) ? docp[row] : kDocAbsent;
    }
    mbar_wait(&bars[2], 0);

    for (int it = 0; kt < nk; ++it) {
      const int s = it & 1;
      const int k0 = kt * kTile;
      const uint32_t sK = sQ + L::kStage * (1 + s);
      const uint32_t sV = sK + L::kTileBytes;
      mbar_wait(&bars[s], (it >> 1) & 1);

      // S = Q.K^T and dP = dO.V^T: rows are q rows, columns keys.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k(sQ, kk), desc_k(sK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k(sDO, kk), desc_k(sV, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      const bool full = tile_full(a, q0, k0, doc_last);
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float ds2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * half + h;
            const int col = k0 + 8 * j + 2 * (lane & 3) + h;
            float p;
            p_ds(a, sc[i], shift_l2[half], dsum[half], dp[i], p, ds2[h]);
            if (!full && !visible(a, row_a + 8 * half, qlog[half],
                                  qdoc[half], col))
              ds2[h] = 0.f;
          }
          dsa[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
        }
      }

      // dQ += dS.K (B MN-major: K = the 64 keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, dsa[kk], desc_mn(sK, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      __syncthreads();               // stage s is free
      const int ka = kn < nk ? next_k_tile(a, q0, doc_first, kn, nk) : nk;
      if (tid == 0 && ka < nk)
        tma_pair<D>(sK, &tm_k, &tm_v, &bars[s], ka * kTile, bkv);
      kt = kn;
      kn = ka;
    }
  }
  store_rows<D>(a.dq + static_cast<size_t>(b) * a.lq * D, dq, row_a, a.lq,
                lane);
}

// ---------------------------------------------------------------------------
// Launch
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

template <int D>
int launch(int which, const Args& a, const CUtensorMap (&m)[4], int bhkv,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes;
  auto kernel = which ? flash_dkv_sm90_kernel<D> : flash_dq_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The tile index on the slow axis: blocks start tile by tile.
  const dim3 grid = which ? dim3(bhkv, (a.lk + kTile - 1) / kTile)
                          : dim3(a.bh, (a.lq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dsum, void* o0,
        void* o1, const void* doc, int is_bf16, int bh, int bhkv, int lq,
        int lk, int d, int q_off_lo, int q_off_hi, int k_off_lo,
        int k_off_hi, int kv_valid, int q_seg, int k_seg, int causal,
        int window, float softcap, float scale, int packed, int doc_skip,
        int doc_rows, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  if (!is_bf16 || (d != 64 && d != 128) || !aligned || bh <= 0 ||
      bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int err = make_map(&maps[0], q, bh, lq, d);
  if (err == 0) err = make_map(&maps[1], dout, bh, lq, d);
  if (err == 0) err = make_map(&maps[2], k, bhkv, lk, d);
  if (err == 0) err = make_map(&maps[3], v, bhkv, lk, d);
  if (err != 0) return err;
  Args a;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = static_cast<__nv_bfloat16*>(which ? nullptr : o0);
  a.dk = static_cast<__nv_bfloat16*>(which ? o0 : nullptr);
  a.dv = static_cast<__nv_bfloat16*>(which ? o1 : nullptr);
  a.doc = static_cast<const int*>(doc);
  a.bh = bh;
  a.group = bh / bhkv;
  a.lq = lq;
  a.lk = lk;
  a.q_mult = packed ? bh / doc_rows : 1;
  a.q_off_lo = q_off_lo;
  a.q_off_hi = q_off_hi;
  a.k_off_lo = k_off_lo;
  a.k_off_hi = k_off_hi;
  a.kv_valid = kv_valid;
  a.q_seg = q_seg;
  a.k_seg = k_seg;
  a.causal = causal;
  a.window = window;
  a.packed = packed;
  a.doc_skip = doc_skip;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 128 ? launch<128>(which, a, maps, bhkv, st)
                  : launch<64>(which, a, maps, bhkv, st);
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd.cu's entry points (is_bf16 must be
// 1 and d 64 or 128).  Each returns 0 when launched, else a cudaError_t or
// one of this file's codes (flash_bwd_sm90_error_string names them).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, const void* doc, int is_bf16, int bh,
                      int bhkv, int lq, int lk, int d, int q_off_lo,
                      int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
                      int q_seg, int k_seg, int causal, int window,
                      float softcap, float scale, int packed, int doc_skip,
                      int doc_rows, void* stream) {
  return run(0, q, k, v, dout, lse, dsum, dq, nullptr, doc, is_bf16, bh,
             bhkv, lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi,
             kv_valid, q_seg, k_seg, causal, window, softcap, scale, packed,
             doc_skip, doc_rows, stream);
}

int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, const void* doc, int is_bf16,
                       int bh, int bhkv, int lq, int lk, int d, int q_off_lo,
                       int q_off_hi, int k_off_lo, int k_off_hi,
                       int kv_valid, int q_seg, int k_seg, int causal,
                       int window, float softcap, float scale, int packed,
                       int doc_skip, int doc_rows, void* stream) {
  return run(1, q, k, v, dout, lse, dsum, dk, dv, doc, is_bf16, bh, bhkv,
             lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid,
             q_seg, k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

const char* flash_bwd_sm90_error_string(int err) {
  if (err == kErrEntryPoint)
    return "cuTensorMapEncodeTiled not found in the driver";
  if (err >= kErrEncode && err < kErrEntryPoint)
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code "
           "- 20000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
