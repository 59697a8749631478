// Device and host helpers shared by the sm_90a flash-attention kernels
// (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu, csrc/flash_fwd_sm90_wide.cu,
// csrc/flash_fwd_sm90_d384.cu, csrc/flash_dq_sm90_wide.cu,
// csrc/flash_dkv_sm90_wide.cu, csrc/flash_bwd_sm90_d384.cu, through
// csrc/sm90_narrow.cuh csrc/flash_fwd_sm90_narrow.cu and
// csrc/flash_bwd_sm90_narrow.cu, and, for the mask predicates and
// smem_u32, the fp32 3xTF32 backward through csrc/tf32x3.cuh): the BandMask
// predicates,
// the forward's online softmax (``softmax_tile``, and ``softmax_tile_ex2``
// with the softcap and the mask chosen once a tile) and the backward's
// (p, ds), mbarriers, TMA, wgmma descriptors and products (inline PTX), the
// accumulator store, and the host-side tensor-map encoder.
//
// Layout contract.  Every staged tile is R rows (64 unless a kernel says
// otherwise; the wide kernels stage 48-key tiles) of D bf16 values, written
// by TMA with the 128-byte swizzle in ceil(D/64) chunks of R x 64 (R * 128
// bytes each), 1024-byte aligned.  When D is not a multiple of 64 (gemma2's
// 288, or D 16 / 32 in one chunk) the last chunk's columns past D are
// zeros: the tensor map's box runs
// past the tensor's last column and TMA fills it with zeros, yet counts the
// whole box's bytes.  ``desc_k`` reads such a tile as a K-major operand
// (K = D), ``desc_mn`` as an MN-major one (K = the R rows).  The wgmma
// accumulator of a thread holds rows 16*warp + lane/4 (+8) and columns
// 8*j + 2*(lane%4) (+1); packed to bf16 pairs it is the A fragment of the
// next product.  The mask predicates take any argument struct with the
// fields lq, lk, kv_valid, q_off_lo, q_off_hi, k_off_lo, k_off_hi, q_seg,
// k_seg, causal, window, packed and doc_skip; their q and key extents are
// template arguments (64 and 64 unless given).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;          // rows of every staged tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kChunk = kTile * 128;  // 64 rows x 64 bf16: one swizzle span
constexpr int kDocAbsent = 0x7fffffff;
constexpr long long kWaitCycles = 1LL << 33;
// Error codes beside cudaError_t's.
constexpr int kErrEntryPoint = 30000;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 20000;       // + its CUresult

// Bytes of one staged R x D bf16 tile: ceil(D/64) chunks of R x 64.
template <int D, int R = kTile>
__host__ __device__ constexpr int tile_bytes() {
  return R * 128 * ((D + 63) / 64);
}

// ---------------------------------------------------------------------------
// The mask
// ---------------------------------------------------------------------------

__device__ __forceinline__ int logical_pos(int idx, int lo, int hi, int seg) {
  return seg == 0 ? idx + hi : idx + (idx < seg ? lo : hi);
}

// ``_run_predicate`` at tile edges (QR q rows from q0, KR keys from k0):
// logical positions and the doc-start table are nondecreasing in the
// physical index, so a tile's extrema sit at its edges.
template <int QR = kTile, int KR = kTile, class A>
__device__ __forceinline__ bool tile_runs(const A& a, int q0, int k0,
                                          int doc_first) {
  const int q_first = logical_pos(q0, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int q_last =
      logical_pos(q0 + QR - 1, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int k_first = logical_pos(k0, a.k_off_lo, a.k_off_hi, a.k_seg);
  const int k_last =
      logical_pos(k0 + KR - 1, a.k_off_lo, a.k_off_hi, a.k_seg);
  bool run = k0 < a.kv_valid;
  if (a.causal) run = run && k_first <= q_last;
  if (a.window >= 0) run = run && k_last >= q_first - (a.window - 1);
  if (a.packed && a.doc_skip) run = run && k_last >= doc_first;
  return run;
}

// Whether every (row, key) pair of the tile is visible, so the per-element
// test can be skipped; ``doc_last`` is the tile's last row's doc start.
template <int QR = kTile, int KR = kTile, class A>
__device__ __forceinline__ bool tile_full(const A& a, int q0, int k0,
                                          int doc_last) {
  if (q0 + QR > a.lq || k0 + KR > a.lk || k0 + KR > a.kv_valid)
    return false;
  if (!a.causal && a.window < 0) return true;
  const int q_first = logical_pos(q0, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int q_last =
      logical_pos(q0 + QR - 1, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int k_first = logical_pos(k0, a.k_off_lo, a.k_off_hi, a.k_seg);
  const int k_last =
      logical_pos(k0 + KR - 1, a.k_off_lo, a.k_off_hi, a.k_seg);
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

// The next K tile (of KR keys) after ``kt`` that the band reaches from the
// QR q rows at q0; ``nk`` when none is left.
template <int QR = kTile, int KR = kTile, class A>
__device__ __forceinline__ int next_k_tile(const A& a, int q0,
                                           int doc_first, int kt, int nk) {
  for (++kt; kt < nk; ++kt)
    if (tile_runs<QR, KR>(a, q0, kt * KR, doc_first)) return kt;
  return nk;
}

// The next q step after ``g`` (q row bkv*group + g/nq, q tile g%nq of QR
// rows) whose tile the band reaches from the KR keys at k0; ``group * nq``
// when none is left.  ``A`` also needs the fields group, q_mult and doc.
template <int QR = kTile, int KR = kTile, class A>
__device__ __forceinline__ int next_q_step(const A& a, int k0, int bkv,
                                           int g, int nq) {
  const int steps = a.group * nq;
  for (++g; g < steps; ++g) {
    const int b = bkv * a.group + g / nq;
    const int q0 = (g % nq) * QR;
    const int doc_first =
        a.packed ? a.doc[static_cast<size_t>(b / a.q_mult) * a.lq + q0] : 0;
    if (tile_runs<QR, KR>(a, q0, k0, doc_first)) return g;
  }
  return steps;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The forward kernels' launch arguments.
struct FwdArgs {
  const __nv_bfloat16* q;        // (B*Hq, Lq, D)
  __nv_bfloat16* out;            // (B*Hq, Lq, D)
  float* lse;                    // (B*Hq, Lq)
  const int* doc;                // (B, Lq) per-row doc start, or null
  int bh, group, lq, lk, q_mult;
  int q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg, k_seg;
  int causal, window, packed, doc_skip;   // window < 0: no window
  float softcap, scale;
};

// 2^x on the special-function unit (2 ulp; denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One K tile's step of the online softmax on the S accumulator fragment of
// NJ column blocks (8 NJ keys; rows row_a, row_a + 8; columns k0 + 8j +
// 2(lane%4) (+1)), for the forward kernels.  The scores
// are s * scale * log2(e), or under the softcap softcap * log2(e) *
// tanh(s * scale / softcap), in log2 units; keys a row does not see are
// -1e30 unless the tile is ``full``.  The row maxima ``m`` (over the row's
// quad of lanes) and this thread's partial sums ``l`` move on; ``alpha`` =
// 2^(m_old - m_new) is the factor O must be scaled by (0 for a row that
// had seen no key: such a row keeps shift 0, so no exp of an infinity).
// ``pa`` receives P in bf16 as the A fragments of P.V (k step kk takes
// accumulator column blocks j = 2kk, 2kk+1); l sums the fp32 P.
// The common path (no softcap, a full tile) costs a max, an FFMA, an ex2
// and an add per score: the scale is applied to the raw maximum and folded
// into the FFMA, which keeps the order of the scores because the scale is
// positive; a negative scale reverses it, so it is applied first, as the
// softcap is.
template <int NJ, class A>
__device__ __forceinline__ void softmax_tile(
    const A& a, float (&sc)[4 * NJ], uint32_t (&pa)[NJ / 2][4],
    float (&m)[2], float (&l)[2], float (&alpha)[2], bool full, int row_a,
    const int (&qlog)[2], const int (&qdoc)[2], int k0, int lane) {
  float scale = a.scale * kLog2e;            // raw score -> log2 units
  if (a.softcap != 0.f) {
    const float inner = a.scale / a.softcap;
    const float outer = a.softcap * kLog2e;
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) sc[i] = outer * tanhf(sc[i] * inner);
    scale = 1.f;
  } else if (scale < 0.f) {
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) sc[i] *= scale;
    scale = 1.f;
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (!visible(a, row_a + 8 * half, qlog[half], qdoc[half],
                       k0 + 8 * j + 2 * (lane & 3) + h))
            sc[4 * j + 2 * half + h] = kNegInf;
  }
  float shift[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * half], sc[4 * j + 2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new =
        fmaxf(m[half], mx <= kNegInf / 2 ? kNegInf : mx * scale);
    shift[half] = m_new <= kNegInf / 2 ? 0.f : m_new;
    alpha[half] = m[half] <= kNegInf / 2 ? 0.f : ex2(m[half] - shift[half]);
    m[half] = m_new;
    l[half] *= alpha[half];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float p0 = ex2(fmaf(sc[4 * j + 2 * half], scale, -shift[half]));
      const float p1 =
          ex2(fmaf(sc[4 * j + 2 * half + 1], scale, -shift[half]));
      l[half] += p0 + p1;
      pa[j >> 1][(j & 1) * 2 + half] = pack_bf16(p0, p1);
    }
  }
}

// The factors of a forward score, taken once a launch, for
// ``softmax_tile_ex2``.  Without the softcap the score in log2 units is
// s * g with g = scale * log2(e); under it, th * g with th = tanh(s * scale
// / |cap|) = 1 - 2 / (2^(s * tin) + 1) and g = |cap| * log2(e) (cap *
// tanh(x / cap) is even in the sign of cap).
struct ScoreFactors {
  float g, tin;
};

__device__ __forceinline__ ScoreFactors score_factors(const FwdArgs& a) {
  ScoreFactors f;
  if (a.softcap != 0.f) {
    const float cap = fabsf(a.softcap);
    f.g = cap * kLog2e;
    f.tin = 2.f * kLog2e * a.scale / cap;
  } else {
    f.g = a.scale * kLog2e;
    f.tin = 0.f;
  }
  return f;
}

// ``softmax_tile``'s step with the softcap (kCap) and the per-element mask
// (kMask) chosen at compile time, and the softcap's tanh taken by
// ``ex2.approx`` and ``rcp.approx`` (as the sm90n and sm90w backward
// kernels take it).  The max is taken on the raw scores (or on th) and g
// folds into the one FFMA from there to the exponent; a negative g (a
// negative scale without the softcap), which reverses the order, is
// applied first.  Keys a row does not see score -1e30 under kMask, so
// their P is 0.
template <bool kCap, bool kMask, int NJ, class A>
__device__ __forceinline__ void softmax_ex2(
    const A& a, const ScoreFactors& f, float (&sc)[4 * NJ],
    uint32_t (&pa)[NJ / 2][4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int row_a, const int (&qlog)[2],
    const int (&qdoc)[2], int k0, int lane) {
  float g = f.g;
  if constexpr (kCap) {
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i)
      sc[i] = 1.f - __fdividef(2.f, ex2(sc[i] * f.tin) + 1.f);
  } else if (g <= 0.f) {
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) sc[i] *= g;
    g = 1.f;
  }
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (!visible(a, row_a + 8 * half, qlog[half], qdoc[half],
                       k0 + 8 * j + 2 * (lane & 3) + h))
            sc[4 * j + 2 * half + h] = kNegInf;
  }
  float shift[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * half], sc[4 * j + 2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[half], mx <= kNegInf / 2 ? kNegInf : mx * g);
    shift[half] = m_new <= kNegInf / 2 ? 0.f : m_new;
    alpha[half] = m[half] <= kNegInf / 2 ? 0.f : ex2(m[half] - shift[half]);
    m[half] = m_new;
    l[half] *= alpha[half];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float p0 = ex2(fmaf(sc[4 * j + 2 * half], g, -shift[half]));
      const float p1 = ex2(fmaf(sc[4 * j + 2 * half + 1], g, -shift[half]));
      l[half] += p0 + p1;
      pa[j >> 1][(j & 1) * 2 + half] = pack_bf16(p0, p1);
    }
  }
}

// One K tile's step of the online softmax as ``softmax_tile`` computes it
// (the same arguments and results), for the sm90n forward and the sm90w
// forward at D 384: the softcap and the mask are chosen once a tile (a
// uniform branch) and each score costs, on a full tile without the
// softcap, a max, an FFMA, an ex2 and an add.
template <int NJ, class A>
__device__ __forceinline__ void softmax_tile_ex2(
    const A& a, const ScoreFactors& f, float (&sc)[4 * NJ],
    uint32_t (&pa)[NJ / 2][4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], bool full, int row_a, const int (&qlog)[2],
    const int (&qdoc)[2], int k0, int lane) {
  if (a.softcap != 0.f) {
    if (full)
      softmax_ex2<true, false, NJ>(a, f, sc, pa, m, l, alpha, row_a, qlog,
                                   qdoc, k0, lane);
    else
      softmax_ex2<true, true, NJ>(a, f, sc, pa, m, l, alpha, row_a, qlog,
                                  qdoc, k0, lane);
  } else {
    if (full)
      softmax_ex2<false, false, NJ>(a, f, sc, pa, m, l, alpha, row_a, qlog,
                                    qdoc, k0, lane);
    else
      softmax_ex2<false, true, NJ>(a, f, sc, pa, m, l, alpha, row_a, qlog,
                                   qdoc, k0, lane);
  }
}

// The bf16 backward kernels' launch arguments.
struct BwdArgs {
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

// (p, ds) of one score for the bf16 backward kernels, from the raw
// product q.k, the row's shift times log2(e), its dsum, and dO.v.
__device__ __forceinline__ void p_ds_exp2(const BwdArgs& a, float qk,
                                          float shift_l2, float dsum,
                                          float dp, float& p, float& ds) {
  if (a.softcap != 0.f) {
    const float t = tanhf(qk * a.scale / a.softcap);
    p = exp2f(a.softcap * kLog2e * t - shift_l2);
    ds = p * (dp - dsum) * (a.scale * (1.f - t * t));
  } else {
    p = exp2f(fmaf(qk, a.scale * kLog2e, -shift_l2));
    ds = p * (dp - dsum) * a.scale;
  }
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

// An R-row tile (ceil(D/64) chunks of R x 64, each swizzled in 128-byte
// rows; ``map``'s box must be R rows).  Past column D the last chunk is
// zero-filled, and its full R * 128 bytes count toward the barrier.
template <int D, int R = kTile>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head) {
#pragma unroll
  for (int c = 0; c < (D + 63) / 64; ++c)
    tma_box(dst + c * R * 128, map, bar, c * 64, row, head);
}

// Two R-row tiles of one (row, head), ``m0``'s at dst and ``m1``'s after
// it, completing on ``bar``.
template <int D, int R = kTile>
__device__ __forceinline__ void tma_pair(uint32_t dst, const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint64_t* bar,
                                         int row, int head) {
  mbar_expect_tx(bar, 2 * tile_bytes<D, R>());
  tma_tile<D, R>(dst, m0, bar, row, head);
  tma_tile<D, R>(dst + tile_bytes<D, R>(), m1, bar, row, head);
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A tile as a K-major operand (rows = M or N, columns = K = D): k step kk
// covers columns 16kk..16kk+15, 32 bytes into the swizzled row; the
// 64-column chunks lie ``chunk`` bytes apart (R * 128 for R rows).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk,
                                           int chunk = kChunk) {
  return smem_desc(tile + (kk >> 2) * chunk + (kk & 3) * 32, 16, 1024);
}

// A tile as an MN-major operand (rows = K, columns = N = D): k step kk
// covers rows 16kk..16kk+15; the 64-column chunks lie ``chunk`` bytes
// apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk,
                                            int chunk = kChunk) {
  return smem_desc(tile + kk * 16 * 128, chunk, 1024);
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

// Synchronises the 128 threads of warpgroup ``wg`` alone, on named barrier
// 1 + wg (barrier 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "r"(kThreads)
               : "memory");
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

// d[64 x 32] (+)= A[64 x 16] . B[16 x 32], A and B from shared memory,
// both K-major (no transpose); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 48] (+)= A[64 x 16] . B[16 x 48], A and B from shared memory,
// both K-major (no transpose); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A product with A and B K-major from shared memory over N = 64, 48 or
// 32 columns (the wide kernels' 48 or 32 keys, the narrow kernels' 64 q
// rows or keys).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else if constexpr (N == 48) {
    wgmma_ss_n48(d, da, db, scale_d);
  } else {
    static_assert(N == 32, "no wgmma wrapper for this N");
    wgmma_ss_n32(d, da, db, scale_d);
  }
}

// d[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] . B[16 x 16], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 192] += A[64 x 16] . B[16 x 192], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], A from registers (a[4], the
// accumulator layout packed to bf16 pairs), B from shared memory MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The D 64 / 128 kernels' O += P.V, dV += P^T.dO, dK += dS^T.Q and
// dQ += dS.K over N = D columns (the narrow kernels' D 16 / 32 take
// ``wgmma_rs_mn``).
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    static_assert(D == 64, "wgmma_rs takes D 64 or 128");
    wgmma_rs_n64(d, a, db);
  }
}

// O += P.V or dQ += dS.K with N = D above 128, split along the 64-column
// chunks that ``desc_mn`` walks into wgmma products of at most 256 columns:
// min(D, 256), then the rest rounded up to 8 columns (N = 32 at D = 288,
// which reads half of each 128-byte swizzled row of the last chunk).  The
// accumulator holds both parts, kAcc floats a thread, in the layout of one
// N = kN0 + kN1 product.
template <int D>
struct OutParts {
  static constexpr int kN0 = D < 256 ? D : 256;
  static constexpr int kN1 = (D - kN0 + 7) / 8 * 8;
  static constexpr int kAcc = (kN0 + kN1) / 2;
  static_assert(kN0 % 64 == 0 && kN0 <= 256 && kN1 % 8 == 0 && kN1 <= 256,
                "a wgmma product takes N a multiple of 8 up to 256, and a "
                "second part starts on a 64-column chunk");
};

template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (N == 256) {
    wgmma_rs_n256(d, a, db);
  } else if constexpr (N == 192) {
    wgmma_rs_n192(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    static_assert(N == 16, "no wgmma wrapper for this N");
    wgmma_rs_n16(d, a, db);
  }
}

// d += A.B over both parts of ``OutParts<D>``: A from registers, B an
// MN-major tile of R rows (its chunks R * 128 bytes apart) at k step kk.
template <int D, int R>
__device__ __forceinline__ void wgmma_rs_parts(
    float (&d)[OutParts<D>::kAcc], const uint32_t (&a)[4], uint32_t tile,
    int kk) {
  using P = OutParts<D>;
  wgmma_rs_mn<P::kN0>(*reinterpret_cast<float(*)[P::kN0 / 2]>(&d[0]), a,
                      desc_mn(tile, kk, R * 128));
  if constexpr (P::kN1 > 0)
    wgmma_rs_mn<P::kN1>(
        *reinterpret_cast<float(*)[P::kN1 / 2]>(&d[P::kN0 / 2]), a,
        desc_mn(tile + (P::kN0 / 64) * R * 128, kk, R * 128));
}

// Stores a 64 x D fp32 accumulator (of ACC floats a thread, D/2 or more)
// as bf16 rows ``row0 + 16*warp + lane/4 (+8)`` of a (rows, D) matrix,
// skipping rows at or past ``rows``.
template <int D, int ACC = D / 2>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[ACC],
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

// A map over a contiguous (heads, rows, d) bf16 tensor: boxes of
// ``box_rows`` rows x ``box_cols`` columns of one head (64 and the 128-byte
// swizzle unless given), zeros past the edges (rows past ``rows``, columns
// past ``d``).
int make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
             int box_rows = kTile, int box_cols = 64,
             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrEntryPoint;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
