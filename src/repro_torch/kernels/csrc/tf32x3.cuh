// Helpers of the fp32 3xTF32 kernels (the backward's csrc/flash_bwd_tf32x3.cu
// up to D 128 and csrc/flash_bwd_tf32x3_wide.cu above it; the forward's
// csrc/flash_fwd_tf32x3.cu and csrc/flash_fwd_tf32x3_wide.cu): their launch
// arguments, cp.async staging, the TF32 split, mma.sync.m16n8k8.tf32 in
// three passes, the contraction numbering that feeds an accumulator into
// the next product, the first products' fresh partial sums, and the score,
// p and f of one raw product.  csrc/flash_bwd_tf32x3.cu's header says why
// the split and the passes are what they are.
//
// Fragments.  An m16n8 accumulator holds rows g, g + 8 (g = lane / 4) and
// columns 2t, 2t + 1 of its 8 (t = lane % 4); the tf32 A fragment wants
// columns t, t + 4.  A second product's contraction index is numbered so
// that logical t is physical 2t and t + 4 is 2t + 1 (``acc_as_a``), and
// its B rows are loaded by that map (``tile_product``), so P and dS (or
// P^T and dS^T) go from the accumulator into the next product with no
// shuffle.  Tiles sit in shared memory as raw fp32 rows of stride S
// floats; S = D + 4 makes both the row-wise fragment loads (bank 4g + t)
// and the column-wise loads of the transposed operands (bank 8t + g) free
// of bank conflicts at every D that is a multiple of 32 (and at 16).
#pragma once

#include "sm90_common.cuh"

namespace {

// The shape and mask fields of every fp32 kernel's launch arguments.
struct MaskArgs {
  const int* doc;                // (B, Lq) per-row doc start, or null
  int bh, group, lq, lk, q_mult;
  int q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg, k_seg;
  int causal, window, packed, doc_skip;   // window < 0: no window
  float softcap, scale;
};

// The backward's operands: q, dout, dq (B*Hq, Lq, D), k/v, dk/dv
// (B*Hkv, Lk, D), lse and dsum (B*Hq, Lq), all fp32.
struct BwdOperands {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* dsum;
  float* dq;
  float* dk;
  float* dv;
};
struct Args : BwdOperands, MaskArgs {};

// The forward's: q and out (B*Hq, Lq, D), k/v (B*Hkv, Lk, D), lse
// (B*Hq, Lq), all fp32.
struct FwdOperands {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
};
struct FwdArgs32 : FwdOperands, MaskArgs {};

// Whether the pointers are all 16-byte aligned (cp.async copies 16 bytes).
template <class... P>
bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) & 15) == 0;
}

// Fills ``a`` from a C entry's shape and mask arguments; false if they do
// not fit: a group that does not divide, an empty side, a doc table
// missing or not dividing B*Hq.
bool fill_mask(MaskArgs& a, const void* doc, int bh, int bhkv, int lq, int lk,
               int q_off_lo, int q_off_hi, int k_off_lo, int k_off_hi,
               int kv_valid, int q_seg, int k_seg, int causal, int window,
               float softcap, float scale, int packed, int doc_skip,
               int doc_rows) {
  if (bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return false;
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
  return true;
}

// Fills ``a`` from a backward C entry's arguments (``which``: 0 dq into
// o0, 1 dk/dv into o0 and o1); false if they do not fit: bf16, q, k, v, do
// or an output not 16-byte aligned, or ``fill_mask``'s reasons.  The
// caller checks d.
bool make_args(Args& a, int which, const void* q, const void* k,
               const void* v, const void* dout, const void* lse,
               const void* dsum, void* o0, void* o1, const void* doc,
               int is_bf16, int bh, int bhkv, int lq, int lk, int q_off_lo,
               int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
               int q_seg, int k_seg, int causal, int window, float softcap,
               float scale, int packed, int doc_skip, int doc_rows) {
  if (is_bf16 || !aligned16(q, k, v, dout, o0, o1) ||
      !fill_mask(a, doc, bh, bhkv, lq, lk, q_off_lo, q_off_hi, k_off_lo,
                 k_off_hi, kv_valid, q_seg, k_seg, causal, window, softcap,
                 scale, packed, doc_skip, doc_rows))
    return false;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = static_cast<float*>(which ? nullptr : o0);
  a.dk = static_cast<float*>(which ? o0 : nullptr);
  a.dv = static_cast<float*>(which ? o1 : nullptr);
  return true;
}

// Fills ``a`` from a forward C entry's arguments (those of every forward
// source); false if they do not fit: bf16, q, k, v or out not 16-byte
// aligned, or ``fill_mask``'s reasons.  The caller checks d.
bool make_fwd_args(FwdArgs32& a, const void* q, const void* k,
                   const void* v, void* out, void* lse, const void* doc,
                   int is_bf16, int bh, int bhkv, int lq, int lk,
                   int q_off_lo, int q_off_hi, int k_off_lo, int k_off_hi,
                   int kv_valid, int q_seg, int k_seg, int causal,
                   int window, float softcap, float scale, int packed,
                   int doc_skip, int doc_rows) {
  if (is_bf16 || !aligned16(q, k, v, out) ||
      !fill_mask(a, doc, bh, bhkv, lq, lk, q_off_lo, q_off_hi, k_off_lo,
                 k_off_hi, kv_valid, q_seg, k_seg, causal, window, softcap,
                 scale, packed, doc_skip, doc_rows))
    return false;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  return true;
}

// ---------------------------------------------------------------------------
// cp.async, TF32 split and mma.sync (PTX)
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; ``bytes`` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x rounded to TF32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32, in two integer instructions on the bits (sign and
// magnitude, so adding half a TF32 ulp rounds the magnitude).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (at most 2^-22 |x|), both TF32: hi rounded to nearest,
// lo = x - hi (exact in fp32) with its low 13 bits cleared.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// An A fragment (row g: a[0], a[2]; row g+8: a[1], a[3]) split in two.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b to about fp32 accuracy: B's fragment (b0 at k = t, b1 at
// k = t + 4, both at n = g) is split here; three passes, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, h0, h1);
}

// The A fragment of rows r, r + 8 at columns c + t, c + t + 4 of a tile of
// row stride S.
template <int S>
__device__ __forceinline__ FragA load_a(const float* tile, int r, int c) {
  const float* p = tile + r * S + c;
  constexpr int kDown = 8 * S;
  return split_a(p[0], p[kDown], p[4], p[kDown + 4]);
}

// An accumulator block as the A fragment of the next product, its
// contraction index permuted (logical t = physical 2t, t + 4 = 2t + 1).
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// acc += part, in fp32 (round to nearest).  The tensor cores' fp32 sum does
// not round to nearest, so over thousands of chained products it drifts;
// a partial sum over one tile, added here, keeps that drift to the tile.
__device__ __forceinline__ void add_to(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += part[i];
}

// out[c] += a[0..NK-1] . b for each column block c of NB: the contraction
// over NK k steps (b rows 8n + 2t and 8n + 2t + 1 from ``b``, the permuted
// order of ``acc_as_a``), its sum added in fp32.
template <int NB, int S, int NK>
__device__ __forceinline__ void tile_product(float (&out)[NB][4],
                                             const FragA (&a)[NK],
                                             const float* b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
      mma3(part, a[n], b[8 * n * S + 8 * c], b[(8 * n + 1) * S + 8 * c]);
    add_to(out[c], part);
  }
}

// The score of one raw product q.k: times the scale, and under a softcap
// cap * tanh(s / cap), s / cap a product with ``inv_cap`` = 1 / cap; ``t``
// is that tanh (0 without a softcap).  There is no IEEE division: each
// within an ulp of the division's, which was 1.07x slower for the tf32x3w
// backward pair with the softcap (scripts/ab_flash_bwd_tf32x3.py --wide
// wide_kept wide_div_softcap).
__device__ __forceinline__ float score(const MaskArgs& a, float qk,
                                       float inv_cap, float& t) {
  const float s = qk * a.scale;
  t = a.softcap != 0.f ? tanhf(s * inv_cap) : 0.f;
  return a.softcap != 0.f ? a.softcap * t : s;
}
__device__ __forceinline__ float score(const MaskArgs& a, float qk,
                                       float inv_cap) {
  float t;
  return score(a, qk, inv_cap, t);
}

// p = exp(s - shift) of one score from the raw product q.k and the row's
// shift, and f = the scale times the softcap's factor 1 - t^2 (the scale
// alone without a softcap); ``inv_cap`` = 1 / cap.  dS = P F (dP - dsum).
__device__ __forceinline__ void p_f(const MaskArgs& a, float qk, float shift,
                                    float inv_cap, float& p, float& f) {
  float t;
  p = expf(score(a, qk, inv_cap, t) - shift);
  f = a.softcap != 0.f ? a.scale * (1.f - t * t) : a.scale;
}

// Named barrier ``id`` over ``threads`` threads (whole warps).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Rows row0 .. row0 + R - 1 of a (rows, D) fp32 matrix into a tile of row
// stride D + 4, by ``THREADS`` threads in rounds of 16-byte cp.async
// copies; rows at or past ``rows`` are zeros.
template <int D, int R, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int tid) {
  constexpr int kChunks = D / 4;          // 16-byte chunks a row
  constexpr int kAll = R * kChunks;
#pragma unroll
  for (int j = 0; j < (kAll + THREADS - 1) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (kAll % THREADS != 0 && i >= kAll) break;   // a last partial round
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * (D + 4) + c,
               src + static_cast<size_t>(in ? row0 + r : 0) * D + c,
               in ? 16 : 0);
  }
}

constexpr int kSumK = 16;   // first products: k steps a partial sum holds

// x[n] = A . B^T over KS k steps (8 KS columns from sa and sb) for NN
// 8-row blocks of B: A rows ra, ra + 8 (this lane's g), B rows rb + 8n +
// g; tiles of row stride S.  Each kSumK k steps go into two fresh partial
// sums (even and odd k steps, two chains of products at once), added to x
// in fp32.
template <int S, int NN, int KS>
__device__ __forceinline__ void first_product(float (&x)[NN][4],
                                              const float* sa,
                                              const float* sb, int ra,
                                              int rb, int g, int t) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += kSumK) {
    const int c1 = c0 + kSumK < KS ? c0 + kSumK : KS;
    float part[2][NN][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[e][n][i] = 0.f;
#pragma unroll(NN == 1 ? 4 : 2)
    for (int ks = c0; ks < c1; ks += 2) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const FragA fa = load_a<S>(sa, ra + g, 8 * (ks + e) + t);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int off = (rb + 8 * n + g) * S + 8 * (ks + e) + t;
          mma3(part[e][n], fa, sb[off], sb[off + 4]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[n][i] += part[0][n][i] + part[1][n][i];
  }
}

}  // namespace
