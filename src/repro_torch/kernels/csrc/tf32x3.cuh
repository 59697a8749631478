// Helpers of the fp32 3xTF32 backward kernels (csrc/flash_bwd_tf32x3.cu up
// to D 128, csrc/flash_bwd_tf32x3_wide.cu above it): their launch
// arguments, cp.async, the TF32 split, mma.sync.m16n8k8.tf32 in three
// passes, the contraction numbering that feeds an accumulator into the
// next product, and (p, ds) of one score.  csrc/flash_bwd_tf32x3.cu's
// header says why the split and the passes are what they are.
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

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;              // (B*Hq, Lq)
  const float* dsum;             // (B*Hq, Lq)
  float* dq;
  float* dk;
  float* dv;
  const int* doc;                // (B, Lq) per-row doc start, or null
  int bh, group, lq, lk, q_mult;
  int q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg, k_seg;
  int causal, window, packed, doc_skip;   // window < 0: no window
  float softcap, scale;
};

// Fills ``a`` from a C entry's arguments (``which``: 0 dq into o0, 1 dk/dv
// into o0 and o1); false if they do not fit: bf16, a group that does not
// divide, an empty side, a doc table missing or not dividing B*Hq, or q,
// k, v, do or an output not 16-byte aligned.  The caller checks d.
bool make_args(Args& a, int which, const void* q, const void* k,
               const void* v, const void* dout, const void* lse,
               const void* dsum, void* o0, void* o1, const void* doc,
               int is_bf16, int bh, int bhkv, int lq, int lk, int q_off_lo,
               int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
               int q_seg, int k_seg, int causal, int window, float softcap,
               float scale, int packed, int doc_skip, int doc_rows) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(o0) | reinterpret_cast<uintptr_t>(o1)) &
       15) == 0;
  if (is_bf16 || !aligned || bh <= 0 || bhkv <= 0 || bh % bhkv != 0 ||
      lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
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

// (p, ds) of one score from the raw product q.k, the row's shift and dsum,
// and dO.v, in fp32 (the division-free ``p_f`` below is the wide
// kernels').
__device__ __forceinline__ void p_ds(const Args& a, float qk, float shift,
                                     float dsum, float dp, float& p,
                                     float& ds) {
  float s = qk * a.scale;
  float factor = a.scale;
  if (a.softcap != 0.f) {
    s = a.softcap * tanhf(s / a.softcap);
    const float t = s / a.softcap;
    factor *= 1.f - t * t;
  }
  p = expf(s - shift);
  ds = p * (dp - dsum) * factor;
}

// p = exp(s - shift) of one score from the raw product q.k and the row's
// shift, and f = the scale times the softcap's factor 1 - t^2, t =
// tanh(s / cap) (the scale alone without a softcap); ``inv_cap`` = 1 / cap.
// ``p_ds``'s function without its two IEEE divisions: s / cap is a product
// with 1 / cap, and t is tanh's result itself rather than s_c / cap, each
// within an ulp of ``p_ds``'s (1.07x faster for the tf32x3w pair with the
// softcap, scripts/ab_flash_bwd_tf32x3.py --wide wide_kept
// wide_div_softcap).
__device__ __forceinline__ void p_f(const Args& a, float qk, float shift,
                                    float inv_cap, float& p, float& f) {
  float s = qk * a.scale;
  f = a.scale;
  if (a.softcap != 0.f) {
    const float t = tanhf(s * inv_cap);
    s = a.softcap * t;
    f *= 1.f - t * t;
  }
  p = expf(s - shift);
}

}  // namespace
