// Flash-attention backward for fp32 above head dim 128 on Hopper's tensor
// cores (sm_90a), written by hand in CUDA C++: the fp32 dq kernel and the
// fp32 dk/dv kernel at the padded D 192, 256, 288 and 384 (the
// ``"tf32x3w"`` route), each product in three TF32 passes ("3xTF32").
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289) and
// ::_dkv_kernel (:331), the Pallas TPU kernels launched by ``_bwd`` (:421,
// :464), for fp32 operands at every D above 128 (csrc/flash_bwd_tf32x3.cu
// serves D up to 128).  Same function, folded layout and C arguments as
// every backward source: q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D), lse and
// dsum = rowsum(dO * O) (B*Hq, Lq), all fp32; GQA: q row b reads KV row
// b / group.  P = exp(s - lse) on visible keys (a row whose lse is -1e30
// uses shift 0 and sees no key); dS = P * (dO.V^T - dsum), times (1 -
// (s_c/cap)^2) under a softcap, times the scale; dq = dS.K, dk = the
// group's sum of dS^T.Q, dv = the sum of P^T.dO, fp32 out.  The mask (the
// five band ints, q_seg / k_seg, kv_valid, causal, window, the doc table
// with doc_skip), the softcap, the scale and the whole-tile skip
// (``tile_runs``, ``tile_full``, ``next_k_tile``, ``next_q_step``,
// ``visible`` from csrc/sm90_common.cuh) are launch arguments.
//
// Numerics: csrc/flash_bwd_tf32x3.cu's (helpers in csrc/tf32x3.cuh).  Each
// fp32 operand is split in registers into a TF32 hi (round to nearest,
// ties away) and a truncated lo; every product is hi.lo + lo.hi + hi.hi,
// small terms first; P and dS are split the same way before the second
// products, and each second product sums one stage in a fresh accumulator
// and adds that to the long-lived one in fp32.  The first products (S and
// dP, or S^T and dP^T) contract over up to 384 columns, three times D 128's
// 16 k steps: they too sum kSumK = 16 k steps (D 128's whole contraction)
// in fresh accumulators, two of them (even and odd k steps) so that two
// chains of products run at once, and add those in fp32.  P and F come
// from ``p_f`` (csrc/tf32x3.cuh): tanhf and expf as in every fp32 kernel,
// with s / cap a product with 1 / cap instead of an IEEE division.
//
// What bounds it on an H100.  Operations: dq is three products of
// 2*Lq*Lk*D FLOPs (S, dP, dS.K), dk/dv four (S^T, dP^T, P^T.dO, dS^T.Q),
// halved under causal; three TF32 passes each at 495 TFLOP/s of dense TF32
// (gemma2-2b's shape, B=2, L=4096, Hq=8, Hkv=4, D=288, causal: 3 x 232.0
// and 3 x 309.3 GFLOP, 1.406 and 1.875 ms).  The bytes (each operand read
// once) are far below that.  ``mma.sync`` reaches less than ``wgmma``'s
// rate: scripts/mma_tf32_probe.py measures its ceiling.
//
// Design.
//   Why mma.sync.  wgmma reads tf32 operands from shared memory K-major
//   only, and three of the five products read one MN-major (dS.K, dS^T.Q,
//   P^T.dO); transposed hi and lo copies of the operands would not fit
//   beside the tiles at D 288.  mma.sync loads every fragment by address, so
//   one raw fp32 copy of a tile serves both orientations.
//   Why not csrc/flash_bwd_tf32x3.cu's tiling.  It keeps a warp's partial
//   dK and dV for 16 keys x D columns in registers: 2 x 16 x D / 32 floats
//   a lane, 128 at D 128 (255 registers in all), 288 at D 288.  Here each
//   warp owns a column slice of the outputs instead, and the score tile is
//   computed once a step and traded through shared memory.
//   Blocks.  256 threads (8 warps), one block an SM.  A block owns 32 rows
//   (dq: q rows of one head; dk/dv: keys of one KV head) and streams the
//   other side through two cp.async stages of kR rows (32; 16 at D 384).
//   Warp w's first product is S (w < 4) or dP (w >= 4) (dk/dv: S^T or
//   dP^T) for 16 of the block's rows (w % 2) and kR/2 of the stage's
//   ((w / 2) % 2).
//   dq.  The S warps write P times F (the scale times the softcap's
//   factor, masked), the dP warps dP - dsum, into an exchange in fragment
//   order; after one named barrier a row half (the four warps of its 16 q
//   rows), each of those warps reads the whole row half, forms dS = PF *
//   (dP - dsum) and adds dS.K to its quarter of dQ's columns (D / 4: 72 at
//   D 288, 36 floats a thread).  Each warp writes its own dQ slice: no
//   final sum.
//   dk/dv.  A block walks all group * nq q steps of its KV head (the GQA
//   sum stays in registers: no atomics, deterministic).  The S^T warps own
//   dV, the dP^T warps dK, each for 16 keys x D / 2 columns (72 floats a
//   thread at D 288).  An S^T warp writes P and P times F; after a named
//   barrier a key half the dP^T warp at the same place turns P F into dS =
//   PF * (dP - dsum) in place, and a second barrier (the two dP^T warps of
//   the key half) hands it on.  Then the S^T warps add P^T.dO and the dP^T
//   warps dS^T.Q over the stage.  Each reads back its own slots and its
//   partner's; the exchange is rewritten only after the next stage's
//   __syncthreads, so it needs no "buffer free" barrier.
//   Shared memory.  Rows padded to D + 4 floats (bank-conflict free for
//   both orientations, csrc/tf32x3.cuh).  Two fixed 32-row tiles, two
//   stages of two kR-row tiles and two kR x 32 exchange arrays: 232,448
//   bytes at D 288, exactly the 227 KB a block may use (the row stats are
//   read from global memory, not staged); at D 384 32-row stages would
//   take 297,984, so its stages hold 16 rows (202,752 bytes).
//   Staging.  Every thread issues its share of a stage's 16-byte cp.async
//   copies (zero-filled past Lq / Lk) right after the step's
//   __syncthreads, so the next stage's copy overlaps this step's math.
//   Masks.  A tile the band cannot reach is skipped, a tile wholly inside
//   it skips the per-element test.  dq's grid puts the q tile on its slow
//   axis, the last (heaviest under causal) first; dk/dv's the key tile,
//   the first first.
//   Tuning.  scripts/ab_flash_bwd_tf32x3.py --wide NAME ... times the
//   choices above against their alternatives (``MEASURED_WIDE``) and the
//   parent tree's FMA pair at gemma2-2b's shape (PERF.md section 6 has
//   the numbers).  Kept: two
//   interleaved partial sums in the first products (one: 1.02x slower),
//   32-row stages (16 at D 288: 1.20x), P and F without divisions (with
//   them: 1.07x with the softcap), the k loop unrolled 4 times at D 384
//   and 2 below (2 at D 384: 1.04x), cp.async staging (one bulk copy a
//   row on an mbarrier, issued by one warp: 1.04x), 4-byte fragment
//   loads (8-byte pairs: 0.99x at D 288, 1.03x at head dim 320).
//   Without any stage loaded after the first (a diagnostic) the pair
//   takes 0.86x: the staged copies cost more than their issue slots.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dq_tf32x3w_kernel<192>  141, 0   flash_dkv_tf32x3w_kernel<192>  178, 0
//   flash_dq_tf32x3w_kernel<256>  172, 0   flash_dkv_tf32x3w_kernel<256>  217, 0
//   flash_dq_tf32x3w_kernel<288>  190, 0   flash_dkv_tf32x3w_kernel<288>  235, 0
//   flash_dq_tf32x3w_kernel<384>  178, 0   flash_dkv_tf32x3w_kernel<384>  252, 0
// (no stack frame, no ptxas warning).

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBlockW = 32 * kWarps;   // threads of a block
constexpr int kRows = 32;              // q rows (dq) or keys (dk/dv) a block

// The shared-memory layout at D: two fixed kRows-row tiles, two stages of
// two kR-row tiles, two kRows x kR exchange arrays; rows padded to D + 4.
template <int D>
struct Wide {
  static constexpr int kStride = D + 4;
  static constexpr int kR = D == 384 ? 16 : 32;   // rows a stage
  static constexpr int kFixed = kRows * kStride;  // floats of a fixed tile
  static constexpr int kStage = kR * kStride;     // floats of a staged tile
  static constexpr int kX = kRows * kR;           // floats of an exchange
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kFixed + 4 * kStage + 2 * kX);
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
  static_assert(kR % 16 == 0 && D % 32 == 0, "whole fragments");
};

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockW, 1)
flash_dq_tf32x3w_kernel(const Args a) {
  using W = Wide<D>;
  constexpr int S = W::kStride, KT = W::kR;
  constexpr int NN = KT / 16;       // 8-key blocks of a warp's S or dP
  constexpr int NJ = KT / 8;        // 8-key blocks of a stage
  constexpr int NB = D / 32;        // 8-column blocks of a warp's dQ
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + W::kFixed;
  float* ring = sDO + W::kFixed;    // stage s: K at 2s, V at 2s + 1
  float4* xpf = reinterpret_cast<float4*>(ring + 4 * W::kStage);
  float4* xdp = xpf + W::kX / 4;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rh = warp & 1;          // q rows 16*rh.. of the block
  const int kind = warp >> 2;       // first product: 0 S = Q.K^T, 1 dP
  const int kq = (warp >> 1) & 1;   // keys (KT/2)*kq.. of the stage
  const int cw = warp >> 1;         // dQ columns (D/4)*cw..
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + KT - 1) / KT;
  const int row_a = q0 + 16 * rh + g;                    // accumulator rows
  const float* kp = a.k + static_cast<size_t>(bkv) * a.lk * D;
  const float* vp = a.v + static_cast<size_t>(bkv) * a.lk * D;
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kRows, a.lq) - 1] : 0;
  const float inv_cap = a.softcap != 0.f ? 1.f / a.softcap : 0.f;

  float dq[NB][4];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[c][i] = 0.f;

  int kt = next_k_tile<kRows, KT>(a, q0, doc_first, -1, nk);  // block-uniform
  if (kt < nk) {
    const size_t qbase = static_cast<size_t>(b) * a.lq * D;
    load_rows<D, kRows, kBlockW>(sQ, a.q + qbase, q0, a.lq, tid);
    load_rows<D, kRows, kBlockW>(sDO, a.dout + qbase, q0, a.lq, tid);
    load_rows<D, KT, kBlockW>(ring, kp, kt * KT, a.lk, tid);
    load_rows<D, KT, kBlockW>(ring + W::kStage, vp, kt * KT, a.lk, tid);
    cp_async_commit();
    int kn = next_k_tile<kRows, KT>(a, q0, doc_first, kt, nk);

    float shift[2], dsum[2];
    int qlog[2], qdoc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      const bool in = row < a.lq;
      const float lse = in ? a.lse[static_cast<size_t>(b) * a.lq + row]
                           : kNegInf;
      shift[h] = lse <= kNegInf / 2 ? 0.f : lse;
      dsum[h] = in ? a.dsum[static_cast<size_t>(b) * a.lq + row] : 0.f;
      qlog[h] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      qdoc[h] = (a.packed && in) ? docp[row] : kDocAbsent;
    }

    for (int it = 0; kt < nk; ++it) {
      cp_async_wait<0>();
      __syncthreads();        // tile kt has landed; step it - 1 is done
      const float* sK = ring + 2 * (it & 1) * W::kStage;
      const float* sV = sK + W::kStage;
      if (kn < nk) {
        float* next = ring + 2 * ((it + 1) & 1) * W::kStage;
        load_rows<D, KT, kBlockW>(next, kp, kn * KT, a.lk, tid);
        load_rows<D, KT, kBlockW>(next + W::kStage, vp, kn * KT, a.lk, tid);
      }
      cp_async_commit();
      const int k0 = kt * KT;

      // S = Q.K^T or dP = dO.V^T: this warp's 16 q rows x KT/2 keys.
      float x[NN][4];
      first_product<S, NN, D / 8>(x, kind ? sDO : sQ, kind ? sV : sK,
                                  16 * rh, (KT / 2) * kq, g, t);
      if (kind == 0) {        // P times F, masked
        const bool full = tile_full<kRows, KT>(a, q0, k0, doc_last);
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1;
            float p, f;
            p_f(a, x[n][i], shift[h], inv_cap, p, f);
            if (!full &&
                !visible(a, row_a + 8 * h, qlog[h], qdoc[h],
                         k0 + (KT / 2) * kq + 8 * n + 2 * t + (i & 1)))
              p = 0.f;
            x[n][i] = p * f;
          }
      } else {                // dP - dsum
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[n][i] -= dsum[i >> 1];
      }
      float4* xo = kind ? xdp : xpf;
#pragma unroll
      for (int n = 0; n < NN; ++n)
        xo[(rh * NJ + kq * NN + n) * 32 + lane] =
            make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
      bar_sync(1 + rh, 128);  // the row half's four warps

      // dQ[rows, cols] += dS.K[:, cols]: k step j reads key rows 8j + 2t
      // (logical t) and + 1 (t + 4); the stage's sum is added in fp32.
      FragA dsa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 pf = xpf[(rh * NJ + j) * 32 + lane];
        const float4 dp = xdp[(rh * NJ + j) * 32 + lane];
        dsa[j] = split_a(pf.x * dp.x, pf.z * dp.z, pf.y * dp.y, pf.w * dp.w);
      }
      tile_product<NB, S, NJ>(dq, dsa, sK + 2 * t * S + (D / 4) * cw + g);
      kt = kn;
      kn = kn < nk ? next_k_tile<kRows, KT>(a, q0, doc_first, kn, nk) : nk;
    }
  }
  cp_async_wait<0>();

  float* dqp = a.dq + static_cast<size_t>(b) * a.lq * D + (D / 4) * cw;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= a.lq) continue;
#pragma unroll
    for (int c = 0; c < NB; ++c)
      *reinterpret_cast<float2*>(dqp + static_cast<size_t>(row) * D + 8 * c +
                                 2 * t) =
          make_float2(dq[c][2 * h], dq[c][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockW, 1)
flash_dkv_tf32x3w_kernel(const Args a) {
  using W = Wide<D>;
  constexpr int S = W::kStride, QR = W::kR;
  constexpr int NN = QR / 16;       // 8-row blocks of a warp's S^T or dP^T
  constexpr int NJ = QR / 8;        // 8-row blocks of a stage
  constexpr int NB = D / 16;        // 8-column blocks of a warp's dV or dK
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + W::kFixed;
  float* ring = sV + W::kFixed;     // stage s: Q at 2s, dO at 2s + 1
  float4* xp = reinterpret_cast<float4*>(ring + 4 * W::kStage);   // P
  float4* xs = xp + W::kX / 4;      // P times F, then dS

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kh = warp & 1;          // keys 16*kh.. of the block
  const int kind = warp >> 2;       // 0: S^T = K.Q^T, owns dV; 1: dP^T, dK
  const int qh = (warp >> 1) & 1;   // q rows (QR/2)*qh.. of the stage, and
                                    // output columns (D/2)*qh..
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int nq = (a.lq + QR - 1) / QR;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * kh + g;   // accumulator rows
  const float inv_cap = a.softcap != 0.f ? 1.f / a.softcap : 0.f;

  float acc[NB][4];                 // dV (kind 0) or dK (kind 1)
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;

  int gs = next_q_step<QR, kRows>(a, k0, bkv, -1, nq);   // block-uniform
  if (gs < steps) {
    const size_t kbase = static_cast<size_t>(bkv) * a.lk * D;
    load_rows<D, kRows, kBlockW>(sK, a.k + kbase, k0, a.lk, tid);
    load_rows<D, kRows, kBlockW>(sV, a.v + kbase, k0, a.lk, tid);
    {
      const size_t base =
          static_cast<size_t>(bkv * a.group + gs / nq) * a.lq * D;
      load_rows<D, QR, kBlockW>(ring, a.q + base, (gs % nq) * QR, a.lq,
                                tid);
      load_rows<D, QR, kBlockW>(ring + W::kStage, a.dout + base,
                                (gs % nq) * QR, a.lq, tid);
    }
    cp_async_commit();
    int gn = next_q_step<QR, kRows>(a, k0, bkv, gs, nq);

    for (int it = 0; gs < steps; ++it) {
      const int b = bkv * a.group + gs / nq;
      const int q0 = (gs % nq) * QR;
      // This warp's columns' shift (S^T warps) or dsum (dP^T warps),
      // read before the wait so that the loads overlap it.
      float rs[NN][2];
      const float* stat =
          (kind ? a.dsum : a.lse) + static_cast<size_t>(b) * a.lq;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + (QR / 2) * qh + 8 * n + 2 * t + h;
          const float v = row < a.lq ? stat[row] : 0.f;
          rs[n][h] = kind == 0 && v <= kNegInf / 2 ? 0.f : v;
        }
      cp_async_wait<0>();
      __syncthreads();        // step gs has landed; step it - 1 is done
      const float* sQ = ring + 2 * (it & 1) * W::kStage;
      const float* sDO = sQ + W::kStage;
      if (gn < steps) {
        float* next = ring + 2 * ((it + 1) & 1) * W::kStage;
        const size_t base =
            static_cast<size_t>(bkv * a.group + gn / nq) * a.lq * D;
        load_rows<D, QR, kBlockW>(next, a.q + base, (gn % nq) * QR, a.lq,
                                  tid);
        load_rows<D, QR, kBlockW>(next + W::kStage, a.dout + base,
                                  (gn % nq) * QR, a.lq, tid);
      }
      cp_async_commit();

      // S^T = K.Q^T or dP^T = V.dO^T: this warp's 16 keys x QR/2 q rows.
      float x[NN][4];
      first_product<S, NN, D / 8>(x, kind ? sV : sK, kind ? sDO : sQ,
                                  16 * kh, (QR / 2) * qh, g, t);
      const int slot = kh * NJ + qh * NN;     // this warp's exchange slots
      if (kind == 0) {
        // P^T, masked, and P^T times F, to the exchange.
        const int* docp =
            a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq
                     : nullptr;
        const bool full = tile_full<QR, kRows>(
            a, q0, k0, a.packed ? docp[min(q0 + QR, a.lq) - 1] : 0);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          float pf[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = q0 + (QR / 2) * qh + 8 * n + 2 * t + (i & 1);
            float p, f;
            p_f(a, x[n][i], rs[n][i & 1], inv_cap, p, f);
            if (!full) {
              const int qlog =
                  logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
              const int qdoc =
                  (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
              if (!visible(a, row, qlog, qdoc, key_a + 8 * (i >> 1)))
                p = 0.f;
            }
            x[n][i] = p;
            pf[i] = p * f;
          }
          xp[(slot + n) * 32 + lane] =
              make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
          xs[(slot + n) * 32 + lane] = make_float4(pf[0], pf[1], pf[2], pf[3]);
        }
        bar_sync(1 + kh, 128);  // the key half's four warps
      } else {
        // dS^T = PF * (dP^T - dsum) in place of PF, for the other dP^T warp.
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[n][i] -= rs[n][i & 1];
        bar_sync(1 + kh, 128);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float4 pf = xs[(slot + n) * 32 + lane];
          xs[(slot + n) * 32 + lane] =
              make_float4(pf.x * x[n][0], pf.y * x[n][1], pf.z * x[n][2],
                          pf.w * x[n][3]);
        }
        bar_sync(3 + kh, 64);   // the key half's two dP^T warps
      }

      // dV += P^T.dO (kind 0) or dK += dS^T.Q (1) over the stage's QR rows,
      // columns (D/2)*qh..: k step j reads q rows 8j + 2t (logical t) and
      // + 1 (t + 4); the stage's sum is added in fp32.
      const float4* xa = kind ? xs : xp;
      FragA fa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v = xa[(kh * NJ + j) * 32 + lane];
        fa[j] = split_a(v.x, v.z, v.y, v.w);
      }
      tile_product<NB, S, NJ>(acc, fa,
                              (kind ? sQ : sDO) + 2 * t * S + (D / 2) * qh + g);
      gs = gn;
      gn = gn < steps ? next_q_step<QR, kRows>(a, k0, bkv, gn, nq) : steps;
    }
  }
  cp_async_wait<0>();

  float* out = (kind ? a.dk : a.dv) + static_cast<size_t>(bkv) * a.lk * D +
               (D / 2) * qh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_a + 8 * h;
    if (key >= a.lk) continue;
#pragma unroll
    for (int c = 0; c < NB; ++c)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(key) * D + 8 * c +
                                 2 * t) =
          make_float2(acc[c][2 * h], acc[c][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(int which, const Args& a, int bhkv, cudaStream_t stream) {
  constexpr size_t smem = Wide<D>::kBytes;
  auto kernel =
      which ? flash_dkv_tf32x3w_kernel<D> : flash_dq_tf32x3w_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // The tile index on the slow axis: blocks start tile by tile.
  const dim3 grid = which ? dim3(bhkv, (a.lk + kRows - 1) / kRows)
                          : dim3(a.bh, (a.lq + kRows - 1) / kRows);
  kernel<<<grid, kBlockW, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dsum, void* o0,
        void* o1, const void* doc, int is_bf16, int bh, int bhkv, int lq,
        int lk, int d, int q_off_lo, int q_off_hi, int k_off_lo,
        int k_off_hi, int kv_valid, int q_seg, int k_seg, int causal,
        int window, float softcap, float scale, int packed, int doc_skip,
        int doc_rows, void* stream) {
  Args a;
  if ((d != 192 && d != 256 && d != 288 && d != 384) ||
      !make_args(a, which, q, k, v, dout, lse, dsum, o0, o1, doc, is_bf16,
                 bh, bhkv, lq, lk, q_off_lo, q_off_hi, k_off_lo, k_off_hi,
                 kv_valid, q_seg, k_seg, causal, window, softcap, scale,
                 packed, doc_skip, doc_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 192: err = launch<192>(which, a, bhkv, st); break;
    case 256: err = launch<256>(which, a, bhkv, st); break;
    case 288: err = launch<288>(which, a, bhkv, st); break;
    default: err = launch<384>(which, a, bhkv, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd_sm90.cu's entry points (is_bf16 must
// be 0, d one of 192, 256, 288, 384, and q, k, v, do and the outputs
// 16-byte aligned).  Each returns the cudaError_t of its launch (0 =
// launched).
int flash_bwd_dq_tf32x3w(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         void* dq, const void* doc, int is_bf16, int bh,
                         int bhkv, int lq, int lk, int d, int q_off_lo,
                         int q_off_hi, int k_off_lo, int k_off_hi,
                         int kv_valid, int q_seg, int k_seg, int causal,
                         int window, float softcap, float scale, int packed,
                         int doc_skip, int doc_rows, void* stream) {
  return run(0, q, k, v, dout, lse, dsum, dq, dq, doc, is_bf16, bh, bhkv,
             lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid,
             q_seg, k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

int flash_bwd_dkv_tf32x3w(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* dsum, void* dk, void* dv,
                          const void* doc, int is_bf16, int bh, int bhkv,
                          int lq, int lk, int d, int q_off_lo, int q_off_hi,
                          int k_off_lo, int k_off_hi, int kv_valid,
                          int q_seg, int k_seg, int causal, int window,
                          float softcap, float scale, int packed,
                          int doc_skip, int doc_rows, void* stream) {
  return run(1, q, k, v, dout, lse, dsum, dk, dv, doc, is_bf16, bh, bhkv, lq,
             lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg,
             k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

const char* flash_bwd_tf32x3w_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
