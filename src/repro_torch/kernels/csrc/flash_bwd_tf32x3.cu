// Flash-attention backward for fp32 on Hopper's tensor cores (sm_90a),
// written by hand in CUDA C++: the fp32 dq kernel and the fp32 dk/dv kernel,
// each product in three TF32 passes ("3xTF32").
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289) and
// ::_dkv_kernel (:331), the Pallas TPU kernels launched by ``_bwd``, for fp32
// operands at every D in {16, 32, 64, 128}.  Same function and folded layout
// as csrc/flash_bwd_tf32x3_wide.cu and csrc/flash_bwd_sm90.cu: q, do (B*Hq, Lq, D), k/v
// (B*Hkv, Lk, D), lse and dsum = rowsum(dO * O) (B*Hq, Lq), all fp32; GQA:
// q row b reads KV row b / group.  P = exp(s - lse) on visible keys (a row
// whose lse is -1e30 uses shift 0 and sees no key); dS = P * (dO.V^T - dsum),
// times (1 - (s_c/cap)^2) under a softcap, times the scale; dq = dS.K,
// dk = dS^T.Q, dv = P^T.dO, fp32 out.  The mask (kv_valid, causal, window,
// packed documents from the five band ints, q_seg / k_seg and the doc table)
// and the whole-tile skip are the other kernels', all plain launch arguments.
//
// Numerics.  The tensor cores have no fp32 mode, and one TF32 pass keeps
// only 11 bits of each operand.  Each fp32 operand x is split in registers
// into hi = x rounded to TF32 (to nearest, ties away: cvt.rna.tf32.f32's
// rounding, done in two integer instructions) and lo = x - hi (exact)
// truncated to TF32 (its low 13 bits cleared), so |x - hi - lo| <= 2^-22
// |x|; no operand relies on how the tensor core reads the low 13 bits of
// a raw fp32 word.  The product a.b is hi(a).lo(b) + lo(a).hi(b) +
// hi(a).hi(b), issued small terms first, which keeps about 21 of fp32's 24
// mantissa bits of every product (the dropped lo.lo term is below 2^-22 of
// it), the accuracy class of an fp32 FMA sum taken in another order.  P
// and dS are split the same way before the second products.  The tensor
// cores' fp32 accumulation does not round to nearest: summed straight into
// dQ / dK / dV over a 4096-token causal sweep, the products drifted to
// 3.7e-5 norm-relative from the plain version (scripts/
// ab_flash_bwd_tf32x3.py, variant no_tile_sums).  So each second product
// sums one tile (or q step) in a fresh accumulator and adds that to the
// long-lived one in fp32 (round to nearest): 3.1e-6.  The split's rounding
// by cvt.rna.tf32.f32 (a slow conversion instruction) and lo rounded
// rather than truncated cost time for no accuracy (PERF.md).  P and F (the
// scale times the softcap's factor) come from ``p_f`` (csrc/tf32x3.cuh, s
// / cap a product with 1 / cap), dS = P (dP - dsum) F.
//
// What bounds it on an H100.  Operations: dq is three products of
// 2*Lq*Lk*D FLOPs (s, dP, dS.K), dk/dv four (s, dP, P^T.dO, dS^T.Q), halved
// under causal; three TF32 passes each at 495 TFLOP/s of dense TF32 (at
// B=2, L=4096, Hq=16, D=128 causal: 3 x 206.2 and 3 x 274.9 GFLOP, 1.250 and
// 1.666 ms).  The bytes (each operand read once) are far below that.
// ``mma.sync`` reaches less than ``wgmma``'s rate: scripts/mma_tf32_probe.py
// measures its ceiling.
//
// Design.
//   Why mma.sync and not wgmma.  wgmma reads tf32 operands from shared
//   memory K-major only (its transpose bits exist for 16-bit types), and
//   three of the seven products read an operand MN-major (dS.K, dS^T.Q,
//   P^T.dO).  Transposed hi and lo copies of Q and dO would take 256 KB for
//   one 64-row stage at D = 128.  With the warp-level
//   mma.sync.m16n8k8.tf32, every fragment is loaded by address, so one raw
//   fp32 copy of a tile serves both orientations and the split happens in
//   registers.
//   Blocks.  A block owns one 64-row tile.  dq: 512 threads (16 warps)
//   own 64 q rows of one head and walk the K tiles (64 keys) the band
//   reaches; warp w computes S and dP for q rows 16*(w%4).. and keys
//   16*(w/4).. of the tile, then its share of dQ += dS.K over those 16
//   keys.  dk/dv: 256 threads (8 warps) own 64 keys of one KV head and walk
//   all group * nq q tiles of its query heads (the GQA sum stays in
//   registers, no atomics, deterministic); warp w owns
//   keys 16*(w%4).. and q rows 32*(w/4).. of each q tile.  The partial
//   sums of a block's warps are added once, through shared memory, at the
//   end.  Registers a thread at D = 128: dK and dV 128, S^T and dP^T 32
//   (255 in all, one block an SM); dq: dQ 64, S and dP 16 (128 in all).
//   Fragments (helpers in csrc/tf32x3.cuh, shared with
//   csrc/flash_bwd_tf32x3_wide.cu).  An m16n8 accumulator holds columns
//   2t, 2t+1 of its 8 (t = lane % 4); the tf32 A fragment wants columns t,
//   t+4.  The contraction
//   index of the second products is numbered so that logical t is
//   physical 2t and t+4 is 2t+1, and the B rows are loaded by that map, so
//   P / dS (and P^T / dS^T) go from the accumulator into the next product
//   with no shuffle and no shared memory.
//   Staging.  Raw fp32 tiles come through a ring of two stages filled by
//   cp.async (16 bytes a thread, zero-filled past Lq / Lk), so the next
//   tile's copy overlaps this tile's math.  Rows are padded to D + 4 floats,
//   which makes both the row-wise fragment loads (bank 4g + t) and the
//   column-wise loads of the transposed operands (bank 8t + g) free of
//   bank conflicts.  At D = 128: six 64 x 132 fp32 tiles, 198 KB (dk/dv 199
//   KB with the stats), one block an SM.  dq runs one block an SM at every
//   D (512 threads at 128 registers fill the register file); dk/dv two at
//   D <= 32, where its registers allow.
//   Masks.  ``tile_runs``, ``tile_full``, ``next_k_tile``, ``next_q_step``
//   and ``visible`` from csrc/sm90_common.cuh: a tile the band cannot
//   reach is skipped, a tile wholly inside it skips the per-element test.
//   The grid puts the tile index on its slow axis, heaviest first under
//   causal.
//   Tuning.  scripts/ab_flash_bwd_tf32x3.py times the choices above against
//   their alternatives (kDqKeySplit, kDkvSumSteps, the rounding); PERF.md
//   has the numbers.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dq_tf32x3_kernel<16>   108, 0    flash_dkv_tf32x3_kernel<16>  124, 0
//   flash_dq_tf32x3_kernel<32>   108, 0    flash_dkv_tf32x3_kernel<32>  128, 0
//   flash_dq_tf32x3_kernel<64>   128, 0    flash_dkv_tf32x3_kernel<64>  203, 0
//   flash_dq_tf32x3_kernel<128>  128, 0    flash_dkv_tf32x3_kernel<128> 255, 0
// (no stack frame).

#include "tf32x3.cuh"

namespace {

constexpr int kBlock = 256;             // threads of a dk/dv block
constexpr int kDqKeySplit = 4;          // dq: warps sharing a K tile's keys
constexpr int kDqBlock = 128 * kDqKeySplit;
constexpr int kDkvSumSteps = 4;         // dk/dv: k steps a partial sum holds

// A staged 64-row tile: rows padded to D + 4 floats.
template <int D>
struct Tile {
  static constexpr int kStride = D + 4;
  static constexpr int kFloats = kTile * kStride;
};

// Rows row0..row0+63 of a (rows, D) fp32 matrix into a padded tile, by
// ``THREADS`` threads; rows at or past ``rows`` are zeros.
template <int D, int THREADS = kBlock>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows, int tid) {
  constexpr int kChunks = D / 4;          // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < kTile * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * Tile<D>::kStride + c,
               src + static_cast<size_t>(in ? row0 + r : 0) * D + c,
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO; two stages of K, V.
  return sizeof(float) * 6 * Tile<D>::kFloats;
}

template <int D>
__global__ void __launch_bounds__(kDqBlock,
                                  D == 128 || kDqKeySplit > 2 ? 1 : 2)
flash_dq_tf32x3_kernel(const Args a) {
  constexpr int S = Tile<D>::kStride, T = Tile<D>::kFloats, NB = D / 8;
  constexpr int KW = kTile / kDqKeySplit;   // keys a warp, of each K tile
  constexpr int NK = KW / 8;                // their 8-key blocks
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + T;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3;          // q rows 16*rw.. of the tile
  const int kh = warp >> 2;         // keys KW*kh.. of each K tile
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + kTile - 1) / kTile;
  const int row_a = q0 + 16 * rw + g;                    // accumulator rows
  const float* kp = a.k + static_cast<size_t>(bkv) * a.lk * D;
  const float* vp = a.v + static_cast<size_t>(bkv) * a.lk * D;
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0;
  const float inv_cap = a.softcap != 0.f ? 1.f / a.softcap : 0.f;

  float dq[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  int kt = next_k_tile(a, q0, doc_first, -1, nk);        // block-uniform
  if (kt < nk) {
    const size_t qbase = static_cast<size_t>(b) * a.lq * D;
    load_tile<D, kDqBlock>(sQ, a.q + qbase, q0, a.lq, tid);
    load_tile<D, kDqBlock>(sDO, a.dout + qbase, q0, a.lq, tid);
    load_tile<D, kDqBlock>(smem + 2 * T, kp, kt * kTile, a.lk, tid);
    load_tile<D, kDqBlock>(smem + 3 * T, vp, kt * kTile, a.lk, tid);
    cp_async_commit();
    int kn = next_k_tile(a, q0, doc_first, kt, nk);
    if (kn < nk) {
      load_tile<D, kDqBlock>(smem + 4 * T, kp, kn * kTile, a.lk, tid);
      load_tile<D, kDqBlock>(smem + 5 * T, vp, kn * kTile, a.lk, tid);
    }
    cp_async_commit();

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
      cp_async_wait<1>();
      __syncthreads();                 // tile kt has landed
      const float* sK = smem + (2 + 2 * (it & 1)) * T;
      const float* sV = sK + T;
      const int k0 = kt * kTile;

      // S = Q.K^T and dP = dO.V^T: this warp's 16 q rows x KW keys.
      float sc[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < D / 8; ++ks) {
        const FragA qa = load_a<S>(sQ, 16 * rw + g, 8 * ks + t);
        const FragA da = load_a<S>(sDO, 16 * rw + g, 8 * ks + t);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int off = (KW * kh + 8 * n + g) * S + 8 * ks + t;
          mma3(sc[n], qa, sK[off], sK[off + 4]);
          mma3(dp[n], da, sV[off], sV[off + 4]);
        }
      }

      // dS in place of S.
      const bool full = tile_full(a, q0, k0, doc_last);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          float p, f;
          p_f(a, sc[n][i], shift[h], inv_cap, p, f);
          float ds = p * (dp[n][i] - dsum[h]) * f;
          if (!full && !visible(a, row_a + 8 * h, qlog[h], qdoc[h],
                                k0 + KW * kh + 8 * n + 2 * t + (i & 1)))
            ds = 0.f;
          sc[n][i] = ds;
        }

      // dQ += dS.K over this warp's KW keys: k step n reads key rows
      // KW*kh + 8n + 2t (logical t) and + 1 (logical t + 4).  Each
      // column block's sum over the tile is added in fp32.
      FragA dsa[NK];
#pragma unroll
      for (int n = 0; n < NK; ++n) dsa[n] = acc_as_a(sc[n]);
      tile_product<NB, S, NK>(dq, dsa, sK + (KW * kh + 2 * t) * S + g);

      __syncthreads();                 // stage it & 1 is free
      const int ka = kn < nk ? next_k_tile(a, q0, doc_first, kn, nk) : nk;
      if (ka < nk) {
        load_tile<D, kDqBlock>(smem + (2 + 2 * (it & 1)) * T, kp, ka * kTile,
                               a.lk, tid);
        load_tile<D, kDqBlock>(smem + (3 + 2 * (it & 1)) * T, vp, ka * kTile,
                               a.lk, tid);
      }
      cp_async_commit();
      kt = kn;
      kn = ka;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The key groups' partial dQ meet in shared memory (the stages' space).
  float* red = smem + 2 * T;
  if (kh > 0) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((((kh - 1) * 4 + rw) * NB + c) * 4 + i) * 32 + lane] = dq[c][i];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int j = 0; j < kDqKeySplit - 1; ++j)
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dq[c][i] += red[(((j * 4 + rw) * NB + c) * 4 + i) * 32 + lane];
    float* dqp = a.dq + static_cast<size_t>(b) * a.lq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= a.lq) continue;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const float2 out = make_float2(dq[c][2 * h], dq[c][2 * h + 1]);
        *reinterpret_cast<float2*>(dqp + static_cast<size_t>(row) * D +
                                   8 * c + 2 * t) = out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; two stages of Q, dO; two stages of 64 shifts and 64 dsums.
  return sizeof(float) * (6 * Tile<D>::kFloats + 2 * 2 * kTile);
}

// Q, dO, shifts and dsums of q step ``g`` into a stage.
template <int D>
__device__ __forceinline__ void load_q_step(const Args& a, float* stage,
                                            float* stats, int bkv, int g,
                                            int nq, int tid) {
  const int b = bkv * a.group + g / nq;
  const int q0 = (g % nq) * kTile;
  const size_t base = static_cast<size_t>(b) * a.lq * D;
  load_tile<D>(stage, a.q + base, q0, a.lq, tid);
  load_tile<D>(stage + Tile<D>::kFloats, a.dout + base, q0, a.lq, tid);
  if (tid < kTile) {
    const int row = q0 + tid;
    const bool in = row < a.lq;
    const float lse = in ? a.lse[static_cast<size_t>(b) * a.lq + row]
                         : kNegInf;
    stats[tid] = lse <= kNegInf / 2 ? 0.f : lse;
    stats[kTile + tid] =
        in ? a.dsum[static_cast<size_t>(b) * a.lq + row] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kBlock, D <= 32 ? 2 : 1)
flash_dkv_tf32x3_kernel(const Args a) {
  constexpr int S = Tile<D>::kStride, T = Tile<D>::kFloats, NB = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + T;
  float* stats = smem + 6 * T;     // stage s: 64 shifts, 64 dsums

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3;          // keys 16*kw.. of the tile
  const int qh = warp >> 2;         // q rows 32*qh.. of each q tile
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int nq = (a.lq + kTile - 1) / kTile;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * kw + g;   // accumulator rows
  const float inv_cap = a.softcap != 0.f ? 1.f / a.softcap : 0.f;

  float dk[NB][4], dv[NB][4];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[c][i] = dv[c][i] = 0.f;

  int g_step = next_q_step(a, k0, bkv, -1, nq);          // block-uniform
  if (g_step < steps) {
    const size_t kbase = static_cast<size_t>(bkv) * a.lk * D;
    load_tile<D>(sK, a.k + kbase, k0, a.lk, tid);
    load_tile<D>(sV, a.v + kbase, k0, a.lk, tid);
    load_q_step<D>(a, smem + 2 * T, stats, bkv, g_step, nq, tid);
    cp_async_commit();
    int gn = next_q_step(a, k0, bkv, g_step, nq);
    if (gn < steps)
      load_q_step<D>(a, smem + 4 * T, stats + 2 * kTile, bkv, gn, nq, tid);
    cp_async_commit();

    for (int it = 0; g_step < steps; ++it) {
      cp_async_wait<1>();
      __syncthreads();                 // step g_step has landed
      const int s = it & 1;
      const int b = bkv * a.group + g_step / nq;
      const int q0 = (g_step % nq) * kTile;
      const float* sQ = smem + (2 + 2 * s) * T;
      const float* sDO = sQ + T;
      const float* s_shift = stats + 2 * kTile * s;
      const float* s_dsum = s_shift + kTile;

      // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 keys x 32 q rows.
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < D / 8; ++ks) {
        const FragA ka = load_a<S>(sK, 16 * kw + g, 8 * ks + t);
        const FragA va = load_a<S>(sV, 16 * kw + g, 8 * ks + t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int off = (32 * qh + 8 * n + g) * S + 8 * ks + t;
          mma3(st[n], ka, sQ[off], sQ[off + 4]);
          mma3(dpt[n], va, sDO[off], sDO[off + 4]);
        }
      }

      // P^T and dS^T in place of S^T and dP^T.
      const int* docp =
          a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq
                   : nullptr;
      const bool full = tile_full(
          a, q0, k0, a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 32 * qh + 8 * n + 2 * t + (i & 1);
          float p, f;
          p_f(a, st[n][i], s_shift[c], inv_cap, p, f);
          float ds = p * (dpt[n][i] - s_dsum[c]) * f;
          if (!full) {
            const int row = q0 + c;
            const int qlog =
                logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
            const int qdoc =
                (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
            if (!visible(a, row, qlog, qdoc, key_a + 8 * (i >> 1)))
              p = ds = 0.f;
          }
          st[n][i] = p;
          dpt[n][i] = ds;
        }

      // dV += P^T.dO, then dK += dS^T.Q, over this warp's 32 q rows: k
      // step n reads q rows 32*qh + 8n + 2t (logical t) and + 1 (t + 4).
      // Each column block's sum over the step is added in fp32.
      constexpr int NS = kDkvSumSteps;
      const int off = (32 * qh + 2 * t) * S + g;
#pragma unroll
      for (int h = 0; h < 4 / NS; ++h) {
        FragA fa[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n) fa[n] = acc_as_a(st[NS * h + n]);
        tile_product<NB, S, NS>(dv, fa, sDO + off + 8 * NS * h * S);
      }
#pragma unroll
      for (int h = 0; h < 4 / NS; ++h) {
        FragA fa[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n) fa[n] = acc_as_a(dpt[NS * h + n]);
        tile_product<NB, S, NS>(dk, fa, sQ + off + 8 * NS * h * S);
      }

      __syncthreads();                 // stage s is free
      const int ga = gn < steps ? next_q_step(a, k0, bkv, gn, nq) : steps;
      if (ga < steps)
        load_q_step<D>(a, smem + (2 + 2 * s) * T, stats + 2 * kTile * s,
                       bkv, ga, nq, tid);
      cp_async_commit();
      g_step = gn;
      gn = ga;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The q halves' partial dK and dV meet in shared memory (stage 0's
  // space).
  float* red = smem + 2 * T;
  if (qh == 1) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        red[((kw * 2 * NB + c) * 4 + i) * 32 + lane] = dk[c][i];
        red[((kw * 2 * NB + NB + c) * 4 + i) * 32 + lane] = dv[c][i];
      }
  }
  __syncthreads();
  if (qh == 0) {
    const size_t base = static_cast<size_t>(bkv) * a.lk * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_a + 8 * h;
      if (key >= a.lk) continue;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const int i = 2 * h;
        const size_t at = base + static_cast<size_t>(key) * D + 8 * c + 2 * t;
        float2 o;
        o.x = dk[c][i] + red[((kw * 2 * NB + c) * 4 + i) * 32 + lane];
        o.y = dk[c][i + 1] + red[((kw * 2 * NB + c) * 4 + i + 1) * 32 + lane];
        *reinterpret_cast<float2*>(a.dk + at) = o;
        o.x = dv[c][i] + red[((kw * 2 * NB + NB + c) * 4 + i) * 32 + lane];
        o.y = dv[c][i + 1] +
              red[((kw * 2 * NB + NB + c) * 4 + i + 1) * 32 + lane];
        *reinterpret_cast<float2*>(a.dv + at) = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(int which, const Args& a, int bhkv, cudaStream_t stream) {
  const size_t smem = which ? dkv_smem_bytes<D>() : dq_smem_bytes<D>();
  auto kernel = which ? flash_dkv_tf32x3_kernel<D> : flash_dq_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // The tile index on the slow axis: blocks start tile by tile.
  const dim3 grid = which ? dim3(bhkv, (a.lk + kTile - 1) / kTile)
                          : dim3(a.bh, (a.lq + kTile - 1) / kTile);
  kernel<<<grid, which ? kBlock : kDqBlock, smem, stream>>>(a);
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
  if ((d != 16 && d != 32 && d != 64 && d != 128) ||
      !make_args(a, which, q, k, v, dout, lse, dsum, o0, o1, doc, is_bf16,
                 bh, bhkv, lq, lk, q_off_lo, q_off_hi, k_off_lo, k_off_hi,
                 kv_valid, q_seg, k_seg, causal, window, softcap, scale,
                 packed, doc_skip, doc_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(which, a, bhkv, st); break;
    case 32: err = launch<32>(which, a, bhkv, st); break;
    case 64: err = launch<64>(which, a, bhkv, st); break;
    default: err = launch<128>(which, a, bhkv, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd_sm90.cu's entry points (is_bf16 must be
// 0, d one of 16, 32, 64, 128, and q, k, v, do and the outputs 16-byte
// aligned).  Each returns the cudaError_t of its launch (0 = launched).
int flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
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

int flash_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         void* dk, void* dv, const void* doc, int is_bf16,
                         int bh, int bhkv, int lq, int lk, int d,
                         int q_off_lo, int q_off_hi, int k_off_lo,
                         int k_off_hi, int kv_valid, int q_seg, int k_seg,
                         int causal, int window, float softcap, float scale,
                         int packed, int doc_skip, int doc_rows,
                         void* stream) {
  return run(1, q, k, v, dout, lse, dsum, dk, dv, doc, is_bf16, bh, bhkv, lq,
             lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg,
             k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

const char* flash_bwd_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
