// Flash-attention forward for fp32 on Hopper's tensor cores (sm_90a),
// written by hand in CUDA C++: the ``"tf32x3"`` route at the padded D 16,
// 32, 64 and 128, each product in three TF32 passes ("3xTF32").
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (:145), the
// Pallas TPU kernel launched by ``_fwd`` (:252), for fp32 operands up to D
// 128 (csrc/flash_fwd_tf32x3_wide.cu serves the widths above).  Same
// function, folded layout and C arguments as every forward source: q
// (B*Hq, Lq, D), k/v (B*Hkv, Lk, D), all fp32; GQA: q row b reads KV row
// b / group.  out = softmax(mask(softcap(scale * Q.K^T))).V (B*Hq, Lq, D)
// and the row lse (B*Hq, Lq), natural log; a row that sees no key gets out
// 0 and lse -1e30.  The mask (the five band ints, q_seg / k_seg, kv_valid,
// causal, window, the doc table with doc_skip), the softcap, the scale
// (of either sign) and the whole-tile skip (``tile_runs``, ``tile_full``,
// ``next_k_tile``, ``visible`` from csrc/sm90_common.cuh) are launch
// arguments.
//
// Numerics: the backward's (csrc/flash_bwd_tf32x3.cu, helpers in
// csrc/tf32x3.cuh).  Each fp32 operand is split in registers into a TF32
// hi (round to nearest, ties away) and a truncated lo, and every product
// is hi.lo + lo.hi + hi.hi, small terms first: about 21 of fp32's 24
// mantissa bits.  S = Q.K^T sums its D / 8 <= 16 k steps in a fresh
// accumulator each K stage.  The online softmax keeps the row max m and
// sum l in fp32; a row keeps shift 0 until it sees a key, so no exp of an
// infinity.  P is split like any operand and goes from the S accumulator
// into P.V through ``acc_as_a`` (V rows loaded by the permuted map), and
// P.V sums one stage in a fresh accumulator, then O = O * alpha + part in
// fp32: summed straight into O, the tensor cores' fp32 sum (which does not
// round to nearest) drifts over a 4096-key sweep (3.7e-5 norm-relative in
// the backward, csrc/flash_bwd_tf32x3.cu).  The softcap is cap *
// tanhf(s / cap) with 1 / cap a product, exp is expf, lse is m +
// logf(l).
//
// What bounds it on an H100.  Operations: two products of 2*Lq*Lk*D FLOPs
// (S and P.V), halved under causal, in three TF32 passes at 495 TFLOP/s
// of dense TF32 (qwen3-1.7b's prefill shape, B=2, L=4096, Hq=16, D=128,
// causal: 3 x 137.4 GFLOP, 0.833 ms).  The bytes (q, k, v read once, out
// and lse written once) are far below that.  ``mma.sync`` reaches less
// than ``wgmma``'s rate: scripts/mma_tf32_probe.py measures its ceiling.
//
// Design.
//   Why mma.sync.  wgmma reads tf32 operands from shared memory K-major
//   only; V in P.V is read MN-major, and hi / lo copies of a transposed V
//   would double its stages.  mma.sync loads every fragment by address, so
//   one raw fp32 copy of a tile serves both orientations and the split
//   happens in registers.
//   Blocks.  kWarps warps own 16 q rows each (kWarps * 16 q rows a block)
//   and walk the K stages (kKeys keys) the band reaches.  A warp computes
//   S for its 16 rows and all the stage's keys, so the row max and sum are
//   quad shuffles (no shared memory), and keeps O for its rows in
//   registers (D / 2 floats a lane: 64 at D 128).  The row sum l stays a
//   per-lane partial until the end.
//   Staging.  Q once, then K and V through a ring of two stages filled by
//   cp.async (16 bytes a thread, zero-filled past Lq / Lk): the next
//   stage's copy is issued right after the step's __syncthreads, so it
//   overlaps this step's math.  Rows padded to D + 4 floats, free of bank
//   conflicts for both the row-wise Q / K loads and V's column-wise loads
//   (csrc/tf32x3.cuh).  101,376 bytes at D 128: two blocks (8 warps) an
//   SM.
//   Masks.  A K stage the band cannot reach is skipped, one wholly inside
//   it skips the per-element test.  The grid puts the q tile on its slow
//   axis, the last (heaviest under causal) first.
//   Tuning.  scripts/ab_flash_fwd_tf32x3.py times the knobs (kWarps,
//   kKeys) and other designs against this one and the parent tree's FMA
//   forward at qwen3-1.7b's prefill shape (PERF.md has the numbers).
//   Against the kept design, back to back: 64-key stages 2.00x (one block
//   of 4 warps an SM, 4 bytes spilled), 8 warps a block 1.04x, 8 warps
//   and 64-key stages 1.15x, Q split once into hi / lo in shared memory
//   1.44x with 4 warps (one block an SM) and 1.01x with 8.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_fwd_tf32x3_kernel<16> 96, 0     flash_fwd_tf32x3_kernel<64>  181, 0
//   flash_fwd_tf32x3_kernel<32> 127, 0    flash_fwd_tf32x3_kernel<128> 255, 0
// (no stack frame).

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;               // warps a block, 16 q rows each
constexpr int kKeys = 32;               // keys a stage
constexpr int kQRows = 16 * kWarps;     // q rows a block
constexpr int kFwdThreads = 32 * kWarps;

// The shared-memory layout at D: the Q tile, two stages of K and V; rows
// padded to D + 4 floats.
template <int D>
struct Layout {
  static constexpr int kStride = D + 4;
  static constexpr int kQ = kQRows * kStride;     // floats of the Q tile
  static constexpr int kStage = kKeys * kStride;  // floats of a K or V tile
  static constexpr size_t kBytes = sizeof(float) * (kQ + 4 * kStage);
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_tf32x3_kernel(const FwdArgs32 a) {
  using L = Layout<D>;
  constexpr int S = L::kStride, NB = D / 8, NK = kKeys / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* ring = sQ + L::kQ;         // stage s: K at 2s, V at 2s + 1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;  // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + kKeys - 1) / kKeys;
  const int row_a = q0 + 16 * warp + g;                  // accumulator rows
  const float* kp = a.k + static_cast<size_t>(bkv) * a.lk * D;
  const float* vp = a.v + static_cast<size_t>(bkv) * a.lk * D;
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kQRows, a.lq) - 1] : 0;
  const float inv_cap = a.softcap != 0.f ? 1.f / a.softcap : 0.f;

  float o[NB][4];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int qlog[2], qdoc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    qlog[h] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
    qdoc[h] = (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
  }

  int kt = next_k_tile<kQRows, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {                    // block-uniform
    load_rows<D, kQRows, kFwdThreads>(
        sQ, a.q + static_cast<size_t>(b) * a.lq * D, q0, a.lq, tid);
    load_rows<D, kKeys, kFwdThreads>(ring, kp, kt * kKeys, a.lk, tid);
    load_rows<D, kKeys, kFwdThreads>(ring + L::kStage, vp, kt * kKeys, a.lk,
                                     tid);
    cp_async_commit();
    int kn = next_k_tile<kQRows, kKeys>(a, q0, doc_first, kt, nk);

    for (int it = 0; kt < nk; ++it) {
      cp_async_wait<0>();
      __syncthreads();        // stage kt has landed; step it - 1 is done
      const float* sK = ring + 2 * (it & 1) * L::kStage;
      const float* sV = sK + L::kStage;
      if (kn < nk) {
        float* next = ring + 2 * ((it + 1) & 1) * L::kStage;
        load_rows<D, kKeys, kFwdThreads>(next, kp, kn * kKeys, a.lk, tid);
        load_rows<D, kKeys, kFwdThreads>(next + L::kStage, vp, kn * kKeys,
                                         a.lk, tid);
      }
      cp_async_commit();
      const int k0 = kt * kKeys;

      // S = Q.K^T: this warp's 16 q rows x the stage's keys, one fresh sum.
      float sc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < D / 8; ++ks) {
        const FragA qa = load_a<S>(sQ, 16 * warp + g, 8 * ks + t);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int off = (8 * n + g) * S + 8 * ks + t;
          mma3(sc[n], qa, sK[off], sK[off + 4]);
        }
      }

      // Scores, masked to -1e30, and the rows' new maxima (quad shuffles).
      const bool full = tile_full<kQRows, kKeys>(a, q0, k0, doc_last);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          float s = score(a, sc[n][i], inv_cap);
          if (!full && !visible(a, row_a + 8 * h, qlog[h], qdoc[h],
                                k0 + 8 * n + 2 * t + (i & 1)))
            s = kNegInf;
          sc[n][i] = s;
          mx[h] = fmaxf(mx[h], s);
        }
      float shift[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // A row that has seen no key keeps shift 0 (its alpha is 0).
        shift[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
        alpha[h] = m[h] <= kNegInf / 2 ? 0.f : expf(m[h] - shift[h]);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      // P in place of S (a masked score's exp is 0), l += this lane's sum.
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[n][i] = expf(sc[n][i] - shift[i >> 1]);
          l[i >> 1] += sc[n][i];
        }
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[c][i] *= alpha[i >> 1];

      // O = O * alpha + P.V: k step n reads key rows 8n + 2t (logical t)
      // and + 1 (t + 4); the stage's sum is added in fp32.
      FragA pa[NK];
#pragma unroll
      for (int n = 0; n < NK; ++n) pa[n] = acc_as_a(sc[n]);
      tile_product<NB, S, NK>(o, pa, sV + 2 * t * S + g);

      kt = kn;
      kn = kn < nk ? next_k_tile<kQRows, kKeys>(a, q0, doc_first, kn, nk)
                   : nk;
    }
  }
  cp_async_wait<0>();

  float* op = a.out + static_cast<size_t>(b) * a.lq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row_a + 8 * h;
    if (row >= a.lq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int c = 0; c < NB; ++c)
      *reinterpret_cast<float2*>(op + static_cast<size_t>(row) * D + 8 * c +
                                 2 * t) =
          make_float2(o[c][2 * h] / l_safe, o[c][2 * h + 1] / l_safe);
    if (t == 0) {
      const float shift = m[h] <= kNegInf / 2 ? 0.f : m[h];
      a.lse[static_cast<size_t>(b) * a.lq + row] =
          l[h] == 0.f ? kNegInf : shift + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch(const FwdArgs32& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  auto kernel = flash_fwd_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // The q tile on the slow axis: blocks start tile by tile.
  const dim3 grid(a.bh, (a.lq + kQRows - 1) / kQRows);
  kernel<<<grid, kFwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of every forward source (is_bf16 must be 0, d one of 16,
// 32, 64, 128, and q, k, v and out 16-byte aligned).  Returns the
// cudaError_t of the launch (0 = launched).
int flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* out,
                     void* lse, const void* doc, int is_bf16, int bh,
                     int bhkv, int lq, int lk, int d, int q_off_lo,
                     int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
                     int q_seg, int k_seg, int causal, int window,
                     float softcap, float scale, int packed, int doc_skip,
                     int doc_rows, void* stream) {
  FwdArgs32 a;
  if ((d != 16 && d != 32 && d != 64 && d != 128) ||
      !make_fwd_args(a, q, k, v, out, lse, doc, is_bf16, bh, bhkv, lq, lk,
                     q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg,
                     k_seg, causal, window, softcap, scale, packed, doc_skip,
                     doc_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(a, st); break;
    case 32: err = launch<32>(a, st); break;
    case 64: err = launch<64>(a, st); break;
    default: err = launch<128>(a, st); break;
  }
  return static_cast<int>(err);
}

const char* flash_fwd_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
