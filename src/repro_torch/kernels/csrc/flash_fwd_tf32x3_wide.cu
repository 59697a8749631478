// Flash-attention forward for fp32 above head dim 128 on Hopper's tensor
// cores (sm_90a), written by hand in CUDA C++: the ``"tf32x3w"`` route at
// the padded D 192, 256, 288 and 384, each product in three TF32 passes
// ("3xTF32").
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (:145), the
// Pallas TPU kernel launched by ``_fwd`` (:252), for fp32 operands at every
// D above 128 (csrc/flash_fwd_tf32x3.cu serves D up to 128).  Same
// function, folded layout and C arguments as every forward source: q
// (B*Hq, Lq, D), k/v (B*Hkv, Lk, D), all fp32; GQA: q row b reads KV row
// b / group.  out = softmax(mask(softcap(scale * Q.K^T))).V and the row
// lse, natural log; a row that sees no key gets out 0 and lse -1e30.  The
// mask (the five band ints, q_seg / k_seg, kv_valid, causal, window, the
// doc table with doc_skip), the softcap, the scale (of either sign) and
// the whole-tile skip (``tile_runs``, ``tile_full``, ``next_k_tile``,
// ``visible`` from csrc/sm90_common.cuh) are launch arguments.
//
// Numerics: csrc/flash_fwd_tf32x3.cu's (helpers in csrc/tf32x3.cuh): every
// operand split into a TF32 hi (round to nearest, ties away) and a
// truncated lo, every product hi.lo + lo.hi + hi.hi, small terms first.
// S = Q.K^T contracts over up to 384 columns: each of two warps sums half
// of them in two fresh partial sums, the even and the odd k steps, each at
// most kSumK = 16 k steps (``first_product``, shared with
// csrc/flash_bwd_tf32x3_wide.cu), and the halves are added in fp32.  P.V
// sums one stage in a fresh accumulator, then O = O * alpha + part in
// fp32.  A row keeps shift 0 until it sees a key.
//
// What bounds it on an H100.  Operations: two products of 2*Lq*Lk*D FLOPs
// (S and P.V), halved under causal, in three TF32 passes at 495 TFLOP/s
// of dense TF32 (gemma2-2b's shape, B=2, L=4096, Hq=8, Hkv=4, D=288,
// causal: 3 x 154.7 GFLOP, 0.937 ms).  The bytes are far below that.
// ``mma.sync`` reaches less than ``wgmma``'s rate: scripts/mma_tf32_probe.py
// measures its ceiling.
//
// Design.
//   Why not csrc/flash_fwd_tf32x3.cu's tiling.  A warp there keeps O for
//   16 q rows x D columns in registers: D / 2 floats a lane, 144 at D 288.
//   Here, as in csrc/flash_bwd_tf32x3_wide.cu's dq, each warp owns a
//   column slice of O, and the score tile is computed once a step and
//   traded through shared memory in fragment order.
//   Blocks.  256 threads (8 warps), one block an SM.  A block owns 64 q
//   rows of one head, in four row groups of 16 rows and two warps each,
//   and streams K and V through two cp.async stages of 16 keys.  A row
//   group's 16 x 16 score tile is summed by its two warps, each over half
//   of the contraction.  The second hands its partial
//   S to the first through shared memory (named barrier of the row group's
//   64 threads); the first adds it, forms the scores (softcap, mask) and
//   writes its rows' maxima; after a second barrier both warps take the
//   new maxima (the same in each), the first writes P and its rows' sums,
//   and after a third each warp adds P.V to its half of O's columns (D /
//   2: 144 at D 288, 72 floats a thread) and moves its copy of m and l on.
//   Each warp writes its own O slice: no final sum.
//   Shared memory.  Rows padded to D + 4 floats (bank-conflict free for
//   both orientations, csrc/tf32x3.cuh): the Q tile, two stages of K and
//   V, and the exchanges (partial S, P, maxima, sums): 158,208 bytes at
//   D 288, 207,360 at D 384.
//   Staging.  Every thread issues its share of a stage's 16-byte cp.async
//   copies (zero-filled past Lq / Lk) right after the step's
//   __syncthreads, so the next stage's copy overlaps this step's math.
//   Masks.  A K stage the band cannot reach is skipped, one wholly inside
//   it skips the per-element test.  The grid puts the q tile on its slow
//   axis, the last (heaviest under causal) first.
//   Tuning.  scripts/ab_flash_fwd_tf32x3.py --wide times this design
//   against another tree's forward at gemma2-2b's shape.  Measured and
//   not kept (PERF.md has the numbers), back to back, with
//   softcap 50 / 0: the first design (32 q rows in two row groups of four
//   warps, 32-key stages, 16 at D 384) took 1.13x / 1.14x at D 288 and
//   1.29x / 1.25x at head dim 320, where this one reads each K / V stage
//   for twice the rows; 8-key units (two a row group, each warp one over
//   the whole contraction, no partial-S exchange) 1.03x / 1.07x and
//   1.04x / 1.08x.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_fwd_tf32x3w_kernel<192> 184, 0   flash_fwd_tf32x3w_kernel<288> 236, 0
//   flash_fwd_tf32x3w_kernel<256> 218, 0   flash_fwd_tf32x3w_kernel<384> 255, 0
// (no stack frame).

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBlockW = 32 * kWarps;   // threads of a block
constexpr int kRows = 64;              // q rows a block
constexpr int kGroups = kRows / 16;    // row groups (16 q rows, two warps)
constexpr int kKeys = 16;              // keys a stage

// The shared-memory layout at D: the Q tile, two stages of K and V, the
// second halves' partial S, P, and the rows' maxima and sums; rows padded
// to D + 4.
template <int D>
struct Wide {
  static constexpr int kStride = D + 4;
  static constexpr int kSteps = D / 16;           // k steps of a half
  static constexpr int kQ = kRows * kStride;      // floats of the Q tile
  static constexpr int kStage = kKeys * kStride;  // floats of a K or V tile
  static constexpr int kX = kGroups * kKeys * 16;  // partial S, and P
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + 4 * kStage + 2 * kX + 2 * kRows);
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
  static_assert(kSteps % 2 == 0, "whole fragments");
};

template <int D>
__global__ void __launch_bounds__(kBlockW, 1)
flash_fwd_tf32x3w_kernel(const FwdArgs32 a) {
  using W = Wide<D>;
  constexpr int S = W::kStride;
  constexpr int NN = kKeys / 8;     // 8-key blocks of a stage
  constexpr int NB = D / 16;        // 8-column blocks of a warp's O
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* ring = sQ + W::kQ;         // stage s: K at 2s, V at 2s + 1
  float4* xs = reinterpret_cast<float4*>(ring + 4 * W::kStage);
  float4* xp = xs + W::kX / 4;
  float* red_m = reinterpret_cast<float*>(xp + W::kX / 4);
  float* red_l = red_m + kRows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rh = warp % kGroups;    // row group: q rows 16*rh..
  const int half = warp / kGroups;  // its half of the contraction and of O
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + kKeys - 1) / kKeys;
  const int row_a = q0 + 16 * rh + g;                    // accumulator rows
  const float* kp = a.k + static_cast<size_t>(bkv) * a.lk * D;
  const float* vp = a.v + static_cast<size_t>(bkv) * a.lk * D;
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kRows, a.lq) - 1] : 0;
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

  int kt = next_k_tile<kRows, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {                    // block-uniform
    load_rows<D, kRows, kBlockW>(
        sQ, a.q + static_cast<size_t>(b) * a.lq * D, q0, a.lq, tid);
    load_rows<D, kKeys, kBlockW>(ring, kp, kt * kKeys, a.lk, tid);
    load_rows<D, kKeys, kBlockW>(ring + W::kStage, vp, kt * kKeys, a.lk, tid);
    cp_async_commit();
    int kn = next_k_tile<kRows, kKeys>(a, q0, doc_first, kt, nk);

    for (int it = 0; kt < nk; ++it) {
      cp_async_wait<0>();
      __syncthreads();        // stage kt has landed; step it - 1 is done
      const float* sK = ring + 2 * (it & 1) * W::kStage;
      const float* sV = sK + W::kStage;
      if (kn < nk) {
        float* next = ring + 2 * ((it + 1) & 1) * W::kStage;
        load_rows<D, kKeys, kBlockW>(next, kp, kn * kKeys, a.lk, tid);
        load_rows<D, kKeys, kBlockW>(next + W::kStage, vp, kn * kKeys, a.lk,
                                     tid);
      }
      cp_async_commit();
      const int k0 = kt * kKeys;

      // This warp's half of S = Q.K^T: 16 q rows x the stage's keys.
      float x[NN][4];
      first_product<S, NN, W::kSteps>(x, sQ + 8 * W::kSteps * half,
                                      sK + 8 * W::kSteps * half, 16 * rh, 0,
                                      g, t);
      if (half == 1) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
          xs[(rh * NN + n) * 32 + lane] =
              make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
      }
      bar_sync(1 + rh, 64);   // the row group's two warps

      // The first half's warp: the whole S, the scores, the rows' maxima.
      if (half == 0) {
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float4 v = xs[(rh * NN + n) * 32 + lane];
          x[n][0] += v.x;
          x[n][1] += v.y;
          x[n][2] += v.z;
          x[n][3] += v.w;
        }
        const bool full = tile_full<kRows, kKeys>(a, q0, k0, doc_last);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1;
            float s = score(a, x[n][i], inv_cap);
            if (!full && !visible(a, row_a + 8 * h, qlog[h], qdoc[h],
                                  k0 + 8 * n + 2 * t + (i & 1)))
              s = kNegInf;
            x[n][i] = s;
            mx[h] = fmaxf(mx[h], s);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          if (t == 0) red_m[16 * rh + g + 8 * h] = mx[h];
        }
      }
      bar_sync(1 + rh, 64);

      // Both warps: the new maxima, shifts and alphas.
      float shift[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], red_m[16 * rh + g + 8 * h]);
        // A row that has seen no key keeps shift 0 (its alpha is 0).
        shift[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
        alpha[h] = m[h] <= kNegInf / 2 ? 0.f : expf(m[h] - shift[h]);
        m[h] = m_new;
      }
      if (half == 0) {        // P (a masked score's exp is 0) and row sums
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[n][i] = expf(x[n][i] - shift[i >> 1]);
            rs[i >> 1] += x[n][i];
          }
          xp[(rh * NN + n) * 32 + lane] =
              make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
          if (t == 0) red_l[16 * rh + g + 8 * h] = rs[h];
        }
      }
      bar_sync(1 + rh, 64);

      // l = l * alpha + the row sums; O[rows, cols] = O * alpha + P.V: k
      // step j reads key rows 8j + 2t (logical t) and + 1 (t + 4); the
      // stage's sum is added in fp32.
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * alpha[h] + red_l[16 * rh + g + 8 * h];
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[c][i] *= alpha[i >> 1];
      FragA pa[NN];
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const float4 v = xp[(rh * NN + j) * 32 + lane];
        pa[j] = split_a(v.x, v.z, v.y, v.w);
      }
      tile_product<NB, S, NN>(o, pa, sV + 2 * t * S + (D / 2) * half + g);

      kt = kn;
      kn = kn < nk ? next_k_tile<kRows, kKeys>(a, q0, doc_first, kn, nk)
                   : nk;
    }
  }
  cp_async_wait<0>();

  float* op = a.out + static_cast<size_t>(b) * a.lq * D + (D / 2) * half;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= a.lq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int c = 0; c < NB; ++c)
      *reinterpret_cast<float2*>(op + static_cast<size_t>(row) * D + 8 * c +
                                 2 * t) =
          make_float2(o[c][2 * h] / l_safe, o[c][2 * h + 1] / l_safe);
    if (half == 0 && t == 0) {
      const float shift = m[h] <= kNegInf / 2 ? 0.f : m[h];
      a.lse[static_cast<size_t>(b) * a.lq + row] =
          l[h] == 0.f ? kNegInf : shift + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch(const FwdArgs32& a, cudaStream_t stream) {
  constexpr size_t smem = Wide<D>::kBytes;
  auto kernel = flash_fwd_tf32x3w_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // The q tile on the slow axis: blocks start tile by tile.
  const dim3 grid(a.bh, (a.lq + kRows - 1) / kRows);
  kernel<<<grid, kBlockW, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of every forward source (is_bf16 must be 0, d one of 192,
// 256, 288, 384, and q, k, v and out 16-byte aligned).  Returns the
// cudaError_t of the launch (0 = launched).
int flash_fwd_tf32x3w(const void* q, const void* k, const void* v, void* out,
                      void* lse, const void* doc, int is_bf16, int bh,
                      int bhkv, int lq, int lk, int d, int q_off_lo,
                      int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
                      int q_seg, int k_seg, int causal, int window,
                      float softcap, float scale, int packed, int doc_skip,
                      int doc_rows, void* stream) {
  FwdArgs32 a;
  if ((d != 192 && d != 256 && d != 288 && d != 384) ||
      !make_fwd_args(a, q, k, v, out, lse, doc, is_bf16, bh, bhkv, lq, lk,
                     q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg,
                     k_seg, causal, window, softcap, scale, packed, doc_skip,
                     doc_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 192: err = launch<192>(a, st); break;
    case 256: err = launch<256>(a, st); break;
    case 288: err = launch<288>(a, st); break;
    default: err = launch<384>(a, st); break;
  }
  return static_cast<int>(err);
}

const char* flash_fwd_tf32x3w_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
