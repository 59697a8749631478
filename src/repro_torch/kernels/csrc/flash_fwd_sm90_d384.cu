// Flash-attention forward for Hopper's tensor cores (sm_90a) at head dim
// 384, written by hand in CUDA C++: the ``sm90w`` route's bf16 forward at
// the padded D 384 (every head dim from 289 to 384;
// csrc/flash_fwd_sm90_wide.cu serves 192, 256 and 288).
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (:145), the
// Pallas TPU kernel launched by ``_fwd`` (:252), for bf16 operands at
// D = 384.  fp32 takes csrc/flash_fwd_tf32x3_wide.cu.  Same
// function, folded layout and C arguments as csrc/flash_fwd_sm90.cu: q
// (B*Hq, Lq, 384), k/v (B*Hkv, Lk, 384) bf16, GQA row b / group; out bf16
// and lse fp32 in natural log; a row that sees no key gets out = 0 and
// lse = -1e30; the mask (kv_valid, causal, window, packed documents from
// the five band ints, q_seg / k_seg and the doc table), the softcap, the
// scale and the whole-tile skip are launch arguments.
//
// What bounds it on an H100.  Compute: two products of 2*Lq*Lk*D FLOPs a
// head, halved under causal, at 989 TFLOP/s (head dim 320 at gemma2-2b's
// shape, B=2, L=4096, Hq=8, Hkv=4 causal: 171.8 GFLOP, 0.1738 ms; padded to
// 384 the kernel does 1.2x that work, and 1.5x of it again in S, below).
// The bytes from device memory are far below that.  Each 64-row block
// reads its K/V tiles again from L2: about 3.3 GB a call at that shape,
// 4.6 TB/s at the kernel's 0.72 ms (PERF.md section 6); whether that sets
// the pace is not measured (no profiler of the memory system runs here).
//
// Design.
//   Why not csrc/flash_fwd_sm90_wide.cu.  There each warpgroup owns 64 q
//   rows and a whole 64 x D fp32 O: 192 registers a thread at D 384 before
//   S, P and addresses (the D 288 instantiation already takes 251).
//   Columns, not rows.  A block owns 64 q rows of one head and two
//   warpgroups (256 threads); warpgroup w owns O[:, 192w : 192w + 192], 96
//   floats a thread, in one N = 192 ``wgmma`` (V MN-major, three 64-column
//   chunks).  Each warpgroup computes the whole S = Q.K^T itself (24 k
//   steps, Q and K both K-major from shared memory), runs the same online
//   softmax on it, holds the same m, l and P as the other, and applies P.V
//   to its own columns: 1.5x the function's tensor work, and no exchange.
//   Softmax (sm90_common.cuh's ``softmax_tile_ex2``): fp32 on the S
//   fragment in log2 units with ``ex2.approx``; the softcap's tanh by
//   ``ex2.approx`` and ``rcp.approx``; softcap and mask chosen once a tile.
//   Numerics.  P is rounded to bf16 before P.V; every sum stays fp32.
//   Shared memory.  Q 64 x 384 (48 KB) and K and V stages of 48 keys (36 KB
//   each, two stages: 144 KB): 193 KB, one block an SM.  TMA
//   (cp.async.bulk.tensor) with the 128-byte swizzle, 3-D tensor maps (D,
//   rows, heads) whose boxes are 64 columns by 64 (Q) or 48 (K, V) rows;
//   rows past L load as zeros.  A stage is refilled when both warpgroups
//   are past the block barrier that ends the step.  A wait that never
//   completes traps after about 4 s of clock.
//   Masks.  ``tile_runs`` skips a key tile the band cannot reach from the
//   block's rows; ``tile_full`` selects the score loop without the
//   per-element test.  The grid puts the q tile on its slow axis, the last
//   (heaviest under causal) first.
//   Tried and not kept (patches in scripts/ab_wide_sm90.py --d384, PERF.md
//   section 6; head dim 320 at gemma2-2b's shape, back to back, without /
//   with the softcap): the split contraction, each warpgroup computing S
//   over its own 192 columns with the two partials summed through shared
//   memory behind a block barrier (1.09x / 1.13x: the barrier and the
//   exchange cost more than the third of the tensor work they save); a
//   stage released by an atomic count instead of the block barrier
//   (1.00x / 1.01x); three 32-key stages (1.23x); three warpgroups of 128
//   columns with the split contraction (1.48x); one warpgroup holding all
//   of O, 244 registers (1.20x).
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes
//   flash_fwd_sm90w_kernel<384>  163, 0

#include "sm90_common.cuh"

namespace {

constexpr int kWarpgroups = 2;   // each owns 192 of O's columns
constexpr int kStages = 2;       // K/V stages of the ring
constexpr int kKeys = 48;        // keys a stage

template <int D>
struct D384Smem {
  static constexpr int kQBytes = tile_bytes<D>();           // the q tile
  static constexpr int kKvBytes = tile_bytes<D, kKeys>();   // K or V
  static constexpr int kRing = kQBytes;                     // stage 0
  static constexpr int kStage = 2 * kKvBytes;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kBytes = kBars + (kStages + 1) * 8 + 1024;  // + slack
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

template <int D>
__global__ void __launch_bounds__(kThreads * kWarpgroups, 1)
flash_fwd_sm90w_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const FwdArgs a) {
  using L = D384Smem<D>;
  constexpr int kCols = D / kWarpgroups;       // O columns a warpgroup
  static_assert(kCols % 64 == 0 && OutParts<kCols>::kAcc == kCols / 2,
                "a warpgroup owns whole 64-column chunks");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads, t = tid % kThreads;
  const int warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + kKeys - 1) / kKeys;
  const int row_a = q0 + 16 * warp + (lane >> 2);   // accumulator rows
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0;
  const ScoreFactors f = score_factors(a);
  float o[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // log2 units

  // The block's key tiles, in order (block-uniform): kt is this
  // iteration's, far the one kStages - 1 further (nk past the end).
  int kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {               // the q tile, then the first stage
      mbar_expect_tx(&bars[kStages], L::kQBytes);
      tma_tile<D>(sQ, &tm_q, &bars[kStages], q0, b);
      tma_pair<D, kKeys>(sQ + L::kRing, &tm_k, &tm_v, &bars[0], kt * kKeys,
                         bkv);
    }
    int far = kt;
#pragma unroll
    for (int s = 1; s < kStages; ++s) {
      far = far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                     : nk;
      if (tid == 0 && far < nk)
        tma_pair<D, kKeys>(sQ + L::kRing + s * L::kStage, &tm_k, &tm_v,
                           &bars[s], far * kKeys, bkv);
    }
    int qlog[2], qdoc[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      qlog[half] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      qdoc[half] = (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
    }
    mbar_wait(&bars[kStages], 0);

    for (int it = 0; kt < nk; ++it) {
      const int s = it % kStages;
      const int k0 = kt * kKeys;
      const uint32_t sK = sQ + L::kRing + L::kStage * s;
      const uint32_t sV = sK + L::kKvBytes;
      const int nfar =
          far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                   : nk;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // S = Q.K^T (both K-major from shared memory): rows are q rows,
      // columns keys; each warpgroup computes all of it.
      float sc[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kKeys>(sc, desc_k(sQ, kk), desc_k(sK, kk, kKeys * 128), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      float alpha[2];
      uint32_t pa[kKeys / 16][4];
      softmax_tile_ex2<kKeys / 8>(a, f, sc, pa, m, l, alpha,
                                  tile_full<kTile, kKeys>(a, q0, k0, doc_last),
                                  row_a, qlog, qdoc, k0, lane);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          o[4 * j + 2 * half] *= alpha[half];
          o[4 * j + 2 * half + 1] *= alpha[half];
        }
      }
      // O[:, cols] += P.V[:, cols] (V MN-major: K = the stage's keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_parts<kCols, kKeys>(
            o, pa[kk], sV + wg * (kCols / 64) * kKeys * 128, kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      __syncthreads();               // stage s is free
      if (tid == 0 && nfar < nk)
        tma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);
      far = nfar;
      kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);
    }
  }

  // out = O / l and lse = ln(2) * (m + log2 l) per row (both warpgroups
  // hold the same l; warpgroup 0 writes lse); l == 0 (no key seen) gives
  // out = 0 and lse = -1e30.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const float inv = l[half] > 0.f ? 1.f / l[half] : 0.f;
    const int row = row_a + 8 * half;
    if (wg == 0 && (lane & 3) == 0 && row < a.lq)
      a.lse[static_cast<size_t>(b) * a.lq + row] =
          l[half] > 0.f ? (m[half] + log2f(l[half])) * kLn2 : kNegInf;
    if (row >= a.lq) continue;
    __nv_bfloat16* dst = a.out + (static_cast<size_t>(b) * a.lq + row) * D +
                         kCols * wg + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
  }
}

template <int D>
int launch(const FwdArgs& a, const CUtensorMap (&m)[3], cudaStream_t stream) {
  constexpr int smem = D384Smem<D>::kBytes;
  auto kernel = flash_fwd_sm90w_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The q tile on the slow axis: blocks start tile by tile.
  const dim3 grid(a.bh, (a.lq + kTile - 1) / kTile);
  kernel<<<grid, kThreads * kWarpgroups, smem, stream>>>(m[0], m[1], m[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_fwd_sm90.cu's ``flash_fwd_sm90``
// (is_bf16 must be 1 and d 384).  Returns 0 when launched, else a
// cudaError_t or one of sm90_common.cuh's codes
// (flash_fwd_sm90w384_error_string names them).
int flash_fwd_sm90w384(const void* q, const void* k, const void* v,
                       void* out, void* lse, const void* doc, int is_bf16,
                       int bh, int bhkv, int lq, int lk, int d, int q_off_lo,
                       int q_off_hi, int k_off_lo, int k_off_hi,
                       int kv_valid, int q_seg, int k_seg, int causal,
                       int window, float softcap, float scale, int packed,
                       int doc_skip, int doc_rows, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (!is_bf16 || d != 384 || !aligned || bh <= 0 || bhkv <= 0 ||
      bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  int err = make_map(&maps[0], q, bh, lq, d);
  if (err == 0) err = make_map(&maps[1], k, bhkv, lk, d, kKeys);
  if (err == 0) err = make_map(&maps[2], v, bhkv, lk, d, kKeys);
  if (err != 0) return err;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
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
  return launch<384>(a, maps, static_cast<cudaStream_t>(stream));
}

const char* flash_fwd_sm90w384_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
