// Flash-attention forward for Hopper's tensor cores (sm_90a) at head dims
// 16 and 32, written by hand in CUDA C++: the ``sm90n`` route's bf16
// forward.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (:145), the
// Pallas TPU kernel launched by ``_fwd`` (:252), for bf16 operands at the
// padded head dims 16 and 32 (the reduced configs, and any model with heads
// that narrow).  fp32 takes csrc/flash_fwd_tf32x3.cu.  Same
// function, folded layout and C arguments as csrc/flash_fwd_sm90.cu: q
// (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) bf16; GQA: q row b reads KV row b /
// group; out (B*Hq, Lq, D) bf16 and lse (B*Hq, Lq) fp32 in natural log; a
// row that sees no key gets out = 0 and lse = -1e30.  The mask (kv_valid,
// causal, window, packed documents from the five band ints, q_seg / k_seg
// and the doc table, doc_skip on or off), the softcap, the scale and the
// whole-tile skip are launch arguments, as in every other route.
//
// What bounds it on an H100.  Compute: two products of 2*Lq*Lk*D FLOPs a
// head, halved under causal, at 989 TFLOP/s (qwen3-1.7b's shape at D = 32,
// B=2, L=4096, Hq=16, Hkv=8 causal: 34.4 GFLOP, 0.0348 ms).  At D <= 32 the
// work done for each score weighs more: one exp2 a score on the
// special-function unit, 16 a clock an SM (268 M scores at that shape: about
// 0.064 ms at 1,980 MHz, above the tensor bound), and a few fp32
// instructions (the max, the shift, the sum, the bf16 packing; on edge tiles
// the mask).  The bytes are far below both.
//
// Design (csrc/flash_fwd_sm90.cu's, with csrc/flash_bwd_sm90_narrow.cu's
// staging and per-score path).
//   Products.  A block owns 64 q rows of one head: one warpgroup (128
//   threads) issues bf16 ``wgmma.mma_async`` with fp32 accumulation.
//   S = Q.K^T takes Q from registers (loaded once from global memory as the
//   A fragments: D/16 = 1 or 2 k steps, 4 or 8 registers a thread) and K
//   from shared memory, K-major.  P, rounded to bf16, is the A fragment of
//   O += P.V straight from the S accumulator registers, and V is read
//   MN-major over N = D = 16 or 32 (``wgmma_rs_mn``): O is 8 or 16 floats a
//   thread.
//   Per-score work (sm90_common.cuh's ``softmax_tile_ex2``, which the D 384
//   forward shares).  In fp32 on the S fragment, in
//   log2 units: a running max m and sum l per row.  Without the softcap the
//   max is taken on the raw scores and scale * log2(e) folds into the one
//   FFMA from raw score to exponent before ``ex2.approx`` (a negative scale,
//   which reverses the order, is applied first); under the softcap
//   tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) by ``ex2.approx`` and
//   ``rcp.approx``, and softcap * log2(e) folds into the FFMA the same way.
//   The softcap and the mask are template arguments of the score loop,
//   chosen once a tile (a uniform branch), so a full tile without a softcap
//   costs a max, an FFMA, an ex2 and an add a score and a pack a pair.  O is
//   rescaled by 2^(m_old - m_new) in registers before each P.V.
//   Numerics.  P is rounded to bf16 before P.V, as on the sm90 route; the
//   sums stay fp32.
//   Staging (csrc/sm90_narrow.cuh).  A staged row is the row itself, D * 2
//   bytes, written by TMA with the 64-byte swizzle at D 32 and the 32-byte
//   one at D 16, read by wgmma descriptors of layout type 2 / 3.  The K and
//   V tiles come through a ring of kStages = 2 stages on mbarriers, the
//   next tile requested as soon as a stage is free; 3-D tensor maps
//   zero-fill rows past Lk, Q rows past Lq load as zeros.
//   Occupancy.  16 KB of shared memory a block at D 32: registers set the
//   blocks an SM (kMinBlocks = 5, at most 102 registers a thread), so one
//   block's exp2 runs while another's products do.  The grid puts the q
//   tile on its slow axis, the last (heaviest under causal) first.
//   Masks.  ``tile_runs`` skips a K tile the band cannot reach; ``tile_full``
//   selects the score loop without the per-element test.
//   Where the time goes (scripts/ab_narrow_sm90.py --fwd, PERF.md section
//   6; qwen3-1.7b's shape at D 32, back to back).  Not in the exp2 (0.92x
//   without it) but, as in the sm90n backward, in each step's serial chain
//   of products, waits and barriers, which more blocks an SM hide: four
//   blocks took 1.07x (three 1.00x of four), six (80 registers, 184 bytes
//   spilled) 1.08x.  Tried and not kept: 128-key steps at three blocks an SM
//   (0.94x of four blocks, 1.01x of five; 1.02x with three stages), three
//   or four stages (1.00x), and every second exp2 as a polynomial on the
//   FMA pipe (1.25x: the FMA pipe is the busier one).
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_fwd_sm90n_kernel<16>  95, 0      flash_fwd_sm90n_kernel<32>  95, 0

#include "sm90_narrow.cuh"

namespace {

constexpr int kKeys = 64;        // keys a step
constexpr int kStages = 2;       // K/V stages of the ring
constexpr int kMinBlocks = 5;    // blocks an SM the registers allow

// Shared-memory layout (byte offsets from a 1024-byte aligned base):
// kStages stages of a K and a V tile, then one mbarrier a stage.
template <int D>
struct FwdNarrowSmem {
  static constexpr int kTileBytes = ntile_bytes<D, kKeys>();
  static constexpr int kStage = 2 * kTileBytes;      // K, then V
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = kBars + kStages * 8 + 1024;   // + slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_sm90n_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const FwdArgs a) {
  using L = FwdNarrowSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sKV = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
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
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // log2 units

  // The block's key steps, in order (block-uniform): kt is this
  // iteration's, far the one kStages - 1 further (nk past the end).
  int kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      ntma_pair<D, kKeys>(sKV, &tm_k, &tm_v, &bars[0], kt * kKeys, bkv);
    int far = kt;
#pragma unroll
    for (int s = 1; s < kStages; ++s) {
      far = far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                     : nk;
      if (tid == 0 && far < nk)
        ntma_pair<D, kKeys>(sKV + s * L::kStage, &tm_k, &tm_v, &bars[s],
                            far * kKeys, bkv);
    }
    // Q as the A fragments of S = Q.K^T, straight from global memory: k
    // step kk holds columns 16kk + 2(lane%4) (+1) and 16kk + 8 + 2(lane%4)
    // (+1) of rows row_a and row_a + 8; rows past Lq are zero.
    uint32_t qa[D / 16][4];
    int qlog[2], qdoc[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      const bool in = row < a.lq;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
          a.q + (static_cast<size_t>(b) * a.lq + (in ? row : 0)) * D);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][half] = in ? qrow[8 * kk + (lane & 3)] : 0u;
        qa[kk][2 + half] = in ? qrow[8 * kk + 4 + (lane & 3)] : 0u;
      }
      qlog[half] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      qdoc[half] = (a.packed && in) ? docp[row] : kDocAbsent;
    }

    for (int it = 0; kt < nk; ++it) {
      const int s = it % kStages;
      const int k0 = kt * kKeys;
      const uint32_t sK = sKV + L::kStage * s;
      const uint32_t sV = sK + L::kTileBytes;
      const int nfar =
          far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                   : nk;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // S = Q.K^T (A = Q from registers, B = K K-major): rows are q rows,
      // columns keys.
      float sc[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_n64_kmajor(sc, qa[kk], ndesc_k<D>(sK, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      float alpha[2];
      uint32_t pa[kKeys / 16][4];
      softmax_tile_ex2<kKeys / 8>(a, f, sc, pa, m, l, alpha,
                                  tile_full<kTile, kKeys>(a, q0, k0, doc_last),
                                  row_a, qlog, qdoc, k0, lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          o[4 * j + 2 * half] *= alpha[half];
          o[4 * j + 2 * half + 1] *= alpha[half];
        }
      }

      // O += P.V (B MN-major: K = the step's keys, N = D).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_mn<D>(o, pa[kk], ndesc_mn<D, kKeys>(sV, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      __syncthreads();               // stage s is free
      if (tid == 0 && nfar < nk)
        ntma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);
      far = nfar;
      kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);
    }
  }

  // out = O / l and lse = ln(2) * (m + log2 l) per row; l == 0 (no key
  // seen) gives out = 0 and lse = -1e30.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const float inv = l[half] > 0.f ? 1.f / l[half] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * half] *= inv;
      o[4 * j + 2 * half + 1] *= inv;
    }
    const int row = row_a + 8 * half;
    if ((lane & 3) == 0 && row < a.lq)
      a.lse[static_cast<size_t>(b) * a.lq + row] =
          l[half] > 0.f ? (m[half] + log2f(l[half])) * kLn2 : kNegInf;
  }
  store_rows<D>(a.out + static_cast<size_t>(b) * a.lq * D, o, row_a, a.lq,
                lane);
}

template <int D>
int launch(const FwdArgs& a, const CUtensorMap (&m)[2], cudaStream_t stream) {
  constexpr int smem = FwdNarrowSmem<D>::kBytes;
  auto kernel = flash_fwd_sm90n_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The q tile on the slow axis: blocks start tile by tile.
  const dim3 grid(a.bh, (a.lq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_fwd_sm90.cu's ``flash_fwd_sm90``
// (is_bf16 must be 1 and d 16 or 32).  Returns 0 when launched, else a
// cudaError_t or one of sm90_common.cuh's codes
// (flash_fwd_sm90n_error_string names them).
int flash_fwd_sm90n(const void* q, const void* k, const void* v, void* out,
                    void* lse, const void* doc, int is_bf16, int bh, int bhkv,
                    int lq, int lk, int d, int q_off_lo, int q_off_hi,
                    int k_off_lo, int k_off_hi, int kv_valid, int q_seg,
                    int k_seg, int causal, int window, float softcap,
                    float scale, int packed, int doc_skip, int doc_rows,
                    void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (!is_bf16 || (d != 16 && d != 32) || !aligned || bh <= 0 ||
      bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  // Boxes a whole row wide, swizzled over its d * 2 bytes (row_bytes).
  const int cols = d;
  const CUtensorMapSwizzle swizzle =
      d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  int err = make_map(&maps[0], k, bhkv, lk, d, kKeys, cols, swizzle);
  if (err == 0) err = make_map(&maps[1], v, bhkv, lk, d, kKeys, cols, swizzle);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 32 ? launch<32>(a, maps, st) : launch<16>(a, maps, st);
}

const char* flash_fwd_sm90n_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
