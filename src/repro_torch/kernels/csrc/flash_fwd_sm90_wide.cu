// Flash-attention forward for Hopper's tensor cores (sm_90a) above head dim
// 128, written by hand in CUDA C++: the ``sm90w`` route.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (:145), the
// Pallas TPU kernel launched by ``_fwd`` (:252), for bf16 operands at the
// padded head dims 192 (deepseek-v2-lite MLA), 256 (gemma3-12b's 240) and
// 288 (gemma2-2b).  fp32 operands take csrc/flash_fwd_tf32x3_wide.cu, and
// D = 384 csrc/flash_fwd_sm90_d384.cu.  Same function, folded layout and
// arguments as csrc/flash_fwd_sm90.cu: q (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) bf16, GQA
// row b / group; out bf16 and lse fp32 in natural log; a row that sees no
// key gets out = 0 and lse = -1e30; the mask (kv_valid, causal, window,
// packed documents from the five band ints, q_seg / k_seg and the doc
// table), the softcap, the scale and the whole-tile skip are launch
// arguments.
//
// What bounds it on an H100.  Compute: two products of 2*Lq*Lk*D FLOPs a
// head, halved under causal, at 989 TFLOP/s of bf16 tensor-core throughput
// (gemma2-2b's B=2, L=4096, Hq=8, D=288 causal: 154.7 GFLOP, 0.156 ms).
// The bytes are far below that.  Each score carries 4*D tensor FLOPs (1,152
// at D = 288, against 512 at D = 128) beside its special-function work
// (the softcap's tanh and the ex2), so the softmax weighs less than in the
// D = 128 kernel, and the products set the pace.
//
// Design.
//   Registers.  A 64 x D fp32 O is D/2 registers a thread (144 at 288), so
//   Q cannot stay in registers as in the D = 128 kernel: S = Q.K^T reads
//   both Q and K from shared memory (K-major descriptors), and K's depth
//   runs D/16 k steps (18 at 288: the zero columns of the last chunk are
//   never read).  O += P.V takes P from registers (the S accumulator
//   rounded to bf16) and V MN-major, in parts of at most 256 columns along
//   the 64-column chunks (``OutParts``: 256 + 32 at D = 288; an N = 32
//   part reads half of each 128-byte swizzled row, which the card takes).
//   Shared memory.  A 64 x 288 tile takes five 64-column chunks (40 KB);
//   K and V stages hold 48 keys (30 KB each), so a block holds two Q tiles
//   and two K/V stages: 200 KB, one block an SM.
//   Warpgroups.  A block owns kWarpgroups * 64 q rows of one head; each
//   warpgroup (128 threads) owns 64 with its own Q tile, and all share the
//   K/V ring, so each stage's bytes feed twice the products, and one
//   warpgroup's softmax can run beside the other's products (one block
//   fits an SM, so this is the only overlap there is).  A stage is free
//   when every warpgroup has finished its products on it: each counts
//   itself in with an atomic add in shared memory, and the last to arrive
//   refills the stage by TMA, so no warpgroup waits for another except on
//   data.  The key tiles are those the band reaches from the block's rows;
//   a warpgroup whose own rows see none of a tile only counts itself in.
//   Softmax (``softmax_tile``, as at D = 128): fp32 on the S fragment in
//   log2 units with ``ex2.approx``; the softcap's tanh and the per-element
//   mask only where they apply (``tile_runs``, ``tile_full``).
//   Numerics.  P is rounded to bf16 before P.V; every sum stays fp32.
//   Staging.  TMA (cp.async.bulk.tensor) with the 128-byte swizzle, 3-D
//   tensor maps (D, rows, heads) whose boxes are 64 columns by 64 (Q) or
//   48 (K, V) rows; rows past L and columns past D load as zeros.  A wait
//   that never completes traps after about 4 s of clock.
//   Tried and not kept (patches in scripts/ab_wide_sm90.py, PERF.md
//   section 6; times against the kept kernel's in one call): one
//   warpgroup a block (1.55x), 32-key stages, three of them (1.26x), the q
//   tile on the grid's fast axis (1.23x), the warpgroups issuing their
//   products in turns as dq's do (1.09x), a last output part of a whole
//   chunk (1.10x).
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_fwd_sm90w_kernel<192>  190, 0
//   flash_fwd_sm90w_kernel<256>  229, 0
//   flash_fwd_sm90w_kernel<288>  251, 0

#include "sm90_common.cuh"

namespace {

constexpr int kWarpgroups = 2;   // 64-row q tiles a block
constexpr int kStages = 2;       // K/V stages of the ring
constexpr int kKeys = 48;        // keys a stage

template <int D>
struct FwdWideSmem {
  static constexpr int kQBytes = tile_bytes<D>();           // one q tile
  static constexpr int kKvBytes = tile_bytes<D, kKeys>();   // K or V
  static constexpr int kRing = kWarpgroups * kQBytes;       // stage 0
  static constexpr int kStage = 2 * kKvBytes;
  static constexpr int kBars = kRing + kStages * kStage;    // + Q's
  static constexpr int kCounts = kBars + (kStages + 1) * 8;
  static constexpr int kBytes = kCounts + kStages * 4 + 1024;   // + slack
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

template <int D>
__global__ void __launch_bounds__(kThreads * kWarpgroups, 1)
flash_fwd_sm90w_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const FwdArgs a) {
  using L = FwdWideSmem<D>;
  using P = OutParts<D>;
  constexpr int kRows = kTile * kWarpgroups;   // q rows a block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  unsigned* counts = reinterpret_cast<unsigned*>(smem + L::kCounts);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads, t = tid % kThreads;
  const int warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x;
  const int qb = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int q0 = qb + kTile * wg;                         // this warpgroup's
  const bool active = q0 < a.lq;                          // warpgroup-uniform
  const int bkv = b / a.group;
  const int nk = (a.lk + kKeys - 1) / kKeys;
  const int row_a = q0 + 16 * warp + (lane >> 2);   // accumulator rows
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_block = a.packed ? docp[qb] : 0;
  const int doc_first = a.packed ? docp[min(q0, a.lq - 1)] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0;
  const uint32_t sQ = base + wg * L::kQBytes;
  float o[P::kAcc];
#pragma unroll
  for (int i = 0; i < P::kAcc; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // log2 units

  // The block's key tiles, in order (block-uniform): kt is this
  // iteration's, far the one kStages - 1 further (nk past the end).
  int kt = next_k_tile<kRows, kKeys>(a, qb, doc_block, -1, nk);
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
#pragma unroll
      for (int i = 0; i < kStages; ++i) counts[i] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {               // every Q tile, then the first stage
      mbar_expect_tx(&bars[kStages], kWarpgroups * L::kQBytes);
#pragma unroll
      for (int w = 0; w < kWarpgroups; ++w)
        tma_tile<D>(base + w * L::kQBytes, &tm_q, &bars[kStages],
                    qb + kTile * w, b);
      tma_pair<D, kKeys>(base + L::kRing, &tm_k, &tm_v, &bars[0],
                         kt * kKeys, bkv);
    }
    int far = kt;
#pragma unroll
    for (int s = 1; s < kStages; ++s) {
      far = far < nk ? next_k_tile<kRows, kKeys>(a, qb, doc_block, far, nk)
                     : nk;
      if (tid == 0 && far < nk)
        tma_pair<D, kKeys>(base + L::kRing + s * L::kStage, &tm_k, &tm_v,
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
      const uint32_t sK = base + L::kRing + L::kStage * s;
      const uint32_t sV = sK + L::kKvBytes;
      mbar_wait(&bars[s], (it / kStages) & 1);
      const bool runs =        // warpgroup-uniform
          active && tile_runs<kTile, kKeys>(a, q0, k0, doc_first);
      if (runs) {
        // S = Q.K^T (both K-major from shared memory): rows are q rows,
        // columns keys.
        float sc[kKeys / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kKeys>(sc, desc_k(sQ, kk), desc_k(sK, kk, kKeys * 128), kk);
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);
        uint32_t pa[kKeys / 16][4];
        float alpha[2];
        softmax_tile<kKeys / 8>(a, sc, pa, m, l, alpha,
                                tile_full<kTile, kKeys>(a, q0, k0, doc_last),
                                row_a, qlog, qdoc, k0, lane);
#pragma unroll
        for (int j = 0; j < P::kAcc / 4; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            o[4 * j + 2 * half] *= alpha[half];
            o[4 * j + 2 * half + 1] *= alpha[half];
          }
        }
        // O += P.V (V MN-major: K = the stage's keys).
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_rs_parts<D, kKeys>(o, pa[kk], sV, kk);
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
      }
      // Stage s is free once every warpgroup is done with it; the last to
      // count itself in refills it with the tile kStages further on.
      const int nfar =
          far < nk ? next_k_tile<kRows, kKeys>(a, qb, doc_block, far, nk)
                   : nk;
      warpgroup_sync(wg);
      if (t == 0) {
        __threadfence_block();
        const unsigned done = atomicAdd(&counts[s], 1u);
        if (done % kWarpgroups == kWarpgroups - 1 && nfar < nk)
          tma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);
      }
      far = nfar;
      kt = next_k_tile<kRows, kKeys>(a, qb, doc_block, kt, nk);
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
  store_rows<D, P::kAcc>(a.out + static_cast<size_t>(b) * a.lq * D, o, row_a,
                         a.lq, lane);
}

template <int D>
int launch(const FwdArgs& a, const CUtensorMap (&m)[3], cudaStream_t stream) {
  constexpr int smem = FwdWideSmem<D>::kBytes;
  auto kernel = flash_fwd_sm90w_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kTile * kWarpgroups;
  const dim3 grid(a.bh, (a.lq + rows - 1) / rows);
  kernel<<<grid, kThreads * kWarpgroups, smem, stream>>>(m[0], m[1], m[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The arguments of every forward source (is_bf16 must be 1 and d 192, 256
// or 288).  Returns 0 when launched, else a cudaError_t
// or one of sm90_common.cuh's codes (flash_fwd_sm90w_error_string names
// them).
int flash_fwd_sm90w(const void* q, const void* k, const void* v, void* out,
                    void* lse, const void* doc, int is_bf16, int bh, int bhkv,
                    int lq, int lk, int d, int q_off_lo, int q_off_hi,
                    int k_off_lo, int k_off_hi, int kv_valid, int q_seg,
                    int k_seg, int causal, int window, float softcap,
                    float scale, int packed, int doc_skip, int doc_rows,
                    void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (!is_bf16 || (d != 192 && d != 256 && d != 288) || !aligned ||
      bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 192) return launch<192>(a, maps, st);
  if (d == 256) return launch<256>(a, maps, st);
  return launch<288>(a, maps, st);
}

const char* flash_fwd_sm90w_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
