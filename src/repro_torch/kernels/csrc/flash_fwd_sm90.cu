// Flash-attention forward for Hopper's tensor cores (sm_90a), written by
// hand in CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (:145), the
// Pallas TPU kernel launched by ``_fwd``, for bf16 operands at D = 64 and
// 128.  fp32 operands take csrc/flash_fwd_tf32x3.cu, and bf16 at a head
// dim below 64 csrc/flash_fwd_sm90_narrow.cu.  Same function and folded
// layout as those:
// q (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) bf16; GQA: q row b reads KV row
// b / group.  out (B*Hq, Lq, D) bf16 and lse (B*Hq, Lq) fp32 in natural
// log.  A row that sees no key gets out = 0 and lse = -1e30.  The mask
// (kv_valid, causal, window, packed documents from the five band ints,
// q_seg / k_seg and the doc table), the softcap, the scale and the
// whole-tile skip (``_run_predicate``, doc_skip) are plain launch
// arguments, so a new ring offset needs no rebuild.
//
// What bounds it on an H100.  Compute: two products of 2*Lq*Lk*D FLOPs a
// head (S = Q.K^T, O = P.V), halved under causal, against 989 TFLOP/s of
// bf16 tensor-core throughput (at B=2, L=4096, Hq=16, D=128 causal: 137.5
// GFLOP, 0.139 ms).  The bytes (q, k, v read once, out and lse written
// once) are far below that.  Beside the products, every score costs an
// exp2 on the special-function unit (16 a clock an SM against 4096
// tensor-core FLOPs: 512 FLOPs a score at D = 128), so the softmax's own
// instructions must stay few and overlap the products.
//
// Design (the dq kernel of csrc/flash_bwd_sm90.cu with its second and
// third products replaced by an online softmax and O += P.V).
//   Products.  A block owns 64 q rows of one head: one warpgroup (128
//   threads) issues bf16 ``wgmma.mma_async`` with fp32 accumulation.
//   S = Q.K^T takes Q from registers (loaded once from global memory as
//   the A fragments) and K from shared memory, K-major.  P, rounded to
//   bf16, is the A fragment of O += P.V straight from the S accumulator
//   registers, and V is read MN-major (wgmma's transpose bit), so no
//   shared memory holds Q, S or P.  Registers a thread at D = 128: O 64,
//   Q 32, S 32, P 16.
//   Softmax (``softmax_tile``).  In fp32 on the S fragment, in log2 units:
//   a running max m and sum l per row; the scale and log2(e) multiply the
//   raw maximum and fold into one FFMA per score before ``ex2.approx``;
//   the softcap's tanh and the per-element mask run only when they apply
//   (a softcap; a tile an edge of the mask crosses), so a full tile costs
//   a max, an FFMA, an ex2 and an add per score.  The rescale of O by
//   2^(m_old - m_new) happens in registers before each P.V.  l sums the
//   fp32 P, one partial per thread, reduced over the row's four lanes only
//   at the end.
//   Staging.  The K and V tiles come through a ring of two stages, filled
//   by TMA (cp.async.bulk.tensor) with the 128-byte swizzle that wgmma's
//   descriptors read, completing on mbarriers; the next-but-one tile is
//   requested as soon as a stage is free.  3-D tensor maps (D, rows,
//   heads) zero-fill rows past Lk, so L is not padded; Q rows past Lq load
//   as zeros.  A wait that never completes traps after about 4 s of clock.
//   Occupancy.  64 KB of tiles at D = 128 (65.6 KB with the barriers and
//   the alignment slack) and at most 168 registers a thread: three blocks
//   an SM, whose warpgroups take turns on the tensor cores while the
//   others run their softmax.  The grid puts the q tile on its slow axis,
//   the last (heaviest under causal) first.
//   Masks.  A K tile the band cannot reach is skipped (``tile_runs``); a
//   tile wholly inside the band (``tile_full``) skips the per-element
//   test; only tiles an edge crosses apply ``visible`` on the fragment.
//   Tried and not kept (PERF.md section 6): 128-row blocks of two
//   warpgroups sharing each stage, fed by a producer warp (their products
//   and softmaxes fell into step, and it was slower); issuing the next
//   tile's S before this tile's softmax (ptxas serialized it until S and P
//   got registers of their own, and then it was still slower); a third
//   stage and Q in shared memory (no gain, and it costs the third block).
// The mask predicates, mbarriers, TMA, descriptors, wgmma wrappers and the
// tensor-map encoder are csrc/sm90_common.cuh's, shared with the backward.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_fwd_sm90_kernel<64>  147, 0      flash_fwd_sm90_kernel<128> 168, 0

#include "sm90_common.cuh"

namespace {

// Shared-memory layout (byte offsets from a 1024-byte aligned base): two
// stages of K and V, then one mbarrier a stage.
template <int D>
struct FwdSmem {
  static constexpr int kTileBytes = tile_bytes<D>();
  static constexpr int kStage = 2 * kTileBytes;   // stage s at kStage*s
  static constexpr int kBars = 2 * kStage;
  static constexpr int kBytes = kBars + 2 * 8 + 1024;   // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const FwdArgs a) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sKV = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heaviest first
  const int bkv = b / a.group;
  const int nk = (a.lk + kTile - 1) / kTile;
  const int row_a = q0 + 16 * warp + (lane >> 2);   // accumulator rows
  const int* docp =
      a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq : nullptr;
  const int doc_first = a.packed ? docp[q0] : 0;
  const int doc_last = a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // log2 units

  int kt = next_k_tile(a, q0, doc_first, -1, nk);   // block-uniform
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int kn = next_k_tile(a, q0, doc_first, kt, nk);
    if (tid == 0) {               // K and V of tiles kt, kn
      tma_pair<D>(sKV, &tm_k, &tm_v, &bars[0], kt * kTile, bkv);
      if (kn < nk)
        tma_pair<D>(sKV + L::kStage, &tm_k, &tm_v, &bars[1], kn * kTile,
                    bkv);
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
      const int s = it & 1;
      const int k0 = kt * kTile;
      const uint32_t sK = sKV + L::kStage * s;
      const uint32_t sV = sK + L::kTileBytes;
      mbar_wait(&bars[s], (it >> 1) & 1);

      // S = Q.K^T (A = Q from registers, B = K K-major): rows are q rows,
      // columns keys.
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_n64_kmajor(sc, qa[kk], desc_k(sK, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      float alpha[2];
      uint32_t pa[4][4];
      softmax_tile<8>(a, sc, pa, m, l, alpha,
                      tile_full(a, q0, k0, doc_last), row_a, qlog, qdoc, k0,
                      lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          o[4 * j + 2 * half] *= alpha[half];
          o[4 * j + 2 * half + 1] *= alpha[half];
        }
      }

      // O += P.V (B MN-major: K = the 64 keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[kk], desc_mn(sV, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      __syncthreads();               // stage s is free
      const int ka = kn < nk ? next_k_tile(a, q0, doc_first, kn, nk) : nk;
      if (tid == 0 && ka < nk)
        tma_pair<D>(sK, &tm_k, &tm_v, &bars[s], ka * kTile, bkv);
      kt = kn;
      kn = ka;
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
  constexpr int smem = FwdSmem<D>::kBytes;
  auto kernel = flash_fwd_sm90_kernel<D>;
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

// The arguments of every forward source (is_bf16 must be 1 and d 64 or
// 128).  Returns 0 when launched, else a cudaError_t or one
// of sm90_common.cuh's codes (flash_fwd_sm90_error_string names them).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* doc, int is_bf16, int bh, int bhkv,
                   int lq, int lk, int d, int q_off_lo, int q_off_hi,
                   int k_off_lo, int k_off_hi, int kv_valid, int q_seg,
                   int k_seg, int causal, int window, float softcap,
                   float scale, int packed, int doc_skip, int doc_rows,
                   void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (!is_bf16 || (d != 64 && d != 128) || !aligned || bh <= 0 ||
      bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  int err = make_map(&maps[0], k, bhkv, lk, d);
  if (err == 0) err = make_map(&maps[1], v, bhkv, lk, d);
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
  return d == 128 ? launch<128>(a, maps, st) : launch<64>(a, maps, st);
}

const char* flash_fwd_sm90_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
