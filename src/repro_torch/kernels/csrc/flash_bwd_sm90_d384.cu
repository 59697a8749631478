// Flash-attention dq and dk/dv for Hopper's tensor cores (sm_90a) at head
// dim 384, written by hand in CUDA C++: the ``sm90w`` route's backward at
// the padded D 384 (every head dim from 289 to 384;
// csrc/flash_dq_sm90_wide.cu and csrc/flash_dkv_sm90_wide.cu serve 192,
// 256 and 288).
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289) and
// ::_dkv_kernel (:331), the Pallas TPU kernels launched in ``_bwd`` (:421,
// :464), for bf16 operands at D = 384.  fp32 takes the 3xTF32 kernels of
// csrc/flash_bwd_tf32x3_wide.cu.  Same function, folded layout and C
// arguments as
// csrc/flash_bwd_sm90.cu: q, do (B*Hq, Lq, 384), k/v (B*Hkv, Lk, 384)
// bf16; lse and dsum = rowsum(dO * O) (B*Hq, Lq) fp32; GQA row b / group.
// P = exp(s - lse) on visible keys (a row whose lse is -1e30 uses shift 0
// and sees no key); dS = P * (dO.V^T - dsum), times (1 - (s_c/cap)^2) under
// a softcap, times the scale; dq = dS.K, dk = the group's sum of dS^T.Q,
// dv = the sum of P^T.dO.  The mask (the five band ints, q_seg / k_seg,
// kv_valid, causal, window, the doc table with doc_skip), the softcap, the
// scale and the whole-tile skip are launch arguments, as in every route.
//
// What bounds it on an H100.  Compute: dq three products of 2*Lq*Lk*D
// FLOPs a head (S, dP, dS.K), dk/dv four (S^T, dP^T, P^T.dO, dS^T.Q),
// halved under causal, at 989 TFLOP/s (head dim 320 at gemma2-2b's shape,
// B=2, L=4096, Hq=8, Hkv=4 causal: dq 257.8 GFLOP, 0.2606 ms; dk/dv 343.7
// GFLOP, 0.3475 ms; padded to 384 the kernels do 1.2x that work, and dk/dv
// 1.5x of it again, below).  The bytes are far below that.
//
// Why not the D 288 designs.  A 64 x 384 fp32 accumulator is 192 registers
// a thread: the D 288 dq keeps a whole dQ partial in each of two
// warpgroups (144 registers at 288, 244 in all), and the D 288 dk/dv one
// whole dV in one warpgroup and dK in the other (228 in all).  And a
// 64-row tile is 48 KB: stages of 48 rows no longer fit beside two fixed
// 64-row tiles (96 KB + 2 x 72 KB > 227 KB).
//
// Design.  Both kernels keep two 64-row tiles fixed in shared memory and
// stream the other two through kStages = 2 TMA stages of 32 rows (48 KB a
// stage), with an 8 KB exchange: 205,856 bytes with the barriers and the
// slack, one block an SM.  Each warpgroup owns kCols = 192 output columns,
// 96 floats a thread, in one N = 192 ``wgmma`` (B MN-major, three
// 64-column chunks); the first products contract over all 384 columns (24
// k steps, both operands K-major from shared memory).
//   dq.  A block owns 64 q rows of one head (Q and dO fixed) and walks the
//   32-key K/V tiles the band reaches; warpgroup w owns dQ[:, 192w :
//   192w + 192].  Warpgroup 0 computes S = Q.K^T and warpgroup 1 dP =
//   dO.V^T at the same time.  Warpgroup 0 turns S into P times the
//   softcap's factor (1 - t^2), masked, and hands it over in the exchange
//   (thread t of one warpgroup to thread t of the other: both accumulators
//   have the same fragment layout); warpgroup 1 forms dS = PF * (dP -
//   dsum) * scale, rounds it to bf16 and hands the packed A fragments back
//   through the same slots.  Then each warpgroup issues dQ[:, its columns]
//   += dS.K[:, its columns] with dS from registers.  1x the function's
//   tensor work; two named barriers a step order the exchange ("P
//   written", 5, and "dS written", 6: barrier 0 is __syncthreads', 1-2
//   ``warpgroup_sync``'s), each with one arrival and one wait a step, and
//   a thread only ever reads back the slots it wrote before the other
//   warpgroup's barrier let it.  No final sum: each warpgroup writes its
//   own columns, so the result is deterministic.
//   dk/dv.  A block owns 64 keys of one KV head (K and V fixed) and one
//   half of the output columns, and walks all group * nq q steps of 32
//   rows through the Q/dO stages: csrc/flash_dkv_sm90_wide.cu's design at
//   an output width of 192.  Warpgroup 0 computes S^T = K.Q^T and owns
//   dV[:, half], warpgroup 1 dP^T = V.dO^T and dK[:, half]; warpgroup 0
//   hands P times the softcap's factor over in the exchange (barriers 5,
//   "written", and 6, "read").  Both halves compute S^T and dP^T in full,
//   so the tensor work is 1.5x the function's.  The half is the grid's
//   fast axis, so the two blocks of a key tile run together and share
//   their Q/dO reads in L2.  The GQA sum stays in registers: no atomics,
//   deterministic.
//   Stage release.  Each warpgroup counts itself in with an atomic add in
//   shared memory after its last product on a stage; the second refills it
//   by TMA with the step kStages further on.
//   Special functions.  P = 2^(s log2 e - shift) by ex2.approx, and under
//   the softcap tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) by ex2.approx and
//   rcp.approx, as csrc/flash_dkv_sm90_wide.cu takes them.
//   Numerics.  P and dS are rounded to bf16 before the second products, as
//   in every sm90 backward; the sums stay fp32.
//   Staging, masks.  TMA with the 128-byte swizzle (64 columns by 64 or 32
//   rows a box), zero rows past L; ``tile_runs`` skips a tile the band
//   cannot reach, ``tile_full`` selects the loop without the per-element
//   test.  dq's grid puts the q tile on its slow axis, the last (heaviest
//   under causal) first; dk/dv's the key tile, the first first.
//   Measured (PERF.md section 6; head dim 320 at gemma2-2b's shape, back to
//   back, NVIDIA H100 80GB HBM3 at 700 W): dq 1.44-1.46 ms with softcap 50,
//   1.23-1.25 without; dk/dv 3.79-3.85 and 3.24-3.29 (SDPA's backward
//   15.9-16.0 ms).  dk/dv runs at the D 288 kernel's rate per product
//   issued; its 1.5x recomputation and the 1.2x padding set its time.
//   Tried and not kept (patches in scripts/ab_wide_sm90.py --d384-bwd;
//   times against the kept kernels' in one call, with / without the
//   softcap): dq with each warpgroup computing S and dP and forming dS
//   itself, no exchange (1.15x / 1.23x: unlike the D 384 forward, where
//   recomputing S beat an exchange, here it duplicates two of three
//   products); dk/dv with the column half on the grid's slow axis (1.00x /
//   1.00x).  Three stages of 24 rows cannot be built: the second products'
//   depth runs in k steps of 16.  Diagnostics, wrong by design: without
//   the tanh and exp2 dq takes 0.79x / 0.92x and dk/dv 0.80x / 0.94x; with
//   the first products over half of the columns 0.88x / 0.85x and 0.88x /
//   0.89x; without the staged loads 0.89x / 0.86x and 0.94x / 0.91x.  No
//   one part sets the pace: each step's chain of products, exchange and
//   special functions does.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes
//   flash_dq_sm90w_kernel<384>   166, 0
//   flash_dkv_sm90w_kernel<384>  165, 0

#include "sm90_common.cuh"

namespace {

constexpr int kCols = 192;       // output columns a warpgroup owns
constexpr int kStages = 2;       // stages of the ring
constexpr int kKeys = 32;        // dq: keys a K/V stage
constexpr int kQRows = 32;       // dk/dv: q rows a Q/dO stage
constexpr int kWritten = 5;      // named barrier: P is in the exchange
constexpr int kBack = 6;         // named barrier: dq's dS is in it, or
                                 // dk/dv's P has been read

// Shared memory of both kernels at D: two fixed 64-row tiles, kStages
// stages of two R-row tiles, the exchange, the barriers and the stages'
// counts.
template <int D, int R>
struct Layout {
  static constexpr int kFixed = tile_bytes<D>();       // Q/dO or K/V
  static constexpr int kRow = tile_bytes<D, R>();      // a staged tile
  static constexpr int kRing = 2 * kFixed;             // stage 0
  static constexpr int kStage = 2 * kRow;
  static constexpr int kX = kRing + kStages * kStage;  // the exchange
  static constexpr int kXBytes = R / 2 * kThreads * 4;
  static constexpr int kBars = kX + kXBytes;           // + the fixed pair's
  static constexpr int kCounts = kBars + (kStages + 1) * 8;
  static constexpr int kBytes = kCounts + kStages * 4 + 1024;  // + slack
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

// Warpgroup ``arrive``s on named barrier ``id``; the other warpgroup
// ``wait``s there (256 threads in all).
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(2 * kThreads)
               : "memory");
}
__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(2 * kThreads)
               : "memory");
}

// The fixed pair's barrier (kStages) and the stages' (0 .. kStages - 1),
// and the stages' counts, initialised by thread 0 before the block's
// barrier.
__device__ __forceinline__ void init_ring(uint64_t* bars, unsigned* counts) {
#pragma unroll
  for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
#pragma unroll
  for (int i = 0; i < kStages; ++i) counts[i] = 0;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Stage s is free once both warpgroups are done with it: each counts
// itself in (thread t == 0 of each, after ``warpgroup_sync``), and the
// second returns true, so that it refills the stage.
__device__ __forceinline__ bool release(unsigned* counts, int s) {
  __threadfence_block();
  return atomicAdd(&counts[s], 1u) % 2 == 1;
}

// Stores a 64-row fp32 accumulator of kCols columns (the layout of one
// N = kCols product) as bf16 into columns col0 .. col0 + kCols - 1 of rows
// row_a and row_a + 8 of a (rows, D) matrix, skipping rows at or past
// ``rows``.
template <int D>
__device__ __forceinline__ void store_cols(__nv_bfloat16* out,
                                           const float (&acc)[kCols / 2],
                                           int row_a, int rows, int col0,
                                           int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= rows) continue;
    __nv_bfloat16* dst =
        out + static_cast<size_t>(row) * D + col0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// P of one raw score s in log2 units, shifted by ``shift`` (the row's lse
// times log2 e), and the softcap's factor f = 1 - t^2 (1 without one);
// ``lin`` = scale log2 e, ``tin`` = 2 log2 e scale / cap, ``outer`` =
// cap log2 e.
__device__ __forceinline__ float p_of(const BwdArgs& a, float s, float shift,
                                      float lin, float tin, float outer,
                                      float& f) {
  if (a.softcap != 0.f) {
    const float th = 1.f - __fdividef(2.f, ex2(s * tin) + 1.f);
    f = 1.f - th * th;
    return ex2(outer * th - shift);
  }
  f = 1.f;
  return ex2(fmaf(s, lin, -shift));
}

template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
flash_dq_sm90w_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const BwdArgs a) {
  using L = Layout<D, kKeys>;
  static_assert(D == 2 * kCols, "two warpgroups of kCols columns");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sDO = sQ + L::kFixed;
  float4* xch = reinterpret_cast<float4*>(smem + L::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  unsigned* counts = reinterpret_cast<unsigned*>(smem + L::kCounts);

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
  const float lin = a.scale * kLog2e;
  const float tin = 2.f * kLog2e * a.scale / a.softcap;
  const float outer = a.softcap * kLog2e;

  float dq[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dq[i] = 0.f;

  // The block's key tiles, in order (block-uniform): kt is this step's,
  // far the one kStages - 1 further (nk past the end).
  int kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {
    if (tid == 0) init_ring(bars, counts);
    __syncthreads();
    if (tid == 0) {               // Q, dO; the first stage
      tma_pair<D>(sQ, &tm_q, &tm_do, &bars[kStages], q0, b);
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
    float shift_l2[2], dsum[2];
    int qlog[2], qdoc[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      const bool in = row < a.lq;
      const float lse = in ? a.lse[static_cast<size_t>(b) * a.lq + row]
                           : kNegInf;
      shift_l2[half] = (lse <= kNegInf / 2 ? 0.f : lse) * kLog2e;
      dsum[half] = in ? a.dsum[static_cast<size_t>(b) * a.lq + row] : 0.f;
      qlog[half] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      qdoc[half] = (a.packed && in) ? docp[row] : kDocAbsent;
    }
    mbar_wait(&bars[kStages], 0);

    for (int it = 0; kt < nk; ++it) {
      const int s = it % kStages;
      const int k0 = kt * kKeys;
      const uint32_t sK = sQ + L::kRing + L::kStage * s;
      const uint32_t sV = sK + L::kRow;
      const int nfar =
          far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                   : nk;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // S = Q.K^T (warpgroup 0) or dP = dO.V^T (1), both K-major: rows q
      // rows, columns keys (i = 4j + 2*half + h: row row_a + 8*half, key
      // k0 + 8j + 2(lane%4) + h; float4 j of the exchange is block j).
      float x[kKeys / 2];
      uint32_t frag[kKeys / 16][4];       // dS, bf16 pairs
      const uint32_t sA = wg == 0 ? sQ : sDO, sB = wg == 0 ? sK : sV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kKeys>(x, desc_k(sA, kk), desc_k(sB, kk, kKeys * 128), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(x);
      if (wg == 0) {
        // P times the softcap's factor, masked, to warpgroup 1; its dS
        // back.
        const bool full = tile_full<kTile, kKeys>(a, q0, k0, doc_last);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * half + h;
              float f;
              float p = p_of(a, x[i], shift_l2[half], lin, tin, outer, f);
              if (!full && !visible(a, row_a + 8 * half, qlog[half],
                                    qdoc[half], k0 + 8 * j + 2 * (lane & 3) + h))
                p = 0.f;
              x[i] = p * f;
            }
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
          xch[j * kThreads + t] =
              make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        bar_arrive(kWritten);
        bar_wait(kBack);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint4 u = reinterpret_cast<const uint4*>(xch)[kk * kThreads + t];
          frag[kk][0] = u.x;
          frag[kk][1] = u.y;
          frag[kk][2] = u.z;
          frag[kk][3] = u.w;
        }
      } else {
        // dS = PF * (dP - dsum) * scale, to warpgroup 0 as bf16 pairs in
        // the slots this thread has just read.
        bar_wait(kWritten);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float4 pf = xch[j * kThreads + t];
          x[4 * j] = pf.x * (x[4 * j] - dsum[0]) * a.scale;
          x[4 * j + 1] = pf.y * (x[4 * j + 1] - dsum[0]) * a.scale;
          x[4 * j + 2] = pf.z * (x[4 * j + 2] - dsum[1]) * a.scale;
          x[4 * j + 3] = pf.w * (x[4 * j + 3] - dsum[1]) * a.scale;
        }
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            frag[j >> 1][(j & 1) * 2 + half] =
                pack_bf16(x[4 * j + 2 * half], x[4 * j + 2 * half + 1]);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          reinterpret_cast<uint4*>(xch)[kk * kThreads + t] =
              make_uint4(frag[kk][0], frag[kk][1], frag[kk][2], frag[kk][3]);
        bar_arrive(kBack);
      }

      // dQ[:, cols] += dS.K[:, cols] (K MN-major: K = the stage's keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_parts<kCols, kKeys>(
            dq, frag[kk], sK + wg * (kCols / 64) * kKeys * 128, kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      warpgroup_sync(wg);
      if (t == 0 && release(counts, s) && nfar < nk)
        tma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);
      far = nfar;
      kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);
    }
  }
  store_cols<D>(a.dq + static_cast<size_t>(b) * a.lq * D, dq, row_a, a.lq,
                kCols * wg, lane);
}

template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
flash_dkv_sm90w_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const BwdArgs a) {
  using L = Layout<D, kQRows>;
  static_assert(D == 2 * kCols, "two blocks of kCols columns a key tile");
  constexpr int kN = kQRows / 2;          // accumulator floats of S^T, dP^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kFixed;
  float4* xch = reinterpret_cast<float4*>(smem + L::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  unsigned* counts = reinterpret_cast<unsigned*>(smem + L::kCounts);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads, t = tid % kThreads;
  const int warp = t >> 5, lane = t & 31;
  const int part = blockIdx.x;            // output columns kCols * part
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.z * kTile;
  const int nq = (a.lq + kQRows - 1) / kQRows;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * warp + (lane >> 2);   // accumulator rows
  const float lin = a.scale * kLog2e;
  const float tin = 2.f * kLog2e * a.scale / a.softcap;
  const float outer = a.softcap * kLog2e;

  float acc[kCols / 2];                   // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;

  // The block's q steps, in order (block-uniform): g is step it's, far
  // step it + kStages - 1's (steps past the end).
  int g = next_q_step<kQRows>(a, k0, bkv, -1, nq);
  if (g < steps) {
    if (tid == 0) init_ring(bars, counts);
    __syncthreads();
    if (tid == 0) {               // K, V; the first stage
      tma_pair<D>(sK, &tm_k, &tm_v, &bars[kStages], k0, bkv);
      tma_pair<D, kQRows>(sK + L::kRing, &tm_q, &tm_do, &bars[0],
                          (g % nq) * kQRows, bkv * a.group + g / nq);
    }
    int far = g;
#pragma unroll
    for (int s = 1; s < kStages; ++s) {
      far = far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;
      if (tid == 0 && far < steps)
        tma_pair<D, kQRows>(sK + L::kRing + s * L::kStage, &tm_q, &tm_do,
                            &bars[s], (far % nq) * kQRows,
                            bkv * a.group + far / nq);
    }
    mbar_wait(&bars[kStages], 0);
    if (wg == 1) bar_arrive(kBack);       // the exchange starts free

    for (int it = 0; g < steps; ++it) {
      const int s = it % kStages;
      const int b = bkv * a.group + g / nq;
      const int q0 = (g % nq) * kQRows;
      const uint32_t sQ = sK + L::kRing + L::kStage * s;
      const uint32_t sDO = sQ + L::kRow;
      const float* stat = (wg == 0 ? a.lse : a.dsum) +
                          static_cast<size_t>(b) * a.lq + q0;
      const int nfar =
          far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // This thread's accumulator columns are q rows q0 + 8j + 2(lane%4)
      // (+1); i = 4j + 2*half + h indexes the fragment (rows: keys key_a
      // (+8)), and float4 i of the exchange is block j.
      float x[kN];                        // S^T (0) or dP^T (1)
      float rs[kN / 2];                   // column 2j + h's shift or dsum
      // S^T = K.Q^T (0) or dP^T = V.dO^T (1), both K-major: rows keys,
      // columns q rows.
      const uint32_t sA = wg == 0 ? sK : sV, sB = wg == 0 ? sQ : sDO;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kQRows>(x, desc_k(sA, kk), desc_k(sB, kk, kQRows * 128), kk);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + 2 * (lane & 3) + h;
          const float v = q0 + c < a.lq ? stat[c] : (wg == 0 ? kNegInf : 0.f);
          // Warpgroup 0: the shift in log2 units (0 for a row that sees
          // no key); warpgroup 1: dsum.
          rs[2 * j + h] = wg == 1 ? v : (v <= kNegInf / 2 ? 0.f : v) * kLog2e;
        }
      wgmma_wait_all();
      pin(x);

      uint32_t frag[kQRows / 16][4];      // P^T (0) or dS^T (1), bf16 pairs
      if (wg == 0) {
        // P^T, masked, into frag; P^T times the softcap's factor into x.
        const int* docp =
            a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq
                     : nullptr;
        const bool full = tile_full<kQRows, kTile>(
            a, q0, k0, a.packed ? docp[min(q0 + kQRows, a.lq) - 1] : 0);
#pragma unroll
        for (int j = 0; j < kQRows / 8; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float p2[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * half + h;
              float f;
              float p = p_of(a, x[i], rs[2 * j + h], lin, tin, outer, f);
              if (!full) {
                const int row = q0 + 8 * j + 2 * (lane & 3) + h;
                const int qlog =
                    logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
                const int qdoc =
                    (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
                if (!visible(a, row, qlog, qdoc, key_a + 8 * half)) p = 0.f;
              }
              p2[h] = p;
              x[i] = p * f;
            }
            frag[j >> 1][(j & 1) * 2 + half] = pack_bf16(p2[0], p2[1]);
          }
        }
        bar_wait(kBack);
#pragma unroll
        for (int i = 0; i < kN / 4; ++i)
          xch[i * kThreads + t] =
              make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        bar_arrive(kWritten);
      } else {
        // dS^T = PF * (dP^T - dsum) * scale into frag.
        bar_wait(kWritten);
#pragma unroll
        for (int i = 0; i < kN / 4; ++i) {
          const float4 pf = xch[i * kThreads + t];
          x[4 * i] = pf.x * (x[4 * i] - rs[2 * i]) * a.scale;
          x[4 * i + 1] = pf.y * (x[4 * i + 1] - rs[2 * i + 1]) * a.scale;
          x[4 * i + 2] = pf.z * (x[4 * i + 2] - rs[2 * i]) * a.scale;
          x[4 * i + 3] = pf.w * (x[4 * i + 3] - rs[2 * i + 1]) * a.scale;
        }
        bar_arrive(kBack);
#pragma unroll
        for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            frag[j >> 1][(j & 1) * 2 + half] =
                pack_bf16(x[4 * j + 2 * half], x[4 * j + 2 * half + 1]);
      }

      // dV[:, cols] += P^T.dO[:, cols] (0) or dK[:, cols] += dS^T.Q[:, cols]
      // (1), B MN-major: K = the q rows.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs_parts<kCols, kQRows>(
            acc, frag[kk],
            (wg == 0 ? sDO : sQ) + part * (kCols / 64) * kQRows * 128, kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      warpgroup_sync(wg);
      if (t == 0 && release(counts, s) && nfar < steps)
        tma_pair<D, kQRows>(sQ, &tm_q, &tm_do, &bars[s],
                            (nfar % nq) * kQRows, bkv * a.group + nfar / nq);
      far = nfar;
      g = next_q_step<kQRows>(a, k0, bkv, g, nq);
    }
    if (wg == 0) bar_wait(kBack);         // the last "read": both idle
  }
  store_cols<D>((wg == 0 ? a.dv : a.dk) + static_cast<size_t>(bkv) * a.lk * D,
                acc, key_a, a.lk, kCols * part, lane);
}

template <class Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const CUtensorMap (&m)[4],
           const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 2 * kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the C entries' arguments and fills ``a`` and the tensor maps of
// q, do (boxes of ``q_rows`` rows) and k, v (``kv_rows``); 0 or an error
// code.
int prepare(BwdArgs& a, CUtensorMap (&maps)[4], const void* q, const void* k,
            const void* v, const void* dout, const void* lse,
            const void* dsum, const void* doc, int is_bf16, int bh, int bhkv,
            int lq, int lk, int d, int q_off_lo, int q_off_hi, int k_off_lo,
            int k_off_hi, int kv_valid, int q_seg, int k_seg, int causal,
            int window, float softcap, float scale, int packed, int doc_skip,
            int doc_rows, int q_rows, int kv_rows) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  if (!is_bf16 || d != 384 || !aligned || bh <= 0 || bhkv <= 0 ||
      bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = make_map(&maps[0], q, bh, lq, d, q_rows);
  if (err == 0) err = make_map(&maps[1], dout, bh, lq, d, q_rows);
  if (err == 0) err = make_map(&maps[2], k, bhkv, lk, d, kv_rows);
  if (err == 0) err = make_map(&maps[3], v, bhkv, lk, d, kv_rows);
  if (err != 0) return err;
  a = BwdArgs{};
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
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
  return 0;
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd_sm90.cu's ``flash_bwd_dq_sm90`` and
// ``flash_bwd_dkv_sm90`` (is_bf16 must be 1 and d 384).  Each returns 0
// when launched, else a cudaError_t or one of sm90_common.cuh's codes
// (flash_bwd_sm90w384_error_string names them).
int flash_bwd_dq_sm90w384(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* dsum, void* dq, const void* doc,
                          int is_bf16, int bh, int bhkv, int lq, int lk,
                          int d, int q_off_lo, int q_off_hi, int k_off_lo,
                          int k_off_hi, int kv_valid, int q_seg, int k_seg,
                          int causal, int window, float softcap, float scale,
                          int packed, int doc_skip, int doc_rows,
                          void* stream) {
  BwdArgs a;
  CUtensorMap maps[4];
  const int err = prepare(a, maps, q, k, v, dout, lse, dsum, doc, is_bf16,
                          bh, bhkv, lq, lk, d, q_off_lo, q_off_hi, k_off_lo,
                          k_off_hi, kv_valid, q_seg, k_seg, causal, window,
                          softcap, scale, packed, doc_skip, doc_rows, kTile,
                          kKeys);
  if (err != 0) return err;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  // The q tile on the slow axis: blocks start tile by tile.
  return launch(flash_dq_sm90w_kernel<384>, Layout<384, kKeys>::kBytes,
                dim3(bh, (lq + kTile - 1) / kTile), maps, a,
                static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkv_sm90w384(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* dsum, void* dk, void* dv,
                           const void* doc, int is_bf16, int bh, int bhkv,
                           int lq, int lk, int d, int q_off_lo, int q_off_hi,
                           int k_off_lo, int k_off_hi, int kv_valid,
                           int q_seg, int k_seg, int causal, int window,
                           float softcap, float scale, int packed,
                           int doc_skip, int doc_rows, void* stream) {
  BwdArgs a;
  CUtensorMap maps[4];
  const int err = prepare(a, maps, q, k, v, dout, lse, dsum, doc, is_bf16,
                          bh, bhkv, lq, lk, d, q_off_lo, q_off_hi, k_off_lo,
                          k_off_hi, kv_valid, q_seg, k_seg, causal, window,
                          softcap, scale, packed, doc_skip, doc_rows, kQRows,
                          kTile);
  if (err != 0) return err;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  // The column half on the fast axis, the key tile on the slow one.
  return launch(flash_dkv_sm90w_kernel<384>, Layout<384, kQRows>::kBytes,
                dim3(2, bhkv, (lk + kTile - 1) / kTile), maps, a,
                static_cast<cudaStream_t>(stream));
}

const char* flash_bwd_sm90w384_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
