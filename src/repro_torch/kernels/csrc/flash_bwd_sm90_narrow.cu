// Flash-attention backward for Hopper's tensor cores (sm_90a) at head dims
// 16 and 32, written by hand in CUDA C++: the ``sm90n`` route's bf16 dq
// and dk/dv kernels.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289) and
// ::_dkv_kernel (:331), the Pallas TPU kernels launched by ``_bwd`` (:421,
// :464), for bf16 operands at the padded head dims 16 and 32 (the reduced
// configs, and any model with heads that narrow).  fp32 never reaches it:
// it keeps the 3xTF32 kernels of csrc/flash_bwd_tf32x3.cu.  Same function,
// folded layout and C arguments as csrc/flash_bwd_sm90.cu: q, do (B*Hq, Lq,
// D), k/v (B*Hkv, Lk, D) bf16; lse and dsum = rowsum(dO * O) (B*Hq, Lq)
// fp32; GQA: q row b reads KV row b / group.  P = exp(s - lse) on visible
// keys (a row whose lse is -1e30 uses shift 0 and sees no key); dS = P *
// (dO.V^T - dsum), times (1 - (s_c/cap)^2) under a softcap, times the
// scale; dq = dS.K, dk = dS^T.Q, dv = P^T.dO, dk and dv summed over the
// group inside the block (no atomics).  The mask (kv_valid, causal, window,
// packed documents from the five band ints, q_seg / k_seg and the doc
// table, doc_skip on or off) and the whole-tile skip are launch arguments,
// as in every other route.
//
// What bounds it on an H100.  Compute: dq is three products of 2*L*L*D
// FLOPs a head, dk/dv four, halved under causal, at 989 TFLOP/s (qwen3-1.7b's
// training shape at D = 32, B=2, L=4096, Hq=16, Hkv=8 causal: 51.6 and 68.7
// GFLOP, 0.0521 and 0.0695 ms).  At D <= 32 the work done for each score is
// as large: each kernel takes one exp2 a score on the special-function
// unit, 16 a clock an SM (about 0.07 ms at that shape), and a few fp32
// instructions (the scale and shift, dP - dsum, the products with P, the
// bf16 packing; on edge tiles the mask).  The bytes are far below both.
//
// Design (from csrc/flash_bwd_sm90.cu's, redone for the narrow width).
// Where the time goes (scripts/ab_narrow_sm90.py, PERF.md section 6): not
// in the exp2 (0.91-0.96x without it) nor in waiting on loads (0.89-0.94x
// without them) but in each step's serial chain of products, waits and
// block barriers, four warpgroups an SM, all the registers allow.
//   Products.  One warpgroup a block issues every product as a bf16
//   ``wgmma.mma_async`` with fp32 accumulation.  dk/dv: a block owns 64 keys
//   of one KV head and walks all group * nq q steps of its query heads;
//   S^T = K.Q^T and dP^T = V.dO^T take D/16 = 1 or 2 k steps (A = K/V, B =
//   Q/dO, both K-major), then dV += P^T.dO and dK += dS^T.Q with A from
//   registers and B MN-major over N = D = 16 or 32 (``wgmma_rs_mn``): dK and
//   dV are 8 or 16 floats a thread each.  dq: a block owns 64 q rows and
//   walks the key steps: S = Q.K^T, dP = dO.V^T, dQ += dS.K.  A step is
//   kQRows = 64 q rows (dk/dv) or kKeys = 64 keys (dq); 128-row steps at
//   two blocks an SM are no faster.  Each step waits for its products
//   before the next step's: overlapping them (one wait for step it's
//   second products and step it + 1's first) took 1.09x (dq) and 1.4-2x
//   (dk/dv, which then spills).
//   Per-score work.  P = 2^(s * scale * log2(e) - shift) by ``ex2.approx``;
//   under the softcap tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) by ``ex2.approx``
//   and ``rcp.approx`` (as csrc/flash_dkv_sm90_wide.cu); the scale, the
//   softcap's factors and dsum * scale are taken once, so the common path is
//   an FFMA, an ex2, an FFMA and an FMUL a score and a pack a pair.  The
//   softcap and the mask are template arguments of the score loop, chosen
//   once a tile (a uniform branch), so a full tile without a softcap runs
//   no test.  dk/dv's per-column shift and dsum * scale are loaded at the
//   start of each step (a step ahead took 1.08x: two more live registers)
//   and written to shared memory as float2 pairs that a thread reads as one
//   float4 per two columns.
//   Numerics.  P and dS are rounded to bf16 before the second products, as
//   on the sm90 route; the sums stay fp32.
//   Staging.  A staged row is the row itself, D * 2 bytes, written by TMA
//   with the 64-byte swizzle at D 32 and the 32-byte one at D 16, and the
//   wgmma descriptors take the matching layout type (csrc/sm90_narrow.cuh,
//   shared with the forward; sm90_common.cuh's layout, one 64-column chunk a row with the 128-byte swizzle and zeros
//   past D, gives the same results at 0.99-1.01x the time and twice the
//   shared memory).  The walked tiles (Q/dO, or K/V) come through
//   a ring of kStages = 2 stages on mbarriers, the next tiles requested as
//   soon as a stage is free.  A 3-D tensor map per operand zero-fills rows
//   past L.
//   Occupancy.  24 KB of shared memory a block at D 32: registers set the
//   blocks an SM (kMinBlocks = 4, 128 registers a thread), so
//   one block's exp2 runs while another's products do.  Three blocks took
//   1.14x (dq) and 1.19x (dk/dv); five (96 registers) spill and take
//   1.12x and 1.35x.  The grid puts the tile index on its slow axis,
//   heaviest first under causal.
//   Masks.  ``tile_runs`` skips a tile the band cannot reach; ``tile_full``
//   selects the score loop without the per-element test.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dq_sm90n_kernel<16>   128, 0     flash_dkv_sm90n_kernel<16>  128, 0
//   flash_dq_sm90n_kernel<32>   128, 0     flash_dkv_sm90n_kernel<32>  128, 44

#include "sm90_narrow.cuh"

namespace {

constexpr int kQRows = 64;       // q rows a dk/dv step
constexpr int kKeys = 64;        // keys a dq step
constexpr int kStages = 2;       // stages of the ring
constexpr int kMinBlocks = 4;    // blocks an SM the registers allow

// Shared-memory layout (byte offsets from a 1024-byte aligned base): the two
// fixed 64-row tiles (K, V for dk/dv; Q, dO for dq), kStages stages of two
// R-row tiles, R float2 column stats (dk/dv), the stages' mbarriers and the
// fixed tiles'.
template <int D, int R>
struct NarrowSmem {
  static constexpr int kFixed = ntile_bytes<D>();
  static constexpr int kTileBytes = ntile_bytes<D, R>();
  static constexpr int kRing = 2 * kFixed;                  // stage 0
  static constexpr int kStage = 2 * kTileBytes;
  static constexpr int kStats = kRing + kStages * kStage;
  static constexpr int kBars = kStats + R * 8;
  static constexpr int kBytes = kBars + (kStages + 1) * 8 + 1024;
};

// The factors of a score taken once a launch: P = 2^(s * lin - shift), or
// under the softcap 2^(outer * tanh - shift) with tanh's argument times
// 2 log2(e) being s * tin.
struct Factors {
  float lin, tin, outer, scale;
};

__device__ __forceinline__ Factors factors(const BwdArgs& a) {
  Factors f;
  f.lin = a.scale * kLog2e;
  f.tin = a.softcap != 0.f ? 2.f * kLog2e * a.scale / a.softcap : 0.f;
  f.outer = a.softcap * kLog2e;
  f.scale = a.scale;
  return f;
}

// (p, ds) of one score from the raw product q.k, dO.v, the row's shift
// (log2 units) and its dsum * scale.
template <bool kCap>
__device__ __forceinline__ void p_ds(const Factors& f, float s, float dp,
                                     float shift, float dsc, float& p,
                                     float& ds) {
  if constexpr (kCap) {
    const float th = 1.f - __fdividef(2.f, ex2(s * f.tin) + 1.f);
    p = ex2(fmaf(f.outer, th, -shift));
    ds = p * fmaf(-th, th, 1.f) * fmaf(dp, f.scale, -dsc);
  } else {
    p = ex2(fmaf(s, f.lin, -shift));
    ds = p * fmaf(dp, f.scale, -dsc);
  }
}

// The shift of a row in log2 units: lse * log2(e), 0 for a row that sees
// no key.
__device__ __forceinline__ float shift_l2(float lse) {
  return (lse <= kNegInf / 2 ? 0.f : lse) * kLog2e;
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

// P^T and dS^T of one dk/dv step as the A fragments of the second products
// (k step kk takes accumulator column blocks j = 2kk, 2kk+1), from S^T and
// dP^T (rows: keys key_a, key_a + 8; columns: q rows q0 + 8j + 2(lane%4)
// (+1), whose shift and dsum * scale ``stat`` holds as float2 pairs).
template <bool kCap, bool kMask, int N>
__device__ __forceinline__ void dkv_scores(
    const BwdArgs& a, const Factors& f, const float (&st)[N / 2],
    const float (&dpt)[N / 2], const float4* stat, uint32_t (&pa)[N / 16][4],
    uint32_t (&dsa)[N / 16][4], int q0, int key_a, const int* docp,
    int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float4 c = stat[4 * j + (lane & 3)];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float p2[2], ds2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * half + h;
        p_ds<kCap>(f, st[i], dpt[i], h ? c.z : c.x, h ? c.w : c.y, p2[h],
                   ds2[h]);
        if constexpr (kMask) {
          const int row = q0 + 8 * j + 2 * (lane & 3) + h;
          const int qlog = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
          const int qdoc = (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
          if (!visible(a, row, qlog, qdoc, key_a + 8 * half))
            p2[h] = ds2[h] = 0.f;
        }
      }
      pa[j >> 1][(j & 1) * 2 + half] = pack_bf16(p2[0], p2[1]);
      dsa[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
    }
  }
}

// Column ``tid``'s lse and dsum of q step ``g`` (-1e30 and 0 past the
// rows, the steps or the columns).
__device__ __forceinline__ void load_stats(const BwdArgs& a, int g, int nq,
                                           int bkv, int tid, float& lse,
                                           float& dsum) {
  const int row = (g % nq) * kQRows + tid;
  lse = kNegInf;
  dsum = 0.f;
  if (tid < kQRows && g < a.group * nq && row < a.lq) {
    const size_t i =
        static_cast<size_t>(bkv * a.group + g / nq) * a.lq + row;
    lse = a.lse[i];
    dsum = a.dsum[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_dkv_sm90n_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const BwdArgs a) {
  using L = NarrowSmem<D, kQRows>;
  constexpr int kN = kQRows / 2;          // accumulator floats of S^T, dP^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kFixed;
  const float4* stat = reinterpret_cast<const float4*>(smem + L::kStats);
  float2* stat_w = reinterpret_cast<float2*>(smem + L::kStats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int nq = (a.lq + kQRows - 1) / kQRows;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * warp + (lane >> 2);   // accumulator rows
  const Factors f = factors(a);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // The block's q steps, in order (block-uniform): g is step it's, far
  // step it + kStages - 1's (steps past the end).
  int g = next_q_step<kQRows>(a, k0, bkv, -1, nq);
  if (g < steps) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {               // K, V; the first stage
      ntma_pair<D>(sK, &tm_k, &tm_v, &bars[kStages], k0, bkv);
      ntma_pair<D, kQRows>(sK + L::kRing, &tm_q, &tm_do, &bars[0],
                          (g % nq) * kQRows, bkv * a.group + g / nq);
    }
    int far = g;
#pragma unroll
    for (int s = 1; s < kStages; ++s) {
      far = far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;
      if (tid == 0 && far < steps)
        ntma_pair<D, kQRows>(sK + L::kRing + s * L::kStage, &tm_q, &tm_do,
                            &bars[s], (far % nq) * kQRows,
                            bkv * a.group + far / nq);
    }
    mbar_wait(&bars[kStages], 0);

    for (int it = 0; g < steps; ++it) {
      const int s = it % kStages;
      const int b = bkv * a.group + g / nq;
      const int q0 = (g % nq) * kQRows;
      const uint32_t sQ = sK + L::kRing + L::kStage * s;
      const uint32_t sDO = sQ + L::kTileBytes;
      // Thread tid < kQRows loads column tid's lse and dsum.
      float lse_v, dsum_v;
      load_stats(a, g, nq, bkv, tid, lse_v, dsum_v);
      const int gn = next_q_step<kQRows>(a, k0, bkv, g, nq);
      const int nfar =
          far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns q rows.
      float st[kN], dpt[kN];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kQRows>(st, ndesc_k<D>(sK, kk), ndesc_k<D>(sQ, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kQRows>(dpt, ndesc_k<D>(sV, kk), ndesc_k<D>(sDO, kk), kk);
      wgmma_commit();
      if (tid < kQRows)
        stat_w[tid] = make_float2(shift_l2(lse_v), dsum_v * a.scale);
      __syncthreads();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      const int* docp =
          a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq
                   : nullptr;
      const bool full = tile_full<kQRows, kTile>(
          a, q0, k0, a.packed ? docp[min(q0 + kQRows, a.lq) - 1] : 0);
      uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];
      if (a.softcap != 0.f) {
        if (full)
          dkv_scores<true, false, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,
                                          key_a, docp, lane);
        else
          dkv_scores<true, true, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,
                                         key_a, docp, lane);
      } else {
        if (full)
          dkv_scores<false, false, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,
                                           key_a, docp, lane);
        else
          dkv_scores<false, true, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,
                                          key_a, docp, lane);
      }

      // dV += P^T.dO and dK += dS^T.Q (B MN-major: K = the step's q rows).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs_mn<D>(dv, pa[kk], ndesc_mn<D, kQRows>(sDO, kk));
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs_mn<D>(dk, dsa[kk], ndesc_mn<D, kQRows>(sQ, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      __syncthreads();               // stage s and the stats are free
      if (tid == 0 && nfar < steps)
        ntma_pair<D, kQRows>(sQ, &tm_q, &tm_do, &bars[s],
                            (nfar % nq) * kQRows, bkv * a.group + nfar / nq);
      far = nfar;
      g = gn;
    }
  }
  const size_t base = static_cast<size_t>(bkv) * a.lk * D;
  store_rows<D>(a.dk + base, dk, key_a, a.lk, lane);
  store_rows<D>(a.dv + base, dv, key_a, a.lk, lane);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// dS of one dq step as the A fragments of dS.K, from S and dP (rows: q
// rows row_a, row_a + 8 with their shifts and dsum * scale; columns: keys
// k0 + 8j + 2(lane%4) (+1)).
template <bool kCap, bool kMask, int N>
__device__ __forceinline__ void dq_scores(
    const BwdArgs& a, const Factors& f, const float (&sc)[N / 2],
    const float (&dp)[N / 2], const float (&shift)[2], const float (&dsc)[2],
    uint32_t (&dsa)[N / 16][4], int k0, int row_a, const int (&qlog)[2],
    const int (&qdoc)[2], int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float ds2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * half + h;
        float p;
        p_ds<kCap>(f, sc[i], dp[i], shift[half], dsc[half], p, ds2[h]);
        if constexpr (kMask) {
          if (!visible(a, row_a + 8 * half, qlog[half], qdoc[half],
                       k0 + 8 * j + 2 * (lane & 3) + h))
            ds2[h] = 0.f;
        }
      }
      dsa[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_dq_sm90n_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const BwdArgs a) {
  using L = NarrowSmem<D, kKeys>;
  constexpr int kN = kKeys / 2;           // accumulator floats of S, dP
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sDO = sQ + L::kFixed;
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
  const Factors f = factors(a);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // The block's key steps, in order (block-uniform), as for dk/dv's q steps.
  int kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {               // Q, dO; the first stage
      ntma_pair<D>(sQ, &tm_q, &tm_do, &bars[kStages], q0, b);
      ntma_pair<D, kKeys>(sQ + L::kRing, &tm_k, &tm_v, &bars[0], kt * kKeys,
                         bkv);
    }
    int far = kt;
#pragma unroll
    for (int s = 1; s < kStages; ++s) {
      far = far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                     : nk;
      if (tid == 0 && far < nk)
        ntma_pair<D, kKeys>(sQ + L::kRing + s * L::kStage, &tm_k, &tm_v,
                           &bars[s], far * kKeys, bkv);
    }
    float shift[2], dsc[2];
    int qlog[2], qdoc[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      const bool in = row < a.lq;
      shift[half] = shift_l2(
          in ? a.lse[static_cast<size_t>(b) * a.lq + row] : kNegInf);
      dsc[half] =
          in ? a.dsum[static_cast<size_t>(b) * a.lq + row] * a.scale : 0.f;
      qlog[half] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      qdoc[half] = (a.packed && in) ? docp[row] : kDocAbsent;
    }
    mbar_wait(&bars[kStages], 0);

    for (int it = 0; kt < nk; ++it) {
      const int s = it % kStages;
      const int k0 = kt * kKeys;
      const uint32_t sK = sQ + L::kRing + L::kStage * s;
      const uint32_t sV = sK + L::kTileBytes;
      const int nfar =
          far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                   : nk;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // S = Q.K^T and dP = dO.V^T: rows are q rows, columns keys.
      float sc[kN], dp[kN];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kKeys>(sc, ndesc_k<D>(sQ, kk), ndesc_k<D>(sK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kKeys>(dp, ndesc_k<D>(sDO, kk), ndesc_k<D>(sV, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      const bool full = tile_full<kTile, kKeys>(a, q0, k0, doc_last);
      uint32_t dsa[kKeys / 16][4];
      if (a.softcap != 0.f) {
        if (full)
          dq_scores<true, false, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,
                                        row_a, qlog, qdoc, lane);
        else
          dq_scores<true, true, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,
                                       row_a, qlog, qdoc, lane);
      } else {
        if (full)
          dq_scores<false, false, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,
                                         row_a, qlog, qdoc, lane);
        else
          dq_scores<false, true, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,
                                        row_a, qlog, qdoc, lane);
      }

      // dQ += dS.K (B MN-major: K = the step's keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_mn<D>(dq, dsa[kk], ndesc_mn<D, kKeys>(sK, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      __syncthreads();               // stage s is free
      if (tid == 0 && nfar < nk)
        ntma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);
      far = nfar;
      kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);
    }
  }
  store_rows<D>(a.dq + static_cast<size_t>(b) * a.lq * D, dq, row_a, a.lq,
                lane);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
int launch(int which, const BwdArgs& a, const CUtensorMap (&m)[4], int bhkv,
           cudaStream_t stream) {
  const int smem = which ? NarrowSmem<D, kQRows>::kBytes
                         : NarrowSmem<D, kKeys>::kBytes;
  auto kernel = which ? flash_dkv_sm90n_kernel<D> : flash_dq_sm90n_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The tile index on the slow axis: blocks start tile by tile.
  const dim3 grid = which ? dim3(bhkv, (a.lk + kTile - 1) / kTile)
                          : dim3(a.bh, (a.lq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dsum, void* o0,
        void* o1, const void* doc, int is_bf16, int bh, int bhkv, int lq,
        int lk, int d, int q_off_lo, int q_off_hi, int k_off_lo,
        int k_off_hi, int kv_valid, int q_seg, int k_seg, int causal,
        int window, float softcap, float scale, int packed, int doc_skip,
        int doc_rows, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  if (!is_bf16 || (d != 16 && d != 32) || !aligned || bh <= 0 ||
      bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The walked operands' boxes are a step's rows, the fixed ones 64.
  const int q_rows = which ? kQRows : kTile;
  const int k_rows = which ? kTile : kKeys;
  CUtensorMap maps[4];
  // Boxes a whole row wide, swizzled over its d * 2 bytes (row_bytes).
  const int cols = d;
  const CUtensorMapSwizzle swizzle =
      d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  int err = make_map(&maps[0], q, bh, lq, d, q_rows, cols, swizzle);
  if (err == 0) err = make_map(&maps[1], dout, bh, lq, d, q_rows, cols, swizzle);
  if (err == 0) err = make_map(&maps[2], k, bhkv, lk, d, k_rows, cols, swizzle);
  if (err == 0) err = make_map(&maps[3], v, bhkv, lk, d, k_rows, cols, swizzle);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = static_cast<__nv_bfloat16*>(which ? nullptr : o0);
  a.dk = static_cast<__nv_bfloat16*>(which ? o0 : nullptr);
  a.dv = static_cast<__nv_bfloat16*>(which ? o1 : nullptr);
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
  return d == 32 ? launch<32>(which, a, maps, bhkv, st)
                 : launch<16>(which, a, maps, bhkv, st);
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd_sm90.cu's entry points (is_bf16
// must be 1 and d 16 or 32).  Each returns 0 when launched, else a
// cudaError_t or one of sm90_common.cuh's codes
// (flash_bwd_sm90n_error_string names them).
int flash_bwd_dq_sm90n(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dq, const void* doc, int is_bf16, int bh,
                       int bhkv, int lq, int lk, int d, int q_off_lo,
                       int q_off_hi, int k_off_lo, int k_off_hi,
                       int kv_valid, int q_seg, int k_seg, int causal,
                       int window, float softcap, float scale, int packed,
                       int doc_skip, int doc_rows, void* stream) {
  return run(0, q, k, v, dout, lse, dsum, dq, nullptr, doc, is_bf16, bh,
             bhkv, lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi,
             kv_valid, q_seg, k_seg, causal, window, softcap, scale, packed,
             doc_skip, doc_rows, stream);
}

int flash_bwd_dkv_sm90n(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dk, void* dv, const void* doc, int is_bf16,
                        int bh, int bhkv, int lq, int lk, int d,
                        int q_off_lo, int q_off_hi, int k_off_lo,
                        int k_off_hi, int kv_valid, int q_seg, int k_seg,
                        int causal, int window, float softcap, float scale,
                        int packed, int doc_skip, int doc_rows,
                        void* stream) {
  return run(1, q, k, v, dout, lse, dsum, dk, dv, doc, is_bf16, bh, bhkv,
             lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid,
             q_seg, k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

const char* flash_bwd_sm90n_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
