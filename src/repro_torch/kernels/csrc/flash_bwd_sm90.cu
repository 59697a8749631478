// Flash-attention backward for Hopper's tensor cores (sm_90a), written by
// hand in CUDA C++: the bf16 dq kernel and the bf16 dk/dv kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289) and
// ::_dkv_kernel (:331), the Pallas TPU kernels launched by ``_bwd``, for
// bf16 operands at D = 64 and 128.  fp32 operands keep the 3xTF32 kernels
// of csrc/flash_bwd_tf32x3.cu, and bf16 below D 64 the narrow kernels of
// csrc/flash_bwd_sm90_narrow.cu.  The folded layout: q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) bf16; lse
// and dsum = rowsum(dO * O) (B*Hq, Lq) fp32; GQA: q row b reads KV row
// b / group.  P = exp(s - lse) on visible keys (a row whose lse is -1e30
// uses shift 0 and sees no key); dS = P * (dO.V^T - dsum), times
// (1 - (s_c/cap)^2) under a softcap, times the scale; dq = dS.K,
// dk = dS^T.Q, dv = P^T.dO.  The mask (kv_valid, causal, window, packed
// documents from the five band ints, q_seg / k_seg and the doc table) and
// the whole-tile skip are the other kernels', all plain launch arguments.
//
// What bounds it on an H100.  Compute: dq is three products of 2*L*L*D
// FLOPs a head (s, dP, dS.K), dk/dv four (s, dP, P^T.dO, dS^T.Q), halved
// under causal, against 989 TFLOP/s of bf16 tensor-core throughput (at
// B=2, L=4096, Hq=16, D=128 causal: 206.2 and 274.9 GFLOP, 0.2085 and
// 0.2780 ms).  The bytes (each operand read once) are far below that.
//
// Design.
//   Products.  Every product is a bf16 ``wgmma.mma_async`` with fp32
//   accumulation, issued by one warpgroup (128 threads) that owns a 64-row
//   tile.  dk/dv: a block owns 64 keys of one KV head and walks all
//   group * nq q tiles of its query heads, so the GQA sum stays in
//   registers: S^T = K.Q^T and dP^T = V.dO^T (A = K/V, B = Q/dO, both
//   K-major in shared memory), then P^T and dS^T in registers, then
//   dV += P^T.dO and dK += dS^T.Q with A taken from registers (the
//   accumulator fragment of S^T rounded to bf16 is the A fragment of the
//   next product) and B = dO/Q read MN-major (wgmma's transpose bit), so
//   no shared memory holds P or dS.  dq: a block owns 64 q rows and walks
//   the K tiles: S = Q.K^T, dP = dO.V^T, then dQ += dS.K with dS from
//   registers and K MN-major.  Registers a thread at D = 128: dK and dV
//   128, S^T and dP^T 64 (dq: dQ 64, S and dP 64).  No atomics: the result
//   is deterministic.
//   Numerics.  P and dS are rounded to bf16 before the second products
//   (the TPU kernel keeps them in fp32); the sums stay fp32.
//   Staging.  The tiles the loop walks (Q/dO for dk/dv, K/V for dq) come
//   through a ring of two stages, filled by TMA (cp.async.bulk.tensor)
//   with the 128-byte swizzle that wgmma's descriptors read, completing
//   on mbarriers; the next-but-one tile is requested as soon as a stage is
//   free, so loads overlap the math.  A 3-D tensor map per operand
//   (D, rows, heads) zero-fills rows past Lq / Lk, so the ragged edge
//   needs no padding.  The maps are encoded on the host for each launch
//   with cuTensorMapEncodeTiled, fetched from the driver through
//   cudaGetDriverEntryPoint(ByVersion) so the library links against the
//   CUDA runtime only (no -lcuda).  A wait that never completes traps
//   after about 4 s of clock instead of hanging the card.
//   Occupancy.  96 KB of tiles at D = 128 (99.9 KB with the stats, the
//   barriers and the alignment slack) and 128 threads: two blocks an SM.
//   The grid puts the tile index on its slow axis, heaviest first under
//   causal (key tile 0 for dk/dv, the last q tile for dq), so the long
//   blocks start first and the short ones fill the tail.
//   Masks.  A tile the band cannot reach is skipped (``tile_runs``); a
//   tile wholly inside the band, window, kv_valid, lengths and document
//   (``tile_full``) skips the per-element test; only tiles an edge crosses
//   apply it, on the accumulator fragment (row 16*warp + lane/4 (+8),
//   column 8*j + 2*(lane%4) (+1)).
//   The mask predicates, mbarriers, TMA, descriptors, wgmma wrappers and
//   the tensor-map encoder are shared with the forward kernel, in
//   csrc/sm90_common.cuh.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dq_sm90_kernel<64>   138, 0      flash_dkv_sm90_kernel<64>  168, 0
//   flash_dq_sm90_kernel<128>  171, 0      flash_dkv_sm90_kernel<128> 234, 0
// (no stack frame), under the 255 that two 128-thread blocks an SM allow.

#include "sm90_common.cuh"

namespace {

// Shared-memory layout (byte offsets from a 1024-byte aligned base): two
// fixed tiles, two stages of two tiles, 64 shifts and 64 dsums, three
// mbarriers (the stages', then the fixed tiles').
template <int D>
struct Smem {
  static constexpr int kTileBytes = tile_bytes<D>();
  static constexpr int kStage = 2 * kTileBytes;   // stage s at kStage*(1+s)
  static constexpr int kStats = 6 * kTileBytes;
  static constexpr int kBars = kStats + 2 * kTile * 4;
  static constexpr int kBytes = kBars + 3 * 8 + 1024;   // + alignment slack
};

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const BwdArgs a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kTileBytes;
  float* s_shift = reinterpret_cast<float*>(smem + L::kStats);
  float* s_dsum = s_shift + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int nq = (a.lq + kTile - 1) / kTile;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * warp + (lane >> 2);   // accumulator rows
  const int key_b = key_a + 8;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  int g = next_q_step(a, k0, bkv, -1, nq);          // block-uniform
  if (g < steps) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int gn = next_q_step(a, k0, bkv, g, nq);
    if (tid == 0) {               // K, V; Q and dO of steps g, gn
      tma_pair<D>(sK, &tm_k, &tm_v, &bars[2], k0, bkv);
      tma_pair<D>(sK + L::kStage, &tm_q, &tm_do, &bars[0], (g % nq) * kTile,
                  bkv * a.group + g / nq);
      if (gn < steps)
        tma_pair<D>(sK + 2 * L::kStage, &tm_q, &tm_do, &bars[1],
                    (gn % nq) * kTile, bkv * a.group + gn / nq);
    }
    mbar_wait(&bars[2], 0);

    for (int it = 0; g < steps; ++it) {
      const int s = it & 1;
      const int b = bkv * a.group + g / nq;
      const int q0 = (g % nq) * kTile;
      const uint32_t sQ = sK + L::kStage * (1 + s);
      const uint32_t sDO = sQ + L::kTileBytes;
      float lse_v = kNegInf, dsum_v = 0.f;
      if (tid < kTile && q0 + tid < a.lq) {
        lse_v = a.lse[static_cast<size_t>(b) * a.lq + q0 + tid];
        dsum_v = a.dsum[static_cast<size_t>(b) * a.lq + q0 + tid];
      }
      mbar_wait(&bars[s], (it >> 1) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns q rows.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, desc_k(sK, kk), desc_k(sQ, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k(sV, kk), desc_k(sDO, kk), kk);
      wgmma_commit();
      if (tid < kTile) {
        s_shift[tid] = (lse_v <= kNegInf / 2 ? 0.f : lse_v) * kLog2e;
        s_dsum[tid] = dsum_v;
      }
      __syncthreads();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      const int* docp =
          a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq
                   : nullptr;
      const bool full = tile_full(
          a, q0, k0, a.packed ? docp[min(q0 + kTile, a.lq) - 1] : 0);
      // P^T and dS^T as the A fragments of the next products: k step kk
      // takes accumulator column blocks j = 2kk, 2kk+1.
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = half ? key_b : key_a;
          float p2[2], ds2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * half + h;
            const int c = 8 * j + 2 * (lane & 3) + h;
            p_ds_exp2(a, st[i], s_shift[c], s_dsum[c], dpt[i], p2[h],
                      ds2[h]);
            if (!full) {
              const int row = q0 + c;
              const int qlog =
                  logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
              const int qdoc =
                  (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
              if (!visible(a, row, qlog, qdoc, key)) p2[h] = ds2[h] = 0.f;
            }
          }
          pa[j >> 1][(j & 1) * 2 + half] = pack_bf16(p2[0], p2[1]);
          dsa[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
        }
      }

      // dV += P^T.dO and dK += dS^T.Q (B MN-major: K = the 64 q rows).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], desc_mn(sDO, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, dsa[kk], desc_mn(sQ, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      __syncthreads();               // stage s and the stats are free
      const int ga = gn < steps ? next_q_step(a, k0, bkv, gn, nq) : steps;
      if (tid == 0 && ga < steps)
        tma_pair<D>(sQ, &tm_q, &tm_do, &bars[s], (ga % nq) * kTile,
                    bkv * a.group + ga / nq);
      g = gn;
      gn = ga;
    }
  }
  const size_t base = static_cast<size_t>(bkv) * a.lk * D;
  store_rows<D>(a.dk + base, dk, key_a, a.lk, lane);
  store_rows<D>(a.dv + base, dv, key_a, a.lk, lane);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const BwdArgs a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sDO = sQ + L::kTileBytes;
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

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  int kt = next_k_tile(a, q0, doc_first, -1, nk);   // block-uniform
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int kn = next_k_tile(a, q0, doc_first, kt, nk);
    if (tid == 0) {               // Q, dO; K and V of tiles kt, kn
      tma_pair<D>(sQ, &tm_q, &tm_do, &bars[2], q0, b);
      tma_pair<D>(sQ + L::kStage, &tm_k, &tm_v, &bars[0], kt * kTile, bkv);
      if (kn < nk)
        tma_pair<D>(sQ + 2 * L::kStage, &tm_k, &tm_v, &bars[1], kn * kTile,
                    bkv);
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
    mbar_wait(&bars[2], 0);

    for (int it = 0; kt < nk; ++it) {
      const int s = it & 1;
      const int k0 = kt * kTile;
      const uint32_t sK = sQ + L::kStage * (1 + s);
      const uint32_t sV = sK + L::kTileBytes;
      mbar_wait(&bars[s], (it >> 1) & 1);

      // S = Q.K^T and dP = dO.V^T: rows are q rows, columns keys.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k(sQ, kk), desc_k(sK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k(sDO, kk), desc_k(sV, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      const bool full = tile_full(a, q0, k0, doc_last);
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float ds2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * half + h;
            const int col = k0 + 8 * j + 2 * (lane & 3) + h;
            float p;
            p_ds_exp2(a, sc[i], shift_l2[half], dsum[half], dp[i], p,
                      ds2[h]);
            if (!full && !visible(a, row_a + 8 * half, qlog[half],
                                  qdoc[half], col))
              ds2[h] = 0.f;
          }
          dsa[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
        }
      }

      // dQ += dS.K (B MN-major: K = the 64 keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, dsa[kk], desc_mn(sK, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      __syncthreads();               // stage s is free
      const int ka = kn < nk ? next_k_tile(a, q0, doc_first, kn, nk) : nk;
      if (tid == 0 && ka < nk)
        tma_pair<D>(sK, &tm_k, &tm_v, &bars[s], ka * kTile, bkv);
      kt = kn;
      kn = ka;
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
  constexpr int smem = Smem<D>::kBytes;
  auto kernel = which ? flash_dkv_sm90_kernel<D> : flash_dq_sm90_kernel<D>;
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
  if (!is_bf16 || (d != 64 && d != 128) || !aligned || bh <= 0 ||
      bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int err = make_map(&maps[0], q, bh, lq, d);
  if (err == 0) err = make_map(&maps[1], dout, bh, lq, d);
  if (err == 0) err = make_map(&maps[2], k, bhkv, lk, d);
  if (err == 0) err = make_map(&maps[3], v, bhkv, lk, d);
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
  return d == 128 ? launch<128>(which, a, maps, bhkv, st)
                  : launch<64>(which, a, maps, bhkv, st);
}

}  // namespace

extern "C" {

// Every backward source's arguments (is_bf16 must be 1 and d 64 or
// 128).  Each returns 0 when launched, else a cudaError_t or
// one of sm90_common.cuh's codes (flash_bwd_sm90_error_string names
// them).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, const void* doc, int is_bf16, int bh,
                      int bhkv, int lq, int lk, int d, int q_off_lo,
                      int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
                      int q_seg, int k_seg, int causal, int window,
                      float softcap, float scale, int packed, int doc_skip,
                      int doc_rows, void* stream) {
  return run(0, q, k, v, dout, lse, dsum, dq, nullptr, doc, is_bf16, bh,
             bhkv, lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi,
             kv_valid, q_seg, k_seg, causal, window, softcap, scale, packed,
             doc_skip, doc_rows, stream);
}

int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, const void* doc, int is_bf16,
                       int bh, int bhkv, int lq, int lk, int d, int q_off_lo,
                       int q_off_hi, int k_off_lo, int k_off_hi,
                       int kv_valid, int q_seg, int k_seg, int causal,
                       int window, float softcap, float scale, int packed,
                       int doc_skip, int doc_rows, void* stream) {
  return run(1, q, k, v, dout, lse, dsum, dk, dv, doc, is_bf16, bh, bhkv,
             lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid,
             q_seg, k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

const char* flash_bwd_sm90_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
