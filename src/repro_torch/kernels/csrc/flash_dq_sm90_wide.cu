// Flash-attention dq for Hopper's tensor cores (sm_90a) above head dim 128,
// written by hand in CUDA C++: the ``sm90w`` route's dq kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel (:289), the
// Pallas TPU kernel launched in ``_bwd`` (:421), for bf16 operands at the
// padded head dims 192, 256 and 288 (gemma2-2b).  fp32 operands take the
// 3xTF32 kernels of csrc/flash_bwd_tf32x3_wide.cu; D = 384 has its own design
// (csrc/flash_bwd_sm90_d384.cu: a 64 x 384 dQ partial per warpgroup would
// not fit in registers).  Same function, folded layout and arguments as
// csrc/flash_bwd_sm90.cu's dq: q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D)
// bf16; lse and dsum = rowsum(dO * O) (B*Hq, Lq) fp32; GQA row b / group.
// P = exp(s - lse) on visible keys (a row whose lse is -1e30 uses shift 0
// and sees no key); dS = P * (dO.V^T - dsum), times (1 - (s_c/cap)^2) under
// a softcap, times the scale; dq = dS.K.  The mask and the whole-tile skip
// are launch arguments, as in every other route.
//
// What bounds it on an H100.  Compute: three products of 2*Lq*Lk*D FLOPs a
// head (S = Q.K^T, dP = dO.V^T, dQ += dS.K), halved under causal, at 989
// TFLOP/s of bf16 tensor-core throughput (gemma2-2b's B=2, L=4096, Hq=8,
// D=288 causal: 232.0 GFLOP, 0.235 ms).  The bytes are far below that.
//
// Design.
//   Registers.  dQ, 64 x D fp32, is D/2 registers a thread (144 at 288),
//   so Q and dO stay in shared memory as K-major operands of S and dP, whose
//   depth runs D/16 k steps (the zero columns of a last chunk are never
//   read).  dQ += dS.K takes dS from registers (rounded to bf16) and K
//   MN-major, in parts of at most 256 columns (``OutParts``: 256 + 32 at
//   D = 288).
//   Shared memory.  Q and dO are fixed 64-row tiles (40 KB each at 288);
//   K and V come through a ring of kStages stages of 48 keys (60 KB a
//   stage): 200 KB with two stages, so one block an SM.
//   Warpgroups.  A block owns 64 q rows of one head and walks the key
//   tiles the band reaches from them.  With two warpgroups, tile i goes to
//   warpgroup i % 2, each with its own dQ partial sum, so one warpgroup's
//   dS runs beside the other's products; the two issue their products in
//   turns (a token passed on a named barrier each, so the S and dP of one
//   and the dQ of the other alternate on the tensor cores; every wait
//   consumes one pass, and the block ends with the token where it started,
//   both barriers idle).  At the end the second adds its sum to the
//   first's through shared memory (the ring, now idle), in a fixed order:
//   no atomics, and the result is deterministic.  Stage i % kStages holds
//   tile i; the warpgroup that used it refills it with tile i + kStages.
//   Numerics.  dS is rounded to bf16 before dS.K, as in the D 64/128
//   kernels; the sums stay fp32.
//   Staging, masks.  As csrc/flash_fwd_sm90_wide.cu: TMA with the 128-byte
//   swizzle, zero rows past L and zero columns past D; ``tile_runs`` skips
//   a tile the band cannot reach, ``tile_full`` the per-element test.
//   Tried and not kept (patches in scripts/ab_wide_sm90.py, PERF.md
//   section 6; times against the kept kernel's in one call): one
//   warpgroup (1.79x), 32-key stages, three of them (1.12x), no turns
//   (1.15x), the q tile on the grid's fast axis (1.09x), a last output
//   part of a whole chunk (1.04x, within the spread of the call).
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dq_sm90w_kernel<192>  200, 0
//   flash_dq_sm90w_kernel<256>  233, 0
//   flash_dq_sm90w_kernel<288>  244, 0

#include "sm90_common.cuh"

namespace {

constexpr int kWarpgroups = 2;   // warpgroups sharing a block's key tiles
constexpr int kStages = 2;       // K/V stages of the ring
constexpr int kKeys = 48;        // keys a stage

template <int D>
struct DqWideSmem {
  static constexpr int kTileBytes = tile_bytes<D>();        // Q or dO
  static constexpr int kKvBytes = tile_bytes<D, kKeys>();   // K or V
  static constexpr int kRing = 2 * kTileBytes;              // stage 0
  static constexpr int kStage = 2 * kKvBytes;
  static constexpr int kBars = kRing + kStages * kStage;    // + Q/dO's
  static constexpr int kBytes = kBars + (kStages + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
  static_assert(kWarpgroups == 1 || kStages * kStage >=
                OutParts<D>::kAcc * kThreads * 4,
                "the ring must hold a warpgroup's dQ for the final sum");
};

// The two warpgroups issue their products in turns, so one's dS runs
// while the other's products do.  The turn is a token on named barrier 3 +
// wg: ``turn_wait`` waits until it is this warpgroup's, ``turn_pass`` hands
// it to the other.  Each bar.sync there consumes exactly one bar.arrive of
// the other warpgroup (see the kernel for the count).
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (kWarpgroups == 2)
    asm volatile("bar.sync %0, %1;\n" :: "r"(3 + wg), "r"(2 * kThreads)
                 : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (kWarpgroups == 2)
    asm volatile("bar.arrive %0, %1;\n" :: "r"(3 + (wg ^ 1)),
                 "r"(2 * kThreads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads * kWarpgroups, 1)
flash_dq_sm90w_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const BwdArgs a) {
  using L = DqWideSmem<D>;
  using P = OutParts<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sDO = sQ + L::kTileBytes;
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

  float dq[P::kAcc];
#pragma unroll
  for (int i = 0; i < P::kAcc; ++i) dq[i] = 0.f;

  // The block's key tiles, in order (block-uniform): kt is tile i's, far
  // tile i + kStages - 1's (nk past the end).
  int kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, -1, nk);
  if (kt < nk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
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
    // The token starts with warpgroup 0 (warpgroup 1's first pass) and
    // ends with it (its wait after the loop); in between each warpgroup
    // takes two turns a round of kWarpgroups tiles, so each barrier sees as
    // many waits as arrivals and the block exits with both idle.
    if (wg == 1) turn_pass(wg);

    int it = 0;
    for (; kt < nk; ++it) {
      const int s = it % kStages;
      const int k0 = kt * kKeys;
      const uint32_t sK = sQ + L::kRing + L::kStage * s;
      const uint32_t sV = sK + L::kKvBytes;
      const int nfar =
          far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)
                   : nk;
      if (it % kWarpgroups == wg) {        // warpgroup-uniform
        mbar_wait(&bars[s], (it / kStages) & 1);

        // S = Q.K^T and dP = dO.V^T (all K-major from shared memory):
        // rows are q rows, columns keys.
        float sc[kKeys / 2], dp[kKeys / 2];
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kKeys>(sc, desc_k(sQ, kk), desc_k(sK, kk, kKeys * 128), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kKeys>(dp, desc_k(sDO, kk), desc_k(sV, kk, kKeys * 128),
                       kk);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait_all();
        pin(sc);
        pin(dp);

        const bool full = tile_full<kTile, kKeys>(a, q0, k0, doc_last);
        uint32_t dsa[kKeys / 16][4];
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
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

        // dQ += dS.K (K MN-major: K = the stage's keys).
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_rs_parts<D, kKeys>(dq, dsa[kk], sK, kk);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait_all();
        pin(dq);
        warpgroup_sync(wg);          // stage s is free
        if (t == 0 && nfar < nk)
          tma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);
      }
      far = nfar;
      kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);
    }
    // A warpgroup that got no tile in the last (partial) round still
    // takes its two turns, so the other's turns keep alternating with them.
    if (it % kWarpgroups != 0 && wg >= it % kWarpgroups) {
      turn_wait(wg);
      turn_pass(wg);
      turn_wait(wg);
      turn_pass(wg);
    }
    if (wg == 0) turn_wait(wg);      // the token back: both barriers idle
    if constexpr (kWarpgroups == 2) {
      // dQ = the first warpgroup's sum + the second's, through the ring.
      float* red = reinterpret_cast<float*>(smem + L::kRing);
      __syncthreads();
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < P::kAcc; ++i) red[i * kThreads + t] = dq[i];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < P::kAcc; ++i) dq[i] += red[i * kThreads + t];
      }
    }
  }
  if (wg == 0)
    store_rows<D, P::kAcc>(a.dq + static_cast<size_t>(b) * a.lq * D, dq,
                           row_a, a.lq, lane);
}

template <int D>
int launch(const BwdArgs& a, const CUtensorMap (&m)[4], cudaStream_t stream) {
  constexpr int smem = DqWideSmem<D>::kBytes;
  auto kernel = flash_dq_sm90w_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.bh, (a.lq + kTile - 1) / kTile);
  kernel<<<grid, kThreads * kWarpgroups, smem, stream>>>(m[0], m[1], m[2],
                                                         m[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd_sm90.cu's ``flash_bwd_dq_sm90``
// (is_bf16 must be 1 and d 192, 256 or 288).  Returns 0 when launched, else a cudaError_t
// or one of sm90_common.cuh's codes (flash_bwd_sm90w_error_string names
// them).
int flash_bwd_dq_sm90w(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dq, const void* doc, int is_bf16, int bh,
                       int bhkv, int lq, int lk, int d, int q_off_lo,
                       int q_off_hi, int k_off_lo, int k_off_hi,
                       int kv_valid, int q_seg, int k_seg, int causal,
                       int window, float softcap, float scale, int packed,
                       int doc_skip, int doc_rows, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  if (!is_bf16 || (d != 192 && d != 256 && d != 288) || !aligned ||
      bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int err = make_map(&maps[0], q, bh, lq, d);
  if (err == 0) err = make_map(&maps[1], dout, bh, lq, d);
  if (err == 0) err = make_map(&maps[2], k, bhkv, lk, d, kKeys);
  if (err == 0) err = make_map(&maps[3], v, bhkv, lk, d, kKeys);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = nullptr;
  a.dv = nullptr;
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

const char* flash_bwd_sm90w_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
