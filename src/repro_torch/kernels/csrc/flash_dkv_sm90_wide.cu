// Flash-attention dk/dv for Hopper's tensor cores (sm_90a) above head dim
// 128, written by hand in CUDA C++: the ``sm90w`` route's dk/dv kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_dkv_kernel (:331), the
// Pallas TPU kernel launched in ``_bwd`` (:464), for bf16 operands at the
// padded head dims 192, 256 and 288 (gemma2-2b).  fp32 operands take the
// 3xTF32 kernels of csrc/flash_bwd_tf32x3_wide.cu; D = 384 has its own design
// (csrc/flash_bwd_sm90_d384.cu: there K and V alone take 96 KB and a 64 x 384
// fp32 accumulator a warpgroup does not fit in registers, so each block owns
// half of the columns).  Same function, folded layout and arguments as
// csrc/flash_bwd_sm90.cu's dk/dv: q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D)
// bf16; lse and dsum = rowsum(dO * O) (B*Hq, Lq) fp32; GQA row b / group.  P =
// exp(s - lse) on visible keys (a row whose lse is -1e30 uses shift 0 and sees
// no key); dS = P * (dO.V^T - dsum), times (1 - (s_c/cap)^2) under a softcap,
// times the scale; dk = sum over the group's q tiles of dS^T.Q, dv = sum of
// P^T.dO.  The mask and the whole-tile skip are launch arguments, as in every
// other route.
//
// What bounds it on an H100.  Compute: four products of 2*Lq*Lk*D FLOPs a
// head (S^T = K.Q^T, dP^T = V.dO^T, dV += P^T.dO, dK += dS^T.Q), halved
// under causal, at 989 TFLOP/s of bf16 tensor-core throughput (gemma2-2b's
// B=2, L=4096, Hq=8, D=288 causal: 309.3 GFLOP, 0.3128 ms).  The bytes are
// far below that.
//
// Design (the one kept: two warpgroups, each owning one accumulator; not
// half of dK's and dV's columns in each, where both warpgroups would need
// the whole S^T and dP^T of a tile).  Where the time goes (variants
// below): the tanh and exp of P in warpgroup 0, which warpgroup 1 waits
// for, then the four products.
//   Registers.  dK and dV, each 64 x D fp32, are D/2 registers a thread
//   each (144 at 288): one warpgroup cannot hold both (the D <= 128
//   kernel's design), so warpgroup 0 owns dV and warpgroup 1 owns dK, each
//   in the ``OutParts`` layout (256 + 32 columns at 288).  Each issues two
//   of the four products: warpgroup 0 S^T = K.Q^T (K and Q K-major from
//   shared memory, D/16 k steps) and dV += P^T.dO (P^T from registers, dO
//   MN-major); warpgroup 1 dP^T = V.dO^T and dK += dS^T.Q.  The A
//   fragments of the second products are the accumulators of the first,
//   rounded to bf16, as in csrc/flash_bwd_sm90.cu.
//   The exchange.  Warpgroup 1's dS^T needs warpgroup 0's P.  Both first
//   products' accumulators (M = 64 keys, N = the stage's q rows) have the
//   same fragment layout, so thread t of warpgroup 0 writes its values and
//   thread t of warpgroup 1 reads the same slots of a thread-major buffer
//   (16-byte pieces, no bank conflicts).  What is sent is P times the
//   softcap's factor (1 - t^2), or P without a softcap, already masked: so
//   warpgroup 1 does no tanh, exp or mask test, and dS^T = PF * (dP^T -
//   dsum) * scale.  Two named barriers order it ("written", 5; "read", 6:
//   barrier 0 is __syncthreads', 1-2 ``warpgroup_sync``'s): warpgroup 1
//   counts the buffer free once before the loop and once a tile after
//   reading it, warpgroup 0 waits for that before each write and once after
//   the loop, so each barrier sees as many arrivals as waits and the block
//   ends with both idle.
//   Shared memory at 288.  K and V fixed (64 keys, 40,960 B each); Q and
//   dO through kStages = 2 stages of kQRows = 48 q rows (61,440 B a stage);
//   the exchange 12,288 B; 218,144 B with the barriers and slack: one block
//   an SM.  64-row stages do not fit.
//   Stage release.  Both warpgroups read both tiles of a stage; each counts
//   itself in with an atomic add in shared memory after its last product
//   on it, and the second refills it by TMA (as the sm90w forward frees
//   its K/V stages), so neither waits for the other except on data.
//   Per-row stats.  lse (warpgroup 0) and dsum (warpgroup 1) are per q
//   row, so per accumulator column: each thread loads its 12 columns'
//   values while its first product runs; no block-wide barrier locks the
//   two warpgroups together.
//   Special functions.  P = 2^(s log2 e - shift) by ex2.approx, and under
//   the softcap tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) by ex2.approx and
//   rcp.approx (the D <= 128 kernels use tanhf and exp2f): about 3e-7
//   absolute error in tanh, 1.5e-5 relative in P at softcap 50, below the
//   2^-8 of P's rounding to bf16; the scale over the softcap is a factor
//   taken once, not a division a score.
//   Grid.  (KV heads, key tiles) with the key tile on the slow axis,
//   heaviest first under causal (key tile 0 is seen by every q row).  A
//   block walks all group * nq q steps of its KV head, so the GQA sum stays
//   in registers: no atomics, deterministic.
//   Numerics.  P and dS are rounded to bf16 before the second products, as
//   in the D 64/128 kernels; the sums stay fp32.
//   Staging, masks.  As csrc/flash_dq_sm90_wide.cu: TMA with the 128-byte
//   swizzle, zero rows past L and zero columns past D (a 48-row Q/dO box,
//   a 64-row K/V box); ``tile_runs`` (through ``next_q_step``) skips a q
//   tile the band cannot reach, ``tile_full`` the per-element test, and a
//   masked score gives P = 0 before either warpgroup's second product.
//   Tried and not kept (patches in scripts/ab_wide_sm90.py, PERF.md
//   section 6; times at gemma2-2b's shape against the kept kernel's in one
//   call): the raw scores in the exchange, each warpgroup computing P
//   (1.05x), 32-row stages, three of them (1.06x), tanhf and exp2f (1.11x),
//   those and a division a score (1.34x).  Without the tanh and exp (wrong
//   by design) the kernel takes 0.77x, without the Q/dO loads 0.93x.
// ptxas (-O3 -Xptxas -v for sm_90a; chip_smoke.py phase 1 prints them):
// registers a thread and spill bytes per instantiation
//   flash_dkv_sm90w_kernel<192>  180, 0
//   flash_dkv_sm90w_kernel<256>  214, 0
//   flash_dkv_sm90w_kernel<288>  228, 0

#include "sm90_common.cuh"

namespace {

constexpr int kStages = 2;       // Q/dO stages of the ring
constexpr int kQRows = 48;       // q rows a stage
constexpr int kWritten = 5;      // named barrier: the exchange holds a tile
constexpr int kRead = 6;         // named barrier: the exchange is free

template <int D>
struct DkvWideSmem {
  static constexpr int kKvBytes = tile_bytes<D>();           // K or V
  static constexpr int kQBytes = tile_bytes<D, kQRows>();    // Q or dO
  static constexpr int kRing = 2 * kKvBytes;                 // stage 0
  static constexpr int kStage = 2 * kQBytes;
  static constexpr int kX = kRing + kStages * kStage;        // the exchange
  static constexpr int kXBytes = kQRows / 2 * kThreads * 4;
  static constexpr int kBars = kX + kXBytes;                 // + K/V's
  static constexpr int kCounts = kBars + (kStages + 1) * 8;
  static constexpr int kBytes = kCounts + kStages * 4 + 1024;   // + slack
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

template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
flash_dkv_sm90w_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const BwdArgs a) {
  using L = DkvWideSmem<D>;
  using P = OutParts<D>;
  constexpr int kN = kQRows / 2;          // accumulator floats of S^T, dP^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kKvBytes;
  float4* xch = reinterpret_cast<float4*>(smem + L::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  unsigned* counts = reinterpret_cast<unsigned*>(smem + L::kCounts);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads, t = tid % kThreads;
  const int warp = t >> 5, lane = t & 31;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int nq = (a.lq + kQRows - 1) / kQRows;
  const int steps = a.group * nq;
  const int key_a = k0 + 16 * warp + (lane >> 2);   // accumulator rows
  // P = 2^(s * log2(e) - shift): a raw score's factor without a softcap;
  // with one, tanh's inner factor (times 2 log2(e)) and the outer one.
  const float lin = a.scale * kLog2e;
  const float tin = 2.f * kLog2e * a.scale / a.softcap;
  const float outer = a.softcap * kLog2e;

  float acc[P::kAcc];                     // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < P::kAcc; ++i) acc[i] = 0.f;

  // The block's q steps, in order (block-uniform): g is step it's, far
  // step it + kStages - 1's (steps past the end).
  int g = next_q_step<kQRows>(a, k0, bkv, -1, nq);
  if (g < steps) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
#pragma unroll
      for (int i = 0; i < kStages; ++i) counts[i] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
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
    if (wg == 1) bar_arrive(kRead);       // the exchange starts free

    for (int it = 0; g < steps; ++it) {
      const int s = it % kStages;
      const int b = bkv * a.group + g / nq;
      const int q0 = (g % nq) * kQRows;
      const uint32_t sQ = sK + L::kRing + L::kStage * s;
      const uint32_t sDO = sQ + L::kQBytes;
      const float* stat = (wg == 0 ? a.lse : a.dsum) +
                          static_cast<size_t>(b) * a.lq + q0;
      const int nfar =
          far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;
      mbar_wait(&bars[s], (it / kStages) & 1);

      // This thread's accumulator columns are q rows q0 + 8j + 2(lane%4)
      // (+1); i = 4j + 2*half + h indexes the fragment (rows: keys k0 +
      // 16*warp + lane/4 (+8)), and float4 i of the exchange is block j.
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
        // P^T, masked, into frag; P^T times the softcap's factor into x
        // (tanh and 2^x as the header's "Special functions" says).
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
              const int c = 8 * j + 2 * (lane & 3) + h;
              float p, f = 1.f;
              if (a.softcap != 0.f) {
                const float th =
                    1.f - __fdividef(2.f, ex2(x[i] * tin) + 1.f);
                p = ex2(outer * th - rs[2 * j + h]);
                f = 1.f - th * th;
              } else {
                p = ex2(fmaf(x[i], lin, -rs[2 * j + h]));
              }
              if (!full) {
                const int row = q0 + c;
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
        bar_wait(kRead);
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
        bar_arrive(kRead);
#pragma unroll
        for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            frag[j >> 1][(j & 1) * 2 + half] =
                pack_bf16(x[4 * j + 2 * half], x[4 * j + 2 * half + 1]);
      }

      // dV += P^T.dO (0) or dK += dS^T.Q (1), B MN-major: K = the q rows.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs_parts<D, kQRows>(acc, frag[kk], wg == 0 ? sDO : sQ, kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);

      // Stage s is free once both warpgroups are done with it; the second
      // to count itself in refills it with the step kStages further on.
      warpgroup_sync(wg);
      if (t == 0) {
        __threadfence_block();
        const unsigned done = atomicAdd(&counts[s], 1u);
        if (done % 2 == 1 && nfar < steps)
          tma_pair<D, kQRows>(sQ, &tm_q, &tm_do, &bars[s],
                              (nfar % nq) * kQRows,
                              bkv * a.group + nfar / nq);
      }
      far = nfar;
      g = next_q_step<kQRows>(a, k0, bkv, g, nq);
    }
    if (wg == 0) bar_wait(kRead);         // the last "free": both idle
  }
  const size_t base = static_cast<size_t>(bkv) * a.lk * D;
  store_rows<D, P::kAcc>((wg == 0 ? a.dv : a.dk) + base, acc, key_a, a.lk,
                         lane);
}

template <int D>
int launch(const BwdArgs& a, const CUtensorMap (&m)[4], int bhkv,
           cudaStream_t stream) {
  constexpr int smem = DkvWideSmem<D>::kBytes;
  auto kernel = flash_dkv_sm90w_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bhkv, (a.lk + kTile - 1) / kTile);   // key tile: slow
  kernel<<<grid, 2 * kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The same arguments as csrc/flash_bwd_sm90.cu's ``flash_bwd_dkv_sm90``
// (is_bf16 must be 1 and d 192, 256 or 288).  Returns 0 when launched, else a
// cudaError_t or one of sm90_common.cuh's codes
// (flash_bwd_sm90w_error_string names them).
int flash_bwd_dkv_sm90w(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dk, void* dv, const void* doc, int is_bf16,
                        int bh, int bhkv, int lq, int lk, int d,
                        int q_off_lo, int q_off_hi, int k_off_lo,
                        int k_off_hi, int kv_valid, int q_seg, int k_seg,
                        int causal, int window, float softcap, float scale,
                        int packed, int doc_skip, int doc_rows,
                        void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  if (!is_bf16 || (d != 192 && d != 256 && d != 288) || !aligned ||
      bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int err = make_map(&maps[0], q, bh, lq, d, kQRows);
  if (err == 0) err = make_map(&maps[1], dout, bh, lq, d, kQRows);
  if (err == 0) err = make_map(&maps[2], k, bhkv, lk, d);
  if (err == 0) err = make_map(&maps[3], v, bhkv, lk, d);
  if (err != 0) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = nullptr;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
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
  if (d == 192) return launch<192>(a, maps, bhkv, st);
  if (d == 256) return launch<256>(a, maps, bhkv, st);
  return launch<288>(a, maps, bhkv, st);
}

const char* flash_bwd_sm90w_error_string(int err) {
  return sm90_error_string(err);
}

}  // extern "C"
