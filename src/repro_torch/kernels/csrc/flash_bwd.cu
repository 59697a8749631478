// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++:
// the dq kernel and the dk/dv kernel on fp32 FMA, for bf16 operands at
// D = 16 and 32 only.  bf16 at D = 64 and 128 takes the tensor-core kernels
// of csrc/flash_bwd_sm90.cu, and fp32 at every D the 3xTF32 tensor-core
// kernels of csrc/flash_bwd_tf32x3.cu; no route reaches this source's
// kernels with fp32 operands or a wider head, so they are not built.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels launched by ``_bwd``).  Same function, same folded
// layout as the forward (csrc/flash_fwd.cu):
//   q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) bf16; lse and
//   dsum = rowsum(dO * O) (B*Hq, Lq) fp32.  GQA: q row b reads KV row
//   b / group.  dq comes out in q's type, dk/dv in k's type.
//   P = exp(s - lse) on visible keys (a row whose lse is -1e30 uses shift
//   0 and sees no key, so it gives dq = 0 and adds nothing to dk/dv);
//   dS = P * (dO.V^T - dsum), times (1 - (s_c/cap)^2) under a softcap, times
//   the scale; dq = dS.K, dk = dS^T.Q, dv = P^T.dO.  The mask and the
//   whole-tile skip are the forward's: kv_valid, causal, window and the
//   packed-document table, from the five band ints and q_seg / k_seg, all
//   plain launch arguments.
//
// Design.  The TPU kernels keep a sequential grid axis and carry their sums
// in VMEM scratch; CUDA blocks carry nothing between them, so each block
// loops over the tiles it reduces over itself.
//   dq:   one block per (64-row q tile, B*Hq row) walks every K tile
//         (64 keys), recomputes s and P, and
//         accumulates dS.K in registers.
//   dk/dv: one block per (key tile, B*Hkv row) walks all group * nq q
//         tiles of the query heads that share this KV head (q row
//         b*group + g/nq, q tile g%nq), so the group sum happens in the
//         block's fp32 registers: no atomics (the result is deterministic)
//         and no K/V expanded by the group size.
// Tiles are staged in shared memory as fp32, and the products are plain
// fp32 FMA loops (no tensor cores).  256 threads as 16 x 16; in the dq kernel
// thread (ty, tx) owns q rows ty*4..ty*4+3 and dq columns tx + 16*c; in the
// dk/dv kernel it owns keys ty*KR..ty*KR+KR-1 and columns tx + 16*c.
//
// What bounds it on an H100.  Compute: dq is three products of
// 2*Lq*Lk*D FLOPs (s, dP and dS.K), dk/dv four (s, dP, P^T.dO, dS^T.Q),
// halved for causal, against 989 TFLOP/s of bf16 tensor-core throughput;
// the bytes are far below that line at training lengths.  This simple
// design runs on the fp32 CUDA cores (67 TFLOP/s at best) and reads its
// operands from shared memory for every FMA, so it sits well above that
// bound; mma/wgmma tiles and TMA staging are the work of a later change.
// Its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kDocAbsent = 0x7fffffff;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;              // (B*Hq, Lq)
  const float* dsum;             // (B*Hq, Lq)
  void* dq;
  void* dk;
  void* dv;
  const int* doc;                // (B, Lq) per-row doc start, or null
  int bh, group, lq, lk, q_mult;
  int q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg, k_seg;
  int causal, window, packed, doc_skip;   // window < 0: no window
  float softcap, scale;
};

__device__ __forceinline__ int logical_pos(int idx, int lo, int hi, int seg) {
  return seg == 0 ? idx + hi : idx + (idx < seg ? lo : hi);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ``_run_predicate`` at tile edges.  Logical positions are nondecreasing in
// the physical index, so a tile's extrema sit at its edges; the doc-start
// table is nondecreasing too, so a q tile's smallest doc start is its first
// row's (``doc_first``).
__device__ __forceinline__ bool tile_runs(const Args& a, int q0, int bq,
                                          int k0, int bk, int doc_first) {
  const int q_log_first = logical_pos(q0, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int q_log_last =
      logical_pos(q0 + bq - 1, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int k_log_first = logical_pos(k0, a.k_off_lo, a.k_off_hi, a.k_seg);
  const int k_log_last =
      logical_pos(k0 + bk - 1, a.k_off_lo, a.k_off_hi, a.k_seg);
  bool run = k0 < a.kv_valid;
  if (a.causal) run = run && k_log_first <= q_log_last;
  if (a.window >= 0) run = run && k_log_last >= q_log_first - (a.window - 1);
  if (a.packed && a.doc_skip) run = run && k_log_last >= doc_first;
  return run;
}

// Whether query row ``row`` (logical ``qlog``, doc start ``qdoc``) sees key
// ``col``.
__device__ __forceinline__ bool visible(const Args& a, int row, int qlog,
                                        int qdoc, int col) {
  bool ok = row < a.lq && col < a.lk && col < a.kv_valid;
  if (a.causal || a.window >= 0) {
    const int kl = logical_pos(col, a.k_off_lo, a.k_off_hi, a.k_seg);
    if (a.causal) ok = ok && kl <= qlog;
    if (a.packed) ok = ok && kl >= qdoc;
    if (a.window >= 0) ok = ok && kl >= qlog - (a.window - 1);
  }
  return ok;
}

// (p, ds) of one score from the raw product q.k, the row's shift and dsum,
// and dO.v.
__device__ __forceinline__ void p_ds(const Args& a, bool vis, float qk,
                                     float shift, float dsum, float dp,
                                     float& p, float& ds) {
  float s = qk * a.scale;
  float factor = a.scale;
  if (a.softcap != 0.f) {
    s = a.softcap * tanhf(s / a.softcap);
    const float t = s / a.softcap;
    factor *= 1.f - t * t;
  }
  p = vis ? expf(s - shift) : 0.f;
  ds = p * (dp - dsum) * factor;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // q rows per dq block

template <int D, int BK>
constexpr size_t dq_smem_bytes() {
  // sQ, sDO (BQ x D+1), sK, sV (BK x D+1), sDS (BQ x BK+1), fp32.
  return sizeof(float) *
         (2 * kBQ * (D + 1) + 2 * BK * (D + 1) + kBQ * (BK + 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int QS = D + 1;      // padded stride: column walks hit distinct banks
  constexpr int PS = BK + 1;
  constexpr int SC = BK / 16;    // score columns per thread
  constexpr int OC = D / 16;     // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kBQ * QS;
  float* sK = sDO + kBQ * QS;
  float* sV = sK + BK * QS;
  float* sDS = sV + BK * QS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y;
  const int bkv = b / a.group;
  const T* qp = static_cast<const T*>(a.q) + (size_t)b * a.lq * D;
  const T* dop = static_cast<const T*>(a.dout) + (size_t)b * a.lq * D;
  const T* kp = static_cast<const T*>(a.k) + (size_t)bkv * a.lk * D;
  const T* vp = static_cast<const T*>(a.v) + (size_t)bkv * a.lk * D;
  const int* docp =
      a.packed ? a.doc + (size_t)(b / a.q_mult) * a.lq : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    const bool in = row < a.lq;
    sQ[r * QS + c] = in ? to_float(qp[(size_t)row * D + c]) : 0.f;
    sDO[r * QS + c] = in ? to_float(dop[(size_t)row * D + c]) : 0.f;
  }

  float acc[4][OC], shift[4], dsum[4];
  int rows[4], qlog[4], qdoc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    rows[i] = row;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
    const float lse = row < a.lq ? a.lse[(size_t)b * a.lq + row] : kNegInf;
    shift[i] = lse <= kNegInf / 2 ? 0.f : lse;
    dsum[i] = row < a.lq ? a.dsum[(size_t)b * a.lq + row] : 0.f;
    qlog[i] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
    qdoc[i] = (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
  }
  const int doc_first = a.packed ? docp[q0] : 0;
  const int nk = (a.lk + BK - 1) / BK;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_runs(a, q0, kBQ, k0, BK, doc_first)) continue;  // block-uniform

    __syncthreads();               // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D, col = k0 + r;
      const bool in = col < a.lk;
      sK[r * QS + c] = in ? to_float(kp[(size_t)col * D + c]) : 0.f;
      sV[r * QS + c] = in ? to_float(vp[(size_t)col * D + c]) : 0.f;
    }
    __syncthreads();

    // s = Q.K^T and dP = dO.V^T for this thread's 4 rows x SC columns.
    float s[4][SC], dp[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[SC], vv[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * QS + d];
        dov[i] = sDO[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        kv[j] = sK[(tx + 16 * j) * QS + d];
        vv[j] = sV[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = k0 + tx + 16 * j;
        float p, ds;
        p_ds(a, visible(a, rows[i], qlog[i], qdoc[i], col), s[i][j],
             shift[i], dsum[i], dp[i][j], p, ds);
        sDS[(ty * 4 + i) * PS + tx + 16 * j] = ds;
      }
    __syncthreads();               // dS complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) kv[c] = sK[kk * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dqp = static_cast<T*>(a.dq) + (size_t)b * a.lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rows[i] >= a.lq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      dqp[(size_t)rows[i] * D + tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

constexpr int kBQKV = 64;        // q rows per step of the dk/dv block

template <int D, int BKV>
constexpr size_t dkv_smem_bytes() {
  // sK, sV (BKV x D+1), sQ, sDO (BQ x D+1), sP, sDS (BKV x BQ+1), and the
  // q tile's shift, dsum, logical positions and doc starts.
  return sizeof(float) * (2 * BKV * (D + 1) + 2 * kBQKV * (D + 1) +
                          2 * BKV * (kBQKV + 1) + 4 * kBQKV);
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int QS = D + 1;
  constexpr int PS = kBQKV + 1;
  constexpr int KR = BKV / 16;   // keys per thread
  constexpr int QC = kBQKV / 16; // q columns per thread in the score tile
  constexpr int OC = D / 16;     // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BKV * QS;
  float* sQ = sV + BKV * QS;
  float* sDO = sQ + kBQKV * QS;
  float* sP = sDO + kBQKV * QS;
  float* sDS = sP + BKV * PS;
  float* sShift = sDS + BKV * PS;
  float* sDsum = sShift + kBQKV;
  int* sQlog = reinterpret_cast<int*>(sDsum + kBQKV);
  int* sQdoc = sQlog + kBQKV;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BKV;
  const int bkv = blockIdx.y;
  const T* kp = static_cast<const T*>(a.k) + (size_t)bkv * a.lk * D;
  const T* vp = static_cast<const T*>(a.v) + (size_t)bkv * a.lk * D;

  for (int i = tid; i < BKV * D; i += kThreads) {
    const int r = i / D, c = i % D, col = k0 + r;
    const bool in = col < a.lk;
    sK[r * QS + c] = in ? to_float(kp[(size_t)col * D + c]) : 0.f;
    sV[r * QS + c] = in ? to_float(vp[(size_t)col * D + c]) : 0.f;
  }

  float dk[KR][OC], dv[KR][OC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (a.lq + kBQKV - 1) / kBQKV;
  for (int g = 0; g < a.group * nq; ++g) {
    const int b = bkv * a.group + g / nq;      // folded q row
    const int q0 = (g % nq) * kBQKV;
    const int* docp =
        a.packed ? a.doc + (size_t)(b / a.q_mult) * a.lq : nullptr;
    const int doc_first = a.packed ? docp[q0] : 0;
    if (!tile_runs(a, q0, kBQKV, k0, BKV, doc_first)) continue;

    const T* qp = static_cast<const T*>(a.q) + (size_t)b * a.lq * D;
    const T* dop = static_cast<const T*>(a.dout) + (size_t)b * a.lq * D;
    __syncthreads();               // the previous q tile is no longer read
    for (int i = tid; i < kBQKV * D; i += kThreads) {
      const int r = i / D, c = i % D, row = q0 + r;
      const bool in = row < a.lq;
      sQ[r * QS + c] = in ? to_float(qp[(size_t)row * D + c]) : 0.f;
      sDO[r * QS + c] = in ? to_float(dop[(size_t)row * D + c]) : 0.f;
    }
    if (tid < kBQKV) {
      const int row = q0 + tid;
      const bool in = row < a.lq;
      const float lse = in ? a.lse[(size_t)b * a.lq + row] : kNegInf;
      sShift[tid] = lse <= kNegInf / 2 ? 0.f : lse;
      sDsum[tid] = in ? a.dsum[(size_t)b * a.lq + row] : 0.f;
      sQlog[tid] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
      sQdoc[tid] = (a.packed && in) ? docp[row] : kDocAbsent;
    }
    __syncthreads();

    // s^T = K.Q^T and dP^T = V.dO^T for this thread's KR keys x QC rows.
    float s[KR][QC], dp[KR][QC];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < QC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[KR], vv[KR], qv[QC], dov[QC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        kv[i] = sK[(ty * KR + i) * QS + d];
        vv[i] = sV[(ty * KR + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        qv[j] = sQ[(tx + 16 * j) * QS + d];
        dov[j] = sDO[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int r = tx + 16 * j;
        const int col = k0 + ty * KR + i;
        float p, ds;
        p_ds(a, visible(a, q0 + r, sQlog[r], sQdoc[r], col), s[i][j],
             sShift[r], sDsum[r], dp[i][j], p, ds);
        sP[(ty * KR + i) * PS + r] = p;
        sDS[(ty * KR + i) * PS + r] = ds;
      }
    __syncthreads();               // P and dS complete

#pragma unroll 4
    for (int r = 0; r < kBQKV; ++r) {
      float pv[KR], dsv[KR], dov[OC], qv[OC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        pv[i] = sP[(ty * KR + i) * PS + r];
        dsv[i] = sDS[(ty * KR + i) * PS + r];
      }
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        dov[c] = sDO[r * QS + tx + 16 * c];
        qv[c] = sQ[r * QS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + (size_t)bkv * a.lk * D;
  T* dvp = static_cast<T*>(a.dv) + (size_t)bkv * a.lk * D;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int col = k0 + ty * KR + i;
    if (col >= a.lk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dkp[(size_t)col * D + tx + 16 * c] = from_float<T>(dk[i][c]);
      dvp[(size_t)col * D + tx + 16 * c] = from_float<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int BK = 64;
  constexpr size_t smem = dq_smem_bytes<D, BK>();
  auto kernel = flash_dq_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + kBQ - 1) / kBQ, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, int bhkv, cudaStream_t stream) {
  constexpr int BKV = 64;
  constexpr size_t smem = dkv_smem_bytes<D, BKV>();
  auto kernel = flash_dkv_kernel<T, D, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lk + BKV - 1) / BKV, bhkv);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int d, int which, int bhkv,
                     cudaStream_t st) {
  switch (d) {
    case 16: return which ? launch_dkv<T, 16>(a, bhkv, st) : launch_dq<T, 16>(a, st);
    case 32: return which ? launch_dkv<T, 32>(a, bhkv, st) : launch_dq<T, 32>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dsum, void* o0,
        void* o1, const void* doc, int is_bf16, int bh, int bhkv, int lq,
        int lk, int d, int q_off_lo, int q_off_hi, int k_off_lo,
        int k_off_hi, int kv_valid, int q_seg, int k_seg, int causal,
        int window, float softcap, float scale, int packed, int doc_skip,
        int doc_rows, void* stream) {
  if (!is_bf16 || bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || lq <= 0 ||
      lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = which ? nullptr : o0;
  a.dk = which ? o0 : nullptr;
  a.dv = which ? o1 : nullptr;
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
  return (int)dispatch<__nv_bfloat16>(a, d, which, bhkv, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 = launched); is_bf16 must
// be 1 and d 16 or 32.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* dsum,
                 void* dq, const void* doc, int is_bf16, int bh, int bhkv,
                 int lq, int lk, int d, int q_off_lo, int q_off_hi,
                 int k_off_lo, int k_off_hi, int kv_valid, int q_seg,
                 int k_seg, int causal, int window, float softcap,
                 float scale, int packed, int doc_skip, int doc_rows,
                 void* stream) {
  return run(0, q, k, v, dout, lse, dsum, dq, nullptr, doc, is_bf16, bh,
             bhkv, lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi,
             kv_valid, q_seg, k_seg, causal, window, softcap, scale, packed,
             doc_skip, doc_rows, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dsum,
                  void* dk, void* dv, const void* doc, int is_bf16, int bh,
                  int bhkv, int lq, int lk, int d, int q_off_lo,
                  int q_off_hi, int k_off_lo, int k_off_hi, int kv_valid,
                  int q_seg, int k_seg, int causal, int window,
                  float softcap, float scale, int packed, int doc_skip,
                  int doc_rows, void* stream) {
  return run(1, q, k, v, dout, lse, dsum, dk, dv, doc, is_bf16, bh, bhkv,
             lq, lk, d, q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid,
             q_seg, k_seg, causal, window, softcap, scale, packed, doc_skip,
             doc_rows, stream);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
