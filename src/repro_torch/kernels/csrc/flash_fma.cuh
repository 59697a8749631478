// The flash-attention kernels on fp32 FMA, written by hand in CUDA C++ for
// Hopper (sm_90a): the forward, the dq and the dk/dv kernel as templates
// over the operand type and the head dim.  Three sources instantiate them,
// all for fp32 operands (bf16 runs on the tensor cores at every head dim):
// csrc/flash_fwd.cu the forward at D <= 128 (the ``"fma"`` route),
// csrc/flash_fwd_wide.cu and csrc/flash_bwd_wide.cu all three above it
// (the ``"wide"`` route).  Each source's header says which widths it
// builds; the kernels are the same code.
//
// They replace src/repro/kernels/flash_attention.py::_fwd_kernel,
// ::_dq_kernel and ::_dkv_kernel (the Pallas TPU kernels launched by
// ``_fwd`` and ``_bwd``).  Same function, same folded layout:
//   q, do (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) in fp32, heads folded
//   major-to-minor; GQA: q row b reads KV row b / group.
//   forward: out (B*Hq, Lq, D) in q's type, lse (B*Hq, Lq) fp32; rows that
//   see no key give out = 0 and lse = -1e30.
//   backward: lse and dsum = rowsum(dO * O) (B*Hq, Lq) fp32 in; P =
//   exp(s - lse) on visible keys (a row whose lse is -1e30 uses shift 0
//   and sees no key, so it gives dq = 0 and adds nothing to dk/dv);
//   dS = P * (dO.V^T - dsum), times (1 - (s_c/cap)^2) under a softcap,
//   times the scale; dq = dS.K, dk = dS^T.Q, dv = P^T.dO, dq in q's type,
//   dk/dv in k's type.
//   Mask: kj < kv_valid; causal k_log <= q_log; window
//   k_log >= q_log - (window - 1); packed k_log >= doc[row].  Logical
//   positions come from the five band ints plus q_seg / k_seg (the
//   BandMask contract of docs/KERNELS.md).  They arrive as plain kernel
//   arguments, so a new ring offset never needs a rebuild.
//
// Design.  The TPU kernels keep a sequential grid axis and carry their
// state in VMEM scratch; CUDA blocks carry nothing between them, so each
// block loops over the tiles it reduces over itself.
//   forward: one block per (64-row q tile, B*Hq row) walks the K tiles,
//            carrying the online-softmax state (m, l, acc in fp32) in
//            registers.
//   dq:      one block per (q tile, B*Hq row) walks every K tile,
//            recomputes s and P and accumulates dS.K in registers.
//   dk/dv:   one block per (key tile, B*Hkv row) walks all group * nq q
//            tiles of the query heads that share this KV head (q row
//            b*group + g/nq, q tile g%nq), so the group sum happens in the
//            block's fp32 registers: no atomics (the result is
//            deterministic) and no K/V expanded by the group size.
// A tile wholly outside the mask is skipped with the predicate of
// ``_run_predicate`` (kv_valid, causal, window, and doc_skip for packed
// documents).  Tiles are staged in shared memory as fp32, and the products
// are plain FMA loops (no tensor cores, no TF32), so fp32 inputs keep full
// fp32 math.
// 256 threads as 16 x 16: thread (ty, tx) owns a few rows (q rows, or keys
// in dk/dv) and, for those rows, the score columns tx + 16*j and the
// output columns tx + 16*c; a row's 16 owners are one half-warp, so the
// forward's row max and row sum are half-warp shuffles.  Rows are padded to
// D + 1 floats, so the column walks hit 16 distinct banks.
//
// Tiles.  Each thread holds D/16 output columns of each of its rows, so the
// registers grow with D, and each fp32 staging tile holds (rows) x (D + 1)
// floats, so the shared memory does.  Up to D = 128 the backward keeps
// 64-row tiles.  Above it (the wide route, up to D = 384) its q and key
// tiles shrink to 32 rows, so that its four staging tiles fit the 227 KB
// a block may hold: dq 201,344 bytes and dk/dv 206,080 at D = 384 (dq
// with 64-row q tiles and 32-key tiles would need 230,400 at D = 288 and
// 304,128 at D = 384).  The forward keeps 64 q rows and 32 keys a tile at
// D >= 128: 156,288 bytes at D = 288, 205,440 at D = 384.  Every block
// takes its shared memory above 48 KB by the opt-in attribute.
//
// What bounds it on an H100.  Compute: the forward is two products of
// 2*Lq*Lk*D FLOPs, dq three (s, dP and dS.K), dk/dv four (s, dP, P^T.dO,
// dS^T.Q), halved for causal, against 989 TFLOP/s of bf16 tensor-core
// throughput; the bytes are far below that line at training lengths.  This
// simple design runs on the fp32 CUDA cores (about 67 TFLOP/s at best) and
// reads its operands from shared memory for every FMA, so it sits well
// above that bound; its times stand in PERF.md.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace flash_fma {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kDocAbsent = 0x7fffffff;
constexpr int kBQ = 64;          // q rows per forward block

// The forward's arguments and the backward's: the data pointers, then the
// shape and mask fields both share.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                    // (B*Hq, Lq)
  const int* doc;                // (B, Lq) per-row doc start, or null
  int bh, group, lq, lk, q_mult;
  int q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid, q_seg, k_seg;
  int causal, window, packed, doc_skip;   // window < 0: no window
  float softcap, scale;
};

struct BwdArgs {
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

// Checks the C entries' shape and mask arguments and fills ``a`` with them;
// false if they do not fit.  The caller sets the data pointers.
template <typename Args>
bool fill_args(Args& a, const void* doc, int bh, int bhkv, int lq, int lk,
               int q_off_lo, int q_off_hi, int k_off_lo, int k_off_hi,
               int kv_valid, int q_seg, int k_seg, int causal, int window,
               float softcap, float scale, int packed, int doc_skip,
               int doc_rows) {
  if (bh <= 0 || bhkv <= 0 || bh % bhkv != 0 || lq <= 0 || lk <= 0 ||
      (packed && (doc == nullptr || doc_rows <= 0 || bh % doc_rows != 0)))
    return false;
  a = Args{};
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
  return true;
}

__device__ __forceinline__ int logical_pos(int idx, int lo, int hi, int seg) {
  return seg == 0 ? idx + hi : idx + (idx < seg ? lo : hi);
}

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// ``_run_predicate`` at tile edges.  Logical positions are nondecreasing in
// the physical index, so a tile's extrema sit at its edges; the doc-start
// table is nondecreasing too, so a q tile's smallest doc start is its first
// row's (``doc_first``).
__device__ __forceinline__ bool tile_runs(const BwdArgs& a, int q0, int bq,
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
__device__ __forceinline__ bool visible(const BwdArgs& a, int row, int qlog,
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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D, int BK>
constexpr size_t fwd_smem_bytes() {
  // sQ (BQ x D+1), sK (BK x D+1), sV (BK x D), sP (BQ x BK+1), fp32.
  return sizeof(float) *
         (kBQ * (D + 1) + BK * (D + 1) + BK * D + kBQ * (BK + 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  constexpr int QS = D + 1;      // padded stride: column walks hit distinct banks
  constexpr int PS = BK + 1;
  constexpr int SC = BK / 16;    // score columns per thread
  constexpr int OC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y;
  const int bkv = b / a.group;
  const T* qp = static_cast<const T*>(a.q) + (size_t)b * a.lq * D;
  const T* kp = static_cast<const T*>(a.k) + (size_t)bkv * a.lk * D;
  const T* vp = static_cast<const T*>(a.v) + (size_t)bkv * a.lk * D;
  const int* docp =
      a.packed ? a.doc + (size_t)(b / a.q_mult) * a.lq : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    sQ[r * QS + c] = row < a.lq ? to_float(qp[(size_t)row * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][OC];
  int qlog[4], qdoc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
    qlog[i] = logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);
    qdoc[i] = (a.packed && row < a.lq) ? docp[row] : kDocAbsent;
  }

  // Whole-tile skip bounds (``tile_runs`` of the backward, with the q
  // tile's edges hoisted out of the K loop).
  const int q_log_first = logical_pos(q0, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int q_log_last =
      logical_pos(q0 + kBQ - 1, a.q_off_lo, a.q_off_hi, a.q_seg);
  const int doc_first = a.packed ? docp[q0] : 0;
  const int kv_end = min(a.kv_valid, a.lk);
  const int nk = (a.lk + BK - 1) / BK;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const int k_log_first = logical_pos(k0, a.k_off_lo, a.k_off_hi, a.k_seg);
    const int k_log_last =
        logical_pos(k0 + BK - 1, a.k_off_lo, a.k_off_hi, a.k_seg);
    bool run = k0 < a.kv_valid;
    if (a.causal) run = run && k_log_first <= q_log_last;
    if (a.window >= 0) run = run && k_log_last >= q_log_first - (a.window - 1);
    if (a.packed && a.doc_skip) run = run && k_log_last >= doc_first;
    if (!run) continue;            // uniform over the block

    __syncthreads();               // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D, col = k0 + r;
      const bool in = col < a.lk;
      sK[r * QS + c] = in ? to_float(kp[(size_t)col * D + c]) : 0.f;
      sV[r * D + c] = in ? to_float(vp[(size_t)col * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool vis[SC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = col < kv_end;
        if (a.causal || a.window >= 0) {
          const int kl = logical_pos(col, a.k_off_lo, a.k_off_hi, a.k_seg);
          if (a.causal) ok = ok && kl <= qlog[i];
          if (a.packed) ok = ok && kl >= qdoc[i];
          if (a.window >= 0) ok = ok && kl >= qlog[i] - (a.window - 1);
        }
        vis[j] = ok;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // Rows masked so far keep shift 0, so no exp of an infinity.
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = vis[j] ? expf(s[i][j] - shift) : 0.f;
        rs += p;
        sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - shift);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();               // P complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* op = static_cast<T*>(a.out) + (size_t)b * a.lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.lq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < OC; ++c)
      op[(size_t)row * D + tx + 16 * c] = from_float<T>(acc[i][c] / l_safe);
    if (tx == 0) {
      const float shift = m[i] <= kNegInf / 2 ? 0.f : m[i];
      a.lse[(size_t)b * a.lq + row] =
          l[i] == 0.f ? kNegInf : shift + logf(l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  constexpr int BK = D >= 128 ? 32 : 64;
  constexpr size_t smem = fwd_smem_bytes<D, BK>();
  auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + kBQ - 1) / kBQ, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Rows of the backward's q and key tiles at head dim D (see "Tiles" above).
template <int D>
constexpr int bwd_tile() { return D > 128 ? 32 : 64; }

// (p, ds) of one score from the raw product q.k, the row's shift and dsum,
// and dO.v.
__device__ __forceinline__ void p_ds(const BwdArgs& a, bool vis, float qk,
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

template <int D, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  // sQ, sDO (BQ x D+1), sK, sV (BK x D+1), sDS (BQ x BK+1), fp32.
  return sizeof(float) *
         (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  constexpr int QS = D + 1;      // padded stride: column walks hit distinct banks
  constexpr int PS = BK + 1;
  constexpr int RQ = BQ / 16;    // q rows per thread
  constexpr int SC = BK / 16;    // score columns per thread
  constexpr int OC = D / 16;     // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * QS;
  float* sK = sDO + BQ * QS;
  float* sV = sK + BK * QS;
  float* sDS = sV + BK * QS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int bkv = b / a.group;
  const T* qp = static_cast<const T*>(a.q) + (size_t)b * a.lq * D;
  const T* dop = static_cast<const T*>(a.dout) + (size_t)b * a.lq * D;
  const T* kp = static_cast<const T*>(a.k) + (size_t)bkv * a.lk * D;
  const T* vp = static_cast<const T*>(a.v) + (size_t)bkv * a.lk * D;
  const int* docp =
      a.packed ? a.doc + (size_t)(b / a.q_mult) * a.lq : nullptr;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    const bool in = row < a.lq;
    sQ[r * QS + c] = in ? to_float(qp[(size_t)row * D + c]) : 0.f;
    sDO[r * QS + c] = in ? to_float(dop[(size_t)row * D + c]) : 0.f;
  }

  float acc[RQ][OC], shift[RQ], dsum[RQ];
  int rows[RQ], qlog[RQ], qdoc[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
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
    if (!tile_runs(a, q0, BQ, k0, BK, doc_first)) continue;  // block-uniform

    __syncthreads();               // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D, col = k0 + r;
      const bool in = col < a.lk;
      sK[r * QS + c] = in ? to_float(kp[(size_t)col * D + c]) : 0.f;
      sV[r * QS + c] = in ? to_float(vp[(size_t)col * D + c]) : 0.f;
    }
    __syncthreads();

    // s = Q.K^T and dP = dO.V^T for this thread's RQ rows x SC columns.
    float s[RQ][SC], dp[RQ][SC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], dov[RQ], kv[SC], vv[SC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = sQ[(ty * RQ + i) * QS + d];
        dov[i] = sDO[(ty * RQ + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        kv[j] = sK[(tx + 16 * j) * QS + d];
        vv[j] = sV[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = k0 + tx + 16 * j;
        float p, ds;
        p_ds(a, visible(a, rows[i], qlog[i], qdoc[i], col), s[i][j],
             shift[i], dsum[i], dp[i][j], p, ds);
        sDS[(ty * RQ + i) * PS + tx + 16 * j] = ds;
      }
    __syncthreads();               // dS complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ], kv[OC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = sDS[(ty * RQ + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) kv[c] = sK[kk * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dqp = static_cast<T*>(a.dq) + (size_t)b * a.lq * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    if (rows[i] >= a.lq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      dqp[(size_t)rows[i] * D + tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

template <int D, int BKV, int BQ>
constexpr size_t dkv_smem_bytes() {
  // sK, sV (BKV x D+1), sQ, sDO (BQ x D+1), sP, sDS (BKV x BQ+1), and the
  // q tile's shift, dsum, logical positions and doc starts.
  return sizeof(float) * (2 * BKV * (D + 1) + 2 * BQ * (D + 1) +
                          2 * BKV * (BQ + 1) + 4 * BQ);
}

template <typename T, int D, int BKV, int BQ>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
  constexpr int QS = D + 1;
  constexpr int PS = BQ + 1;
  constexpr int KR = BKV / 16;   // keys per thread
  constexpr int QC = BQ / 16;    // q columns per thread in the score tile
  constexpr int OC = D / 16;     // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BKV * QS;
  float* sQ = sV + BKV * QS;
  float* sDO = sQ + BQ * QS;
  float* sP = sDO + BQ * QS;
  float* sDS = sP + BKV * PS;
  float* sShift = sDS + BKV * PS;
  float* sDsum = sShift + BQ;
  int* sQlog = reinterpret_cast<int*>(sDsum + BQ);
  int* sQdoc = sQlog + BQ;

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

  const int nq = (a.lq + BQ - 1) / BQ;
  for (int g = 0; g < a.group * nq; ++g) {
    const int b = bkv * a.group + g / nq;      // folded q row
    const int q0 = (g % nq) * BQ;
    const int* docp =
        a.packed ? a.doc + (size_t)(b / a.q_mult) * a.lq : nullptr;
    const int doc_first = a.packed ? docp[q0] : 0;
    if (!tile_runs(a, q0, BQ, k0, BKV, doc_first)) continue;

    const T* qp = static_cast<const T*>(a.q) + (size_t)b * a.lq * D;
    const T* dop = static_cast<const T*>(a.dout) + (size_t)b * a.lq * D;
    __syncthreads();               // the previous q tile is no longer read
    for (int i = tid; i < BQ * D; i += kThreads) {
      const int r = i / D, c = i % D, row = q0 + r;
      const bool in = row < a.lq;
      sQ[r * QS + c] = in ? to_float(qp[(size_t)row * D + c]) : 0.f;
      sDO[r * QS + c] = in ? to_float(dop[(size_t)row * D + c]) : 0.f;
    }
    if (tid < BQ) {
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
    for (int r = 0; r < BQ; ++r) {
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

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr int BQ = bwd_tile<D>(), BK = bwd_tile<D>();
  constexpr size_t smem = dq_smem_bytes<D, BQ, BK>();
  auto kernel = flash_dq_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + BQ - 1) / BQ, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  constexpr int BKV = bwd_tile<D>(), BQ = bwd_tile<D>();
  constexpr size_t smem = dkv_smem_bytes<D, BKV, BQ>();
  auto kernel = flash_dkv_kernel<T, D, BKV, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lk + BKV - 1) / BKV, a.bh / a.group);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace flash_fma
