// The flash-attention forward on fp32 FMA, written by hand in CUDA C++ for
// Hopper (sm_90a), as a template over the operand type and the head dim.
// Two sources instantiate it, for fp32 operands (bf16 runs on the tensor
// cores at every head dim): csrc/flash_fwd.cu at D <= 128 (the ``"fma"``
// route) and csrc/flash_fwd_wide.cu above it (the ``"wide"`` route).  The
// fp32 backward runs on the tensor cores in three TF32 passes
// (csrc/flash_bwd_tf32x3.cu, csrc/flash_bwd_tf32x3_wide.cu).
//
// It replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by ``_fwd``).  Same function, same folded layout:
//   q (B*Hq, Lq, D), k/v (B*Hkv, Lk, D) in fp32, heads folded
//   major-to-minor; GQA: q row b reads KV row b / group.  out (B*Hq, Lq,
//   D) in q's type, lse (B*Hq, Lq) fp32; rows that see no key give out = 0
//   and lse = -1e30.
//   Mask: kj < kv_valid; causal k_log <= q_log; window
//   k_log >= q_log - (window - 1); packed k_log >= doc[row].  Logical
//   positions come from the five band ints plus q_seg / k_seg (the
//   BandMask contract of docs/KERNELS.md).  They arrive as plain kernel
//   arguments, so a new ring offset never needs a rebuild.
//
// Design.  The TPU kernel keeps a sequential grid axis and carries its
// state in VMEM scratch; CUDA blocks carry nothing between them, so one
// block per (64-row q tile, B*Hq row) walks the K tiles itself, carrying
// the online-softmax state (m, l, acc in fp32) in registers.  A K tile
// wholly outside the mask is skipped with the predicate of
// ``_run_predicate`` (kv_valid, causal, window, and doc_skip for packed
// documents).  Tiles are staged in shared memory as fp32, and the products
// are plain FMA loops (no tensor cores, no TF32), so fp32 inputs keep full
// fp32 math.
// 256 threads as 16 x 16: thread (ty, tx) owns four q rows and, for those
// rows, the score columns tx + 16*j and the output columns tx + 16*c; a
// row's 16 owners are one half-warp, so the row max and row sum are
// half-warp shuffles.  Rows are padded to D + 1 floats, so the column
// walks hit 16 distinct banks.
//
// Tiles.  Each thread holds D/16 output columns of each of its rows, so the
// registers grow with D, and each fp32 staging tile holds (rows) x (D + 1)
// floats, so the shared memory does.  64 q rows and 64 keys a tile below D
// 128, 32 keys from D 128 on: 156,288 bytes at D = 288, 205,440 at D =
// 384.  Every block takes its shared memory above 48 KB by the opt-in
// attribute.
//
// What bounds it on an H100.  Compute: two products of 2*Lq*Lk*D FLOPs,
// halved for causal; the bytes are far below that line at training
// lengths.  This simple design runs on the fp32 CUDA cores (about 67
// TFLOP/s at best) and reads its operands from shared memory for every
// FMA, so it sits well above that bound; its times stand in PERF.md.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace flash_fma {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kDocAbsent = 0x7fffffff;
constexpr int kBQ = 64;          // q rows per forward block

// The forward's arguments: the data pointers, then the shape and mask
// fields.
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

}  // namespace flash_fma
