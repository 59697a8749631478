// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++:
// the dq kernel and the dk/dv kernel on fp32 FMA, for bf16 operands at
// D = 16 and 32 only.  bf16 at D = 64 and 128 takes the tensor-core kernels
// of csrc/flash_bwd_sm90.cu, fp32 at D <= 128 the 3xTF32 tensor-core
// kernels of csrc/flash_bwd_tf32x3.cu, and every head dim above 128 the
// wide route of csrc/flash_bwd_wide.cu; no route reaches this source with
// fp32 operands or another head dim, so it builds none.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels launched by ``_bwd``).  The kernels, their
// layout, their design (dq loops over K tiles; dk/dv over all group * nq q
// tiles of its KV head, so the group sum stays in the block: no atomics)
// and what bounds them are in csrc/flash_fma.cuh, shared with the wide
// route; here they run on 64-row tiles.  Their times stand in PERF.md.

#include "flash_fma.cuh"

namespace {

cudaError_t dispatch(const flash_fma::BwdArgs& a, int d, int which,
                     cudaStream_t st) {
  using T = __nv_bfloat16;
  switch (d) {
    case 16: return which ? flash_fma::launch_dkv<T, 16>(a, st)
                          : flash_fma::launch_dq<T, 16>(a, st);
    case 32: return which ? flash_fma::launch_dkv<T, 32>(a, st)
                          : flash_fma::launch_dq<T, 32>(a, st);
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
  flash_fma::BwdArgs a;
  if (!is_bf16 ||
      !flash_fma::fill_args(a, doc, bh, bhkv, lq, lk, q_off_lo, q_off_hi,
                            k_off_lo, k_off_hi, kv_valid, q_seg, k_seg,
                            causal, window, softcap, scale, packed, doc_skip,
                            doc_rows))
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = which ? nullptr : o0;
  a.dk = which ? o0 : nullptr;
  a.dv = which ? o1 : nullptr;
  return (int)dispatch(a, d, which, static_cast<cudaStream_t>(stream));
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
