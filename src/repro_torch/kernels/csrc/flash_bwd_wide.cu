// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++:
// the wide route's dq and dk/dv kernels, for fp32 operands at head dims
// above 128 (padded to D in {192, 256, 288, 384} by ``ops._d_pad``;
// ``bwd_route``).  bf16 never takes it: it runs on the tensor cores at
// every one of those widths (csrc/flash_dq_sm90_wide.cu,
// csrc/flash_dkv_sm90_wide.cu, csrc/flash_bwd_sm90_d384.cu), and the C
// interface refuses it.
//
// Replaces src/repro/kernels/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels launched by ``_bwd``) at the widths the reference
// reaches by rounding D up to a multiple of 128: gemma2-2b's 288,
// gemma3-12b's 240 and deepseek-v2-lite MLA's 192.  The kernels are the FMA
// route's (csrc/flash_fma.cuh, which holds the layout, the design and what
// bounds them).  At these widths they run on 32-row q and key tiles: each
// thread holds D/16 columns of its two rows (dq: 36 fp32 at D = 288; dk/dv
// 72, dK and dV), and the four fp32 staging tiles take 201,344 bytes (dq)
// and 206,080 bytes (dk/dv) at D = 384, so one block runs on an SM.  dk/dv
// loops over all group * nq q tiles of its KV head, so the group sum stays
// in the block: no atomics, deterministic.  They keep full fp32 math (no
// TF32: the tf32x3 kernels already use 255 registers at D = 128) on the
// fp32 CUDA cores, far above the tensor-core bound.  Their times stand in
// PERF.md.

#include "flash_fma.cuh"

namespace {

cudaError_t dispatch(const flash_fma::BwdArgs& a, int d, int which,
                     cudaStream_t st) {
  switch (d) {
    case 192: return which ? flash_fma::launch_dkv<float, 192>(a, st)
                           : flash_fma::launch_dq<float, 192>(a, st);
    case 256: return which ? flash_fma::launch_dkv<float, 256>(a, st)
                           : flash_fma::launch_dq<float, 256>(a, st);
    case 288: return which ? flash_fma::launch_dkv<float, 288>(a, st)
                           : flash_fma::launch_dq<float, 288>(a, st);
    case 384: return which ? flash_fma::launch_dkv<float, 384>(a, st)
                           : flash_fma::launch_dq<float, 384>(a, st);
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
  if (is_bf16 ||
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(a, d, which, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 = launched).  The arguments
// are every backward source's (csrc/flash_bwd_sm90.cu's entry points);
// is_bf16 must be 0.
int flash_bwd_dq_wide(const void* q, const void* k, const void* v,
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

int flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
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

const char* flash_bwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
