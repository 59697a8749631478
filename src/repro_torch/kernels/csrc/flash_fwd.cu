// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++:
// the FMA route, for fp32 operands at head dims up to 128 (full fp32 math).
// bf16 never takes it: at D = 16 and 32 it takes the tensor-core kernel of
// csrc/flash_fwd_sm90_narrow.cu, at D = 64 and 128 that of
// csrc/flash_fwd_sm90.cu; every head dim above 128 takes the wide route of
// csrc/flash_fwd_wide.cu (``fwd_route``).
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel launched by ``_fwd``).  The kernel, its layout, its design and what
// bounds it are in csrc/flash_fma.cuh, shared with the wide route; this
// source instantiates it at D in {16, 32, 64, 128} for fp32 and gives it
// its C interface, which refuses bf16.  Its times stand in PERF.md.

#include "flash_fma.cuh"

namespace {

cudaError_t dispatch_d(const flash_fma::FwdArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return flash_fma::launch_fwd<float, 16>(a, stream);
    case 32: return flash_fma::launch_fwd<float, 32>(a, stream);
    case 64: return flash_fma::launch_fwd<float, 64>(a, stream);
    case 128: return flash_fma::launch_fwd<float, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, const void* doc, int is_bf16, int bh, int bhkv,
              int lq, int lk, int d, int q_off_lo, int q_off_hi,
              int k_off_lo, int k_off_hi, int kv_valid, int q_seg, int k_seg,
              int causal, int window, float softcap, float scale, int packed,
              int doc_skip, int doc_rows, void* stream) {
  flash_fma::FwdArgs a;
  if (is_bf16 ||
      !flash_fma::fill_args(a, doc, bh, bhkv, lq, lk, q_off_lo, q_off_hi,
                            k_off_lo, k_off_hi, kv_valid, q_seg, k_seg,
                            causal, window, softcap, scale, packed, doc_skip,
                            doc_rows))
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch_d(a, d, st);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
