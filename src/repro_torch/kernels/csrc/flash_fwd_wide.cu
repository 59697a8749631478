// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++:
// the wide route, for fp32 operands at head dims above 128 (padded to D in
// {192, 256, 288, 384} by ``ops._d_pad``; ``fwd_route``).  bf16 never takes
// it: it runs on the tensor cores at every one of those widths
// (csrc/flash_fwd_sm90_wide.cu, csrc/flash_fwd_sm90_d384.cu), and the C
// interface refuses it.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel launched by ``_fwd``) at the widths the reference reaches by
// rounding D up to a multiple of 128: gemma2-2b's 288, gemma3-12b's 240 and
// deepseek-v2-lite MLA's 192.  The kernel is the FMA route's
// (csrc/flash_fma.cuh, which holds the layout, the design and what bounds
// it), here at 64 q rows and 32 keys a tile: each thread holds D/16 output
// columns of its four rows (72 fp32 at D = 288) and the block stages
// 156,288 bytes of fp32 tiles at D = 288 (205,440 at D = 384), so one block
// runs on an SM.  It keeps full fp32 math on the fp32 CUDA cores, far
// above the tensor-core bound.  Its times stand in PERF.md.

#include "flash_fma.cuh"

namespace {

cudaError_t dispatch_d(const flash_fma::FwdArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 192: return flash_fma::launch_fwd<float, 192>(a, stream);
    case 256: return flash_fma::launch_fwd<float, 256>(a, stream);
    case 288: return flash_fma::launch_fwd<float, 288>(a, stream);
    case 384: return flash_fma::launch_fwd<float, 384>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  The arguments are
// those of csrc/flash_fwd.cu's ``flash_fwd``.
int flash_fwd_wide(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* doc, int is_bf16, int bh, int bhkv,
                   int lq, int lk, int d, int q_off_lo, int q_off_hi,
                   int k_off_lo, int k_off_hi, int kv_valid, int q_seg,
                   int k_seg, int causal, int window, float softcap,
                   float scale, int packed, int doc_skip, int doc_rows,
                   void* stream) {
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

const char* flash_fwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
