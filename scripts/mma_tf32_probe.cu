// A probe of the rate the warp-level TF32 tensor-core instruction
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32) sustains on the
// card: every warp issues ``iters`` rounds of kChains independent products
// on register operands, with no memory traffic in the loop.  Built and timed
// by scripts/mma_tf32_probe.py; the ceiling it finds stands beside the
// 3xTF32 backward kernels' bound (csrc/flash_bwd_tf32x3.cu) in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;       // independent accumulators a warp

__global__ void mma_tf32_probe_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm("cvt.rna.tf32.f32 %0, %1;\n"
        : "=r"(a[i]) : "f"(1.f + 1e-3f * (threadIdx.x + i)));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    asm("cvt.rna.tf32.f32 %0, %1;\n"
        : "=r"(b[i]) : "f"(1e-6f * (threadIdx.x + i)));
  float d[kChains][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[c][i] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

extern "C" {

// FLOPs of one launch: blocks * threads / 32 warps, each iters * kChains
// products of 2 * 16 * 8 * 8.
double mma_tf32_probe_flops(int blocks, int threads, int iters) {
  return 2.0 * 16 * 8 * 8 * kChains * static_cast<double>(iters) * blocks *
         (threads / 32);
}

// Launches the probe on ``stream``; ``out`` holds blocks * threads floats.
// Returns the cudaError_t of the launch.
int mma_tf32_probe(float* out, int blocks, int threads, int iters,
                   void* stream) {
  mma_tf32_probe_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
