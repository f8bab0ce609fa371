// Tensor-core rate of mma.sync on this card, for sm_90a.
//
// A measurement, not a kernel of the port: every warp of a full grid issues
// ACC independent mma.sync per iteration on registers, with no memory
// traffic, so the time is the tensor pipe's (or, at ACC = 1, the latency of
// one dependent mma). The attention kernel (attention.cu) issues
// mma.sync.m16n8k8 TF32; the f16 shape is the yardstick for the TF32 one.

#include <cuda_runtime.h>

namespace {

template <int ACC, bool TF32>
__global__ void mma_loop(float* sink, int iters) {
  const unsigned x = threadIdx.x * 0x9e3779b9u;
  const unsigned a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  const unsigned b0 = x * 3u, b1 = x * 5u;
  float c[ACC][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1.2345f) sink[threadIdx.x] = s;  // keeps the products alive
}

}  // namespace

// Milliseconds of one launch (the second of two) of `blocks` blocks of
// `threads` threads, each warp issuing acc (1 or 8) independent mma.sync per
// iteration: m16n8k8 TF32 when tf32, else m16n8k16 f16.
extern "C" int prt_mma_rate(int tf32, int acc, int blocks, int threads,
                            int iters, float* sink, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (tf32 && acc == 8) mma_loop<8, true><<<blocks, threads>>>(sink, iters);
    else if (tf32) mma_loop<1, true><<<blocks, threads>>>(sink, iters);
    else if (acc == 8) mma_loop<8, false><<<blocks, threads>>>(sink, iters);
    else mma_loop<1, false><<<blocks, threads>>>(sink, iters);
    cudaEventRecord(e1);
  }
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
