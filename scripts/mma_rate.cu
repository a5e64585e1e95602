// The card's rate of warp-level tensor-core products, mma.sync
// m16n8k8 .tf32 (the float32 kernels' 3×TF32 GEMM, csrc/tf32.cuh) and
// m16n8k16 .bf16, at 4 to 32 warps an SM: each warp runs rounds of 8
// independent products into 8 accumulators, register operands only, so
// the figure is the instruction's own ceiling. Needs nvcc and a card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate scripts/mma_rate.cu && ./mma_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void bench(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 1024 * 4);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int kind = 0; kind < 2; ++kind)
    for (int warps : {4, 8, 16, 32}) {
      int iters = 4096, blocks = 132 * 4, threads = warps * 32 / 4;
      auto k = kind == 0 ? bench<0> : bench<1>;
      k<<<blocks, threads>>>(out, iters);
      cudaEventRecord(e0);
      k<<<blocks, threads>>>(out, iters);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double flops = (double)blocks * (threads / 32) * iters * 8 * (kind == 0 ? 2048.0 : 4096.0);
      printf("%s warps/SM=%d: %.1f TFLOP/s\n", kind == 0 ? "mma tf32 m16n8k8" : "mma bf16 m16n8k16", warps, flops / ms / 1e9);
    }
  return 0;
}
