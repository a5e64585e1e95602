// SAM2 MultiKernelRefinement head: four 1→4-channel convolutions with
// k = 3, 5, 7 and 11 (SAME zero padding), exact GELU, and a 1×1
// combiner from 16 channels to 1, over the full-resolution logit map.
//
// Replaces the Pallas kernel `refinement_fused` of the JAX package
// (circuitvision_tpu/ops/pallas/refinement_fused.py). What bounds it on
// the H100: 2·4·(9+25+49+121) + 16 ≈ 1.7 kFLOP of f32 per pixel against
// 6 bytes (bf16 in, f32 out) — about 280 FLOP/byte, far above the f32
// ridge (67 TFLOP/s ÷ 3.35 TB/s ≈ 20), so the FMAs bound it. The design
// reads each logit from device memory once: a block stages its 32×8
// output tile plus the 5-pixel halo in shared memory, with the 833
// weights beside it, and each thread computes one output pixel with the
// sixteen channel sums in registers; no intermediate leaves the SM.
// erff gives the exact GELU (the Pallas kernel needed a polynomial only
// because Mosaic lowers no erf).
#include "common.cuh"

namespace {

using namespace cvk;

constexpr int kTx = 32, kTy = 8, kHalo = 5;
constexpr int kNw = 4 * (9 + 25 + 49 + 121);  // branch weights
constexpr int kSx = kTx + 2 * kHalo, kSy = kTy + 2 * kHalo;

template <int K>
__device__ __forceinline__ float branch(const float (*tile)[kSx],
                                        const float* w, const float* b,
                                        const float* wc, int tx, int ty) {
  constexpr int r = K / 2;
  float acc[4] = {b[0], b[1], b[2], b[3]};
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float v = tile[ty + kHalo - r + dy][tx + kHalo - r + dx];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += w[(c * K + dy) * K + dx] * v;
    }
  }
  float out = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) out += wc[c] * gelu_erf(acc[c]);
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
refinement_kernel(const T* __restrict__ x, const T* __restrict__ w3,
                  const T* __restrict__ b3, const T* __restrict__ w5,
                  const T* __restrict__ b5, const T* __restrict__ w7,
                  const T* __restrict__ b7, const T* __restrict__ w11,
                  const T* __restrict__ b11, const T* __restrict__ wc,
                  const T* __restrict__ bc, float* __restrict__ out, int h,
                  int w) {
  __shared__ float tile[kSy][kSx];
  __shared__ float wts[kNw + 16 + 16 + 1];
  const int tid = threadIdx.y * kTx + threadIdx.x;
  const int nthreads = kTx * kTy;
  const T* srcs[4] = {w3, w5, w7, w11};
  const int sizes[4] = {9, 25, 49, 121};
  int off = 0;
  for (int i = 0; i < 4; ++i) {
    for (int e = tid; e < 4 * sizes[i]; e += nthreads) wts[off + e] = to_f(srcs[i][e]);
    off += 4 * sizes[i];
  }
  const T* bs[4] = {b3, b5, b7, b11};
  if (tid < 16) wts[kNw + tid] = to_f(bs[tid / 4][tid % 4]);
  if (tid < 16) wts[kNw + 16 + tid] = to_f(wc[tid]);
  if (tid == 0) wts[kNw + 32] = to_f(bc[0]);

  const int img = blockIdx.z;
  const int x0 = blockIdx.x * kTx - kHalo, y0 = blockIdx.y * kTy - kHalo;
  const T* xi = x + (size_t)img * h * w;
  for (int e = tid; e < kSx * kSy; e += nthreads) {
    int yy = y0 + e / kSx, xx = x0 + e % kSx;
    tile[e / kSx][e % kSx] =
        (yy >= 0 && yy < h && xx >= 0 && xx < w) ? to_f(xi[(size_t)yy * w + xx]) : 0.f;
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = blockIdx.x * kTx + tx, oy = blockIdx.y * kTy + ty;
  if (ox >= w || oy >= h) return;
  const float* bias = wts + kNw;
  const float* comb = wts + kNw + 16;
  float y = wts[kNw + 32];
  y += branch<3>(tile, wts, bias, comb, tx, ty);
  y += branch<5>(tile, wts + 36, bias + 4, comb + 4, tx, ty);
  y += branch<7>(tile, wts + 136, bias + 8, comb + 8, tx, ty);
  y += branch<11>(tile, wts + 332, bias + 12, comb + 12, tx, ty);
  out[(size_t)img * h * w + (size_t)oy * w + ox] = y;
}

template <typename T>
cudaError_t launch(const void* x, const void* const* p, void* out, int b,
                   int h, int w, cudaStream_t stream) {
  dim3 block(kTx, kTy);
  dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy, b);
  refinement_kernel<T><<<grid, block, 0, stream>>>(
      (const T*)x, (const T*)p[0], (const T*)p[1], (const T*)p[2],
      (const T*)p[3], (const T*)p[4], (const T*)p[5], (const T*)p[6],
      (const T*)p[7], (const T*)p[8], (const T*)p[9], (float*)out, h, w);
  return cudaGetLastError();
}

}  // namespace

// x: (b, h, w) logits; branch weights in torch Conv2d layout (4, 1, k, k)
// for k = 3, 5, 7, 11, biases (4,), combiner (1, 16, 1, 1) and (1,), all
// in x's dtype (0 = float32, 1 = bfloat16). out: (b, h, w) float32.
extern "C" int cv_refinement(const void* x, const void* w3, const void* b3,
                             const void* w5, const void* b5, const void* w7,
                             const void* b7, const void* w11, const void* b11,
                             const void* wc, const void* bc, void* out, int b,
                             int h, int w, int dtype, void* stream) {
  const void* p[10] = {w3, b3, w5, b5, w7, b7, w11, b11, wc, bc};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, p, out, b, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, p, out, b, h, w, s);
  return (int)cudaErrorInvalidValue;
}
