// Row-wise LayerNorm of the Hiera trunk, alone and after the residual add.
//
// Replaces the Pallas kernels `fused_layernorm` and `fused_add_layernorm`
// of the JAX package (circuitvision_tpu/ops/pallas/fused_ln.py):
//
//   cv_fused_layernorm:     y = LN(x)
//   cv_fused_add_layernorm: r = a + b rounded to the input dtype,
//                           y = LN(r); both written
//
// with f32 statistics in the fast-variance form E[x²]−mean² clamped at 0
// (common.cuh: warp_ln_stats), the affine in f32 with float32 scale and
// bias, and y rounded to the input dtype. What bounds it on the H100: a
// LayerNorm does ~8 operations per element against 4 (bf16) to 8 (f32)
// bytes moved, so the memory, not the arithmetic, is the limit. One warp
// owns one row: it sums the row in one pass and normalises it in a second,
// which finds the row (at most 4.5 KB) in L1/L2, so device memory sees
// each input once and each output once. Eight warps per block, rows
// spread over the grid. No shared memory and no atomics: a row's
// statistics never leave its warp, so the result does not depend on the
// launch shape.
#include "common.cuh"

namespace {

using namespace cvk;

constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out, int t,
                 int c, float eps) {
  const int lane = threadIdx.x % 32;
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < t;
       r += gridDim.x * kWarps) {
    const T* xr = x + (size_t)r * c;
    float2 st = warp_ln_stats([&](int i) { return to_f(xr[i]); }, c, eps);
    T* o = out + (size_t)r * c;
    for (int i = lane; i < c; i += 32)
      o[i] = from_f<T>((to_f(xr[i]) - st.x) * st.y * scale[i] + bias[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
add_layernorm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ resid,
                     T* __restrict__ out, int t, int c, float eps) {
  const int lane = threadIdx.x % 32;
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < t;
       r += gridDim.x * kWarps) {
    const size_t off = (size_t)r * c;
    // the sum is rounded to the input dtype before the statistics are
    // taken of it, as the Pallas kernel stores a + b first
    auto sum = [&](int i) { return rnd<T>(to_f(a[off + i]) + to_f(b[off + i])); };
    float2 st = warp_ln_stats(sum, c, eps);
    for (int i = lane; i < c; i += 32) {
      float v = sum(i);
      resid[off + i] = from_f<T>(v);
      out[off + i] = from_f<T>((v - st.x) * st.y * scale[i] + bias[i]);
    }
  }
}

int grid_for(int t) {
  int blocks = (t + kWarps - 1) / kWarps;
  return blocks < 65535 ? blocks : 65535;
}

template <typename T>
cudaError_t launch_ln(const void* x, const void* scale, const void* bias,
                      void* out, int t, int c, float eps, cudaStream_t s) {
  layernorm_kernel<T><<<grid_for(t), kThreads, 0, s>>>(
      (const T*)x, (const float*)scale, (const float*)bias, (T*)out, t, c, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_add_ln(const void* a, const void* b, const void* scale,
                          const void* bias, void* resid, void* out, int t,
                          int c, float eps, cudaStream_t s) {
  add_layernorm_kernel<T><<<grid_for(t), kThreads, 0, s>>>(
      (const T*)a, (const T*)b, (const float*)scale, (const float*)bias,
      (T*)resid, (T*)out, t, c, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x and out; scale and bias (c,)
// float32. x and out (t, c), contiguous.
extern "C" int cv_fused_layernorm(const void* x, const void* scale,
                                  const void* bias, void* out, int t, int c,
                                  float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 0) return 0;
  if (dtype == 0) return launch_ln<float>(x, scale, bias, out, t, c, eps, s);
  if (dtype == 1)
    return launch_ln<__nv_bfloat16>(x, scale, bias, out, t, c, eps, s);
  return (int)cudaErrorInvalidValue;
}

// As cv_fused_layernorm for a + b; writes the sum to `resid` as well.
extern "C" int cv_fused_add_layernorm(const void* a, const void* b,
                                      const void* scale, const void* bias,
                                      void* resid, void* out, int t, int c,
                                      float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 0) return 0;
  if (dtype == 0)
    return launch_add_ln<float>(a, b, scale, bias, resid, out, t, c, eps, s);
  if (dtype == 1)
    return launch_add_ln<__nv_bfloat16>(a, b, scale, bias, resid, out, t, c,
                                        eps, s);
  return (int)cudaErrorInvalidValue;
}
