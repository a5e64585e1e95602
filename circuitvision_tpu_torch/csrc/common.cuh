// Device helpers shared by the Hiera block kernels (mlp_block.cu,
// window_attn.cu, global_attn.cu): dtype conversion, a row-tile
// LayerNorm and a block-wide tiled product against a weight in torch
// Linear layout. Everything a block computes lives in shared memory
// as float32; values that the JAX kernels store in the compute dtype are
// rounded to it (`rnd`) at the same points, so bf16 results round where
// the reference's do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cvk {

constexpr int kThreads = 256;  // every block kernel runs 256 threads
constexpr int kRows = 16;      // row group of one block_gemm pass
constexpr int kTileN = 64;     // output columns per pass
constexpr int kTileK = 32;     // reduction depth per staged weight tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round a float32 value to the compute dtype T and back.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// LayerNorm statistics of one row of c values, by one warp: f32 sums of
// x and x² (lane-strided, then a butterfly), mean = Σx/n and
// rsqrt(var + eps) with var = Σx²/n − mean² clamped at 0 — flax's
// fast-variance form (fused_ln.py:27-32 and window_attn.py:40-46 in the
// JAX package). n is the row's true width `width`, or c where width is
// 0: a row zero-padded past its true width (a bf16 block whose width is
// off a multiple of 8) sums the same, and only the divisor differs.
// `load(i)` returns element i as float32. Every lane gets the result.
template <typename Load>
__device__ __forceinline__ float2 warp_ln_stats(Load load, int c, float eps, int width = 0) {
  const int lane = threadIdx.x % 32;
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < c; i += 32) {
    float v = load(i);
    s1 += v;
    s2 += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int n = width ? width : c;
  float mean = s1 / n;
  float var = fmaxf(s2 / n - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// LayerNorm of `rows` rows of `src` (row stride c) into `dst`, one warp
// per row: warp_ln_stats (divisor `width`, or c where it is 0), then
// (x−mean)·rsqrt(var+eps)·scale + bias rounded to T. scale and bias are
// float32 whatever T is, as flax keeps them (its parameters are float32
// under a bf16 compute dtype).
template <typename T>
__device__ void layernorm_rows(const float* src, float* dst, int rows, int c,
                               const float* scale, const float* bias, float eps,
                               int width = 0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float* x = src + (size_t)r * c;
    float2 st = warp_ln_stats([&](int i) { return x[i]; }, c, eps, width);
    for (int i = lane; i < c; i += 32)
      dst[(size_t)r * c + i] = rnd<T>((x[i] - st.x) * st.y * scale[i] + bias[i]);
  }
}

// out[r][n] = Σ_k A[r][k] · W[n][k] for r < rows (≤ kRows), n < n_cols,
// with A in shared memory (row stride lda) and W in global memory in
// torch Linear layout (row n at W + n·ldw). The accumulated f32 value is
// handed to epi(r, n, acc). Weight tiles are staged through `ws`
// (kTileK × (kTileN+1) floats) so the global reads run along k and are
// coalesced. Callers sync before reading what epi wrote.
template <typename T, typename Epi>
__device__ void block_gemm(const float* A, int lda, int rows, int k_dim,
                           const T* W, int ldw, int n_cols, float* ws,
                           Epi epi) {
  const int tid = threadIdx.x;
  const int tn = tid % kTileN;           // output column in the tile
  const int tr = tid / kTileN;           // row phase, 0..3
  constexpr int kPer = kRows / (kThreads / kTileN);  // rows per thread
  for (int n0 = 0; n0 < n_cols; n0 += kTileN) {
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += kTileK) {
      __syncthreads();
      for (int e = tid; e < kTileK * kTileN; e += kThreads) {
        int kk = e % kTileK, nn = e / kTileK;
        int n = n0 + nn, k = k0 + kk;
        ws[kk * (kTileN + 1) + nn] =
            (n < n_cols && k < k_dim) ? to_f(W[(size_t)n * ldw + k]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kTileK, k_dim - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float w = ws[kk * (kTileN + 1) + tn];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          int r = tr + i * (kThreads / kTileN);
          if (r < rows) acc[i] += A[(size_t)r * lda + k0 + kk] * w;
        }
      }
    }
    int n = n0 + tn;
    if (n < n_cols) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        int r = tr + i * (kThreads / kTileN);
        if (r < rows) epi(r, n, acc[i]);
      }
    }
  }
  __syncthreads();
}

}  // namespace cvk
