// Hiera MLP half, out = x + W1·GELU_erf(W0·LN2(x) + b0) + b1, over rows.
//
// Replaces the Pallas kernel `mlp_block` of the JAX package
// (circuitvision_tpu/ops/pallas/mlp_block.py). What bounds it on the
// H100: 16·T·C² FLOPs against 4·T·C bytes of activations, about 4·C
// FLOP/byte — 384 to 3072 at the slice's widths (C = 96 … 768), so the
// products, not the memory, are the limit. This first version spends them
// on plain f32 FMAs: one block per 16-row tile keeps the row tile's
// LayerNorm output and the f32 accumulator in shared memory for the whole
// hidden dimension, which it walks in 64-wide chunks — the hidden
// activation never reaches device memory, as in the Pallas kernel. The
// weights stream through a staged tile per chunk (block_gemm). Where the
// row tiles alone would leave most SMs idle (T ≤ 4096 at the slice's
// deep stages), the hidden dimension is also split across blocks: each
// writes its f32 partial sum to a workspace, and a second pass adds the
// partials in split order to x + b1 — deterministic, no atomics.
// Tensor cores (wgmma) are the next step.
#include <algorithm>

#include "common.cuh"

namespace {

using namespace cvk;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const T* __restrict__ w0,
                 const T* __restrict__ b0, const T* __restrict__ w1,
                 const T* __restrict__ b1, T* __restrict__ out,
                 float* __restrict__ partial, int t, int c, int hidden,
                 int split_len, float eps) {
  extern __shared__ float smem[];
  float* acc = smem;                    // kRows × c
  float* xn = acc + kRows * c;          // kRows × c
  float* h = xn + kRows * c;            // kRows × kTileN
  float* ws = h + kRows * kTileN;       // kTileK × (kTileN + 1)
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, t - r0);
  const int j_begin = blockIdx.y * split_len;
  const int j_end = min(hidden, j_begin + split_len);
  const bool whole = gridDim.y == 1;
  const T* xb = x + (size_t)r0 * c;

  for (int e = threadIdx.x; e < rows * c; e += kThreads) acc[e] = to_f(xb[e]);
  __syncthreads();
  layernorm_rows<T>(acc, xn, rows, c, ln_s, ln_b, eps);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * c; e += kThreads)
    acc[e] = whole ? acc[e] + to_f(b1[e % c]) : 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTileN) {
    const int hc = min(kTileN, j_end - j0);
    block_gemm<T>(xn, c, rows, c, w0 + (size_t)j0 * c, c, hc, ws,
                  [&](int r, int n, float v) {
                    h[r * kTileN + n] = rnd<T>(gelu_erf(v + to_f(b0[j0 + n])));
                  });
    block_gemm<T>(h, kTileN, rows, hc, w1 + j0, hidden, c, ws,
                  [&](int r, int n, float v) { acc[r * c + n] += v; });
  }
  if (whole) {
    T* ob = out + (size_t)r0 * c;
    for (int e = threadIdx.x; e < rows * c; e += kThreads) ob[e] = from_f<T>(acc[e]);
  } else {
    float* pb = partial + ((size_t)blockIdx.y * t + r0) * c;
    for (int e = threadIdx.x; e < rows * c; e += kThreads) pb[e] = acc[e];
  }
}

// out = x + b1 + Σ_s partial[s], summed in split order.
template <typename T>
__global__ void mlp_reduce_kernel(const T* __restrict__ x, const T* __restrict__ b1,
                                  const float* __restrict__ partial,
                                  T* __restrict__ out, int t, int c, int splits) {
  size_t n = (size_t)t * c;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = to_f(x[e]) + to_f(b1[e % c]);
    for (int s = 0; s < splits; ++s) v += partial[s * n + e];
    out[e] = from_f<T>(v);
  }
}

size_t mlp_smem(int c) {
  return sizeof(float) *
         ((size_t)2 * kRows * c + kRows * kTileN + kTileK * (kTileN + 1));
}

template <typename T>
cudaError_t launch(const void* x, const void* ln_s, const void* ln_b,
                   const void* w0, const void* b0, const void* w1,
                   const void* b1, void* out, void* partial, int t, int c,
                   int hidden, int splits, float eps, cudaStream_t stream) {
  size_t smem = mlp_smem(c);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // split length: a multiple of the 64-wide hidden chunk
  int split_len = (hidden + splits - 1) / splits;
  split_len = (split_len + kTileN - 1) / kTileN * kTileN;
  splits = (hidden + split_len - 1) / split_len;
  dim3 grid((t + kRows - 1) / kRows, splits);
  mlp_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)ln_s, (const float*)ln_b, (const T*)w0,
      (const T*)b0, (const T*)w1, (const T*)b1, (T*)out, (float*)partial, t,
      c, hidden, split_len, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  int blocks = (int)min(((size_t)t * c + 255) / 256, (size_t)4096);
  mlp_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      (const T*)x, (const T*)b1, (const float*)partial, (T*)out, t, c, splits);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes a launch of width c needs (the wrapper refuses
// widths above the 227 KB a block can hold).
extern "C" long long cv_mlp_block_smem(int c) { return (long long)mlp_smem(c); }

// How many blocks share the hidden dimension of a row tile: enough for
// about two waves over `sms` SMs, at most one per 64-wide hidden chunk.
// The wrapper sizes the float32 workspace from it.
extern "C" int cv_mlp_block_splits(int t, int hidden, int sms) {
  int row_tiles = (t + cvk::kRows - 1) / cvk::kRows;
  int want = (2 * sms + row_tiles - 1) / row_tiles;
  return std::max(1, std::min(hidden / cvk::kTileN, want));
}

// dtype: 0 = float32, 1 = bfloat16. Weights in torch Linear layout:
// w0 (hidden, c), w1 (c, hidden). All tensors contiguous, of the same
// dtype but ln_s and ln_b, which are float32 for either dtype.
// splits > 1 divides the hidden dimension across blocks; `partial` is
// then a float32 workspace of splits·t·c elements.
extern "C" int cv_mlp_block(const void* x, const void* ln_s, const void* ln_b,
                            const void* w0, const void* b0, const void* w1,
                            const void* b1, void* out, void* partial, int t,
                            int c, int hidden, int splits, float eps,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, ln_s, ln_b, w0, b0, w1, b1, out, partial, t, c,
                         hidden, splits, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ln_s, ln_b, w0, b0, w1, b1, out, partial,
                                 t, c, hidden, splits, eps, s);
  return (int)cudaErrorInvalidValue;
}
