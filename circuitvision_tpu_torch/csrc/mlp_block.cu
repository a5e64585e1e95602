// Hiera MLP half, out = x + W1·bf16(GELU_erf(W0·bf16(LN2(x)) + b0)) + b1,
// over rows; weights in torch Linear layout, w0 (4C, C) and w1 (C, 4C).
//
// Replaces the Pallas kernel `mlp_block` of the JAX package
// (circuitvision_tpu/ops/pallas/mlp_block.py). Numerics follow it: LN
// statistics in f32 (fast-variance form, true width), LN(x) rounded to
// the compute dtype where the Pallas kernel stores xn_ref, both products
// accumulated in f32, the hidden activation rounded where it is stored,
// the output rounded once.
//
// What bounds it on the H100: 16·T·C² FLOPs against 4·T·C bytes of
// activations, about 4·C FLOP/byte — 576 to 4608 at the Hiera-L@1024
// widths (C = 144 … 1152): the products, not the memory. Each L@1024
// launch is 21.7 GFLOP, 22 µs at 989 TFLOP/s.
//
// bfloat16 — the design: three launches per call, the LN pre-pass and
// the GEMM of tc_gemm.cuh (shared with global_attn.cu's ln_qkv).
//   1. LN pre-pass (ln_rows_kernel): 8 rows a block through common.cuh's
//      layernorm_rows, unchanged, so xn is bit for bit what the fused
//      kernel computed; written to a bf16 workspace (T·C·2 bytes).
//   2. h = bf16(GELU_erf(xn·W0ᵀ + b0)) (gemm_tc_kernel, GeluEpi),
//      written to the workspace in bf16 (T·4C·2 bytes).
//   3. out = bf16(x + b1 + h·W1ᵀ) (ResidEpi).
// Both products are one tensor-core GEMM over operands that are both
// K-contiguous (xn or h row-major; W in Linear layout): wgmma m64n128k16
// (tc.cuh), B and A read from shared memory through 128-byte-swizzle
// descriptors; a 3-stage cp.async ring of 64-deep tiles (rows of 128
// bytes, each 16-byte chunk placed where the swizzle expects it, so no
// TMA descriptor is needed); one warpgroup per 64 output rows, blocks of
// 128 or 64 rows by 128 columns — 64 where 128-row blocks would not give
// two per SM (the wrapper's plan, ops/cuda/mlp_block.py). Where h lives:
// in device memory, in bf16 at the point where the Pallas kernel rounds
// it, so the numerics are those of the fused form. It costs 2·T·4C·2
// bytes a call: 37.7 MB at T = 4096, C = 576, where h (18.9 MB) stays in
// the 50 MB L2; 151 MB at T = 65536, C = 144, where it does not (≈ 45 µs
// at 3.35 TB/s, 2 launches a call); ≈ 2.2 GB summed over an L@1024
// analyze(). A fused form would keep h on chip only while the 64-row f32
// output accumulator fits one warpgroup's registers (C ≤ 288); the
// two-pass form serves every width with one kernel. Each k tile's
// products finish before the next tile's barrier (wgmma_wait<0>); a
// producer warp with mbarriers, keeping products in flight across tiles,
// is the next step.
//
// float32 — mlp_block_kernel, f32 FMA loops: one block per 16-row tile
// keeps the row tile's LayerNorm output and the f32 accumulator in shared
// memory for the whole hidden dimension, walked in 64-wide chunks (the
// hidden activation never reaches device memory, as in the Pallas
// kernel); weights stream through a staged tile per chunk (block_gemm).
// Where the row tiles alone would leave most SMs idle, the hidden
// dimension is also split across blocks: each writes its f32 partial sum
// to a workspace, and mlp_reduce_kernel adds the partials in split order
// to x + b1 — deterministic, no atomics. TF32 would not hold the float32
// card-against-CPU check, so it stays on the FMA units.
//
// Measured per Hiera-L@1024 analyze() (48 launches, bf16; chip_smoke.py,
// H100 80GB HBM3 at 700 W, parent and this design in one call): 6.414
// and 6.363 ms against the parent's f32-FMA loops at 149.632 and
// 148.922, and a 1.055 ms bound (6.0×); 0.123 ms a launch at T = 4096,
// C = 576 (177 TFLOP/s, bound 0.022). float32: 152.7–153.4 ms, unchanged.
#include <algorithm>

#include "common.cuh"
#include "tc_gemm.cuh"

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


// ------------------------------------------------------------ bfloat16
using tc::bf16;

// Epilogues of the shared GEMM (tc_gemm.cuh) over an output of n_cols
// columns. EPI 0: h = bf16(GELU_erf(acc + bias[n])); EPI 1: out =
// bf16(resid[r][n] + bias[n] + acc).
struct BiasCol {
  float2 bb;
  int col;
};

struct GeluEpi {
  const bf16* bias;
  bf16* out;
  int n_cols;
  __device__ size_t row(int r) const { return (size_t)r * n_cols; }
  __device__ BiasCol col(int c) const {
    return {tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + c)), c};
  }
  __device__ void store(size_t r, BiasCol c, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + r + c.col) =
        tc::pack_bf16(gelu_erf(v0 + c.bb.x), gelu_erf(v1 + c.bb.y));
  }
};

struct ResidEpi {
  const bf16* bias;
  const bf16* resid;
  bf16* out;
  int n_cols;
  __device__ size_t row(int r) const { return (size_t)r * n_cols; }
  __device__ BiasCol col(int c) const {
    return {tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + c)), c};
  }
  __device__ void store(size_t r, BiasCol c, float v0, float v1) const {
    const size_t at = r + c.col;
    const float2 xr = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(resid + at));
    *reinterpret_cast<uint32_t*>(out + at) =
        tc::pack_bf16((xr.x + c.bb.x) + v0, (xr.y + c.bb.y) + v1);
  }
};

}  // namespace

// Shared-memory bytes of a float32 launch of width c (the wrapper refuses
// widths above the 227 KB a block can hold).
extern "C" long long cv_mlp_block_smem(int c) { return (long long)mlp_smem(c); }

// Shared-memory bytes of the bf16 path's LN pre-pass at width c, and of
// one bf16 GEMM block of bm rows (the wrapper's plan must agree).
extern "C" long long cv_mlp_ln_smem(int c) { return (long long)tcg::ln_smem(c); }
extern "C" long long cv_mlp_gemm_smem(int bm) { return (long long)tcg::gemm_smem(bm); }

// float32: how many blocks share the hidden dimension of a row tile:
// enough for about two waves over `sms` SMs, at most one per 64-wide
// hidden chunk. The wrapper sizes the float32 workspace from it.
extern "C" int cv_mlp_block_splits(int t, int hidden, int sms) {
  int row_tiles = (t + cvk::kRows - 1) / cvk::kRows;
  int want = (2 * sms + row_tiles - 1) / row_tiles;
  return std::max(1, std::min(hidden / cvk::kTileN, want));
}

// float32 on the FMA units. Weights in torch Linear layout: w0 (hidden,
// c), w1 (c, hidden); every tensor contiguous float32. splits > 1
// divides the hidden dimension across blocks; `partial` is then a
// float32 workspace of splits·t·c elements.
extern "C" int cv_mlp_block_f32(const void* x, const void* ln_s, const void* ln_b,
                                const void* w0, const void* b0, const void* w1,
                                const void* b1, void* out, void* partial, int t, int c,
                                int hidden, int splits, float eps, void* stream) {
  return launch<float>(x, ln_s, ln_b, w0, b0, w1, b1, out, partial, t, c, hidden, splits, eps,
                       (cudaStream_t)stream);
}

// bfloat16 on the tensor cores: the same function, ln_s and ln_b float32,
// every other tensor contiguous bf16 and 16-byte aligned, c and hidden
// multiples of 8. xn (t·c) and h (t·hidden) are bf16 workspaces; the
// GEMM row tiles (bm1 for h, bm2 for out, each 128 or 64) come from the
// wrapper's plan (ops/cuda/mlp_block.py mlp_plan). ln_c ≤ c is the rows'
// true width, the LayerNorm's divisor: x, the weights and the LN
// parameters zero-padded from ln_c to c give the unpadded block's
// values and zeros in the padding.
extern "C" int cv_mlp_block_bf16(const void* x, const void* ln_s, const void* ln_b,
                                 const void* w0, const void* b0, const void* w1,
                                 const void* b1, void* out, void* xn, void* h, int t, int c,
                                 int hidden, int ln_c, float eps, int bm1, int bm2,
                                 void* stream) {
  if (t < 1 || c < 8 || c % 8 || hidden < 8 || hidden % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = tcg::launch_ln_rows((const bf16*)x, (const float*)ln_s, (const float*)ln_b,
                                        (bf16*)xn, t, c, ln_c, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = tcg::launch_gemm(bm1, (const bf16*)xn, (const bf16*)w0, t, hidden, c,
                         GeluEpi{(const bf16*)b0, (bf16*)h, hidden}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)tcg::launch_gemm(bm2, (const bf16*)h, (const bf16*)w1, t, c, hidden,
                               ResidEpi{(const bf16*)b1, (const bf16*)x, (bf16*)out, c}, s);
}
