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
// float32 — the same three launches in float32, every product 3×TF32
// on the tensor cores (tf32.cuh): the LN pre-pass (tf32::ln_rows_kernel,
// layernorm_rows<float>, so xn is bit for bit what the FMA kernel
// normalised) into an f32 workspace; h = GELU_erf(xn·W0ᵀ + b0) kept in
// f32 (T·4C·4 bytes: 25 MB at T = 16384, C = 96, within the 50 MB L2);
// out = x + b1 + h·W1ᵀ. Blocks of 64 × 64 outputs, mma.sync m16n8k8
// .tf32 with each operand split into hi and lo in registers; where
// the row tiles leave SMs idle (t@512's small-T products: T = 256, C = 768
// gives 48 blocks for out) the depth is split across blocks and the
// partial sums added in split order (the wrapper's plan, mlp_plan_f32).
// What bounds it: 16·T·C² FLOPs at three TF32 products each, 3 × ops ÷
// 495 TFLOP/s — 0.176 ms per trained-product analyze() (12 launches,
// 29 GFLOP), against 0.433 at the FMA units' 67 TFLOP/s. The FMA loops it
// replaces (one 16-row tile a block, weights re-read from L2 by every
// block, 4 accumulators a thread) ran at about 7 TFLOP/s. One TF32
// product would miss the float32 card-against-CPU check (about 3e-4 of
// max |plain| at these shapes); three hold float32's own summation noise.
//
// Measured per Hiera-L@1024 analyze() (48 launches, bf16; chip_smoke.py,
// H100 80GB HBM3 at 700 W, parent and this design in one call): 6.414
// and 6.363 ms against the parent's f32-FMA loops at 149.632 and
// 148.922, and a 1.055 ms bound (6.0×); 0.123 ms a launch at T = 4096,
// C = 576 (177 TFLOP/s, bound 0.022). float32, 3×TF32 (scripts/
// kernel_rows.py, same card, the FMA kernel in the same call): 0.836 ms
// per trained-product analyze() (12 launches, 29.6–36.3 TFLOP/s) against
// 4.02 for the FMA loops and 1.148 for the two products' F.linear calls
// (cuBLAS float32); 20.1 ms per Hiera-L@1024 float32 forward against
// 152.2.
#include <algorithm>

#include "common.cuh"
#include "tc_gemm.cuh"
#include "tf32.cuh"

namespace {

using namespace cvk;

// ------------------------------------------------------------- float32
// Epilogues of the 3×TF32 GEMM (tf32.cuh) over an output of n_cols
// columns: h = GELU_erf(acc + bias[n]); out = (resid[r][n] + bias[n]) +
// acc, the plain version's order. two() takes columns c, c + 1 (c even,
// n_cols even) with 8-byte loads and stores.
struct GeluF32 {
  const float* bias;
  float* out;
  int n_cols;
  static constexpr bool kFrag = false;
  __device__ void one(int r, int c, float v) const {
    out[(size_t)r * n_cols + c] = gelu_erf(v + bias[c]);
  }
  __device__ void two(int r, int c, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    *reinterpret_cast<float2*>(out + (size_t)r * n_cols + c) =
        make_float2(gelu_erf(v0 + b.x), gelu_erf(v1 + b.y));
  }
  bool aligned8() const { return tf32::aligned8(bias) && tf32::aligned8(out); }
};

struct ResidF32 {
  const float* bias;
  const float* resid;
  float* out;
  int n_cols;
  static constexpr bool kFrag = false;
  __device__ void one(int r, int c, float v) const {
    const size_t at = (size_t)r * n_cols + c;
    out[at] = (resid[at] + bias[c]) + v;
  }
  __device__ void two(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * n_cols + c;
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    const float2 x = *reinterpret_cast<const float2*>(resid + at);
    *reinterpret_cast<float2*>(out + at) = make_float2((x.x + b.x) + v0, (x.y + b.y) + v1);
  }
  bool aligned8() const {
    return tf32::aligned8(bias) && tf32::aligned8(resid) && tf32::aligned8(out);
  }
};

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

// Shared-memory bytes of the bf16 path's LN pre-pass at width c, and of
// one bf16 GEMM block of bm rows (the wrapper's plan must agree).
extern "C" long long cv_mlp_ln_smem(int c) { return (long long)tcg::ln_smem(c); }
extern "C" long long cv_mlp_gemm_smem(int bm) { return (long long)tcg::gemm_smem(bm); }

// float32 on the tensor cores (3×TF32). Weights in torch Linear layout:
// w0 (hidden, c), w1 (c, hidden); every tensor contiguous float32. ws is
// a float32 workspace of xn (t·c elements) and h (t·hidden), each
// starting on a 16-byte boundary, followed by the partial sums of a split
// GEMM: splits·t·hidden for the first product, splits·t·c for the
// second, the larger where both split. The
// GEMMs' depth splits come from the wrapper's plan
// (ops/cuda/mlp_block.py mlp_plan_f32). Any width: k a multiple of 4
// with aligned operands copies 16 bytes at a time.
extern "C" int cv_mlp_block_f32(const void* x, const void* ln_s, const void* ln_b,
                                const void* w0, const void* b0, const void* w1,
                                const void* b1, void* out, void* ws, int t, int c, int hidden,
                                float eps, int splits1, int splits2, void* stream) {
  if (t < 1 || c < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto up4 = [](size_t e) { return (e + 3) / 4 * 4; };
  float* xn = (float*)ws;
  float* h = xn + up4((size_t)t * c);
  float* partial = h + up4((size_t)t * hidden);
  cudaError_t err = tf32::launch_ln_rows((const float*)x, (const float*)ln_s,
                                         (const float*)ln_b, xn, t, c, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = tf32::launch_gemm(splits1, xn, (const float*)w0, (const float*)w0, hidden, t,
                          hidden, c, partial, GeluF32{(const float*)b0, h, hidden}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)tf32::launch_gemm(splits2, h, (const float*)w1, (const float*)w1, c, t, c,
                                hidden, partial,
                                ResidF32{(const float*)b1, (const float*)x, (float*)out, c}, s);
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
