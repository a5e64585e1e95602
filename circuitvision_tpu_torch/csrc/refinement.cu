// SAM2 MultiKernelRefinement head: four 1→4-channel convolutions with
// k = 3, 5, 7 and 11 (SAME zero padding), exact GELU, and a 1×1
// combiner from 16 channels to 1, over the full-resolution logit map.
//
// Replaces the Pallas kernel `refinement_fused` of the JAX package
// (circuitvision_tpu/ops/pallas/refinement_fused.py). What bounds it on
// the H100: 2·4·(9+25+49+121) + 32 ≈ 1.7 kFLOP of f32 per pixel against
// 6–8 bytes (a bf16 or f32 logit in, f32 out) — about 200–280 FLOP/byte,
// far above the f32 ridge (67 TFLOP/s ÷ 3.35 TB/s ≈ 20), so the 816
// FFMAs a pixel bound it: 0.026 ms at 1 × 1024 × 1024.
//
// The design keeps the FMA pipe fed. The first version (one output pixel
// a thread, every tap one shared-memory load of the input and four of
// weights for its four FFMAs) issued five loads for every four FFMAs and
// was bound by shared-memory issue at 27 % of the FMA bound. Here:
//   * each thread owns a strip of kP = 4 pixels along x. For every row dy
//     of a branch it loads the strip plus K − 1 inputs into registers
//     once and reuses them across the K taps dx and the four channels:
//     4·K·kP FFMAs for kP + K − 1 input loads (strips of 8 and 16 pixels
//     cut the loads further but hold 80 and 128 registers, and ran
//     slower: fewer warps to hide latency);
//   * the weights sit in shared memory as one float4 per tap (the four
//     channels' weights side by side), read with one 16-byte load at a
//     uniform address (a broadcast) and used for kP·4 FFMAs; biases and
//     the combiner the same way;
//   * a block of 256 threads owns a 32 × 32 output tile: each warp 4 rows
//     of eight strips, lane l at strip l % 8 of row l / 8, so with a tile
//     pitch of kPitch = 43 (3 mod 4) the 32 lanes' loads of one row
//     element fall in 32 distinct banks. The haloed 42 × 42 tile is loaded
//     once, each warp its rows, each lane its columns, with no division,
//     and zero outside the image (SAME padding);
//   * a 512 × 512 map is 256 blocks, 1024 × 1024 is 1024 blocks; at 54
//     registers four blocks share an SM.
// erff gives the exact GELU (the Pallas kernel needed a polynomial only
// because Mosaic lowers no erf). Sums are f32.
//
// What holds it from the FMA bound (0.067 ms at 1 × 1024 × 1024 on an
// H100 80GB HBM3 at 700 W, scripts/kernel_rows.py, 39 % of the bound) is
// instruction issue. A thread issues about 5,800 instructions for its
// 4-pixel strip: 3,264 convolution FFMAs, about 1,600 for erff's 64
// evaluations (two polynomial branches merged by selects), about 500
// loads and the addressing. At four warp-instructions a clock an SM that
// is 0.046 ms at 1,980 MHz; the kernel reaches about 68 % of it. A
// version with the weights in __constant__ memory (copied there on the
// stream before each launch, every tap unrolled) ran 2–3 % slower:
// ptxas fed the FFMAs from uniform registers, with 481 ULDC a strip, more
// than the 204 broadcast loads here. Fewer instructions a pixel — erf
// above all — is the way past it.
#include "common.cuh"

namespace {

using namespace cvk;

constexpr int kP = 4;                      // pixels a thread owns along x
constexpr int kStrips = 8;                 // strips of a warp's row
constexpr int kTx = kP * kStrips;          // 32: tile width
constexpr int kWarps = 8, kThreadsR = 32 * kWarps;
constexpr int kTy = kWarps * (32 / kStrips);  // 32: tile height
constexpr int kHalo = 5;
constexpr int kSx = kTx + 2 * kHalo, kSy = kTy + 2 * kHalo;  // 42 × 42
constexpr int kPitch = kSx + 1;            // 43: the lanes' banks differ
constexpr int kTaps = 9 + 25 + 49 + 121;   // float4 weights, one per tap

template <int K>
__device__ __forceinline__ void branch(const float* __restrict__ tile, const float4* wk,
                                       float4 bias, float4 comb, float (&y)[kP]) {
  constexpr int R = K / 2;
  float acc[kP][4];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    acc[p][0] = bias.x;
    acc[p][1] = bias.y;
    acc[p][2] = bias.z;
    acc[p][3] = bias.w;
  }
  const float* row = tile + (kHalo - R) * kPitch + (kHalo - R);
#pragma unroll 1
  for (int dy = 0; dy < K; ++dy, row += kPitch) {
    float v[kP + K - 1];
#pragma unroll
    for (int j = 0; j < kP + K - 1; ++j) v[j] = row[j];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float4 w = wk[dy * K + dx];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        acc[p][0] = fmaf(w.x, v[p + dx], acc[p][0]);
        acc[p][1] = fmaf(w.y, v[p + dx], acc[p][1]);
        acc[p][2] = fmaf(w.z, v[p + dx], acc[p][2]);
        acc[p][3] = fmaf(w.w, v[p + dx], acc[p][3]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    y[p] += comb.x * gelu_erf(acc[p][0]);
    y[p] += comb.y * gelu_erf(acc[p][1]);
    y[p] += comb.z * gelu_erf(acc[p][2]);
    y[p] += comb.w * gelu_erf(acc[p][3]);
  }
}

// The (4, 1, K, K) weights of one branch as K·K float4s, tap-major.
template <typename T, int K>
__device__ __forceinline__ void stage_weights(const T* __restrict__ src, float* dst) {
  for (int e = threadIdx.x; e < 4 * K * K; e += kThreadsR) {
    const int c = e / (K * K), t = e - c * (K * K);
    dst[4 * t + c] = to_f(src[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsR)
refinement_kernel(const T* __restrict__ x, const T* __restrict__ w3,
                  const T* __restrict__ b3, const T* __restrict__ w5,
                  const T* __restrict__ b5, const T* __restrict__ w7,
                  const T* __restrict__ b7, const T* __restrict__ w11,
                  const T* __restrict__ b11, const T* __restrict__ wc,
                  const T* __restrict__ bc, float* __restrict__ out, int h,
                  int w) {
  __shared__ float tile[kSy * kPitch];
  // per tap a float4 of the four channels; then the 16 biases, the 16
  // combiner weights and the combiner's bias
  __shared__ __align__(16) float wts[4 * kTaps + 16 + 16 + 4];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  stage_weights<T, 3>(w3, wts);
  stage_weights<T, 5>(w5, wts + 4 * 9);
  stage_weights<T, 7>(w7, wts + 4 * 34);
  stage_weights<T, 11>(w11, wts + 4 * 83);
  float* tail = wts + 4 * kTaps;
  if (tid < 16) {
    const T* bs[4] = {b3, b5, b7, b11};
    tail[tid] = to_f(bs[tid / 4][tid % 4]);
    tail[16 + tid] = to_f(wc[tid]);
  }
  if (tid == 0) tail[32] = to_f(bc[0]);

  const int img = blockIdx.z;
  const int tx0 = blockIdx.x * kTx, ty0 = blockIdx.y * kTy;
  const T* xi = x + (size_t)img * h * w;
  for (int r = warp; r < kSy; r += kWarps) {
    const int gy = ty0 - kHalo + r;
    const bool row_in = gy >= 0 && gy < h;
    for (int c = lane; c < kSx; c += 32) {
      const int gx = tx0 - kHalo + c;
      tile[r * kPitch + c] =
          row_in && gx >= 0 && gx < w ? to_f(xi[(size_t)gy * w + gx]) : 0.f;
    }
  }
  __syncthreads();

  const int sx = lane % kStrips, sy = warp * (32 / kStrips) + lane / kStrips;
  const int ox = tx0 + sx * kP, oy = ty0 + sy;
  if (oy >= h || ox >= w) return;
  const float* t = tile + sy * kPitch + sx * kP;
  const float4* w4 = reinterpret_cast<const float4*>(wts);
  const float4* b4 = reinterpret_cast<const float4*>(tail);
  float y[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) y[p] = tail[32];
  branch<3>(t, w4, b4[0], b4[4], y);
  branch<5>(t, w4 + 9, b4[1], b4[5], y);
  branch<7>(t, w4 + 34, b4[2], b4[6], y);
  branch<11>(t, w4 + 83, b4[3], b4[7], y);

  float* o = out + (size_t)img * h * w + (size_t)oy * w + ox;
  if (kP % 4 == 0 && ox + kP <= w && w % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kP / 4; ++q)
      reinterpret_cast<float4*>(o)[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2],
                                                    y[4 * q + 3]);
  } else {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (ox + p < w) o[p] = y[p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* const* p, void* out, int b,
                   int h, int w, cudaStream_t stream) {
  dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy, b);
  refinement_kernel<T><<<grid, kThreadsR, 0, stream>>>(
      (const T*)x, (const T*)p[0], (const T*)p[1], (const T*)p[2],
      (const T*)p[3], (const T*)p[4], (const T*)p[5], (const T*)p[6],
      (const T*)p[7], (const T*)p[8], (const T*)p[9], (float*)out, h, w);
  return cudaGetLastError();
}

}  // namespace

// x: (b, h, w) logits; branch weights in torch Conv2d layout (4, 1, k, k)
// for k = 3, 5, 7, 11, biases (4,), combiner (1, 16, 1, 1) and (1,), all
// in x's dtype (0 = float32, 1 = bfloat16). out: (b, h, w) float32,
// 16-byte aligned (the wrapper's torch.empty).
extern "C" int cv_refinement(const void* x, const void* w3, const void* b3,
                             const void* w5, const void* b5, const void* w7,
                             const void* b7, const void* w11, const void* b11,
                             const void* wc, const void* bc, void* out, int b,
                             int h, int w, int dtype, void* stream) {
  if (b < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const void* p[10] = {w3, b3, w5, b5, w7, b7, w11, b11, wc, bc};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, p, out, b, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, p, out, b, h, w, s);
  return (int)cudaErrorInvalidValue;
}
