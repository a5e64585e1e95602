// Line enhancement of the topology raster in one pass:
//   5×5 Gaussian (σ = 1) → round half to even → 3×3 dilate ×2 → 3×3 erode ×2
//
// Replaces the Pallas kernel `enhance_lines_fused` of the JAX package
// (circuitvision_tpu/ops/pallas/fused_morphology.py), with its numerics:
//
//   * taps built in float64, normalised, rounded to float32 and passed by
//     value (they differ from ops/morphology.py's float32-built taps by one
//     ulp in four of the five);
//   * the blur separable, horizontal taps summed left to right, then the
//     vertical taps top to bottom, each product and sum rounded on its own
//     (__fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs);
//   * every stage replicates its own input at the TRUE image edge, as cv2
//     does (fused_morphology.py:10-13): a neighbour coordinate outside the
//     image is clamped to the edge before it is read.
//
// What bounds it on the H100: ~60 operations per pixel against 8 bytes
// (one float32 read, one written), far below the card's ~20 operations
// per byte at f32 — the memory is the limit. The design reads each pixel
// once and writes it once: a block owns a 32×32 output tile, loads it with
// a 6-pixel halo (2 blur + 2 dilate + 2 erode) into shared memory, and
// runs the five stages there over a shrinking region, ping-ponging
// between two buffers. A clamped neighbour of a pixel always lies inside
// that pixel's own window, so it is inside the region the previous stage
// computed; positions outside the image are never computed or read.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;               // output tile side
constexpr int kHalo = 6;                // 2 blur + 2 dilate + 2 erode
constexpr int kSide = kTile + 2 * kHalo;
constexpr int kThreads = 256;

struct Taps {
  float t[5];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One 3×3 max (dilate) or min (erode) stage: output positions with margin
// `m` around the tile, from `src` to `dst`.
template <bool kMax>
__device__ void pool3(const float* src, float* dst, int m, int y0, int x0,
                      int h, int w) {
  const int side = kTile + 2 * m, off = kHalo - m;
  for (int e = threadIdx.x; e < side * side; e += kThreads) {
    int ly = off + e / side, lx = off + e % side;
    int gy = y0 - kHalo + ly, gx = x0 - kHalo + lx;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
    float v = kMax ? -INFINITY : INFINITY;
    for (int dy = -1; dy <= 1; ++dy) {
      int ny = clampi(gy + dy, 0, h - 1) - (y0 - kHalo);
      for (int dx = -1; dx <= 1; ++dx) {
        int nx = clampi(gx + dx, 0, w - 1) - (x0 - kHalo);
        float u = src[ny * kSide + nx];
        v = kMax ? fmaxf(v, u) : fminf(v, u);
      }
    }
    dst[ly * kSide + lx] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
enhance_lines_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int h, int w, Taps taps) {
  __shared__ float a[kSide * kSide];
  __shared__ float b[kSide * kSide];
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int gy_base = y0 - kHalo, gx_base = x0 - kHalo;

  // load: every in-image position of the haloed tile
  for (int e = threadIdx.x; e < kSide * kSide; e += kThreads) {
    int gy = gy_base + e / kSide, gx = gx_base + e % kSide;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) a[e] = in[(size_t)gy * w + gx];
  }
  __syncthreads();

  // blur, horizontal: all rows (margin 6), columns of margin 4, a → b
  for (int e = threadIdx.x; e < kSide * (kTile + 8); e += kThreads) {
    int ly = e / (kTile + 8), lx = 2 + e % (kTile + 8);
    int gy = gy_base + ly, gx = gx_base + lx;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      int nx = clampi(gx + i - 2, 0, w - 1) - gx_base;
      float p = __fmul_rn(taps.t[i], a[ly * kSide + nx]);
      acc = i == 0 ? p : __fadd_rn(acc, p);
    }
    b[ly * kSide + lx] = acc;
  }
  __syncthreads();

  // blur, vertical, then round half to even: margin 4, b → a
  for (int e = threadIdx.x; e < (kTile + 8) * (kTile + 8); e += kThreads) {
    int ly = 2 + e / (kTile + 8), lx = 2 + e % (kTile + 8);
    int gy = gy_base + ly, gx = gx_base + lx;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      int ny = clampi(gy + i - 2, 0, h - 1) - gy_base;
      float p = __fmul_rn(taps.t[i], b[ny * kSide + lx]);
      acc = i == 0 ? p : __fadd_rn(acc, p);
    }
    a[ly * kSide + lx] = rintf(acc);
  }
  __syncthreads();

  pool3<true>(a, b, 3, y0, x0, h, w);   // dilate 1
  pool3<true>(b, a, 2, y0, x0, h, w);   // dilate 2
  pool3<false>(a, b, 1, y0, x0, h, w);  // erode 1

  // erode 2, straight to device memory
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    int gy = y0 + e / kTile, gx = x0 + e % kTile;
    if (gy >= h || gx >= w) continue;
    float v = INFINITY;
    for (int dy = -1; dy <= 1; ++dy) {
      int ny = clampi(gy + dy, 0, h - 1) - gy_base;
      for (int dx = -1; dx <= 1; ++dx)
        v = fminf(v, b[ny * kSide + clampi(gx + dx, 0, w - 1) - gx_base]);
    }
    out[(size_t)gy * w + gx] = v;
  }
}

}  // namespace

// in, out: (h, w) float32, contiguous; t0..t4 the Gaussian taps.
extern "C" int cv_enhance_lines(const void* in, void* out, int h, int w,
                                float t0, float t1, float t2, float t3,
                                float t4, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  Taps taps = {{t0, t1, t2, t3, t4}};
  dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  enhance_lines_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, h, w, taps);
  return (int)cudaGetLastError();
}
