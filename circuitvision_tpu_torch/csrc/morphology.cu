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
// What bounds it on the H100: ~50 operations per pixel against 8 bytes
// (one float32 read, one written), far below the card's ~20 operations
// per byte at f32 — the memory is the limit, 1.15 µs for a 600 × 800
// raster, about what one launch costs. So the kernel reads each pixel
// once and writes it once, and spends as few instructions as it can in
// between: a block owns a 52 × 48 output tile, loads it with a 6-pixel
// halo (2 blur + 2 dilate + 2 erode) into shared memory — a 64-column,
// 60-row tile — and runs the five stages there, ping-ponging between two
// buffers, one __syncthreads a stage.
//
// Each of the 256 threads owns one tile column and a quarter of the rows
// of every stage, and walks down them:
//   * the horizontal part of a stage (the blur's five taps left to right,
//     a pool's max or min over three columns) reads shared memory at the
//     thread's column and its neighbours; the vertical part runs in
//     registers as a rolling window over the rows the walk has passed
//     (five horizontal sums for the blur, three row maxima or minima for a
//     pool) and writes one value a row, two rows an iteration so that
//     one row's loads are in flight while the other's sums run. Max and
//     min are exact and order-free, so the 3 × 3 pool split into a
//     horizontal and a vertical pass is bit for bit the 3 × 3 pool; the
//     blur keeps its order.
//   * Edges without clamping in the inner loop: every stage writes all
//     the columns of its region, a column outside the image getting the
//     value of the edge column it clamps to (its thread computes that
//     column), so a horizontal read never needs a clamp. Rows are walked
//     inside the image only, and a read row is clamped once per row.
//   * No division or modulo per element: the thread's column, its
//     clamped column and the rows of its quarter are set once a stage; a
//     block whose tile lies inside the image's rows reads rows unclamped
//     (the stages are instantiated twice).
// A clamped neighbour of a pixel always lies inside that pixel's own
// window, so it is inside the region the previous stage computed.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 6.9 µs of device
// time for a 600 × 800 raster against the first version's 16.4 (one
// thread a pixel, nine shared-memory reads a pool, a division and a
// modulo per element), with an empty kernel's launch at 0.8 µs. What is
// left is latency more than work: the tile's load from device memory,
// then five stages in turn, each a walk of 14–18 rows per thread at
// about three warps an SM sub-partition (208 blocks of 8 warps).
#include <cuda_runtime.h>

namespace {

constexpr int kTw = 52, kTh = 48;       // output tile
constexpr int kHalo = 6;                // 2 blur + 2 dilate + 2 erode
constexpr int kCols = kTw + 2 * kHalo;  // 64: one thread a column
constexpr int kRows = kTh + 2 * kHalo;  // 60
constexpr int kSegs = 4;                // row quarters: 64 × 4 = 256 threads
static_assert(kRows % kSegs == 0, "the load's trip count");
constexpr int kThreads = kCols * kSegs;

struct Taps {
  float t[5];
};

// Where a thread works in one stage: its column (local), the column it
// computes (clamped into the image), and the rows [y0, y1) of its quarter
// of the stage's rows inside the image. lo/hi clamp a local row into the
// image.
template <bool kClamp>
struct Walk {
  int col, cc, y0, y1, lo, hi;
  __device__ int row(int r) const {
    return kClamp ? (r < lo ? lo : (r > hi ? hi : r)) : r;
  }
};

// The thread's share of a stage whose output lies `m` rows and columns
// inside the tile's edge (blur 2, the pools 3 to 6); false where its
// column is outside the stage's region or its quarter is empty.
template <bool kClamp>
__device__ bool walk(int m, int gy0, int gx0, int h, int w, Walk<kClamp>& k) {
  const int col = threadIdx.x % kCols, seg = threadIdx.x / kCols;
  if (col < m || col >= kCols - m) return false;
  const int lo = -gy0, hi = h - 1 - gy0;  // the image's rows, local
  const int a = max(m, lo), b = min(kRows - m, hi + 1);
  const int len = (b - a + kSegs - 1) / kSegs;
  k.col = col;
  k.cc = min(max(col, -gx0), w - 1 - gx0);
  k.y0 = a + seg * len;
  k.y1 = min(k.y0 + len, b);
  k.lo = lo;
  k.hi = hi;
  return k.y0 < k.y1;
}

// 5×5 blur and round: src → dst over the rows and columns of margin 2.
// kClamp: the tile reaches past the image's top or bottom edge, so read
// rows are clamped (a block whose tile lies inside the image skips it).
template <bool kClamp>
__device__ void blur(const float* src, float* dst, int gy0, int gx0, int h, int w,
                     const Taps& tp) {
  Walk<kClamp> k;
  if (!walk(2, gy0, gx0, h, w, k)) return;
  const int c = k.cc;
  auto hsum = [&](int r) {
    const float* s = src + k.row(r) * kCols + c;
    float acc = __fmul_rn(tp.t[0], s[-2]);
    acc = __fadd_rn(acc, __fmul_rn(tp.t[1], s[-1]));
    acc = __fadd_rn(acc, __fmul_rn(tp.t[2], s[0]));
    acc = __fadd_rn(acc, __fmul_rn(tp.t[3], s[1]));
    return __fadd_rn(acc, __fmul_rn(tp.t[4], s[2]));
  };
  float v0 = hsum(k.y0 - 2), v1 = hsum(k.y0 - 1), v2 = hsum(k.y0), v3 = hsum(k.y0 + 1);
#pragma unroll 2
  for (int r = k.y0; r < k.y1; ++r) {
    const float v4 = hsum(r + 2);
    float acc = __fmul_rn(tp.t[0], v0);
    acc = __fadd_rn(acc, __fmul_rn(tp.t[1], v1));
    acc = __fadd_rn(acc, __fmul_rn(tp.t[2], v2));
    acc = __fadd_rn(acc, __fmul_rn(tp.t[3], v3));
    acc = __fadd_rn(acc, __fmul_rn(tp.t[4], v4));
    dst[r * kCols + k.col] = rintf(acc);
    v0 = v1;
    v1 = v2;
    v2 = v3;
    v3 = v4;
  }
}

// One 3×3 max (dilate) or min (erode): src → dst (shared memory, row
// pitch kCols, tile origin) over margin m, or with `out` set straight to
// device memory at the image's own rows and columns.
template <bool kMax, bool kClamp>
__device__ void pool3(const float* src, float* dst, int m, int gy0, int gx0, int h, int w,
                      float* __restrict__ out) {
  Walk<kClamp> k;
  if (!walk(m, gy0, gx0, h, w, k)) return;
  const int c = k.cc;
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : fminf(a, b); };
  auto hpool = [&](int r) {
    const float* s = src + k.row(r) * kCols + c;
    return op(op(s[-1], s[0]), s[1]);
  };
  float v0 = hpool(k.y0 - 1), v1 = hpool(k.y0);
  const bool in_image = k.col == c;
#pragma unroll 2
  for (int r = k.y0; r < k.y1; ++r) {
    const float v2 = hpool(r + 1);
    const float v = op(op(v0, v1), v2);
    if (!out)
      dst[r * kCols + k.col] = v;
    else if (in_image)
      out[(size_t)(gy0 + r) * w + gx0 + k.col] = v;
    v0 = v1;
    v1 = v2;
  }
}

// The five stages over the tile in shared memory `a` (the input, loaded)
// and `b`, ending in device memory.
template <bool kClamp>
__device__ void stages(float* a, float* b, float* __restrict__ out, int gy0, int gx0, int h,
                       int w, const Taps& taps) {
  blur<kClamp>(a, b, gy0, gx0, h, w, taps);
  __syncthreads();
  pool3<true, kClamp>(b, a, 3, gy0, gx0, h, w, nullptr);   // dilate 1
  __syncthreads();
  pool3<true, kClamp>(a, b, 4, gy0, gx0, h, w, nullptr);   // dilate 2
  __syncthreads();
  pool3<false, kClamp>(b, a, 5, gy0, gx0, h, w, nullptr);  // erode 1
  __syncthreads();
  pool3<false, kClamp>(a, nullptr, 6, gy0, gx0, h, w, out);  // erode 2, to device memory
}

__global__ void __launch_bounds__(kThreads)
enhance_lines_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int h, int w, Taps taps) {
  __shared__ float a[kRows * kCols];
  __shared__ float b[kRows * kCols];
  const int gy0 = blockIdx.y * kTh - kHalo, gx0 = blockIdx.x * kTw - kHalo;

  // load the tile's rows inside the image, every column, a column outside
  // the image taking its clamped column's value; a fixed trip count, so
  // the loads of a thread's 15 rows are all in flight at once
  {
    const int col = threadIdx.x % kCols, seg = threadIdx.x / kCols;
    const int gx = min(max(gx0 + col, 0), w - 1);
    const int r0 = max(0, -gy0), r1 = min(kRows, h - gy0);
#pragma unroll
    for (int i = 0; i < kRows / kSegs; ++i) {
      const int r = r0 + seg + i * kSegs;
      if (r < r1) a[r * kCols + col] = in[(size_t)(gy0 + r) * w + gx];
    }
  }
  __syncthreads();
  if (gy0 >= 0 && gy0 + kRows <= h)
    stages<false>(a, b, out, gy0, gx0, h, w, taps);
  else
    stages<true>(a, b, out, gy0, gx0, h, w, taps);
}

}  // namespace

// in, out: (h, w) float32, contiguous; t0..t4 the Gaussian taps.
extern "C" int cv_enhance_lines(const void* in, void* out, int h, int w,
                                float t0, float t1, float t2, float t3,
                                float t4, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  Taps taps = {{t0, t1, t2, t3, t4}};
  dim3 grid((w + kTw - 1) / kTw, (h + kTh - 1) / kTh);
  enhance_lines_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, h, w, taps);
  return (int)cudaGetLastError();
}
