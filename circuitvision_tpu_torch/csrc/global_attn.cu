// The shell around attention in the Hiera global blocks: LN1 + a product
// emitting head-major slabs (`ln_qkv`), and the output projection with
// the residual (`attn_proj_residual`).
//
// Replaces two Pallas kernels of the JAX package
// (circuitvision_tpu/ops/pallas/global_attn.py):
//   * ln_qkv_flash: q, k, v = split_heads(LN1(x)·Wqkvᵀ + b), each
//     (B, H, N, D), the layout the attention kernel reads;
//   * attn_proj_residual: out = x + concat_heads(o)·Wprojᵀ + b, reading
//     the attention output o head-major.
// The large-window routes of window_attn.cu's blocks use the same two
// kernels over (n_windows, T, C) windows; for the q-pool block the
// residual is the 2×2 max-pool of the shortcut, taken as it is read.
//
// What bounds them on the H100: at the global blocks (N 4096, C 576) the
// products are 6·N·C² and 2·N·C² FLOPs against 8·N·C and 6·N·C bytes of
// bf16 activations, ~430 and ~190 FLOP/byte — about the bf16 ridge
// (295), so the products are the limit once they run on tensor cores.
// Per Hiera-L@1024 analyze(), ln_qkv's 42 launches are ≈ 350 GFLOP
// (bound 0.39 ms at 989 TFLOP/s); attn_proj_residual's 40 are ≈ 109
// GFLOP (0.11 ms) against ≈ 620 MB (0.186 ms): its q-pool launch reads
// the full-resolution shortcut, 4 rows per output row, so bytes bound it.
//
// Which kernel is which:
//   * ln_qkv, bfloat16 — two launches through tc_gemm.cuh, shared with
//     mlp_block.cu: the LN pre-pass (ln_rows_kernel over common.cuh's
//     layernorm_rows, unchanged, so xn is bit for bit what the f32
//     kernel normalises) into a bf16 workspace of B·N × C_in, then the
//     wgmma m64n128k16 GEMM over a swizzled cp.async ring with the
//     head-split epilogue (HeadsEpi): bias added to the f32 accumulator,
//     one rounding, and the store at the head-major address (s, b, h, i,
//     d). The head width is even, so each accumulator pair (2t, 2t + 1)
//     stays in one head and goes out as one 4-byte store; the per-row
//     and per-column parts of the address are computed once each. No
//     transpose pass and no 72 → 128 lane pad (the pad only served the
//     MXU). Measured per Hiera-L@1024 analyze() (chip_smoke.py, H100
//     80GB HBM3 at 700 W): 2.415 ms against the FMA design's 53.7–53.9,
//     150–185 TFLOP/s a launch at C_in = 576 and 1152, 56–74 at 144.
//   * attn_proj_residual, bfloat16 — one launch of the same GEMM, its A
//     operand concat_heads(o) read where it lies (HeadsA: the 16-byte
//     piece at row b·N + i, depth h·hd + d comes from o[b][h][i][d..];
//     hd is a multiple of 8, so no piece straddles two heads; a template
//     instance at 56, 72 and 96, HeadsAnyA with a runtime hd at any
//     other multiple of 8) and the
//     residual in the epilogue (ProjResEpi): bias added to the f32
//     accumulator, the projection rounded there where round_proj asks
//     (the window routes) or not (the global blocks), the residual read
//     as bf16 pairs — with pool_win, four pairs a row of C apart, their
//     max taken in f32 — and one rounding at the store. No transpose
//     pass, no f32 copy of the heads. The FMA design it replaces owned
//     16 rows a block and read every weight element M/16 times at ≈ 8
//     TFLOP/s (13.7 ms per L@1024 analyze()).
//   * ln_qkv and attn_proj_residual, float32 — ln_heads_kernel and
//     proj_res_kernel, f32 FMA loops: a block owns 16 rows and a share of
//     the output columns and streams its weight columns through staged
//     tiles (common.cuh block_gemm); few rows (1024 at stage 4) split the
//     columns until about four blocks per SM are in flight. ln_heads
//     normalises its rows in shared memory; proj_res gathers the heads as
//     it loads and adds the residual (pooled where asked) as it stores.
//     TF32 would not hold the float32 card-against-CPU check.
// After this, no bf16 Hiera kernel of the port multiplies on the FMA
// units: both of these, mlp_block, window_attn_block, qpool_attn_block
// and flash_attn run their bf16 products on the tensor cores.
#include <algorithm>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

using namespace cvk;

constexpr int kWs = kTileK * (kTileN + 1);

// x: (rows, c_in) = B·N rows; w: (n_out, c_in), n_out = slabs·heads·hd.
// out: (slabs, B, heads, N, hd). Block (i, j) takes rows [16·i, 16·i + 16)
// and output columns [j·cols, (j + 1)·cols).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_heads_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out, int rows_total,
                int n, int c_in, int n_out, int cols, int heads, int hd,
                float eps) {
  extern __shared__ float smem[];
  float* xn = smem;  // kRows × c_in: the input, normalised in place
  float* ws = xn + kRows * c_in;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, rows_total - r0);
  const T* xb = x + (size_t)r0 * c_in;
  for (int e = threadIdx.x; e < rows * c_in; e += kThreads) xn[e] = to_f(xb[e]);
  __syncthreads();
  layernorm_rows<T>(xn, xn, rows, c_in, ln_s, ln_b, eps);
  const int c_out = heads * hd;
  const size_t slab = (size_t)rows_total * c_out;
  const int col0 = blockIdx.y * cols;
  block_gemm<T>(xn, c_in, rows, c_in, w + (size_t)col0 * c_in, c_in,
                min(cols, n_out - col0), ws, [&](int r, int j, float v) {
                  const int col = col0 + j;
                  const int s = col / c_out, h = (col % c_out) / hd, d = col % hd;
                  const int row = r0 + r, b = row / n, i = row % n;
                  out[s * slab + (((size_t)b * heads + h) * n + i) * hd + d] =
                      from_f<T>(v + to_f(bias[col]));
                });
}

// o: (B, heads, N, hd); w: (c, c), c = heads·hd; out: (B·N, c). The
// residual x is (B·N, c), or with pool_win > 0 the full-resolution
// window-major rows (B·pool_win², c) whose 2×2 max-pool gives row i.
// round_proj rounds the projection to T before the residual add (the
// window kernels' rounding); otherwise one rounding at the end
// (ln_qkv_flash's companion kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_res_kernel(const T* __restrict__ x, const T* __restrict__ o,
                const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ out, int rows_total, int n, int cols, int heads,
                int hd, int pool_win, int round_proj) {
  extern __shared__ float smem[];
  const int c = heads * hd;
  float* a = smem;  // kRows × c: concat_heads(o)
  float* ws = a + kRows * c;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, rows_total - r0);
  for (int e = threadIdx.x; e < rows * c; e += kThreads) {
    const int r = e / c, col = e % c, h = col / hd, d = col % hd;
    const int row = r0 + r, b = row / n, i = row % n;
    a[e] = to_f(o[(((size_t)b * heads + h) * n + i) * hd + d]);
  }
  const int col0 = blockIdx.y * cols;
  block_gemm<T>(a, c, rows, c, w + (size_t)col0 * c, c, min(cols, c - col0),
                ws, [&](int r, int j, float v) {
    const int row = r0 + r, col = col0 + j;
    float res;
    if (pool_win) {
      const int m = pool_win / 2, b = row / n, i = row % n;
      const T* p = x + ((size_t)b * pool_win * pool_win +
                        (size_t)(2 * (i / m)) * pool_win + 2 * (i % m)) * c + col;
      res = fmaxf(fmaxf(to_f(p[0]), to_f(p[c])),
                  fmaxf(to_f(p[(size_t)pool_win * c]),
                        to_f(p[(size_t)(pool_win + 1) * c])));
    } else {
      res = to_f(x[(size_t)row * c + col]);
    }
    const float proj = v + to_f(bias[col]);
    out[(size_t)row * c + col] =
        from_f<T>(round_proj ? res + rnd<T>(proj) : res + proj);
  });
}

// Output columns per block, a multiple of the weight tile: the columns
// split until about four blocks per SM cover rows_total rows.
int block_cols(int rows_total, int n_cols) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_blocks = (rows_total + kRows - 1) / kRows;
  const int tiles = (n_cols + kTileN - 1) / kTileN;
  const int splits =
      std::max(1, std::min(tiles, (4 * sms + row_blocks - 1) / row_blocks));
  return (tiles + splits - 1) / splits * kTileN;
}

size_t ln_heads_smem(int c_in) {
  return sizeof(float) * ((size_t)kRows * c_in + kWs);
}

size_t proj_res_smem(int c) {
  return sizeof(float) * ((size_t)kRows * c + kWs);
}

template <typename T>
cudaError_t launch_ln_heads(const void* x, const void* ln_s, const void* ln_b,
                            const void* w, const void* b, void* out,
                            int rows_total, int n, int c_in, int n_out,
                            int heads, int hd, float eps, cudaStream_t stream) {
  size_t smem = ln_heads_smem(c_in);
  cudaError_t err = cudaFuncSetAttribute(
      ln_heads_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int cols = block_cols(rows_total, n_out);
  dim3 grid((rows_total + kRows - 1) / kRows, (n_out + cols - 1) / cols);
  ln_heads_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)ln_s, (const float*)ln_b, (const T*)w, (const T*)b,
      (T*)out, rows_total, n, c_in, n_out, cols, heads, hd, eps);
  return cudaGetLastError();
}

cudaError_t launch_proj_res_f32(const void* x, const void* o, const void* w, const void* b,
                                void* out, int rows_total, int n, int heads, int hd,
                                int pool_win, int round_proj, cudaStream_t stream) {
  size_t smem = proj_res_smem(heads * hd);
  cudaError_t err = cudaFuncSetAttribute(
      proj_res_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int c = heads * hd, cols = block_cols(rows_total, c);
  dim3 grid((rows_total + kRows - 1) / kRows, (c + cols - 1) / cols);
  proj_res_kernel<float><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)o, (const float*)w, (const float*)b, (float*)out,
      rows_total, n, cols, heads, hd, pool_win, round_proj);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bfloat16
using tc::bf16;

// ln_qkv's store: out[s][b][h][i][d] = bf16(acc + bias[col]) for output
// column col = s·c_out + h·hd + d of row b·n + i; hd even.
struct HeadsEpi {
  const bf16* bias;
  bf16* out;
  int n, heads, hd, c_out;
  size_t slab;  // rows_total · c_out: one of q, k, v
  struct Col {
    float2 bb;
    size_t off;  // s·slab + h·n·hd + d
  };
  __device__ size_t row(int r) const {
    return ((size_t)(r / n) * heads * n + r % n) * hd;
  }
  __device__ Col col(int c) const {
    const int s = c / c_out, h = (c % c_out) / hd, d = c % hd;
    return {tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + c)),
            s * slab + (size_t)h * n * hd + d};
  }
  __device__ void store(size_t r, Col c, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + r + c.off) = tc::pack_bf16(v0 + c.bb.x, v1 + c.bb.y);
  }
};

// attn_proj_residual's A operand, concat_heads(o) with o (B, heads, n,
// HD): row r = b·n + i at depth kk = h·HD + d lies at o[b][h][i][d]; HD
// a multiple of 8, so the 8 elements from kk on are in one head. HD is a
// template argument: the GEMM asks for an address per 16-byte piece of
// every k tile, and a division by a constant is a multiply.
template <int HD>
struct HeadsA {
  int n, heads;
  __device__ size_t at(int r, int kk, int) const {
    const int b = r / n, i = r - b * n, h = kk / HD;
    return (((size_t)b * heads + h) * n + i) * HD + (kk - h * HD);
  }
};

// The same operand at any head width hd that is a multiple of 8, hd a
// runtime value (one division by it per 16-byte piece): the head widths
// HeadsA has no instance for. The pieces are 16-byte aligned and never
// straddle a head, since kk and hd are multiples of 8.
struct HeadsAnyA {
  int n, heads, hd;
  __device__ size_t at(int r, int kk, int) const {
    const int b = r / n, i = r - b * n, h = kk / hd;
    return (((size_t)b * heads + h) * n + i) * hd + (kk - h * hd);
  }
};

// attn_proj_residual's store: out[r][c] = bf16(res + p) with p = acc +
// bias[c], rounded to bf16 first where round_proj asks; res = x[r][c],
// or with pool_win the max of the 2×2 patch of window-major rows whose
// top-left row row(r) locates (b·pool_win² + 2·(i / m)·pool_win +
// 2·(i % m), m = pool_win / 2). Residuals are read as bf16 pairs.
struct ProjResEpi {
  const bf16* bias;
  const bf16* x;
  bf16* out;
  int c, n, pool_win, round_proj;
  struct Row {
    size_t out, res;  // element offsets of the output row and the residual row
  };
  struct Col {
    float2 bb;
    int col;
  };
  __device__ Row row(int r) const {
    if (!pool_win) return {(size_t)r * c, (size_t)r * c};
    const int m = pool_win / 2, b = r / n, i = r % n;
    return {(size_t)r * c, ((size_t)b * pool_win * pool_win +
                            (size_t)(2 * (i / m)) * pool_win + 2 * (i % m)) * c};
  }
  __device__ Col col(int cc) const {
    return {tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + cc)), cc};
  }
  __device__ float2 pair(size_t at) const {
    return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
  }
  __device__ void store(Row r, Col cv, float v0, float v1) const {
    const size_t at = r.res + cv.col;
    float2 res = pair(at);
    if (pool_win) {
      const float2 a = pair(at + c), b = pair(at + (size_t)pool_win * c),
                   d = pair(at + (size_t)(pool_win + 1) * c);
      res = make_float2(fmaxf(fmaxf(res.x, a.x), fmaxf(b.x, d.x)),
                        fmaxf(fmaxf(res.y, a.y), fmaxf(b.y, d.y)));
    }
    float2 p = make_float2(v0 + cv.bb.x, v1 + cv.bb.y);
    if (round_proj) p = tc::unpack_bf16(tc::pack_bf16(p.x, p.y));
    *reinterpret_cast<uint32_t*>(out + r.out + cv.col) = tc::pack_bf16(res.x + p.x, res.y + p.y);
  }
};

}  // namespace

// Shared-memory bytes of a float32 ln_qkv or attn_proj_residual launch
// (the wrapper refuses widths above the 227 KB a block can hold), and of
// the bf16 path's LN pre-pass at width c_in and one GEMM block of bm rows
// — the GEMM of both bf16 kernels (the wrappers' plans,
// ops/cuda/global_attn.py ln_qkv_plan and proj_res_plan, must agree).
extern "C" long long cv_ln_heads_smem(int c_in) {
  return (long long)ln_heads_smem(c_in);
}
extern "C" long long cv_proj_res_smem(int c) {
  return (long long)proj_res_smem(c);
}
extern "C" long long cv_ln_heads_ln_smem(int c_in) { return (long long)tcg::ln_smem(c_in); }
extern "C" long long cv_ln_heads_gemm_smem(int bm) { return (long long)tcg::gemm_smem(bm); }

// float32 on the FMA units. x (B, N, c_in); w (n_out, c_in) in torch
// Linear layout with n_out = slabs·heads·hd; out (slabs, B, heads, N,
// hd); ln_s and ln_b float32.
extern "C" int cv_ln_heads_f32(const void* x, const void* ln_s, const void* ln_b,
                               const void* w, const void* b, void* out, int batch, int n,
                               int c_in, int n_out, int heads, int hd, float eps,
                               void* stream) {
  return (int)launch_ln_heads<float>(x, ln_s, ln_b, w, b, out, batch * n, n, c_in, n_out,
                                     heads, hd, eps, (cudaStream_t)stream);
}

// bfloat16 on the tensor cores: the same function and layouts; x, w and
// the workspace xn (B·N·c_in bf16) 16-byte aligned, c_in a multiple of 8,
// hd even; bm (128 or 64) from the wrapper's plan. ln_c ≤ c_in is the
// rows' true width, the LayerNorm's divisor (x, w's columns and the LN
// parameters zero-padded from ln_c to c_in).
extern "C" int cv_ln_heads_bf16(const void* x, const void* ln_s, const void* ln_b,
                                const void* w, const void* b, void* out, void* xn, int batch,
                                int n, int c_in, int n_out, int heads, int hd, int ln_c,
                                float eps, int bm, void* stream) {
  const int rows = batch * n;
  if (rows < 1 || c_in < 8 || c_in % 8 || hd < 2 || hd % 2 || heads < 1 ||
      n_out % (heads * hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = tcg::launch_ln_rows((const bf16*)x, (const float*)ln_s, (const float*)ln_b,
                                        (bf16*)xn, rows, c_in, ln_c, eps, s);
  if (err != cudaSuccess) return (int)err;
  const int c_out = heads * hd;
  return (int)tcg::launch_gemm(
      bm, (const bf16*)xn, (const bf16*)w, rows, n_out, c_in,
      HeadsEpi{(const bf16*)b, (bf16*)out, n, heads, hd, c_out, (size_t)rows * c_out}, s);
}

// float32 on the FMA units. o (B, heads, N, hd); w (c, c); out (B, N,
// c); x (B, N, c), or (B, N·4, c) window-major rows with pool_win > 0
// (N = pool_win²/4).
extern "C" int cv_proj_res_f32(const void* x, const void* o, const void* w, const void* b,
                               void* out, int batch, int n, int heads, int hd, int pool_win,
                               int round_proj, void* stream) {
  return (int)launch_proj_res_f32(x, o, w, b, out, batch * n, n, heads, hd, pool_win,
                                  round_proj, (cudaStream_t)stream);
}

// bfloat16 on the tensor cores: the same function and layouts through
// tc_gemm.cuh's GEMM; o, w 16-byte aligned, x and b 4-byte, hd a
// multiple of 8; a_width the A layout (ops/cuda/global_attn.py
// proj_a_width): hd for the instances at the Hiera head widths 56, 72,
// 96 (b+, L, t/s), 0 for the runtime-width layout; bm (128 or 64) from
// the wrapper's plan (proj_res_plan).
extern "C" int cv_proj_res_bf16(const void* x, const void* o, const void* w, const void* b,
                                void* out, int batch, int n, int heads, int hd, int pool_win,
                                int round_proj, int a_width, int bm, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || hd < 8 || hd % 8 || pool_win < 0 || pool_win % 2 ||
      (a_width && a_width != hd))
    return (int)cudaErrorInvalidValue;
  const int c = heads * hd;
  const ProjResEpi epi{(const bf16*)b, (const bf16*)x, (bf16*)out, c, n, pool_win, round_proj};
  auto run = [&](auto a_layout) {
    return (int)tcg::launch_gemm(bm, (const bf16*)o, (const bf16*)w, batch * n, c, c, epi,
                                 (cudaStream_t)stream, a_layout);
  };
  switch (a_width) {
    case 56: return run(HeadsA<56>{n, heads});
    case 72: return run(HeadsA<72>{n, heads});
    case 96: return run(HeadsA<96>{n, heads});
    case 0: return run(HeadsAnyA{n, heads, hd});
    default: return (int)cudaErrorInvalidValue;
  }
}
