// Hiera windowed-attention halves.
//
// Replaces two Pallas kernels of the JAX package
// (circuitvision_tpu/ops/pallas/window_attn.py):
//   * window_attn_block: out = x + proj(softmax(q·kᵀ·s)·v), qkv = W·LN1(x);
//   * qpool_attn_block, the stage-transition block: xn = LN1(x),
//     skip = maxpool2×2(xn·Wskip + b), q = maxpool2×2(q(xn)), k, v from
//     xn, out = skip + proj(attention).
// What bounds them on the H100: per window the qkv/skip/proj products
// dominate, about 8·T·C² FLOPs (plus the T²·C of the scores) against
// 4·T·C bytes of activations — 2·C ≈ 190-580 FLOP/byte at the Hiera
// widths, at or above the bf16 ridge (295), so the products are the
// limit. Per Hiera-L@1024 analyze() the 7 window_attn_block launches
// (1024 windows of 64 tokens at C = 144, 1024 of 16 at C = 288) are
// ≈ 83 GFLOP, 0.083 ms at 989 TFLOP/s; every block also streams all of
// Wqkv and Wproj (8·C² bytes) from L2, 64 FLOPs per byte at 64 rows.
//
// window_attn_block, bfloat16 — window_tc_kernel, tensor cores. A block
// owns 64 rows: one window at T = 64, four at T = 16 (two at T = 32), so
// every product has 64 rows and the 16-token windows are not 64-row
// tiles three-quarters empty. 8 warps.
//   1. LN1 through common.cuh's layernorm_rows, eight rows at a time
//      staged in f32 (each warp loads, normalises and stores its own
//      row), into a bf16 tile: bit for bit the f32 kernel's xn.
//   2. qkv = bf16(xn·Wqkvᵀ + b) and, after attention, out = bf16(x +
//      bf16(o·Wprojᵀ + b)) — x read again from L2 — as mma.sync m16n8k16
//      with ldmatrix: each warp 16 rows × 24 columns of a 48-row weight
//      tile (48 divides C and 3C at the t, s and L widths; a ragged
//      last tile is zero-filled and not stored); weight tiles of the
//      whole depth C stream through a double buffer filled by cp.async,
//      the next tile's copy in flight while this one's products run (the
//      first Wproj tile's across the attention).
//   3. Attention per (16-row slab, head), one warp each, on mma.sync:
//      S = q·kᵀ over the slab's own window (T ≤ 64 keys: at T = 16 each
//      window-head is one m16 tile against its 16 keys, not a masked
//      64×64 tile), depth hd in 16-deep steps, the last half-step of
//      hd = 72 (or 56) zeroed in registers; then the exact softmax —
//      f32 scores × scale, max, exp and sum over the quad — with P
//      rounded to bf16 as it becomes the A fragment of P·V (V through
//      ldmatrix.trans); O = bf16(P·V) overwrites the slab's q columns.
// Why mma.sync rather than wgmma: rows of the head width (144 bytes at
// hd = 72) and of C = 144 or 288 (288, 576 bytes) are not whole 128-byte
// swizzle spans, so wgmma's descriptors would need a re-laid copy of q,
// k, v and o; the warp-level product reads them as they are, each row
// padded by 16 bytes so the eight rows one ldmatrix reads fall in
// distinct bank groups, and at 64 rows a block the products are small
// enough that mma.sync's rate is not the limit. Shared memory (bf16): xn
// 64 × (C + 8), q|k|v 64 × (3C + 8), two weight tiles 48 × (C + 8) —
// 104,960 bytes at C = 144, so two blocks share an SM (113 registers a
// thread); 206,336 at C = 288, one. T ∈ {16, 32, 64}; head widths 56,
// 72 and 96, those of Hiera-b+, -L and -t/-s (template instances).
// Measured per Hiera-L@1024 analyze() (chip_smoke.py, H100 80GB HBM3 at
// 700 W, parent and this design in one call): 1.03 ms against the
// FMA kernel's 16.77, 80 TFLOP/s at both shapes.
//
// window_attn_block in float32, and qpool_attn_block in both dtypes —
// one block per window, f32 FMA loops: the whole window (≤ 64 tokens) —
// its LN output, q/k/v and scores — in shared memory as float32, so
// each activation is read once and written once (the residual re-reads
// the input tile from L2), as in the Pallas kernel, without its 128-row
// window packing and block-diagonal masks. Buffers are reused (scores
// in the LN buffer, each head's output over its q columns) so a
// 64-token, 96-wide window needs 107 KB and two blocks share an SM. The
// products run as staged-tile f32 FMA loops (common.cuh block_gemm);
// TF32 would not hold the float32 card-against-CPU check.
#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "tc.cuh"

namespace {

using namespace cvk;

constexpr int kWs = kTileK * (kTileN + 1);

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, const T* __restrict__ wqkv,
                   const T* __restrict__ bqkv, const T* __restrict__ wproj,
                   const T* __restrict__ bproj, T* __restrict__ out, int t,
                   int c, int heads, float scale, float eps) {
  extern __shared__ float smem[];
  // xn: LN1 output, then one head's scores (t·t ≤ t·c floats).
  // qkv: the input first, then q|k|v; each head's attention output
  // overwrites that head's q columns once its scores exist.
  float* xn = smem;
  float* qkv = xn + max(t * c, t * t);  // t × 3c
  float* ws = qkv + 3 * t * c;
  const size_t base = (size_t)blockIdx.x * t * c;
  const T* xb = x + base;

  for (int e = threadIdx.x; e < t * c; e += kThreads) qkv[e] = to_f(xb[e]);
  __syncthreads();
  layernorm_rows<T>(qkv, xn, t, c, ln_s, ln_b, eps);
  rows_gemm<T>(xn, c, t, c, wqkv, c, 3 * c, ws, [&](int r, int n, float v) {
    qkv[r * 3 * c + n] = rnd<T>(v + to_f(bqkv[n]));
  });
  window_attention<T>(qkv, 3 * c, qkv + c, 3 * c, qkv + 2 * c, 3 * c, qkv,
                      3 * c, xn, t, t, heads, c / heads, scale);
  T* ob = out + base;
  rows_gemm<T>(qkv, 3 * c, t, c, wproj, c, c, ws, [&](int r, int n, float v) {
    float proj = rnd<T>(v + to_f(bproj[n]));
    ob[r * c + n] = from_f<T>(to_f(xb[r * c + n]) + proj);
  });
}

// 2×2 max-pool of a window-major (win × win, row stride ld) map into
// (win/2)² rows.
__device__ void pool2x2(const float* src, int ld, float* dst, int win, int c) {
  const int m = win / 2;
  for (int e = threadIdx.x; e < m * m * c; e += kThreads) {
    int p = e / c, ch = e % c;
    int i = 2 * (p / m), j = 2 * (p % m);
    const float* a = src + (size_t)(i * win + j) * ld + ch;
    float v = fmaxf(fmaxf(a[0], a[ld]), fmaxf(a[win * ld], a[(win + 1) * ld]));
    dst[(size_t)p * c + ch] = v;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qpool_attn_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const T* __restrict__ wskip,
                  const T* __restrict__ bskip, const T* __restrict__ wqkv,
                  const T* __restrict__ bqkv, const T* __restrict__ wproj,
                  const T* __restrict__ bproj, T* __restrict__ out, int win,
                  int c_in, int c_out, int heads, float scale, float eps) {
  extern __shared__ float smem[];
  const int t = win * win, tq = t / 4;
  float* xn = smem;                   // t × c_in, later tq × c_out attn out
  float* kv = xn + t * c_in;          // t × 2c_out (scratch for skip and q)
  float* skp = kv + 2 * t * c_out;    // tq × c_out pooled shortcut
  float* qp = skp + tq * c_out;       // tq × c_out pooled q
  float* s = qp + tq * c_out;         // tq × t
  float* ws = s + tq * t;
  const T* xb = x + (size_t)blockIdx.x * t * c_in;

  for (int e = threadIdx.x; e < t * c_in; e += kThreads) kv[e] = to_f(xb[e]);
  __syncthreads();
  layernorm_rows<T>(kv, xn, t, c_in, ln_s, ln_b, eps);
  // shortcut, then q: full resolution into kv, pooled out of it
  rows_gemm<T>(xn, c_in, t, c_in, wskip, c_in, c_out, ws,
               [&](int r, int n, float v) {
                 kv[r * c_out + n] = rnd<T>(v + to_f(bskip[n]));
               });
  pool2x2(kv, c_out, skp, win, c_out);
  rows_gemm<T>(xn, c_in, t, c_in, wqkv, c_in, c_out, ws,
               [&](int r, int n, float v) {
                 kv[r * c_out + n] = rnd<T>(v + to_f(bqkv[n]));
               });
  pool2x2(kv, c_out, qp, win, c_out);
  rows_gemm<T>(xn, c_in, t, c_in, wqkv + (size_t)c_out * c_in, c_in,
               2 * c_out, ws, [&](int r, int n, float v) {
                 kv[r * 2 * c_out + n] = rnd<T>(v + to_f(bqkv[c_out + n]));
               });
  window_attention<T>(qp, c_out, kv, 2 * c_out, kv + c_out, 2 * c_out, xn,
                      c_out, s, tq, t, heads, c_out / heads, scale);
  T* ob = out + (size_t)blockIdx.x * tq * c_out;
  rows_gemm<T>(xn, c_out, tq, c_out, wproj, c_out, c_out, ws,
               [&](int r, int n, float v) {
                 float proj = rnd<T>(v + to_f(bproj[n]));
                 ob[r * c_out + n] = from_f<T>(skp[r * c_out + n] + proj);
               });
}

// Softmax scale from the head width, 1/sqrt(c / heads).
float head_scale(int c, int heads) {
  return (float)(1.0 / std::sqrt((double)(c / heads)));
}

size_t window_smem(int t, int c) {
  return sizeof(float) *
         (std::max((size_t)t * c, (size_t)t * t) + (size_t)3 * t * c + kWs);
}

size_t qpool_smem(int win, int c_in, int c_out) {
  size_t t = (size_t)win * win, tq = t / 4;
  return sizeof(float) *
         (t * c_in + 2 * t * c_out + 2 * tq * c_out + tq * t + kWs);
}

template <typename T>
cudaError_t launch_window(const void* x, const void* ln_s, const void* ln_b,
                          const void* wqkv, const void* bqkv,
                          const void* wproj, const void* bproj, void* out,
                          int n_win, int t, int c, int heads, float eps,
                          cudaStream_t stream) {
  size_t smem = window_smem(t, c);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  window_attn_kernel<T><<<n_win, kThreads, smem, stream>>>(
      (const T*)x, (const float*)ln_s, (const float*)ln_b, (const T*)wqkv,
      (const T*)bqkv, (const T*)wproj, (const T*)bproj, (T*)out, t, c, heads,
      head_scale(c, heads), eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qpool(const void* x, const void* ln_s, const void* ln_b,
                         const void* wskip, const void* bskip,
                         const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bproj, void* out,
                         int n_win, int win, int c_in, int c_out, int heads,
                         float eps, cudaStream_t stream) {
  size_t smem = qpool_smem(win, c_in, c_out);
  cudaError_t err = cudaFuncSetAttribute(
      qpool_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  qpool_attn_kernel<T><<<n_win, kThreads, smem, stream>>>(
      (const T*)x, (const float*)ln_s, (const float*)ln_b, (const T*)wskip,
      (const T*)bskip, (const T*)wqkv, (const T*)bqkv, (const T*)wproj,
      (const T*)bproj, (T*)out, win, c_in, c_out, heads,
      head_scale(c_out, heads), eps);
  return cudaGetLastError();
}


// ------------------------------------------------------------ bfloat16
using tc::bf16;

constexpr int kTcRows = 64;               // rows a block owns: 64 / t windows
constexpr int kTcBN = 48;                 // weight rows per staged tile
constexpr int kTcWarps = kThreads / 32;   // 8

// Shared memory of one bf16 block at width c: xn (64 rows), q|k|v (64
// rows of 3c) and two staged weight tiles (48 rows of c), all bf16, each
// row padded by 16 bytes so the eight rows one ldmatrix reads fall in
// distinct bank groups (c a multiple of 16).
size_t window_tc_smem(int c) {
  return sizeof(bf16) * ((size_t)kTcRows * (c + 8) + (size_t)kTcRows * (3 * c + 8) +
                         (size_t)2 * kTcBN * (c + 8));
}

// NT: the head width in 8-column tiles (hd = 8·NT). A block owns 64 rows
// (64 / t windows of t ∈ {16, 32, 64} tokens); rows past rows_total are
// zero and never stored.
template <int NT>
__global__ void __launch_bounds__(kThreads)
window_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                 const bf16* __restrict__ bqkv, const bf16* __restrict__ wproj,
                 const bf16* __restrict__ bproj, bf16* __restrict__ out, int rows_total,
                 int t, int c, int heads, float scale, float eps) {
  constexpr int hd = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = c + 8, ldq = 3 * c + 8;
  bf16* xn = reinterpret_cast<bf16*>(smem_raw);  // 64 × ldx: LN1(x)
  bf16* qkv = xn + kTcRows * ldx;                // 64 × ldq: q | k | v, o over q
  bf16* ring = qkv + kTcRows * ldq;              // 2 × 48 × ldx: weight tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int r0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, rows_total - r0);
  const int n_qkv = (3 * c + kTcBN - 1) / kTcBN;
  const int n_tiles = n_qkv + (c + kTcBN - 1) / kTcBN;
  const int chunks = c / 8;  // 16-byte pieces of a row of c

  // weight tile j into buffer j % 2: rows [48j, 48j + 48) of wqkv for
  // j < n_qkv, then of wproj; rows past the weight's end zero-filled
  auto load_w = [&](int j) {
    const bool proj = j >= n_qkv;
    const bf16* w = proj ? wproj : wqkv;
    const int n_rows = proj ? c : 3 * c, n0 = (proj ? j - n_qkv : j) * kTcBN;
    bf16* dst = ring + (j % 2) * kTcBN * ldx;
    for (int e = tid; e < kTcBN * chunks; e += kThreads) {
      const int r = e / chunks, c8 = (e % chunks) * 8;
      const bool in = n0 + r < n_rows;
      tc::cp_async16(dst + r * ldx + c8, w + (in ? (size_t)(n0 + r) * c + c8 : 0), in);
    }
  };
  load_w(0);
  tc::cp_async_commit();

  // LN1, eight rows at a time through layernorm_rows, staged in float32
  // in the second weight buffer: warp w loads, normalises (layernorm_rows
  // gives row w to warp w) and stores row w, so only the warp syncs.
  {
    float* row_f = reinterpret_cast<float*>(ring + kTcBN * ldx) + warp * c;
    for (int q0 = 0; q0 < kTcRows; q0 += kTcWarps) {
      const int n_r = max(0, min(kTcWarps, rows - q0));
      if (warp < n_r) {
        const bf16* xr = x + (size_t)(r0 + q0 + warp) * c;
        for (int i = lane; i < c; i += 32) row_f[i] = to_f(xr[i]);
      }
      __syncwarp();
      layernorm_rows<bf16>(row_f - warp * c, row_f - warp * c, n_r, c, ln_s, ln_b, eps);
      __syncwarp();
      bf16* xw = xn + (q0 + warp) * ldx;
      for (int i = lane; i < c; i += 32)
        xw[i] = __float2bfloat16(warp < n_r ? row_f[i] : 0.f);
      __syncwarp();
    }
  }

  // the two products: 16 rows × 24 columns of each 48-column tile a warp
  const int mrow = (warp % 4) * 16, ncol = (warp / 4) * 24;
  for (int j = 0; j < n_tiles; ++j) {
    const bool proj = j >= n_qkv;
    if (j == n_qkv) {
      __syncthreads();  // q, k, v are complete
      // attention per (16-row slab, head), one warp each: S = q·kᵀ over
      // the slab's window (t ≤ 64 keys, the whole row in registers),
      // exact softmax, O = bf16(P·V) over the slab's q columns
      const int nk8 = t / 8;
      constexpr int KS = (NT + 1) / 2;  // 16-deep steps over hd; an odd NT's last is half zero
      for (int u = warp; u < 4 * heads; u += kTcWarps) {
        const int q0 = (u / heads) * 16, h = u % heads, key0 = q0 / t * t;
        if (key0 >= rows) continue;
        const bf16* qb = qkv + h * hd;
        const bf16* kb = qkv + c + h * hd;
        const bf16* vb = qkv + 2 * c + h * hd;
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const bool half = NT % 2 == 1 && ks == KS - 1;  // depth hd..hd+15 is the next columns'
          uint32_t qf[4];
          tc::ldsm_x4(qf, qb + (q0 + lane % 16) * ldq + ks * 16 + (lane / 16) * 8);
          if (half) qf[2] = qf[3] = 0u;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (16 * jj >= t) break;
            uint32_t bk[4];
            tc::ldsm_x4(bk, kb + (key0 + jj * 16 + lane % 8 + (lane / 16) * 8) * ldq + ks * 16 +
                                ((lane / 8) % 2) * 8);
            if (half) bk[1] = bk[3] = 0u;
            tc::mma_bf16(s[2 * jj], qf, bk[0], bk[1]);
            tc::mma_bf16(s[2 * jj + 1], qf, bk[2], bk[3]);
          }
        }
        // rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8n + 2t + (e & 1);
        // the four lanes of a quad hold a row's keys
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (n < nk8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] *= scale;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (n < nk8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] = expf(s[n][e] - mx[e >> 1]);
              sum[e >> 1] += s[n][e];
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        }
        // O = P·V: P rounded to bf16 as it becomes the A fragment
        float o[NT][4];
#pragma unroll
        for (int d = 0; d < NT; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (16 * kk >= t) break;
          uint32_t pa[4];
          pa[0] = tc::pack_bf16(s[2 * kk][0] / sum[0], s[2 * kk][1] / sum[0]);
          pa[1] = tc::pack_bf16(s[2 * kk][2] / sum[1], s[2 * kk][3] / sum[1]);
          pa[2] = tc::pack_bf16(s[2 * kk + 1][0] / sum[0], s[2 * kk + 1][1] / sum[0]);
          pa[3] = tc::pack_bf16(s[2 * kk + 1][2] / sum[1], s[2 * kk + 1][3] / sum[1]);
          const bf16* vrow = vb + (key0 + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ldq;
#pragma unroll
          for (int dp = 0; dp < NT / 2; ++dp) {
            uint32_t bv[4];
            tc::ldsm_x4_t(bv, vrow + dp * 16 + (lane / 16) * 8);
            tc::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
            tc::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
          }
          if constexpr (NT % 2 == 1) {
            uint32_t bv[2];
            tc::ldsm_x2_t(bv, vrow + (NT - 1) * 8);
            tc::mma_bf16(o[NT - 1], pa, bv[0], bv[1]);
          }
        }
        __syncwarp();  // this slab's q is read; its o takes the same columns
#pragma unroll
        for (int d = 0; d < NT; ++d) {
          bf16* orow = qkv + (q0 + g) * ldq + h * hd + 8 * d + t2;
          *reinterpret_cast<uint32_t*>(orow) = tc::pack_bf16(o[d][0], o[d][1]);
          *reinterpret_cast<uint32_t*>(orow + 8 * ldq) = tc::pack_bf16(o[d][2], o[d][3]);
        }
      }
    }
    tc::cp_async_wait<0>();  // tile j has landed (the only group in flight)
    __syncthreads();         // ... for every thread; tile j − 1's buffer and o are free / ready
    if (j + 1 < n_tiles) load_w(j + 1);
    tc::cp_async_commit();

    const bf16* a = proj ? qkv : xn;
    const int lda = proj ? ldq : ldx;
    const bf16* wt = ring + (j % 2) * kTcBN * ldx;
    float acc[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int ks = 0; ks < c / 16; ++ks) {
      uint32_t af[4], b01[4], b2[2];
      tc::ldsm_x4(af, a + (mrow + lane % 16) * lda + ks * 16 + (lane / 16) * 8);
      tc::ldsm_x4(b01, wt + (ncol + lane % 8 + (lane / 16) * 8) * ldx + ks * 16 +
                           ((lane / 8) % 2) * 8);
      tc::ldsm_x2(b2, wt + (ncol + 16 + lane % 8) * ldx + ks * 16 + ((lane / 8) % 2) * 8);
      tc::mma_bf16(acc[0], af, b01[0], b01[1]);
      tc::mma_bf16(acc[1], af, b01[2], b01[3]);
      tc::mma_bf16(acc[2], af, b2[0], b2[1]);
    }
    const int n0 = (proj ? j - n_qkv : j) * kTcBN + ncol;
    const int n_cols = proj ? c : 3 * c;
    const bf16* bias = proj ? bproj : bqkv;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int col = n0 + 8 * i + t2;
      if (col >= n_cols) continue;
      const float2 bb = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mrow + g + 8 * hr;
        const float v0 = acc[i][2 * hr] + bb.x, v1 = acc[i][2 * hr + 1] + bb.y;
        if (!proj) {  // qkv = bf16(xn·Wqkvᵀ + b)
          *reinterpret_cast<uint32_t*>(qkv + row * ldq + col) = tc::pack_bf16(v0, v1);
        } else if (row < rows) {  // out = bf16(x + bf16(o·Wprojᵀ + b))
          const size_t at = (size_t)(r0 + row) * c + col;
          const float2 xr = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
          const float2 pr = tc::unpack_bf16(tc::pack_bf16(v0, v1));
          *reinterpret_cast<uint32_t*>(out + at) = tc::pack_bf16(xr.x + pr.x, xr.y + pr.y);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_window_tc(const void* x, const void* ln_s, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, void* out, int rows_total, int t, int c,
                             int heads, float eps, cudaStream_t stream) {
  const size_t smem = window_tc_smem(c);
  cudaError_t err = cudaFuncSetAttribute(
      window_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_tc_kernel<NT><<<(rows_total + kTcRows - 1) / kTcRows, kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)ln_s, (const float*)ln_b, (const bf16*)wqkv,
      (const bf16*)bqkv, (const bf16*)wproj, (const bf16*)bproj, (bf16*)out, rows_total, t, c,
      heads, head_scale(c, heads), eps);
  return cudaGetLastError();
}

// t ∈ {16, 32, 64}, c a multiple of 16, head width c / heads one of the
// instances below.
cudaError_t launch_window_bf16(const void* x, const void* ln_s, const void* ln_b,
                               const void* wqkv, const void* bqkv, const void* wproj,
                               const void* bproj, void* out, int n_win, int t, int c,
                               int heads, float eps, cudaStream_t stream) {
  if ((t != 16 && t != 32 && t != 64) || c < 16 || c % 16 || heads < 1 || c % heads)
    return cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, out, n_win * t, t, c, heads, eps,
                  stream);
  };
  switch (c / heads) {  // Hiera-b+, -L and -t/-s
    case 56: return run(launch_window_tc<7>);
    case 72: return run(launch_window_tc<9>);
    case 96: return run(launch_window_tc<12>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared-memory bytes a launch needs (the wrappers refuse shapes above
// the 227 KB a block can hold).
extern "C" long long cv_window_attn_smem(int t, int c, int dtype) {
  return (long long)(dtype == 1 ? window_tc_smem(c) : window_smem(t, c));
}
extern "C" long long cv_qpool_attn_smem(int win, int c_in, int c_out) {
  return (long long)qpool_smem(win, c_in, c_out);
}

// dtype: 0 = float32 (window_attn_kernel, FMA loops), 1 = bfloat16
// (window_tc_kernel, tensor cores; t ∈ {16, 32, 64}, c a multiple of 16,
// head width 56, 72 or 96, every bf16 pointer 16-byte aligned). x is (n_win, t, c); weights in torch Linear layout: wqkv
// (3c, c), wproj (c, c); ln_s and ln_b float32 for either dtype (here
// and in cv_qpool_attn).
extern "C" int cv_window_attn(const void* x, const void* ln_s,
                              const void* ln_b, const void* wqkv,
                              const void* bqkv, const void* wproj,
                              const void* bproj, void* out, int n_win, int t,
                              int c, int heads, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_window<float>(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, out,
                                n_win, t, c, heads, eps, s);
  if (dtype == 1)
    return (int)launch_window_bf16(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, out, n_win, t, c,
                                   heads, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x is (n_win·win², c_in) window-major rows; out (n_win·win²/4, c_out).
// wskip (c_out, c_in), wqkv (3·c_out, c_in), wproj (c_out, c_out).
extern "C" int cv_qpool_attn(const void* x, const void* ln_s,
                             const void* ln_b, const void* wskip,
                             const void* bskip, const void* wqkv,
                             const void* bqkv, const void* wproj,
                             const void* bproj, void* out, int n_win, int win,
                             int c_in, int c_out, int heads, float eps,
                             int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_qpool<float>(x, ln_s, ln_b, wskip, bskip, wqkv, bqkv, wproj,
                               bproj, out, n_win, win, c_in, c_out, heads, eps,
                               s);
  if (dtype == 1)
    return launch_qpool<__nv_bfloat16>(x, ln_s, ln_b, wskip, bskip, wqkv, bqkv,
                                       wproj, bproj, out, n_win, win, c_in,
                                       c_out, heads, eps, s);
  return (int)cudaErrorInvalidValue;
}
