// Hiera windowed-attention halves, one block per window.
//
// Replaces two Pallas kernels of the JAX package
// (circuitvision_tpu/ops/pallas/window_attn.py):
//   * window_attn_block: out = x + proj(softmax(q·kᵀ·s)·v), qkv = W·LN1(x);
//   * qpool_attn_block, the stage-transition block: xn = LN1(x),
//     skip = maxpool2×2(xn·Wskip + b), q = maxpool2×2(q(xn)), k, v from
//     xn, out = skip + proj(attention).
// What bounds them on the H100: per window the qkv/skip/proj products
// dominate, about 8·T·C² FLOPs (plus the T²·C of the scores) against
// 4·T·C bytes of activations — 2·C ≈ 190-380 FLOP/byte at the slice's
// widths, at or above the bf16 ridge, so the products are the limit
// again. The design keeps a whole window (≤ 64 tokens) — its LN output,
// q/k/v and scores — in shared memory, so each activation is read once
// and written once (the residual re-reads the input tile from L2), as in
// the Pallas kernel, without its 128-row window packing and
// block-diagonal masks: a block simply owns one window. Buffers are
// reused (scores in the LN buffer, each head's output over its q
// columns) so a 64-token, 96-wide window needs 107 KB and two blocks
// share an SM. The products run as staged-tile f32 FMA loops
// (common.cuh block_gemm); tensor cores are the next step.
#include <algorithm>
#include <cmath>

#include "common.cuh"

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

}  // namespace

// Shared-memory bytes a launch needs (the wrappers refuse shapes above
// the 227 KB a block can hold).
extern "C" long long cv_window_attn_smem(int t, int c) {
  return (long long)window_smem(t, c);
}
extern "C" long long cv_qpool_attn_smem(int win, int c_in, int c_out) {
  return (long long)qpool_smem(win, c_in, c_out);
}

// dtype: 0 = float32, 1 = bfloat16. x is (n_win, t, c); weights in torch
// Linear layout: wqkv (3c, c), wproj (c, c); ln_s and ln_b float32 for
// either dtype (here and in cv_qpool_attn).
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
    return launch_window<__nv_bfloat16>(x, ln_s, ln_b, wqkv, bqkv, wproj,
                                        bproj, out, n_win, t, c, heads, eps,
                                        s);
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
