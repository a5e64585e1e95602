// Non-causal softmax attention with online softmax: o = softmax(q·kᵀ·s)·v
// over (B, H, Nq, D) × (B, H, Nk, D), s = D^-0.5, scores never leaving
// the SM.
//
// Replaces jax's TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention, which the JAX
// package calls at circuitvision_tpu/models/sam2/hiera.py:487 for the
// Hiera global blocks) and serves the large-window routes of the window
// and q-pool blocks (window_attn.cu's blocks do not fit shared memory
// there). With pool_win > 0, q is the full-resolution window-major
// (B, H, pool_win², D) tensor and row i of the attention is the 2×2
// max-pool of q taken as it is loaded (Nq = pool_win²/4).
// Numerics follow jax's kernel: f32 scores and running max/sum, the
// unnormalised probabilities rounded to the compute dtype for the p·v
// product (accumulated in f32), the f32 sum of the unrounded ones as the
// divisor, and the result rounded once.
// What bounds it on the H100: 4·Nq·Nk·D FLOPs against (2·Nq + 2·Nk)·D
// elements, N/2 ≈ 2000 FLOP/byte in bf16 at the global blocks (N 4096,
// D 72): the arithmetic, far above the ridge; memory never is. The
// design keeps one 64-row q tile in shared memory and streams 64-row k/v
// tiles past it; each of 256 threads owns a quarter of one q row's keys
// and output columns, so the row's max and sum reduce over four
// neighbouring lanes by shuffles. D = 72 is handled as it is (row stride D + 1 in shared
// memory, so the eight rows a warp touches fall in distinct banks), not
// padded to 128. The products are f32 FMA loops over shared memory;
// tensor-core tiles are the next step.
#include <cmath>

#include "common.cuh"

namespace {

using namespace cvk;

constexpr int kBQ = 64;    // q rows per block
constexpr int kBK = 64;    // keys per streamed tile
constexpr int kMaxD = 128;  // largest head width
constexpr int kLanes = kThreads / kBQ;  // threads sharing one q row (4)

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
             int hd, int pool_win, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;             // kBQ × ld
  float* ks = qs + kBQ * ld;    // kBK × ld
  float* vs = ks + kBK * ld;    // kBK × ld
  float* ps = vs + kBK * ld;    // kBQ × (kBK + 1): this tile's probabilities
  const int tid = threadIdx.x, r = tid / kLanes, sub = tid % kLanes;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + bh * (size_t)(pool_win ? pool_win * pool_win : nq) * hd;
  const T* kb = k + bh * (size_t)nk * hd;
  const T* vb = v + bh * (size_t)nk * hd;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, d = e % hd, qi = q0 + i;
    float val = 0.f;
    if (qi < nq) {
      if (pool_win) {
        const int m = pool_win / 2;
        const T* a = qb + ((size_t)(2 * (qi / m)) * pool_win + 2 * (qi % m)) * hd + d;
        val = fmaxf(fmaxf(to_f(a[0]), to_f(a[hd])),
                    fmaxf(to_f(a[(size_t)pool_win * hd]),
                          to_f(a[(size_t)(pool_win + 1) * hd])));
      } else {
        val = to_f(qb[(size_t)qi * hd + d]);
      }
    }
    qs[i * ld + d] = val;
  }

  constexpr int kPerK = kBK / kLanes;    // keys per thread per tile (16)
  constexpr int kPerD = kMaxD / kLanes;  // output columns per thread (≤ 32)
  float m_run = -INFINITY, l_run = 0.f;
  float acc[kPerD];
#pragma unroll
  for (int dd = 0; dd < kPerD; ++dd) acc[dd] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd, d = e % hd, kj = k0 + j;
      const bool in = kj < nk;
      ks[j * ld + d] = in ? to_f(kb[(size_t)kj * hd + d]) : 0.f;
      vs[j * ld + d] = in ? to_f(vb[(size_t)kj * hd + d]) : 0.f;
    }
    __syncthreads();

    float s[kPerK];
#pragma unroll
    for (int jj = 0; jj < kPerK; ++jj) s[jj] = 0.f;
    const float* qr = qs + r * ld;
    for (int d = 0; d < hd; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int jj = 0; jj < kPerK; ++jj) s[jj] += qv * ks[(sub + kLanes * jj) * ld + d];
    }
    float m_tile = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kPerK; ++jj) {
      s[jj] = (k0 + sub + kLanes * jj < nk) ? s[jj] * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[jj]);
    }
    // the kLanes threads of a row are neighbouring lanes of one warp
    for (int off = 1; off < kLanes; off <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float l_tile = 0.f;
    float* pr = ps + r * (kBK + 1);
#pragma unroll
    for (int jj = 0; jj < kPerK; ++jj) {
      const float p = expf(s[jj] - m_new);
      l_tile += p;
      pr[sub + kLanes * jj] = rnd<T>(p);
    }
    for (int off = 1; off < kLanes; off <<= 1)
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, off);
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
    __syncwarp();  // the row's probabilities come from its own warp

#pragma unroll
    for (int dd = 0; dd < kPerD; ++dd) acc[dd] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * ld;
#pragma unroll
      for (int dd = 0; dd < kPerD; ++dd) {
        const int d = sub + kLanes * dd;
        if (d < hd) acc[dd] += p * vr[d];
      }
    }
  }

  const int qi = q0 + r;
  if (qi < nq) {
    const float inv = 1.f / l_run;
    T* orow = o + (bh * nq + qi) * (size_t)hd;
#pragma unroll
    for (int dd = 0; dd < kPerD; ++dd) {
      const int d = sub + kLanes * dd;
      if (d < hd) orow[d] = from_f<T>(acc[dd] * inv);
    }
  }
}

size_t flash_smem(int hd) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (hd + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int bh, int nq, int nk, int hd, int pool_win,
                         cudaStream_t stream) {
  if (hd < 1 || hd > kMaxD || nk < 1) return cudaErrorInvalidValue;
  size_t smem = flash_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + kBQ - 1) / kBQ, bh);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, nq, nk, hd, pool_win,
      (float)(1.0 / std::sqrt((double)hd)));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (bh, nq, hd) — or (bh, pool_win²,
// hd) with pool_win > 0, nq = pool_win²/4 — k, v (bh, nk, hd), o (bh, nq,
// hd); bh = batch·heads.
extern "C" int cv_flash_attn(const void* q, const void* k, const void* v,
                             void* o, int bh, int nq, int nk, int hd,
                             int pool_win, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_flash<float>(q, k, v, o, bh, nq, nk, hd, pool_win, s);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, o, bh, nq, nk, hd, pool_win, s);
  return (int)cudaErrorInvalidValue;
}
