// The backward of non-causal softmax attention, o = softmax(q·kᵀ·s)·v over
// (B·H, N, D), from the forward's residual lse = log Σ_k e^(q·kᵀ·s), the
// per-row log-sum-exp that flash_attn.cu's lse instances write:
//
//   P = exp(q·kᵀ·s − lse),  dV = Pᵀ·dO,  dP = dO·Vᵀ,  D = rowsum(dO∘O),
//   dS = P∘(dP − D),        dQ = dS·K·s,  dK = dSᵀ·Q·s.
//
// Replaces the two Pallas calls of jax's TPU flash-attention backward
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd_dkv :941 and _flash_attention_bwd_dq :1287), which
// the JAX package reaches when it differentiates the Hiera global blocks
// (models/sam2/hiera.py:270 under train/train_step.py). It computes what
// those compute, not block for block as they do.
//
// flash_bwd_dq_kernel — one block per (batch·head, 64 q rows). Its
// prologue computes D for its rows (warp-per-row dot products of dO and
// O) and writes it out; then it streams the 64-key tiles of K and V past
// its q and dO tiles, recomputes S and dP, forms dS and accumulates
// dQ += dS·K. flash_bwd_dkv_kernel — one block per (batch·head, 64
// keys), launched after it on the same stream: it keeps its K and V tiles,
// streams the 64-row tiles of q and dO with their lse and D, and
// accumulates dV += Pᵀ·dO and dK += dSᵀ·q. Scores and probabilities never
// leave the SM.
//
// The simple design: every product runs on the FMA units in float32,
// whatever the input dtype (bfloat16 inputs are widened as they load, the
// results rounded once as they are stored); each of the 256 threads owns a
// 4 × 4 sub-tile of a 64 × 64 score tile (rows ty + 16a, columns
// tx + 16b, so a warp's loads hit distinct banks or broadcast) and a
// 4 × 16·DC sub-tile of the 64 × D accumulators. D = 72 at SAM2.1-L's
// global blocks: 14·N²·D operations a head over about 10·N·D elements, so
// the work is bound by the operations; on the tensor cores (mma.sync, as
// the forward) it would run several times faster — later work.
#include <cmath>

#include "common.cuh"

namespace {

using namespace cvk;

constexpr int kB = 64;      // q rows and keys per tile
constexpr int kSide = 16;   // threads per side of the 16 × 16 thread grid
constexpr int kPer = kB / kSide;  // rows (and columns) of a score tile per thread
constexpr int kLdS = kB + 1;      // row stride of the score tiles in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory bytes of either kernel at head width hd: four 64-row
// tiles of width hd + 1, two 64 × 65 score tiles, lse and D of 64 rows.
__host__ __device__ size_t bwd_smem(int hd) {
  return sizeof(float) * ((size_t)4 * kB * (hd + 1) + (size_t)2 * kB * kLdS + 2 * kB);
}

// rows [row0, row0 + 64) of a (n, hd) row-major tensor into dst (row stride
// ld) as float32, rows past n zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int n, int hd,
                                          int ld) {
  for (int e = threadIdx.x; e < kB * hd; e += kThreads) {
    const int i = e / hd, d = e % hd, row = row0 + i;
    dst[i * ld + d] = row < n ? to_f(src[(size_t)row * hd + d]) : 0.f;
  }
}

// S = q·kᵀ and dP = dO·vᵀ over the 64 × 64 tile: this thread's rows
// ty + 16a and columns tx + 16b
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int hd, int ld, float s[kPer][kPer],
                                       float dp[kPer][kPer]) {
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) s[a][b] = dp[a][b] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float qa[kPer], da[kPer], kb[kPer], vb[kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      qa[a] = qs[(ty + kSide * a) * ld + d];
      da[a] = dos[(ty + kSide * a) * ld + d];
    }
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      kb[b] = ks[(tx + kSide * b) * ld + d];
      vb[b] = vs[(tx + kSide * b) * ld + d];
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        s[a][b] += qa[a] * kb[b];
        dp[a][b] += da[a] * vb[b];
      }
  }
}

// dQ for 64 q rows: D in the prologue (written to `delta`), then every key
// tile. DC: 16-column groups of the head each thread accumulates (hd ≤ 16·DC).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const float* __restrict__ lse,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
                    int nq, int nk, int hd, float scale) {
  extern __shared__ float sm[];
  const int ld = hd + 1;
  float* qs = sm;
  float* dos = qs + kB * ld;
  float* ks = dos + kB * ld;
  float* vs = ks + kB * ld;
  float* dss = vs + kB * ld;        // dS, 64 × 65
  float* lse2 = dss + 2 * kB * kLdS;  // lse · log2(e) of the 64 rows
  float* dl = lse2 + kB;            // D of the 64 rows
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int warp = tid / 32, lane = tid % 32;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const T* qb = q + bh * nq * hd;
  const T* kb = k + bh * nk * hd;
  const T* vb = v + bh * nk * hd;
  const T* dob = dout + bh * nq * hd;

  load_tile(qs, qb, q0, nq, hd, ld);
  load_tile(dos, dob, q0, nq, hd, ld);
  load_tile(ks, o + bh * nq * hd, q0, nq, hd, ld);  // O, for D only
  __syncthreads();
  for (int i = warp; i < kB; i += kThreads / 32) {
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += dos[i * ld + d] * ks[i * ld + d];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int qi = q0 + i;
      dl[i] = acc;
      lse2[i] = qi < nq ? lse[bh * nq + qi] * kLog2e : 0.f;
      if (qi < nq) delta[bh * nq + qi] = acc;
    }
  }

  const float scale_log2 = scale * kLog2e;
  float acc[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kB) {
    __syncthreads();  // the previous tile (or O) is no longer read
    load_tile(ks, kb, k0, nk, hd, ld);
    load_tile(vs, vb, k0, nk, hd, ld);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    scores(qs, dos, ks, vs, hd, ld, s, dp);
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        const int i = ty + kSide * a, j = tx + kSide * b;
        const bool in = q0 + i < nq && k0 + j < nk;
        const float p = in ? exp2f(s[a][b] * scale_log2 - lse2[i]) : 0.f;
        dss[i * kLdS + j] = p * (dp[a][b] - dl[i]);
      }
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float dsa[kPer], kc[DC];
#pragma unroll
      for (int a = 0; a < kPer; ++a) dsa[a] = dss[(ty + kSide * a) * kLdS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + kSide * c;
        kc[c] = d < hd ? ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] += dsa[a] * kc[c];
    }
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int qi = q0 + ty + kSide * a;
    if (qi >= nq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + kSide * c;
      if (d < hd) dq[(bh * nq + qi) * hd + d] = from_f<T>(acc[a][c] * scale);
    }
  }
}

// dK and dV for 64 keys, over every q tile; `delta` is D from the dq kernel.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int nq,
                     int nk, int hd, float scale) {
  extern __shared__ float sm[];
  const int ld = hd + 1;
  float* ks = sm;
  float* vs = ks + kB * ld;
  float* qs = vs + kB * ld;
  float* dos = qs + kB * ld;
  float* ps = dos + kB * ld;   // P, 64 × 65
  float* dss = ps + kB * kLdS;  // dS, 64 × 65
  float* lse2 = dss + kB * kLdS;
  float* dl = lse2 + kB;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const T* qb = q + bh * nq * hd;
  const T* dob = dout + bh * nq * hd;

  load_tile(ks, k + bh * nk * hd, k0, nk, hd, ld);
  load_tile(vs, v + bh * nk * hd, k0, nk, hd, ld);

  const float scale_log2 = scale * kLog2e;
  float acc_k[kPer][DC], acc_v[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += kB) {
    __syncthreads();  // the previous q tile is no longer read
    load_tile(qs, qb, q0, nq, hd, ld);
    load_tile(dos, dob, q0, nq, hd, ld);
    for (int i = tid; i < kB; i += kThreads) {
      const int qi = q0 + i;
      lse2[i] = qi < nq ? lse[bh * nq + qi] * kLog2e : 0.f;
      dl[i] = qi < nq ? delta[bh * nq + qi] : 0.f;
    }
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    scores(qs, dos, ks, vs, hd, ld, s, dp);
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        const int i = ty + kSide * a, j = tx + kSide * b;
        const bool in = q0 + i < nq && k0 + j < nk;
        const float p = in ? exp2f(s[a][b] * scale_log2 - lse2[i]) : 0.f;
        ps[i * kLdS + j] = p;
        dss[i * kLdS + j] = p * (dp[a][b] - dl[i]);
      }
    __syncthreads();
    // this thread's keys ty + 16a and columns tx + 16c
    for (int i = 0; i < kB; ++i) {
      float pa[kPer], dsa[kPer], dov[DC], qv[DC];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        pa[a] = ps[i * kLdS + ty + kSide * a];
        dsa[a] = dss[i * kLdS + ty + kSide * a];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + kSide * c;
        dov[c] = d < hd ? dos[i * ld + d] : 0.f;
        qv[c] = d < hd ? qs[i * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[a][c] += pa[a] * dov[c];
          acc_k[a][c] += dsa[a] * qv[c];
        }
    }
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int kj = k0 + ty + kSide * a;
    if (kj >= nk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + kSide * c;
      if (d < hd) {
        dk[(bh * nk + kj) * hd + d] = from_f<T>(acc_k[a][c] * scale);
        dv[(bh * nk + kj) * hd + d] = from_f<T>(acc_v[a][c]);
      }
    }
  }
}

template <typename T, int DC>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* delta, int bh, int nq, int nk, int hd,
              float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + kB - 1) / kB, bh);
  flash_bwd_dq_kernel<T, DC><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const float*)lse, (const T*)dout,
      (T*)dq, (float*)delta, nq, nk, hd, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int launch_dkv(const void* q, const void* k, const void* v, const void* lse, const void* delta,
               const void* dout, void* dk, void* dv, int bh, int nq, int nk, int hd,
               float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nk + kB - 1) / kB, bh);
  flash_bwd_dkv_kernel<T, DC><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)lse, (const float*)delta,
      (const T*)dout, (T*)dk, (T*)dv, nq, nk, hd, scale);
  return (int)cudaGetLastError();
}

// the instances: float32 up to hd 128 (DC 8), bfloat16 up to hd 80 (DC 5)
constexpr int kDcF32 = 8, kDcBf16 = 5;

bool bad_shape(int bh, int nq, int nk, int hd, int dtype) {
  const int widest = dtype == 0 ? 16 * kDcF32 : 16 * kDcBf16;
  return bh < 1 || bh > 65535 || nq < 1 || nk < 1 || hd < 1 || hd > widest ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dQ and D. q, o, dout, dq (bh, nq, hd); k, v (bh, nk, hd); lse and delta
// (bh, nq) float32; dtype 0 float32 (hd ≤ 128), 1 bfloat16 (hd ≤ 80); scale
// the softmax scale.
extern "C" int cv_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* dq, void* delta, int bh,
                               int nq, int nk, int hd, float scale, int dtype, void* stream) {
  if (bad_shape(bh, nq, nk, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dq<float, kDcF32>(q, k, v, o, lse, dout, dq, delta, bh, nq, nk, hd, scale, s);
  return launch_dq<__nv_bfloat16, kDcBf16>(q, k, v, o, lse, dout, dq, delta, bh, nq, nk, hd,
                                           scale, s);
}

// dK and dV, given D from cv_flash_bwd_dq (same stream, launched before).
extern "C" int cv_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* lse,
                                const void* delta, const void* dout, void* dk, void* dv, int bh,
                                int nq, int nk, int hd, float scale, int dtype, void* stream) {
  if (bad_shape(bh, nq, nk, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dkv<float, kDcF32>(q, k, v, lse, delta, dout, dk, dv, bh, nq, nk, hd, scale,
                                     s);
  return launch_dkv<__nv_bfloat16, kDcBf16>(q, k, v, lse, delta, dout, dk, dv, bh, nq, nk, hd,
                                            scale, s);
}
