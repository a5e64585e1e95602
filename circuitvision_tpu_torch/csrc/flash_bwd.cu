// The backward of non-causal softmax attention, o = softmax(q·kᵀ·s)·v over
// (B·H, N, D), from the forward's residual lse = log Σ_k e^(q·kᵀ·s), the
// per-row log-sum-exp that flash_attn.cu's lse instances write:
//
//   P = exp(q·kᵀ·s − lse),  dV = Pᵀ·dO,  dP = dO·Vᵀ,  D = rowsum(dO∘O),
//   dS = P∘(dP − D)·s,      dQ = dS·K,   dK = dSᵀ·Q.
//
// Replaces the two Pallas calls of jax's TPU flash-attention backward
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd_dkv :941 and _flash_attention_bwd_dq :1287), which
// the JAX package reaches when it differentiates the Hiera global blocks
// (models/sam2/hiera.py:270 under train/train_step.py). It computes what
// those compute, with their roundings, not block for block as they do.
//
// Two kernels, launched in this order on one stream, deterministic (no
// atomics). The dq kernel — one block per (batch·head, 64 q rows) — first
// computes D for its rows and writes it out; then it streams the 64-key
// tiles of K and V past its q and dO tiles, recomputes S and dP, forms dS
// and accumulates dQ += dS·K. The dkv kernel — one block per (batch·head,
// 64 keys) — keeps its K and V tiles, streams the 64-row tiles of q and
// dO with their lse and D, and accumulates dV += Pᵀ·dO and dK += dSᵀ·q.
// Scores and probabilities never leave the SM.
//
// What bounds them on the H100: 6·N²·D (dq: S, dP, dQ) and 8·N²·D (dkv:
// S, dP, dV, dK) operations a head against about 10·N·D elements moved,
// so both are bound by the operations — at SAM2.1-L's global blocks (8
// heads, N = 4096, D = 72) 0.059 and 0.078 ms at 989 TFLOP/s bf16.
//
// bfloat16 — the design (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel):
// flash_attn.cu's tensor-core forward turned round. Every product is a
// warp-level mma.sync m16n8k16 (tc.cuh) fed by ldmatrix, for the reason
// the forward gives: rows of 72 bf16 are 144 bytes, past the 128-byte
// swizzle span wgmma's descriptors are built around. A block is 4 warps,
// one m16 tile of the block's 64 rows (q rows in dq, keys in dkv) a warp.
// Tiles stay bf16 in shared memory with rows padded by 16 bytes (ldmatrix
// free of bank conflicts) and their depth padded with zero columns to a
// multiple of 16 (exact). The streamed tiles (K and V in dq; q and dO
// with their lse and D in dkv) come through a cp.async double buffer, the
// next tile's copy in flight while this one's products run.
//  - dq: S = q·kᵀ and dP = dO·vᵀ land in C fragments; P = 2^(S·c − lse·
//    log2 e) (c = s·log2 e) and dS = P∘(dP − D)·s are formed in registers
//    and packed to bf16 A fragments — jax's rounding of ds (:1251-1258) —
//    for dQ += dS·K, which reads K by ldmatrix.trans as the forward's p·v
//    reads V. dQ is accumulated in float32 registers over the key tiles
//    and rounded once.
//  - dkv: the transposed products Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and
//    dSᵀ come out as C fragments of the key rows; each lane reads the lse
//    and D of its columns from shared memory. Pᵀ and dSᵀ are packed to
//    bf16 A fragments (jax's p.T.astype :900, ds.T.astype :918) for
//    dV += Pᵀ·dO and dK += dSᵀ·q, which read dO and q by ldmatrix.trans.
//    dK and dV are accumulated in float32 registers over the q tiles.
// Instances at head widths 72 (NT = 9) and 96 (NT = 12), which take every
// SAM2.1 preset's global heads (L 72, b+ 56, t and s 96), and 128 (NT =
// 16) for heads of 97 to 128; a head takes the narrowest that holds it,
// its extra columns zero (a head off a multiple of 8 arrives zero-padded
// to the next one: ops/cuda/flash_attn.py FlashAttention). The 128
// instance is the same kernel at the wider head, left as it is: its
// shared memory is 105,472 bytes a block (one block an SM of either
// kernel), and its dkv accumulators alone take 128 of the 255 registers a
// thread may hold. Budget (ptxas -v,
// sm_90a, CUDA 12.8): no local memory, 0 spill bytes in all four; dq 166
// registers at either width, dkv 170 at 72 and 230 at 96; shared memory
// 68,608 bytes a block at 72, 80,896 at 96. So an SM holds 3 dq blocks at
// 72 (registers and shared memory both allow 3) and 2 at 96 (shared
// memory), and 2 dkv blocks at either width (registers).
//
// Measured (scripts/kernel_rows.py, NVIDIA H100 80GB HBM3 at 700 W,
// device time by CUDA-graph replay, the FMA design in the same call): at
// 1 × 8 heads × 4096 × 72, dq 0.292–0.294 ms (3.096–3.130 before), dkv
// 0.303–0.305 (3.824), 200 and 255 TFLOP/s, 20 and 26 % of the bf16
// bound; SDPA's whole backward 0.314–0.318. At 1 × 4 × 4096 × 96 dq
// 0.165, dkv 0.189 (SDPA's backward 0.154).
//
// float32 — flash_bwd_dq_kernel, flash_bwd_dkv_kernel: FMA loops, every
// operand widened to float32 in shared memory; each of the 256 threads
// owns a 4 × 4 sub-tile of a 64 × 64 score tile (rows ty + 16a, columns
// tx + 16b, so a warp's loads hit distinct banks or broadcast) and a
// 4 × 16·DC sub-tile of the 64 × D accumulators; dS and P go through
// shared memory. Tensor cores in TF32 would not hold the float32
// card-against-CPU check, so it stays on the FMA units, as every float32
// instance of the port does.
#include <cmath>

#include "common.cuh"
#include "tc.cuh"

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

// ------------------------------------------------------------ bfloat16
using tc::bf16;

constexpr int kTcThreads = 128;  // 4 warps, one m16 tile of the 64 rows each
// head widths of the bfloat16 instances (ops/cuda/flash_attn.py LSE_WIDTHS),
// NT = 9, 12 and 16 8-wide tiles
constexpr int kBwdWidths[3] = {72, 96, 128};
static_assert(kBwdWidths[0] == 8 * 9 && kBwdWidths[1] == 8 * 12 && kBwdWidths[2] == 8 * 16,
              "the launchers' NT");

// Shared-memory bytes of either bfloat16 kernel at instance width `width`:
// six 64-row bf16 tiles — dq: q, dO and two stages of K and V; dkv: K, V
// and two stages of q and dO — of rows of the depth (the width padded to
// a multiple of 16) plus 8, and 1 KB of float32 row values (dkv: lse and
// D of the two staged q tiles; dq: D of its 64 rows).
__host__ __device__ size_t bwd_tc_smem(int width) {
  const size_t ld = (size_t)(width + 15) / 16 * 16 + 8;
  return sizeof(bf16) * 6 * kB * ld + sizeof(float) * 4 * kB;
}

// 64 rows [row0, row0 + 64) of two (n, hd) bf16 tensors a and b into the
// tiles ta and tb (row stride LD) by cp.async, 16 bytes a copy; rows past
// n zero-filled, the columns past hd left as they are.
template <int LD>
__device__ __forceinline__ void load_pair(bf16* ta, bf16* tb, const bf16* a, const bf16* b,
                                          int row0, int n, int hd) {
  const int chunks = hd / 8;
  for (int e = threadIdx.x; e < kB * chunks; e += kTcThreads) {
    const int r = e / chunks, c8 = (e % chunks) * 8, row = row0 + r;
    const bool in = row < n;
    const size_t off = (size_t)(in ? row : 0) * hd + c8;
    tc::cp_async16(ta + r * LD + c8, a + off, in);
    tc::cp_async16(tb + r * LD + c8, b + off, in);
  }
}

// Zero all of a block's shared memory: the columns past hd of every tile
// stay zero from here on (cp.async writes only the hd columns).
__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t bytes) {
  uint4* all = reinterpret_cast<uint4*>(smem);
  for (int e = threadIdx.x; e < (int)(bytes / 16); e += kTcThreads) all[e] = make_uint4(0, 0, 0, 0);
}

// Σ a·b over eight bf16 pairs, in float32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = tc::unpack_bf16(x[i]), w = tc::unpack_bf16(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// C[n] += A·B over one 64-wide tile of the other operand's rows: the
// warp's 16 rows (A fragments from `arow`, row stride LD) against 64 rows
// of `bt` (the B operand stored n rows × k contiguous), KS steps of 16
// deep — S = q·kᵀ in dq, Sᵀ = K·qᵀ in dkv, and the same for dP.
template <int KS, int LD>
__device__ __forceinline__ void product_64(float (&c)[8][4], float (&c2)[8][4], const bf16* arow,
                                           const bf16* arow2, const bf16* bt, const bf16* bt2) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = c2[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[4], af2[4];
    tc::ldsm_x4(af, arow + (lane % 16) * LD + ks * 16 + (lane / 16) * 8);
    tc::ldsm_x4(af2, arow2 + (lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int boff = (jj * 16 + (lane % 8) + (lane / 16) * 8) * LD + ks * 16 + ((lane / 8) % 2) * 8;
      uint32_t bf[4], bf2[4];
      tc::ldsm_x4(bf, bt + boff);
      tc::ldsm_x4(bf2, bt2 + boff);
      tc::mma_bf16(c[2 * jj], af, bf[0], bf[1]);
      tc::mma_bf16(c[2 * jj + 1], af, bf[2], bf[3]);
      tc::mma_bf16(c2[2 * jj], af2, bf2[0], bf2[1]);
      tc::mma_bf16(c2[2 * jj + 1], af2, bf2[2], bf2[3]);
    }
  }
}

// acc += A·B where A is the warp's 16 × 64 fragment tile `x` (a C-fragment
// tile of the first products, packed to bf16 here) and B the 64 rows of
// `bt` (stored k rows × n contiguous, read by ldmatrix.trans) over the
// head's NT 8-wide column tiles — dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·q.
template <int NT, int LD>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4], const float (&x)[8][4],
                                             const bf16* bt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = tc::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = tc::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = tc::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = tc::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const bf16* brow = bt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD;
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t b[4];
      tc::ldsm_x4_t(b, brow + dp * 16 + (lane / 16) * 8);
      tc::mma_bf16(acc[2 * dp], a, b[0], b[1]);
      tc::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
    if constexpr (NT % 2 == 1) {
      uint32_t b[2];
      tc::ldsm_x2_t(b, brow + (NT - 1) * 8);
      tc::mma_bf16(acc[NT - 1], a, b[0], b[1]);
    }
  }
}

// Rows g and g + 8 of the warp's 16 accumulated rows, rounded to bf16,
// into rows row0 + g and row0 + g + 8 of the (n, hd) tensor `out`,
// columns below hd.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NT][4], int row0, int n,
                                           int hd) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      const int col = 8 * d + t2;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * hd + col) =
            tc::pack_bf16(acc[d][2 * r], acc[d][2 * r + 1]);
    }
  }
}

// dQ and D for 64 q rows; NT: the instance's head width in 8-wide tiles.
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const float* __restrict__ lse, const bf16* __restrict__ dout,
                       bf16* __restrict__ dq, float* __restrict__ delta, int nq, int nk, int hd,
                       float scale) {
  constexpr int KS = (NT + 1) / 2;  // 16-deep steps over the padded depth
  constexpr int LD = KS * 16 + 8;   // row stride in shared memory, bf16
  constexpr int kTile = kB * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile;
  bf16* kv = dos + kTile;  // stage s: K at kv + 2·s·kTile, V after it
  float* dls = reinterpret_cast<float*>(kv + 4 * kTile);  // D of the 64 rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kB, w0 = warp * 16;
  const bf16* kb = k + bh * nk * hd;
  const bf16* vb = v + bh * nk * hd;

  zero_smem(smem_raw, bwd_tc_smem(8 * NT));
  __syncthreads();
  load_pair<LD>(qs, dos, q + bh * nq * hd, dout + bh * nq * hd, q0, nq, hd);
  load_pair<LD>(kv, kv + kTile, kb, vb, 0, nk, hd);
  tc::cp_async_commit();

  // D = rowsum(dO∘O) of the warp's 16 rows, two at a time (one per half
  // warp, a 16-byte piece a lane), while the first tiles are in flight
  for (int it = 0; it < 8; ++it) {
    const int r = w0 + 2 * it + lane / 16, qi = q0 + r, c = lane % 16;
    float acc = 0.f;
    if (qi < nq && c < hd / 8) {
      const size_t off = (bh * nq + qi) * hd + c * 8;
      acc = dot8(*reinterpret_cast<const uint4*>(dout + off),
                 *reinterpret_cast<const uint4*>(o + off));
    }
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (c == 0) {
      dls[r] = acc;
      if (qi < nq) delta[bh * nq + qi] = acc;
    }
  }
  __syncwarp();
  // this lane's rows g and g + 8: D, and lse in log2 units
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + w0 + g + 8 * r;
    dl[r] = dls[w0 + g + 8 * r];
    l2[r] = qi < nq ? lse[bh * nq + qi] * kLog2e : 0.f;
  }

  const float scale_log2 = scale * kLog2e;
  const int t2 = 2 * (lane % 4);
  float acc[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  const int ntiles = (nk + kB - 1) / kB;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      bf16* next = kv + ((j + 1) % 2) * 2 * kTile;
      load_pair<LD>(next, next + kTile, kb, vb, (j + 1) * kB, nk, hd);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j (and q, dO) landed: this thread's copies
    __syncthreads();         // ... and every thread's
    const bf16* kt = kv + (j % 2) * 2 * kTile;
    const bf16* vt = kt + kTile;
    // S = q·kᵀ and dP = dO·vᵀ: the warp's 16 rows × 64 keys
    float s[8][4], dp[8][4];
    product_64<KS, LD>(s, dp, qs + w0 * LD, dos + w0 * LD, kt, vt);
    // P = 2^(S·c − lse·log2 e), dS = P∘(dP − D)·s; this lane holds rows
    // g (e = 0, 1) and g + 8 (e = 2, 3) at keys 8n + 2t + (e & 1)
    const int k0 = j * kB;
    const bool ragged = k0 + kB > nk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -l2[e >> 1]));
        if (ragged && k0 + 8 * n + t2 + (e & 1) >= nk) p = 0.f;
        s[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;
      }
    // dQ += dS·K, dS rounded to bf16 as it becomes the A fragment
    product_rows<NT, LD>(acc, s, kt);
    __syncthreads();  // the buffer of tile j is refilled next iteration
  }
  store_rows<NT>(dq + bh * nq * hd, acc, q0 + w0, nq, hd);
}

// dK and dV for 64 keys, over every q tile; `delta` is D from the dq kernel.
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ delta, const bf16* __restrict__ dout,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk, int hd,
                        float scale) {
  constexpr int KS = (NT + 1) / 2;
  constexpr int LD = KS * 16 + 8;
  constexpr int kTile = kB * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* qd = vs + kTile;  // stage s: q at qd + 2·s·kTile, dO after it
  float* rows = reinterpret_cast<float*>(qd + 4 * kTile);  // stage s: lse, then D, 64 each
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kB, w0 = warp * 16;
  const bf16* qb = q + bh * nq * hd;
  const bf16* dob = dout + bh * nq * hd;

  zero_smem(smem_raw, bwd_tc_smem(8 * NT));
  __syncthreads();
  auto load_q = [&](int i, int s) {
    bf16* qt = qd + s * 2 * kTile;
    load_pair<LD>(qt, qt + kTile, qb, dob, i * kB, nq, hd);
    // lse (threads 0..63) and D (64..127) of the tile's rows
    const int r = tid % kB, qi = i * kB + r;
    const bool in = qi < nq;
    const float* src = (tid < kB ? lse : delta) + bh * nq + (in ? qi : 0);
    tc::cp_async4(rows + s * 2 * kB + tid, src, in);
  };
  load_pair<LD>(ks, vs, k + bh * nk * hd, v + bh * nk * hd, k0, nk, hd);
  load_q(0, 0);
  tc::cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  const int t2 = 2 * (lane % 4);
  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.f;

  const int ntiles = (nq + kB - 1) / kB;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_q(i + 1, (i + 1) % 2);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qd + (i % 2) * 2 * kTile;
    const bf16* dt = qt + kTile;
    const float* l_s = rows + (i % 2) * 2 * kB;
    const float* d_s = l_s + kB;
    // Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ: the warp's 16 keys × 64 q rows
    float s[8][4], dp[8][4];
    product_64<KS, LD>(s, dp, ks + w0 * LD, vs + w0 * LD, qt, dt);
    // Pᵀ and dSᵀ: this lane holds keys g (e = 0, 1) and g + 8 (e = 2, 3)
    // at q rows 8n + 2t + (e & 1), whose lse and D it reads here
    const int q0 = i * kB;
    const bool ragged = q0 + kB > nq;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + t2;
      const float2 lc = *reinterpret_cast<const float2*>(l_s + col);
      const float2 dc = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? lc.y : lc.x, d = (e & 1) ? dc.y : dc.x;
        float p = exp2f(fmaf(s[n][e], scale_log2, -l * kLog2e));
        if (ragged && q0 + col + (e & 1) >= nq) p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - d) * scale;
      }
    }
    // dV += Pᵀ·dO and dK += dSᵀ·q, Pᵀ and dSᵀ rounded to bf16 as A fragments
    product_rows<NT, LD>(acc_v, s, dt);
    product_rows<NT, LD>(acc_k, dp, qt);
    __syncthreads();  // the buffers of tile i are refilled next iteration
  }
  store_rows<NT>(dk + bh * nk * hd, acc_k, k0 + w0, nk, hd);
  store_rows<NT>(dv + bh * nk * hd, acc_v, k0 + w0, nk, hd);
}

template <int NT>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dq, void* delta, int bh, int nq, int nk, int hd,
                 float scale, cudaStream_t stream) {
  const size_t smem = bwd_tc_smem(8 * NT);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + kB - 1) / kB, bh);
  flash_bwd_dq_tc_kernel<NT><<<grid, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const float*)lse,
      (const bf16*)dout, (bf16*)dq, (float*)delta, nq, nk, hd, scale);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* lse,
                  const void* delta, const void* dout, void* dk, void* dv, int bh, int nq, int nk,
                  int hd, float scale, cudaStream_t stream) {
  const size_t smem = bwd_tc_smem(8 * NT);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nk + kB - 1) / kB, bh);
  flash_bwd_dkv_tc_kernel<NT><<<grid, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lse, (const float*)delta,
      (const bf16*)dout, (bf16*)dk, (bf16*)dv, nq, nk, hd, scale);
  return (int)cudaGetLastError();
}

// the float32 instance: heads up to 128 (DC 8)
constexpr int kDcF32 = 8;

// The bfloat16 instance width for a head of width hd: the narrowest of
// kBwdWidths that holds it; 0 where none does or hd is not a multiple of
// 8 (rows are copied in 16-byte pieces).
int bwd_tc_width(int hd) {
  if (hd < 8 || hd % 8) return 0;
  for (int w : kBwdWidths)
    if (hd <= w) return w;
  return 0;
}

bool bad_shape(int bh, int nq, int nk, int hd, int dtype) {
  return bh < 1 || bh > 65535 || nq < 1 || nk < 1 ||
         (dtype == 0 ? hd < 1 || hd > 16 * kDcF32 : dtype != 1 || bwd_tc_width(hd) == 0);
}

}  // namespace

// Shared-memory bytes of the bfloat16 kernels' launch for a head of width
// hd (either kernel; the wrapper's plan must agree), 0 where no instance
// takes it.
extern "C" long long cv_flash_bwd_bf16_smem(int hd) {
  const int width = bwd_tc_width(hd);
  return width ? (long long)bwd_tc_smem(width) : 0;
}

// dQ and D. q, o, dout, dq (bh, nq, hd); k, v (bh, nk, hd); lse and delta
// (bh, nq) float32; dtype 0 float32 (hd ≤ 128), 1 bfloat16 (hd a multiple
// of 8 up to 128, every pointer 16-byte aligned); scale the softmax scale.
extern "C" int cv_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* dq, void* delta, int bh,
                               int nq, int nk, int hd, float scale, int dtype, void* stream) {
  if (bad_shape(bh, nq, nk, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dq<float, kDcF32>(q, k, v, o, lse, dout, dq, delta, bh, nq, nk, hd, scale, s);
  if (bwd_tc_width(hd) == kBwdWidths[0])
    return launch_dq_tc<9>(q, k, v, o, lse, dout, dq, delta, bh, nq, nk, hd, scale, s);
  if (bwd_tc_width(hd) == kBwdWidths[1])
    return launch_dq_tc<12>(q, k, v, o, lse, dout, dq, delta, bh, nq, nk, hd, scale, s);
  return launch_dq_tc<16>(q, k, v, o, lse, dout, dq, delta, bh, nq, nk, hd, scale, s);
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
  if (bwd_tc_width(hd) == kBwdWidths[0])
    return launch_dkv_tc<9>(q, k, v, lse, delta, dout, dk, dv, bh, nq, nk, hd, scale, s);
  if (bwd_tc_width(hd) == kBwdWidths[1])
    return launch_dkv_tc<12>(q, k, v, lse, delta, dout, dk, dv, bh, nq, nk, hd, scale, s);
  return launch_dkv_tc<16>(q, k, v, lse, delta, dout, dk, dv, bh, nq, nk, hd, scale, s);
}
