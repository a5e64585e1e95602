// float32 products on the tensor cores at float32's accuracy (3×TF32),
// shared by the float32 kernels of mlp_block.cu (the MLP's two products)
// and window_attn.cu (the q-pool block's products and attention).
//
// 3×TF32: each float32 operand x is split into hi = tf32(x), rounded to
// nearest with ties away (cvt.rna's rounding, done as an integer add and
// mask, which timed faster on the card than cvt.rna.tf32) and lo = x −
// hi, exact in float32, which the tensor core reads as TF32 by dropping
// its low 13 bits (truncation, as CUTLASS's fast 3×TF32 takes its small
// part); a·b is taken as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b with float32
// accumulators, lo·lo (≈ 2^-22 relative) dropped. The error is then of
// float32's own summation noise (error / max(1, max |plain|) below 1e-6
// at Hiera-t@512's shapes against 2e-4 to 5e-4 for one TF32 product;
// tests/test_torch_port_tf32x3.py emulates both), and the tensor cores'
// dense TF32 rate (495 TFLOP/s) gives 165 TFLOP/s of such products
// against the FMA units' 67.
//
// Products are warp-level mma.sync m16n8k8 .tf32 (the split happens in
// registers, as CUTLASS's 3×TF32 does), whose own ceiling on the card is
// below wgmma's (scripts/mma_rate.cu measures it). Fragment layouts
// (lane = 4g + t):
//   A (16×8, row-major)  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8×8, k × n)       b0 (k t, n g)  b1 (k t+4, n g)
//   C (16×8, float32)    c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
// A row-major tile (m rows, k contiguous) and a weight in torch Linear
// layout (n rows, k contiguous) give A and B by ldmatrix: an 8×8 b16
// matrix is 8 rows of four float32, and thread 4g + t receives row g's
// float t.
//
// gemm_kernel: out = epi(a·wᵀ) over an (m × n) output, a (m, k)
// row-major and w (n, k) in torch Linear layout — rows n ≥ n1 from a
// second weight w2 (the q-pool block's Wskip then Wqkv) — all float32. A
// block owns a 64 × 64 output tile, a warp for each 32 × 32, whose
// 32-deep tiles (128-byte rows, padded to 144 bytes so the eight rows one
// ldmatrix reads fall in distinct bank groups) ring through three
// cp.async stages, two in flight; rows and columns past the edges and
// depth past k are zero-filled. Three or four such blocks share an SM.
// Timed on the card at t@512's shapes, 128 × 64 and 128 × 128 blocks (a
// third and half less L2 traffic a FLOP), four stages, and the small
// terms in accumulators of their own were each no faster. k a multiple
// of 4 with 16-byte-aligned operands copies 16 bytes at a time, anything
// else 4. With gridDim.z > 1 the depth is split: each split writes its raw sums
// to its slab of `partial`, and reduce_kernel adds the slabs in split
// order before the epilogue — deterministic, no atomics.
//
// The epilogue is a type: kFrag false → two(r, c, v0, v1) for the output
// pair (r, c), (r, c + 1) where n is even and its pointers 8-byte aligned
// (aligned8(), so its 8-byte loads and stores line up), one(r, c, v) for
// each element otherwise; kFrag true → frag(row0, col, v, m, n) for each
// m16 × n8 fragment, called by every lane of the warp (the q-pool block
// pools its rows with shuffles there).
#pragma once

#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "tc.cuh"

namespace {  // internal linkage: each library compiles its own copy
namespace tf32 {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // depth of a staged tile: 32 floats, a 128-byte row
constexpr int kLd = kBK + 4;   // its row stride in shared memory: 144 bytes
constexpr int kStages = 3;     // depth of the cp.async ring
constexpr int kLnRows = 8;     // rows per block of the LN pre-pass (one per warp)

constexpr size_t kGemmSmem = sizeof(float) * kStages * (kBM + kBN) * kLd;

// Depth of one split of k into `splits` (whole staged tiles); the splits
// that depth gives are ceil(k / split_len).
int split_len(int k, int splits) {
  const int tiles = (k + kBK - 1) / kBK;
  return (tiles + splits - 1) / splits * kBK;
}

// x as hi = tf32(x) (to nearest, ties away: half of the 13 dropped
// bits' weight added to the magnitude, then the bits cleared) and lo =
// x − hi, whose TF32 part the tensor core reads.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a·b: one 16×8×8 product, tf32 inputs, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3×TF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

template <int VEC>
__device__ __forceinline__ void copy(float* dst, const float* src, bool in) {
  if constexpr (VEC == 4)
    tc::cp_async16(dst, src, in);
  else
    tc::cp_async4(dst, src, in);
}

// xn = LN(x) for kLnRows rows a block through common.cuh's
// layernorm_rows<float>, as the float32 FMA kernels normalised: xn is
// bit for bit theirs. (Staging the rows through shared memory first, as
// tc_gemm.cuh's bf16 pre-pass does, timed no faster on the card.)
__global__ void __launch_bounds__(cvk::kThreads)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, float* __restrict__ xn, int t, int c, float eps) {
  const int r0 = blockIdx.x * kLnRows;
  cvk::layernorm_rows<float>(x + (size_t)r0 * c, xn + (size_t)r0 * c, min(kLnRows, t - r0), c,
                             ln_s, ln_b, eps);
}

cudaError_t launch_ln_rows(const float* x, const float* ln_s, const float* ln_b, float* xn, int t,
                           int c, float eps, cudaStream_t stream) {
  ln_rows_kernel<<<(t + kLnRows - 1) / kLnRows, cvk::kThreads, 0, stream>>>(x, ln_s, ln_b, xn,
                                                                          t, c, eps);
  return cudaGetLastError();
}

// One staged 32-deep tile's products for a warp's 32 × 32 outputs: A rows
// at sa (row stride lda floats, ≡ 4 mod 32), B rows at sb (stride kLd).
__device__ __forceinline__ void warp_tile(float (&acc)[2][4][4], const float* sa, int lda,
                                          const float* sb, int lane) {
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t r[4];
      tc::ldsm_x4(r, sa + (i * 16 + lane % 16) * lda + ks * 8 + (lane / 16) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), ah[i][e], al[i][e]);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {  // n8 tiles 2jj and 2jj + 1: b0, b1 of each
      uint32_t r[4];
      tc::ldsm_x4(r, sb + (jj * 16 + lane % 8 + (lane / 16) * 8) * kLd + ks * 8 +
                         ((lane / 8) % 2) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(r[e]), bh[2 * jj + e / 2][e % 2], bl[2 * jj + e / 2][e % 2]);
    }
    // the three terms in turn over the warp's eight tiles, so no
    // product waits on the one before it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], ah[i], bh[j][0], bh[j][1]);
  }
}

// A warp's 32 × 32 outputs from row m0w, column n0w: to `partial` (raw
// sums, a split's slab) where it is given, else through the epilogue.
template <typename Epi>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], int m0w, int n0w,
                                           int m, int n, float* partial, bool pairs,
                                           const Epi& epi) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row0 = m0w + i * 16, col = n0w + j * 8 + t2;
      if (partial != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + g + 8 * (e / 2), c = col + e % 2;
          if (r < m && c < n) partial[(size_t)r * n + c] = acc[i][j][e];
        }
      } else if constexpr (Epi::kFrag) {
        epi.frag(row0, col, acc[i][j], m, n);
      } else {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row0 + g + 8 * hr;
          const float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
          if (r >= m) continue;
          if (pairs && col < n) {
            epi.two(r, col, v0, v1);
          } else {
            if (col < n) epi.one(r, col, v0);
            if (col + 1 < n) epi.one(r, col + 1, v1);
          }
        }
      }
    }
}

template <int VEC, typename Epi>
__global__ void __launch_bounds__(kBM * kBN / 32, 3)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ w,
            const float* __restrict__ w2, int n1, int m, int n, int k, int k_len,
            float* __restrict__ partial, bool pairs, Epi epi) {
  constexpr int kWarpsN = kBN / 32, kThreadsG = kBM * kBN / 32, kStage = (kBM + kBN) * kLd,
                kPer = kBK / VEC;
  extern __shared__ __align__(16) float gsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;  // the warp's 32 rows and 32 columns
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * k_len, ke = min(k, kb + k_len);
  const int ktiles = (ke - kb + kBK - 1) / kBK;

  // this thread's copies: piece cc of rows r0t + i · kRowStep of the A
  // and B tiles, their row pointers worked out once (null past the edge)
  constexpr int kRowStep = kThreadsG / kPer, kCopiesA = kBM / kRowStep,
                kCopiesB = kBN / kRowStep;
  const int cc = (tid % kPer) * VEC, r0t = tid / kPer;
  const float* pa[kCopiesA];
  const float* pb[kCopiesB];
#pragma unroll
  for (int i = 0; i < kCopiesA; ++i) {
    const int gr = m0 + r0t + i * kRowStep;
    pa[i] = gr < m ? a + (size_t)gr * k + cc : nullptr;
  }
#pragma unroll
  for (int i = 0; i < kCopiesB; ++i) {
    const int gn = n0 + r0t + i * kRowStep;
    pb[i] = gn >= n ? nullptr : (gn < n1 ? w + (size_t)gn * k : w2 + (size_t)(gn - n1) * k) + cc;
  }
  auto load = [&](int kt, int s) {
    float* sa = gsm + s * kStage + r0t * kLd + cc;
    float* sb = sa + kBM * kLd;
    const int k0 = kb + kt * kBK;
    const bool kin = k0 + cc < ke;
#pragma unroll
    for (int i = 0; i < kCopiesA; ++i)
      copy<VEC>(sa + i * kRowStep * kLd, pa[i] && kin ? pa[i] + k0 : a, pa[i] && kin);
#pragma unroll
    for (int i = 0; i < kCopiesB; ++i)
      copy<VEC>(sb + i * kRowStep * kLd, pb[i] && kin ? pb[i] + k0 : w, pb[i] && kin);
  };

  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    tc::cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread, and tile kt − 1 is no longer read
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next, next % kStages);
    tc::cp_async_commit();
    const float* stage = gsm + (kt % kStages) * kStage;
    warp_tile(acc, stage + (wm * 32) * kLd, kLd, stage + (kBM + wn * 32) * kLd, lane);
  }
  tc::cp_async_wait<0>();
  store_tile(acc, m0 + wm * 32, n0 + wn * 32, m, n,
             partial ? partial + (size_t)blockIdx.z * m * n : nullptr, pairs, epi);
}

// out = epi(Σ_s partial[s]), the slabs summed in split order.
template <typename Epi>
__global__ void reduce_kernel(const float* __restrict__ partial, int m, int n, int splits,
                              Epi epi) {
  const size_t total = (size_t)m * n;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * total + e];
    epi.one((int)(e / n), (int)(e % n), v);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
inline bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

// One GEMM with its depth in `splits` (the wrapper's plan); partial
// holds splits·m·n floats where splits > 1. An epilogue of whole
// fragments takes no split and needs the 16-byte copies.
template <typename Epi>
cudaError_t launch_gemm(int splits, const float* a, const float* w, const float* w2, int n1,
                        int m, int n, int k, float* partial, Epi epi, cudaStream_t stream) {
  if (splits < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const int k_len = split_len(k, splits), z = (k + k_len - 1) / k_len;
  const bool vec = k % 4 == 0 && aligned16(a) && aligned16(w) && aligned16(w2);
  if ((z > 1 && (Epi::kFrag || partial == nullptr)) || (!vec && Epi::kFrag))
    return cudaErrorInvalidValue;
  bool pairs = false;
  if constexpr (!Epi::kFrag) pairs = n % 2 == 0 && epi.aligned8();
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kGemmSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, z);
    kernel<<<grid, kBM * kBN / 32, kGemmSmem, stream>>>(a, w, w2, n1, m, n, k, k_len,
                                                        z > 1 ? partial : nullptr, pairs, epi);
    return cudaGetLastError();
  };
  cudaError_t err = cudaSuccess;
  if constexpr (Epi::kFrag) {
    err = run(gemm_kernel<4, Epi>);
  } else {
    err = vec ? run(gemm_kernel<4, Epi>) : run(gemm_kernel<1, Epi>);
    if (err == cudaSuccess && z > 1) {
      const int blocks = (int)std::min(((size_t)m * n + 255) / 256, (size_t)4096);
      reduce_kernel<Epi><<<blocks, 256, 0, stream>>>(partial, m, n, z, epi);
      err = cudaGetLastError();
    }
  }
  return err;
}

}  // namespace tf32
}  // namespace
