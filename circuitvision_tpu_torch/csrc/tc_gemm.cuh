// The bf16 LN pre-pass and tensor-core GEMM shared by mlp_block.cu (the
// MLP's two products) and global_attn.cu (ln_qkv's product with the
// head-split store; attn_proj_residual's, reading the heads where they
// lie, with the residual in its store).
//
// ln_rows_kernel: xn = bf16(LN(x)) for kLnRows rows a block, through
// common.cuh's layernorm_rows as the f32 kernels run it, so xn is bit for
// bit what they normalise. Its statistics divide by ln_c, the row's true
// width: a row of c zero-padded past ln_c (with zero scale and bias
// there) normalises as the unpadded row does, and its padding stays 0.
//
// gemm_tc_kernel: out = epi(a·wᵀ) over an (m × n_cols) output, a (m, k)
// — row-major by default, or any layout whose 8-deep runs are contiguous
// (the A layout type below) — and w (n_cols, k) in torch Linear layout,
// both bf16. A block owns a BM × 128 output tile, one warpgroup per 64
// rows, each issuing wgmma m64n128k16 (tc.cuh) over the 64-deep tiles of
// a 3-stage cp.async ring (4 per tile): rows of 128 bytes, each 16-byte
// chunk placed where the 128-byte swizzle expects it, so no TMA
// descriptor is needed. k and n_cols are multiples of 8 (k·2 bytes a
// multiple of 16); rows and columns past the edges and depth past k are
// zero-filled by cp.async, and the epilogue skips them. Each k tile's
// products finish before the next tile's barrier (wgmma_wait<0>).
//
// The epilogue is a type with three members, so each caller states only
// its store: row(r) gives a per-row value once per thread (two rows),
// col(c) a per-column value once per 8-column tile (its bias, its
// address), and store(row value, col value, v0, v1) takes the f32
// accumulators of columns c and c + 1 of row r and writes them.
//
// The A layout is a type with one member, at(r, kk, k): the element
// offset of row r at depth kk (a multiple of 8) of an (m × k) operand,
// whose 8 elements from there on are contiguous. RowMajorA, the default,
// is the contiguous (m, k) operand of mlp_block and ln_qkv; it holds
// nothing and is the kernel's last parameter, so their loads are what
// they were before the parameter existed.
#pragma once

#include "common.cuh"
#include "tc.cuh"

namespace {  // internal linkage: each library compiles its own copy
namespace tcg {

using tc::bf16;
using cvk::kThreads;

constexpr int kLnRows = 8;       // rows per block of the LN pre-pass (one per warp)
constexpr int kGemmBK = 64;      // reduction depth of one staged tile: a 128-byte row
constexpr int kGemmBN = 128;     // output columns per block: one m64n128 product
constexpr int kGemmStages = 3;   // depth of the cp.async ring

struct RowMajorA {
  __device__ size_t at(int r, int kk, int k) const { return (size_t)r * k + kk; }
};

size_t ln_smem(int c) { return sizeof(float) * 2 * kLnRows * (size_t)c; }

// The ring of A (bm rows) and B (kGemmBN rows) tiles, 128 bytes a row,
// plus 1024 bytes to align it to the swizzle's 1024-byte pattern.
size_t gemm_smem(int bm) { return (size_t)kGemmStages * (bm + kGemmBN) * 128 + 1024; }

__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ xn, int t, int c,
               int ln_c, float eps) {
  extern __shared__ float lsm[];
  float* src = lsm;                 // kLnRows × c
  float* dst = lsm + kLnRows * c;   // kLnRows × c
  const int r0 = blockIdx.x * kLnRows;
  const int rows = min(kLnRows, t - r0);
  const bf16* xb = x + (size_t)r0 * c;
  for (int e = threadIdx.x; e < rows * c; e += kThreads) src[e] = cvk::to_f(xb[e]);
  __syncthreads();
  cvk::layernorm_rows<bf16>(src, dst, rows, c, ln_s, ln_b, eps, ln_c);
  __syncthreads();
  bf16* ob = xn + (size_t)r0 * c;
  for (int e = threadIdx.x; e < rows * c; e += kThreads) ob[e] = cvk::from_f<bf16>(dst[e]);
}

cudaError_t launch_ln_rows(const bf16* x, const float* ln_s, const float* ln_b, bf16* xn,
                           int t, int c, int ln_c, float eps, cudaStream_t stream) {
  if (ln_c < 1 || ln_c > c) return cudaErrorInvalidValue;
  const size_t lsm = ln_smem(c);
  cudaError_t err = cudaFuncSetAttribute(
      ln_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lsm);
  if (err != cudaSuccess) return err;
  ln_rows_kernel<<<(t + kLnRows - 1) / kLnRows, kThreads, lsm, stream>>>(x, ln_s, ln_b, xn, t,
                                                                        c, ln_c, eps);
  return cudaGetLastError();
}

template <int BM, typename Epi, typename ALayout>
__global__ void __launch_bounds__(BM * 2)
gemm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, int m, int n_cols,
               int k, Epi epi, ALayout al) {
  constexpr int kThreadsG = BM * 2;  // a warpgroup of 128 threads per 64 rows
  constexpr int kABytes = BM * 128, kStage = (BM + kGemmBN) * 128;
  extern __shared__ unsigned char gsm[];
  const uint32_t raw = tc::smem_u32(gsm);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  unsigned char* ring = gsm + (base - raw);
  const int tid = threadIdx.x, wg = tid / 128, w4 = (tid / 32) % 4, lane = tid % 32;
  const int n0 = blockIdx.x * kGemmBN, m0 = blockIdx.y * BM;
  const int ktiles = (k + kGemmBK - 1) / kGemmBK;

  auto load = [&](int kt, int s) {
    const int k0 = kt * kGemmBK;
    unsigned char* sa = ring + s * kStage;
    unsigned char* sb = sa + kABytes;
    for (int e = tid; e < BM * 8; e += kThreadsG) {
      const int r = e / 8, c = e % 8, gr = m0 + r, gk = k0 + c * 8;
      const bool in = gr < m && gk < k;
      tc::cp_async16(sa + tc::sw128_offset(r, c), a + (in ? al.at(gr, gk, k) : 0), in);
    }
    for (int e = tid; e < kGemmBN * 8; e += kThreadsG) {
      const int r = e / 8, c = e % 8, gn = n0 + r, gk = k0 + c * 8;
      const bool in = gn < n_cols && gk < k;
      tc::cp_async16(sb + tc::sw128_offset(r, c), w + (in ? (size_t)gn * k + gk : 0), in);
    }
  };

  float acc[kGemmBN / 2];
#pragma unroll
  for (int i = 0; i < kGemmBN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    tc::cp_async_wait<kGemmStages - 2>();  // tile kt has landed
    tc::fence_proxy_async();               // ... visible to wgmma
    __syncthreads();  // ... for every thread, and tile kt − 1 is no longer read
    const int next = kt + kGemmStages - 1;
    if (next < ktiles) load(next, next % kGemmStages);
    tc::cp_async_commit();
    const uint32_t sa = base + (kt % kGemmStages) * kStage;
    const uint64_t da = tc::sw128_desc(sa + wg * 64 * 128), db = tc::sw128_desc(sa + kABytes);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk)  // +32 bytes a step: +2 in the address field
      tc::wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
  }
  tc::cp_async_wait<0>();

  // this thread's accumulators: rows g and g + 8 of its warp's 16, and in
  // each 8-column tile j the columns 8j + 2t, 8j + 2t + 1
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int row0 = m0 + wg * 64 + w4 * 16 + g;
  const auto rv0 = epi.row(row0), rv1 = epi.row(row0 + 8);
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j) {
    const int col = n0 + 8 * j + t2;
    if (col >= n_cols) continue;
    const auto cv = epi.col(col);
    if (row0 < m) epi.store(rv0, cv, acc[4 * j], acc[4 * j + 1]);
    if (row0 + 8 < m) epi.store(rv1, cv, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// One GEMM of block rows bm (128 or 64, the wrapper's plan).
template <typename Epi, typename ALayout = RowMajorA>
cudaError_t launch_gemm(int bm, const bf16* a, const bf16* w, int m, int n_cols, int k, Epi epi,
                        cudaStream_t stream, ALayout al = ALayout()) {
  auto run = [&](auto kernel) {
    const size_t smem = gemm_smem(bm);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n_cols + kGemmBN - 1) / kGemmBN, (m + bm - 1) / bm);
    kernel<<<grid, bm * 2, smem, stream>>>(a, w, m, n_cols, k, epi, al);
    return cudaGetLastError();
  };
  if (bm == 128) return run(gemm_tc_kernel<128, Epi, ALayout>);
  if (bm == 64) return run(gemm_tc_kernel<64, Epi, ALayout>);
  return cudaErrorInvalidValue;
}

}  // namespace tcg
}  // namespace
