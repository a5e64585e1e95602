// Non-causal softmax attention with online softmax: o = softmax(q·kᵀ·s)·v
// over (B, H, Nq, D) × (B, H, Nk, D), scores never leaving the SM. The
// caller gives the scale s: D^-0.5 of the head's true width, which is
// narrower than D where the bf16 tiled route pads heads with zero columns
// to a multiple of 8 (ops/cuda/window_attn.py pad_heads).
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
//
// The lse instances (flash_lse_kernel, flash_tc_lse_kernel at head widths
// 72, 96 and 128) are the forward of training's FlashAttention (jax's forward with
// save_residuals): the same bodies, which also write each row's
// log-sum-exp of the scaled scores, m + log(l), in float32 — the residual
// the backward kernels (flash_bwd.cu) recompute the probabilities from.
// The serving instances call the bodies with that write compiled out.
//
// What bounds it on the H100, per shape class of the Hiera-L@1024 path
// (D = 72): 4·Nq·Nk·D FLOPs against (2·Nq + 2·Nk)·D elements. The global
// blocks (8 heads, N = 4096) are bound by the operations, N/2 ≈ 2000
// FLOP/byte (39 µs a launch at 989 TFLOP/s); the tiled windows (N = 256
// and 64) and the q-pool transitions (Nq = 16 or 64) by the bytes, q, k
// and v read once (5.6 µs at N = 256, 37 µs for the 4096 q-pool
// problems of Nq = 16).
//
// bfloat16 — the design (flash_tc_kernel). Both products run on the
// tensor cores as mma.sync m16n8k16 (tc.cuh), FA2-style: each warp owns
// one or two m16 tiles of q rows; S = q·kᵀ has depth D padded to a
// multiple of 16 with zero columns in shared memory (exact), and p·v an n
// of D in 8-wide tiles (9 at D = 72). p goes from the S accumulators
// straight into the A fragments of p·v, rounded to bf16 on the way —
// that conversion is jax's rounding of the unnormalised p — and the row
// max and sum reduce over the four lanes of a quad, so p never touches
// shared memory. The softmax runs in base 2 with D^-0.5·log2(e) folded
// into one multiply (2^(s·c − m·c) = e^((s − m)·D^-0.5), one exp2 per
// score). K/V tiles of 64 keys stream through a double buffer filled by
// cp.async, the next tile's copy in flight while this one's products
// run. mma.sync with ldmatrix (.trans for V) rather than wgmma: rows of
// 72 bf16 are 144 bytes, past the 128-byte swizzle span that wgmma's
// shared-memory descriptors and TMA boxes are built around, so at this D
// they would need a padded copy of every tile; the warp-level product
// reads padded rows (a 16-byte pad keeps ldmatrix free of bank
// conflicts) as they are. A block is 4 warps; a group of wpp warps (1, 2
// or 4, chosen by the wrapper from Nq) shares one (batch·head, q tile)
// problem and its K/V buffers, so the 4096 q-pool problems of Nq = 16
// run four to a block, one per warp, rather than as 64-row tiles
// three-quarters empty. Where Nq > 64 and the grid still fills the card
// (the global blocks, the N = 256 windows), each warp takes two m16
// tiles: 128-row blocks, 256 of them, read each K/V tile once for twice
// the rows (half the L2 traffic of 64-row tiles) and reuse each K and V
// fragment for both tiles; that instance holds 221 registers, and at
// D = 96 it would spill, so it stops at D = 72. Head widths are
// instantiated at 32, 64, 72, 96 and 128, and at 136 and 256 for heads
// wider than 128 (one q tile a warp); a narrower head takes the next
// instance with its extra columns zero.
//
// float32 — flash_kernel, f32 FMA loops: one 64-row q tile in shared
// memory, 64-row k/v tiles streamed past it, four threads per q row
// reducing the row's max and sum by shuffles; D kept as it is (row
// stride D + 1). Tensor cores in TF32 would not hold the float32
// card-against-CPU check, so it stays on the FMA units.
//
// Measured per Hiera-L@1024 analyze() (40 launches, bf16; chip_smoke.py,
// H100 80GB HBM3 at 700 W, parent and this design in one call): 1.655
// and 1.656 ms against the parent's f32-FMA loops at 32.265 and 32.366,
// and SDPA's 1.145 and 1.524; 0.176 ms a global launch (219 TFLOP/s,
// bound 0.039), 0.030 ms a 256-token window launch (bound 0.0056).
// float32: 32.77–32.85 ms, unchanged.
#include <cmath>

#include "common.cuh"
#include "tc.cuh"

namespace {

using namespace cvk;

constexpr int kBQ = 64;    // q rows per block
constexpr int kBK = 64;    // keys per streamed tile
constexpr int kMaxD = 128;  // largest head width
constexpr int kLanes = kThreads / kBQ;  // threads sharing one q row (4)

// The body of the float32 kernel; with LSE it also writes each row's
// log-sum-exp of the scaled scores, m + log(l), in float32.
template <typename T, bool LSE>
__device__ __forceinline__ void flash_body(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, T* __restrict__ o,
                                           float* __restrict__ lse, int nq, int nk, int hd,
                                           int pool_win, float scale) {
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
    if constexpr (LSE) {
      if (sub == 0) lse[bh * nq + qi] = m_run + logf(l_run);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
             int hd, int pool_win, float scale) {
  flash_body<T, false>(q, k, v, o, nullptr, nq, nk, hd, pool_win, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, int nq,
                 int nk, int hd, float scale) {
  flash_body<T, true>(q, k, v, o, lse, nq, nk, hd, 0, scale);
}

size_t flash_smem(int hd) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (hd + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int bh, int nq, int nk, int hd, int pool_win, float scale,
                         cudaStream_t stream, float* lse = nullptr) {
  if (hd < 1 || hd > kMaxD || nk < 1) return cudaErrorInvalidValue;
  size_t smem = flash_smem(hd);
  dim3 grid((nq + kBQ - 1) / kBQ, bh);
  if (lse != nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_lse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_lse_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, nq, nk, hd, scale);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, nq, nk, hd, pool_win, scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------ bfloat16
using tc::bf16;

constexpr int kTcWarps = 4;                  // warps per block
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcQRows = 16;                 // q rows per warp: one m16 tile
constexpr int kTcKeys = 64;                  // keys per streamed K/V tile
constexpr int kTcMaxWideNT = 9;              // widest head (in 8s) with two q tiles a warp

// Shared memory of one block: the 4 warps' q tiles of 16·mt rows, then
// for each of the 4/wpp groups `stages` buffers of a K tile and a V tile;
// rows of the head width padded to a multiple of 16 (the depth of q·kᵀ)
// plus 8.
__host__ __device__ size_t flash_tc_smem(int width, int mt, int wpp, int stages) {
  const size_t ld = (size_t)(width + 15) / 16 * 16 + 8;
  const size_t groups = kTcWarps / wpp;
  return sizeof(bf16) * ld * (kTcWarps * kTcQRows * mt + groups * stages * 2 * kTcKeys);
}

// Elementwise max of two rows of eight bf16 values.
__device__ __forceinline__ uint4 hmax8(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = __hmax2(x[i], y[i]);
  return r;
}

// NT: the instance's head width in 8-wide tiles (hd ≤ 8·NT; the columns
// past hd are zero in shared memory and never stored). MT: m16 tiles of
// q per warp (2 for long sequences: 128-row blocks read each K/V tile
// once for twice the rows).
// With LSE the body also writes each row's log-sum-exp of the scaled
// scores in natural log, m·ln 2 + ln(l) (m in log2 units), in float32.
template <int NT, int MT, bool LSE>
__device__ __forceinline__ void flash_tc_body(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v, bf16* __restrict__ o,
                                              float* __restrict__ lse, int bh, int nq, int nk,
                                              int hd, int pool_win, int wpp, int stages,
                                              float scale_log2) {
  constexpr int KS = (NT + 1) / 2;  // 16-deep steps of q·kᵀ
  constexpr int LD = KS * 16 + 8;   // row stride in shared memory, bf16
  constexpr int kStage = 2 * kTcKeys * LD;  // one K tile and one V tile
  constexpr int kWarpRows = kTcQRows * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = kTcWarps / wpp, grp = warp / wpp, wig = warp % wpp;
  const int tile_rows = kWarpRows * wpp;
  const int tiles_per_bh = (nq + tile_rows - 1) / tile_rows;
  const int tile = blockIdx.x * groups + grp;
  const bool active = tile < bh * tiles_per_bh;  // uniform over the group
  const int b = active ? tile / tiles_per_bh : 0;
  const int q0 = (active ? tile % tiles_per_bh : 0) * tile_rows + wig * kWarpRows;
  const bool has_rows = active && q0 < nq;       // uniform over the warp
  bf16* kv = qs + kTcWarps * kWarpRows * LD + (size_t)grp * stages * kStage;
  const bf16* kb = k + (size_t)b * nk * hd;
  const bf16* vb = v + (size_t)b * nk * hd;
  const int chunks = hd / 8;  // 16-byte pieces of a row

  // Zero everything once: the columns past hd and the q rows past nq
  // stay zero; cp.async writes the hd columns and zero-fills keys past nk.
  {
    const int n16 = (int)(flash_tc_smem(8 * NT, MT, wpp, stages) / 16);
    uint4* all = reinterpret_cast<uint4*>(smem_raw);
    for (int e = tid; e < n16; e += kTcThreads) all[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  auto load_kv = [&](int j, int s) {
    bf16* kt = kv + s * kStage;
    bf16* vt = kt + kTcKeys * LD;
    const int k0 = j * kTcKeys;
    for (int e = wig * 32 + lane; e < kTcKeys * chunks; e += wpp * 32) {
      const int r = e / chunks, c8 = (e % chunks) * 8, key = k0 + r;
      const bool in = key < nk;
      const size_t off = (size_t)(in ? key : 0) * hd + c8;
      tc::cp_async16(kt + r * LD + c8, kb + off, in);
      tc::cp_async16(vt + r * LD + c8, vb + off, in);
    }
  };
  if (active) load_kv(0, 0);
  tc::cp_async_commit();

  // this warp's q rows, 2×2-pooled as they load where pool_win > 0
  bf16* qw = qs + warp * kWarpRows * LD;
  if (has_rows) {
    const bf16* qb = q + (size_t)b * (pool_win ? pool_win * pool_win : nq) * hd;
    for (int e = lane; e < kWarpRows * chunks; e += 32) {
      const int r = e / chunks, c8 = (e % chunks) * 8, qi = q0 + r;
      if (qi >= nq) continue;
      uint4 val;
      if (pool_win) {
        const int m = pool_win / 2;
        const bf16* a = qb + ((size_t)(2 * (qi / m)) * pool_win + 2 * (qi % m)) * hd + c8;
        const size_t down = (size_t)pool_win * hd;
        val = hmax8(hmax8(*reinterpret_cast<const uint4*>(a),
                          *reinterpret_cast<const uint4*>(a + hd)),
                    hmax8(*reinterpret_cast<const uint4*>(a + down),
                          *reinterpret_cast<const uint4*>(a + down + hd)));
      } else {
        val = *reinterpret_cast<const uint4*>(qb + (size_t)qi * hd + c8);
      }
      *reinterpret_cast<uint4*>(qw + r * LD + c8) = val;
    }
  }
  __syncwarp();

  // running max (in log2 units of the scaled score) and sum of rows g and
  // g + 8 of each m16 tile
  float m_run[MT][2], l_run[MT][2], acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int d = 0; d < NT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.f;
  }

  const int ntiles = (nk + kTcKeys - 1) / kTcKeys;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles && active) load_kv(j + 1, (j + 1) % stages);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();         // ... and every thread's
    if (has_rows) {
      const bf16* kt = kv + (j % stages) * kStage;
      const bf16* vt = kt + kTcKeys * LD;
      // S = q·kᵀ: 16·MT rows × 64 keys, eight 8-key tiles per m16 tile;
      // each K fragment serves the MT q tiles
      float s[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::ldsm_x4(qf[mt], qw + (16 * mt + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bk[4];
          tc::ldsm_x4(bk, kt + (jj * 16 + (lane % 8) + (lane / 16) * 8) * LD + ks * 16 +
                              ((lane / 8) % 2) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(s[mt][2 * jj], qf[mt], bk[0], bk[1]);
            tc::mma_bf16(s[mt][2 * jj + 1], qf[mt], bk[2], bk[3]);
          }
        }
      }
      // online softmax in base 2 with the scale folded in: p =
      // 2^(s·c − m·c), c = D^-0.5·log2(e), the same e^((s − m)·D^-0.5).
      // This thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3) of each
      // m16 tile at keys 8n + 2t + (e & 1).
      const int k0 = j * kTcKeys;
      const bool ragged = k0 + kTcKeys > nk;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float val = s[mt][n][e] * scale_log2;
            if (ragged && k0 + 8 * n + 2 * (lane % 4) + (e & 1) >= nk) val = -INFINITY;
            s[mt][n][e] = val;
            mx[e >> 1] = fmaxf(mx[e >> 1], val);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[mt][r], mx[r]);
          alpha[r] = exp2f(m_run[mt][r] - m_new);  // 0 on the first tile
          m_run[mt][r] = m_new;
          l_run[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[mt][n][e] - m_run[mt][e >> 1]);
            l_run[mt][e >> 1] += p;  // the unrounded p: the divisor's terms
            s[mt][n][e] = p;
          }
#pragma unroll
        for (int d = 0; d < NT; ++d) {
          acc[mt][d][0] *= alpha[0];
          acc[mt][d][1] *= alpha[0];
          acc[mt][d][2] *= alpha[1];
          acc[mt][d][3] *= alpha[1];
        }
      }
      // O += p·v: p rounded to bf16 as it becomes the A fragment; each V
      // fragment serves the MT q tiles
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = tc::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = tc::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = tc::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = tc::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
        const bf16* vrow = vt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD;
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t bv[4];
          tc::ldsm_x4_t(bv, vrow + dp * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
            tc::mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
          }
        }
        if constexpr (NT % 2 == 1) {
          uint32_t bv[2];
          tc::ldsm_x2_t(bv, vrow + (NT - 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) tc::mma_bf16(acc[mt][NT - 1], pa[mt], bv[0], bv[1]);
        }
      }
    }
    __syncthreads();  // the buffer of tile j is refilled next iteration
  }

  if (has_rows) {
    const int g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[mt][r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;
        const int qi = q0 + 16 * mt + g + 8 * r;
        if (qi >= nq) continue;
        bf16* orow = o + ((size_t)b * nq + qi) * hd;
#pragma unroll
        for (int d = 0; d < NT; ++d) {
          const int col = 8 * d + t2;
          if (col < hd)
            *reinterpret_cast<uint32_t*>(orow + col) =
                tc::pack_bf16(acc[mt][d][2 * r] * inv, acc[mt][d][2 * r + 1] * inv);
        }
        if constexpr (LSE) {
          if (lane % 4 == 0)
            lse[(size_t)b * nq + qi] = m_run[mt][r] * 0.69314718055994531f + logf(l);
        }
      }
  }
}

template <int NT, int MT>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int bh, int nq,
                int nk, int hd, int pool_win, int wpp, int stages, float scale_log2) {
  flash_tc_body<NT, MT, false>(q, k, v, o, nullptr, bh, nq, nk, hd, pool_win, wpp, stages,
                               scale_log2);
}

template <int NT, int MT>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int bh, int nq, int nk, int hd, int wpp, int stages, float scale_log2) {
  flash_tc_body<NT, MT, true>(q, k, v, o, lse, bh, nq, nk, hd, 0, wpp, stages, scale_log2);
}

// LSE: launch flash_tc_lse_kernel, which also writes `lse` (pool_win 0).
template <int NT, int MT, bool LSE = false>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v, void* o, int bh,
                            int nq, int nk, int hd, int pool_win, int wpp, int stages,
                            float scale_log2, cudaStream_t stream, float* lse = nullptr) {
  const size_t smem = flash_tc_smem(8 * NT, MT, wpp, stages);
  const int tile_rows = kTcQRows * MT * wpp, groups = kTcWarps / wpp;
  const long long tiles = (long long)bh * ((nq + tile_rows - 1) / tile_rows);
  const unsigned blocks = (unsigned)((tiles + groups - 1) / groups);
  if constexpr (LSE) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_lse_kernel<NT, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_tc_lse_kernel<NT, MT><<<blocks, kTcThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, bh, nq, nk, hd, wpp,
        stages, scale_log2);
    return cudaGetLastError();
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<NT, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_tc_kernel<NT, MT><<<blocks, kTcThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, bh, nq, nk, hd, pool_win,
        wpp, stages, scale_log2);
    return cudaGetLastError();
  }
}

template <int NT>
cudaError_t launch_flash_width(int mt, const void* q, const void* k, const void* v, void* o,
                               int bh, int nq, int nk, int hd, int pool_win, int wpp,
                               int stages, float scale_log2, cudaStream_t stream) {
  if (mt == 1)
    return launch_flash_tc<NT, 1>(q, k, v, o, bh, nq, nk, hd, pool_win, wpp, stages,
                                  scale_log2, stream);
  if constexpr (NT <= kTcMaxWideNT) {
    if (mt == 2 && wpp == kTcWarps)
      return launch_flash_tc<NT, 2>(q, k, v, o, bh, nq, nk, hd, pool_win, wpp, stages,
                                    scale_log2, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared-memory bytes of a bfloat16 launch at instance `width` (a head
// width the kernel is built for), mt m16 q tiles per warp, wpp warps per
// problem and `stages` K/V buffers per group (the wrapper's plan must
// agree).
extern "C" long long cv_flash_attn_bf16_smem(int width, int mt, int wpp, int stages) {
  return (long long)flash_tc_smem(width, mt, wpp, stages);
}

// bfloat16 on the tensor cores. q (bh, nq, hd) — or (bh, pool_win², hd)
// with pool_win > 0, nq = pool_win²/4 — k, v (bh, nk, hd), o (bh, nq,
// hd); bh = batch·heads; every pointer 16-byte aligned, hd a multiple of
// 8. The launch plan comes from the wrapper (ops/cuda/flash_attn.py
// flash_plan): `width` ∈ {32, 64, 72, 96, 128, 136, 256}, ≥ hd; mt ∈ {1,
// 2} m16 q tiles per warp (2 only with wpp = 4 and width ≤ 72); wpp ∈ {1,
// 2, 4} warps per (batch·head, q tile) problem; `stages` 2, or 1 where nk
// ≤ 64. scale_log2 = log2(e) · the softmax scale.
extern "C" int cv_flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                                  int bh, int nq, int nk, int hd, int pool_win, int width,
                                  int mt, int wpp, int stages, float scale_log2,
                                  void* stream) {
  if (hd < 8 || hd % 8 || hd > width || nq < 1 || nk < 1 || bh < 1 ||
      (wpp != 1 && wpp != 2 && wpp != 4) || stages < 1 || stages > 2 ||
      (stages == 1 && nk > kTcKeys))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto launch) {
    return (int)launch(mt, q, k, v, o, bh, nq, nk, hd, pool_win, wpp, stages, scale_log2, s);
  };
  switch (width) {
    case 32: return run(launch_flash_width<4>);
    case 64: return run(launch_flash_width<8>);
    case 72: return run(launch_flash_width<9>);
    case 96: return run(launch_flash_width<12>);
    case 128: return run(launch_flash_width<16>);
    case 136: return run(launch_flash_width<17>);
    case 256: return run(launch_flash_width<32>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward of the training path (FlashAttention in ops/cuda/
// flash_attn.py): as cv_flash_attn_bf16 without pool_win, at the
// instances of width 72 (mt 1 or 2), 96 and 128 (mt 1) only — hd a
// multiple of 8 up to `width` — and also writing lse (bh, nq) float32, each row's
// log-sum-exp of the scaled scores, the residual the backward
// (flash_bwd.cu) recomputes the probabilities from.
extern "C" int cv_flash_attn_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int bh, int nq, int nk, int hd, int width,
                                      int mt, int wpp, int stages, float scale_log2,
                                      void* stream) {
  if (hd < 8 || hd % 8 || hd > width || nq < 1 || nk < 1 || bh < 1 ||
      (wpp != 1 && wpp != 2 && wpp != 4) || stages < 1 || stages > 2 ||
      (stages == 1 && nk > kTcKeys) || (mt == 2 && wpp != kTcWarps) || mt < 1 || mt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 72 && mt == 2)
    return (int)launch_flash_tc<9, 2, true>(q, k, v, o, bh, nq, nk, hd, 0, wpp, stages,
                                            scale_log2, s, (float*)lse);
  if (width == 72)
    return (int)launch_flash_tc<9, 1, true>(q, k, v, o, bh, nq, nk, hd, 0, wpp, stages,
                                            scale_log2, s, (float*)lse);
  if (width == 96 && mt == 1)
    return (int)launch_flash_tc<12, 1, true>(q, k, v, o, bh, nq, nk, hd, 0, wpp, stages,
                                             scale_log2, s, (float*)lse);
  if (width == 128 && mt == 1)
    return (int)launch_flash_tc<16, 1, true>(q, k, v, o, bh, nq, nk, hd, 0, wpp, stages,
                                             scale_log2, s, (float*)lse);
  return (int)cudaErrorInvalidValue;
}

// float32 forward with lse, as cv_flash_attn_f32 without pool_win.
extern "C" int cv_flash_attn_lse_f32(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int bh, int nq, int nk, int hd, float scale,
                                     void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch_flash<float>(q, k, v, o, bh, nq, nk, hd, 0, scale, (cudaStream_t)stream,
                             (float*)lse);
}

// float32 on the FMA units (flash_kernel); same layouts as above, any hd
// up to 128; `scale` the softmax scale.
extern "C" int cv_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                 int bh, int nq, int nk, int hd, int pool_win, float scale,
                                 void* stream) {
  return launch_flash<float>(q, k, v, o, bh, nq, nk, hd, pool_win, scale,
                             (cudaStream_t)stream);
}
