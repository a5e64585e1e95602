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
// ≈ 83 GFLOP, 0.083 ms at 989 TFLOP/s, and the q-pool launch at win 4,
// 288 → 576 ≈ 24.5 GFLOP, 0.025 ms. Every block also streams all its
// weights from L2: 8·C² bytes for the window block's 64 rows, ≈ 2 MB for
// that q-pool block's 128.
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
//   3. Attention per (16-row slab, head), one warp each (attend16, shared
//      with the q-pool kernel): S = q·kᵀ over the slab's own window (T ≤
//      64 keys: at T = 16 each window-head is one m16 tile against its 16
//      keys, not a masked 64×64 tile), depth hd in 16-deep steps, the
//      last half-step of hd = 72 (or 56) zeroed in registers; then the
//      exact softmax — f32 scores × scale, max, exp and sum over the
//      quad — with P rounded to bf16 as it becomes the A fragment of P·V
//      (V through ldmatrix.trans); O = bf16(P·V) overwrites the slab's q
//      columns.
// Why mma.sync rather than wgmma here: rows of the head width (144 bytes
// at hd = 72) and of C = 144 or 288 (288, 576 bytes) are not whole
// 128-byte swizzle spans, so wgmma's descriptors would need a re-laid
// copy of q, k, v and o; the warp-level product reads them as they are,
// each row padded by 16 bytes so the eight rows one ldmatrix reads fall
// in distinct bank groups. Shared memory (bf16): xn 64 × (C + 8), q|k|v
// 64 × (3C + 8), two weight tiles 48 × (C + 8) — 104,960 bytes at C =
// 144, so two blocks share an SM; 206,336 at C = 288, one. T ∈ {16, 32,
// 64}; head widths 56, 72 and 96, those of Hiera-b+, -L and -t/-s
// (template instances). Measured per Hiera-L@1024 analyze()
// (chip_smoke.py, H100 80GB HBM3 at 700 W): 1.03 ms against the FMA
// kernel's 16.77, 80 TFLOP/s at both shapes.
//
// qpool_attn_block, bfloat16 — ln_rows_kernel (tc_gemm.cuh, the LN
// pre-pass of mlp_block and ln_qkv: xn = bf16(LN1(x)) through
// layernorm_rows into a bf16 workspace) and qpool_tc_kernel. What bounds
// the block kernel: every block streams all of Wskip, Wqkv and Wproj
// (≈ 2 MB at 288 → 576) from L2 for the rows it owns, so rows per block
// set the weight traffic (64 rows: 512 MB from L2 per call, ≈ 0.13 ms
// alone on the card); and one block fills an SM's shared memory, so its
// phases run one after another. The FMA design it replaces held one
// window in f32 a block and read those weights 1024 times through 32×64
// f32 tiles on the FMA units (6.7 ms at win 4, 11.5× slower than the
// tiled route). The design:
//   * A block owns 128 input rows — eight windows of win 4, or two of win
//     8 — and emits 32 pooled rows, halving the weight traffic of a
//     64-row block. Warp w owns rows 16w .. 16w + 15 and, once xn's
//     rows have come in (one cp.async burst from the pre-pass's
//     workspace), holds their A fragments in registers (c_in / 16 steps
//     of 4 registers); xn's shared memory then serves the head groups.
//   * Input-side products on wgmma m64n32k16 with A from registers: each
//     warpgroup its 64 rows × the 32 columns of a weight tile, B read by
//     the tensor cores from 64-deep 128-byte-swizzled panels (the
//     16-byte pieces placed by cp.async where the swizzle expects them,
//     so no TMA descriptor). Three tiles of 32 rows ring through shared
//     memory, two in flight; the next copy is issued while the tile's
//     wgmmas run. Tile j is Wskip's rows, then per head group (two heads,
//     gw = 2·hd columns) the rows of its [q | k | v] columns of Wqkv.
//     The depth is a template argument (c_in ∈ {96, 144, 192, 288}):
//     with a runtime depth each wgmma sat behind a branch and ptxas
//     serialised them, 4× slower.
//   * Pool in the accumulators. wgmma's accumulator layout is mma's per
//     warp, and a warp's 16 rows hold whole pool partners at both window
//     sizes (win 4: row 4i + j, partners in lanes ^ 4 and ^ 16; win 8:
//     rows 8i + j of i = 2s, 2s + 1, partners in lane ^ 4 and the
//     thread's own row g + 8), so skip and q are pooled with shuffles and
//     their full-resolution values never reach shared memory. The bias
//     goes in first; rounding commutes with max, so one rounding after
//     the max is the plain version's bf16(...) then pool. The pooled
//     shortcut goes straight to the block's output rows.
//   * Attention per head group, on mma.sync (attend16), four warps: two
//     heads × two 16-query tiles, each against its 64 keys — at win 4
//     four windows of 4 queries and 16 keys in one m16 tile under a
//     block-diagonal mask (query r sees keys j with r / 4 == j / 16),
//     exact since a masked score's exp is 0, chosen over four m16 tiles
//     of 4 live rows each; at win 8 one window. O_h goes to its columns
//     of o (32 × C_out).
//   * out = bf16(skip + bf16(o·Wprojᵀ + b)) on mma.sync: o is 32 rows,
//     so the product runs the other way round — each warp holds 18
//     8-column units of one 16-row half for the whole depth, and Wproj
//     streams through three tiles of all C_out rows × 32 deep, laid over
//     the ring and the group's memory; the epilogue reads the shortcut
//     back from the output rows.
//   Shared memory (bf16, rows padded by 16 bytes): o 32 × (C_out + 8) and
//   the biases (4·C_out) for the whole block; the weight ring 3 × 32 rows
//   × ⌈C_in/64⌉ panels of 128 bytes; xn 128 × (C_in + 8), then a group's
//   pooled q 32 × (2hd + 8) and k|v 128 × (4hd + 8), sized for hd ≤ 96;
//   then the Wproj ring 3 × C_out × 40 over ring and group: 217,600
//   bytes at 288 → 576 and 172,288 at 144 → 288, one block an SM
//   (134–213 registers a thread). An even number of heads of width 56,
//   72 or 96, C_out ≤ 576; other shapes take the tiled route.
// After this, no bf16 Hiera kernel of the port multiplies on the FMA
// units.
//
// window_attn_block, float32 — four launches, every product 3×TF32 on
// the tensor cores (tf32.cuh, below), at t ∈ {16, 32, 64} and head widths
// 56, 72 and 96:
//   1. the LN pre-pass (tf32::ln_rows_kernel: xn = LN1(x) through
//      layernorm_rows<float>) into an f32 workspace;
//   2. q | k | v = xn·Wqkvᵀ + b as one GEMM (tf32.cuh gemm_kernel, BiasF32)
//      into the workspace;
//   3. attention per (16 query rows, head), one warp each, a block of four
//      warps per (64 rows, head) (window_attn_f32_kernel): the head's k and
//      v for the block's rows in shared memory by cp.async, v landing while
//      S is computed, q's fragments from L2 into registers; each warp
//      against only its own window's t keys — at t = 16 one m16 tile of 16
//      keys, not a three-quarters-masked 64 × 64 one — f32 scores × scale,
//      the exact softmax over the quad, P normalised in f32 as the plain
//      version computes it, then O = P·V with P's accumulators read as the
//      A fragments in place (keys permuted within each 8-deep step, V's
//      rows read in the same order);
//   4. out = x + (o·Wprojᵀ + b) (ProjF32, skip = x), the depth split where
//      the plan says so (partial sums added in split order).
// What bounds it: the products, 3 × ops ÷ 495 TFLOP/s — 0.017 ms per
// trained-product analyze() (2 launches, 2.87 GFLOP) against 0.043 at the
// FMA units' 67 TFLOP/s; the workspace round trips (xn, q|k|v, o: 5·rows·C
// floats written and read, 47 MB per analyze(), mostly in L2) come on top.
// Why not one block kernel: in float32 a block's xn, q|k|v and weight
// tiles pass 227 KB at C = 192 with 64 rows, and a 64-row block streams
// all of Wqkv and Wproj (4·C² floats) from L2 for those rows. The FMA
// design it replaces held one window a block: staged-tile f32 FMA loops
// with 4 accumulators a thread, all the weights from L2 for each window
// (38 and 151 MB a launch at t@512), the attention scalar. Other float32
// shapes (t = 256, other head widths) take the tiled route. Measured
// (scripts/kernel_rows.py, H100 80GB HBM3 at 700 W, the FMA kernel in the
// same call): 0.118–0.120 ms per trained-product analyze() (t = 64: 0.067,
// t = 16: 0.052) against 0.831 for the FMA kernel and 0.147 for its q|k|v
// and proj F.linear calls with F.scaled_dot_product_attention (cuBLAS and
// SDPA, float32); at L@1024 0.373 and 0.261 ms a launch (FMA: 4.20, 1.61).
//
// qpool_attn_block, float32 — four launches, every product 3×TF32 on the
// tensor cores (tf32.cuh: each operand split into hi and lo in
// registers, lo·hi + hi·lo + hi·hi on mma.sync m16n8k8 .tf32, float32
// accumulators), at win 4 and 8 and head widths 56, 72 and 96:
//   1. the LN pre-pass (tf32::ln_rows_kernel: xn = LN1(x) through
//      layernorm_rows<float>) into an f32 workspace;
//   2. [skip | q | k | v] = xn·[Wskip; Wqkv]ᵀ + b as one GEMM (tf32.cuh
//      gemm_kernel, Wskip's rows then Wqkv's) on 64 × 64 blocks — a
//      64-token window of win 8, four of win 4. Skip and q are pooled in
//      the accumulators (PoolF32: an m16 tile holds whole pool partners
//      at both window sizes, as in pool_store) and only the pooled rows
//      reach the workspace; k and v at full resolution;
//   3. attention per (16 pooled queries, head), a block of four warps
//      each (qpool_attn_f32_kernel): the head's k and v in shared memory
//      by cp.async, v landing while S is computed, q's fragments from L2
//      into registers; S = q·kᵀ against the tile's 64 keys, 16 a warp —
//      at win 4 four windows under a block-diagonal mask, exact since a
//      masked score's exp is 0 — f32 scores × scale, max, exp and sum
//      across the warps, P normalised in f32 as the plain version computes
//      it, then O = P·V, a third of the head's columns a warp;
//   4. out = skip + (o·Wprojᵀ + b) (ProjF32) over the pooled rows, a
//      quarter of the input's, the depth split where the row tiles leave
//      SMs idle (win 4: 1024 rows, 96 blocks; the partial sums added in
//      split order).
// Why not one block kernel as in bf16: float32 tiles take twice bf16's
// shared memory; at 192 → 384 the 128-row block's xn, one head group's
// k|v and the attention output alone pass 227 KB, and 64-row blocks
// leave 64 of 132 SMs busy at win 4. What bounds it: the products, 3 ×
// ops ÷ 495 TFLOP/s — 0.035 ms per trained-product analyze() (2
// launches, 5.6 GFLOP) against 0.085 at the FMA units' 67 TFLOP/s; the
// workspace round trips (k|v: 25.2 and 12.6 MB written, then read) come
// on top. The FMA design
// it replaces held one window a block and streamed all of Wskip, Wqkv and
// Wproj from L2 for each (453 MB at win 4), its attention scalar. Other
// float32 shapes (win 16, other head widths) take the tiled route.
// Measured (scripts/kernel_rows.py, H100 80GB HBM3 at 700 W, the FMA
// kernel in the same call): 0.180 ms per trained-product analyze() (win
// 8: 0.097, win 4: 0.083) against 1.293 for the FMA kernel and 0.187 for
// its skip, qkv and proj F.linear calls (cuBLAS float32).
#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "tc.cuh"
#include "tc_gemm.cuh"
#include "tf32.cuh"

namespace {

using namespace cvk;

// Softmax scale from the head width, 1/sqrt(c / heads).
float head_scale(int c, int heads) {
  return (float)(1.0 / std::sqrt((double)(c / heads)));
}


// ------------------------------------------------------------ bfloat16
using tc::bf16;

constexpr int kTcRows = 64;               // rows a block owns: 64 / t windows
constexpr int kTcBN = 48;                 // weight rows per staged tile
constexpr int kTcWarps = kThreads / 32;   // 8
constexpr int kQpRows = 128;              // input rows a q-pool block owns, 16 a warp
constexpr int kQpOut = kQpRows / 4;       // pooled rows it emits
constexpr int kQpGroupMax = 2 * 96;       // columns of a head group (two heads) at most
constexpr int kQpBN = 32;                 // weight rows per staged q-pool input tile
constexpr int kQpStages = 3;              // q-pool weight rings: two tiles in flight
constexpr int kQpProjK = 32;              // depth of a staged Wproj tile
constexpr int kQpUnits = 18;              // 8-column units of the projection a warp holds

// Shared memory of one bf16 block at width c: xn (64 rows), q|k|v (64
// rows of 3c) and two staged weight tiles (48 rows of c), all bf16, each
// row padded by 16 bytes so the eight rows one ldmatrix reads fall in
// distinct bank groups (c a multiple of 16).
size_t window_tc_smem(int c) {
  return sizeof(bf16) * ((size_t)kTcRows * (c + 8) + (size_t)kTcRows * (3 * c + 8) +
                         (size_t)2 * kTcBN * (c + 8));
}

// Shared memory of one bf16 q-pool block, c_in → c_out (bf16, rows
// padded by 16 bytes): the attention output (32 × c_out) and the skip
// and qkv biases (4·c_out) for the whole block, and three staged weight
// tiles (32 × c_in); beside them first xn (128 × c_in) until the warps
// hold its fragments, then a head group's pooled q (32 × 2hd) and k|v
// (128 × 4hd), sized for hd ≤ 96; at the end three staged Wproj tiles
// (c_out × 32) over tiles and group.
size_t qpool_tc_smem(int c_in, int c_out) {
  const size_t keep = sizeof(bf16) * ((size_t)kQpOut * (c_out + 8) + 4 * (size_t)c_out);
  const size_t ring = (size_t)kQpStages * ((c_in + 63) / 64) * kQpBN * 128;
  const size_t group = sizeof(bf16) * std::max((size_t)kQpRows * (c_in + 8),
                                               (size_t)kQpOut * (kQpGroupMax + 8) +
                                                   (size_t)kQpRows * (2 * kQpGroupMax + 8));
  const size_t proj = sizeof(bf16) * kQpStages * c_out * (kQpProjK + 8);
  return keep + 1024 + std::max(ring + group, proj);  // + the swizzle's 1024-byte alignment
}

// Softmax attention of one 16-row query tile over nk ∈ {16, 32, 64} keys
// for one head of width 8·NT, by one warp on mma.sync: S = q·kᵀ (the
// whole row in registers, depth in 16-deep steps, an odd NT's last
// half-step zeroed in q's and k's registers), the exact softmax — f32
// scores × scale, max, exp and sum over the quad — with P rounded to
// bf16 as it becomes the A fragment of P·V (V through ldmatrix.trans),
// and O = bf16(P·V) to o. q, k, v point at the head's first column of
// their first row (q stride ldq; k and v stride ldk). With MASK_Q > 0,
// query row r sees only the keys j with r / MASK_Q == j / MASK_K:
// several windows in one tile, a block-diagonal mask, exact since a
// masked score's exp is 0. The warp syncs before it writes o, which may
// be q itself.
template <int NT, int MASK_Q = 0, int MASK_K = 1>
__device__ __forceinline__ void attend16(const bf16* q, int ldq, const bf16* k, const bf16* v,
                                         int ldk, int nk, bf16* o, int ldo, float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
  const int nk8 = nk / 8;
  constexpr int KS = (NT + 1) / 2;  // 16-deep steps over hd; an odd NT's last is half zero
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bool half = NT % 2 == 1 && ks == KS - 1;  // depth hd..hd+15 is the next columns'
    uint32_t qf[4];
    tc::ldsm_x4(qf, q + (lane % 16) * ldq + ks * 16 + (lane / 16) * 8);
    if (half) qf[2] = qf[3] = 0u;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (16 * jj >= nk) break;
      uint32_t bk[4];
      tc::ldsm_x4(bk, k + (jj * 16 + lane % 8 + (lane / 16) * 8) * ldk + ks * 16 +
                          ((lane / 8) % 2) * 8);
      if (half) bk[1] = bk[3] = 0u;
      tc::mma_bf16(s[2 * jj], qf, bk[0], bk[1]);
      tc::mma_bf16(s[2 * jj + 1], qf, bk[2], bk[3]);
    }
  }
  // rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8n + 2t + (e & 1); the
  // four lanes of a quad hold a row's keys
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
    if (n < nk8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if constexpr (MASK_Q > 0)
          if ((g + 8 * (e >> 1)) / MASK_Q != (8 * n + t2 + (e & 1)) / MASK_K) s[n][e] = -INFINITY;
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
  float acc[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= nk) break;
    uint32_t pa[4];
    pa[0] = tc::pack_bf16(s[2 * kk][0] / sum[0], s[2 * kk][1] / sum[0]);
    pa[1] = tc::pack_bf16(s[2 * kk][2] / sum[1], s[2 * kk][3] / sum[1]);
    pa[2] = tc::pack_bf16(s[2 * kk + 1][0] / sum[0], s[2 * kk + 1][1] / sum[0]);
    pa[3] = tc::pack_bf16(s[2 * kk + 1][2] / sum[1], s[2 * kk + 1][3] / sum[1]);
    const bf16* vrow = v + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ldk;
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bv[4];
      tc::ldsm_x4_t(bv, vrow + dp * 16 + (lane / 16) * 8);
      tc::mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
      tc::mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
    }
    if constexpr (NT % 2 == 1) {
      uint32_t bv[2];
      tc::ldsm_x2_t(bv, vrow + (NT - 1) * 8);
      tc::mma_bf16(acc[NT - 1], pa, bv[0], bv[1]);
    }
  }
  __syncwarp();  // q is read; o may take the same columns
#pragma unroll
  for (int d = 0; d < NT; ++d) {
    bf16* orow = o + g * ldo + 8 * d + t2;
    *reinterpret_cast<uint32_t*>(orow) = tc::pack_bf16(acc[d][0], acc[d][1]);
    *reinterpret_cast<uint32_t*>(orow + 8 * ldo) = tc::pack_bf16(acc[d][2], acc[d][3]);
  }
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
      // attention per (16-row slab, head), one warp each, over the
      // slab's window (at t = 16 each window-head is one m16 tile
      // against its 16 keys, not a masked 64 × 64 tile); O = bf16(P·V)
      // overwrites the slab's q columns
      for (int u = warp; u < 4 * heads; u += kTcWarps) {
        const int q0 = (u / heads) * 16, h = u % heads, key0 = q0 / t * t;
        if (key0 >= rows) continue;
        bf16* qh = qkv + q0 * ldq + h * hd;
        const bf16* kh = qkv + key0 * ldq + c + h * hd;
        attend16<NT>(qh, ldq, kh, kh + c, ldq, t, qh, ldq, scale);
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

// The 2×2 max-pool of one 8-column unit of a warp's m16 product, in the
// accumulators: v holds columns 2t, 2t + 1 of rows g (v[0], v[1]) and
// g + 8 (v[2], v[3]) of the warp's 16 rows, window-major. win 4: the 16
// rows are one window, row 4i + j; the partners of row g are rows g ^ 1
// (lane ^ 4) and g ^ 4 (lane ^ 16). win 8: the rows are rows 2s, 2s + 1
// of a window (s = slab % 4); row g's partners are row g ^ 1 (lane ^ 4)
// and the thread's own g + 8. The lanes holding a pooled pair store it to
// dst + (its pooled row) · ld where that row is below `limit`, the
// pooled rows of slab s being 4s + 0..3. Every lane of the warp calls it.
__device__ __forceinline__ void pool_store(const float (&v)[4], int win, int slab, bf16* dst,
                                           int ld, int limit) {
  const int g = (threadIdx.x % 32) / 4;
  if (win == 4) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float a0 = v[2 * hr], a1 = v[2 * hr + 1];
      a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, 4));
      a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, 4));
      a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, 16));
      a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, 16));
      const int row = 4 * slab + g / 2 + 2 * hr;  // g ∈ {0, 2} hold rows g / 2, 2 + g / 2
      if ((g & 5) == 0 && row < limit)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row * ld) = tc::pack_bf16(a0, a1);
    }
  } else {
    float a0 = fmaxf(v[0], v[2]), a1 = fmaxf(v[1], v[3]);
    a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, 4));
    a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, 4));
    const int row = 4 * slab + g / 2;  // even g hold the pooled rows
    if ((g & 1) == 0 && row < limit)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * ld) = tc::pack_bf16(a0, a1);
  }
}

// The q-pool block in bf16: 128 input rows (eight 16-token windows of win
// 4, or two 64-token windows of win 8) to 32 pooled rows, every product
// on the tensor cores. NT: the head width in 8-column tiles; KS: c_in in
// 16-deep steps (c_in = 16·KS, so every loop over depth and every load
// has a compile-time shape, and no branch separates the wgmmas of a
// tile, which would serialise them). xln holds xn = bf16(LN1(x)), the
// LN pre-pass's output. Warp w owns input rows 16w .. 16w + 15 and keeps
// their A fragments (xn) in registers for every input-side product, so
// xn's shared memory goes to the head groups. The heads go in groups of two (gw = 2·hd columns);
// input-side weight tile j (32 rows of c_in) is Wskip's rows for j <
// n_skip, then, per group, rows of the group's [q | k | v] columns of
// Wqkv. Rows past rows_total are zero and never stored.
template <int NT, int KS>
__global__ void __launch_bounds__(kThreads)
qpool_tc_kernel(const bf16* __restrict__ xln, const bf16* __restrict__ wskip,
                const bf16* __restrict__ bskip, const bf16* __restrict__ wqkv,
                const bf16* __restrict__ bqkv, const bf16* __restrict__ wproj,
                const bf16* __restrict__ bproj, bf16* __restrict__ out, int rows_total,
                int win, int c_out, float scale) {
  constexpr int hd = 8 * NT, gw = 2 * hd;  // a group's columns of q, of k and of v
  constexpr int c_in = 16 * KS, chunks = c_in / 8;  // 16-byte pieces of an input row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldo = c_out + 8;
  constexpr int ldx = c_in + 8, ldq = gw + 8, ldkv = 2 * gw + 8, ldp = kQpProjK + 8;
  bf16* o = reinterpret_cast<bf16*>(smem_raw);  // 32 × ldo: attention output
  bf16* bias_s = o + kQpOut * ldo;              // c_out skip, 3·c_out qkv biases
  // 3 weight tiles of 32 rows × c_in in 64-deep panels of 32 rows × 128
  // bytes, 128-byte swizzled for wgmma, on the swizzle's 1024-byte
  // alignment
  constexpr int panels = (c_in + 63) / 64, stage_bytes = panels * kQpBN * 128;
  const uint32_t raw = tc::smem_u32(bias_s + 4 * c_out), ring_u32 = (raw + 1023) & ~1023u;
  unsigned char* ring = reinterpret_cast<unsigned char*>(bias_s + 4 * c_out) + (ring_u32 - raw);
  bf16* xn = reinterpret_cast<bf16*>(ring + kQpStages * stage_bytes);  // 128 × ldx: LN1(x)
                                                // until the fragments are loaded; then:
  bf16* qp = xn;                                // 32 × ldq: a group's pooled q
  bf16* kv = qp + kQpOut * ldq;                 // 128 × ldkv: a group's k | v
  bf16* pring = reinterpret_cast<bf16*>(ring);  // 3 × c_out × ldp: Wproj tiles, at the end
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int r0 = blockIdx.x * kQpRows;
  const int rows = min(kQpRows, rows_total - r0), out_rows = rows / 4;
  const int heads = c_out / hd, n_groups = heads / 2;
  const int n_skip = (c_out + kQpBN - 1) / kQpBN;
  constexpr int n_grp = (3 * gw + kQpBN - 1) / kQpBN;
  const int n_in = n_skip + n_groups * n_grp;
  bf16* ob = out + (size_t)blockIdx.x * kQpOut * c_out;  // this block's output rows

  // tile j: Wskip's (j < n_skip) or group grp's, its first column v0 of
  // the section; a group column's part (q, k or v) by comparisons
  auto tile_of = [&](int j, int& grp, int& v0) {
    grp = j < n_skip ? -1 : (j - n_skip) / n_grp;
    v0 = (grp < 0 ? j : j - n_skip - grp * n_grp) * kQpBN;
  };
  auto part_of = [](int vc) { return (vc >= gw) + (vc >= 2 * gw); };
  // tile row r's 16-byte piece c (depth 8c) goes to panel c / 8 at its
  // swizzled place; rows past the section's columns are zero-filled
  auto load_w = [&](int j) {
    int grp, v0;
    tile_of(j, grp, v0);
    unsigned char* dst = ring + (j % kQpStages) * stage_bytes;
#pragma unroll
    for (int e = tid; e < kQpBN * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks, vc = v0 + r;
      const bf16* src = nullptr;
      if (grp < 0) {
        if (vc < c_out) src = wskip + (size_t)vc * c_in;
      } else if (vc < 3 * gw) {
        const int part = part_of(vc);
        src = wqkv + (size_t)(part * c_out + grp * gw + vc - part * gw) * c_in;
      }
      tc::cp_async16(dst + (c / 8) * (kQpBN * 128) + tc::sw128_offset(r, c % 8),
                     src ? src + 8 * c : wqkv, src != nullptr);
    }
  };
  // the first two weight tiles in flight, one commit group each; then the
  // biases and the block's rows of xn (the LN pre-pass's output; rows
  // past `rows` zero) in one burst
#pragma unroll
  for (int s = 0; s < kQpStages - 1; ++s) {
    if (s < n_in) load_w(s);
    tc::cp_async_commit();
  }
  {
    for (int e = tid; e < c_out / 8; e += kThreads) tc::cp_async16(bias_s + 8 * e, bskip + 8 * e, true);
    for (int e = tid; e < 3 * c_out / 8; e += kThreads)
      tc::cp_async16(bias_s + c_out + 8 * e, bqkv + 8 * e, true);
    for (int e = tid; e < kQpRows * chunks; e += kThreads) {
      const int r = e / chunks, c8 = (e % chunks) * 8;
      tc::cp_async16(xn + r * ldx + c8, xln + (r < rows ? (size_t)(r0 + r) * c_in + c8 : 0),
                     r < rows);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
  }
  // this warp's 16 rows of xn as mma A fragments, for every k step
  uint32_t af[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    tc::ldsm_x4(af[ks], xn + (16 * warp + lane % 16) * ldx + ks * 16 + (lane / 16) * 8);
  __syncthreads();  // xn is free for the groups' q, k, v

  // attention of group grp: warps 0..3, head grp·2 + (w & 1) of query
  // tile w / 2 — 16 pooled queries (four windows of win 4, a block-
  // diagonal mask; one window of win 8) against that tile's 64 keys;
  // O_h to its columns of o
  auto attend_group = [&](int grp) {
    if (warp < 4) {
      const int hh = warp & 1, qt = warp / 2, col = hh * hd;
      const bf16* q = qp + 16 * qt * ldq + col;
      const bf16* k = kv + 64 * qt * ldkv + col;
      bf16* oh = o + 16 * qt * ldo + grp * gw + col;
      if (win == 4)
        attend16<NT, 4, 16>(q, ldq, k, k + gw, ldkv, 64, oh, ldo, scale);
      else
        attend16<NT>(q, ldq, k, k + gw, ldkv, 64, oh, ldo, scale);
    }
  };

  // the input-side products: each warpgroup its 64 rows × the tile's 32
  // columns on wgmma, A (the warps' xn fragments) from registers, B from
  // the swizzled tile, tile j + 2's copy issued while they run; skip and
  // q pooled in the accumulators, skip straight to the output rows
  for (int j = 0; j < n_in; ++j) {
    if (j > n_skip && (j - n_skip) % n_grp == 0) {
      __syncthreads();  // the previous group's q, k, v are complete
      attend_group((j - n_skip) / n_grp - 1);
    }
    tc::cp_async_wait<kQpStages - 2>();  // tile j has landed
    tc::fence_proxy_async();             // ... visible to wgmma
    __syncthreads();  // ... for every thread; tile j − 1's buffer, q, k, v are free

    const uint32_t stage = tc::smem_u32(ring + (j % kQpStages) * stage_bytes);
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)  // +32 bytes a step in a panel: +2 in the address field
      tc::wgmma_m64n32k16_rs(acc, af[ks],
                             tc::sw128_desc(stage + (ks / 4) * (kQpBN * 128)) + 2 * (ks % 4));
    tc::wgmma_commit();
    if (j + kQpStages - 1 < n_in) load_w(j + kQpStages - 1);
    tc::cp_async_commit();

    int grp, v0;
    tile_of(j, grp, v0);
    // the four 8-column units' parts and biases
    int part[4];
    float2 bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = v0 + 8 * i;  // the unit's first column: one part
      part[i] = u >= (grp < 0 ? c_out : 3 * gw) ? -1 : grp < 0 ? 0 : part_of(u);
      const bf16* bias = bias_s + (grp < 0 ? u : c_out + part[i] * (c_out - gw) + grp * gw + u);
      bb[i] = part[i] < 0 ? make_float2(0.f, 0.f)
                          : tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + t2));
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (part[i] < 0) continue;  // past the section's columns
      const float v[4] = {acc[4 * i] + bb[i].x, acc[4 * i + 1] + bb[i].y,
                          acc[4 * i + 2] + bb[i].x, acc[4 * i + 3] + bb[i].y};
      const int u = v0 + 8 * i, off = u - part[i] * gw;
      if (grp < 0) {  // skip = pool(bf16(xn·Wskipᵀ + b)), to the output rows
        pool_store(v, win, warp, ob + u + t2, c_out, out_rows);
      } else if (part[i] == 0) {  // q = pool(bf16(xn·Wqᵀ + b))
        pool_store(v, win, warp, qp + off + t2, ldq, kQpOut);
      } else {  // k, v = bf16(xn·Wkvᵀ + b)
        bf16* dst = kv + (part[i] - 1) * gw + off + t2;
        *reinterpret_cast<uint32_t*>(dst + (16 * warp + g) * ldkv) = tc::pack_bf16(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(dst + (16 * warp + g + 8) * ldkv) =
            tc::pack_bf16(v[2], v[3]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  attend_group(n_groups - 1);
  __syncthreads();  // o and the shortcut are complete; the weight tiles, q, k, v are free

  // the projection, 32 rows × c_out: warp w takes query rows 16·(w & 1)
  // and the 8-column units w / 2, w / 2 + 4, …, over depth c_out in
  // staged Wproj tiles (all c_out rows, 32 deep) over the weight ring
  const int units = c_out / 8, n_p = (c_out + kQpProjK - 1) / kQpProjK;
  const int prow = 16 * (warp & 1), pu = warp / 2;
  auto load_p = [&](int kt) {
    const int k0 = kt * kQpProjK;
    bf16* dst = pring + (kt % kQpStages) * c_out * ldp;
    for (int e = tid; e < c_out * (kQpProjK / 8); e += kThreads) {
      const int r = e / (kQpProjK / 8), c8 = (e % (kQpProjK / 8)) * 8;
      const bool in = k0 + c8 < c_out;
      tc::cp_async16(dst + r * ldp + c8, wproj + (in ? (size_t)r * c_out + k0 + c8 : 0), in);
    }
  };
  float pacc[kQpUnits][4];
#pragma unroll
  for (int i = 0; i < kQpUnits; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[i][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kQpStages - 1; ++s) {
    if (s < n_p) load_p(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_p; ++kt) {
    tc::cp_async_wait<kQpStages - 2>();
    __syncthreads();
    if (kt + kQpStages - 1 < n_p) load_p(kt + kQpStages - 1);
    tc::cp_async_commit();
    const bf16* wt = pring + (kt % kQpStages) * c_out * ldp;
    const int k0 = kt * kQpProjK;
#pragma unroll
    for (int ks = 0; ks < kQpProjK / 16; ++ks) {
      if (k0 + ks * 16 >= c_out) break;
      uint32_t a[4];
      tc::ldsm_x4(a, o + (prow + lane % 16) * ldo + k0 + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < kQpUnits; ++i) {
        const int u = pu + 4 * i;
        if (u >= units) break;
        uint32_t b[2];
        tc::ldsm_x2(b, wt + (8 * u + lane % 8) * ldp + ks * 16 + ((lane / 8) % 2) * 8);
        tc::mma_bf16(pacc[i], a, b[0], b[1]);
      }
    }
  }
  // out = bf16(skip + bf16(o·Wprojᵀ + b)), skip read back from the
  // output rows this block wrote
#pragma unroll
  for (int i = 0; i < kQpUnits; ++i) {
    const int col = 8 * (pu + 4 * i) + t2;
    if (col >= c_out) break;
    const float2 bb = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(bproj + col));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = prow + g + 8 * hr;
      if (row >= out_rows) continue;
      uint32_t* at = reinterpret_cast<uint32_t*>(ob + (size_t)row * c_out + col);
      const float2 pr = tc::unpack_bf16(
          tc::pack_bf16(pacc[i][2 * hr] + bb.x, pacc[i][2 * hr + 1] + bb.y));
      const float2 sv = tc::unpack_bf16(*at);
      *at = tc::pack_bf16(sv.x + pr.x, sv.y + pr.y);
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

template <int NT, int KS>
cudaError_t launch_qpool_tc(const void* xln, const void* wskip, const void* bskip,
                            const void* wqkv, const void* bqkv, const void* wproj,
                            const void* bproj, void* out, int rows_total, int win, int c_out,
                            int heads, cudaStream_t stream) {
  const size_t smem = qpool_tc_smem(16 * KS, c_out);
  cudaError_t err = cudaFuncSetAttribute(
      qpool_tc_kernel<NT, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  qpool_tc_kernel<NT, KS><<<(rows_total + kQpRows - 1) / kQpRows, kThreads, smem, stream>>>(
      (const bf16*)xln, (const bf16*)wskip, (const bf16*)bskip, (const bf16*)wqkv,
      (const bf16*)bqkv, (const bf16*)wproj, (const bf16*)bproj, (bf16*)out, rows_total, win,
      c_out, head_scale(c_out, heads));
  return cudaGetLastError();
}

// The head widths (NT) and input widths (KS = c_in / 16) the q-pool
// kernel is built for: Hiera-b+, -L and -t/-s heads; the t/s and L
// transitions' inputs.
template <int NT>
cudaError_t launch_qpool_depth(int c_in, const void* xn, const void* wskip, const void* bskip,
                               const void* wqkv, const void* bqkv, const void* wproj,
                               const void* bproj, void* out, int rows, int win, int c_out,
                               int heads, cudaStream_t stream) {
  auto run = [&](auto launch) {
    return launch(xn, wskip, bskip, wqkv, bqkv, wproj, bproj, out, rows, win, c_out, heads,
                  stream);
  };
  switch (c_in) {
    case 96: return run(launch_qpool_tc<NT, 6>);
    case 144: return run(launch_qpool_tc<NT, 9>);
    case 192: return run(launch_qpool_tc<NT, 12>);
    case 288: return run(launch_qpool_tc<NT, 18>);
    default: return cudaErrorInvalidValue;
  }
}

// The LN pre-pass (tc_gemm.cuh's ln_rows_kernel: xn = bf16(LN1(x))
// through layernorm_rows, 8 rows a block, into the workspace xn of
// n_win·win² × c_in), then the block kernel. win ∈ {4, 8}; c_in one of
// 96, 144, 192, 288; c_out a multiple of 16 up to 4 × kQpUnits × 8 =
// 576; an even number of heads (groups of two) of width 56, 72 or 96.
cudaError_t launch_qpool_bf16(const void* x, const void* ln_s, const void* ln_b,
                              const void* wskip, const void* bskip, const void* wqkv,
                              const void* bqkv, const void* wproj, const void* bproj, void* out,
                              void* xn, int n_win, int win, int c_in, int c_out, int heads,
                              float eps, cudaStream_t stream) {
  if ((win != 4 && win != 8) || n_win < 1 || c_out < 16 || c_out % 16 ||
      c_out > 4 * kQpUnits * 8 || heads < 2 || heads % 2 || c_out % heads)
    return cudaErrorInvalidValue;
  const int rows = n_win * win * win;
  cudaError_t err = tcg::launch_ln_rows((const bf16*)x, (const float*)ln_s, (const float*)ln_b,
                                        (bf16*)xn, rows, c_in, c_in, eps, stream);
  if (err != cudaSuccess) return err;
  auto run = [&](auto launch) {
    return launch(c_in, xn, wskip, bskip, wqkv, bqkv, wproj, bproj, out, rows, win, c_out, heads,
                  stream);
  };
  switch (c_out / heads) {
    case 56: return run(launch_qpool_depth<7>);
    case 72: return run(launch_qpool_depth<9>);
    case 96: return run(launch_qpool_depth<12>);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- float32
constexpr int kQpF32Unit = 64;  // input rows (keys) behind one 16-row pooled query tile

// Epilogue of the q-pool block's input GEMM (tf32.cuh) over [skip | q |
// k | v] (4·c_out columns): each 8-column tile lies in one section. Skip
// and q are pooled in the accumulators, the bias added first as the plain
// version adds it before its pool: an m16 tile of window-major rows holds
// whole pool partners at both window sizes — win 4: the 16 rows are one
// window, row 4i + j, the partners of row g rows g ^ 1 (lane ^ 4) and
// g ^ 4 (lane ^ 16); win 8: two window rows, the partners of row g row
// g ^ 1 (lane ^ 4) and the thread's own g + 8 — and its pooled rows are
// row0 / 4 + 0 .. 3. k and v are stored at full resolution.
struct PoolF32 {
  const float* bskip;
  const float* bqkv;
  float* skip;  // (rows / 4) × c_out
  float* q;     // (rows / 4) × c_out
  float* kv;    // rows × 2·c_out: k | v
  int c_out, win;
  static constexpr bool kFrag = true;
  __device__ void frag(int row0, int col, const float (&a)[4], int m, int n) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
    const int base = col - t2;  // the tile's first column, the same for the warp
    if (row0 >= m || base >= n) return;
    const int sec = base / c_out;
    const float2 b = *reinterpret_cast<const float2*>(sec == 0 ? bskip + col
                                                               : bqkv + (col - c_out));
    float v[4] = {a[0] + b.x, a[1] + b.y, a[2] + b.x, a[3] + b.y};
    if (sec >= 2) {  // k, v = xn·Wkvᵀ + b
      float* dst = kv + (col - 2 * c_out);
      const size_t ld = 2 * (size_t)c_out;
      *reinterpret_cast<float2*>(dst + (row0 + g) * ld) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(dst + (row0 + g + 8) * ld) = make_float2(v[2], v[3]);
      return;
    }
    float* dst = (sec == 0 ? skip + col : q + (col - c_out)) + (size_t)(row0 / 4) * c_out;
    if (win == 4) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float p0 = v[2 * hr], p1 = v[2 * hr + 1];
        p0 = fmaxf(p0, __shfl_xor_sync(0xffffffffu, p0, 4));
        p1 = fmaxf(p1, __shfl_xor_sync(0xffffffffu, p1, 4));
        p0 = fmaxf(p0, __shfl_xor_sync(0xffffffffu, p0, 16));
        p1 = fmaxf(p1, __shfl_xor_sync(0xffffffffu, p1, 16));
        if ((g & 5) == 0)  // g ∈ {0, 2}: pooled rows g / 2 and 2 + g / 2
          *reinterpret_cast<float2*>(dst + (size_t)(g / 2 + 2 * hr) * c_out) =
              make_float2(p0, p1);
      }
    } else {
      float p0 = fmaxf(v[0], v[2]), p1 = fmaxf(v[1], v[3]);
      p0 = fmaxf(p0, __shfl_xor_sync(0xffffffffu, p0, 4));
      p1 = fmaxf(p1, __shfl_xor_sync(0xffffffffu, p1, 4));
      if ((g & 1) == 0)  // even g: pooled row g / 2
        *reinterpret_cast<float2*>(dst + (size_t)(g / 2) * c_out) = make_float2(p0, p1);
    }
  }
};

// Epilogue of the window block's q|k|v GEMM: qkv = acc + bias.
struct BiasF32 {
  const float* bias;
  float* out;
  int n_cols;
  static constexpr bool kFrag = false;
  __device__ void one(int r, int c, float v) const {
    out[(size_t)r * n_cols + c] = v + bias[c];
  }
  __device__ void two(int r, int c, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    *reinterpret_cast<float2*>(out + (size_t)r * n_cols + c) = make_float2(v0 + b.x, v1 + b.y);
  }
  bool aligned8() const { return tf32::aligned8(bias) && tf32::aligned8(out); }
};

// Epilogue of the projection: out = skip + (acc + bias), the plain
// version's order; two() as in mlp_block.cu's epilogues. The window
// block's skip is its input x.
struct ProjF32 {
  const float* bias;
  const float* skip;
  float* out;
  int n_cols;
  static constexpr bool kFrag = false;
  __device__ void one(int r, int c, float v) const {
    const size_t at = (size_t)r * n_cols + c;
    out[at] = skip[at] + (v + bias[c]);
  }
  __device__ void two(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * n_cols + c;
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    const float2 s = *reinterpret_cast<const float2*>(skip + at);
    *reinterpret_cast<float2*>(out + at) = make_float2(s.x + (v0 + b.x), s.y + (v1 + b.y));
  }
  bool aligned8() const {
    return tf32::aligned8(bias) && tf32::aligned8(skip) && tf32::aligned8(out);
  }
};

// Attention of the q-pool block in float32, 3×TF32: one block of four
// warps per (unit, head), a unit the 16 pooled query rows 16u .. 16u + 15
// against the 64 key rows 64u .. 64u + 63 (one window of win 8; four of
// win 4 under a block-diagonal mask, query row r seeing keys j with r / 4
// == j / 16). q (out_rows × c_out), kv (rows × 2·c_out: k | v), o
// (out_rows × c_out); head h's columns h·hd .. of each. The head's k and
// v come into shared memory by cp.async, v while S is computed, and its q
// fragments from L2 straight into registers (rows past the last window
// zero, never stored); warp w takes keys 16w .. 16w + 15 of S = q·kᵀ, the
// row max and sum go through shared memory, P (normalised in f32, as
// the plain version computes it) is stored over k, and warp w takes the
// 8-column tiles w, w + 4, w + 8 of O = P·V. 52 KB at head width 96, so
// four blocks share an SM. Row strides keep ldmatrix rows in distinct
// bank groups (≡ 4 mod 32 floats) and V's scalar fragment loads
// conflict-free (≡ 8 mod 32). NT: the head width in 8-column tiles.
template <int NT>
struct QpAttnF32 {
  static constexpr int hd = 8 * NT;
  static constexpr int ldk = hd + (36 - hd % 32) % 32;
  static constexpr int ldv = hd + (40 - hd % 32) % 32;
  static constexpr int ldp = kQpF32Unit + 4;  // P, over k once S is done
  static_assert(16 * ldp <= kQpF32Unit * ldk, "P fits over k");
  static constexpr int kFloats = kQpF32Unit * (ldk + ldv) + 2 * 4 * 16;
  static constexpr size_t smem() { return sizeof(float) * kFloats; }
};

template <int NT>
__global__ void __launch_bounds__(128)
qpool_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                      float* __restrict__ o, int rows, int heads, int c_out, int win,
                      float scale) {
  using L = QpAttnF32<NT>;
  constexpr int hd = L::hd, ldk = L::ldk, ldv = L::ldv, ldp = L::ldp, chunks = hd / 4;
  extern __shared__ __align__(16) float asm_f[];
  float* sk = asm_f;                        // 64 × ldk
  float* sp = sk;                           // 16 × ldp: P, once S is done
  float* sv = sk + kQpF32Unit * ldk;        // 64 × ldv
  float* red_max = sv + kQpF32Unit * ldv;   // 4 warps × 16 rows
  float* red_sum = red_max + 4 * 16;
  const int u = blockIdx.x / heads, h = blockIdx.x % heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int out_rows = rows / 4, qr = 16 * u, kr = kQpF32Unit * u;
  const size_t ldkv = 2 * (size_t)c_out;
  const bool q0 = qr + g < out_rows, q1 = qr + g + 8 < out_rows;
  float qa[NT][4];  // q's A fragments: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  {
    const float* kb = kv + kr * ldkv + h * hd;
    for (int e = tid; e < kQpF32Unit * chunks; e += 128) {
      const int r = e / chunks, c = 4 * (e % chunks);
      const bool in = kr + r < rows;
      tc::cp_async16(sk + r * ldk + c, in ? kb + r * ldkv + c : kv, in);
    }
    tc::cp_async_commit();
    for (int e = tid; e < kQpF32Unit * chunks; e += 128) {  // v lands while S is computed
      const int r = e / chunks, c = 4 * (e % chunks);
      const bool in = kr + r < rows;
      tc::cp_async16(sv + r * ldv + c, in ? kb + r * ldkv + c_out + c : kv, in);
    }
    tc::cp_async_commit();
    const float* qb = q + (size_t)(qr + g) * c_out + h * hd + t;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      qa[ks][0] = q0 ? __ldg(qb + 8 * ks) : 0.f;
      qa[ks][1] = q1 ? __ldg(qb + 8 * c_out + 8 * ks) : 0.f;
      qa[ks][2] = q0 ? __ldg(qb + 8 * ks + 4) : 0.f;
      qa[ks][3] = q1 ? __ldg(qb + 8 * c_out + 8 * ks + 4) : 0.f;
    }
    tc::cp_async_wait<1>();
    __syncthreads();
  }

  // S for keys 16w + 8j + 2t + (e & 1), rows g (e < 2) and g + 8
  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    uint32_t r[4], ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32::split(qa[ks][e], ah[e], al[e]);
    tc::ldsm_x4(r, sk + (16 * warp + lane % 8 + (lane / 16) * 8) * ldk + 8 * ks +
                       ((lane / 8) % 2) * 4);
    uint32_t bh[4], bl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32::split(__uint_as_float(r[e]), bh[e], bl[e]);
    tf32::mma3(s[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
    tf32::mma3(s[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
  }
  // the exact softmax in f32: scale, mask, max and sum over the quad and
  // the four warps
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      if (win == 4 && (g + 8 * (e >> 1)) / 4 != (16 * warp + 8 * j + 2 * t + (e & 1)) / 16)
        s[j][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (t == 0) red_max[16 * warp + g + 8 * r] = mx[r];
  }
  __syncthreads();  // ... and every warp's S is done: k is free for P
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(red_max[g + 8 * r], red_max[16 + g + 8 * r]),
                  fmaxf(red_max[32 + g + 8 * r], red_max[48 + g + 8 * r]));
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    if (t == 0) red_sum[16 * warp + g + 8 * r] = sum[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r)
    sum[r] = (red_sum[g + 8 * r] + red_sum[16 + g + 8 * r]) +
             (red_sum[32 + g + 8 * r] + red_sum[48 + g + 8 * r]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* pr = sp + g * ldp + 16 * warp + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(pr) = make_float2(s[j][0] / sum[0], s[j][1] / sum[0]);
    *reinterpret_cast<float2*>(pr + 8 * ldp) = make_float2(s[j][2] / sum[1], s[j][3] / sum[1]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // O = P·V over the 64 keys in 8-deep steps, 8-column tiles warp + 4i
  constexpr int kTiles = (NT + 3) / 4;
  float acc[kTiles][4] = {};
#pragma unroll
  for (int kk = 0; kk < kQpF32Unit / 8; ++kk) {
    uint32_t r[4], ah[4], al[4];
    tc::ldsm_x4(r, sp + (lane % 16) * ldp + 8 * kk + (lane / 16) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32::split(__uint_as_float(r[e]), ah[e], al[e]);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int d = warp + 4 * i;
      if (d >= NT) break;
      const float* vv = sv + (8 * kk + t) * ldv + 8 * d + g;
      uint32_t bh0, bl0, bh1, bl1;
      tf32::split(vv[0], bh0, bl0);
      tf32::split(vv[4 * ldv], bh1, bl1);
      tf32::mma3(acc[i], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  float* ob = o + (size_t)qr * c_out + h * hd + 2 * t;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int d = warp + 4 * i;
    if (d >= NT) break;
    if (q0) *reinterpret_cast<float2*>(ob + (size_t)g * c_out + 8 * d) =
        make_float2(acc[i][0], acc[i][1]);
    if (q1) *reinterpret_cast<float2*>(ob + (size_t)(g + 8) * c_out + 8 * d) =
        make_float2(acc[i][2], acc[i][3]);
  }
}

// The float32 q-pool block: LN pre-pass, input GEMM with the pooling
// epilogue, attention, projection (see the header). ws holds, in float32
// and in this order: xn (rows × c_in), pooled skip and pooled q (rows/4 ×
// c_out each), k | v (rows × 2·c_out), o (rows/4 × c_out) and the
// projection's partial sums (splits_proj · rows/4 × c_out) where its
// depth is split. win ∈ {4, 8}; c_in a multiple of 4, every pointer
// 16-byte aligned; head width 56, 72 or 96. splits_proj from the
// wrapper's plan (ops/cuda/window_attn.py qpool_plan_f32).
cudaError_t launch_qpool_f32(const float* x, const float* ln_s, const float* ln_b,
                             const float* wskip, const float* bskip, const float* wqkv,
                             const float* bqkv, const float* wproj, const float* bproj,
                             float* out, float* ws, int n_win, int win, int c_in, int c_out,
                             int heads, float eps, int splits_proj, cudaStream_t stream) {
  if ((win != 4 && win != 8) || n_win < 1 || c_in < 4 || c_in % 4 || heads < 1 ||
      c_out % heads)
    return cudaErrorInvalidValue;
  const int rows = n_win * win * win, out_rows = rows / 4;
  float* xn = ws;
  float* skip = xn + (size_t)rows * c_in;
  float* qp = skip + (size_t)out_rows * c_out;
  float* kvp = qp + (size_t)out_rows * c_out;
  float* o = kvp + (size_t)rows * 2 * c_out;
  float* partial = o + (size_t)out_rows * c_out;
  cudaError_t err = tf32::launch_ln_rows(x, ln_s, ln_b, xn, rows, c_in, eps, stream);
  if (err != cudaSuccess) return err;
  auto attend = [&](auto kernel, size_t smem) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int blocks = (rows + kQpF32Unit - 1) / kQpF32Unit * heads;
    kernel<<<blocks, 128, smem, stream>>>(qp, kvp, o, rows, heads, c_out, win,
                                          head_scale(c_out, heads));
    return cudaGetLastError();
  };
  const int hd = c_out / heads;
  if (hd != 56 && hd != 72 && hd != 96) return cudaErrorInvalidValue;  // Hiera-b+, -L, -t/-s
  err = tf32::launch_gemm(1, xn, wskip, wqkv, c_out, rows, 4 * c_out, c_in, nullptr,
                          PoolF32{bskip, bqkv, skip, qp, kvp, c_out, win}, stream);
  if (err != cudaSuccess) return err;
  err = hd == 56   ? attend(qpool_attn_f32_kernel<7>, QpAttnF32<7>::smem())
        : hd == 72 ? attend(qpool_attn_f32_kernel<9>, QpAttnF32<9>::smem())
                   : attend(qpool_attn_f32_kernel<12>, QpAttnF32<12>::smem());
  if (err != cudaSuccess) return err;
  return tf32::launch_gemm(splits_proj, o, wproj, wproj, c_out, out_rows, c_out, c_out,
                           partial, ProjF32{bproj, skip, out, c_out}, stream);
}

constexpr int kWinF32Rows = 64;  // rows of one window-attention block: 64 / t windows, 16 a warp

// Attention of the window block in float32, 3×TF32: one block of four
// warps per (64 rows, head), warp w the 16 query rows 16w .. 16w + 15
// against only its own window's t keys (t ∈ {16, 32, 64}; a 64-row block
// holds whole windows). qkv (rows × 3c: q | k | v), o (rows × c); head
// h's columns h·hd .. of each section. The head's k and v for the block's
// rows come into shared memory by cp.async, v while S is computed, and
// the warp's q fragments from L2 straight into registers. S = q·kᵀ in the
// accumulators (keys 8n + 2t' + (e & 1) of tile n for lane 4g + t'), the
// exact softmax over the quad — f32 scores × scale, max, exp, sum — and P
// normalised in f32 as the plain version computes it; then O = P·V with
// P's accumulators as the A fragments as they stand: the k slots t' and
// t' + 4 of an 8-deep step are taken as keys 2t' and 2t' + 1, so V's
// rows are read in that order and P never goes through shared memory.
// Rows past the last window (a ragged last block) are zero in shared
// memory and never computed or stored. k and v rows at a stride ≡ 4 (mod
// 32) floats: ldmatrix's eight rows fall in distinct bank groups, and V's
// scalar reads (rows 2t', 2t' + 1, column g) in distinct banks. 51,200
// bytes at head width 96 or 72, so four blocks share an SM. NT: the head
// width in 8-column tiles.
template <int NT>
struct WinAttnF32 {
  static constexpr int hd = 8 * NT;
  static constexpr int ld = hd + (36 - hd % 32) % 32;
  static constexpr size_t smem() { return sizeof(float) * 2 * kWinF32Rows * ld; }
};

template <int NT>
__global__ void __launch_bounds__(128)
window_attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ o, int rows, int t,
                       int heads, int c, float scale) {
  using L = WinAttnF32<NT>;
  constexpr int hd = L::hd, ld = L::ld, chunks = hd / 4;
  extern __shared__ __align__(16) float wsm_f[];
  float* sk = wsm_f;                   // 64 × ld
  float* sv = sk + kWinF32Rows * ld;   // 64 × ld
  const int u = blockIdx.x / heads, h = blockIdx.x % heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int r0 = kWinF32Rows * u, qr = 16 * warp;
  const size_t ldq = 3 * (size_t)c;
  const bool live = r0 + qr < rows;  // whole slabs: rows is a multiple of t ≥ 16
  const int key0 = qr / t * t;       // the slab's window's first row in the block
  float qa[NT][4];  // q's A fragments: (g, t'), (g + 8, t'), (g, t' + 4), (g + 8, t' + 4)
  {
    const float* kb = qkv + (size_t)r0 * ldq + c + h * hd;
    for (int e = tid; e < kWinF32Rows * chunks; e += 128) {
      const int r = e / chunks, cc = 4 * (e % chunks);
      const bool in = r0 + r < rows;
      tc::cp_async16(sk + r * ld + cc, in ? kb + r * ldq + cc : qkv, in);
    }
    tc::cp_async_commit();
    for (int e = tid; e < kWinF32Rows * chunks; e += 128) {  // v lands while S is computed
      const int r = e / chunks, cc = 4 * (e % chunks);
      const bool in = r0 + r < rows;
      tc::cp_async16(sv + r * ld + cc, in ? kb + r * ldq + c + cc : qkv, in);
    }
    tc::cp_async_commit();
    const float* qb = qkv + (size_t)(r0 + qr + g) * ldq + h * hd + tq;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      qa[ks][0] = live ? __ldg(qb + 8 * ks) : 0.f;
      qa[ks][1] = live ? __ldg(qb + 8 * ldq + 8 * ks) : 0.f;
      qa[ks][2] = live ? __ldg(qb + 8 * ks + 4) : 0.f;
      qa[ks][3] = live ? __ldg(qb + 8 * ldq + 8 * ks + 4) : 0.f;
    }
    tc::cp_async_wait<1>();
    __syncthreads();
  }

  // S over the window's t keys, 16 an ldmatrix
  float s[8][4] = {};
  if (live) {
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split(qa[ks][e], ah[e], al[e]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (16 * jj >= t) break;
        uint32_t r[4], bh[4], bl[4];
        tc::ldsm_x4(r, sk + (key0 + 16 * jj + lane % 8 + (lane / 16) * 8) * ld + 8 * ks +
                           ((lane / 8) % 2) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32::split(__uint_as_float(r[e]), bh[e], bl[e]);
        tf32::mma3(s[2 * jj], ah, al, bh[0], bh[1], bl[0], bl[1]);
        tf32::mma3(s[2 * jj + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
    // the exact softmax in f32: rows g (e < 2) and g + 8, the four lanes
    // of a quad holding a row's keys
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (8 * n < t)
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
      if (8 * n < t)
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
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] /= sum[e >> 1];
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // v has landed
  if (!live) return;

  // O = P·V in 8-deep steps over the keys: P's accumulators as A (slot t'
  // ↔ key 2t', slot t' + 4 ↔ key 2t' + 1), V's rows in the same order
  float acc[NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (8 * kk >= t) break;
    uint32_t ah[4], al[4];
    tf32::split(s[kk][0], ah[0], al[0]);
    tf32::split(s[kk][2], ah[1], al[1]);
    tf32::split(s[kk][1], ah[2], al[2]);
    tf32::split(s[kk][3], ah[3], al[3]);
    const float* vr = sv + (key0 + 8 * kk + 2 * tq) * ld + g;
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      uint32_t bh0, bl0, bh1, bl1;
      tf32::split(vr[8 * d], bh0, bl0);
      tf32::split(vr[ld + 8 * d], bh1, bl1);
      tf32::mma3(acc[d], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  float* ob = o + (size_t)(r0 + qr + g) * c + h * hd + 2 * tq;
#pragma unroll
  for (int d = 0; d < NT; ++d) {
    *reinterpret_cast<float2*>(ob + 8 * d) = make_float2(acc[d][0], acc[d][1]);
    *reinterpret_cast<float2*>(ob + 8 * (size_t)c + 8 * d) = make_float2(acc[d][2], acc[d][3]);
  }
}

// The float32 window block: LN pre-pass, q|k|v GEMM with its bias,
// attention, projection with the residual (see the header). ws holds, in
// float32 and in this order: xn (rows × c), q | k | v (rows × 3c), o (rows
// × c) and the GEMMs' partial sums where a depth is split (the larger of
// splits_qkv · rows × 3c and splits_proj · rows × c; the two GEMMs run
// one after the other). t ∈ {16, 32, 64}; head width 56, 72 or 96 (so c
// a multiple of 8). splits_qkv and splits_proj from the wrapper's plan
// (ops/cuda/window_attn.py window_plan_f32).
cudaError_t launch_window_f32(const float* x, const float* ln_s, const float* ln_b,
                              const float* wqkv, const float* bqkv, const float* wproj,
                              const float* bproj, float* out, float* ws, int n_win, int t, int c,
                              int heads, float eps, int splits_qkv, int splits_proj,
                              cudaStream_t stream) {
  if ((t != 16 && t != 32 && t != 64) || n_win < 1 || heads < 1 || c < heads || c % heads)
    return cudaErrorInvalidValue;
  const int hd = c / heads;
  if (hd != 56 && hd != 72 && hd != 96) return cudaErrorInvalidValue;  // Hiera-b+, -L, -t/-s
  const int rows = n_win * t;
  float* xn = ws;
  float* qkv = xn + (size_t)rows * c;
  float* o = qkv + (size_t)rows * 3 * c;
  float* partial = o + (size_t)rows * c;
  cudaError_t err = tf32::launch_ln_rows(x, ln_s, ln_b, xn, rows, c, eps, stream);
  if (err != cudaSuccess) return err;
  err = tf32::launch_gemm(splits_qkv, xn, wqkv, wqkv, 3 * c, rows, 3 * c, c, partial,
                          BiasF32{bqkv, qkv, 3 * c}, stream);
  if (err != cudaSuccess) return err;
  auto attend = [&](auto kernel, size_t smem) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int blocks = (rows + kWinF32Rows - 1) / kWinF32Rows * heads;
    kernel<<<blocks, 128, smem, stream>>>(qkv, o, rows, t, heads, c, head_scale(c, heads));
    return cudaGetLastError();
  };
  err = hd == 56   ? attend(window_attn_f32_kernel<7>, WinAttnF32<7>::smem())
        : hd == 72 ? attend(window_attn_f32_kernel<9>, WinAttnF32<9>::smem())
                   : attend(window_attn_f32_kernel<12>, WinAttnF32<12>::smem());
  if (err != cudaSuccess) return err;
  return tf32::launch_gemm(splits_proj, o, wproj, wproj, c, rows, c, c, partial,
                           ProjF32{bproj, x, out, c}, stream);
}

}  // namespace

// Shared-memory bytes a launch needs (the wrappers refuse shapes above
// the 227 KB a block can hold). The float32 window block's largest block
// is its GEMM's, whatever the shape (its attention blocks take less,
// below).
extern "C" long long cv_window_attn_smem(int t, int c, int dtype) {
  return (long long)(dtype == 1 ? window_tc_smem(c) : tf32::kGemmSmem);
}
// Shared-memory bytes of the float32 window block's attention block at
// head width hd (56, 72 or 96; 0 for any other).
extern "C" long long cv_window_f32_attn_smem(int hd) {
  return (long long)(hd == 56 ? WinAttnF32<7>::smem()
                     : hd == 72 ? WinAttnF32<9>::smem()
                     : hd == 96 ? WinAttnF32<12>::smem() : 0);
}
// The float32 q-pool's largest block is its GEMM's, whatever the shape
// (its attention blocks take less, below).
extern "C" long long cv_qpool_attn_smem(int win, int c_in, int c_out, int dtype) {
  return (long long)(dtype == 1 ? qpool_tc_smem(c_in, c_out) : tf32::kGemmSmem);
}
// Shared-memory bytes of the float32 q-pool's attention block at head
// width hd (56, 72 or 96; 0 for any other).
extern "C" long long cv_qpool_f32_attn_smem(int hd) {
  return (long long)(hd == 56 ? QpAttnF32<7>::smem()
                     : hd == 72 ? QpAttnF32<9>::smem()
                     : hd == 96 ? QpAttnF32<12>::smem() : 0);
}

// x is (n_win, t, c); weights in torch Linear layout: wqkv (3c, c), wproj
// (c, c); ln_s and ln_b float32 for either dtype (here and in
// cv_qpool_attn_*). float32 on the tensor cores (3×TF32,
// launch_window_f32: its shapes, the workspace ws and the plan).
extern "C" int cv_window_attn_f32(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  const void* bproj, void* out, void* ws, int n_win, int t, int c,
                                  int heads, float eps, int splits_qkv, int splits_proj,
                                  void* stream) {
  return (int)launch_window_f32((const float*)x, (const float*)ln_s, (const float*)ln_b,
                                (const float*)wqkv, (const float*)bqkv, (const float*)wproj,
                                (const float*)bproj, (float*)out, (float*)ws, n_win, t, c, heads,
                                eps, splits_qkv, splits_proj, (cudaStream_t)stream);
}

// bfloat16 on the tensor cores (window_tc_kernel; t ∈ {16, 32, 64}, c a
// multiple of 16, head width 56, 72 or 96, every bf16 pointer 16-byte
// aligned): the same function and layouts.
extern "C" int cv_window_attn_bf16(const void* x, const void* ln_s, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* wproj,
                                   const void* bproj, void* out, int n_win, int t, int c,
                                   int heads, float eps, void* stream) {
  return (int)launch_window_bf16(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, out, n_win, t, c,
                                 heads, eps, (cudaStream_t)stream);
}

// x is (n_win·win², c_in) window-major rows; out (n_win·win²/4, c_out).
// wskip (c_out, c_in), wqkv (3·c_out, c_in), wproj (c_out, c_out); ln_s
// and ln_b float32. float32 on the tensor cores (3×TF32,
// launch_qpool_f32: its shapes, the workspace ws and the plan).
extern "C" int cv_qpool_attn_f32(const void* x, const void* ln_s, const void* ln_b,
                                 const void* wskip, const void* bskip, const void* wqkv,
                                 const void* bqkv, const void* wproj, const void* bproj,
                                 void* out, void* ws, int n_win, int win, int c_in, int c_out,
                                 int heads, float eps, int splits_proj, void* stream) {
  return (int)launch_qpool_f32((const float*)x, (const float*)ln_s, (const float*)ln_b,
                               (const float*)wskip, (const float*)bskip, (const float*)wqkv,
                               (const float*)bqkv, (const float*)wproj, (const float*)bproj,
                               (float*)out, (float*)ws, n_win, win, c_in, c_out, heads, eps,
                               splits_proj, (cudaStream_t)stream);
}

// bfloat16 on the tensor cores: the same function and layouts, the
// shapes launch_qpool_bf16 takes, every bf16 pointer 16-byte aligned; xn
// a bf16 workspace of n_win·win² × c_in for the LN pre-pass.
extern "C" int cv_qpool_attn_bf16(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wskip, const void* bskip, const void* wqkv,
                                  const void* bqkv, const void* wproj, const void* bproj,
                                  void* out, void* xn, int n_win, int win, int c_in, int c_out,
                                  int heads, float eps, void* stream) {
  return (int)launch_qpool_bf16(x, ln_s, ln_b, wskip, bskip, wqkv, bqkv, wproj, bproj, out, xn,
                                n_win, win, c_in, c_out, heads, eps, (cudaStream_t)stream);
}
