// A block of anchor rows against a set of candidates, for Hopper (sm_90a):
// the row-block logsumexp of CrossCLR and its two backward kernels, with a
// plain C interface.
//
// Replaces the TPU kernels of crossclr_tpu/ops/fused_global.py:
//   crossclr_rows_lse       <- _rows_lse_kernel       (per-row lse)
//   crossclr_rows_bwd_rows  <- _rows_bwd_rows_kernel  (d anchor_rows, and the
//                                                      per-row Σ p⊙z of dτ)
//   crossclr_rows_bwd_cols  <- _rows_bwd_cols_kernel  (d other_all,
//                                                      d anchor_all)
//
// The math, for L2-normalized anchor rows A_r [bl, d] that are rows
// off .. off + bl of the candidates' batch, candidates A, O [n, d], scale
// s = 1/τ and weight w: with z_inter[r, j] = s·a_r·o_j and z_intra[r, j] =
// w·s·a_r·a_j,
//   lse[r] = log( Σ_j exp(z_inter[r, j]) + Σ_j exp(z_intra[r, j]) ).
// Unpruned (the released loss): the intra logit of j = off + r is ZEROED
// (exp(0) = 1 stays in the sum).  Pruned (keep masks ki, ka [n] given): an
// inter column is kept where ki[j] | on_diag, an intra column where
// ka[j] & ~on_diag; an excluded logit is kMasked = -1e9.  Every row keeps
// its positive, so once a real logit has been seen the masked terms are
// exp(-1e9 - m) = 0 in whatever order the tiles come: a thread whose own
// columns are all masked holds a bogus partial (m = -1e9, l = its count)
// that the rescale exp(-1e9 - m_real) wipes when the row's partials are
// combined.  The running max starts at -1e30, BELOW kMasked, so it floors
// nothing a real or masked logit could reach (a floor above -1e9 would
// corrupt rows whose kept logits all lie below it, at extreme 1/τ).
// Given the cotangent g of lse, p = g_r·exp(z_inter - lse_r) and
// q = g_r·exp(z_intra - lse_r) (0 where the intra logit is zeroed or
// excluded; an excluded inter logit gives exactly 0 through the exp):
//   d A_r = s·(p·O + w·q·A),   d O = s·pᵀ·A_r,   d A = s·w·qᵀ·A_r,
//   ds_rows[r] = Σ_j (p⊙z_inter + q⊙z_intra)[r, j] = s · d lse_r / d s
// (an excluded logit adds 0 · -1e9 = -0, never NaN).
//
// Design: owner-computes, in the style of fused_dual.cu.  The TPU kernels
// run a sequential candidate axis j (rows kernels) or anchor axis i (the
// columns kernel) of the grid and carry m, l and the gradient sums across
// it in VMEM scratch; blocks on this card run in parallel in no order, so
// that axis becomes a loop inside the block:
//   rows_lse, rows_bwd_rows: a block owns 64 anchor rows and loops over
//     64-candidate tiles of O and of A;
//   rows_bwd_cols: a block owns 64 candidates of ONE array (O and d O, or A
//     and d A) and loops over 64-row anchor tiles.
// Every output element is written by one block and every sum has a fixed
// order (the per-row partials combine by warp shuffles in a fixed
// pattern, a split's parts in index order), so there are no atomics and
// runs are bit-reproducible.  The TPU workarounds are gone: no lane padding
// of d, no tile picking (edges of bl, n and d are masked here), the row
// offset is an int (not an fp32 SMEM scalar), and the columns kernel takes
// lse and g as they are (no pre-transposed (1, TB) vectors or [TC, 1]
// masks).  The row offset puts each anchor row's own column anywhere in a
// candidate tile (across two tiles for one block where off % 64 != 0), so
// every kernel tests it per element.
//
// The bf16 builds (the `default` tier every leg runs) are tensor-core
// kernels built from loss_mma.cuh's blocks: mma.sync m16n8k16 logits from
// bf16 operands, staged by 16-byte cp.async into double buffers, each
// 16-feature step and 64-row tile a short chain added in fp32.  Their grids
// have only ceil(bl/64) blocks per row direction at the training slice's
// bl = 1024, so each splits its walked tiles over blockIdx.z into the parts
// split_parts picks from the SM count and occupancy; each part writes fp32
// partials to a scratch buffer whose size a crossclr_rows_*_scratch query
// names, and a second kernel combines them in index order.
//   * rows_lse_bf16_kernel: the dual forward's online-logsumexp block in
//     its rows form (log2 units, the anchor fragments in registers where d
//     fits one 256-feature chunk, both anchor chunks resident to d = 512);
//     each part writes (m, l) per row and rows_lse_merge_kernel merges
//     them.  8 parts at bl = n = 1024, d = 384.  It issues the two logit
//     products of 2·bl·n·d where the bound counts 1.5 at bl = n.
//   * rows_bwd_rows_bf16_kernel: the anchor-gradient block in its rows form
//     (coefficients g_r·exp(z - lse_r) in fp32 registers; hi + lo bf16
//     coefficient fragments times the candidate tile into fp32 register
//     accumulators), one block per (64 anchor rows, 256-feature chunk of
//     the gradient), the parts' rows and Σ coef⊙z per row added by
//     rows_sum_kernel.  4 parts at bl = n = 1024, d = 384.
//   * rows_bwd_cols_bf16_kernel: the same block in its cols form (the
//     rows form transposed: the block's 64 candidates of one array against
//     the walked anchor tiles, the anchor tile read by ldmatrix.trans for
//     the gradient product), one block per (64 candidates, array,
//     256-feature chunk), the parts' rows added by cols_sum_kernel.  2
//     parts at bl = n = 1024, d = 384.
//   Each backward issues 6 products of 2·bl·n·d (the two logit products and
//   the two coefficient products in two bf16 parts each) where the bound
//   counts 3.5 at bl = n; at d > 256 each 256-feature chunk recomputes the
//   logits.
// The fp32 builds (the `highest` tier) are scalar kernels: the logit tiles
// are 64 x 64 products over d, staged through shared memory in 32-feature
// chunks; 256 threads own a 4 x 4 micro tile each.  A backward block keeps
// its gradient rows [64, <=512 features] in shared memory and adds
// coefficient-tile x operand-tile products into them; wider features split
// over blockIdx.z, each z recomputing the logits.  What bounds them: scalar
// fp32 FMAs issued from shared memory, on ceil(bl/64) blocks (x 2 for the
// columns kernel's two arrays).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "loss_mma.cuh"

namespace {

using namespace loss_mma;

constexpr int kTile = 64;         // rows per block = rows per loop tile
constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 micro tile each
constexpr int kChunk = 32;        // features per staged chunk of a logit product
constexpr int kLd = kTile + 4;    // padded row stride, float4-aligned
constexpr int kOutChunk = 512;    // gradient features one backward block owns

// ---------------------------------------------------------------------------
// the fp32 builds: scalar kernels
// ---------------------------------------------------------------------------

// s[k][r] = x[r0 + r][k0 + k] for a 64-row x 32-feature chunk of x [n, d],
// 0 outside.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ x, int r0,
                                            int k0, int n, int d, float* s) {
  for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
    const int r = i / kChunk, k = i - r * kChunk;
    const int row = r0 + r, col = k0 + k;
    s[k * kLd + r] = (row < n && col < d) ? x[(size_t)row * d + col] : 0.f;
  }
}

// acc[i][j] = <x[x0 + 4ty + i], y[y0 + 4tx + j]> over all d features, for
// x [nx, d] and y [ny, d]; rows past nx or ny give 0.
__device__ void tile_dot(const float* __restrict__ x, int x0, int nx,
                         const float* __restrict__ y, int y0, int ny, int d,
                         float* sx, float* sy, float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();  // the previous readers of sx, sy are done
    stage_chunk(x, x0, k0, nx, d, sx);
    stage_chunk(y, y0, k0, ny, d, sy);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sx + k * kLd + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(sy + k * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Whether candidate `col` of anchor row `grow` (global index) counts, and
// for the unpruned intra block whether its logit is the zeroed self one.
template <bool kPruned>
__device__ __forceinline__ bool kept(bool intra, int grow, int col,
                                     const unsigned char* __restrict__ ki,
                                     const unsigned char* __restrict__ ka) {
  const bool diag = grow == col;
  if constexpr (kPruned)
    return intra ? (ka[col] != 0 && !diag) : (ki[col] != 0 || diag);
  return true;
}

// the lse of a 64-row anchor tile
template <bool kPruned>
__global__ void __launch_bounds__(kThreads)
rows_lse_kernel(const float* __restrict__ ar, const float* __restrict__ aa,
                const float* __restrict__ oa, const unsigned char* __restrict__ ki,
                const unsigned char* __restrict__ ka,
                const float* __restrict__ scale_ptr, float w,
                float* __restrict__ lse, int bl, int n, int d, int off) {
  __shared__ __align__(16) float sx[kChunk * kLd];
  __shared__ __align__(16) float sy[kChunk * kLd];
  const float s = *scale_ptr;
  const int r0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegFloor;
    l[i] = 0.f;
  }
  float acc[4][4];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    for (int part = 0; part < 2; ++part) {
      const bool intra = part == 1;
      tile_dot(ar, r0, bl, intra ? aa : oa, c0, n, d, sx, sy, acc);
      const float zs = intra ? w * s : s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int grow = off + r0 + 4 * ty + i;
        float z[4];
        bool ok[4];
        float tmax = kNegFloor;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + 4 * tx + j;
          ok[j] = col < n;
          z[j] = zs * acc[i][j];
          if (ok[j]) {
            if (!kept<kPruned>(intra, grow, col, ki, ka)) z[j] = kMasked;
            // the zeroed (not dropped) self logit of the released loss
            if (!kPruned && intra && grow == col) z[j] = 0.f;
            tmax = fmaxf(tmax, z[j]);
          }
        }
        const float mn = fmaxf(m[i], tmax);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ok[j]) add += expf(z[j] - mn);
        l[i] = l[i] * expf(m[i] - mn) + add;
        m[i] = mn;
      }
    }
  }
  // a row's 16 partials live on 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int sh = 8; sh > 0; sh >>= 1) {
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], sh);
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], sh);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
    }
    const int row = r0 + 4 * ty + i;
    if (tx == 0 && row < bl) lse[row] = m[i] + logf(l[i]);
  }
}

// sout[i][f] += Σ_c sc[i][c] · x[x0 + c][d0 + f] for f < dc, x [nx, d].
// `so` is a [kTile][kLd] staging area (it aliases the logit chunks sx, sy).
__device__ void add_product(const float* sc, const float* __restrict__ x, int x0,
                            int nx, int d, int d0, int dc, float* so,
                            float* sout, int ldo) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int f0 = 0; f0 < dc; f0 += kTile) {
    __syncthreads();  // sc is written; the previous readers of so are done
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int c = i / kTile, f = i - c * kTile;
      const int row = x0 + c;
      so[c * kLd + f] = (row < nx && f0 + f < dc)
                            ? x[(size_t)row * d + d0 + f0 + f]
                            : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(so + c * kLd + 4 * tx);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = sc[(4 * ty + i) * kLd + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + 4 * tx + j;
        if (f < dc) sout[(4 * ty + i) * ldo + f] += acc[i][j];
      }
  }
}

__host__ __device__ __forceinline__ int out_ld(int dc) {
  return (dc + kTile - 1) / kTile * kTile + 4;
}

// The shared memory of a backward block: the logit chunks sx, sy (together
// one [kTile][kLd] staging area for add_product), the coefficient tile sc,
// two [kTile] vectors of factors and the gradient rows sout.
struct BwdSmem {
  float *sx, *sy, *sc, *fa, *fb, *sout;
  int dc, ldo;
  __device__ BwdSmem(float* smem, int d0, int d) {
    dc = min(kOutChunk, d - d0);
    ldo = out_ld(dc);
    sx = smem;
    sy = sx + kChunk * kLd;
    sc = sy + kChunk * kLd;
    fa = sc + kTile * kLd;
    fb = fa + kTile;
    sout = fb + kTile;
    for (int i = threadIdx.x; i < kTile * ldo; i += kThreads) sout[i] = 0.f;
  }
};

size_t bwd_smem_bytes(int d) {
  const int dc = d < kOutChunk ? d : kOutChunk;
  return sizeof(float) *
         (2 * kChunk * kLd + kTile * kLd + 2 * kTile + kTile * out_ld(dc));
}

// d A_r and ds_rows for a 64-row anchor tile (blockIdx.z: feature chunk).
template <bool kPruned>
__global__ void __launch_bounds__(kThreads)
rows_bwd_rows_kernel(const float* __restrict__ ar, const float* __restrict__ aa,
                     const float* __restrict__ oa,
                     const unsigned char* __restrict__ ki,
                     const unsigned char* __restrict__ ka,
                     const float* __restrict__ scale_ptr, float w,
                     const float* __restrict__ lse, const float* __restrict__ g,
                     float* __restrict__ d_rows, float* __restrict__ ds_rows,
                     int bl, int n, int d, int off) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = blockIdx.z * kOutChunk;
  BwdSmem sm(smem, d0, d);
  const float s = *scale_ptr;
  const int r0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float rg[4], rl[4], ds[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    rg[i] = row < bl ? g[row] : 0.f;
    rl[i] = row < bl ? lse[row] : 0.f;
    ds[i] = 0.f;
  }
  float acc[4][4];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    for (int part = 0; part < 2; ++part) {
      const bool intra = part == 1;
      const float* cand = intra ? aa : oa;
      tile_dot(ar, r0, bl, cand, c0, n, d, sm.sx, sm.sy, acc);
      const float zs = intra ? w * s : s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * ty + i;
        const int grow = off + row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = 4 * tx + j;
          const int col = c0 + cl;
          const float z = zs * acc[i][j];
          float coef = 0.f;
          // excluded: exp(-1e9 - lse) = 0 exactly; the zeroed self logit
          // of the released loss is a constant with no gradient
          if (row < bl && col < n && kept<kPruned>(intra, grow, col, ki, ka) &&
              (kPruned || !(intra && grow == col)))
            coef = rg[i] * expf(z - rl[i]);
          ds[i] = fmaf(coef, z, ds[i]);
          sm.sc[(4 * ty + i) * kLd + cl] = intra ? w * coef : coef;
        }
      }
      add_product(sm.sc, cand, c0, n, d, d0, sm.dc, sm.sx, sm.sout, sm.ldo);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * sm.dc; i += kThreads) {
    const int rr = i / sm.dc, f = i - rr * sm.dc;
    const int row = r0 + rr;
    if (row < bl) d_rows[(size_t)row * d + d0 + f] = s * sm.sout[rr * sm.ldo + f];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int sh = 8; sh > 0; sh >>= 1)
      ds[i] += __shfl_xor_sync(0xffffffffu, ds[i], sh);
    const int row = r0 + 4 * ty + i;
    if (tx == 0 && blockIdx.z == 0 && row < bl) ds_rows[row] = ds[i];
  }
}

// d O (blockIdx.y = 0) or d A (1) for 64 candidates (blockIdx.z: feature
// chunk): the candidate tile against every anchor tile.
template <bool kPruned>
__global__ void __launch_bounds__(kThreads)
rows_bwd_cols_kernel(const float* __restrict__ ar, const float* __restrict__ aa,
                     const float* __restrict__ oa,
                     const unsigned char* __restrict__ ki,
                     const unsigned char* __restrict__ ka,
                     const float* __restrict__ scale_ptr, float w,
                     const float* __restrict__ lse, const float* __restrict__ g,
                     float* __restrict__ d_other, float* __restrict__ d_anchor,
                     int bl, int n, int d, int off) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = blockIdx.z * kOutChunk;
  BwdSmem sm(smem, d0, d);
  const bool intra = blockIdx.y != 0;
  const float* cand = intra ? aa : oa;
  float* out = intra ? d_anchor : d_other;
  const float s = *scale_ptr;
  const float zs = intra ? w * s : s;
  const int c0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[4][4];
  for (int r0 = 0; r0 < bl; r0 += kTile) {
    // acc[i][j] = cand_{c0 + 4ty + i} · a_{r0 + 4tx + j}
    tile_dot(cand, c0, n, ar, r0, bl, d, sm.sx, sm.sy, acc);
    if (threadIdx.x < kTile) {
      const int row = r0 + threadIdx.x;
      sm.fa[threadIdx.x] = row < bl ? g[row] : 0.f;
      sm.fb[threadIdx.x] = row < bl ? lse[row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = 4 * tx + j;
        const int row = r0 + rl;
        const int grow = off + row;
        float coef = 0.f;
        if (row < bl && col < n && kept<kPruned>(intra, grow, col, ki, ka) &&
            (kPruned || !(intra && grow == col)))
          coef = sm.fa[rl] * expf(zs * acc[i][j] - sm.fb[rl]);
        sm.sc[(4 * ty + i) * kLd + rl] = intra ? w * coef : coef;
      }
    }
    add_product(sm.sc, ar, r0, bl, d, d0, sm.dc, sm.sx, sm.sout, sm.ldo);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * sm.dc; i += kThreads) {
    const int cc = i / sm.dc, f = i - cc * sm.dc;
    const int col = c0 + cc;
    if (col < n) out[(size_t)col * d + d0 + f] = s * sm.sout[cc * sm.ldo + f];
  }
}

// ---------------------------------------------------------------------------
// the bf16 builds: tensor cores (loss_mma.cuh)
// ---------------------------------------------------------------------------

// The lse of anchor rows [64 x, 64 x + 64) against the candidate tiles of
// part z of gridDim.z (O's, then A's, per tile), at the scale *scale_ptr:
// loss_mma.cuh's online-logsumexp block in its rows form.  One part writes
// lse; more write m and l to their slices of `part` ([2][parts][bl]:
// every m, then every l), which rows_lse_merge_kernel merges.
template <int kChunkF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, 2)
rows_lse_bf16_kernel(const bf16* __restrict__ ar, const bf16* __restrict__ aa,
                     const bf16* __restrict__ oa,
                     const unsigned char* __restrict__ ki,
                     const unsigned char* __restrict__ ka,
                     const float* __restrict__ scale_ptr, float w,
                     float* __restrict__ lse, float* __restrict__ part, int bl,
                     int n, int d, int off, bool vec) {
  const int tiles = (n + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  // the candidates: intra A (keep_intra), inter O (keep_inter)
  fwd_block<kChunkF, kPruned, true>(
      aa, oa, ka, ki, *scale_ptr, w, n, d, vec, blockIdx.x * kRows,
      z * tiles / parts, (z + 1) * tiles / parts,
      [&](int row, float mm, float sum) {
        if (parts == 1) {
          lse[row] = kLn2 * (mm + log2f(sum));
        } else {
          part[(size_t)z * bl + row] = mm;
          part[(size_t)(parts + z) * bl + row] = sum;
        }
      },
      ar, bl, off);
}

// lse from the parts' (m, l), merged in index order (merge_parts)
__global__ void __launch_bounds__(kThreads)
rows_lse_merge_kernel(const float* __restrict__ part, int parts,
                      float* __restrict__ lse, int bl) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < bl; i += gridDim.x * kThreads)
    lse[i] = merge_parts(part + i, part + (size_t)parts * bl + i, bl, parts);
}

// d A_r for anchor rows [64 x, 64 x + 64), gradient features [256 y, 256 y
// + 256) (narrower where d is), and the candidate tiles of part z of
// gridDim.z.  One part writes s · the gradient rows to d_rows and Σ coef⊙z
// per row to ds_rows; more write their fp32 sums to `part` ([parts][bl][d],
// then [parts][bl] for the rows' Σ coef⊙z), which rows_sum_kernel adds.  Σ
// coef⊙z comes from the blocks of feature chunk 0 only (every chunk
// recomputes the same logits, each in its own order).
template <int kWarpF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, 1)
rows_bwd_rows_bf16_kernel(const bf16* __restrict__ ar, const bf16* __restrict__ aa,
                          const bf16* __restrict__ oa,
                          const unsigned char* __restrict__ ki,
                          const unsigned char* __restrict__ ka,
                          const float* __restrict__ scale_ptr, float w,
                          const float* __restrict__ lse,
                          const float* __restrict__ g, float* __restrict__ d_rows,
                          float* __restrict__ ds_rows, float* __restrict__ part,
                          int bl, int n, int d, int off, bool vec) {
  const int cand_tiles = (n + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  const float s = *scale_ptr;
  const size_t rows_d = (size_t)bl * d;
  float* out = parts == 1 ? d_rows : part + z * rows_d;
  float* ds_out = blockIdx.y != 0 ? nullptr
                  : parts == 1    ? ds_rows
                                  : part + parts * rows_d + (size_t)z * bl;
  // the candidates: intra A (keep_intra), inter O (keep_inter)
  bwd_block<kWarpF, false, kPruned, false, Form::rows>(
      aa, oa, ka, ki, s, w, lse, nullptr, g, nullptr, out, parts == 1 ? s : 1.f,
      n, d, vec, blockIdx.x * kRows, blockIdx.y, z * cand_tiles / parts,
      (z + 1) * cand_tiles / parts, 0.f, ds_out, ar, bl, off);
}

// d_rows = s · (part[0] + part[1] + ... ) and ds_rows = the parts' Σ coef⊙z
// per row added, each in index order; s = *scale_ptr
__global__ void __launch_bounds__(kThreads)
rows_sum_kernel(const float* __restrict__ part, int parts,
                const float* __restrict__ scale_ptr, float* __restrict__ d_rows,
                float* __restrict__ ds_rows, int bl, size_t rows_d) {
  const float s = *scale_ptr;
  const float* ds_part = part + parts * rows_d;
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < rows_d + bl;
       i += (size_t)gridDim.x * kThreads) {
    if (i < rows_d) {
      float acc = part[i];
      for (int z = 1; z < parts; ++z) acc += part[z * rows_d + i];
      d_rows[i] = s * acc;
    } else {
      const size_t r = i - rows_d;
      float acc = ds_part[r];
      for (int z = 1; z < parts; ++z) acc += ds_part[(size_t)z * bl + r];
      ds_rows[r] = acc;
    }
  }
}

// d O (y < chunks) or d A for candidates [64 x, 64 x + 64), gradient
// features of the 256-feature chunk y % chunks, and the anchor tiles of
// part z of gridDim.z: the anchor-gradient block in its cols form.  One
// part writes s · the gradient rows to d_other / d_anchor; more write their
// fp32 sums to their slices [z][array] of `part` ([parts][2][n][d]), which
// cols_sum_kernel adds.
template <int kWarpF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, 1)
rows_bwd_cols_bf16_kernel(const bf16* __restrict__ ar, const bf16* __restrict__ aa,
                          const bf16* __restrict__ oa,
                          const unsigned char* __restrict__ ki,
                          const unsigned char* __restrict__ ka,
                          const float* __restrict__ scale_ptr, float w,
                          const float* __restrict__ lse,
                          const float* __restrict__ g, float* __restrict__ d_other,
                          float* __restrict__ d_anchor, float* __restrict__ part,
                          int bl, int n, int d, int off, bool vec) {
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const bool intra = (int)blockIdx.y >= chunks;
  const int row_tiles = (bl + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  const float s = *scale_ptr;
  float* out = parts == 1 ? (intra ? d_anchor : d_other)
                          : part + (size_t)(2 * z + (intra ? 1 : 0)) * n * d;
  bwd_block<kWarpF, false, kPruned, false, Form::cols>(
      aa, oa, ka, ki, s, w, lse, nullptr, g, nullptr, out, parts == 1 ? s : 1.f,
      n, d, vec, blockIdx.x * kRows, blockIdx.y - (intra ? chunks : 0),
      z * row_tiles / parts, (z + 1) * row_tiles / parts, 0.f, nullptr, ar, bl,
      off, intra);
}

// d_other, d_anchor = s · (part[0] + part[1] + ... ), in index order; s =
// *scale_ptr
__global__ void __launch_bounds__(kThreads)
cols_sum_kernel(const float* __restrict__ part, int parts,
                const float* __restrict__ scale_ptr, float* __restrict__ d_other,
                float* __restrict__ d_anchor, size_t nd) {
  const float s = *scale_ptr;
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < 2 * nd;
       i += (size_t)gridDim.x * kThreads) {
    float acc = part[i];
    for (int z = 1; z < parts; ++z) acc += part[2 * nd * z + i];
    if (i < nd)
      d_other[i] = s * acc;
    else
      d_anchor[i - nd] = s * acc;
  }
}

// ---------------------------------------------------------------------------
// launches (host)
// ---------------------------------------------------------------------------

int tiles(int n) { return (n + kTile - 1) / kTile; }
int out_chunks(int d) { return (d + kOutChunk - 1) / kOutChunk; }
// a grid-stride kernel's blocks for `count` elements
int stride_blocks(size_t count) {
  const size_t blocks = (count + kThreads - 1) / kThreads;
  return (int)(blocks < 4096 ? blocks : 4096);
}

bool bad_args(int dtype, const void* ki, const void* ka, int bl, int n, int d,
              int off) {
  return bl < 1 || n < 1 || d < 1 || (dtype != 0 && dtype != 1) ||
         (ki == nullptr) != (ka == nullptr) || off < 0 || off > n - bl;
}

template <bool kPruned>
cudaError_t launch_lse(const void* ar, const void* aa, const void* oa,
                       const void* ki, const void* ka, const float* scale,
                       float w, float* lse, int bl, int n, int d, int off,
                       cudaStream_t stream) {
  rows_lse_kernel<kPruned><<<tiles(bl), kThreads, 0, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(aa),
      static_cast<const float*>(oa), static_cast<const unsigned char*>(ki),
      static_cast<const unsigned char*>(ka), scale, w, lse, bl, n, d, off);
  return cudaGetLastError();
}

template <bool kPruned>
cudaError_t launch_bwd_rows(const void* ar, const void* aa, const void* oa,
                            const void* ki, const void* ka, const float* scale,
                            float w, const float* lse, const float* g,
                            float* d_rows, float* ds_rows, int bl, int n,
                            int d, int off, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      rows_bwd_rows_kernel<kPruned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(bl), 1, out_chunks(d));
  rows_bwd_rows_kernel<kPruned><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(aa),
      static_cast<const float*>(oa), static_cast<const unsigned char*>(ki),
      static_cast<const unsigned char*>(ka), scale, w, lse, g, d_rows, ds_rows,
      bl, n, d, off);
  return cudaGetLastError();
}

template <bool kPruned>
cudaError_t launch_bwd_cols(const void* ar, const void* aa, const void* oa,
                            const void* ki, const void* ka, const float* scale,
                            float w, const float* lse, const float* g,
                            float* d_other, float* d_anchor, int bl, int n,
                            int d, int off, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      rows_bwd_cols_kernel<kPruned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(n), 2, out_chunks(d));
  rows_bwd_cols_kernel<kPruned><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(aa),
      static_cast<const float*>(oa), static_cast<const unsigned char*>(ki),
      static_cast<const unsigned char*>(ka), scale, w, lse, g, d_other,
      d_anchor, bl, n, d, off);
  return cudaGetLastError();
}

// The bf16 kernels' plans: the forward splits the candidate tiles of its
// ceil(bl/64) blocks, the rows backward those of its ceil(bl/64) x chunks,
// the cols backward the anchor tiles of its ceil(n/64) x 2 x chunks.
template <int kChunkF, bool kPruned>
cudaError_t lse_plan(int bl, int n, int d, Plan* plan) {
  const int chunks = (d + kChunkF - 1) / kChunkF;
  return split_plan(reinterpret_cast<const void*>(rows_lse_bf16_kernel<kChunkF, kPruned>),
                    fwd_mma_smem_bytes<kChunkF>(chunks), fwd_mma_smem_bytes<kChunkF>(2),
                    tiles(n), tiles(bl), plan);
}

template <int kWarpF, bool kPruned>
cudaError_t rows_plan(int bl, int n, int d, Plan* plan) {
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  return split_plan(reinterpret_cast<const void*>(rows_bwd_rows_bf16_kernel<kWarpF, kPruned>),
                    bwd_mma_smem_bytes<kWarpF>(chunks), bwd_mma_smem_bytes<kWarpF>(2),
                    tiles(n), chunks * tiles(bl), plan);
}

template <int kWarpF, bool kPruned>
cudaError_t cols_plan(int bl, int n, int d, Plan* plan) {
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  return split_plan(reinterpret_cast<const void*>(rows_bwd_cols_bf16_kernel<kWarpF, kPruned>),
                    bwd_mma_smem_bytes<kWarpF>(chunks), bwd_mma_smem_bytes<kWarpF>(2),
                    tiles(bl), 2 * chunks * tiles(n), plan);
}

bool vec_ok(int d, const void* ar, const void* aa, const void* oa) {
  return d % 8 == 0 && aligned16(ar) && aligned16(aa) && aligned16(oa);
}

template <int kChunkF, bool kPruned>
cudaError_t launch_lse_bf16(const void* ar, const void* aa, const void* oa,
                            const void* ki, const void* ka, const float* scale,
                            float w, float* lse, float* part, int bl, int n,
                            int d, int off, cudaStream_t stream) {
  Plan plan;
  cudaError_t err = lse_plan<kChunkF, kPruned>(bl, n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(tiles(bl), 1, plan.parts);
  rows_lse_bf16_kernel<kChunkF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(ar), static_cast<const bf16*>(aa),
      static_cast<const bf16*>(oa), static_cast<const unsigned char*>(ki),
      static_cast<const unsigned char*>(ka), scale, w, lse, part, bl, n, d, off,
      vec_ok(d, ar, aa, oa));
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  rows_lse_merge_kernel<<<stride_blocks(bl), kThreads, 0, stream>>>(part, plan.parts,
                                                                    lse, bl);
  return cudaGetLastError();
}

template <int kWarpF, bool kPruned>
cudaError_t launch_bwd_rows_bf16(const void* ar, const void* aa, const void* oa,
                                 const void* ki, const void* ka,
                                 const float* scale, float w, const float* lse,
                                 const float* g, float* d_rows, float* ds_rows,
                                 float* part, int bl, int n, int d, int off,
                                 cudaStream_t stream) {
  Plan plan;
  cudaError_t err = rows_plan<kWarpF, kPruned>(bl, n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const dim3 grid(tiles(bl), (d + kChunkF - 1) / kChunkF, plan.parts);
  rows_bwd_rows_bf16_kernel<kWarpF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(ar), static_cast<const bf16*>(aa),
      static_cast<const bf16*>(oa), static_cast<const unsigned char*>(ki),
      static_cast<const unsigned char*>(ka), scale, w, lse, g, d_rows, ds_rows,
      part, bl, n, d, off, vec_ok(d, ar, aa, oa));
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  const size_t rows_d = (size_t)bl * d;
  rows_sum_kernel<<<stride_blocks(rows_d + bl), kThreads, 0, stream>>>(
      part, plan.parts, scale, d_rows, ds_rows, bl, rows_d);
  return cudaGetLastError();
}

template <int kWarpF, bool kPruned>
cudaError_t launch_bwd_cols_bf16(const void* ar, const void* aa, const void* oa,
                                 const void* ki, const void* ka,
                                 const float* scale, float w, const float* lse,
                                 const float* g, float* d_other, float* d_anchor,
                                 float* part, int bl, int n, int d, int off,
                                 cudaStream_t stream) {
  Plan plan;
  cudaError_t err = cols_plan<kWarpF, kPruned>(bl, n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const dim3 grid(tiles(n), 2 * ((d + kChunkF - 1) / kChunkF), plan.parts);
  rows_bwd_cols_bf16_kernel<kWarpF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(ar), static_cast<const bf16*>(aa),
      static_cast<const bf16*>(oa), static_cast<const unsigned char*>(ki),
      static_cast<const unsigned char*>(ka), scale, w, lse, g, d_other, d_anchor,
      part, bl, n, d, off, vec_ok(d, ar, aa, oa));
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  const size_t nd = (size_t)n * d;
  cols_sum_kernel<<<stride_blocks(2 * nd), kThreads, 0, stream>>>(
      part, plan.parts, scale, d_other, d_anchor, nd);
  return cudaGetLastError();
}

enum PlanKind { kLse, kBwdRows, kBwdCols };

// floats of a bf16 kernel's scratch for (bl, n, d, pruned) on the current
// device: 0 where its plan does not split; a negative value is a
// cudaError_t, negated
long long split_scratch(PlanKind kind, int dtype, int bl, int n, int d,
                        int pruned) {
  if (dtype != 1 || bl < 1 || n < 1 || d < 1) return 0;
  Plan plan{0, 1};
  const cudaError_t err = by_pruned(pruned != 0, [&](auto p) {
    constexpr bool kPruned = decltype(p)::value;
    if (kind == kLse)
      return by_chunk(d, [&](auto chunk) {
        return lse_plan<decltype(chunk)::value, kPruned>(bl, n, d, &plan);
      });
    return by_width(d, [&](auto width) {
      constexpr int kWarpF = decltype(width)::value;
      return kind == kBwdRows ? rows_plan<kWarpF, kPruned>(bl, n, d, &plan)
                              : cols_plan<kWarpF, kPruned>(bl, n, d, &plan);
    });
  });
  if (err != cudaSuccess) return -(long long)err;
  if (plan.parts == 1) return 0;
  const long long each = kind == kLse      ? 2LL * bl
                         : kind == kBwdRows ? (long long)bl * d + bl
                                            : 2LL * n * d;
  return plan.parts * each;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (anchor_rows [bl, d], anchor_all and
// other_all [n, d]); keep_inter, keep_intra: bool [n] (both, or both null
// for the unpruned variant); scale [1], lse, g, ds_rows [bl] (the [bl, 1]
// columns), d_rows [bl, d], d_other, d_anchor [n, d]: float32.  The anchor
// rows are rows off .. off + bl of the candidates' batch.  Each function
// returns a cudaError_t; launches are asynchronous on `stream`.  The bf16
// builds split their walked tiles where bl leaves the card idle: their
// float32 scratch `part` holds crossclr_rows_<kernel>_scratch(dtype, bl,
// n, d, pruned) values (0: none needed, pass null; negative: a cudaError_t,
// negated), sized from the plan on the current device.

extern "C" long long crossclr_rows_lse_scratch(int dtype, int bl, int n, int d,
                                               int pruned) {
  return split_scratch(kLse, dtype, bl, n, d, pruned);
}

extern "C" int crossclr_rows_lse(int dtype, const void* anchor_rows,
                                 const void* anchor_all, const void* other_all,
                                 const void* keep_inter,
                                 const void* keep_intra, const void* scale,
                                 void* lse, void* part, int bl, int n, int d,
                                 int off, float w, void* stream) {
  if (bad_args(dtype, keep_inter, keep_intra, bl, n, d, off))
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  float* out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_inter != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0)
      return launch_lse<kPruned>(anchor_rows, anchor_all, other_all, keep_inter,
                                 keep_intra, sp, w, out, bl, n, d, off, st);
    return by_chunk(d, [&](auto chunk) {
      return launch_lse_bf16<decltype(chunk)::value, kPruned>(
          anchor_rows, anchor_all, other_all, keep_inter, keep_intra, sp, w, out,
          static_cast<float*>(part), bl, n, d, off, st);
    });
  });
}

extern "C" long long crossclr_rows_bwd_rows_scratch(int dtype, int bl, int n,
                                                    int d, int pruned) {
  return split_scratch(kBwdRows, dtype, bl, n, d, pruned);
}

extern "C" int crossclr_rows_bwd_rows(int dtype, const void* anchor_rows,
                                      const void* anchor_all,
                                      const void* other_all,
                                      const void* keep_inter,
                                      const void* keep_intra,
                                      const void* scale, const void* lse,
                                      const void* g, void* d_rows,
                                      void* ds_rows, void* part, int bl, int n,
                                      int d, int off, float w, void* stream) {
  if (bad_args(dtype, keep_inter, keep_intra, bl, n, d, off))
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  float* out = static_cast<float*>(d_rows);
  float* ds = static_cast<float*>(ds_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_inter != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0)
      return launch_bwd_rows<kPruned>(anchor_rows, anchor_all, other_all,
                                      keep_inter, keep_intra, sp, w, lp, gp, out,
                                      ds, bl, n, d, off, st);
    return by_width(d, [&](auto width) {
      return launch_bwd_rows_bf16<decltype(width)::value, kPruned>(
          anchor_rows, anchor_all, other_all, keep_inter, keep_intra, sp, w, lp,
          gp, out, ds, static_cast<float*>(part), bl, n, d, off, st);
    });
  });
}

extern "C" long long crossclr_rows_bwd_cols_scratch(int dtype, int bl, int n,
                                                    int d, int pruned) {
  return split_scratch(kBwdCols, dtype, bl, n, d, pruned);
}

extern "C" int crossclr_rows_bwd_cols(int dtype, const void* anchor_rows,
                                      const void* anchor_all,
                                      const void* other_all,
                                      const void* keep_inter,
                                      const void* keep_intra,
                                      const void* scale, const void* lse,
                                      const void* g, void* d_other,
                                      void* d_anchor, void* part, int bl, int n,
                                      int d, int off, float w, void* stream) {
  if (bad_args(dtype, keep_inter, keep_intra, bl, n, d, off))
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  float* dother = static_cast<float*>(d_other);
  float* danchor = static_cast<float*>(d_anchor);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_inter != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0)
      return launch_bwd_cols<kPruned>(anchor_rows, anchor_all, other_all,
                                      keep_inter, keep_intra, sp, w, lp, gp,
                                      dother, danchor, bl, n, d, off, st);
    return by_width(d, [&](auto width) {
      return launch_bwd_cols_bf16<decltype(width)::value, kPruned>(
          anchor_rows, anchor_all, other_all, keep_inter, keep_intra, sp, w, lp,
          gp, dother, danchor, static_cast<float*>(part), bl, n, d, off, st);
    });
  });
}

extern "C" const char* crossclr_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
