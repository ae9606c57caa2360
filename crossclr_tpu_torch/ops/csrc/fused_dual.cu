// The CrossCLR-intra logsumexp pair for Hopper (sm_90a): four kernels with a
// plain C interface, each with an unpruned and a pruned (keep-mask) variant.
//
// Replaces the TPU kernels of crossclr_tpu/ops/fused_dual.py, pruned=False
// and pruned=True:
//   crossclr_sym_fwd   <- _sym_fwd_kernel   (static τ: constant shift m0)
//   crossclr_sym_bwd   <- _sym_bwd_kernel   (factored exp(z)·g·e^{-lse})
//   crossclr_dual_fwd  <- _dual_fwd_kernel  (traced τ: online max)
//   crossclr_dual_bwd  <- _dual_bwd_kernel  (subtract-first, and Σ coeff⊙z
//                                            for d loss / d scale)
// The JAX dual backward's `factored` form runs there only for a float τ
// whose sym kernels a VMEM or tile gate refuses; here that τ takes sym.
//
// The math, for L2-normalized V, T [n, d] and scale s = 1/τ, weight w:
//   lse_v[i] = log( Σ_j exp(s·v_i·t_j) + Σ_j exp(w·s·v_i·v_j) ),
//   lse_t[i] = log( Σ_j exp(s·t_i·v_j) + Σ_j exp(w·s·t_i·t_j) ).
// Unpruned (the released loss): the intra logit of j = i is ZEROED (exp(0)
// = 1 stays in the sum).  Pruned (full CrossCLR, keep masks kv, kt [n]
// given): each anchor prunes its candidates by the CANDIDATE modality's
// mask.  For video anchor i, inter column j is kept where kt[j] | j == i and
// intra column j where kv[j] & j != i; text anchors mirror it (inter by kv,
// intra by kt).  The self column is DROPPED, not zeroed, and the positive is
// always kept.  Given the cotangents g_v, g_t of the two lse vectors, with
//   M[i,j]   = g_v[i]·e^{z_vt[i,j] - lse_v[i]}·[kt[j] | i = j]
//            + g_t[j]·e^{z_vt[i,j] - lse_t[j]}·[kv[i] | i = j],
//   Q_v[i,j] = g_v[i]·e^{z_vv[i,j] - lse_v[i]}·[kv[j]]
//            + g_v[j]·e^{z_vv[i,j] - lse_v[j]}·[kv[i]],  0 on the diagonal,
// and Q_t the same on T (the bracketed masks are 1 when unpruned):
//   dV = s·(M·T + w·Q_v·V),   dT = s·(Mᵀ·V + w·Q_t·T),
//   Σ M⊙z_vt + ½(Σ Q_v⊙z_vv + Σ Q_t⊙z_tt) = s · d loss / d s.
// How the masks enter: in the dual forward an excluded logit is kMasked =
// -1e9 and the running max starts at -1e30, below it, so a thread (or a
// part of a split) whose own columns are all excluded holds a bogus
// partial (m = -1e9, l = its count) that the rescale exp(-1e9 - m_real)
// wipes when the row's partials combine (every row keeps its positive), as
// in fused_global.cu.  The sym forward
// has no running max to absorb -1e9, so the masks are 0/1 factors on
// exp(z - m0); the wrapper gates that route to 2·m0 <= 80, where the kept
// positive bounds each row sum below by exp(-2·m0) and nothing flushes.  In
// both backwards each role's term of a coefficient is selected away where
// its mask drops the pair, on the raw logit (never an exp of a masked
// logit, which could overflow at large s); a dropped coefficient is 0 and
// adds 0·z = ±0 to Σ coeff⊙z, never NaN.
//
// Design: owner-computes.  A block owns one 64-row tile of ONE direction's
// anchors (blockIdx.y = 0: video anchors, candidates T then V; 1: text
// anchors, candidates V then T) and loops over every 64-row candidate tile
// itself, recomputing the logits it needs.  The text direction's inter
// logits are the video direction's transposed, so the role swap makes both
// directions one code path; it swaps the masks too (a video-anchor block
// prunes inter candidates by kt and intra ones by kv, a text-anchor block
// the opposite).  The TPU kernels instead carry column sums and column
// gradients across a sequential grid in VMEM scratch and share the inter
// tile and the lower intra triangle between the two directions; blocks on
// this card run in parallel in no order, so nothing carries over between
// them.  Owners need no atomics: every output element is written by one
// block and every sum has a fixed order, so runs are bit-reproducible.
// d loss / d scale is reduced from per-block partials in index order by a
// second one-block kernel.  The inter logits of the text-anchor blocks are
// the transposes of the video-anchor blocks' ones, so only blockIdx.y = 0
// adds Σ M⊙z_vt; each direction adds half of its own intra sum.
//
// The scalar kernels (the fp32 builds of all four): the logit tiles are
// 64 x 64 products over d, staged through shared memory in 32-feature
// chunks (loss_tiles.cuh, shared with fused_crossclr.cu).  256 threads each
// own a 4 x 4 micro tile.  A backward block keeps its gradient rows [64,
// ≤512 features] in shared memory and adds coefficient-tile ×
// candidate-tile products into them; wider features split over blockIdx.z,
// each z recomputing the logits.  Edges of n and d are masked in the
// kernels, so any n and d run unpadded.  The pruned variants are the same
// kernels (a template flag): the masks cost a byte load per candidate and
// a select per logit.  What bounds them on this card: scalar fp32 FMAs
// issued from shared memory.  The forward does 4·n²·d FMAs, the backward
// 8·n²·d, where the function needs 2·n²·d and 6·n²·d: the inter tile once
// for both directions and one triangle of each symmetric intra product,
// with or without keep masks (the TPU design shares both so);
// chip_smoke.py's bound counts the latter.  Operands are read from L2 once
// per (row tile, column tile).
//
// The bf16 builds of all four (the `default` tier every leg runs) are
// tensor-core kernels (mma.sync m16n8k16, bf16 operands, fp32
// accumulators) built from the pieces of loss_mma.cuh.  A block of 8 warps
// owns 64 anchor rows of one direction (blockIdx.y) and walks its candidate
// tiles, each staged by 16-byte cp.async into a double buffer; every
// 16-feature logit step starts from zero and is added in fp32.  At the MLP
// leg's n = 1024 one block per (row tile, direction) leaves most of the 132
// SMs idle, so the candidate tiles split over blockIdx.z into the parts
// split_parts picks from n, the SM count and the occupancy; each part
// writes its fp32 partial rows to a scratch buffer the wrapper allocates
// (its size named by the crossclr_*_scratch queries), and a second kernel
// adds them in index order: no atomics, bit-reproducible.  A kernel's plan
// (its shared memory and parts; loss_mma.cuh) takes its occupancy query
// once per (device, kernel, shared memory size) from a cache; the rest is
// arithmetic.
//   * sym_fwd_bf16_kernel: the per-direction forward's design
//     (fused_crossclr.cu: A fragments in registers where d fits one chunk)
//     with the static shift m0 in place of the online max: each logit is
//     one FFMA into log2 units, (z - m0)·log2 e, and one exp2, its keep
//     test a select where pruned; with a static shift the parts' partial
//     sums add directly (sym_fwd_sum_kernel: m0 + log of their sum).  It
//     issues 4 products of 2·n²·d (each direction recomputes V·Tᵀ and the
//     whole of its intra product) where the bound counts 2.
//   * dual_fwd_bf16_kernel: the sym forward's grid, staging and keep tests
//     with the per-direction forward's online logsumexp in log2 units (the
//     scale read from device memory once per block): a running max per row
//     once per tile, exp2 of each logit; each part writes its (m, l) per
//     row and dual_fwd_merge_kernel merges the parts in index order.  Its
//     block is loss_mma.cuh's fwd_block, shared with the rows forward
//     (fused_global.cu) in its rows form.  Where
//     d takes two 256-feature chunks both anchor chunks stay in shared
//     memory and only the candidate chunks stream, where the sym forward
//     restages the anchor chunk with every candidate chunk.  It issues the
//     same 4 products.
//   * sym_bwd_bf16_kernel: without masks its two directions are the
//     per-direction backward's factored form with (A, O) = (V, T) and
//     (T, V) (the formulas above against fused_crossclr.cu's), so it runs
//     that kernel's block (loss_mma.cuh's bwd_block: coefficients in fp32
//     registers, hi + lo bf16 coefficient fragments times the candidate
//     tile into fp32 register accumulators); the keep masks enter the
//     coefficient stage only, as the role selects above.  It now runs only
//     where the Hopper build below cannot: d % 8 != 0, an unaligned base,
//     or d > 384.
//   * sym_bwd_wgmma_kernel (the same _sym_bwd_kernel, both variants): the
//     Hopper design (loss_wgmma.cuh).  What bounds the mma.sync block on
//     this card: at the podslice cell's 32,768 x 256 it took 32.5 ms a call
//     (PERF.md §5) for 12 issued products of 2·n²·d, 6.6 TFLOP, 6.7 ms
//     at 989 TFLOP/s: about 20% of the tensor cores' rate, because
//     mma.sync from ldmatrix fragments, in 16-feature steps each added in
//     fp32, by 8 warps of one 64-row block a SM, cannot reach it; only
//     wgmma can.  The function itself needs 6 such products (the bound
//     chip_smoke.py counts, 3.3 ms).  The design keeps the 12 products and
//     their arithmetic, and issues them as the card wants: a block of 128
//     anchor rows (two consumer warpgroups of 64) and one 256-feature
//     chunk, whose candidate tiles (128 rows up to d = 256 unpruned, else
//     64) a producer warp streams by TMA into a ring of 128-byte swizzled
//     stages; each stage feeds both of its products, the logits by wgmma
//     from shared memory and the gradient by wgmma with the hi and lo
//     coefficient parts in registers (as FlashAttention-3 feeds P·V), so
//     each candidate tile is read from L2 once per 128 anchor rows, half as
//     often as by 64-row blocks.  The logits run as one accumulator over
//     the depth; the gradient's sum over candidates keeps its short chains
//     (a quarter of the chunk over one tile from zero, added in fp32).
//     Where n leaves SMs idle the candidate tiles split into parts as the
//     other builds do (split_parts, one block an SM), whose partials
//     bwd_sum_kernel adds in index order; at n = 32,768 the 512 blocks run
//     3.9 waves unsplit.  There it takes 10.6-10.9 ms a call, the issued
//     products at 61-63% of the bf16 peak (NVIDIA H100 80GB HBM3, 700 W).
//   * dual_bwd_bf16_kernel: the same block in its subtract-first form, the
//     scale read from device memory once per block, each block also summing
//     its share of Σ coeff⊙z (the ds weights above) from feature chunk 0
//     only (every chunk recomputes the same logits, each in its own order);
//     one partial per (part, direction, row tile), added in index order by
//     sum_partials_kernel.
//   Each backward issues 12 products of 2·n²·d (each direction's two logit
//   products and its two coefficient products, each in two bf16 parts)
//   where the bound counts 6; at d > 256 each 256-feature chunk of the
//   gradient (blockIdx.y) recomputes the logits.

#include <math.h>
#include <stddef.h>

#include "loss_mma.cuh"
#include "loss_tiles.cuh"
#include "loss_wgmma.cuh"

namespace {

using namespace loss_mma;
using namespace loss_tiles;

// ---------------------------------------------------------------------------
// forward: one direction's lse for a 64-row anchor tile
// ---------------------------------------------------------------------------

// kOnline = false: the sym kernel (static scale, constant shift m0, plain
// sums); true: the dual kernel (scale read from device memory, online max).
// kPruned: keep masks kv, kt [n] given (null otherwise).
template <typename T, bool kOnline, bool kPruned>
__global__ void __launch_bounds__(kThreads)
lse_fwd_kernel(const T* __restrict__ v, const T* __restrict__ t,
               const unsigned char* __restrict__ kv,
               const unsigned char* __restrict__ kt,
               const float* __restrict__ scale_ptr, float scale_arg, float w,
               float* __restrict__ lse_v, float* __restrict__ lse_t, int n,
               int d) {
  __shared__ __align__(16) float sx[kChunk * kLd];
  __shared__ __align__(16) float sy[kChunk * kLd];
  const bool text = blockIdx.y != 0;
  const T* a = text ? t : v;
  const T* o = text ? v : t;
  const unsigned char* keep_a = text ? kt : kv;  // the anchors' modality
  const unsigned char* keep_o = text ? kv : kt;  // the other modality
  const float s = kOnline ? *scale_ptr : scale_arg;
  const float ws = w * s;
  const float m0 = fmaxf(fmaxf(s, ws), 0.f);
  const int r0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kOnline ? kNegFloor : m0;
    l[r] = 0.f;
  }
  float acc[4][4];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    for (int part = 0; part < 2; ++part) {
      const bool intra = part == 1;
      tile_dot(a, r0, intra ? a : o, c0, n, d, sx, sy, acc);
      const float zs = intra ? ws : s;
      // this thread's candidate columns kept by the candidates' modality
      bool kc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + 4 * tx + c;
        kc[c] = kPruned && col < n && (intra ? keep_a : keep_o)[col];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * ty + r;
        float z[4];
        bool ok[4], keep[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 4 * tx + c;
          const bool diag = row == col;
          ok[c] = col < n;
          if constexpr (kPruned) {
            // the positive always kept, the self column dropped
            keep[c] = intra ? (kc[c] && !diag) : (kc[c] || diag);
            z[c] = zs * acc[r][c];
            if constexpr (kOnline) z[c] = keep[c] ? z[c] : kMasked;
          } else {
            keep[c] = true;
            // the zeroed (not dropped) self-similarity logit
            z[c] = (intra && diag) ? 0.f : zs * acc[r][c];
          }
        }
        if constexpr (kOnline) {
          float tmax = kNegFloor;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (ok[c]) tmax = fmaxf(tmax, z[c]);
          const float mn = fmaxf(m[r], tmax);
          float add = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (ok[c]) add += expf(z[c] - mn);
          l[r] = l[r] * expf(m[r] - mn) + add;
          m[r] = mn;
        } else {
          // the masks as 0/1 factors: no running max absorbs -1e9 here
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (ok[c]) l[r] += (keep[c] ? 1.f : 0.f) * expf(z[c] - m0);
        }
      }
    }
  }
  // a row's 16 partials live on 16 consecutive lanes of one warp
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      if constexpr (kOnline) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float mn = fmaxf(m[r], mo);
        l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
        m[r] = mn;
      } else {
        l[r] += lo;
      }
    }
    const int row = r0 + 4 * ty + r;
    if (tx == 0 && row < n) (text ? lse_t : lse_v)[row] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward: one direction's gradient rows for a 64-row anchor tile
// ---------------------------------------------------------------------------

// kTraced = false: the sym kernel (static scale, factored coefficients
// exp(z)·(g e^{-lse})); true: the dual kernel (scale from device memory,
// subtract-first g·exp(z - lse), and its Σ coeff⊙z output ds_part, one
// partial per block).  kPruned: keep masks kv, kt [n] given.
template <typename T, bool kTraced, bool kPruned>
__global__ void __launch_bounds__(kThreads)
lse_bwd_kernel(const T* __restrict__ v, const T* __restrict__ t,
               const unsigned char* __restrict__ kv,
               const unsigned char* __restrict__ kt,
               const float* __restrict__ scale_ptr, float scale_arg, float w,
               const float* __restrict__ lse_v, const float* __restrict__ lse_t,
               const float* __restrict__ g_v, const float* __restrict__ g_t,
               float* __restrict__ dv, float* __restrict__ dt,
               float* __restrict__ ds_part, int n, int d) {
  constexpr bool kFactored = !kTraced;
  extern __shared__ __align__(16) float smem[];
  const int d0 = blockIdx.z * kOutChunk;
  const int dc = min(kOutChunk, d - d0);
  const int ldo = out_ld(dc);
  float* sx = smem;                   // [kChunk][kLd]
  float* sy = sx + kChunk * kLd;      // [kChunk][kLd]; sx..sy = [kTile][kLd]
  float* sc = sy + kChunk * kLd;      // [kTile][kLd] coefficient tile
  float* scol_a = sc + kTile * kLd;   // [kTile] candidate factors
  float* scol_b = scol_a + kTile;     // [kTile]
  float* scol_k = scol_b + kTile;     // [kTile] candidates kept (1 / 0)
  float* sout = scol_k + kTile;       // [kTile][ldo] gradient rows

  const bool text = blockIdx.y != 0;
  const T* a = text ? t : v;
  const T* o = text ? v : t;
  const float* lse_a = text ? lse_t : lse_v;
  const float* lse_o = text ? lse_v : lse_t;
  const float* g_a = text ? g_t : g_v;
  const float* g_o = text ? g_v : g_t;
  const unsigned char* keep_a = text ? kt : kv;  // the anchors' modality
  const unsigned char* keep_o = text ? kv : kt;  // the other modality
  float* out = text ? dt : dv;
  const float s = kTraced ? *scale_ptr : scale_arg;
  const int r0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  for (int i = threadIdx.x; i < kTile * ldo; i += kThreads) sout[i] = 0.f;
  // this thread's anchor-row factors, and whether the other role (the
  // candidate's own lse) keeps this anchor row as its candidate
  float ra[4], rb[4];
  bool kr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    ra[r] = rb[r] = 0.f;
    kr[r] = kPruned && row < n && keep_a[row];
    if (row < n) {
      if constexpr (kFactored) {
        ra[r] = g_a[row] * expf(-lse_a[row]);
      } else {
        ra[r] = g_a[row];
        rb[r] = lse_a[row];
      }
    }
  }
  float ds_acc = 0.f;
  float acc[4][4];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    for (int part = 0; part < 2; ++part) {
      const bool intra = part == 1;
      const T* cand = intra ? a : o;
      const float* g_c = intra ? g_a : g_o;
      const float* lse_c = intra ? lse_a : lse_o;
      const unsigned char* keep_c = intra ? keep_a : keep_o;
      tile_dot(a, r0, cand, c0, n, d, sx, sy, acc);
      if (threadIdx.x < kTile) {
        const int col = c0 + threadIdx.x;
        float fa = 0.f, fb = 0.f;
        scol_k[threadIdx.x] = (kPruned && col < n && keep_c[col]) ? 1.f : 0.f;
        if (col < n) {
          if constexpr (kFactored) {
            fa = g_c[col] * expf(-lse_c[col]);
          } else {
            fa = g_c[col];
            fb = lse_c[col];
          }
        }
        scol_a[threadIdx.x] = fa;
        scol_b[threadIdx.x] = fb;
      }
      __syncthreads();
      const float zs = intra ? w * s : s;
      // each (anchor, candidate) logit enters d loss / d s once: the
      // inter logits through the video-anchor blocks only, each intra
      // logit half through either of its two anchors' blocks
      const float ds_weight = intra ? 0.5f : (text ? 0.f : 1.f);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * ty + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cl = 4 * tx + c;
          const int col = c0 + cl;
          const float z = zs * acc[r][c];
          const bool diag = row == col;
          // role A (the anchor row's own lse) and role B (the candidate's):
          // each term counts only where its role keeps the pair
          bool keep_a_role, keep_b_role;
          if constexpr (kPruned) {
            const bool kc = scol_k[cl] != 0.f;
            keep_a_role = intra ? (kc && !diag) : (kc || diag);
            keep_b_role = intra ? (kr[r] && !diag) : (kr[r] || diag);
          } else {
            // a zeroed intra logit is a constant: no gradient
            keep_a_role = keep_b_role = !(intra && diag);
          }
          float coef = 0.f;
          if (row < n && col < n && (keep_a_role || keep_b_role)) {
            if constexpr (kFactored)
              coef = expf(z) * ((keep_a_role ? ra[r] : 0.f) +
                                (keep_b_role ? scol_a[cl] : 0.f));
            else
              coef = (keep_a_role ? ra[r] * expf(z - rb[r]) : 0.f) +
                     (keep_b_role ? scol_a[cl] * expf(z - scol_b[cl]) : 0.f);
          }
          if constexpr (kTraced) ds_acc = fmaf(ds_weight * coef, z, ds_acc);
          sc[(4 * ty + r) * kLd + cl] = intra ? w * coef : coef;
        }
      }
      add_product(sc, cand, c0, n, d, d0, dc, sx, sout, ldo);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * dc; i += kThreads) {
    const int rr = i / dc, f = i - rr * dc;
    const int row = r0 + rr;
    if (row < n) out[(size_t)row * d + d0 + f] = s * sout[rr * ldo + f];
  }
  if constexpr (kTraced) {
    __shared__ float warp_sums[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ds_acc += __shfl_xor_sync(0xffffffffu, ds_acc, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ds_acc;
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.z == 0) {
      float total = 0.f;
      for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
      ds_part[blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
  }
}

// out[0] = Σ part[i], in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part, int count,
                    float* __restrict__ out) {
  __shared__ float buf[kThreads];
  float x = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads) x += part[i];
  buf[threadIdx.x] = x;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

// ---------------------------------------------------------------------------
// sym forward, bf16 features: tensor cores (loss_mma.cuh)
// ---------------------------------------------------------------------------

// The sym forward's shared memory: two stages of candidate rows (the first
// holds the anchor rows while their fragments load), two of anchor rows
// where d takes more than one chunk, two stages of the candidates' keep
// flags, and the two halves' partial sums per row.
template <int kChunkF>
size_t sym_fwd_smem_bytes(int chunks) {
  return sizeof(bf16) * (size_t)((chunks > 1 ? 4 : 2) * kRows *
                                 Chunk<kChunkF>::kLd) +
         sizeof(float) * 4 * kRows;
}

// Block (x, y, z): anchor rows [64 x, 64 x + 64) of direction y (0: video
// anchors, candidates T then V; 1: text anchors, candidates V then T, the
// keep masks swapped with them), the candidate tiles of part z of
// gridDim.z.  Warp w scores rows 16 (w % 4) + [0, 16) against candidates
// 32 (w / 4) + [0, 32) of each tile, in stages (tile, part, chunk) whose
// loads go into the other buffer while the last one computes; where d fits
// one chunk the warp's A fragments stay in registers for the whole loop
// (kSteps x 4), a wider d restages its anchor chunk with each stage.  With
// the static shift every term is exp2((z - m0)·log2 e) <= 1 (unit
// features): one FFMA and one exp2 a logit, no max to track; unpruned, the
// intra self logit is zeroed (its exp(-m0) stays in the sum), pruned, the
// keep test (the positive always kept, the self column dropped) selects
// each term.  The lanes of a quad add their sums, then the two halves of
// each row in a fixed order; one part writes m0 + log(l) to lse_v / lse_t,
// more write l to their slice [z][direction] of `part` ([parts][2][n]).
template <int kChunkF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, 2)
sym_fwd_bf16_kernel(const bf16* __restrict__ v, const bf16* __restrict__ t,
                    const unsigned char* __restrict__ kv,
                    const unsigned char* __restrict__ kt, float s, float w,
                    float* __restrict__ lse_v, float* __restrict__ lse_t,
                    float* __restrict__ part, int n, int d, bool vec) {
  using C = Chunk<kChunkF>;
  extern __shared__ __align__(16) unsigned char smem_sym_fwd[];
  const int chunks = (d + kChunkF - 1) / kChunkF;
  bf16* sx = reinterpret_cast<bf16*>(smem_sym_fwd);  // candidate rows, 2 stages
  bf16* sa = sx + 2 * kRows * C::kLd;                // anchor rows, 2 stages
  float* skeep = reinterpret_cast<float*>(sa + (chunks > 1 ? 2 : 0) * kRows * C::kLd);
  float* sl = skeep + 2 * kRows;  // [half][row] partial sums

  const bool text = blockIdx.y != 0;
  const bf16* a = text ? t : v;
  const bf16* o = text ? v : t;
  const unsigned char* keep_a = text ? kt : kv;  // the anchors' modality
  const unsigned char* keep_o = text ? kv : kt;  // the other modality
  const int tiles = (n + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  const int t0 = z * tiles / parts, t1 = (z + 1) * tiles / parts;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 16 * (warp & 3);   // the warp's rows in the tile
  const int wc = 32 * (warp >> 2);  // its candidates in the logit tile
  const float m0 = fmaxf(fmaxf(s, w * s), 0.f);
  const float m0_log2 = m0 * kLog2e;

  // Issue the loads of stage st into buffer st & 1, and on a tile's first
  // chunk (pruned) the candidates' keep flags into stage tile & 1.
  const int stages = 2 * (t1 - t0) * chunks;
  auto issue = [&](int st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (t0 + (tile >> 1)) * kRows;
    const bool intra = tile & 1;
    if (chunks > 1)
      stage_tile<kChunkF>(sa + buf * kRows * C::kLd, a, r0, i * kChunkF, n, d,
                          vec);
    stage_tile<kChunkF>(sx + buf * kRows * C::kLd, intra ? a : o, c0,
                        i * kChunkF, n, d, vec);
    cp_async_commit();
    if constexpr (kPruned) {
      if (i == 0 && threadIdx.x < kRows) {
        const int col = c0 + threadIdx.x;
        skeep[(tile & 1) * kRows + threadIdx.x] =
            col < n && (intra ? keep_a : keep_o)[col] ? 1.f : 0.f;
      }
    }
  };

  uint32_t af[C::kSteps][4];
  if (chunks == 1) {  // the anchor fragments, once, through buffer 1
    stage_tile<kChunkF>(sx + kRows * C::kLd, a, r0, 0, n, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
      ldmatrix_x4(af[ks], ld_a<C::kLd>(sx + (kRows + wr) * C::kLd + 16 * ks, lane));
  }
  issue(0);  // buffer 0; buffer 1 is next written after stage 0's barrier

  float l[2] = {0.f, 0.f};  // this lane's sums of rows wr + g, wr + g + 8
  float sc[4][4];
  for (int st = 0; st < stages; ++st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (t0 + (tile >> 1)) * kRows;
    const bool intra = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage st has landed; stage st - 1's readers are done
    if (st + 1 < stages) issue(st + 1);
    const bf16* xt = sx + buf * kRows * C::kLd;
    if (chunks > 1) {
      const bf16* at = sa + buf * kRows * C::kLd;
#pragma unroll
      for (int ks = 0; ks < C::kSteps; ++ks)
        ldmatrix_x4(af[ks], ld_a<C::kLd>(at + wr * C::kLd + 16 * ks, lane));
    }
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    }
    // S = A X^T over the chunk, each 16-feature step from zero and added
    // in fp32 (acc_add)
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
      logit_step<C::kLd>(sc, af[ks], xt, wc, ks, lane);
    if (i + 1 < chunks) continue;
    // element e of tile j: row wr + g + 8 (e / 2), candidate wc + 8 j +
    // 2 tq + e % 2; the columns past n dropped
    const float zs = (intra ? w * s : s) * kLog2e;
    const bool diag = intra && c0 == r0, edge = c0 + kRows > n;
    const float* kc = skeep + (tile & 1) * kRows;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + 8 * (e >> 1);
        const int cl = wc + 8 * j + 2 * tq + (e & 1);
        float x = fmaf(sc[j][e], zs, -m0_log2);
        bool keep = !(edge && c0 + cl >= n);
        if constexpr (kPruned) {
          // the positive always kept, the self column dropped
          const bool self = c0 + cl == r0 + rl;
          keep = keep && (intra ? (kc[cl] != 0.f && !self) : (kc[cl] != 0.f || self));
        } else {
          if (diag && cl == rl) x = -m0_log2;  // the zeroed (not dropped) self logit
        }
        l[e >> 1] += keep ? exp2f(x) : 0.f;
      }
  }
  // the quad's sums, then the two halves of each row, in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tq == 0) sl[(warp >> 2) * kRows + wr + g + 8 * r] = l[r];
  }
  __syncthreads();
  const int row = r0 + threadIdx.x;
  if (threadIdx.x < kRows && row < n) {
    const float sum = sl[threadIdx.x] + sl[kRows + threadIdx.x];
    if (parts == 1)
      (text ? lse_t : lse_v)[row] = m0 + logf(sum);
    else
      part[((size_t)2 * z + (text ? 1 : 0)) * n + row] = sum;
  }
}

// lse_v, lse_t = m0 + log(part[0] + part[1] + ... ), in index order
__global__ void __launch_bounds__(kThreads)
sym_fwd_sum_kernel(const float* __restrict__ part, int parts, float s, float w,
                   float* __restrict__ lse_v, float* __restrict__ lse_t, int n) {
  const float m0 = fmaxf(fmaxf(s, w * s), 0.f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < 2 * n;
       i += gridDim.x * kThreads) {
    float acc = part[i];
    for (int z = 1; z < parts; ++z) acc += part[(size_t)2 * n * z + i];
    if (i < n)
      lse_v[i] = m0 + logf(acc);
    else
      lse_t[i - n] = m0 + logf(acc);
  }
}

// ---------------------------------------------------------------------------
// dual forward, bf16 features: tensor cores (loss_mma.cuh)
// ---------------------------------------------------------------------------

// Block (x, y, z): anchor rows [64 x, 64 x + 64) of direction y (0: video
// anchors, candidates T then V; 1: text anchors, candidates V then T, the
// keep masks swapped with them), the candidate tiles of part z of
// gridDim.z, at the scale *scale_ptr (read once per block): loss_mma.cuh's
// online-logsumexp block, whose grid, staging and keep tests are
// sym_fwd_bf16_kernel's, except that where d takes two chunks (256 < d <=
// 512) both anchor chunks stay in shared memory for the whole loop.  One
// part writes ln 2 · (m + log2 l) to lse_v / lse_t, more write m and l to
// their slices [z][direction] of `part` ([2][parts][2][n]: every m, then
// every l).
template <int kChunkF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, 2)
dual_fwd_bf16_kernel(const bf16* __restrict__ v, const bf16* __restrict__ t,
                     const unsigned char* __restrict__ kv,
                     const unsigned char* __restrict__ kt,
                     const float* __restrict__ scale_ptr, float w,
                     float* __restrict__ lse_v, float* __restrict__ lse_t,
                     float* __restrict__ part, int n, int d, bool vec) {
  const bool text = blockIdx.y != 0;
  const int tiles = (n + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  fwd_block<kChunkF, kPruned>(
      text ? t : v, text ? v : t, text ? kt : kv, text ? kv : kt, *scale_ptr, w,
      n, d, vec, blockIdx.x * kRows, z * tiles / parts, (z + 1) * tiles / parts,
      [&](int row, float mm, float sum) {
        if (parts == 1) {
          (text ? lse_t : lse_v)[row] = kLn2 * (mm + log2f(sum));
        } else {
          const size_t at = ((size_t)2 * z + (text ? 1 : 0)) * n + row;
          part[at] = mm;
          part[(size_t)2 * parts * n + at] = sum;
        }
      });
}

// lse_v, lse_t from the parts' (m, l), merged in index order (merge_parts)
__global__ void __launch_bounds__(kThreads)
dual_fwd_merge_kernel(const float* __restrict__ part, int parts,
                      float* __restrict__ lse_v, float* __restrict__ lse_t,
                      int n) {
  const size_t each = 2 * (size_t)n;
  const float* pl = part + parts * each;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < 2 * n;
       i += gridDim.x * kThreads) {
    const float lse = merge_parts(part + i, pl + i, each, parts);
    if (i < n)
      lse_v[i] = lse;
    else
      lse_t[i - n] = lse;
  }
}

// ---------------------------------------------------------------------------
// sym and dual backwards, bf16 features: tensor cores (loss_mma.cuh)
// ---------------------------------------------------------------------------

// Block (x, y, z): anchor rows [64 x, 64 x + 64) of direction y / chunks
// (0: video anchors, candidates T then V; 1: text anchors, candidates V
// then T, the keep masks swapped with them), gradient features of chunk
// y % chunks, and the candidate tiles of part z of gridDim.z.  One part
// writes s · the gradient rows to dv / dt; more write each part's fp32
// sum to its slice [z][direction] of `part` ([parts][2][n][d]), which
// bwd_sum_kernel adds in index order.
template <int kWarpF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, kWarpF <= 32 ? 2 : 1)
sym_bwd_bf16_kernel(const bf16* __restrict__ v, const bf16* __restrict__ t,
                    const unsigned char* __restrict__ kv,
                    const unsigned char* __restrict__ kt, float s, float w,
                    const float* __restrict__ lse_v,
                    const float* __restrict__ lse_t,
                    const float* __restrict__ g_v, const float* __restrict__ g_t,
                    float* __restrict__ dv, float* __restrict__ dt,
                    float* __restrict__ part, int n, int d, bool vec) {
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const bool text = (int)blockIdx.y >= chunks;
  const int tiles = (n + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  float* out = parts == 1 ? (text ? dt : dv)
                          : part + (size_t)(2 * z + (text ? 1 : 0)) * n * d;
  bwd_block<kWarpF, true, kPruned>(
      text ? t : v, text ? v : t, text ? kt : kv, text ? kv : kt, s, w,
      text ? lse_t : lse_v, text ? lse_v : lse_t, text ? g_t : g_v,
      text ? g_v : g_t, out, parts == 1 ? s : 1.f, n, d, vec,
      blockIdx.x * kRows, blockIdx.y - (text ? chunks : 0), z * tiles / parts,
      (z + 1) * tiles / parts);
}

// The Hopper sym backward (loss_wgmma.cuh): block (x, y, z) takes anchor
// rows [128 x, 128 x + 128) of direction y / chunks (the keep masks swapped
// with the roles as above), gradient features [256 (y % chunks), + 256) and
// the candidate tiles (kCand rows) of part z of gridDim.z; one part writes
// s · the gradient rows to dv / dt, more write each part's fp32 sum to its
// slice [z][direction] of `part`, which bwd_sum_kernel adds in index order.
template <bool kPruned, int kCand>
__global__ void __launch_bounds__(loss_wgmma::kThreadsW, 1)
sym_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_t,
                     const unsigned char* __restrict__ kv,
                     const unsigned char* __restrict__ kt, float s, float w,
                     const float* __restrict__ lse_v,
                     const float* __restrict__ lse_t,
                     const float* __restrict__ g_v, const float* __restrict__ g_t,
                     float* __restrict__ dv, float* __restrict__ dt,
                     float* __restrict__ part, int n, int d, int stages) {
  using namespace loss_wgmma;
  const int chunks = (d + kOutF - 1) / kOutF;
  const bool text = (int)blockIdx.y >= chunks;
  const int tiles = (n + kCand - 1) / kCand, parts = gridDim.z, z = blockIdx.z;
  float* out = parts == 1 ? (text ? dt : dv)
                          : part + (size_t)(2 * z + (text ? 1 : 0)) * n * d;
  sym_bwd_block<kPruned, kCand>(
      text ? &map_t : &map_v, text ? &map_v : &map_t, text ? kt : kv,
      text ? kv : kt, s, w, text ? lse_t : lse_v, text ? lse_v : lse_t,
      text ? g_t : g_v, text ? g_v : g_t, out, parts == 1 ? s : 1.f, n, d,
      blockIdx.x * kRowsW, blockIdx.y - (text ? chunks : 0), z * tiles / parts,
      (z + 1) * tiles / parts, stages);
}

// The dual backward: the block of sym_bwd_bf16_kernel (the same grid and
// `part`) in the subtract-first form at the scale *scale_ptr, and the
// block's share of Σ coeff⊙z in ds_part[(2 z + direction) · gridDim.x + x]
// from the blocks of feature chunk 0: the inter logits through the
// video-anchor blocks only (the text-anchor blocks' are their transposes),
// each intra logit half through either of its two anchors' blocks.  Its
// row lse, Σ coeff⊙z and scale take the 32-feature build past the 128
// registers that two blocks per SM leave a thread (it spilled 32 B there),
// so every width runs one block per SM.
template <int kWarpF, bool kPruned>
__global__ void __launch_bounds__(kMmaThreads, 1)
dual_bwd_bf16_kernel(const bf16* __restrict__ v, const bf16* __restrict__ t,
                     const unsigned char* __restrict__ kv,
                     const unsigned char* __restrict__ kt,
                     const float* __restrict__ scale_ptr, float w,
                     const float* __restrict__ lse_v,
                     const float* __restrict__ lse_t,
                     const float* __restrict__ g_v, const float* __restrict__ g_t,
                     float* __restrict__ dv, float* __restrict__ dt,
                     float* __restrict__ part, float* __restrict__ ds_part,
                     int n, int d, bool vec) {
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const bool text = (int)blockIdx.y >= chunks;
  const int fc = blockIdx.y - (text ? chunks : 0);
  const int tiles = (n + kRows - 1) / kRows, parts = gridDim.z, z = blockIdx.z;
  const float s = *scale_ptr;
  float* out = parts == 1 ? (text ? dt : dv)
                          : part + (size_t)(2 * z + (text ? 1 : 0)) * n * d;
  float* ds_out =
      fc == 0 ? ds_part + (size_t)(2 * z + (text ? 1 : 0)) * gridDim.x + blockIdx.x
              : nullptr;
  bwd_block<kWarpF, false, kPruned, true>(
      text ? t : v, text ? v : t, text ? kt : kv, text ? kv : kt, s, w,
      text ? lse_t : lse_v, text ? lse_v : lse_t, text ? g_t : g_v,
      text ? g_v : g_t, out, parts == 1 ? s : 1.f, n, d, vec,
      blockIdx.x * kRows, fc, z * tiles / parts, (z + 1) * tiles / parts,
      text ? 0.f : 1.f, ds_out);
}

// dv, dt = s · (part[0] + part[1] + ... ), in index order; s = *scale_ptr
// where given, else scale_arg
__global__ void __launch_bounds__(kThreads)
bwd_sum_kernel(const float* __restrict__ part, int parts,
               const float* __restrict__ scale_ptr, float scale_arg,
               float* __restrict__ dv, float* __restrict__ dt, size_t nd) {
  const float s = scale_ptr != nullptr ? *scale_ptr : scale_arg;
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < 2 * nd;
       i += (size_t)gridDim.x * kThreads) {
    float acc = part[i];
    for (int z = 1; z < parts; ++z) acc += part[2 * nd * z + i];
    if (i < nd)
      dv[i] = s * acc;
    else
      dt[i - nd] = s * acc;
  }
}

cudaError_t launch_bwd_sum(const float* part, int parts, const float* scale_ptr,
                           float scale, float* dv, float* dt, size_t nd,
                           cudaStream_t stream) {
  const size_t blocks = (2 * nd + kThreads - 1) / kThreads;
  bwd_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      part, parts, scale_ptr, scale, dv, dt, nd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch plans of the bf16 kernels
// ---------------------------------------------------------------------------

template <int kChunkF, bool kPruned>
cudaError_t sym_fwd_plan(int n, int d, Plan* plan) {
  const int chunks = (d + kChunkF - 1) / kChunkF;
  return split_plan(reinterpret_cast<const void*>(sym_fwd_bf16_kernel<kChunkF, kPruned>),
                    sym_fwd_smem_bytes<kChunkF>(chunks),
                    sym_fwd_smem_bytes<kChunkF>(2), row_tiles(n),
                    2 * row_tiles(n), plan);
}

template <int kChunkF, bool kPruned>
cudaError_t dual_fwd_plan(int n, int d, Plan* plan) {
  const int chunks = (d + kChunkF - 1) / kChunkF;
  return split_plan(reinterpret_cast<const void*>(dual_fwd_bf16_kernel<kChunkF, kPruned>),
                    fwd_mma_smem_bytes<kChunkF>(chunks),
                    fwd_mma_smem_bytes<kChunkF>(2), row_tiles(n),
                    2 * row_tiles(n), plan);
}

// kDual: dual_bwd_bf16_kernel, else sym_bwd_bf16_kernel
template <int kWarpF, bool kPruned, bool kDual>
cudaError_t bwd_plan(int n, int d, Plan* plan) {
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const void* fn;
  if constexpr (kDual)
    fn = reinterpret_cast<const void*>(dual_bwd_bf16_kernel<kWarpF, kPruned>);
  else
    fn = reinterpret_cast<const void*>(sym_bwd_bf16_kernel<kWarpF, kPruned>);
  return split_plan(fn, bwd_mma_smem_bytes<kWarpF>(chunks),
                    bwd_mma_smem_bytes<kWarpF>(2), row_tiles(n),
                    2 * chunks * row_tiles(n), plan);
}

template <int kChunkF, bool kPruned>
cudaError_t launch_sym_fwd_bf16(const void* v, const void* t, const void* kv,
                                const void* kt, float s, float w, float* lse_v,
                                float* lse_t, float* part, int n, int d,
                                cudaStream_t stream) {
  Plan plan;
  cudaError_t err = sym_fwd_plan<kChunkF, kPruned>(n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  const bool vec = d % 8 == 0 && aligned16(v) && aligned16(t);
  const dim3 grid(row_tiles(n), 2, plan.parts);
  sym_fwd_bf16_kernel<kChunkF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(t),
      static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), s, w, lse_v, lse_t, part, n, d,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  const int blocks = (2 * n + kThreads - 1) / kThreads;
  sym_fwd_sum_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0, stream>>>(
      part, plan.parts, s, w, lse_v, lse_t, n);
  return cudaGetLastError();
}

template <int kChunkF, bool kPruned>
cudaError_t launch_dual_fwd_bf16(const void* v, const void* t, const void* kv,
                                 const void* kt, const float* scale, float w,
                                 float* lse_v, float* lse_t, float* part, int n,
                                 int d, cudaStream_t stream) {
  Plan plan;
  cudaError_t err = dual_fwd_plan<kChunkF, kPruned>(n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  const bool vec = d % 8 == 0 && aligned16(v) && aligned16(t);
  const dim3 grid(row_tiles(n), 2, plan.parts);
  dual_fwd_bf16_kernel<kChunkF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(t),
      static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), scale, w, lse_v, lse_t, part, n, d,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  const int blocks = (2 * n + kThreads - 1) / kThreads;
  dual_fwd_merge_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0, stream>>>(
      part, plan.parts, lse_v, lse_t, n);
  return cudaGetLastError();
}

template <int kWarpF, bool kPruned>
cudaError_t launch_sym_bwd_bf16(const void* v, const void* t, const void* kv,
                                const void* kt, float s, float w,
                                const float* lse_v, const float* lse_t,
                                const float* g_v, const float* g_t, float* dv,
                                float* dt, float* part, int n, int d,
                                cudaStream_t stream) {
  Plan plan;
  cudaError_t err = bwd_plan<kWarpF, kPruned, false>(n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const bool vec = d % 8 == 0 && aligned16(v) && aligned16(t);
  const dim3 grid(row_tiles(n), 2 * chunks, plan.parts);
  sym_bwd_bf16_kernel<kWarpF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(t),
      static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), s, w, lse_v, lse_t, g_v, g_t, dv,
      dt, part, n, d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  return launch_bwd_sum(part, plan.parts, nullptr, s, dv, dt, (size_t)n * d,
                        stream);
}

// The shapes the Hopper sym backward takes (TMA: d % 8 == 0 and 16-byte
// aligned bases; the anchor tile and two stages in shared memory: d <=
// 384); the pointers are checked at launch.  Every n: it was the faster at
// each shape timed, 1024 rows included (PERF.md, kernel table row 5).
bool wgmma_shape(int n, int d) {
  return n >= 1 && d % 8 == 0 && d <= loss_wgmma::kMaxBoxes * loss_wgmma::kBoxF;
}

bool wgmma_takes(int n, int d, const void* v, const void* t) {
  return wgmma_shape(n, d) && aligned16(v) && aligned16(t);
}

struct WgmmaPlan {
  size_t smem;
  int stages, parts;
};

// The Hopper sym backward's plan: its ring's stages and shared memory, and
// the parts its candidate tiles split into where its blocks (one an SM)
// leave SMs idle
template <bool kPruned, int kCand>
cudaError_t wgmma_plan(int n, int d, WgmmaPlan* plan) {
  using namespace loss_wgmma;
  int sms = 0;
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(sym_bwd_wgmma_kernel<kPruned, kCand>), &sms);
  if (err != cudaSuccess) return err;
  const int boxes = (d + kBoxF - 1) / kBoxF;
  const int chunks = (d + kOutF - 1) / kOutF;
  plan->stages = ring_stages(kCand, boxes);
  plan->smem = smem_bytes(kCand, boxes, plan->stages);
  const int blocks = 2 * chunks * ((n + kRowsW - 1) / kRowsW);
  plan->parts = split_parts((n + kCand - 1) / kCand, blocks, sms);
  return cudaSuccess;
}

// f(std::integral_constant<int, kCand>{}) for the Hopper sym backward's
// candidate rows at d (loss_wgmma::cand_rows); the pruned variant is built
// at 64 alone
template <bool kPruned, typename F>
cudaError_t by_cand(int d, F f) {
  if constexpr (!kPruned)
    if (loss_wgmma::cand_rows(d, false) == 128)
      return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 64>{});
}

template <bool kPruned, int kCand>
cudaError_t launch_sym_bwd_wgmma(const void* v, const void* t, const void* kv,
                                 const void* kt, float s, float w,
                                 const float* lse_v, const float* lse_t,
                                 const float* g_v, const float* g_t, float* dv,
                                 float* dt, float* part, int n, int d,
                                 cudaStream_t stream) {
  using namespace loss_wgmma;
  WgmmaPlan plan;
  cudaError_t err = wgmma_plan<kPruned, kCand>(n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  CUtensorMap map_v, map_t;
  err = tensor_map(&map_v, v, n, d, kCand);
  if (err == cudaSuccess) err = tensor_map(&map_t, t, n, d, kCand);
  if (err != cudaSuccess) return err;
  const int chunks = (d + kOutF - 1) / kOutF;
  const dim3 grid((n + kRowsW - 1) / kRowsW, 2 * chunks, plan.parts);
  sym_bwd_wgmma_kernel<kPruned, kCand><<<grid, kThreadsW, plan.smem, stream>>>(
      map_v, map_t, static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), s, w, lse_v, lse_t, g_v, g_t, dv,
      dt, part, n, d, plan.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.parts == 1) return err;
  return launch_bwd_sum(part, plan.parts, nullptr, s, dv, dt, (size_t)n * d,
                        stream);
}

template <int kWarpF, bool kPruned>
cudaError_t launch_dual_bwd_bf16(const void* v, const void* t, const void* kv,
                                 const void* kt, const float* scale, float w,
                                 const float* lse_v, const float* lse_t,
                                 const float* g_v, const float* g_t, float* dv,
                                 float* dt, float* part, float* ds_part,
                                 float* ds, int n, int d, cudaStream_t stream) {
  Plan plan;
  cudaError_t err = bwd_plan<kWarpF, kPruned, true>(n, d, &plan);
  if (err != cudaSuccess) return err;
  if (plan.parts > 1 && part == nullptr) return cudaErrorInvalidValue;
  constexpr int kChunkF = BwdTile<kWarpF>::kChunkF;
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const bool vec = d % 8 == 0 && aligned16(v) && aligned16(t);
  const dim3 grid(row_tiles(n), 2 * chunks, plan.parts);
  dual_bwd_bf16_kernel<kWarpF, kPruned><<<grid, kMmaThreads, plan.smem, stream>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(t),
      static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), scale, w, lse_v, lse_t, g_v, g_t,
      dv, dt, part, ds_part, n, d, vec);
  err = cudaGetLastError();
  if (err == cudaSuccess && plan.parts > 1)
    err = launch_bwd_sum(part, plan.parts, scale, 0.f, dv, dt, (size_t)n * d,
                         stream);
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(
      ds_part, plan.parts * 2 * row_tiles(n), ds);
  return cudaGetLastError();
}

enum PlanKind { kSymFwd, kDualFwd, kSymBwd, kDualBwd };

// The parts of a bf16 kernel's plan for (n, d, pruned) on the current
// device.
cudaError_t plan_parts(PlanKind kind, int n, int d, bool pruned, int* parts) {
  Plan plan{0, 1};
  const cudaError_t err = by_pruned(pruned, [&](auto p) {
    constexpr bool kPruned = decltype(p)::value;
    if (kind == kSymFwd || kind == kDualFwd)
      return by_chunk(d, [&](auto chunk) {
        constexpr int kChunkF = decltype(chunk)::value;
        return kind == kSymFwd ? sym_fwd_plan<kChunkF, kPruned>(n, d, &plan)
                               : dual_fwd_plan<kChunkF, kPruned>(n, d, &plan);
      });
    return by_width(d, [&](auto width) {
      constexpr int kWarpF = decltype(width)::value;
      return kind == kSymBwd ? bwd_plan<kWarpF, kPruned, false>(n, d, &plan)
                             : bwd_plan<kWarpF, kPruned, true>(n, d, &plan);
    });
  });
  *parts = plan.parts;
  return err;
}

// per part: `each` floats of scratch where the bf16 plan splits, else 0; a
// negative value is a cudaError_t, negated.  A shape the Hopper sym
// backward takes names the larger of its plan's and the mma.sync block's
// (which an unaligned base takes instead)
long long split_scratch(PlanKind kind, int dtype, int n, int d, int pruned,
                        long long each) {
  if (dtype != 1 || n < 1 || d < 1) return 0;
  int parts = 1;
  cudaError_t err = plan_parts(kind, n, d, pruned != 0, &parts);
  if (err == cudaSuccess && kind == kSymBwd && wgmma_shape(n, d)) {
    WgmmaPlan plan{0, 0, 1};
    err = by_pruned(pruned != 0, [&](auto p) {
      constexpr bool kPruned = decltype(p)::value;
      return by_cand<kPruned>(d, [&](auto cand) {
        return wgmma_plan<kPruned, decltype(cand)::value>(n, d, &plan);
      });
    });
    parts = plan.parts > parts ? plan.parts : parts;
  }
  if (err != cudaSuccess) return -(long long)err;
  return parts > 1 ? parts * each : 0;
}

size_t bwd_smem_bytes(int d) {
  const int dc = d < kOutChunk ? d : kOutChunk;
  return sizeof(float) *
         (2 * kChunk * kLd + kTile * kLd + 3 * kTile + kTile * out_ld(dc));
}

template <typename T, bool kOnline, bool kPruned>
cudaError_t launch_fwd(const void* v, const void* t, const void* kv,
                       const void* kt, const float* scale_ptr, float scale,
                       float w, float* lse_v, float* lse_t, int n, int d,
                       cudaStream_t stream) {
  const dim3 grid(row_tiles(n), 2);
  lse_fwd_kernel<T, kOnline, kPruned><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(t),
      static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), scale_ptr, scale, w, lse_v, lse_t,
      n, d);
  return cudaGetLastError();
}

template <typename T, bool kTraced, bool kPruned>
cudaError_t launch_bwd(const void* v, const void* t, const void* kv,
                       const void* kt, const float* scale_ptr, float scale,
                       float w, const float* lse_v, const float* lse_t,
                       const float* g_v, const float* g_t, float* dv,
                       float* dt, float* ds_part, int n, int d,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      lse_bwd_kernel<T, kTraced, kPruned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles(n), 2, (d + kOutChunk - 1) / kOutChunk);
  lse_bwd_kernel<T, kTraced, kPruned><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(t),
      static_cast<const unsigned char*>(kv),
      static_cast<const unsigned char*>(kt), scale_ptr, scale, w, lse_v, lse_t,
      g_v, g_t, dv, dt, ds_part, n, d);
  return cudaGetLastError();
}

// Both keep masks or neither.
bool bad_args(int dtype, const void* kv, const void* kt, int n, int d) {
  return n < 1 || d < 1 || (dtype != 0 && dtype != 1) ||
         (kv == nullptr) != (kt == nullptr);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (v, t); keep_v, keep_t: bool [n] (both,
// or both null for the unpruned variant); every other array is float32:
// lse_*, g_* [n] (the [n, 1] columns), dv, dt [n, d], scale and ds [1].
// Each function returns a cudaError_t; launches are asynchronous on `stream`.
// The bf16 builds split their candidates where n leaves the card idle:
// their float32 scratch `part` holds crossclr_<kernel>_scratch(dtype, n, d,
// pruned) values (0: none needed, pass null; negative: a cudaError_t,
// negated), sized from the plan on the current device.

extern "C" long long crossclr_sym_fwd_scratch(int dtype, int n, int d,
                                              int pruned) {
  return split_scratch(kSymFwd, dtype, n, d, pruned, 2LL * n);
}

extern "C" int crossclr_sym_fwd(int dtype, const void* v, const void* t,
                                const void* keep_v, const void* keep_t,
                                void* lse_v, void* lse_t, void* part, int n,
                                int d, float scale, float w, void* stream) {
  if (bad_args(dtype, keep_v, keep_t, n, d)) return (int)cudaErrorInvalidValue;
  float* lv = static_cast<float*>(lse_v);
  float* lt = static_cast<float*>(lse_t);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_v != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0)
      return launch_fwd<float, false, kPruned>(v, t, keep_v, keep_t, nullptr,
                                               scale, w, lv, lt, n, d, st);
    return by_chunk(d, [&](auto chunk) {
      return launch_sym_fwd_bf16<decltype(chunk)::value, kPruned>(
          v, t, keep_v, keep_t, scale, w, lv, lt, pt, n, d, st);
    });
  });
}

extern "C" long long crossclr_dual_fwd_scratch(int dtype, int n, int d,
                                               int pruned) {
  return split_scratch(kDualFwd, dtype, n, d, pruned, 4LL * n);
}

extern "C" int crossclr_dual_fwd(int dtype, const void* v, const void* t,
                                 const void* keep_v, const void* keep_t,
                                 const void* scale, void* lse_v, void* lse_t,
                                 void* part, int n, int d, float w,
                                 void* stream) {
  if (bad_args(dtype, keep_v, keep_t, n, d)) return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  float* lv = static_cast<float*>(lse_v);
  float* lt = static_cast<float*>(lse_t);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_v != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0)
      return launch_fwd<float, true, kPruned>(v, t, keep_v, keep_t, sp, 0.f, w,
                                              lv, lt, n, d, st);
    return by_chunk(d, [&](auto chunk) {
      return launch_dual_fwd_bf16<decltype(chunk)::value, kPruned>(
          v, t, keep_v, keep_t, sp, w, lv, lt, pt, n, d, st);
    });
  });
}

extern "C" long long crossclr_sym_bwd_scratch(int dtype, int n, int d,
                                              int pruned) {
  return split_scratch(kSymBwd, dtype, n, d, pruned, 2LL * n * d);
}

extern "C" int crossclr_sym_bwd(int dtype, const void* v, const void* t,
                                const void* keep_v, const void* keep_t,
                                const void* lse_v, const void* lse_t,
                                const void* g_v, const void* g_t, void* dv,
                                void* dt, void* part, int n, int d,
                                float scale, float w, void* stream) {
  if (bad_args(dtype, keep_v, keep_t, n, d)) return (int)cudaErrorInvalidValue;
  const float* lv = static_cast<const float*>(lse_v);
  const float* lt = static_cast<const float*>(lse_t);
  const float* gv = static_cast<const float*>(g_v);
  const float* gt = static_cast<const float*>(g_t);
  float* ov = static_cast<float*>(dv);
  float* ot = static_cast<float*>(dt);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_v != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0)
      return launch_bwd<float, false, kPruned>(
          v, t, keep_v, keep_t, nullptr, scale, w, lv, lt, gv, gt, ov, ot,
          nullptr, n, d, st);
    if (wgmma_takes(n, d, v, t))
      return by_cand<kPruned>(d, [&](auto cand) {
        return launch_sym_bwd_wgmma<kPruned, decltype(cand)::value>(
            v, t, keep_v, keep_t, scale, w, lv, lt, gv, gt, ov, ot, pt, n, d, st);
      });
    return by_width(d, [&](auto width) {
      return launch_sym_bwd_bf16<decltype(width)::value, kPruned>(
          v, t, keep_v, keep_t, scale, w, lv, lt, gv, gt, ov, ot, pt, n, d,
          st);
    });
  });
}

// 1 where crossclr_sym_bwd runs the Hopper design for these features, else
// 0 (the float32 build, the mma.sync block)
extern "C" int crossclr_sym_bwd_wgmma(int dtype, const void* v, const void* t,
                                      int n, int d) {
  return dtype == 1 && wgmma_takes(n, d, v, t) ? 1 : 0;
}

// The float32 scratch `ds_part` holds crossclr_dual_bwd_partials(dtype, n,
// d, pruned) values (one per block that sums Σ coeff⊙z; negative: a
// cudaError_t, negated); `ds` receives Σ coeff⊙z (= scale · d loss /
// d scale).
extern "C" long long crossclr_dual_bwd_partials(int dtype, int n, int d,
                                                int pruned) {
  if (dtype != 1 || n < 1 || d < 1) return 2LL * row_tiles(n < 1 ? 1 : n);
  int parts = 1;
  const cudaError_t err = plan_parts(kDualBwd, n, d, pruned != 0, &parts);
  if (err != cudaSuccess) return -(long long)err;
  return 2LL * parts * row_tiles(n);
}

extern "C" long long crossclr_dual_bwd_scratch(int dtype, int n, int d,
                                               int pruned) {
  return split_scratch(kDualBwd, dtype, n, d, pruned, 2LL * n * d);
}

extern "C" int crossclr_dual_bwd(int dtype, const void* v, const void* t,
                                 const void* keep_v, const void* keep_t,
                                 const void* scale, const void* lse_v,
                                 const void* lse_t, const void* g_v,
                                 const void* g_t, void* dv, void* dt,
                                 void* part, void* ds_part, void* ds, int n,
                                 int d, float w, void* stream) {
  if (bad_args(dtype, keep_v, keep_t, n, d)) return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scale);
  const float* lv = static_cast<const float*>(lse_v);
  const float* lt = static_cast<const float*>(lse_t);
  const float* gv = static_cast<const float*>(g_v);
  const float* gt = static_cast<const float*>(g_t);
  float* ov = static_cast<float*>(dv);
  float* ot = static_cast<float*>(dt);
  float* pt = static_cast<float*>(part);
  float* dp = static_cast<float*>(ds_part);
  float* out = static_cast<float*>(ds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_pruned(keep_v != nullptr, [&](auto pruned) {
    constexpr bool kPruned = decltype(pruned)::value;
    if (dtype == 0) {
      const cudaError_t err = launch_bwd<float, true, kPruned>(
          v, t, keep_v, keep_t, sp, 0.f, w, lv, lt, gv, gt, ov, ot, dp, n, d,
          st);
      if (err != cudaSuccess) return err;
      sum_partials_kernel<<<1, kThreads, 0, st>>>(dp, 2 * row_tiles(n), out);
      return cudaGetLastError();
    }
    return by_width(d, [&](auto width) {
      return launch_dual_bwd_bf16<decltype(width)::value, kPruned>(
          v, t, keep_v, keep_t, sp, w, lv, lt, gv, gt, ov, ot, pt, dp, out, n,
          d, st);
    });
  });
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
