// One direction of the CrossCLR-intra logsumexp and its anchor gradient for
// Hopper (sm_90a), with a plain C interface: the forward, and the backward
// in two builds.
//
// Replaces the TPU kernels of crossclr_tpu/ops/fused_crossclr.py:
//   crossclr_direction_fwd  <- _lse_fwd_kernel  (one direction's online lse)
//   crossclr_direction_bwd  <- _lse_bwd_kernel  (that direction's anchor
//                                                 gradient)
// The JAX package runs them for a static τ past the dual kernels' column
// accumulator budget, B·lane_pad(D)·4 > 48 MiB (crossclr_tpu/ops/
// fused_dual.py:78-85); the port keeps that boundary as its route rule
// (ops/fused_crossclr.py).  These kernels hold no [B, D] scratch.
//
// The math, for L2-normalized anchors A and other features O [n, d], scale
// s = 1/τ and weight w:
//   lse[i] = log( Σ_j exp(s·a_i·o_j) + Σ_j exp(w·s·a_i·a_j) ),
// with the intra logit of j = i ZEROED (its exp(0) = 1 stays in the sum, as
// in the released reference loss).  The backward takes the anchors' lse_a,
// the other direction's lse_o (anchored on O) and their cotangents g_a,
// g_o, and returns the gradient of Σ g_a·lse_a + Σ g_o·lse_o with respect
// to A:
//   P[i,j] = g_a[i]·e^{z_ao[i,j] - lse_a[i]} + g_o[j]·e^{z_ao[i,j] - lse_o[j]},
//   Q[i,j] = g_a[i]·e^{z_aa[i,j] - lse_a[i]} + g_a[j]·e^{z_aa[i,j] - lse_a[j]},
//            0 on the diagonal (a zeroed logit is a constant),
//   dA = s·(P·O + w·Q·A).
// The caller runs each kernel twice, (A, O) = (V, T) and (T, V), with the
// roles and cotangents swapped.  kFactored computes each coefficient as
// exp(z)·(g_a e^{-lse_a} + g_o e^{-lse_o}), one exp of the raw logit, where
// the JAX gate allows it (0 < s < 80 and 0 <= w·s < 80, strict;
// fused_crossclr.py:327); otherwise it subtracts first.  The build keeps
// subnormals (no -ftz): at s near 80 and large n, e^{-lse} is subnormal,
// and the factored coefficient keeps what a TPU flushes to 0.
//
// Design: owner-computes, as in fused_dual.cu.  A block owns one 64-row
// tile of anchors and loops over every 64-row candidate tile itself,
// recomputing the logits it needs.  Every output element has one writer
// and every sum a fixed order: no atomics, runs are bit-reproducible.
// Edges of n and d are masked, so any n and d run unpadded; indices past
// 2^31 are formed in size_t, and the diagonal is found as row == col.
//
// The forward, and the backward's fp32 build (the `highest` tier): the
// tiles of loss_tiles.cuh, shared with fused_dual.cu, 64 x 64 logit
// products over d in 32-feature chunks with scalar fp32 FMAs.  The forward
// keeps a running max and sum per row (the TPU kernel carries them across
// its sequential grid in VMEM scratch); the backward keeps its gradient
// rows [64, <= 512 features] in shared memory and adds coefficient-tile x
// candidate-tile products into them, wider features split over
// blockIdx.y, each y recomputing the logits.  The forward does 2·n²·d
// FMAs, the backward 4·n²·d, where the function needs 1.5 and 3.5
// products of n²·d (A·Aᵀ is symmetric, so one triangle suffices;
// chip_smoke.py's bound counts that): bound by instruction issue and
// shared-memory traffic.
//
// The backward's bf16 build (direction_bwd_bf16_kernel, the `default`
// tier the large-batch leg runs): the four products on tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators; mma_common.cuh).
// At n = 65,536, d = 256 it does 3.5 products of 2·n²·d against 67 MB of
// features, far past the card's ~295 operations per byte: the operations
// bound it.  A block of 8 warps owns 64 anchor rows and up to 256 gradient
// features (wider d over blockIdx.y):
//   * the anchor rows stay in shared memory (one 256-feature chunk; wider
//     d restages its chunks per candidate tile), and each 64-row candidate
//     tile of O, then of A, is staged by 16-byte cp.async into a double
//     buffer, the next tile's loads in flight while this one computes, rows
//     padded by 16 bytes for conflict-free ldmatrix;
//   * each warp scores 16 anchors x 32 candidates by mma (A·Oᵀ or A·Aᵀ;
//     bf16 features are exact mma operands, so the logits equal the scalar
//     kernel's up to the order of the sums) and forms their coefficients in
//     fp32 registers with exactly the scalar kernel's arithmetic (the row
//     factors once per row, the candidate factors once per tile, the
//     diagonal test, the w multiplier), so the factored form meets a
//     subnormal g·e^{-lse} as the plain version does;
//   * the coefficient tile goes to shared memory as a bf16 hi part and the
//     bf16 rounding of the remainder (about 16 bits, as in the flash
//     kernels), and each warp adds hi·X + lo·X for its 16 rows x 128
//     features into fp32 accumulators in registers, the candidate tile X
//     read by ldmatrix.trans; the gradient rows never touch shared memory.
// The split doubles the coefficient products' mma count: 6 products of
// 2·n²·d issued where the bound counts 3.5 (A·Aᵀ's triangle is not shared).
// A warp's fp32 gradient tile (16 x 128 for d > 128) takes a thread past
// the 128 registers that two blocks per SM would leave it, so the block of
// 8 warps runs alone on its SM (for d <= 64, two blocks share one).

#include <math.h>
#include <stddef.h>

#include "loss_tiles.cuh"
#include "mma_common.cuh"

namespace {

using namespace loss_tiles;
using namespace tc;

// ---------------------------------------------------------------------------
// forward: one direction's lse for a 64-row anchor tile
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
direction_fwd_kernel(const T* __restrict__ a, const T* __restrict__ o,
                     float s, float w, float* __restrict__ lse, int n, int d) {
  __shared__ __align__(16) float sx[kChunk * kLd];
  __shared__ __align__(16) float sy[kChunk * kLd];
  const float ws = w * s;
  const int r0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegFloor;
    l[r] = 0.f;
  }
  float acc[4][4];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    for (int part = 0; part < 2; ++part) {
      const bool intra = part == 1;
      tile_dot(a, r0, intra ? a : o, c0, n, d, sx, sy, acc);
      const float zs = intra ? ws : s;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * ty + r;
        float z[4];
        float tmax = kNegFloor;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 4 * tx + c;
          // the zeroed (not dropped) self-similarity logit
          z[c] = (intra && row == col) ? 0.f : zs * acc[r][c];
          if (col < n) tmax = fmaxf(tmax, z[c]);
        }
        const float mn = fmaxf(m[r], tmax);
        float add = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + 4 * tx + c < n) add += expf(z[c] - mn);
        l[r] = l[r] * expf(m[r] - mn) + add;
        m[r] = mn;
      }
    }
  }
  // a row's 16 partials live on 16 consecutive lanes of one warp
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
      m[r] = mn;
    }
    const int row = r0 + 4 * ty + r;
    if (tx == 0 && row < n) lse[row] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward: one direction's anchor gradient rows for a 64-row anchor tile
// ---------------------------------------------------------------------------

// kFactored = true: exp(z)·(g_a e^{-lse_a} + g_c e^{-lse_c}); false:
// g_a·exp(z - lse_a) + g_c·exp(z - lse_c).
template <typename T, bool kFactored>
__global__ void __launch_bounds__(kThreads)
direction_bwd_kernel(const T* __restrict__ a, const T* __restrict__ o,
                     float s, float w, const float* __restrict__ lse_a,
                     const float* __restrict__ lse_o,
                     const float* __restrict__ g_a,
                     const float* __restrict__ g_o, float* __restrict__ out,
                     int n, int d) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = blockIdx.y * kOutChunk;
  const int dc = min(kOutChunk, d - d0);
  const int ldo = out_ld(dc);
  float* sx = smem;                   // [kChunk][kLd]
  float* sy = sx + kChunk * kLd;      // [kChunk][kLd]; sx..sy = [kTile][kLd]
  float* sc = sy + kChunk * kLd;      // [kTile][kLd] coefficient tile
  float* scol_a = sc + kTile * kLd;   // [kTile] candidate factors
  float* scol_b = scol_a + kTile;     // [kTile]
  float* sout = scol_b + kTile;       // [kTile][ldo] gradient rows

  const int r0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  for (int i = threadIdx.x; i < kTile * ldo; i += kThreads) sout[i] = 0.f;
  // this thread's anchor-row factors
  float ra[4], rb[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    ra[r] = rb[r] = 0.f;
    if (row < n) {
      if constexpr (kFactored) {
        ra[r] = g_a[row] * expf(-lse_a[row]);
      } else {
        ra[r] = g_a[row];
        rb[r] = lse_a[row];
      }
    }
  }
  float acc[4][4];
  for (int c0 = 0; c0 < n; c0 += kTile) {
    for (int part = 0; part < 2; ++part) {
      const bool intra = part == 1;
      const T* cand = intra ? a : o;
      const float* g_c = intra ? g_a : g_o;
      const float* lse_c = intra ? lse_a : lse_o;
      tile_dot(a, r0, cand, c0, n, d, sx, sy, acc);
      if (threadIdx.x < kTile) {
        const int col = c0 + threadIdx.x;
        float fa = 0.f, fb = 0.f;
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
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * ty + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cl = 4 * tx + c;
          const int col = c0 + cl;
          const float z = zs * acc[r][c];
          float coef = 0.f;
          // a zeroed intra logit is a constant: no gradient
          if (row < n && col < n && !(intra && row == col)) {
            if constexpr (kFactored)
              coef = expf(z) * (ra[r] + scol_a[cl]);
            else
              coef = ra[r] * expf(z - rb[r]) +
                     scol_a[cl] * expf(z - scol_b[cl]);
          }
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
}

// ---------------------------------------------------------------------------
// backward, bf16 features: tensor cores (see the header)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // anchor rows per block = candidates per tile
constexpr int kBwdThreads = 256;  // 8 warps: 4 row groups x 2 halves
constexpr int kCoefLd = kRows + 8;  // bf16 per row of the coefficient tile

// kWarpF gradient features per warp; a block stages kChunkF = 2 kWarpF
// features of each row at a time, and owns that many gradient features.
template <int kWarpF>
struct BwdTile {
  static constexpr int kChunkF = 2 * kWarpF;
  static constexpr int kLd = kChunkF + 8;  // bf16 per shared row, 16 (2m + 1) B
  static constexpr int kSteps = kChunkF / 16;  // logit k-steps per chunk
  static constexpr int kN = kWarpF / 8;  // 8-wide gradient tiles per warp
};

// two stages of candidate rows, and two of anchor rows where d takes more
// than one chunk (else one, resident), the coefficient tile's hi and lo
// parts, two stages of candidate factors
template <int kWarpF>
size_t bwd_bf16_smem_bytes(int chunks) {
  using D = BwdTile<kWarpF>;
  return sizeof(bf16) * (size_t)((chunks > 1 ? 4 : 3) * kRows * D::kLd +
                                 2 * kRows * kCoefLd) +
         sizeof(float) * 4 * kRows;
}

// acc += t in fp32, rounded to nearest.  An mma does not round its sum as
// an fp32 add does, and a long chain of mma on one accumulator drifts: with
// the whole sum over the 131,072 candidates of the leg's n = 65,536 chained
// that way, the gradient left its limit on the card (2.5e-4 of the largest
// entry against 5e-5).  Short chains from zero, added here, do not.
__device__ __forceinline__ void acc_add(float acc[4], const float t[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// Stage features [f0, f0 + kChunkF) of rows [r0, r0 + 64) of a row-major
// [n, d] bf16 matrix into a shared tile of stride kLd.  Rows past n and
// features past d are zero.  `vec` (d % 8 == 0 and a 16-byte aligned
// base): 16-byte cp.async copies; otherwise element loads.
template <int kWarpF>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int r0,
                                           int f0, int n, int d, bool vec) {
  using D = BwdTile<kWarpF>;
  constexpr int kChunks = D::kChunkF / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kBwdThreads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 8;
      bf16* p = dst + r * D::kLd + c;
      if (r0 + r < n && f0 + c < d)
        cp_async16(p, src + (size_t)(r0 + r) * d + f0 + c);
      else
        *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * D::kChunkF; i += kBwdThreads) {
      const int r = i / D::kChunkF, c = i - r * D::kChunkF;
      dst[r * D::kLd + c] = (r0 + r < n && f0 + c < d)
                                ? src[(size_t)(r0 + r) * d + f0 + c]
                                : __float2bfloat16(0.f);
    }
  }
}

// Block (x, y): anchor rows [64 x, 64 x + 64), gradient features
// [kChunkF y, kChunkF (y + 1)).  Warp w: logits of rows 16 (w % 4) + [0, 16)
// over candidates 32 (w / 4) + [0, 32) of a tile; gradient rows
// 16 (w % 4) + [0, 16), features kWarpF (w / 4) + [0, kWarpF) of the chunk.
// The block walks stages st = (tile, part, chunk) in order, tile t holding
// candidates [64 t, 64 t + 64), part 0 the other features O and part 1 the
// anchors A; the loads of stage st + 1 go into the other buffer while
// stage st computes.  The gradient tile of the two wider builds (16 x 64
// and 16 x 128 fp32 a warp, beside the coefficients' A fragments) takes
// more than the 128 registers that two blocks per SM would leave a thread,
// so those builds run one block per SM.
template <int kWarpF, bool kFactored>
__global__ void __launch_bounds__(kBwdThreads, kWarpF <= 32 ? 2 : 1)
direction_bwd_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ o,
                          float s, float w, const float* __restrict__ lse_a,
                          const float* __restrict__ lse_o,
                          const float* __restrict__ g_a,
                          const float* __restrict__ g_o, float* __restrict__ out,
                          int n, int d, bool vec) {
  using D = BwdTile<kWarpF>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int chunks = (d + D::kChunkF - 1) / D::kChunkF;
  const int a_bufs = chunks > 1 ? 2 : 1;
  bf16* sx = reinterpret_cast<bf16*>(smem_bf16);  // candidate rows, 2 stages
  bf16* sa = sx + 2 * kRows * D::kLd;             // anchor rows, 1 or 2
  bf16* chi = sa + a_bufs * kRows * D::kLd;       // coefficients, bf16 hi
  bf16* clo = chi + kRows * kCoefLd;              // and lo parts
  float* scol_a = reinterpret_cast<float*>(clo + kRows * kCoefLd);
  float* scol_b = scol_a + 2 * kRows;             // candidate factors, 2 stages

  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 16 * (warp & 3);      // the warp's rows in the tile
  const int wc = 32 * (warp >> 2);     // its candidates in the logit tile
  const int wf = kWarpF * (warp >> 2);  // its gradient features in the chunk

  // Issue the loads of stage st into buffer st & 1: the candidate rows of
  // its chunk (the chunks run in the order that ends on this block's own,
  // whose candidate rows the gradient products read), the anchor rows of
  // the chunk where d takes more than one, and on a tile's first chunk the
  // candidates' factors.
  const int stages = 2 * ((n + kRows - 1) / kRows) * chunks;
  auto issue = [&](int st) {
    const int i = st % chunks, tile = st / chunks;
    const int c0 = (tile >> 1) * kRows, buf = st & 1;
    const bool intra = tile & 1;
    const int f0 = ((blockIdx.y + 1 + i) % chunks) * D::kChunkF;
    if (chunks > 1)
      stage_tile<kWarpF>(sa + buf * kRows * D::kLd, a, r0, f0, n, d, vec);
    stage_tile<kWarpF>(sx + buf * kRows * D::kLd, intra ? a : o, c0, f0, n, d,
                       vec);
    cp_async_commit();
    if (i == 0 && threadIdx.x < kRows) {
      const int col = c0 + threadIdx.x;
      const float* g_c = intra ? g_a : g_o;
      const float* lse_c = intra ? lse_a : lse_o;
      float fa = 0.f, fb = 0.f;
      if (col < n) {
        if constexpr (kFactored) {
          fa = g_c[col] * expf(-lse_c[col]);
        } else {
          fa = g_c[col];
          fb = lse_c[col];
        }
      }
      scol_a[(tile & 1) * kRows + threadIdx.x] = fa;
      scol_b[(tile & 1) * kRows + threadIdx.x] = fb;
    }
  };

  // this lane's anchor-row factors, rows wr + g and wr + g + 8
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wr + g + 8 * r;
    ra[r] = rb[r] = 0.f;
    if (row < n) {
      if constexpr (kFactored) {
        ra[r] = g_a[row] * expf(-lse_a[row]);
      } else {
        ra[r] = g_a[row];
        rb[r] = lse_a[row];
      }
    }
  }
  float acc[D::kN][4];
#pragma unroll
  for (int j = 0; j < D::kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // one chunk: the anchor rows stay resident, loaded with stage 0
  if (chunks == 1) stage_tile<kWarpF>(sa, a, r0, 0, n, d, vec);
  issue(0);
  float sc[4][4];
  for (int st = 0; st < stages; ++st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (tile >> 1) * kRows;
    const bool intra = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage st has landed; stage st - 1's readers are done
    if (st + 1 < stages) issue(st + 1);
    const bf16* xt = sx + buf * kRows * D::kLd;
    const bf16* at = sa + (chunks > 1 ? buf : 0) * kRows * D::kLd;
    // S = A X^T over the chunk: [16 rows, 32 candidates] per warp, each
    // 16-feature step from zero and added in fp32 (see acc_add)
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    }
#pragma unroll 4
    for (int ks = 0; ks < D::kSteps; ++ks) {
      uint32_t af[4], b[4];
      ldmatrix_x4(af, ld_a<D::kLd>(at + wr * D::kLd + 16 * ks, lane));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ldmatrix_x4(b, ld_b<D::kLd>(xt + (wc + 16 * h) * D::kLd + 16 * ks, lane));
        float t0[4] = {}, t1[4] = {};
        mma_bf16(t0, af, b[0], b[1]);
        mma_bf16(t1, af, b[2], b[3]);
        acc_add(sc[2 * h], t0);
        acc_add(sc[2 * h + 1], t1);
      }
    }
    if (i + 1 < chunks) continue;
    // the coefficients, with the scalar kernel's arithmetic; element e of
    // tile j: row wr + g + 8 (e / 2), candidate wc + 8 j + 2 tq + e % 2
    const float zs = intra ? w * s : s;
    const float* fa = scol_a + (tile & 1) * kRows;
    const float* fb = scol_b + (tile & 1) * kRows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wr + g + 8 * (e >> 1);
        const int cl = wc + 8 * j + 2 * tq + (e & 1);
        const int col = c0 + cl;
        const float z = zs * sc[j][e];
        float coef = 0.f;
        // a zeroed intra logit is a constant: no gradient
        if (row < n && col < n && !(intra && row == col)) {
          if constexpr (kFactored)
            coef = expf(z) * (ra[e >> 1] + fa[cl]);
          else
            coef = ra[e >> 1] * expf(z - rb[e >> 1]) + fa[cl] * expf(z - fb[cl]);
        }
        sc[j][e] = intra ? w * coef : coef;
      }
      // as a bf16 hi part and the bf16 rounding of the remainder
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = sc[j][2 * h], x1 = sc[j][2 * h + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        const int idx = (wr + g + 8 * h) * kCoefLd + wc + 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(chi + idx) = hi;
        *reinterpret_cast<uint32_t*>(clo + idx) = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
    }
    __syncthreads();  // the coefficient tile is whole
    // G += C X over the tile's 64 candidates, C as hi and lo A fragments,
    // X by ldmatrix.trans; each 16-feature tile's product from zero, then
    // added in fp32 (see acc_add)
    uint32_t ah[kRows / 16][4], al[kRows / 16][4];
#pragma unroll
    for (int kg = 0; kg < kRows / 16; ++kg) {
      ldmatrix_x4(ah[kg], ld_a<kCoefLd>(chi + wr * kCoefLd + 16 * kg, lane));
      ldmatrix_x4(al[kg], ld_a<kCoefLd>(clo + wr * kCoefLd + 16 * kg, lane));
    }
#pragma unroll
    for (int np = 0; np < kWarpF / 16; ++np) {
      float t0[4] = {}, t1[4] = {};
#pragma unroll
      for (int kg = 0; kg < kRows / 16; ++kg) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, ld_b_trans<D::kLd>(xt + 16 * kg * D::kLd + wf + 16 * np, lane));
        mma_bf16(t0, ah[kg], b[0], b[1]);
        mma_bf16(t0, al[kg], b[0], b[1]);
        mma_bf16(t1, ah[kg], b[2], b[3]);
        mma_bf16(t1, al[kg], b[2], b[3]);
      }
      acc_add(acc[2 * np], t0);
      acc_add(acc[2 * np + 1], t1);
    }
  }
  const int fbase = blockIdx.y * D::kChunkF + wf + 2 * tq;
#pragma unroll
  for (int j = 0; j < D::kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + wr + g + 8 * (e >> 1);
      const int f = fbase + 8 * j + (e & 1);
      if (row < n && f < d) out[(size_t)row * d + f] = s * acc[j][e];
    }
}

size_t bwd_smem_bytes(int d) {
  const int dc = d < kOutChunk ? d : kOutChunk;
  return sizeof(float) *
         (2 * kChunk * kLd + kTile * kLd + 2 * kTile + kTile * out_ld(dc));
}

template <typename T>
cudaError_t launch_fwd(const void* a, const void* o, float s, float w,
                       float* lse, int n, int d, cudaStream_t stream) {
  direction_fwd_kernel<T><<<row_tiles(n), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(o), s, w, lse, n, d);
  return cudaGetLastError();
}

// fp32 features: the scalar kernel
template <bool kFactored>
cudaError_t launch_bwd(const void* a, const void* o, float s, float w,
                       const float* lse_a, const float* lse_o,
                       const float* g_a, const float* g_o, float* out, int n,
                       int d, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      direction_bwd_kernel<float, kFactored>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles(n), (d + kOutChunk - 1) / kOutChunk);
  direction_bwd_kernel<float, kFactored><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(o), s, w, lse_a,
      lse_o, g_a, g_o, out, n, d);
  return cudaGetLastError();
}

// bf16 features: the tensor-core kernel, on the narrowest chunk that holds
// d, up to 256 features (wider d in chunks)
template <int kWarpF, bool kFactored>
cudaError_t launch_bwd_bf16(const void* a, const void* o, float s, float w,
                            const float* lse_a, const float* lse_o,
                            const float* g_a, const float* g_o, float* out,
                            int n, int d, cudaStream_t stream) {
  const int chunk = BwdTile<kWarpF>::kChunkF;
  const size_t smem = bwd_bf16_smem_bytes<kWarpF>((d + chunk - 1) / chunk);
  cudaError_t err = cudaFuncSetAttribute(
      direction_bwd_bf16_kernel<kWarpF, kFactored>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && aligned16(a) && aligned16(o);
  const dim3 grid((n + kRows - 1) / kRows, (d + chunk - 1) / chunk);
  direction_bwd_bf16_kernel<kWarpF, kFactored>
      <<<grid, kBwdThreads, smem, stream>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(o), s, w,
          lse_a, lse_o, g_a, g_o, out, n, d, vec);
  return cudaGetLastError();
}

template <bool kFactored>
cudaError_t launch_bwd_form(int dtype, const void* a, const void* o, float s,
                            float w, const float* la, const float* lo,
                            const float* ga, const float* go, float* out,
                            int n, int d, cudaStream_t st) {
  if (dtype == 0)
    return launch_bwd<kFactored>(a, o, s, w, la, lo, ga, go, out, n, d, st);
  if (d <= 64)
    return launch_bwd_bf16<32, kFactored>(a, o, s, w, la, lo, ga, go, out, n,
                                          d, st);
  if (d <= 128)
    return launch_bwd_bf16<64, kFactored>(a, o, s, w, la, lo, ga, go, out, n,
                                          d, st);
  return launch_bwd_bf16<128, kFactored>(a, o, s, w, la, lo, ga, go, out, n, d,
                                         st);
}

bool bad_args(int dtype, int n, int d) {
  return n < 1 || d < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (anchor, other); every other array is
// float32: lse, lse_a, lse_o, g_a, g_o [n] (the [n, 1] columns), out [n, d].
// Each function returns a cudaError_t; launches are asynchronous on `stream`.

extern "C" int crossclr_direction_fwd(int dtype, const void* anchor,
                                      const void* other, void* lse, int n,
                                      int d, float scale, float w,
                                      void* stream) {
  if (bad_args(dtype, n, d)) return (int)cudaErrorInvalidValue;
  float* out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(anchor, other, scale, w, out, n, d, st);
  return (int)launch_fwd<__nv_bfloat16>(anchor, other, scale, w, out, n, d,
                                        st);
}

// factored: 1 for the factored coefficients, 0 to subtract first.
extern "C" int crossclr_direction_bwd(int dtype, const void* anchor,
                                      const void* other, const void* lse_a,
                                      const void* lse_o, const void* g_a,
                                      const void* g_o, void* grad, int n,
                                      int d, float scale, float w,
                                      int factored, void* stream) {
  if (bad_args(dtype, n, d)) return (int)cudaErrorInvalidValue;
  const float* la = static_cast<const float*>(lse_a);
  const float* lo = static_cast<const float*>(lse_o);
  const float* ga = static_cast<const float*>(g_a);
  const float* go = static_cast<const float*>(g_o);
  float* out = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(factored != 0
                   ? launch_bwd_form<true>(dtype, anchor, other, scale, w, la,
                                           lo, ga, go, out, n, d, st)
                   : launch_bwd_form<false>(dtype, anchor, other, scale, w, la,
                                            lo, ga, go, out, n, d, st));
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
