// One direction of the CrossCLR-intra logsumexp and its anchor gradient for
// Hopper (sm_90a), with a plain C interface: the forward and the backward,
// each in two builds.
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
// The fp32 builds (the `highest` tier): the tiles of loss_tiles.cuh,
// shared with fused_dual.cu, 64 x 64 logit products over d in 32-feature
// chunks with scalar fp32 FMAs.  The forward keeps a running max and sum
// per row (the TPU kernel carries them across its sequential grid in VMEM
// scratch); the backward keeps its gradient rows [64, <= 512 features] in
// shared memory and adds coefficient-tile x candidate-tile products into
// them, wider features split over blockIdx.y, each y recomputing the
// logits.  The forward does 2·n²·d FMAs, the backward 4·n²·d, where the
// function needs 1.5 and 3.5 products of n²·d (A·Aᵀ is symmetric, so one
// triangle suffices; chip_smoke.py's bound counts that): bound by
// instruction issue and shared-memory traffic.
//
// The bf16 builds (the `default` tier the large-batch leg runs) put the
// products on tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators), with the pieces of loss_mma.cuh (shared with
// fused_dual.cu's bf16 kernels).  At n = 65,536, d = 256 the forward's 1.5
// and the backward's 3.5 products of 2·n²·d against 67 MB of features are
// far past the card's ~295 operations per byte: the operations bound both.
// Bf16 features are exact mma operands, so the logits equal the scalar
// kernels' up to the order of the sums.  A block of 8 warps owns 64 anchor
// rows; each 64-row candidate tile of O, then of A, is staged by 16-byte
// cp.async into a double buffer, the next tile's loads in flight while
// this one computes, rows padded by 16 bytes for conflict-free ldmatrix;
// each warp scores 16 anchors x 32 candidates.
//   * The forward (direction_fwd_bf16_kernel) holds each warp's anchor
//     fragments in registers for the whole candidate loop (d <= 256; a
//     wider d restages them per tile) and keeps an online logsumexp in
//     log2 units: a row's max over its quad once per tile, one rescale of
//     the lane's partial sum, exp2 of each logit; the two warps that share
//     a row merge their (max, sum) once, at the end, in a fixed order.  It
//     issues the 2 products of 2·n²·d that the bound counts as 1.5 (A·Aᵀ's
//     triangle is not shared) and one exp2 per logit; without gradient
//     accumulators it fits 128 registers, two blocks per SM.
//   * The backward (direction_bwd_bf16_kernel, loss_mma.cuh's bwd_block)
//     forms the coefficients in fp32 registers with exactly the scalar
//     kernel's arithmetic (so the factored form meets a subnormal
//     g·e^{-lse} as the plain version does), writes the coefficient tile to
//     shared memory as a bf16 hi part and the bf16 rounding of the
//     remainder (about 16 bits, as in the flash kernels), and each warp
//     adds hi·X + lo·X for its 16 rows x up to 128 features into fp32
//     accumulators in registers; the gradient rows never touch shared
//     memory.  The split doubles the coefficient products' mma count: 6
//     products of 2·n²·d issued where the bound counts 3.5.  A warp's fp32
//     gradient tile (16 x 128 for d > 128) takes a thread past the 128
//     registers that two blocks per SM would leave it, so the block runs
//     alone on its SM (for d <= 64, two blocks share one).

#include <math.h>
#include <stddef.h>

#include "loss_mma.cuh"
#include "loss_tiles.cuh"

namespace {

using namespace loss_mma;
using namespace loss_tiles;

// ---------------------------------------------------------------------------
// forward, fp32 features: one direction's lse for a 64-row anchor tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
direction_fwd_kernel(const float* __restrict__ a, const float* __restrict__ o,
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
// forward, bf16 features: tensor cores (see the header)
// ---------------------------------------------------------------------------

// the forward's shared memory: two stages of candidate rows (the first
// holds the anchor rows while their fragments load), two of anchor rows
// where d takes more than one chunk, and the two halves' (m, l) per row
template <int kChunkF>
size_t fwd_bf16_smem_bytes(int chunks) {
  return sizeof(bf16) * (size_t)((chunks > 1 ? 4 : 2) * kRows *
                                 Chunk<kChunkF>::kLd) +
         sizeof(float) * 4 * kRows;
}

// Block x: anchor rows [64 x, 64 x + 64).  Warp w scores rows 16 (w % 4) +
// [0, 16) against candidates 32 (w / 4) + [0, 32) of every 64-row tile, O's
// tiles and then A's, in stages (tile, part, chunk) whose loads go into the
// other buffer while the last one computes.  Where d fits one chunk the
// warp's A fragments stay in registers for the whole loop (kSteps x 4); a
// wider d restages its anchor chunk with each stage and reloads them.  The
// logits are in log2 units, z·log2 e: each row keeps a running max m (over
// its quad, once per tile) and each lane its part of the row's sum l of
// exp2(z - m), rescaled once per tile.  At the end the lanes of a quad add
// their sums, and the two warps that share a row merge their (m, l) in a
// fixed order: lse = ln 2 · (m + log2 l).
template <int kChunkF>
__global__ void __launch_bounds__(kMmaThreads, 2)
direction_fwd_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ o,
                          float s, float w, float* __restrict__ lse, int n,
                          int d, bool vec) {
  using C = Chunk<kChunkF>;
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  const int chunks = (d + kChunkF - 1) / kChunkF;
  bf16* sx = reinterpret_cast<bf16*>(smem_fwd);  // candidate rows, 2 stages
  bf16* sa = sx + 2 * kRows * C::kLd;            // anchor rows, 2 stages
  float* sm = reinterpret_cast<float*>(sa + (chunks > 1 ? 2 : 0) * kRows * C::kLd);
  float* sl = sm + 2 * kRows;  // [half][row] of m and l

  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 16 * (warp & 3);   // the warp's rows in the tile
  const int wc = 32 * (warp >> 2);  // its candidates in the logit tile

  const int stages = 2 * ((n + kRows - 1) / kRows) * chunks;
  auto issue = [&](int st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (tile >> 1) * kRows;
    if (chunks > 1)
      stage_tile<kChunkF>(sa + buf * kRows * C::kLd, a, r0, i * kChunkF, n, d,
                          vec);
    stage_tile<kChunkF>(sx + buf * kRows * C::kLd, (tile & 1) ? a : o, c0,
                        i * kChunkF, n, d, vec);
    cp_async_commit();
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

  // rows wr + g and wr + g + 8: running max (log2 units) and this lane's sum
  float m[2] = {kNegFloor, kNegFloor}, l[2] = {0.f, 0.f};
  float sc[4][4];
  for (int st = 0; st < stages; ++st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (tile >> 1) * kRows;
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
    // the logits in log2 units; the zeroed (not dropped) self logit; the
    // columns past n masked.  Element e of tile j: row wr + g + 8 (e / 2),
    // candidate wc + 8 j + 2 tq + e % 2
    const float zs = (intra ? w * s : s) * kLog2e;
    const bool diag = intra && c0 == r0, edge = c0 + kRows > n;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = wc + 8 * j + 2 * tq + (e & 1);
        float z = zs * sc[j][e];
        if (diag && cl == wr + g + 8 * (e >> 1)) z = 0.f;
        if (edge && c0 + cl >= n) z = -INFINITY;
        sc[j][e] = z;
        mx[e >> 1] = fmaxf(mx[e >> 1], z);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      l[r] *= exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(sc[j][e] - m[e >> 1]);
  }
  // the quad's sums (its m is one), then the two halves of each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tq == 0) {
      const int idx = (warp >> 2) * kRows + wr + g + 8 * r;
      sm[idx] = m[r];
      sl[idx] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows && r0 + threadIdx.x < n) {
    const float m0 = sm[threadIdx.x], m1 = sm[kRows + threadIdx.x];
    const float mm = fmaxf(m0, m1);
    const float sum = sl[threadIdx.x] * exp2f(m0 - mm) +
                      sl[kRows + threadIdx.x] * exp2f(m1 - mm);
    lse[r0 + threadIdx.x] = kLn2 * (mm + log2f(sum));
  }
}

// ---------------------------------------------------------------------------
// backward, bf16 features: tensor cores (see the header and loss_mma.cuh)
// ---------------------------------------------------------------------------

// Block (x, y): anchor rows [64 x, 64 x + 64), gradient features
// [kChunkF y, kChunkF (y + 1)), every candidate tile.  The gradient tile of
// the two wider builds (16 x 64 and 16 x 128 fp32 a warp, beside the
// coefficients' A fragments) takes more than the 128 registers that two
// blocks per SM would leave a thread, so those builds run one block per SM.
template <int kWarpF, bool kFactored>
__global__ void __launch_bounds__(kMmaThreads, kWarpF <= 32 ? 2 : 1)
direction_bwd_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ o,
                          float s, float w, const float* __restrict__ lse_a,
                          const float* __restrict__ lse_o,
                          const float* __restrict__ g_a,
                          const float* __restrict__ g_o, float* __restrict__ out,
                          int n, int d, bool vec) {
  bwd_block<kWarpF, kFactored, false>(a, o, nullptr, nullptr, s, w, lse_a,
                                      lse_o, g_a, g_o, out, s, n, d, vec,
                                      blockIdx.x * kRows, blockIdx.y, 0,
                                      (n + kRows - 1) / kRows);
}

size_t bwd_smem_bytes(int d) {
  const int dc = d < kOutChunk ? d : kOutChunk;
  return sizeof(float) *
         (2 * kChunk * kLd + kTile * kLd + 2 * kTile + kTile * out_ld(dc));
}

// fp32 features: the scalar kernel
cudaError_t launch_fwd(const void* a, const void* o, float s, float w,
                       float* lse, int n, int d, cudaStream_t stream) {
  direction_fwd_kernel<<<row_tiles(n), kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(o), s, w, lse, n,
      d);
  return cudaGetLastError();
}

// bf16 features: the tensor-core kernel, on the narrowest chunk that holds
// d, up to 256 features (wider d in chunks)
template <int kChunkF>
cudaError_t launch_fwd_bf16(const void* a, const void* o, float s, float w,
                            float* lse, int n, int d, cudaStream_t stream) {
  const size_t smem = fwd_bf16_smem_bytes<kChunkF>((d + kChunkF - 1) / kChunkF);
  cudaError_t err = cudaFuncSetAttribute(
      direction_fwd_bf16_kernel<kChunkF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && aligned16(a) && aligned16(o);
  direction_fwd_bf16_kernel<kChunkF>
      <<<(n + kRows - 1) / kRows, kMmaThreads, smem, stream>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(o), s, w, lse,
          n, d, vec);
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
  const size_t smem = bwd_mma_smem_bytes<kWarpF>((d + chunk - 1) / chunk);
  cudaError_t err = cudaFuncSetAttribute(
      direction_bwd_bf16_kernel<kWarpF, kFactored>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && aligned16(a) && aligned16(o);
  const dim3 grid((n + kRows - 1) / kRows, (d + chunk - 1) / chunk);
  direction_bwd_bf16_kernel<kWarpF, kFactored>
      <<<grid, kMmaThreads, smem, stream>>>(
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
  if (dtype == 0) return (int)launch_fwd(anchor, other, scale, w, out, n, d, st);
  if (d <= 64)
    return (int)launch_fwd_bf16<64>(anchor, other, scale, w, out, n, d, st);
  if (d <= 128)
    return (int)launch_fwd_bf16<128>(anchor, other, scale, w, out, n, d, st);
  return (int)launch_fwd_bf16<256>(anchor, other, scale, w, out, n, d, st);
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
