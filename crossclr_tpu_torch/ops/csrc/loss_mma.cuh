// The bf16 tensor-core pieces of the CrossCLR logsumexp kernels, shared by
// fused_crossclr.cu (the per-direction forward and backward), fused_dual.cu
// (the sym forward and backward, the dual forward and backward) and
// fused_global.cu (the rows kernels): 64-row tiles of bf16 features staged
// by 16-byte cp.async, the logits A·Xᵀ by mma.sync (mma_common.cuh), the
// online-logsumexp block of one direction (the dual forward, and its rows
// form for the rows forward), the anchor-gradient block of one direction,
// and the launch plans that split a kernel's tiles over more blocks.
// The gradient block's formulas are
//   P[i,j] = e^{z_ao[i,j]}·(f_a[i] + f_o[j])  (factored; or subtract-first
//            g_a[i]·e^{z_ao - lse_a[i]} + g_o[j]·e^{z_ao - lse_o[j]}),
//   Q[i,j] = the same over z_aa with f_a on both sides, 0 on the diagonal,
//   dA = s·(P·O + w·Q·A),  f = g·e^{-lse}.
// With keep masks (the pruned sym and dual backwards) each role's term of a
// coefficient is kept by the other index's mask: the anchor row's term by
// the candidate's mask (inter: keep_o[col] | row == col; intra: keep_a[col]
// & row != col), the candidate's term by the anchor row's mask (keep_a[row],
// the same diagonal rule).  A mask never reaches an exp: a dropped
// subtract-first term is selected away on the raw logit, so an exp that
// overflows at large s is never multiplied.  The dual backward also sums
// its share of Σ P⊙z_ao + ½ Σ Q⊙z_aa (= s · d loss / d s) per block.  The
// rows form (the rows backward, fused_global.cu) takes its anchor rows from
// an array of their own, rows off .. off + bl of the candidates' batch (the
// diagonal is off + row == col), keeps only the anchor row's term,
// g_a[i]·e^{z - lse_a[i]}, and sums Σ coef⊙z per anchor row.  The cols form
// (the rows backward's candidates) is the rows form transposed: the block's
// rows are candidates of one array, the walked tiles the anchor rows, and
// the coefficient the walked anchor row's term g_r·e^{z - lse_r}, kept by
// the block's candidate's mask.
//
// The block of 8 warps: 4 row groups x 2 halves.  Warp w scores rows
// 16 (w % 4) + [0, 16) of the block's 64 anchors against candidates
// 32 (w / 4) + [0, 32) of each 64-row candidate tile; in the backward it
// owns gradient rows 16 (w % 4) + [0, 16) and features kWarpF (w / 4) +
// [0, kWarpF) of the block's feature chunk.  Every 16-feature logit step and
// every 64-candidate gradient tile is an mma chain started from zero and
// added in fp32 (acc_add): a long chain on one accumulator drifts.
#pragma once

#include <math.h>
#include <stddef.h>

#include <mutex>
#include <type_traits>

#include "mma_common.cuh"

namespace loss_mma {

using namespace tc;

constexpr int kRows = 64;          // anchor rows per block = candidates per tile
constexpr int kMmaThreads = 256;   // 8 warps: 4 row groups x 2 halves
constexpr int kCoefLd = kRows + 8;  // bf16 per row of the coefficient tile
// The online logsumexp: logits in log2 units (z·log2 e, exp2), an excluded
// (pruned) candidate's logit kMasked, below every real one, and a running
// max that starts at kNegFloor, below kMasked
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e9f;
constexpr float kNegFloor = -1e30f;

// kChunkF features of each row staged at a time
template <int kChunkF>
struct Chunk {
  static constexpr int kLd = kChunkF + 8;      // bf16 per shared row, 16 (2m + 1) B
  static constexpr int kSteps = kChunkF / 16;  // logit k-steps per chunk
};

// The backward: kWarpF gradient features per warp; a block stages kChunkF =
// 2 kWarpF features of each row at a time, and owns that many gradient
// features.
template <int kWarpF>
struct BwdTile : Chunk<2 * kWarpF> {
  static constexpr int kChunkF = 2 * kWarpF;
  static constexpr int kN = kWarpF / 8;  // 8-wide gradient tiles per warp
};

// The backward's shared memory: two stages of candidate rows, and two of
// anchor rows where d takes more than one chunk (else one, resident), the
// coefficient tile's hi and lo parts, two stages of the candidates' factor,
// lse and keep flag.
template <int kWarpF>
size_t bwd_mma_smem_bytes(int chunks) {
  using D = BwdTile<kWarpF>;
  return sizeof(bf16) * (size_t)((chunks > 1 ? 4 : 3) * kRows * D::kLd +
                                 2 * kRows * kCoefLd) +
         sizeof(float) * 6 * kRows;
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
template <int kChunkF>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int r0,
                                           int f0, int n, int d, bool vec) {
  constexpr int kLd = Chunk<kChunkF>::kLd;
  constexpr int kChunks = kChunkF / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 8;
      bf16* p = dst + r * kLd + c;
      if (r0 + r < n && f0 + c < d)
        cp_async16(p, src + (size_t)(r0 + r) * d + f0 + c);
      else
        *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kChunkF; i += kMmaThreads) {
      const int r = i / kChunkF, c = i - r * kChunkF;
      dst[r * kLd + c] = (r0 + r < n && f0 + c < d)
                             ? src[(size_t)(r0 + r) * d + f0 + c]
                             : __float2bfloat16(0.f);
    }
  }
}

// One 16-feature step of the warp's logits S += A Xᵀ: A's 16 rows as the
// fragment af, the candidate tile xt (stride kLd) at 16-feature column ks;
// S is [16 rows, 32 candidates], four 8-wide tiles from candidate wc.
template <int kLd>
__device__ __forceinline__ void logit_step(float sc[4][4], const uint32_t af[4],
                                           const bf16* xt, int wc, int ks,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t b[4];
    ldmatrix_x4(b, ld_b<kLd>(xt + (wc + 16 * h) * kLd + 16 * ks, lane));
    float t0[4] = {}, t1[4] = {};
    mma_bf16(t0, af, b[0], b[1]);
    mma_bf16(t1, af, b[2], b[3]);
    acc_add(sc[2 * h], t0);
    acc_add(sc[2 * h + 1], t1);
  }
}

// The online-logsumexp block's shared memory: two stages of candidate rows
// (the first holds the anchor rows while their fragments load where d fits
// one chunk), two buffers of anchor rows where d takes more than one chunk
// (both chunks, resident, where it takes two; two stages where it takes
// more), two stages of the candidates' keep flags, and the two halves' (m,
// l) per row.
template <int kChunkF>
size_t fwd_mma_smem_bytes(int chunks) {
  return sizeof(bf16) * (size_t)((chunks > 1 ? 4 : 2) * kRows *
                                 Chunk<kChunkF>::kLd) +
         sizeof(float) * 6 * kRows;
}

// The online-logsumexp block of one direction: the lse of anchor rows [r0,
// r0 + 64) against candidate tiles [t0, t1) of O (inter, scale s) then A
// (intra, w·s), each tile O's and then A's.  Warp w scores rows 16 (w % 4) +
// [0, 16) against candidates 32 (w / 4) + [0, 32) of each tile, in stages
// (tile, part, chunk) whose loads go into the other buffer while the last
// one computes; where d fits one chunk the warp's A fragments stay in
// registers for the whole loop, where it takes two (256 < d <= 512) both
// anchor chunks stay in shared memory and only the candidate chunks stream,
// a wider d restages its anchor chunk with each stage.  The sum is online
// in log2 units: logits z·log2 e, a running max m per row over its quad
// once per tile, the lane's sum l of exp2(z - m) rescaled once per tile.
// Unpruned, the intra self logit is zeroed (its exp2(0 - m) stays in the
// sum); pruned, an inter column is kept where keep_o[col] or it is the
// row's own, an intra one where keep_a[col] and it is not, an excluded logit
// is kMasked, and m starts at kNegFloor: a lane or part whose columns are
// all excluded holds (m = -1e9, l = their count), which the rescale by
// exp2(-1e9 - m) wipes once the row's positive (always kept) is merged in.
// The quad's lanes add their sums and the two halves of each row merge
// their (m, l) in a fixed order, which write(row, m, l) stores (the kernel's
// own: its parameters are read there, not held through the loop).
// kRowsForm: the anchor rows are rows [r0, r0 + 64) of `rows` ([bl, d]) and
// anchor row r is candidate row_off + r of `a` (its own column); otherwise
// the anchors are rows of `a` itself (bl = n, row_off = 0).
template <int kChunkF, bool kPruned, bool kRowsForm = false, typename Write>
__device__ __forceinline__ void fwd_block(
    const bf16* __restrict__ a, const bf16* __restrict__ o,
    const unsigned char* __restrict__ keep_a,
    const unsigned char* __restrict__ keep_o, float s, float w, int n, int d,
    bool vec, int r0, int t0, int t1, Write write,
    const bf16* __restrict__ rows = nullptr, int bl = 0, int row_off = 0) {
  using C = Chunk<kChunkF>;
  const bf16* arows = kRowsForm ? rows : a;  // the anchor rows' array
  const int na = kRowsForm ? bl : n;         // and its rows
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  const int chunks = (d + kChunkF - 1) / kChunkF;
  const bool resident = chunks == 2;  // both anchor chunks stay staged
  bf16* sx = reinterpret_cast<bf16*>(smem_fwd);  // candidate rows, 2 stages
  bf16* sa = sx + 2 * kRows * C::kLd;  // anchor rows: 2 chunks or 2 stages
  float* skeep = reinterpret_cast<float*>(sa + (chunks > 1 ? 2 : 0) * kRows * C::kLd);
  float* sm = skeep + 2 * kRows;  // [half][row] running max
  float* sl = sm + 2 * kRows;     // [half][row] sum

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 16 * (warp & 3);   // the warp's rows in the tile
  const int wc = 32 * (warp >> 2);  // its candidates in the logit tile
  const float ws = w * s;

  // Issue the loads of stage st into buffer st & 1, and on a tile's first
  // chunk (pruned) the candidates' keep flags into stage tile & 1.
  const int stages = 2 * (t1 - t0) * chunks;
  auto issue = [&](int st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (t0 + (tile >> 1)) * kRows;
    const bool intra = tile & 1;
    if (chunks > 1 && !resident)
      stage_tile<kChunkF>(sa + buf * kRows * C::kLd, arows, r0, i * kChunkF, na,
                          d, vec);
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
    stage_tile<kChunkF>(sx + kRows * C::kLd, arows, r0, 0, na, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
      ldmatrix_x4(af[ks], ld_a<C::kLd>(sx + (kRows + wr) * C::kLd + 16 * ks, lane));
  } else if (resident) {  // both anchor chunks, landing with stage 0
    stage_tile<kChunkF>(sa, arows, r0, 0, na, d, vec);
    stage_tile<kChunkF>(sa + kRows * C::kLd, arows, r0, kChunkF, na, d, vec);
  }
  issue(0);  // buffer 0; buffer 1 is next written after stage 0's barrier

  // rows wr + g and wr + g + 8: running max (log2 units) and this lane's sum
  float m[2] = {kNegFloor, kNegFloor}, l[2] = {0.f, 0.f};
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
      const bf16* at = sa + (resident ? i : buf) * kRows * C::kLd;
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
    // the logits in log2 units; element e of tile j: row wr + g + 8 (e /
    // 2), candidate wc + 8 j + 2 tq + e % 2; the columns past n masked.
    // Row rl's own column: the square form's diagonal of tile r0, the rows
    // form's c0 + cl = row_off + r0 + rl (any column, of one tile or two;
    // each test as written keeps the 128 registers of two blocks an SM)
    const float zs = (intra ? ws : s) * kLog2e;
    const int self_at = kRowsForm ? row_off + r0 - c0 : 0;
    const bool diag = intra && c0 == r0, edge = c0 + kRows > n;
    const float* kc = skeep + (tile & 1) * kRows;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + 8 * (e >> 1);
        const int cl = wc + 8 * j + 2 * tq + (e & 1);
        float x = zs * sc[j][e];
        if constexpr (kPruned) {
          // the positive always kept, the self column dropped
          const bool self =
              kRowsForm ? c0 + cl == row_off + r0 + rl : c0 + cl == r0 + rl;
          if (!(intra ? (kc[cl] != 0.f && !self) : (kc[cl] != 0.f || self)))
            x = kMasked;
        } else if constexpr (kRowsForm) {
          if (intra && cl == rl + self_at) x = 0.f;  // the zeroed self logit
        } else {
          if (diag && cl == rl) x = 0.f;  // the zeroed (not dropped) self logit
        }
        if (edge && c0 + cl >= n) x = -INFINITY;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
  const int row = r0 + threadIdx.x;
  if (threadIdx.x < kRows && row < na) {
    const float m0 = sm[threadIdx.x], m1 = sm[kRows + threadIdx.x];
    const float mm = fmaxf(m0, m1);
    const float sum = sl[threadIdx.x] * exp2f(m0 - mm) +
                      sl[kRows + threadIdx.x] * exp2f(m1 - mm);
    write(row, mm, sum);
  }
}

// The lse of the parts' (m, l) of one row, m[z · stride] and l[z ·
// stride]: ln 2 · (M + log2 Σ_z l_z·2^(m_z - M)), M = max_z m_z, the parts
// added in index order
__device__ __forceinline__ float merge_parts(const float* __restrict__ m,
                                             const float* __restrict__ l,
                                             size_t stride, int parts) {
  float mm = m[0];
  for (int z = 1; z < parts; ++z) mm = fmaxf(mm, m[z * stride]);
  float sum = 0.f;
  for (int z = 0; z < parts; ++z) sum += l[z * stride] * exp2f(m[z * stride] - mm);
  return kLn2 * (mm + log2f(sum));
}

// The anchor-gradient block of one direction: anchor rows [r0, r0 + 64),
// gradient features [kChunkF fc, kChunkF (fc + 1)), candidate tiles
// [t0, t1) (64 rows each).  It writes out_scale · (its sum over those
// tiles) to out[row · d + feature]: s · the gradient where one block sees
// every tile, or the fp32 partial (out_scale = 1) of a split.
// The block walks stages st = (tile, part, chunk) in order, part 0 the
// other features O and part 1 the anchors A; the loads of stage st + 1 go
// into the other buffer while stage st computes.  Each warp scores 16
// anchors x 32 candidates by mma and forms their coefficients in fp32
// registers with exactly the scalar kernels' arithmetic (the row factors
// once per row, the candidate factors once per tile, the diagonal test, the
// w multiplier), so the factored form meets a subnormal g·e^{-lse} as the
// plain version does.  The coefficient tile goes to shared memory as a bf16
// hi part and the bf16 rounding of the remainder, and each warp adds
// hi·X + lo·X for its 16 rows x kWarpF features into fp32 accumulators in
// registers, the candidate tile X read by ldmatrix.trans.
// kFactored = true: exp(z)·(g_a e^{-lse_a} + g_c e^{-lse_c}); false:
// g_a·exp(z - lse_a) + g_c·exp(z - lse_c).  kPruned: keep masks keep_a,
// keep_o [n].  kDs (subtract-first only): the block also sums
// ds_weight·coef·z over its logits, ds_weight = ds_inter for the inter
// logits and ½ for the intra ones, each tile's 16 terms a thread holds
// summed apart and then added to its running sum, the threads' sums
// reduced in a fixed order; thread 0 writes it to *ds_out where ds_out is
// not null.  The forms (Form, below; the rows and cols forms are
// subtract-first, without kDs): `pairs`, the anchors are rows of `a` itself
// (bl = n, row_off = 0).  `rows`: the anchor rows are rows [r0, r0 + 64) of
// `rows` ([bl, d]; lse_a, g_a [bl]), anchor row r is candidate row_off + r
// of `a` (the diagonal), the coefficient is the anchor row's term alone,
// and each row's Σ coef⊙z (its 16 terms of a tile summed apart, then the
// quad's lanes and the two halves in a fixed order) goes to ds_out[row]
// where ds_out is not null.  `cols`: the block's rows are candidates [r0,
// r0 + 64) of A (cols_intra) or O, with their mask keep_a or keep_o, the
// walked tiles [t0, t1) are those of `rows` alone (no O / A alternation),
// candidate c is anchor row c - row_off's own column, and the coefficient
// is the walked anchor row's term g_a[r]·exp(z - lse_a[r]), kept where the
// block's candidate's mask keeps the pair (on the diagonal the positive,
// never the intra self logit).
enum class Form { pairs, rows, cols };

template <int kWarpF, bool kFactored, bool kPruned, bool kDs = false,
          Form kForm = Form::pairs>
__device__ __forceinline__ void bwd_block(
    const bf16* __restrict__ a, const bf16* __restrict__ o,
    const unsigned char* __restrict__ keep_a,
    const unsigned char* __restrict__ keep_o, float s, float w,
    const float* __restrict__ lse_a, const float* __restrict__ lse_o,
    const float* __restrict__ g_a, const float* __restrict__ g_o,
    float* __restrict__ out, float out_scale, int n, int d, bool vec, int r0,
    int fc, int t0, int t1, float ds_inter = 0.f, float* ds_out = nullptr,
    const bf16* __restrict__ rows = nullptr, int bl = 0, int row_off = 0,
    bool cols_intra = false) {
  constexpr bool kRowsForm = kForm == Form::rows, kColsForm = kForm == Form::cols;
  static_assert(!(kDs && kFactored), "Σ coeff⊙z is the subtract-first form's");
  static_assert(kForm == Form::pairs || !(kDs || kFactored),
                "the rows and cols forms are subtract-first, without Σ coeff⊙z");
  using D = BwdTile<kWarpF>;
  // the block's rows and their count, and the walked tiles' rows: the
  // anchor rows against the candidates, or (cols) the candidates against
  // the anchor rows
  const bf16* arows = kRowsForm ? rows : kColsForm && !cols_intra ? o : a;
  const int na = kRowsForm ? bl : n;
  const int nx = kColsForm ? bl : n;
  const int diag = kRowsForm ? row_off : 0;  // anchor row r is candidate r + diag
  constexpr int kWalks = kColsForm ? 1 : 2;  // tiles walked per tile index
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int chunks = (d + D::kChunkF - 1) / D::kChunkF;
  const int a_bufs = chunks > 1 ? 2 : 1;
  bf16* sx = reinterpret_cast<bf16*>(smem_bf16);  // candidate rows, 2 stages
  bf16* sa = sx + 2 * kRows * D::kLd;             // anchor rows, 1 or 2
  bf16* chi = sa + a_bufs * kRows * D::kLd;       // coefficients, bf16 hi
  bf16* clo = chi + kRows * kCoefLd;              // and lo parts
  // the candidates' factors, 2 stages each: g·e^{-lse} (factored) or g,
  // lse (subtract-first), and the keep flag 1 / 0 (pruned)
  float* scol_a = reinterpret_cast<float*>(clo + kRows * kCoefLd);
  float* scol_b = scol_a + 2 * kRows;
  float* scol_k = scol_b + 2 * kRows;

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
  const int stages = kWalks * (t1 - t0) * chunks;
  auto issue = [&](int st) {
    const int i = st % chunks, tile = st / chunks;
    const int c0 = (t0 + (kColsForm ? tile : tile >> 1)) * kRows, buf = st & 1;
    const bool intra = kColsForm ? cols_intra : tile & 1;
    const int f0 = ((fc + 1 + i) % chunks) * D::kChunkF;
    if (chunks > 1)
      stage_tile<D::kChunkF>(sa + buf * kRows * D::kLd, arows, r0, f0, na, d,
                             vec);
    stage_tile<D::kChunkF>(sx + buf * kRows * D::kLd,
                           kColsForm ? rows : intra ? a : o, c0, f0, nx, d, vec);
    cp_async_commit();
    if (i == 0 && threadIdx.x < kRows) {
      const int col = c0 + threadIdx.x;
      // the cols form's walked rows are the anchor rows: their g, lse
      const float* g_c = intra || kColsForm ? g_a : g_o;
      const float* lse_c = intra || kColsForm ? lse_a : lse_o;
      float fa = 0.f, fb = 0.f, fk = 0.f;
      if (col < nx) {
        if constexpr (kFactored) {
          fa = g_c[col] * expf(-lse_c[col]);
        } else if constexpr (!kRowsForm) {
          fa = g_c[col];
          fb = lse_c[col];
        }
        if constexpr (kPruned && !kColsForm)
          fk = (intra ? keep_a : keep_o)[col] ? 1.f : 0.f;
      }
      scol_a[(tile & 1) * kRows + threadIdx.x] = fa;
      scol_b[(tile & 1) * kRows + threadIdx.x] = fb;
      scol_k[(tile & 1) * kRows + threadIdx.x] = fk;
    }
  };

  // this lane's anchor-row factors, rows wr + g and wr + g + 8, and (pruned)
  // whether each row's mask keeps it as the candidates' candidate (cols:
  // the block's candidates' masks keep the walked anchor rows' terms)
  const unsigned char* keep_r = kColsForm && !cols_intra ? keep_o : keep_a;
  float ra[2], rb[2];
  bool kr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wr + g + 8 * r;
    ra[r] = rb[r] = 0.f;
    kr[r] = kPruned && !kRowsForm && row < n && keep_r[row];
    if (!kColsForm && row < na) {
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
  float ds_acc = 0.f;  // kDs: this thread's running Σ ds_weight·coef·z
  float ds_row[2] = {0.f, 0.f};  // kRowsForm: its rows' running Σ coef·z

  // one chunk: the anchor rows stay resident, loaded with stage 0
  if (chunks == 1) stage_tile<D::kChunkF>(sa, arows, r0, 0, na, d, vec);
  issue(0);
  float sc[4][4];
  for (int st = 0; st < stages; ++st) {
    const int i = st % chunks, tile = st / chunks, buf = st & 1;
    const int c0 = (t0 + (kColsForm ? tile : tile >> 1)) * kRows;
    const bool intra = kColsForm ? cols_intra : tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage st has landed; stage st - 1's readers are done
    if (st + 1 < stages) issue(st + 1);
    const bf16* xt = sx + buf * kRows * D::kLd;
    const bf16* at = sa + (chunks > 1 ? buf : 0) * kRows * D::kLd;
    // S = A X^T over the chunk: [16 rows, 32 candidates] per warp
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    }
#pragma unroll 4
    for (int ks = 0; ks < D::kSteps; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, ld_a<D::kLd>(at + wr * D::kLd + 16 * ks, lane));
      logit_step<D::kLd>(sc, af, xt, wc, ks, lane);
    }
    if (i + 1 < chunks) continue;
    // the coefficients, with the scalar kernels' arithmetic; element e of
    // tile j: row wr + g + 8 (e / 2), candidate wc + 8 j + 2 tq + e % 2
    const float zs = intra ? w * s : s;
    const float* fa = scol_a + (tile & 1) * kRows;
    const float* fb = scol_b + (tile & 1) * kRows;
    const float* fk = scol_k + (tile & 1) * kRows;
    // each logit enters Σ coeff⊙z once over both directions' blocks
    const float ds_w = intra ? 0.5f : ds_inter;
    float ds_tile = 0.f, ds_rows_tile[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wr + g + 8 * (e >> 1);
        const int cl = wc + 8 * j + 2 * tq + (e & 1);
        const int col = c0 + cl;
        const float z = zs * sc[j][e];
        float coef = 0.f;
        if constexpr (kRowsForm) {
          // the anchor row's term where the candidate's mask keeps it; on
          // the diagonal the positive (inter) is kept, the self logit
          // (intra: dropped, or zeroed and constant) has none
          bool keep = !kPruned || fk[cl] != 0.f;
          if (row + diag == col) keep = !intra;
          if (row < na && col < n && keep) coef = ra[e >> 1] * expf(z - rb[e >> 1]);
          ds_rows_tile[e >> 1] = fmaf(coef, z, ds_rows_tile[e >> 1]);
        } else if constexpr (kColsForm) {
          // the walked anchor row's term where the block's candidate's mask
          // keeps it; on the diagonal (candidate row is anchor col's own)
          // the positive (inter) is kept, the self logit has none
          bool keep = !kPruned || kr[e >> 1];
          if (row == col + row_off) keep = !intra;
          if (row < na && col < nx && keep) coef = fa[cl] * expf(z - fb[cl]);
        } else if constexpr (kPruned) {
          // each role's term where its mask keeps the pair; on the
          // diagonal the positive (inter) keeps both, intra neither
          bool keep_row_term = fk[cl] != 0.f, keep_col_term = kr[e >> 1];
          if (row == col) keep_row_term = keep_col_term = !intra;
          if (row < n && col < n && (keep_row_term || keep_col_term)) {
            if constexpr (kFactored)
              coef = expf(z) * ((keep_row_term ? ra[e >> 1] : 0.f) +
                                (keep_col_term ? fa[cl] : 0.f));
            else
              coef = (keep_row_term ? ra[e >> 1] * expf(z - rb[e >> 1]) : 0.f) +
                     (keep_col_term ? fa[cl] * expf(z - fb[cl]) : 0.f);
          }
        } else {
          // a zeroed intra logit is a constant: no gradient
          if (row < n && col < n && !(intra && row == col)) {
            if constexpr (kFactored)
              coef = expf(z) * (ra[e >> 1] + fa[cl]);
            else
              coef = ra[e >> 1] * expf(z - rb[e >> 1]) + fa[cl] * expf(z - fb[cl]);
          }
        }
        if constexpr (kDs) ds_tile = fmaf(ds_w * coef, z, ds_tile);
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
    if constexpr (kDs) ds_acc += ds_tile;
    if constexpr (kRowsForm) {
      ds_row[0] += ds_rows_tile[0];
      ds_row[1] += ds_rows_tile[1];
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
      float t0_[4] = {}, t1_[4] = {};
#pragma unroll
      for (int kg = 0; kg < kRows / 16; ++kg) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, ld_b_trans<D::kLd>(xt + 16 * kg * D::kLd + wf + 16 * np, lane));
        mma_bf16(t0_, ah[kg], b[0], b[1]);
        mma_bf16(t0_, al[kg], b[0], b[1]);
        mma_bf16(t1_, ah[kg], b[2], b[3]);
        mma_bf16(t1_, al[kg], b[2], b[3]);
      }
      acc_add(acc[2 * np], t0_);
      acc_add(acc[2 * np + 1], t1_);
    }
  }
  const int fbase = fc * D::kChunkF + wf + 2 * tq;
#pragma unroll
  for (int j = 0; j < D::kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + wr + g + 8 * (e >> 1);
      const int f = fbase + 8 * j + (e & 1);
      if (row < na && f < d) out[(size_t)row * d + f] = out_scale * acc[j][e];
    }
  if constexpr (kRowsForm) {
    __shared__ float ds_half[2][kRows];  // [warp / 4][row]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ds_row[r] += __shfl_xor_sync(0xffffffffu, ds_row[r], 1);
      ds_row[r] += __shfl_xor_sync(0xffffffffu, ds_row[r], 2);
      if (tq == 0) ds_half[warp >> 2][wr + g + 8 * r] = ds_row[r];
    }
    __syncthreads();
    const int row = r0 + threadIdx.x;
    if (ds_out != nullptr && threadIdx.x < kRows && row < na)
      ds_out[row] = ds_half[0][threadIdx.x] + ds_half[1][threadIdx.x];
  }
  if constexpr (kDs) {
    __shared__ float ds_warps[kMmaThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ds_acc += __shfl_xor_sync(0xffffffffu, ds_acc, off);
    if (lane == 0) ds_warps[warp] = ds_acc;
    __syncthreads();
    if (threadIdx.x == 0 && ds_out != nullptr) {
      float total = 0.f;
      for (int i = 0; i < kMmaThreads / 32; ++i) total += ds_warps[i];
      *ds_out = total;
    }
  }
}

// ---------------------------------------------------------------------------
// launch plans of the bf16 kernels (host)
// ---------------------------------------------------------------------------

// Host functions of internal linkage (static): each library keeps its own
// plan cache.

// The parts S the candidate tiles split into.  S = 1 where the blocks
// already fill the card's slots (SMs x resident blocks); otherwise the S
// up to ceil(slots / blocks) (and the tiles) whose waves x tiles per part
// is least, the smallest of a tie: at n = 1024, d = 256 (32 blocks of one
// per SM) S = 4.
static int split_parts(int tiles, int blocks, int slots) {
  if (blocks >= slots) return 1;
  int best = 1;
  long long best_cost = tiles;
  const int fill = (slots + blocks - 1) / blocks;
  const int most = fill < tiles ? fill : tiles;
  for (int parts = 2; parts <= most; ++parts) {
    const long long cost = (long long)((blocks * parts + slots - 1) / slots) *
                           ((tiles + parts - 1) / parts);
    if (cost < best_cost) {
      best = parts;
      best_cost = cost;
    }
  }
  return best;
}

// The SM count and the blocks of kernel `fn` resident on one SM at `smem`
// bytes of dynamic shared memory, on the current device: queried once per
// (device, kernel, smem) and cached.  The first query of a (device,
// kernel) raises its dynamic shared memory limit to `max_smem`, the most
// any launch of it takes, so that no later launch needs it raised again.
static cudaError_t occupancy(const void* fn, size_t smem, size_t max_smem,
                             int* sms, int* per_sm) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    int sms, per_sm;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.dev != dev || e.fn != fn) continue;
    raised = true;
    if (e.smem == smem) {
      *sms = e.sms;
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
  }
  if (!raised)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kMmaThreads,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (used < kEntries) cache[used++] = Entry{dev, fn, smem, *sms, *per_sm};
  return cudaSuccess;
}

// A bf16 kernel's launch: its dynamic shared memory and the parts its
// candidate tiles split into.
struct Plan {
  size_t smem;
  int parts;
};

static cudaError_t split_plan(const void* fn, size_t smem, size_t max_smem,
                              int tiles, int blocks, Plan* plan) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = occupancy(fn, smem, max_smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  plan->smem = smem;
  plan->parts = split_parts(tiles, blocks, sms * (per_sm > 1 ? per_sm : 1));
  return cudaSuccess;
}

// f(std::integral_constant<int, kChunkF>{}) for the forwards' chunk: the
// narrowest that holds d, up to 256 features (wider d in chunks of 256)
template <typename F>
cudaError_t by_chunk(int d, F f) {
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

// f(std::integral_constant<int, kWarpF>{}) on the narrowest feature chunk
// that holds d, up to 256 features (wider d in chunks of 256): the
// backwards' kWarpF = chunk / 2
template <typename F>
cudaError_t by_width(int d, F f) {
  if (d <= 64) return f(std::integral_constant<int, 32>{});
  if (d <= 128) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

// f(std::bool_constant<pruned>{})
template <typename F>
cudaError_t by_pruned(bool pruned, F f) {
  return pruned ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace loss_mma
