// The Hopper block of the sym backward's bf16 build (fused_dual.cu's
// sym_bwd_wgmma_kernel): warpgroup matrix products (wgmma, sm_90a) fed by
// the Tensor Memory Accelerator (TMA), shared by nothing else.
//
// One direction's anchor-gradient block, as the formulas of loss_mma.cuh
// write it in the factored form: P[i,j] = e^{z_ao[i,j]}·(f_a[i] + f_o[j]),
// Q[i,j] the same over z_aa with f_a on both sides and 0 on the diagonal,
// f = g·e^{-lse}, dA = s·(P·O + w·Q·A); pruned, each role's term selected
// by the other index's keep mask (the positive kept, the intra self logit
// dropped).  The coefficient arithmetic is loss_mma.cuh's bwd_block's, term
// for term; what differs is how the products are issued.
//
// The block: 128 anchor rows of one direction and 256 gradient features
// (chunk fc), three warpgroups.  Warpgroup 2 produces: one thread loads the
// anchor tile once, [boxes][128 rows][64 features], and then each candidate
// tile of kCand rows (the other features O, then the anchors A,
// alternately) into a ring of stages by TMA, 128-byte swizzled boxes of 64
// features, each stage's arrival counted by its `full` mbarrier; the warp's
// lanes write the candidates' factors g·e^{-lse} (and keep flags) beside
// it.  Warpgroups 0 and 1 consume, 64 anchor rows each: the logits A·Xᵀ by
// wgmma m64n{kCand}k16 with both operands in shared memory (one accumulator
// over the whole depth d), the coefficients in fp32 registers, then, for
// each 64-feature quarter of the gradient chunk, hi·X + lo·X by wgmma
// m64n64k16 with the coefficients' bf16 hi and lo parts as the register
// operand and the same shared-memory stage, read feature-major, as the
// other: one load of a candidate tile serves both of its products.  Each
// quarter's product over the tile's candidates starts from zero and is
// added to the running sum in fp32 (loss_mma.cuh's acc_add: a long chain on
// one accumulator drifts).  A warp releases a stage (its `empty` mbarrier,
// 8 arrivals) once its products have read it.  Warpgroup 1 starts once 0
// has issued its first logits, so that the two do not take the tensor cores
// and the exponentials in step.  A tile with no row or candidate past n
// and off the diagonal forms its coefficients without those tests.
// kCand: 128 where the depth fits four boxes (d <= 256), so that the
// logits' product is 128 wide (64-wide products with both operands in
// shared memory ask for all of its bandwidth); 64 for d <= 384, where the
// anchor tile and two stages of 128 rows would not fit, and for the pruned
// variant (cand_rows).  Registers: the running gradient 64 rows x 256
// features (128 a thread), a quarter's product (32), the coefficients' hi
// and lo parts (kCand / 2); the consumers take 240 a thread, the producer
// 24 (setmaxnreg), and the anchor rows' factors wait in shared memory.
#pragma once

#include <cuda.h>
#include <math.h>
#include <stddef.h>

#include <mutex>

#include "mma_common.cuh"

namespace loss_wgmma {

using namespace tc;

constexpr int kRowsW = 128;      // anchor rows per block: two warpgroups of 64
constexpr int kBoxF = 64;        // features per TMA box: one 128-byte swizzle row
constexpr int kOutF = 256;       // gradient features per block
constexpr int kMaxBoxes = 6;     // d <= 384: the anchor tile and two stages fit
constexpr int kMaxStages = 4;
constexpr int kThreadsW = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kAnchorBoxBytes = kRowsW * kBoxF * 2;  // an anchor box, 16 KB
constexpr int kSmemLimit = 232448;                   // 227 KB, a block's most

// candidate rows a tile for d: 128 up to four boxes, else 64; pruned 64
// (at 128 the keep flags take its consumers past 240 registers: it spilled)
constexpr int cand_rows(int d, bool pruned) {
  return !pruned && (d + kBoxF - 1) / kBoxF <= 4 ? 128 : 64;
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// box (x = feature, y = row) of a 2-D tensor map into shared memory,
// counted on `bar`; outside the tensor the box is filled with zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x,
                                         int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// A shared-memory matrix descriptor of a 128-byte swizzled operand
// (start address, leading and stride byte offsets; layout 1 = 128B).
// K-major (the logits' operands, 16 features a step): 8-row groups 1024 B
// apart, a step 32 B into the swizzled row.  Feature-major (the
// candidates as the gradient product's B, 64 features wide): 8-candidate
// groups 1024 B apart; with one 64-feature atom across N the leading offset
// is never stepped.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the registers an asynchronous wgmma reads or writes, pinned in place
// until after its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// named barrier 1 of the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync_consumers() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive_consumers() {
  asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// D (64 x 64 or 64 x 128 fp32, the accumulator layout of mma_common.cuh per
// warp's 16 rows and 8-column tile) = A·Bᵀ (ss: both K-major in shared
// memory) or A·B (rs: A, 64 x 16, as each warp's mma.sync A fragment; B,
// 16 x 64, in shared memory feature-major); the _first forms start from
// zero.
__device__ __forceinline__ void wgmma_ss_first(float d[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float d[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_first(float d[32], const uint32_t a[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs(float d[32], const uint32_t a[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss128_first(float d[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, " "%8, %9, %10, %11, %12, %13, %14, %15, " "%16, %17, %18, %19, %20, %21, %22, %23, " "%24, %25, %26, %27, %28, %29, %30, %31, " "%32, %33, %34, %35, %36, %37, %38, %39, " "%40, %41, %42, %43, %44, %45, %46, %47, " "%48, %49, %50, %51, %52, %53, %54, %55, " "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss128(float d[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, " "%8, %9, %10, %11, %12, %13, %14, %15, " "%16, %17, %18, %19, %20, %21, %22, %23, " "%24, %25, %26, %27, %28, %29, %30, %31, " "%32, %33, %34, %35, %36, %37, %38, %39, " "%40, %41, %42, %43, %44, %45, %46, %47, " "%48, %49, %50, %51, %52, %53, %54, %55, " "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

// Shared memory: the 1024-byte alignment pad, the anchor boxes, the stages'
// candidate boxes of `cand` rows, their factors and keep flags, the anchor
// rows' factors and keep flags, the barriers.
inline size_t smem_bytes(int cand, int boxes, int stages) {
  return 1024 + (size_t)boxes * kAnchorBoxBytes +
         (size_t)stages * (boxes * cand * kBoxF * 2 + 2 * cand * sizeof(float)) +
         2 * kRowsW * sizeof(float) + (2 * stages + 1) * sizeof(uint64_t);
}

// The coefficients of one tile in place of its logits sc, with bwd_block's
// arithmetic (the w multiplier as cw, 1 for the inter tiles); element e of
// 8-wide tile j: row wrow + 8 (e / 2), candidate c0 + 8 j + 2 tq + e % 2.
// The candidates' factors and keep flags fa, fk; the rows' ra, rk (at
// wrow - r0, shared memory: registers are the scarce thing here).  kEdge:
// the tile may hold rows or candidates past n, or the diagonal.
template <bool kPruned, bool kEdge, int kN>
__device__ __forceinline__ void coefficients(float (&sc)[kN], const float* fa,
                                             const float* fk, const float* ra_s,
                                             const float* rk_s, bool intra,
                                             float zs, float cw, int wrow,
                                             int c0, int tq, int n) {
  const float ra[2] = {ra_s[0], ra_s[8]};
  bool kr[2] = {false, false};
  if constexpr (kPruned) {
    kr[0] = rk_s[0] != 0.f;
    kr[1] = rk_s[8] != 0.f;
  }
#pragma unroll
  for (int j = 0; j < kN / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wrow + 8 * (e >> 1);
      const int cl = 8 * j + 2 * tq + (e & 1);
      const int col = c0 + cl;
      const float z = zs * sc[4 * j + e];
      float coef = 0.f;
      if constexpr (kPruned) {
        // each role's term where its mask keeps the pair; on the diagonal
        // the positive (inter) keeps both, intra neither
        bool keep_row_term = fk[cl] != 0.f, keep_col_term = kr[e >> 1];
        if (kEdge && row == col) keep_row_term = keep_col_term = !intra;
        if ((!kEdge || (row < n && col < n)) && (keep_row_term || keep_col_term))
          coef = expf(z) * ((keep_row_term ? ra[e >> 1] : 0.f) +
                            (keep_col_term ? fa[cl] : 0.f));
      } else {
        // a zeroed intra logit is a constant: no gradient
        if (!kEdge || (row < n && col < n && !(intra && row == col)))
          coef = expf(z) * (ra[e >> 1] + fa[cl]);
      }
      sc[4 * j + e] = cw * coef;
    }
}

// The gradient rows [r0, r0 + 128) of the anchors of map_a, features
// [256 fc, 256 fc + 256) ∩ [0, d), over candidate tiles [t0, t1) (kCand
// rows each, of map_o then map_a), written as out_scale · the sum to
// out[row · d + feature].  `stages` (2 to 4) stages of the ring.
template <bool kPruned, int kCand>
__device__ __forceinline__ void sym_bwd_block(
    const CUtensorMap* map_a, const CUtensorMap* map_o,
    const unsigned char* __restrict__ keep_a,
    const unsigned char* __restrict__ keep_o, float s, float w,
    const float* __restrict__ lse_a, const float* __restrict__ lse_o,
    const float* __restrict__ g_a, const float* __restrict__ g_o,
    float* __restrict__ out, float out_scale, int n, int d, int r0, int fc,
    int t0, int t1, int stages) {
  constexpr int kBoxBytes = kCand * kBoxF * 2;  // a candidate box
  constexpr int kSteps = kCand / 16;            // 16-candidate steps
  extern __shared__ __align__(1024) unsigned char smem_wgmma[];
  unsigned char* sm = smem_wgmma + ((1024 - (smem_u32(smem_wgmma) & 1023)) & 1023);
  const int boxes = (d + kBoxF - 1) / kBoxF;
  unsigned char* s_anchor = sm;                            // [boxes][128][64]
  unsigned char* s_stage = sm + boxes * kAnchorBoxBytes;  // [stages][boxes][kCand][64]
  float* s_fac = reinterpret_cast<float*>(s_stage + stages * boxes * kBoxBytes);
  float* s_keep = s_fac + stages * kCand;                  // [stages][kCand]
  float* s_row = s_keep + stages * kCand;  // [128] anchor rows' g·e^{-lse}
  float* s_rowk = s_row + kRowsW;          // [128] their keep flags
  uint64_t* full = reinterpret_cast<uint64_t*>(s_rowk + kRowsW);
  uint64_t* empty = full + stages;
  uint64_t* anchor_full = empty + stages;
  const int walks = 2 * (t1 - t0);  // (tile, O or A) pairs

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 32);  // the producer warp's lanes
      mbar_init(empty + i, 8);  // the consumer warps
    }
    mbar_init(anchor_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // the producer: its first warp alone
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(anchor_full, boxes * kAnchorBoxBytes);
      for (int k = 0; k < boxes; ++k)
        for (int h = 0; h < kRowsW / kCand; ++h)
          tma_load(s_anchor + k * kAnchorBoxBytes + h * kBoxBytes, map_a, kBoxF * k,
                   r0 + kCand * h, anchor_full);
    }
    for (int it = 0; it < walks; ++it) {
      const int st = it % stages;
      const int c0 = (t0 + (it >> 1)) * kCand;
      const bool intra = it & 1;
      if (it >= stages) mbar_wait(empty + st, ((it / stages) - 1) & 1);
      const float* g_c = intra ? g_a : g_o;
      const float* lse_c = intra ? lse_a : lse_o;
#pragma unroll
      for (int q = 0; q < kCand / 32; ++q) {
        const int i = lane + 32 * q, col = c0 + i;
        float fa = 0.f, fk = 0.f;
        if (col < n) {
          fa = g_c[col] * expf(-lse_c[col]);
          if constexpr (kPruned) fk = (intra ? keep_a : keep_o)[col] ? 1.f : 0.f;
        }
        s_fac[st * kCand + i] = fa;
        s_keep[st * kCand + i] = fk;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + st, boxes * kBoxBytes);
        unsigned char* dst = s_stage + st * boxes * kBoxBytes;
        for (int k = 0; k < boxes; ++k)
          tma_load(dst + k * kBoxBytes, intra ? map_a : map_o, kBoxF * k, c0, full + st);
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }

  // the consumers: warpgroup wg scores anchor rows 64 wg + [0, 64); warp
  // `warp` holds rows 16 warp + g and + 8 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = r0 + 64 * wg + 16 * warp + g;  // this thread's first row
  // its rows' factors, each written by the row's four threads alike
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;
    s_row[row - r0] = row < n ? g_a[row] * expf(-lse_a[row]) : 0.f;
    s_rowk[row - r0] = kPruned && row < n && keep_a[row] ? 1.f : 0.f;
  }
  float run[4][32];  // the gradient's running sum: quarter, accumulator
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) run[q][i] = 0.f;
  const uint32_t a0 = smem_u32(s_anchor) + wg * 64 * 128;
  const int quarters = min(4, (d - kOutF * fc + kBoxF - 1) / kBoxF);
  mbar_wait(anchor_full, 0);
  // warpgroup 1 waits for 0's first logits
  if (wg == 1 && walks > 0) bar_sync_consumers();

  for (int it = 0; it < walks; ++it) {
    const int st = it % stages;
    const int c0 = (t0 + (it >> 1)) * kCand;
    const bool intra = it & 1;
    mbar_wait(full + st, (it / stages) & 1);
    const uint32_t x0 = smem_u32(s_stage) + st * boxes * kBoxBytes;
    // S = A Xᵀ over the whole depth: 4 steps of 16 features a box
    float sc[kCand / 2];
    wgmma_fence();
    if constexpr (kCand == 128)
      wgmma_ss128_first(sc, sw128_desc(a0, 0, 1024), sw128_desc(x0, 0, 1024));
    else
      wgmma_ss_first(sc, sw128_desc(a0, 0, 1024), sw128_desc(x0, 0, 1024));
    for (int ks = 1; ks < 4 * boxes; ++ks) {
      const uint32_t k = ks >> 2, step = (ks & 3) * 32;
      const uint64_t da = sw128_desc(a0 + k * kAnchorBoxBytes + step, 0, 1024);
      const uint64_t db = sw128_desc(x0 + k * kBoxBytes + step, 0, 1024);
      if constexpr (kCand == 128)
        wgmma_ss128(sc, da, db);
      else
        wgmma_ss(sc, da, db);
    }
    wgmma_commit();
    if (wg == 0 && it == 0) bar_arrive_consumers();
    wgmma_wait0();
    pin(sc);
    const float zs = intra ? w * s : s;
    const float cw = intra ? w : 1.f;
    // the diagonal: the zeroed intra logit, and pruned the positive too
    const bool edge = r0 + kRowsW > n || c0 + kCand > n ||
                      ((kPruned || intra) && c0 < r0 + kRowsW && r0 < c0 + kCand);
    if (edge)
      coefficients<kPruned, true>(sc, s_fac + st * kCand, s_keep + st * kCand,
                                  s_row + wrow - r0, s_rowk + wrow - r0, intra, zs,
                                  cw, wrow, c0, tq, n);
    else
      coefficients<kPruned, false>(sc, s_fac + st * kCand, s_keep + st * kCand,
                                   s_row + wrow - r0, s_rowk + wrow - r0, intra, zs,
                                   cw, wrow, c0, tq, n);
    // as bf16 hi parts and the bf16 roundings of the remainders: the A
    // fragments of the 16-candidate steps
    uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      acc_to_a_split(hi[kk], lo[kk], sc + 8 * kk, sc + 8 * kk + 4);
    // G += C X, a quarter of the chunk's features at a time, each from zero
    // over the tile's candidates and then added in fp32
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= quarters) break;
      const uint32_t xb = x0 + (4 * fc + q) * kBoxBytes;
      float t[32];
      wgmma_fence();
      wgmma_rs_first(t, hi[0], sw128_desc(xb, 1024, 1024));
      wgmma_rs(t, lo[0], sw128_desc(xb, 1024, 1024));
#pragma unroll
      for (int kk = 1; kk < kSteps; ++kk) {
        const uint64_t db = sw128_desc(xb + kk * 16 * 128, 1024, 1024);
        wgmma_rs(t, hi[kk], db);
        wgmma_rs(t, lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
      pin(t);
      pin(hi);
      pin(lo);
#pragma unroll
      for (int i = 0; i < 32; ++i) run[q][i] += t[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  const int f0 = kOutF * fc + 2 * tq;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + 8 * (e >> 1);
        const int f = f0 + kBoxF * q + 8 * j + (e & 1);
        if (row < n && f < d) out[(size_t)row * d + f] = out_scale * run[q][4 * j + e];
      }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch plan
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, through the runtime's entry-point
// query (no -lcuda)
static cudaError_t encode_fn(EncodeTiled* fn) {
  static std::mutex mu;
  static EncodeTiled cached = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a row-major [n, d] bf16 matrix in boxes of `rows` rows
// x 64 features, 128-byte swizzled (d % 8 == 0 and a 16-byte aligned base:
// TMA's stride and address rules)
static cudaError_t tensor_map(CUtensorMap* map, const void* base, int n, int d,
                              int rows) {
  EncodeTiled encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {kBoxF, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The stages of the ring that fit beside the anchor tile: up to 4, at
// least 2 (d <= 384 at cand_rows)
inline int ring_stages(int cand, int boxes) {
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes(cand, boxes, stages) > (size_t)kSmemLimit) --stages;
  return stages;
}

// The SM count of the current device, and kernel `fn`'s dynamic shared
// memory limit raised to kSmemLimit there: once per (device, kernel)
static cudaError_t prepare(const void* fn, int* sms) {
  struct Entry {
    int dev;
    const void* fn;
    int sms;
  };
  constexpr int kEntries = 16;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].fn == fn) {
      *sms = cache[i].sms;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (used < kEntries) cache[used++] = Entry{dev, fn, *sms};
  return cudaSuccess;
}

}  // namespace loss_wgmma
