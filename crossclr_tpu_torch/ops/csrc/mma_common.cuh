// The bf16 tensor-core pieces shared by the port's kernels (flash_fwd.cu and
// flash_bwd.cu through flash_common.cuh, fused_crossclr.cu and fused_dual.cu
// through loss_mma.cuh): 16-byte cp.async staging, ldmatrix, mma.sync and
// their fragment index map.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// ---------------------------------------------------------------------------
// Fragment index map of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// written once here; every tensor-core kernel of the port, and the keep()
// index of every flash accumulator element, rely on it.
// lane = threadIdx.x % 32, g = lane / 4, t = lane % 4; a register of "two
// bf16" holds the lower column (or k) index in its low 16 bits.
//   A, 16 x 16 (rows x k), four registers of two bf16:
//     a[0] = (row g,     k 2t, 2t+1)     a[1] = (row g + 8, k 2t, 2t+1)
//     a[2] = (row g,     k 2t+8, 2t+9)   a[3] = (row g + 8, k 2t+8, 2t+9)
//   B, 16 x 8 (k x cols), two registers of two bf16:
//     b[0] = (k 2t, 2t+1; col g)         b[1] = (k 2t+8, 2t+9; col g)
//   C, 16 x 8 fp32, four floats:
//     c[0], c[1] = (row g, cols 2t, 2t+1)
//     c[2], c[3] = (row g + 8, cols 2t, 2t+1)
// So element e of an accumulator sits at (row g + 8 (e / 2), col 2t + e % 2),
// and the accumulators of two neighbouring 8-column tiles, c0 and c1,
// converted to bf16 pairs, are the A fragment of a product that is 16 deep
// over those 16 columns: {c0[0:2], c0[2:4], c1[0:2], c1[2:4]}
// (acc_to_a_split).
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of lane l receives matrix i's
// (row l / 4, cols 2 (l % 4), +1), or with .trans its (rows 2 (l % 4), +1;
// col l / 4).  The three address maps below (ld_a, ld_b, ld_b_trans) turn
// a 16 x 16 tile of a row-major shared array into the fragments above.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a · b (A 16 x 16, B 16 x 8, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a register of two bf16, x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment of two neighbouring accumulator tiles (the map above) in
// two parts, hi = bf16(x) and lo = bf16(x - hi), so that hi·B + lo·B
// carries x to about 16 significant bits where one bf16 rounding of the
// operand is too coarse for the product's limit.
__device__ __forceinline__ void acc_to_a_split(uint32_t hi[4], uint32_t lo[4],
                                               const float c0[4],
                                               const float c1[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* c = i < 2 ? c0 : c1;
    const float x0 = c[2 * (i & 1)], x1 = c[2 * (i & 1) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
  }
}

// Address of this lane's row for the A fragment of the 16 x 16 tile at
// (row 0, col 0) of `base`: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15),
// in the order a[0..3].
template <int kLd>
__device__ __forceinline__ const bf16* ld_a(const bf16* base, int lane) {
  return base + (lane & 15) * kLd + ((lane >> 4) << 3);
}
// The B fragments of two 8-column tiles whose columns are rows 0-7 and 8-15
// of `base` (the product's k runs along the shared row): r[0], r[1] are
// b[0], b[1] of the first, r[2], r[3] of the second.
template <int kLd>
__device__ __forceinline__ const bf16* ld_b(const bf16* base, int lane) {
  return base + (((lane >> 4) << 3) + (lane & 7)) * kLd + (((lane >> 3) & 1) << 3);
}
// With .trans: the B fragments of two 8-column tiles whose k runs down the
// rows 0-15 of `base` and whose columns are the shared columns 0-7 and 8-15.
template <int kLd>
__device__ __forceinline__ const bf16* ld_b_trans(const bf16* base, int lane) {
  return base + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + ((lane >> 4) << 3);
}

// 16-byte alignment of a device pointer (host side)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace tc
