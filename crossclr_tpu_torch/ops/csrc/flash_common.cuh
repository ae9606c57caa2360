// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, fp32/bf16 loads and stores, the attention-dropout hash, and
// the bf16 tensor-core pieces (shared-memory staging, ldmatrix, mma.sync and
// their fragment index map).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// the scalar fp32 kernels (and dq in both builds)
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 4 * kBlockQ;  // four threads per tile row
constexpr int kMaxDh = 128;
constexpr int kColsPerThread = kBlockK / 4;
constexpr float kMaxFloor = -1e30f;  // crossclr_tpu _MAX_FLOOR
constexpr uint32_t kBhPrime = 0x27D4EB2Fu;  // crossclr_tpu _BH_PRIME

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The dropout words of one launch: the JAX kernels' (1, 4) SMEM operand
// [seed, q_offset, k_offset, bh_offset] (`seed_operand`), the seed already
// folded to [0, 2^23) by the caller, and the rate.
struct Dropout {
  float rate;
  uint32_t seed;
  int q_offset;
  int k_offset;
  int bh_offset;
};

// crossclr_tpu `_hash_keep` / `_keep_from_grids`, bit for bit: each index
// mixed on its own (xorshift-multiply), the words summed with the
// per-(batch·head) term and the seed, a murmur3 finalizer, the top 24 bits
// as a uniform in [0, 1), kept where it is >= rate.  `qi`, `kj` and `bh`
// are local; the offsets place them in the global sequence and the global
// folded batch·head range.  Every flash kernel calls this (or the three
// words and keep_words, which give the same bits: the sum is mod 2^32) with
// the same (bh, query, key), so they agree on every element.
__device__ __forceinline__ uint32_t keep_query_word(const Dropout& d, int qi) {
  uint32_t hq = static_cast<uint32_t>(d.q_offset + qi) * 0x9E3779B1u;
  hq ^= hq >> 15;
  return hq * 0x735A2D97u;
}
__device__ __forceinline__ uint32_t keep_key_word(const Dropout& d, int kj) {
  uint32_t hk = static_cast<uint32_t>(d.k_offset + kj) * 0x85EBCA77u;
  hk ^= hk >> 13;
  return hk * 0xC2B2AE3Du;
}
// the per-(batch·head) term plus the seed
__device__ __forceinline__ uint32_t keep_bh_word(const Dropout& d, int bh) {
  return static_cast<uint32_t>(bh + d.bh_offset + 1) * kBhPrime + d.seed;
}
__device__ __forceinline__ bool keep_words(const Dropout& d, uint32_t hq,
                                           uint32_t hk, uint32_t hbh) {
  uint32_t u = hq + hk + hbh;
  u ^= u >> 16;
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return static_cast<float>(u >> 8) * (1.0f / 16777216.0f) >= d.rate;
}
__device__ __forceinline__ bool keep(const Dropout& d, int bh, int qi, int kj) {
  return keep_words(d, keep_query_word(d, qi), keep_key_word(d, kj),
                    keep_bh_word(d, bh));
}

// ---------------------------------------------------------------------------
// bf16 tensor-core pieces (flash_fwd_bf16_kernel, flash_dkv_bf16_kernel)
//
// Fragment index map of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// written once here; both kernels, and the keep() index of every
// accumulator element, rely on it.  lane = threadIdx.x % 32,
// g = lane / 4, t = lane % 4; a register of "two bf16" holds the lower
// column (or k) index in its low 16 bits.
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

// Shared rows are padded by 16 bytes: a stride of (kDhp + 8) bf16 is
// 16 (2m + 1) bytes for kDhp = 16 m, so the eight row addresses of one
// ldmatrix matrix fall on eight different 4-bank groups.
template <int kDhp>
struct Tile {
  static constexpr int kLd = kDhp + 8;       // bf16 per shared row
  static constexpr int kSteps = kDhp / 16;   // 16-wide steps over the head dim
  static constexpr int kChunks = kDhp / 8;   // 16-byte chunks per row
};

constexpr int kStageRows = 64;  // rows of one streamed tile
constexpr int kMaxResident = 2 * kStageRows;  // S up to this stays resident

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

// Stage rows [r0, r0 + rows) of a row-major [S, dh] bf16 matrix into a
// shared tile of stride Tile<kDhp>::kLd.  Rows past S and columns past dh
// are zero, so the products over them add nothing and never meet a stale
// NaN.  `vec` (dh % 8 == 0 and a 16-byte aligned base): 16-byte cp.async
// copies, to be waited for with cp_async_wait; otherwise element loads.
template <int kDhp>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0,
                                           int rows, int s, int dh, bool vec,
                                           int tid, int nthreads) {
  using T = Tile<kDhp>;
  if (vec) {
    for (int i = tid; i < rows * T::kChunks; i += nthreads) {
      const int r = i / T::kChunks, c = (i - r * T::kChunks) * 8;
      bf16* d = dst + r * T::kLd + c;
      if (r0 + r < s && c < dh)
        cp_async16(d, src + (size_t)(r0 + r) * dh + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < rows * kDhp; i += nthreads) {
      const int r = i / kDhp, c = i - r * kDhp;
      dst[r * T::kLd + c] = (r0 + r < s && c < dh)
                                ? src[(size_t)(r0 + r) * dh + c]
                                : __float2bfloat16(0.f);
    }
  }
}

// Write one warp's 16 x kDhp fp32 accumulators (times `mul0` on rows g and
// `mul1` on rows g + 8) as bf16 rows [r0, r0 + 16) of a [S, dh] matrix,
// through the warp's own 16 shared rows `tile` (16-byte stores when `vec`).
// Rows past S and columns past dh are not written.
template <int kDhp>
__device__ __forceinline__ void store_rows(bf16* tile, const float (*acc)[4],
                                           float mul0, float mul1, bf16* dst,
                                           int r0, int s, int dh, bool vec,
                                           int lane) {
  using T = Tile<kDhp>;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's last reads of `tile` are done
#pragma unroll
  for (int n = 0; n < 2 * T::kSteps; ++n) {
    bf16* p = tile + g * T::kLd + 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(p + 8 * T::kLd) =
        __floats2bfloat162_rn(acc[n][2] * mul1, acc[n][3] * mul1);
  }
  __syncwarp();
  if (vec) {
    for (int i = lane; i < 16 * T::kChunks; i += 32) {
      const int r = i / T::kChunks, c = (i - r * T::kChunks) * 8;
      if (r0 + r < s && c < dh)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * dh + c) =
            *reinterpret_cast<const uint4*>(tile + r * T::kLd + c);
    }
  } else {
    for (int i = lane; i < 16 * kDhp; i += 32) {
      const int r = i / kDhp, c = i - r * kDhp;
      if (r0 + r < s && c < dh) dst[(size_t)(r0 + r) * dh + c] = tile[r * T::kLd + c];
    }
  }
}

// 16-byte alignment of a device pointer (host side)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace flash
