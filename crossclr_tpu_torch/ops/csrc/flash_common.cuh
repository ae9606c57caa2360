// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the scalar kernels' loads and stores, the attention-dropout
// hash, and the bf16 tensor-core tiles (shared-memory staging and stores of
// rows); the generic tensor-core pieces (cp.async, ldmatrix, mma.sync and
// their fragment index map) are in mma_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace flash {

using namespace tc;

// the scalar fp32 kernels
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 4 * kBlockQ;  // four threads per tile row
constexpr int kMaxDh = 128;
// the bf16 builds take every head dim up to kMaxDh, and latent attention's
// query/key width of 192 (its values zero-padded to it by the caller)
constexpr int kMlaDh = 192;
__host__ __device__ constexpr bool bf16_head_dim(int dh) {
  return (dh >= 1 && dh <= kMaxDh) || (dh > kMlaDh - 16 && dh <= kMlaDh);
}
constexpr int kColsPerThread = kBlockK / 4;
constexpr float kMaxFloor = -1e30f;  // crossclr_tpu _MAX_FLOOR
constexpr uint32_t kBhPrime = 0x27D4EB2Fu;  // crossclr_tpu _BH_PRIME

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// The dropout words of one launch: the JAX kernels' (1, 4) SMEM operand
// [seed, q_offset, k_offset, bh_offset] (`seed_operand`), the seed already
// folded to [0, 2^23) by the caller, and the rate; then the launch's head
// count, the global head count and the first local head's place among
// them, which place a tensor-parallel rank's heads [head_offset,
// head_offset + heads) of head_count inside the global batch·head range
// (heads == head_count and head_offset 0 on one device), and `heads` as
// a multiply-shift divisor (head_divisor).
struct Dropout {
  float rate;
  uint32_t seed;
  int q_offset;
  int k_offset;
  int bh_offset;
  int heads;
  int head_count;
  int head_offset;
  uint32_t div_mul;
  int div_shr;
};

// `heads` as (mul, shr) with n / heads == __umulhi(n, mul) >> shr for
// every n < 2^31 (the round-up multiply of CUTLASS's FastDivmod); heads
// 1 is (0, 0) and divided by no one.  Host code, once a launch.
inline void head_divisor(Dropout& d) {
  int l = 0;
  while ((1 << l) < d.heads) ++l;  // ceil(log2(heads))
  d.div_mul = d.heads <= 1 ? 0u
      : static_cast<uint32_t>(((1ull << (31 + l)) + d.heads - 1) / d.heads);
  d.div_shr = d.heads <= 1 ? 0 : l - 1;
}

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
// the per-(batch·head) term plus the seed: local bh = b·heads + h sits at
// bh_offset + b·head_count + head_offset + h of the global range (bh +
// bh_offset when the launch holds every head, the parent's arithmetic)
__device__ __forceinline__ uint32_t keep_bh_word(const Dropout& d, int bh) {
  int global = bh + d.bh_offset + d.head_offset;
  if (d.head_count != d.heads) {
    const int b = d.heads == 1 ? bh
        : static_cast<int>(__umulhi(static_cast<uint32_t>(bh), d.div_mul) >> d.div_shr);
    global += b * (d.head_count - d.heads);
  }
  return static_cast<uint32_t>(global + 1) * kBhPrime + d.seed;
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
// bf16 tensor-core tiles (flash_fwd_bf16_kernel, flash_dkv_bf16_kernel,
// flash_dq_bf16_kernel), built on mma_common.cuh and its fragment map
// ---------------------------------------------------------------------------

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

}  // namespace flash
