// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, fp32/bf16 loads and stores, and the attention-dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

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
// folded batch·head range.  The forward, dq and dk/dv kernels all call this
// with the same (bh, query, key), so they agree on every element.
__device__ __forceinline__ bool keep(const Dropout& d, int bh, int qi, int kj) {
  uint32_t hq = static_cast<uint32_t>(d.q_offset + qi) * 0x9E3779B1u;
  hq ^= hq >> 15;
  hq *= 0x735A2D97u;
  uint32_t hk = static_cast<uint32_t>(d.k_offset + kj) * 0x85EBCA77u;
  hk ^= hk >> 13;
  hk *= 0xC2B2AE3Du;
  const uint32_t bh_term = static_cast<uint32_t>(bh + d.bh_offset + 1) * kBhPrime;
  uint32_t u = hq + hk + bh_term + d.seed;
  u ^= u >> 16;
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return static_cast<float>(u >> 8) * (1.0f / 16777216.0f) >= d.rate;
}

}  // namespace flash
