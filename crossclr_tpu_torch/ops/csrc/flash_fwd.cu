// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` in crossclr_tpu/ops/flash_attention.py
// (launched by `_flash_fwd`): online-softmax attention over q, k, v
// [BH, S, Dh] with an optional [B, S] key-padding mask (1 = valid), emitting
// out [BH, S, Dh] in q's dtype and the per-row logsumexp lse [BH, S] in fp32,
// with optional attention-probability dropout.
//
// Semantics kept from the TPU kernel:
//   * a masked logit is -inf, so its probability is exactly 0;
//   * the running max has a finite floor of -1e30, so a key tile with no
//     valid key never computes -inf - (-inf);
//   * a query row with no valid key emits 0 and lse = -1e30 + log(1);
//   * scores, softmax statistics and the output accumulate in fp32;
//   * dropout (rate > 0): the keep mask is the stateless hash of the global
//     (bh, query, key) indices (flash_common.cuh); only the P·V accumulation
//     sees it, the softmax denominator keeps every term, and the output is
//     scaled by 1/(1-rate)/l.  lse does not depend on the mask.
//
// Design: one block of 256 threads per (bh, 64-row query tile); 64-row K/V
// tiles stream through shared memory.  Four threads share a query row: each
// scores 16 of the tile's 64 keys and owns every fourth head dimension of
// the output accumulator, which lives in registers.  The row's max and sum
// reduce over the four lanes with warp shuffles.  Edges of S and Dh are
// masked in the kernel, so any S and any Dh <= 128 run without padding.
// The dropout branch is a template argument: rate 0 compiles the branch out.
//
// What bounds it on this card: the products run as scalar fp32 FMAs out of
// shared memory, so the kernel is bound by instruction throughput, not by
// device memory (q, k, v are read once per query tile).  Tensor-core products
// (mma / wgmma), TMA loads and a pipelined K/V ring are the next steps.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

size_t smem_bytes(int dh) {
  const size_t ld = dh + 1;
  return sizeof(float) * (kBlockQ * ld          // Q tile, padded rows
                          + kBlockK * ld        // K tile, padded rows
                          + kBlockK * dh        // V tile
                          + kBlockQ * (kBlockK + 1)  // P tile, padded rows
                          + kBlockK);           // key-valid flags
}

// MaxDh bounds the head dim at compile time (64 or 128), so a thread's
// accumulator holds MaxDh / 4 registers and no more.
template <typename T, int MaxDh, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int s, int dh,
                 int heads, float scale, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* sq = smem;
  float* sk = sq + kBlockQ * ld;
  float* sv = sk + kBlockK * ld;
  float* sp = sv + kBlockK * dh;
  float* svalid = sp + kBlockQ * (kBlockK + 1);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int lane4 = tid & 3;
  const size_t base = (size_t)bh * s * dh;
  // the [B, S] mask is indexed by batch entry, not repeated per head
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * s;

  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int qi = q0 + r;
    sq[r * ld + d] = qi < s ? load_f32(q + base + (size_t)qi * dh + d) : 0.f;
  }

  constexpr int kDimsPerThread = MaxDh / 4;
  float m = kMaxFloor;
  float l = 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V/P readers are done
    for (int i = tid; i < kBlockK * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const int kj = k0 + r;
      const bool in = kj < s;
      sk[r * ld + d] = in ? load_f32(k + base + (size_t)kj * dh + d) : 0.f;
      sv[r * dh + d] = in ? load_f32(v + base + (size_t)kj * dh + d) : 0.f;
    }
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      svalid[tid] = (kj < s && (mrow == nullptr || mrow[kj] > 0.5f)) ? 1.f : 0.f;
    }
    __syncthreads();

    // scores of this thread's keys c = lane4 + 4 j
    float sc[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) sc[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = sq[row * ld + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        sc[j] = fmaf(qd, sk[(lane4 + 4 * j) * ld + d], sc[j]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      sc[j] = svalid[lane4 + 4 * j] > 0.5f ? scale * sc[j] : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(fmaxf(m, tmax), kMaxFloor);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = expf(sc[j] - m_new);  // exp(-inf) = 0 for masked keys
      psum += p;
      float p_v = p;  // what the values see
      if (kDrop && !keep(drop, bh, q0 + row, k0 + lane4 + 4 * j)) p_v = 0.f;
      sp[row * (kBlockK + 1) + lane4 + 4 * j] = p_v;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four lanes share one warp

    // acc = acc * alpha + P V over this thread's dims d = lane4 + 4 i
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = sp[row * (kBlockK + 1) + c];
      const float* vrow = sv + c * dh + lane4;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        if (lane4 + 4 * i < dh) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
  }

  const int qi = q0 + row;
  if (qi < s) {
    const float safe_l = l > 0.f ? l : 1.f;  // fully masked row: emit 0
    float inv = 1.f / safe_l;
    if (kDrop) inv = static_cast<float>(1.0 / (1.0 - (double)drop.rate)) / safe_l;
    T* orow = out + base + (size_t)qi * dh;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = lane4 + 4 * i;
      if (d < dh) store_f32(orow + d, acc[i] * inv);
    }
    if (lane4 == 0) lse[(size_t)bh * s + qi] = m + logf(safe_l);
  }
}

template <typename T, int MaxDh, bool kDrop>
cudaError_t launch_variant(const void* q, const void* k, const void* v,
                           const float* mask, void* out, float* lse, int bh,
                           int s, int dh, int heads, float scale,
                           const Dropout& drop, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, MaxDh, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, MaxDh, kDrop><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, s, dh, heads,
      scale, drop);
  return cudaGetLastError();
}

template <typename T, int MaxDh>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const float* mask, void* out, float* lse, int bh, int s,
                      int dh, int heads, float scale, const Dropout& drop,
                      cudaStream_t stream) {
  if (drop.rate > 0.f)
    return launch_variant<T, MaxDh, true>(q, k, v, mask, out, lse, bh, s, dh,
                                          heads, scale, drop, stream);
  return launch_variant<T, MaxDh, false>(q, k, v, mask, out, lse, bh, s, dh,
                                         heads, scale, drop, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, int bh, int s,
                   int dh, int heads, float scale, const Dropout& drop,
                   cudaStream_t stream) {
  if (dh <= 64)
    return launch_dh<T, 64>(q, k, v, mask, out, lse, bh, s, dh, heads, scale,
                            drop, stream);
  return launch_dh<T, kMaxDh>(q, k, v, mask, out, lse, bh, s, dh, heads, scale,
                              drop, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mask may be null.  rate in [0, 1);
// seed already folded to [0, 2^23); the offsets place the call's query and
// key indices and its bh range inside the global ones (0 on one device).
// Returns a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int crossclr_flash_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* mask, void* out,
                                  void* lse, int bh, int s, int dh, int heads,
                                  float scale, float rate, unsigned int seed,
                                  int q_offset, int k_offset, int bh_offset,
                                  void* stream) {
  if (bh < 1 || s < 1 || dh < 1 || dh > kMaxDh || heads < 1 || bh % heads ||
      !(rate >= 0.f && rate < 1.f))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{rate, seed, q_offset, k_offset, bh_offset};
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, m, out, l, bh, s, dh, heads, scale, drop,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, m, out, l, bh, s, dh, heads,
                                      scale, drop, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
