// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, as in the TPU design.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// crossclr_tpu/ops/flash_attention.py (launched by `_flash_bwd`).  Given
// q, k, v, dO [BH, S, Dh], the forward's lse [BH, S] and
// delta = rowsum(dO * out) [BH, S] (both fp32; delta is computed by the
// caller, as the JAX package computes it outside Pallas), with the same
// optional [B, S] key mask and dropout words as the forward:
//
//   P  = exp(scale * q k^T - lse)      (0 on masked keys and on rows of a
//                                       fully masked entry, lse = -1e30)
//   dP = dO v^T, and with dropout keep * dP / (1 - rate)
//   dS = P * (dP - delta)
//   dq = scale * dS k                  (flash_dq_kernel)
//   dk = scale * dS^T q,  dv = P^^T dO  (flash_dkv_kernel), where
//        P^ = keep * P / (1 - rate) is what the values saw in the forward
//
// dS uses the unmasked P: delta = rowsum(dO * out) already carries the mask
// through out.  Both kernels regenerate the forward's keep mask from the
// global (bh, query, key) indices (flash_common.cuh), so they agree with it
// element for element in either orientation.
//
// Design: one block of 256 threads per (bh, 64-row tile), four threads per
// tile row, as in the forward.  dq: the query tile and its dO stay in shared
// memory while 64-row K/V tiles stream; dk/dv: the key tile and its V stay
// while 64-row Q/dO tiles stream.  Each thread scores 16 of a tile's 64
// columns and owns every fourth head dimension of its row's accumulators,
// which live in registers.  No atomics: every output row is written by one
// block and every sum runs in a fixed order, so runs are bit-reproducible.
// Rows past S add nothing and are not written (the dk/dv kernel skips query
// rows past S explicitly: their lse and delta are not loaded).  Any S and any
// Dh <= 128 run without padding.
//
// What bounds it on this card: scalar fp32 FMAs out of shared memory, as in
// the forward; the backward does 2.5x the forward's products.  Tensor-core
// products, TMA loads and a pipelined ring are the next steps.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

// four [64, Dh] fp32 tiles with padded rows, one [64, 65] P/dS tile, and
// three 64-entry vectors (key-valid flags, or lse, delta and row flags)
size_t smem_bytes(int dh) {
  return sizeof(float) * (4 * kBlockQ * (dh + 1) + kBlockQ * (kBlockK + 1) +
                          3 * kBlockQ);
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int s, int dh, int ld, int tid) {
  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int row = r0 + r;
    dst[r * ld + d] = row < s ? load_f32(src + (size_t)row * dh + d) : 0.f;
  }
}

template <typename T, int MaxDh, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ mask, T* __restrict__ dq, int s,
                int dh, int heads, float scale, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* sq = smem;
  float* sdo = sq + kBlockQ * ld;
  float* sk = sdo + kBlockQ * ld;
  float* sv = sk + kBlockK * ld;
  float* sds = sv + kBlockK * ld;
  float* svalid = sds + kBlockQ * (kBlockK + 1);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int lane4 = tid & 3;
  const size_t base = (size_t)bh * s * dh;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * s;

  load_tile(sq, q + base, q0, s, dh, ld, tid);
  load_tile(sdo, dout + base, q0, s, dh, ld, tid);
  const int qi = q0 + row;
  const bool row_in = qi < s;
  const float lse_r = row_in ? lse[(size_t)bh * s + qi] : 0.f;
  const float delta_r = row_in ? delta[(size_t)bh * s + qi] : 0.f;
  const float inv_keep =
      kDrop ? static_cast<float>(1.0 / (1.0 - (double)drop.rate)) : 1.f;

  constexpr int kDimsPerThread = MaxDh / 4;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sk, k + base, k0, s, dh, ld, tid);
    load_tile(sv, v + base, k0, s, dh, ld, tid);
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      svalid[tid] = (kj < s && (mrow == nullptr || mrow[kj] > 0.5f)) ? 1.f : 0.f;
    }
    __syncthreads();

    // this thread's columns c = lane4 + 4 j: q.k and dO.v
    float sc[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) sc[j] = dp[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = sq[row * ld + d];
      const float od = sdo[row * ld + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int off = (lane4 + 4 * j) * ld + d;
        sc[j] = fmaf(qd, sk[off], sc[j]);
        dp[j] = fmaf(od, sv[off], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane4 + 4 * j;
      const bool ok = row_in && svalid[c] > 0.5f;
      const float p = ok ? expf(scale * sc[j] - lse_r) : 0.f;
      float dpj = dp[j];
      if (kDrop) dpj = keep(drop, bh, qi, k0 + c) ? dpj * inv_keep : 0.f;
      sds[row * (kBlockK + 1) + c] = p * (dpj - delta_r);
    }
    __syncwarp();  // the row's four lanes share one warp

    // acc += dS K over this thread's dims d = lane4 + 4 i
    for (int c = 0; c < kBlockK; ++c) {
      const float ds = sds[row * (kBlockK + 1) + c];
      const float* krow = sk + c * ld + lane4;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        if (lane4 + 4 * i < dh) acc[i] = fmaf(ds, krow[4 * i], acc[i]);
    }
  }

  if (row_in) {
    T* out = dq + base + (size_t)qi * dh;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = lane4 + 4 * i;
      if (d < dh) store_f32(out + d, scale * acc[i]);
    }
  }
}

template <typename T, int MaxDh, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ mask, T* __restrict__ dk,
                 T* __restrict__ dv, int s, int dh, int heads, float scale,
                 Dropout drop) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* sk = smem;
  float* sv = sk + kBlockK * ld;
  float* sq = sv + kBlockK * ld;
  float* sdo = sq + kBlockQ * ld;
  float* sp = sdo + kBlockQ * ld;
  float* slse = sp + kBlockK * (kBlockQ + 1);
  float* sdelta = slse + kBlockQ;
  float* sqin = sdelta + kBlockQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int row = tid >> 2;  // this thread's key row
  const int lane4 = tid & 3;
  const size_t base = (size_t)bh * s * dh;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * s;

  load_tile(sk, k + base, k0, s, dh, ld, tid);
  load_tile(sv, v + base, k0, s, dh, ld, tid);
  const int kj = k0 + row;
  const bool key_ok = kj < s && (mrow == nullptr || mrow[kj] > 0.5f);
  const float inv_keep =
      kDrop ? static_cast<float>(1.0 / (1.0 - (double)drop.rate)) : 1.f;

  constexpr int kDimsPerThread = MaxDh / 4;
  float dk_acc[kDimsPerThread], dv_acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = 0; q0 < s; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sq, q + base, q0, s, dh, ld, tid);
    load_tile(sdo, dout + base, q0, s, dh, ld, tid);
    if (tid < kBlockQ) {
      const int qi = q0 + tid;
      const bool in = qi < s;
      sqin[tid] = in ? 1.f : 0.f;
      slse[tid] = in ? lse[(size_t)bh * s + qi] : 0.f;
      sdelta[tid] = in ? delta[(size_t)bh * s + qi] : 0.f;
    }
    __syncthreads();

    // this thread's query columns c = lane4 + 4 j: k.q and v.dO
    float st[kColsPerThread], dpt[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) st[j] = dpt[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kd = sk[row * ld + d];
      const float vd = sv[row * ld + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int off = (lane4 + 4 * j) * ld + d;
        st[j] = fmaf(kd, sq[off], st[j]);
        dpt[j] = fmaf(vd, sdo[off], dpt[j]);
      }
    }
    float pt[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane4 + 4 * j;
      // query rows past S are skipped here, not trusted to cancel
      const bool ok = key_ok && sqin[c] > 0.5f;
      pt[j] = ok ? expf(scale * st[j] - slse[c]) : 0.f;
      float pv = pt[j];
      if (kDrop) {
        if (keep(drop, bh, q0 + c, kj)) {
          pv *= inv_keep;
          dpt[j] *= inv_keep;
        } else {
          pv = 0.f;
          dpt[j] = 0.f;
        }
      }
      sp[row * (kBlockQ + 1) + c] = pv;  // P^T as the values saw it
    }
    __syncwarp();  // the row's four lanes share one warp
    for (int c = 0; c < kBlockQ; ++c) {
      const float pv = sp[row * (kBlockQ + 1) + c];
      const float* orow = sdo + c * ld + lane4;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        if (lane4 + 4 * i < dh) dv_acc[i] = fmaf(pv, orow[4 * i], dv_acc[i]);
    }
    __syncwarp();  // P^T read; the same tile now takes dS^T
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane4 + 4 * j;
      sp[row * (kBlockQ + 1) + c] = pt[j] * (dpt[j] - sdelta[c]);
    }
    __syncwarp();
    for (int c = 0; c < kBlockQ; ++c) {
      const float ds = sp[row * (kBlockQ + 1) + c];
      const float* qrow = sq + c * ld + lane4;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        if (lane4 + 4 * i < dh) dk_acc[i] = fmaf(ds, qrow[4 * i], dk_acc[i]);
    }
  }

  if (kj < s) {
    T* dk_row = dk + base + (size_t)kj * dh;
    T* dv_row = dv + base + (size_t)kj * dh;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = lane4 + 4 * i;
      if (d < dh) {
        store_f32(dk_row + d, scale * dk_acc[i]);
        store_f32(dv_row + d, dv_acc[i]);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* mask;
  void* dq;
  void* dk;
  void* dv;
  int bh, s, dh, heads;
  float scale;
  Dropout drop;
};

template <typename T, int MaxDh, bool kDrop>
cudaError_t launch_variant(bool dkv, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.dh);
  const dim3 grid(a.bh, (a.s + kBlockQ - 1) / kBlockQ);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(flash_dkv_kernel<T, MaxDh, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<T, MaxDh, kDrop><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.s, a.dh, a.heads, a.scale, a.drop);
  } else {
    err = cudaFuncSetAttribute(flash_dq_kernel<T, MaxDh, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_dq_kernel<T, MaxDh, kDrop><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.dq), a.s,
        a.dh, a.heads, a.scale, a.drop);
  }
  return cudaGetLastError();
}

template <typename T, int MaxDh>
cudaError_t launch_dh(bool dkv, const Args& a, cudaStream_t stream) {
  if (a.drop.rate > 0.f) return launch_variant<T, MaxDh, true>(dkv, a, stream);
  return launch_variant<T, MaxDh, false>(dkv, a, stream);
}

int launch(int dtype, bool dkv, const Args& a, void* stream) {
  if (a.bh < 1 || a.s < 1 || a.dh < 1 || a.dh > kMaxDh || a.heads < 1 ||
      a.bh % a.heads || !(a.drop.rate >= 0.f && a.drop.rate < 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(a.dh <= 64 ? launch_dh<float, 64>(dkv, a, st)
                            : launch_dh<float, kMaxDh>(dkv, a, st));
  if (dtype == 1)
    return (int)(a.dh <= 64 ? launch_dh<__nv_bfloat16, 64>(dkv, a, st)
                            : launch_dh<__nv_bfloat16, kMaxDh>(dkv, a, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients);
// lse and delta fp32 [BH, S]; mask fp32 [B, S] or null.  The dropout words
// are those of the forward.  Each returns a cudaError_t; the launch is
// asynchronous on `stream`.
extern "C" int crossclr_flash_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* mask, void* dq, int bh, int s,
                                 int dh, int heads, float scale, float rate,
                                 unsigned int seed, int q_offset, int k_offset,
                                 int bh_offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<const float*>(mask),
               dq, nullptr, nullptr, bh, s, dh, heads, scale,
               Dropout{rate, seed, q_offset, k_offset, bh_offset}};
  return launch(dtype, false, a, stream);
}

extern "C" int crossclr_flash_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* mask, void* dk, void* dv, int bh,
                                  int s, int dh, int heads, float scale,
                                  float rate, unsigned int seed, int q_offset,
                                  int k_offset, int bh_offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<const float*>(mask),
               nullptr, dk, dv, bh, s, dh, heads, scale,
               Dropout{rate, seed, q_offset, k_offset, bh_offset}};
  return launch(dtype, true, a, stream);
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
