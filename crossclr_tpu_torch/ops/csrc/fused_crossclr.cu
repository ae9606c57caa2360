// One direction of the CrossCLR-intra logsumexp and its anchor gradient for
// Hopper (sm_90a): two kernels with a plain C interface.
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
// recomputing the logits it needs; the forward keeps a running max and sum
// per row (the TPU kernel carries them across its sequential grid in VMEM
// scratch), the backward keeps its gradient rows [64, <= 512 features] in
// shared memory and adds coefficient-tile x candidate-tile products into
// them; wider features split over blockIdx.y, each y recomputing the
// logits.  Every output element has one writer and every sum a fixed
// order: no atomics, runs are bit-reproducible.  The tiles are those of
// loss_tiles.cuh, shared with fused_dual.cu: 64 x 64 logit products over d
// in 32-feature chunks, fp32 accumulation for both tiers.  Edges of n and d
// are masked, so any n and d run unpadded; indices past 2^31 are formed in
// size_t, and the diagonal is found as row == col.
//
// What bounds it on this card: scalar fp32 FMAs issued from shared memory.
// The forward does 2·n²·d FMAs, the backward 4·n²·d, where the function
// needs 1.5 and 3.5 products of n²·d (A·Aᵀ is symmetric, so one triangle
// suffices; chip_smoke.py's bound counts that).  Tensor-core products (mma
// / wgmma on bf16 tiles) and sharing the intra triangle are the next steps.

#include <math.h>
#include <stddef.h>

#include "loss_tiles.cuh"

namespace {

using namespace loss_tiles;

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

template <typename T, bool kFactored>
cudaError_t launch_bwd(const void* a, const void* o, float s, float w,
                       const float* lse_a, const float* lse_o,
                       const float* g_a, const float* g_o, float* out, int n,
                       int d, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      direction_bwd_kernel<T, kFactored>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles(n), (d + kOutChunk - 1) / kOutChunk);
  direction_bwd_kernel<T, kFactored><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(o), s, w, lse_a, lse_o,
      g_a, g_o, out, n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_form(bool factored, const void* a, const void* o,
                            float s, float w, const float* la,
                            const float* lo, const float* ga,
                            const float* go, float* out, int n, int d,
                            cudaStream_t st) {
  return factored
             ? launch_bwd<T, true>(a, o, s, w, la, lo, ga, go, out, n, d, st)
             : launch_bwd<T, false>(a, o, s, w, la, lo, ga, go, out, n, d, st);
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
  if (dtype == 0)
    return (int)launch_bwd_form<float>(factored != 0, anchor, other, scale, w,
                                       la, lo, ga, go, out, n, d, st);
  return (int)launch_bwd_form<__nv_bfloat16>(factored != 0, anchor, other,
                                             scale, w, la, lo, ga, go, out, n,
                                             d, st);
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
