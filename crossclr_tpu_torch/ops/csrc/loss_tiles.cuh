// Pieces shared by the CrossCLR logsumexp kernels (fused_dual.cu,
// fused_crossclr.cu): the tile sizes, the 64 x 64 logit tile over d
// features, and the coefficient-tile x candidate-tile product of the
// backward.  A block of 256 threads owns a 64-row anchor tile; each thread
// a 4 x 4 micro tile.  Operands are staged through shared memory in
// 32-feature chunks, fp32 or bf16 widened to fp32 on load, so both tiers
// accumulate in fp32.  Edges of n and d are masked; row offsets are formed
// in size_t.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace loss_tiles {

constexpr int kTile = 64;         // anchor rows per block = candidate rows per tile
constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 micro tile each
constexpr int kChunk = 32;        // features per staged chunk of a logit product
constexpr int kLd = kTile + 4;    // padded row stride, float4-aligned
constexpr int kOutChunk = 512;    // gradient features one backward block owns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// s[k][r] = x[r0 + r][k0 + k] for a 64-row x 32-feature chunk, 0 outside.
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ x, int r0,
                                            int k0, int n, int d, float* s) {
  for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
    const int r = i / kChunk, k = i - r * kChunk;
    const int row = r0 + r, col = k0 + k;
    s[k * kLd + r] =
        (row < n && col < d) ? to_f32(x[(size_t)row * d + col]) : 0.f;
  }
}

// acc[r][c] = <x[x0 + 4ty + r], y[y0 + 4tx + c]> over all d features.
template <typename T>
__device__ void tile_dot(const T* __restrict__ x, int x0,
                         const T* __restrict__ y, int y0, int n, int d,
                         float* sx, float* sy, float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();  // the previous readers of sx, sy are done
    stage_chunk(x, x0, k0, n, d, sx);
    stage_chunk(y, y0, k0, n, d, sy);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sx + k * kLd + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(sy + k * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// sout[r][f] += Σ_c sc[r][c] · x[c0 + c][d0 + f] for f < dc.  `so` is a
// [kTile][kLd] staging area (it aliases the logit chunks sx, sy).
template <typename T>
__device__ void add_product(const float* sc, const T* __restrict__ x, int c0,
                            int n, int d, int d0, int dc, float* so,
                            float* sout, int ldo) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int f0 = 0; f0 < dc; f0 += kTile) {
    __syncthreads();  // sc is written; the previous readers of so are done
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int c = i / kTile, f = i - c * kTile;
      const int row = c0 + c;
      so[c * kLd + f] = (row < n && f0 + f < dc)
                            ? to_f32(x[(size_t)row * d + d0 + f0 + f])
                            : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(so + c * kLd + 4 * tx);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = sc[(4 * ty + r) * kLd + c];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(a, bv[k], acc[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + 4 * tx + k;
        if (f < dc) sout[(4 * ty + r) * ldo + f] += acc[r][k];
      }
  }
}

// The row stride of a backward block's gradient rows of dc features.
__host__ __device__ __forceinline__ int out_ld(int dc) {
  return (dc + kTile - 1) / kTile * kTile + 4;
}

inline int row_tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace loss_tiles
