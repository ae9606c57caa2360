// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` in crossclr_tpu/ops/flash_attention.py
// (launched by `_flash_fwd`): online-softmax attention over q, k, v
// [BH, S, Dh] with an optional [B, S] key-padding mask (1 = valid), emitting
// out [BH, S, Dh] in q's dtype and the per-row logsumexp lse [BH, S] in fp32,
// with optional attention-probability dropout.
//
// Semantics kept from the TPU kernel, in both builds:
//   * a masked logit is -inf, so its probability is exactly 0;
//   * the running max has a finite floor of -1e30, so a key tile with no
//     valid key never computes -inf - (-inf);
//   * a query row with no valid key emits 0 and lse = -1e30 + log(1);
//   * scores, softmax statistics and the output accumulate in fp32;
//   * dropout (rate > 0): the keep mask is the stateless hash of the global
//     (bh, query, key) indices (flash_common.cuh); only the P·V accumulation
//     sees it, the softmax denominator keeps every term, and the output is
//     scaled by 1/(1-rate)/l.  lse does not depend on the mask.
// The dropout branch is a template argument: rate 0 compiles it out.
//
// Two builds, two designs.
//
// fp32 (flash_fwd_kernel): IEEE fp32 products, which tensor cores do not
// offer.  One block of 256 threads per (bh, 64-row query tile); 64-row K/V
// tiles stream through shared memory; four threads share a query row, each
// scoring 16 of a tile's keys with scalar FMAs and owning every fourth head
// dimension of the output.  Bound by instruction throughput and
// shared-memory traffic, not by device memory.
//
// bf16 (flash_fwd_bf16_kernel): the products on tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators).  At the towers'
// shapes (S <= 128, Dh = 48) the work is S/2 = 48 operations per byte
// moved at S = 96, far below the card's ~295, so the bytes bound it: q,
// k, v read once and out written once.  The design reads each once and
// keeps every intermediate in registers:
//   * one block per (bh, query tile of up to 128 rows), one warp per 16
//     query rows, so at S = 96 a (bh) is one block of 6 warps that scores
//     96 x 96 and no row past round16(S);
//   * K and V go into shared memory in 64-row stages by 16-byte cp.async
//     (element loads where dh % 8 != 0), rows padded by 16 bytes so that
//     ldmatrix meets no bank conflict; for S <= 128 both stages are loaded
//     at once and the whole head stays resident, longer S streams them
//     through the two stages as a double buffer;
//   * each warp loads its Q fragments once (ldmatrix), scores a stage by
//     mma against K (ldmatrix), keeps the running max and sum of its rows
//     in registers (reduced over the quad of lanes that share a row by
//     shuffles), applies keep() per accumulator element, converts P^ to
//     bf16 A fragments in registers (the accumulator layout is the A
//     layout, flash_common.cuh) and multiplies by V read with
//     ldmatrix.trans; P never touches shared memory;
//   * the output goes out through the warp's own Q rows in shared memory
//     as 16-byte stores.
// The TPU kernel's default-tier `jnp.dot(p_v, v)` rounds P^ to bf16 once,
// in a single MXU pass.  Here P^ goes in as a bf16 hi part and a bf16 lo
// part (the remainder), two products on each V fragment, so P^ carries
// about 16 bits: one rounding flips about 30% of the bf16 outputs by an
// ulp, the backward's delta = rowsum(dO * out) sums those flips, and dk
// then left the limits against the fp32 plain backward on the card at
// B = 1024.  The kernel stays bound by bytes.  The head dim is padded to a
// multiple of 16 in shared memory (zero-filled) and is a template
// argument; any S >= 1 and any Dh <= 128 run, and Dh in (176, 192] for
// latent attention (MLA), whose 128-wide values the caller zero-pads to the
// query/key width and whose extra output columns it drops.

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

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the header).  Shared memory, in bf16 rows of
// stride Tile<kDhp>::kLd: the block's Q rows, then K and V of
// min(round16(S), 128) rows each (stage 0 at row 0, stage 1 at row 64),
// then two stages of 64 key-valid flags (fp32).
// ---------------------------------------------------------------------------

// `rows` = min(round16(S), 128) query rows, and as many K and V rows
size_t bf16_smem_bytes(int rows, int dhp) {
  return sizeof(bf16) * (size_t)(3 * rows) * (dhp + 8) +
         sizeof(float) * 2 * kStageRows;
}

// Stage key tile `t` (rows 64 t ...) of K and V and its key-valid flags.
template <int kDhp>
__device__ __forceinline__ void stage_kv(bf16* sk, bf16* sv, float* sflag,
                                         const bf16* k, const bf16* v,
                                         const float* mrow, int t, int s,
                                         int dh, bool vec) {
  using T = Tile<kDhp>;
  const int k0 = t * kStageRows;
  const int rows = min(kStageRows, round16(s - k0));
  const int off = (t & 1) * kStageRows;
  stage_rows<kDhp>(sk + off * T::kLd, k, k0, rows, s, dh, vec, threadIdx.x,
                   blockDim.x);
  stage_rows<kDhp>(sv + off * T::kLd, v, k0, rows, s, dh, vec, threadIdx.x,
                   blockDim.x);
  for (int c = threadIdx.x; c < kStageRows; c += blockDim.x) {
    const int kj = k0 + c;
    sflag[off + c] =
        (kj < s && (mrow == nullptr || mrow[kj] > 0.5f)) ? 1.f : 0.f;
  }
}

template <int kDhp, bool kDrop>
__global__ void __launch_bounds__(kMaxResident * 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ mask,
                      bf16* __restrict__ out, float* __restrict__ lse, int s,
                      int dh, int heads, float scale, Dropout drop, bool vec) {
  using T = Tile<kDhp>;
  constexpr int kN = 2 * T::kSteps;  // 8-wide output tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int q_rows = blockDim.x / 2;  // 16 per warp
  const int kv_rows = min(round16(s), kMaxResident);
  bf16* sq = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sk = sq + q_rows * T::kLd;
  bf16* sv = sk + kv_rows * T::kLd;
  float* sflag = reinterpret_cast<float*>(sv + kv_rows * T::kLd);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * q_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + warp * 16;  // this warp's first query row
  const bool active = row0 < s;
  const size_t base = (size_t)bh * s * dh;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * s;
  const int tiles = (s + kStageRows - 1) / kStageRows;

  stage_rows<kDhp>(sq, q + base, q0, q_rows, s, dh, vec, threadIdx.x, blockDim.x);
  stage_kv<kDhp>(sk, sv, sflag, k + base, v + base, mrow, 0, s, dh, vec);
  cp_async_commit();

  uint32_t qf[T::kSteps][4];
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kMaxFloor, kMaxFloor}, l[2] = {0.f, 0.f};
  uint32_t hq[2] = {0u, 0u}, hbh = 0u;
  if (kDrop) {
    hq[0] = keep_query_word(drop, row0 + g);
    hq[1] = keep_query_word(drop, row0 + g + 8);
    hbh = keep_bh_word(drop, bh);
  }

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_kv<kDhp>(sk, sv, sflag, k + base, v + base, mrow, t + 1, s, dh, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < T::kSteps; ++ks)
          ldmatrix_x4(qf[ks], ld_a<T::kLd>(sq + warp * 16 * T::kLd + 16 * ks, lane));
      }
      const int k0 = t * kStageRows;
      const int groups = min(4, round16(s - k0) / 16);  // 16-key groups
      const bf16* kt = sk + (t & 1) * kStageRows * T::kLd;
      const bf16* vt = sv + (t & 1) * kStageRows * T::kLd;
      const float* ft = sflag + (t & 1) * kStageRows;

      // S = Q K^T over the stage's keys, masked and scaled
      float sc[8][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        if (grp < groups) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[2 * grp][e] = sc[2 * grp + 1][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < T::kSteps; ++ks) {
            uint32_t b[4];
            ldmatrix_x4(b, ld_b<T::kLd>(kt + 16 * grp * T::kLd + 16 * ks, lane));
            mma_bf16(sc[2 * grp], qf[ks], b[0], b[1]);
            mma_bf16(sc[2 * grp + 1], qf[ks], b[2], b[3]);
          }
#pragma unroll
          for (int j = 2 * grp; j < 2 * grp + 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = ft[8 * j + 2 * tq + (e & 1)] > 0.5f;
              sc[j][e] = ok ? scale * sc[j][e] : -INFINITY;
              mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
            }
        }
      }
      // the online softmax of rows g and g + 8, over the row's quad
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(fmaxf(m[r], mx[r]), kMaxFloor);
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        if (grp < groups) {
#pragma unroll
          for (int j = 2 * grp; j < 2 * grp + 2; ++j) {
            uint32_t hk[2] = {0u, 0u};
            if (kDrop) {
              hk[0] = keep_key_word(drop, k0 + 8 * j + 2 * tq);
              hk[1] = keep_key_word(drop, k0 + 8 * j + 2 * tq + 1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = __expf(sc[j][e] - m[e >> 1]);  // masked: 0
              psum[e >> 1] += p;
              // what the values see
              sc[j][e] = (!kDrop || keep_words(drop, hq[e >> 1], hk[e & 1], hbh))
                             ? p : 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l[r] = l[r] * alpha[r] + psum[r];
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P^ V: P^ from the accumulators in registers as a bf16 hi and
      // lo part, two products on each V fragment (ldmatrix.trans)
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        if (grp < groups) {
          uint32_t hi[4], lo[4];
          acc_to_a_split(hi, lo, sc[2 * grp], sc[2 * grp + 1]);
#pragma unroll
          for (int np = 0; np < T::kSteps; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, ld_b_trans<T::kLd>(
                                     vt + 16 * grp * T::kLd + 16 * np, lane));
            mma_bf16(o[2 * np], hi, b[0], b[1]);
            mma_bf16(o[2 * np], lo, b[0], b[1]);
            mma_bf16(o[2 * np + 1], hi, b[2], b[3]);
            mma_bf16(o[2 * np + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    if (t + 2 < tiles) __syncthreads();  // stage t & 1 is refilled next
  }

  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;  // fully masked row: emit 0
    inv[r] = (kDrop ? static_cast<float>(1.0 / (1.0 - (double)drop.rate)) : 1.f) /
             safe_l;
    const int qi = row0 + g + 8 * r;
    if (tq == 0 && qi < s) lse[(size_t)bh * s + qi] = m[r] + logf(safe_l);
  }
  store_rows<kDhp>(sq + warp * 16 * T::kLd, o, inv[0], inv[1], out + base, row0,
                   s, dh, vec, lane);
}

template <int kDhp, bool kDrop>
cudaError_t launch_bf16_variant(const bf16* q, const bf16* k, const bf16* v,
                                const float* mask, bf16* out, float* lse,
                                int bh, int s, int dh, int heads, float scale,
                                const Dropout& drop, bool vec,
                                cudaStream_t stream) {
  // S <= 128: one block per (bh), one warp per 16 rows; else 128-row blocks
  const int q_rows = round16(s) < kMaxResident ? round16(s) : kMaxResident;
  const size_t smem = bf16_smem_bytes(q_rows, kDhp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<kDhp, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + q_rows - 1) / q_rows);
  flash_fwd_bf16_kernel<kDhp, kDrop><<<grid, 2 * q_rows, smem, stream>>>(
      q, k, v, mask, out, lse, s, dh, heads, scale, drop, vec);
  return cudaGetLastError();
}

template <int kDhp>
cudaError_t launch_bf16_dh(const bf16* q, const bf16* k, const bf16* v,
                           const float* mask, bf16* out, float* lse, int bh,
                           int s, int dh, int heads, float scale,
                           const Dropout& drop, bool vec, cudaStream_t stream) {
  if (drop.rate > 0.f)
    return launch_bf16_variant<kDhp, true>(q, k, v, mask, out, lse, bh, s, dh,
                                           heads, scale, drop, vec, stream);
  return launch_bf16_variant<kDhp, false>(q, k, v, mask, out, lse, bh, s, dh,
                                          heads, scale, drop, vec, stream);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* mask, void* out, float* lse, int bh, int s,
                        int dh, int heads, float scale, const Dropout& drop,
                        cudaStream_t stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  const bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(out);
#define FLASH_FWD_BF16(DHP)                                                   \
  case DHP / 16:                                                              \
    return launch_bf16_dh<DHP>(qb, kb, vb, mask, ob, lse, bh, s, dh, heads,  \
                               scale, drop, vec, stream);
  switch (round16(dh) / 16) {
    FLASH_FWD_BF16(16)
    FLASH_FWD_BF16(32)
    FLASH_FWD_BF16(48)
    FLASH_FWD_BF16(64)
    FLASH_FWD_BF16(80)
    FLASH_FWD_BF16(96)
    FLASH_FWD_BF16(112)
    FLASH_FWD_BF16(128)
    FLASH_FWD_BF16(192)
  }
#undef FLASH_FWD_BF16
  return cudaErrorInvalidValue;
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
// key indices and its bh range inside the global ones (0 on one device);
// the call's `heads` are heads [head_offset, head_offset + heads) of
// head_count (head_count = heads, head_offset = 0 on one device).
// Returns a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int crossclr_flash_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* mask, void* out,
                                  void* lse, int bh, int s, int dh, int heads,
                                  float scale, float rate, unsigned int seed,
                                  int q_offset, int k_offset, int bh_offset,
                                  int head_count, int head_offset,
                                  void* stream) {
  if (bh < 1 || s < 1 || dh < 1 || heads < 1 || bh % heads ||
      !(dtype == 1 ? bf16_head_dim(dh) : dh <= kMaxDh) ||
      !(rate >= 0.f && rate < 1.f) || head_offset < 0 ||
      head_offset + heads > head_count)
    return (int)cudaErrorInvalidValue;
  Dropout drop{rate,      seed,  q_offset,   k_offset,    bh_offset,
               heads,     head_count, head_offset, 0u, 0};
  head_divisor(drop);
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, m, out, l, bh, s, dh, heads, scale, drop,
                              st);
  if (dtype == 1)
    return (int)launch_bf16(q, k, v, m, out, l, bh, s, dh, heads, scale, drop,
                            st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
