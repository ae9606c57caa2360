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
// Two builds.
//
// fp32 (flash_dq_kernel, flash_dkv_kernel): one block of 256 threads per
// (bh, 64-row tile), four threads per tile row, as in the fp32 forward.
// dq: the query tile and its dO stay in shared memory while 64-row K/V
// tiles stream; dk/dv: the key tile and its V stay while 64-row Q/dO tiles
// stream.  Each thread scores 16 of a tile's 64 columns with scalar FMAs
// and owns every fourth head dimension of its row's accumulators, which
// live in registers.  Bound by instruction throughput and shared-memory
// traffic; the backward does 2.5x the forward's products.
// Rows past S add nothing and are not written (the dk/dv kernel skips query
// rows past S explicitly: their lse and delta are not loaded).  No
// atomics: every output row is written by one block and every sum runs in
// a fixed order, so runs are bit-reproducible.
//
// bf16 (flash_dkv_bf16_kernel, flash_dq_bf16_kernel): the products on
// tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators).  At
// the towers' shapes (S <= 128, Dh = 48) dk/dv does 2S/3 = 64 operations
// per byte moved at S = 96 and dq 3S/5, far below the card's ~295, so the
// bytes bound both: each reads its inputs once and writes its outputs
// once, and keeps every intermediate in registers.
// dk/dv:
//   * one block per (bh, key tile of up to 128 rows), one warp per 16 key
//     rows, so at S = 96 a (bh) is one block of 6 warps and no tile
//     computes a row past round16(S);
//   * each warp holds its K and V rows as mma A fragments in registers
//     (for Dh <= 64; wider heads reload them from shared memory per use,
//     to stay clear of spills) and owns the dk and dv accumulators of its
//     rows;
//   * Q, dO (and lse, delta) go into shared memory in 64-row stages by
//     16-byte cp.async, rows padded by 16 bytes for conflict-free
//     ldmatrix; for S <= 128 the whole head is resident, longer S streams
//     through the two stages as a double buffer;
//   * per 16 queries: S^T = K Q^T and dP^T = V dO^T by mma (Q and dO by
//     ldmatrix), P^T = exp(scale S^T - lse) with lse per query column,
//     keep() per accumulator element on the transposed index, then
//     dV += P^^T dO and dK += dS^T Q with both A operands converted from
//     the accumulators in registers and dO, Q read by ldmatrix.trans;
//     each A operand goes in as a bf16 hi part and a bf16 lo part (the
//     remainder), two products on the same B fragments.
// dq, the same design with the roles swapped:
//   * one block per (bh, query tile of up to 128 rows), one warp per 16
//     query rows; each warp holds its Q and dO rows as A fragments (for
//     Dh <= 64), the lse and delta of its rows g and g + 8 and their
//     dropout query words in registers, and owns the dq accumulators;
//   * K and V go into shared memory in 64-row stages, with a key-valid
//     flag and the key's dropout word per key (resident for S <= 128,
//     double-buffered past it);
//   * per 16 keys: S = Q K^T and dP = dO V^T by mma (K and V by
//     ldmatrix), P = exp(scale S - lse) on valid keys, keep() per
//     accumulator element, dS = P (dP^ - delta) in registers, then
//     dQ += dS K with dS as a hi + lo A operand and K by ldmatrix.trans.
// In both, each warp sums only into its own rows: no cross-warp
// reduction, no atomics, and a run is bit-reproducible.
// The TPU kernels' default-tier `jnp.dot(pT_v, do)`, `jnp.dot(dsT, q)` and
// `jnp.dot(ds, k)` round P^^T and dS to bf16 once, in single MXU passes.
// One rounding is too coarse for the limits against the fp32 plain version
// at wide heads (at Dh = 100 a dk/dv element missed them on the card), so
// the split carries those operands to about 16 bits at twice those
// products' mma count; the kernels stay bound by bytes.
// Any S and any Dh <= 128 run without padding; the bf16 builds also take
// Dh in (176, 192] (latent attention, its values zero-padded by the caller).

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

// ---------------------------------------------------------------------------
// bf16 dk/dv: tensor cores (see the header).  Shared memory, in bf16 rows of
// stride Tile<kDhp>::kLd: the block's K rows, its V rows, then Q and dO of
// min(round16(S), 128) rows each (stage 0 at row 0, stage 1 at row 64),
// then two stages of 64 lse and 64 delta values (fp32).
// ---------------------------------------------------------------------------

// `rows` = min(round16(S), 128) key rows, and as many Q and dO rows
size_t dkv_bf16_smem_bytes(int rows, int dhp) {
  return sizeof(bf16) * (size_t)(4 * rows) * (dhp + 8) +
         sizeof(float) * 4 * kStageRows;
}

// Stage query tile `t` (rows 64 t ...) of Q and dO with its lse and delta.
// Past S: zero rows, lse = +inf and delta = 0, so those columns give
// P = exp(0 - inf) = 0 and dS = 0 without a test.
template <int kDhp>
__device__ __forceinline__ void stage_q(bf16* sq, bf16* sdo, float* slse,
                                        float* sdelta, const bf16* q,
                                        const bf16* dout, const float* lse_bh,
                                        const float* delta_bh, int t, int s,
                                        int dh, bool vec) {
  using T = Tile<kDhp>;
  const int q0 = t * kStageRows;
  const int rows = min(kStageRows, round16(s - q0));
  const int off = (t & 1) * kStageRows;
  stage_rows<kDhp>(sq + off * T::kLd, q, q0, rows, s, dh, vec, threadIdx.x,
                   blockDim.x);
  stage_rows<kDhp>(sdo + off * T::kLd, dout, q0, rows, s, dh, vec, threadIdx.x,
                   blockDim.x);
  for (int c = threadIdx.x; c < kStageRows; c += blockDim.x) {
    const int qi = q0 + c;
    slse[off + c] = qi < s ? lse_bh[qi] : INFINITY;
    sdelta[off + c] = qi < s ? delta_bh[qi] : 0.f;
  }
}

template <int kDhp, bool kDrop>
__global__ void __launch_bounds__(kMaxResident * 2)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ mask, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int dh, int heads,
                      float scale, Dropout drop, bool vec) {
  using T = Tile<kDhp>;
  constexpr int kN = 2 * T::kSteps;  // 8-wide output tiles over the head dim
  constexpr bool kHoldKV = kDhp <= 64;  // K, V fragments live in registers
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int k_rows = blockDim.x / 2;  // 16 per warp
  const int q_rows = min(round16(s), kMaxResident);
  bf16* sk = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sv = sk + k_rows * T::kLd;
  bf16* sq = sv + k_rows * T::kLd;
  bf16* sdo = sq + q_rows * T::kLd;
  float* slse = reinterpret_cast<float*>(sdo + q_rows * T::kLd);
  float* sdelta = slse + 2 * kStageRows;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * k_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = k0 + warp * 16;  // this warp's first key row
  const bool active = row0 < s;
  const size_t base = (size_t)bh * s * dh;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * s;
  const float* lse_bh = lse + (size_t)bh * s;
  const float* delta_bh = delta + (size_t)bh * s;
  const int tiles = (s + kStageRows - 1) / kStageRows;

  stage_rows<kDhp>(sk, k + base, k0, k_rows, s, dh, vec, threadIdx.x, blockDim.x);
  stage_rows<kDhp>(sv, v + base, k0, k_rows, s, dh, vec, threadIdx.x, blockDim.x);
  stage_q<kDhp>(sq, sdo, slse, sdelta, q + base, dout + base, lse_bh, delta_bh,
                0, s, dh, vec);
  cp_async_commit();

  // this lane's key rows g and g + 8
  bool key_ok[2];
  uint32_t hk[2] = {0u, 0u}, hbh = 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = row0 + g + 8 * r;
    key_ok[r] = kj < s && (mrow == nullptr || mrow[kj] > 0.5f);
    if (kDrop) hk[r] = keep_key_word(drop, kj);
  }
  if (kDrop) hbh = keep_bh_word(drop, bh);
  const float inv_keep =
      kDrop ? static_cast<float>(1.0 / (1.0 - (double)drop.rate)) : 1.f;
  const bf16* sk_w = sk + warp * 16 * T::kLd;
  const bf16* sv_w = sv + warp * 16 * T::kLd;

  uint32_t kf[kHoldKV ? T::kSteps : 1][4], vf[kHoldKV ? T::kSteps : 1][4];
  float dk_acc[kN][4], dv_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_q<kDhp>(sq, sdo, slse, sdelta, q + base, dout + base, lse_bh,
                    delta_bh, t + 1, s, dh, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if constexpr (kHoldKV) {
        if (t == 0) {
#pragma unroll
          for (int ks = 0; ks < T::kSteps; ++ks) {
            ldmatrix_x4(kf[ks], ld_a<T::kLd>(sk_w + 16 * ks, lane));
            ldmatrix_x4(vf[ks], ld_a<T::kLd>(sv_w + 16 * ks, lane));
          }
        }
      }
      const int q0 = t * kStageRows;
      const int groups = min(4, round16(s - q0) / 16);  // 16-query groups
      const bf16* qt = sq + (t & 1) * kStageRows * T::kLd;
      const bf16* dot = sdo + (t & 1) * kStageRows * T::kLd;
      const float* lt = slse + (t & 1) * kStageRows;
      const float* dt = sdelta + (t & 1) * kStageRows;
      for (int grp = 0; grp < groups; ++grp) {
        const bf16* qg = qt + 16 * grp * T::kLd;
        const bf16* dog = dot + 16 * grp * T::kLd;
        // S^T = K Q^T and dP^T = V dO^T: [16 keys, 16 queries]
        float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < T::kSteps; ++ks) {
          uint32_t a[4], b[4];
          const uint32_t* ka = a;
          if constexpr (kHoldKV) ka = kf[ks];
          else ldmatrix_x4(a, ld_a<T::kLd>(sk_w + 16 * ks, lane));
          ldmatrix_x4(b, ld_b<T::kLd>(qg + 16 * ks, lane));
          mma_bf16(st[0], ka, b[0], b[1]);
          mma_bf16(st[1], ka, b[2], b[3]);
          const uint32_t* va = a;
          if constexpr (kHoldKV) va = vf[ks];
          else ldmatrix_x4(a, ld_a<T::kLd>(sv_w + 16 * ks, lane));
          ldmatrix_x4(b, ld_b<T::kLd>(dog + 16 * ks, lane));
          mma_bf16(dpt[0], va, b[0], b[1]);
          mma_bf16(dpt[1], va, b[2], b[3]);
        }
        // element e of tile n: key row g + 8 (e / 2), query column
        // 16 grp + 8 n + 2 tq + e % 2 of the stage
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t hq[2] = {0u, 0u};
          if (kDrop) {
            hq[0] = keep_query_word(drop, q0 + 16 * grp + 8 * n + 2 * tq);
            hq[1] = keep_query_word(drop, q0 + 16 * grp + 8 * n + 2 * tq + 1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 16 * grp + 8 * n + 2 * tq + (e & 1);
            const float p =
                key_ok[e >> 1] ? __expf(scale * st[n][e] - lt[c]) : 0.f;
            float pv = p, dp = dpt[n][e];
            if (kDrop) {
              if (keep_words(drop, hq[e & 1], hk[e >> 1], hbh)) {
                pv *= inv_keep;
                dp *= inv_keep;
              } else {
                pv = 0.f;
                dp = 0.f;
              }
            }
            st[n][e] = pv;                   // P^^T as the values saw it
            dpt[n][e] = p * (dp - dt[c]);    // dS^T
          }
        }
        // dV += P^^T dO and dK += dS^T Q, dO and Q by ldmatrix.trans; each
        // A operand in a bf16 hi and lo part, two products on one B
        uint32_t pv_hi[4], pv_lo[4], ds_hi[4], ds_lo[4];
        acc_to_a_split(pv_hi, pv_lo, st[0], st[1]);
        acc_to_a_split(ds_hi, ds_lo, dpt[0], dpt[1]);
#pragma unroll
        for (int np = 0; np < T::kSteps; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ld_b_trans<T::kLd>(dog + 16 * np, lane));
          mma_bf16(dv_acc[2 * np], pv_hi, b[0], b[1]);
          mma_bf16(dv_acc[2 * np], pv_lo, b[0], b[1]);
          mma_bf16(dv_acc[2 * np + 1], pv_hi, b[2], b[3]);
          mma_bf16(dv_acc[2 * np + 1], pv_lo, b[2], b[3]);
          ldmatrix_x4_trans(b, ld_b_trans<T::kLd>(qg + 16 * np, lane));
          mma_bf16(dk_acc[2 * np], ds_hi, b[0], b[1]);
          mma_bf16(dk_acc[2 * np], ds_lo, b[0], b[1]);
          mma_bf16(dk_acc[2 * np + 1], ds_hi, b[2], b[3]);
          mma_bf16(dk_acc[2 * np + 1], ds_lo, b[2], b[3]);
        }
      }
    }
    if (t + 2 < tiles) __syncthreads();  // stage t & 1 is refilled next
  }

  if (!active) return;
  // out through the warp's own K and V rows, read for the last time above
  store_rows<kDhp>(sk + warp * 16 * T::kLd, dk_acc, scale, scale, dk + base,
                   row0, s, dh, vec, lane);
  store_rows<kDhp>(sv + warp * 16 * T::kLd, dv_acc, 1.f, 1.f, dv + base, row0,
                   s, dh, vec, lane);
}

// ---------------------------------------------------------------------------
// bf16 dq: tensor cores (see the header).  Shared memory, in bf16 rows of
// stride Tile<kDhp>::kLd: the block's Q rows, its dO rows, then K and V of
// min(round16(S), 128) rows each (stage 0 at row 0, stage 1 at row 64),
// then two stages of 64 key-valid flags (fp32) and 64 key dropout words.
// ---------------------------------------------------------------------------

// `rows` = min(round16(S), 128) query rows, and as many K and V rows
size_t dq_bf16_smem_bytes(int rows, int dhp) {
  return sizeof(bf16) * (size_t)(4 * rows) * (dhp + 8) +
         (sizeof(float) + sizeof(uint32_t)) * 2 * kStageRows;
}

// Stage key tile `t` (rows 64 t ...) of K and V with each key's valid flag
// and dropout word.
template <int kDhp, bool kDrop>
__device__ __forceinline__ void stage_kv_dq(bf16* sk, bf16* sv, float* sflag,
                                            uint32_t* skw, const bf16* k,
                                            const bf16* v, const float* mrow,
                                            const Dropout& drop, int t, int s,
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
    if (kDrop) skw[off + c] = keep_key_word(drop, kj);
  }
}

template <int kDhp, bool kDrop>
__global__ void __launch_bounds__(kMaxResident * 2)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, bf16* __restrict__ dq,
                     int s, int dh, int heads, float scale, Dropout drop,
                     bool vec) {
  using T = Tile<kDhp>;
  constexpr int kN = 2 * T::kSteps;  // 8-wide output tiles over the head dim
  constexpr bool kHoldQ = kDhp <= 64;  // Q, dO fragments live in registers
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int q_rows = blockDim.x / 2;  // 16 per warp
  const int kv_rows = min(round16(s), kMaxResident);
  bf16* sq = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sdo = sq + q_rows * T::kLd;
  bf16* sk = sdo + q_rows * T::kLd;
  bf16* sv = sk + kv_rows * T::kLd;
  float* sflag = reinterpret_cast<float*>(sv + kv_rows * T::kLd);
  uint32_t* skw = reinterpret_cast<uint32_t*>(sflag + 2 * kStageRows);

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
  stage_rows<kDhp>(sdo, dout + base, q0, q_rows, s, dh, vec, threadIdx.x,
                   blockDim.x);
  stage_kv_dq<kDhp, kDrop>(sk, sv, sflag, skw, k + base, v + base, mrow, drop,
                           0, s, dh, vec);
  cp_async_commit();

  // this lane's query rows g and g + 8; past S: lse = +inf, so P = 0
  float lse_r[2], delta_r[2];
  uint32_t hq[2] = {0u, 0u}, hbh = 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + 8 * r;
    lse_r[r] = qi < s ? lse[(size_t)bh * s + qi] : INFINITY;
    delta_r[r] = qi < s ? delta[(size_t)bh * s + qi] : 0.f;
    if (kDrop) hq[r] = keep_query_word(drop, qi);
  }
  if (kDrop) hbh = keep_bh_word(drop, bh);
  const float inv_keep =
      kDrop ? static_cast<float>(1.0 / (1.0 - (double)drop.rate)) : 1.f;
  const bf16* sq_w = sq + warp * 16 * T::kLd;
  const bf16* sdo_w = sdo + warp * 16 * T::kLd;

  uint32_t qf[kHoldQ ? T::kSteps : 1][4], of[kHoldQ ? T::kSteps : 1][4];
  float dq_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_kv_dq<kDhp, kDrop>(sk, sv, sflag, skw, k + base, v + base, mrow,
                               drop, t + 1, s, dh, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if constexpr (kHoldQ) {
        if (t == 0) {
#pragma unroll
          for (int ks = 0; ks < T::kSteps; ++ks) {
            ldmatrix_x4(qf[ks], ld_a<T::kLd>(sq_w + 16 * ks, lane));
            ldmatrix_x4(of[ks], ld_a<T::kLd>(sdo_w + 16 * ks, lane));
          }
        }
      }
      const int k0 = t * kStageRows;
      const int groups = min(4, round16(s - k0) / 16);  // 16-key groups
      const bf16* kt = sk + (t & 1) * kStageRows * T::kLd;
      const bf16* vt = sv + (t & 1) * kStageRows * T::kLd;
      const float* ft = sflag + (t & 1) * kStageRows;
      const uint32_t* wt = skw + (t & 1) * kStageRows;
      for (int grp = 0; grp < groups; ++grp) {
        const bf16* kg = kt + 16 * grp * T::kLd;
        const bf16* vg = vt + 16 * grp * T::kLd;
        // S = Q K^T and dP = dO V^T: [16 queries, 16 keys]
        float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < T::kSteps; ++ks) {
          uint32_t a[4], b[4];
          const uint32_t* qa = a;
          if constexpr (kHoldQ) qa = qf[ks];
          else ldmatrix_x4(a, ld_a<T::kLd>(sq_w + 16 * ks, lane));
          ldmatrix_x4(b, ld_b<T::kLd>(kg + 16 * ks, lane));
          mma_bf16(sc[0], qa, b[0], b[1]);
          mma_bf16(sc[1], qa, b[2], b[3]);
          const uint32_t* oa = a;
          if constexpr (kHoldQ) oa = of[ks];
          else ldmatrix_x4(a, ld_a<T::kLd>(sdo_w + 16 * ks, lane));
          ldmatrix_x4(b, ld_b<T::kLd>(vg + 16 * ks, lane));
          mma_bf16(dp[0], oa, b[0], b[1]);
          mma_bf16(dp[1], oa, b[2], b[3]);
        }
        // element e of tile n: query row g + 8 (e / 2), key column
        // 16 grp + 8 n + 2 tq + e % 2 of the stage
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 16 * grp + 8 * n + 2 * tq + (e & 1);
            const int r = e >> 1;
            const float p =
                ft[c] > 0.5f ? __expf(scale * sc[n][e] - lse_r[r]) : 0.f;
            float dpv = dp[n][e];
            if (kDrop)
              dpv = keep_words(drop, hq[r], wt[c], hbh) ? dpv * inv_keep : 0.f;
            sc[n][e] = p * (dpv - delta_r[r]);  // dS
          }
        }
        // dQ += dS K, dS as a bf16 hi and lo part on one B, K by
        // ldmatrix.trans
        uint32_t ds_hi[4], ds_lo[4];
        acc_to_a_split(ds_hi, ds_lo, sc[0], sc[1]);
#pragma unroll
        for (int np = 0; np < T::kSteps; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ld_b_trans<T::kLd>(kg + 16 * np, lane));
          mma_bf16(dq_acc[2 * np], ds_hi, b[0], b[1]);
          mma_bf16(dq_acc[2 * np], ds_lo, b[0], b[1]);
          mma_bf16(dq_acc[2 * np + 1], ds_hi, b[2], b[3]);
          mma_bf16(dq_acc[2 * np + 1], ds_lo, b[2], b[3]);
        }
      }
    }
    if (t + 2 < tiles) __syncthreads();  // stage t & 1 is refilled next
  }

  if (!active) return;
  // out through the warp's own Q rows, read for the last time above
  store_rows<kDhp>(sq + warp * 16 * T::kLd, dq_acc, scale, scale, dq + base,
                   row0, s, dh, vec, lane);
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

// fp32: the scalar kernels (the bf16 builds are the tensor-core kernels)
template <int MaxDh, bool kDrop>
cudaError_t launch_variant(bool dkv, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.dh);
  const dim3 grid(a.bh, (a.s + kBlockQ - 1) / kBlockQ);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(flash_dkv_kernel<float, MaxDh, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<float, MaxDh, kDrop><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.s, a.dh, a.heads, a.scale, a.drop);
  } else {
    err = cudaFuncSetAttribute(flash_dq_kernel<float, MaxDh, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_dq_kernel<float, MaxDh, kDrop><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<float*>(a.dq), a.s,
        a.dh, a.heads, a.scale, a.drop);
  }
  return cudaGetLastError();
}

template <int MaxDh>
cudaError_t launch_dh(bool dkv, const Args& a, cudaStream_t stream) {
  if (a.drop.rate > 0.f) return launch_variant<MaxDh, true>(dkv, a, stream);
  return launch_variant<MaxDh, false>(dkv, a, stream);
}

template <int kDhp, bool kDrop>
cudaError_t launch_dkv_bf16_variant(const Args& a, bool vec,
                                    cudaStream_t stream) {
  // S <= 128: one block per (bh), one warp per 16 key rows; else 128 rows
  const int rows = round16(a.s) < kMaxResident ? round16(a.s) : kMaxResident;
  const size_t smem = dkv_bf16_smem_bytes(rows, kDhp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_bf16_kernel<kDhp, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + rows - 1) / rows);
  flash_dkv_bf16_kernel<kDhp, kDrop><<<grid, 2 * rows, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.mask, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.s, a.dh, a.heads, a.scale, a.drop, vec);
  return cudaGetLastError();
}

template <int kDhp>
cudaError_t launch_dkv_bf16_dh(const Args& a, bool vec, cudaStream_t stream) {
  if (a.drop.rate > 0.f) return launch_dkv_bf16_variant<kDhp, true>(a, vec, stream);
  return launch_dkv_bf16_variant<kDhp, false>(a, vec, stream);
}

cudaError_t launch_dkv_bf16(const Args& a, cudaStream_t stream) {
  const bool vec = a.dh % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.dout) && aligned16(a.dk) &&
                   aligned16(a.dv);
#define FLASH_DKV_BF16(DHP) \
  case DHP / 16:            \
    return launch_dkv_bf16_dh<DHP>(a, vec, stream);
  switch (round16(a.dh) / 16) {
    FLASH_DKV_BF16(16)
    FLASH_DKV_BF16(32)
    FLASH_DKV_BF16(48)
    FLASH_DKV_BF16(64)
    FLASH_DKV_BF16(80)
    FLASH_DKV_BF16(96)
    FLASH_DKV_BF16(112)
    FLASH_DKV_BF16(128)
    FLASH_DKV_BF16(192)
  }
#undef FLASH_DKV_BF16
  return cudaErrorInvalidValue;
}

template <int kDhp, bool kDrop>
cudaError_t launch_dq_bf16_variant(const Args& a, bool vec,
                                   cudaStream_t stream) {
  // S <= 128: one block per (bh), one warp per 16 query rows; else 128 rows
  const int rows = round16(a.s) < kMaxResident ? round16(a.s) : kMaxResident;
  const size_t smem = dq_bf16_smem_bytes(rows, kDhp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_bf16_kernel<kDhp, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + rows - 1) / rows);
  flash_dq_bf16_kernel<kDhp, kDrop><<<grid, 2 * rows, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.mask, static_cast<bf16*>(a.dq), a.s, a.dh, a.heads, a.scale,
      a.drop, vec);
  return cudaGetLastError();
}

template <int kDhp>
cudaError_t launch_dq_bf16_dh(const Args& a, bool vec, cudaStream_t stream) {
  if (a.drop.rate > 0.f) return launch_dq_bf16_variant<kDhp, true>(a, vec, stream);
  return launch_dq_bf16_variant<kDhp, false>(a, vec, stream);
}

cudaError_t launch_dq_bf16(const Args& a, cudaStream_t stream) {
  const bool vec = a.dh % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.dout) && aligned16(a.dq);
#define FLASH_DQ_BF16(DHP) \
  case DHP / 16:           \
    return launch_dq_bf16_dh<DHP>(a, vec, stream);
  switch (round16(a.dh) / 16) {
    FLASH_DQ_BF16(16)
    FLASH_DQ_BF16(32)
    FLASH_DQ_BF16(48)
    FLASH_DQ_BF16(64)
    FLASH_DQ_BF16(80)
    FLASH_DQ_BF16(96)
    FLASH_DQ_BF16(112)
    FLASH_DQ_BF16(128)
    FLASH_DQ_BF16(192)
  }
#undef FLASH_DQ_BF16
  return cudaErrorInvalidValue;
}

int launch(int dtype, bool dkv, const Args& a, void* stream) {
  if (a.bh < 1 || a.s < 1 || a.heads < 1 ||
      !(dtype == 1 ? bf16_head_dim(a.dh) : a.dh >= 1 && a.dh <= kMaxDh) ||
      a.bh % a.heads || !(a.drop.rate >= 0.f && a.drop.rate < 1.f) ||
      a.drop.head_offset < 0 || a.drop.head_offset + a.heads > a.drop.head_count)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(a.dh <= 64 ? launch_dh<64>(dkv, a, st)
                            : launch_dh<kMaxDh>(dkv, a, st));
  if (dtype == 1)
    return (int)(dkv ? launch_dkv_bf16(a, st) : launch_dq_bf16(a, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients);
// lse and delta fp32 [BH, S]; mask fp32 [B, S] or null.  The dropout words
// (the head count and head offset too) are those of the forward.  Each
// returns a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int crossclr_flash_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* mask, void* dq, int bh, int s,
                                 int dh, int heads, float scale, float rate,
                                 unsigned int seed, int q_offset, int k_offset,
                                 int bh_offset, int head_count,
                                 int head_offset, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const float*>(mask),
         dq, nullptr, nullptr, bh, s, dh, heads, scale,
         Dropout{rate, seed, q_offset, k_offset, bh_offset, heads, head_count,
                 head_offset, 0u, 0}};
  head_divisor(a.drop);
  return launch(dtype, false, a, stream);
}

extern "C" int crossclr_flash_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* mask, void* dk, void* dv, int bh,
                                  int s, int dh, int heads, float scale,
                                  float rate, unsigned int seed, int q_offset,
                                  int k_offset, int bh_offset, int head_count,
                                  int head_offset, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const float*>(mask),
         nullptr, dk, dv, bh, s, dh, heads, scale,
         Dropout{rate, seed, q_offset, k_offset, bh_offset, heads, head_count,
                 head_offset, 0u, 0}};
  head_divisor(a.drop);
  return launch(dtype, true, a, stream);
}

extern "C" const char* crossclr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
