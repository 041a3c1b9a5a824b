// Attention, and attention with dropout (forward and backward), at the
// shapes the tiled kernels do not take: any head_dim up to 256 and any
// number of queries and keys, for sm_90a.
//
// The TPU kernels of mit_tpu/ops/pallas_attention.py (_attn_kernel_btd,
// _attn_kernel_btd_fusedqkv, _attn_kernel_allheads) and of
// mit_tpu/ops/pallas_dropout_attention.py (_fwd_kernel, _bwd_kernel) hold a
// cell's whole tiles and take any geometry. Their ports in
// flash_attention_btd.cu and flash_attention_dropout.cu are laid out for
// head_dim 64 (and, with dropout, at most 128 queries and keys). These
// kernels compute the same functions everywhere else, so that no shape the
// TPU kernels take runs without a hand-written kernel on the card. They are
// the simple design: right first, and slow beside the tiled kernels.
//
// A warp owns two query rows (in the second backward kernel, two keys) and
// a block of eight warps sixteen. The block walks the keys 32 at a time: a
// tile of 32 rows of k (and of v) is staged in shared memory as f32, each
// row padded by one float, by coalesced loads that all sixteen rows share.
// Within a tile a lane owns a key: its scores are dot products over head_dim
// of its tile row (32 lanes, 32 banks) with the warp's two rows of q
// (broadcast reads), one tile load feeding two FMAs. A first walk takes the
// row max and the row sum (online within a lane, merged across the warp), a
// second takes p = exp(s - max) and multiplies: each lane's p goes round
// the warp by shuffle, and for P.V the lanes turn to the columns of v (lane
// + 32 i). Causal: the second walk ends at the block's diagonal unless a
// row of the block has seen only masked keys (its max is a masked score's,
// which the causally masked keys share; see flash_attention_btd.cu). f32
// throughout, the products in the inputs' own precision (bf16 inputs are
// widened exactly), expf and IEEE divisions as in the plain versions;
// scale, causal and pad are applied in the plain versions' order with
// unfused multiplies and adds.
//
// Numerics, by entry:
// - divide-after (flash_attention_btd, fused qkv): p rounded to v's dtype,
//   out = (sum p v) / rowsum(p);
// - layer (fused qkv with the int8 whole-layer numerics of
//   mit_tpu/ops/pallas_int8_layer.py:96-118, bf16 in, f32 out): scores
//   multiplied by log2(e)/sqrt(hd), a first walk for the exact row max m
//   alone, p = exp2f(s - m) summed in f32 unrounded and rounded to bf16 for
//   P.V, out = (sum p v) * (1 / rowsum(p)) in f32;
// - normalize-first (flash_attention in (B, H, T, hd)): p / rowsum rounded
//   to v's dtype, out = sum p v;
// - dropout: p / rowsum, then keep ? p / (1 - r) : 0 rounded to v's dtype,
//   the keep bit from dropout_hash.cuh at (row, col) of cell b*H + h.
// The backward is the plain version's formulas in f32 (see
// flash_attention_dropout.cu), in two kernels because a cell's (T, S) tile
// is not held anywhere: the first, laid out as the forward, takes each
// row's max, sum and delta = rowsum(dp * p), writes them to a (cells, T, 3)
// f32 workspace and computes dq in a third walk; the second, a warp to two
// keys, stages 32 rows of q and do at a time, rebuilds p, dp and ds from the
// workspace (a lane to a query row) and reduces dk and dv over the rows. No
// atomics, so a run repeats bit for bit.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"

namespace {

constexpr int MAX_HD = 256;
constexpr int NI = MAX_HD / 32;   // columns of head_dim a lane owns
constexpr int WARPS = 8;
constexpr int R = 2;              // query rows (or keys) a warp
constexpr int BR = WARPS * R;     // query rows (or keys) a block
constexpr int KT = 32;            // keys (or query rows) a tile: one a lane
constexpr float NEG_INF = -1e9f;
// a row whose max is below this has seen only masked keys
constexpr float ROW_MASKED = -5e8f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_like(float x, const float*) {
  return x;
}
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Where a (batch, head) cell starts in a tensor and how far its rows lie
// apart, in elements. (B, T, D): batch T * ld, head hd, rows ld (D, or 3D
// inside a fused qkv tensor). (B, H, T, hd): batch H * T * hd, head T * hd,
// rows hd.
struct Cells {
  long long batch, head;
  int ld;
  __device__ __forceinline__ size_t at(int b, int h) const {
    return (size_t)b * batch + (size_t)h * head;
  }
};

Cells cells_of(bool bhtd, int H, int rows, int hd, int ld) {
  if (bhtd) return {(long long)H * rows * hd, (long long)rows * hd, hd};
  return {(long long)rows * ld, hd, ld};
}

// Rows first .. first + n - 1 of `src` (row stride ld, hd columns) into
// dst (row stride dld, f32), a warp to a row; rows from `total` on are zero.
// Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int dld, const T* src,
                                           int ld, int first, int n, int total,
                                           int hd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += WARPS) {
    const bool ok = first + r < total;
    const T* row = src + (size_t)(first + (ok ? r : 0)) * ld;
    for (int d = lane; d < hd; d += 32)
      dst[r * dld + d] = ok ? to_f32(row[d]) : 0.f;
  }
}

// acc[r] = a lane's tile row . the warp's r-th broadcast row, r < R
__device__ __forceinline__ void dots(float acc[R], const float* tile_row,
                                     const float* rows, int rld, int hd) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    const float t = tile_row[d];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(rows[r * rld + d], t, acc[r]);
  }
}

// the score of (row, col) from the raw product, in the plain versions' order
__device__ __forceinline__ float masked_score(float acc, float scale, int row,
                                              int col, const float* pad_row,
                                              bool causal) {
  float x = __fmul_rn(acc, scale);
  if (causal) x = __fadd_rn(x, col <= row ? 0.f : NEG_INF);
  if (pad_row != nullptr) x = __fadd_rn(x, pad_row[col]);
  return x;
}

// one more score into a lane's online (max, sum)
__device__ __forceinline__ void online(float& m, float& l, float x) {
  const float mn = fmaxf(m, x);
  l = l * expf(m - mn) + expf(x - mn);         // exp(-inf) = 0 the first time
  m = mn;
}

// the lanes' (max, sum) pairs merged into the row's; S >= 1, so M is finite
__device__ __forceinline__ void merge(float m, float l, float& M, float& L) {
  M = warp_max(m);
  L = warp_sum(m == -INFINITY ? 0.f : l * expf(m - M));
}

// acc[i] += w * row[lane + 32 i] for the columns below hd (row: shared)
__device__ __forceinline__ void axpy(float acc[NI], float w, const float* row,
                                     int hd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) acc[i] = fmaf(w, row[d], acc[i]);
  }
}

// The first walk of a block's BR query rows over the keys: each warp's R
// row maxima and sums (the maxima alone when !SUM). qs: the block's rows of
// q (stride hd); ks: room for a key tile (stride hd + 1). Ends with every
// warp past its last tile read.
template <typename T, bool SUM = true>
__device__ __forceinline__ void walk_max_sum(
    const float* qs, float* ks, const T* kb, int ldk, int S, int hd,
    float scale, int row0, const float* pad_row, bool causal, float M[R],
    float L[R]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();                            // the last tile is spent
    stage_rows(ks, hd + 1, kb, ldk, k0, KT, S, hd);
    __syncthreads();
    const int col = k0 + lane;
    if (col < S) {
      float acc[R];
      dots(acc, ks + lane * (hd + 1), qs + warp * R * hd, hd, hd);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = masked_score(acc[r], scale, row0 + warp * R + r, col,
                                     pad_row, causal);
        if (SUM) online(m[r], l[r], x);
        else m[r] = fmaxf(m[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (SUM) merge(m[r], l[r], M[r], L[r]);
    else M[r] = warp_max(m[r]);
  }
}

// ----------------------------------------------------------------------
// forward: attention, and attention with dropout
// ----------------------------------------------------------------------
// LAYER: the int8 layer's numerics (bf16 in, f32 out); never with DROPOUT
template <typename T, bool LAYER>
using OutOf = typename std::conditional<LAYER, float, T>::type;

template <typename T, bool DROPOUT, bool LAYER>
__global__ void __launch_bounds__(WARPS * 32)
attention_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ pad,
                      OutOf<T, LAYER>* __restrict__ out, Cells cq, Cells ck,
                      Cells co,
                      int Tq, int S, int hd, float scale, bool causal,
                      bool norm_first, uint32_t seed,
                      const uint32_t* __restrict__ seed_ptr,
                      uint32_t threshold, float one_minus_r, CellMap cm) {
  extern __shared__ float smem[];
  float* qs = smem;                     // BR x hd
  float* ks = qs + BR * hd;             // KT x (hd + 1)
  float* vs = ks + KT * (hd + 1);       // KT x (hd + 1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* kb = k + ck.at(b, h);
  const T* vb = v + ck.at(b, h);
  const float* pad_row = pad != nullptr ? pad + (size_t)b * S : nullptr;
  const uint32_t base =
      cell_base(launch_seed(seed, seed_ptr),
                global_cell(b * gridDim.y + h, gridDim.y, cm));

  stage_rows(qs, hd, q + cq.at(b, h), cq.ld, row0, BR, Tq, hd);
  float M[R], L[R];
  walk_max_sum<T, !LAYER>(qs, ks, kb, ck.ld, S, hd, scale, row0, pad_row,
                          causal, M, L);
  float lsum[R];                        // LAYER: this lane's part of rowsum(p)
#pragma unroll
  for (int r = 0; r < R; ++r) lsum[r] = 0.f;

  // Causal: past the block's diagonal every p is exp(-1e9 - max) = 0 unless
  // a row's max is itself a masked score's; then the block walks on
  bool masked = false;
#pragma unroll
  for (int r = 0; r < R; ++r)
    masked |= row0 + warp * R + r < Tq && M[r] <= ROW_MASKED;
  int s_end = S;
  if (causal && !__syncthreads_or(masked)) s_end = min(S, row0 + BR);

  float o[R][NI];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) o[r][i] = 0.f;
  for (int k0 = 0; k0 < s_end; k0 += KT) {
    __syncthreads();
    stage_rows(ks, hd + 1, kb, ck.ld, k0, KT, S, hd);
    stage_rows(vs, hd + 1, vb, ck.ld, k0, KT, S, hd);
    __syncthreads();
    const int col = k0 + lane;
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = 0.f;
    if (col < S) {
      float acc[R];
      dots(acc, ks + lane * (hd + 1), qs + warp * R * hd, hd, hd);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + warp * R + r;
        const float sc = masked_score(acc[r], scale, row, col, pad_row, causal);
        float x = LAYER ? exp2f(sc - M[r]) : expf(sc - M[r]);
        if (LAYER) {
          lsum[r] += x;
        } else if (DROPOUT) {
          x = __fdiv_rn(x, L[r]);
          x = keep_at(row, col, S, base, threshold)
                  ? __fdiv_rn(x, one_minus_r) : 0.f;
        } else if (norm_first) {
          x = __fdiv_rn(x, L[r]);
        }
        p[r] = round_like(x, v);
      }
    }
    const int n = min(KT, S - k0);
    for (int cc = 0; cc < n; ++cc) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pc = __shfl_sync(0xffffffffu, p[r], cc);
        // a probability of exactly 0 (a masked or dropped key) adds nothing
        if (pc != 0.f) axpy(o[r], pc, vs + cc * (hd + 1), hd);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float inv = LAYER ? __fdiv_rn(1.f, warp_sum(lsum[r])) : 0.f;
    const int row = row0 + warp * R + r;
    if (row >= Tq) continue;
    OutOf<T, LAYER>* orow = out + co.at(b, h) + (size_t)row * co.ld;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd)
        store(orow + d, LAYER ? __fmul_rn(o[r][i], inv)
                        : DROPOUT || norm_first ? o[r][i]
                                                : __fdiv_rn(o[r][i], L[r]));
    }
  }
}

// ----------------------------------------------------------------------
// backward of attention with dropout; tensors in (B, H, T|S, hd)
// ----------------------------------------------------------------------

// BR query rows a block: max, sum and delta into stats[cell, row, 0..2], dq.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dropout_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ pad,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ stats, int H, int Tq, int S,
                        int hd, float scale, bool causal, uint32_t seed,
                        const uint32_t* __restrict__ seed_ptr,
                        uint32_t threshold, float inv, CellMap cm) {
  extern __shared__ float smem[];
  float* qs = smem;                     // BR x hd
  float* dos = qs + BR * hd;            // BR x hd
  float* ks = dos + BR * hd;            // KT x (hd + 1)
  float* vs = ks + KT * (hd + 1);       // KT x (hd + 1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x;
  const int row0 = blockIdx.y * BR;
  const T* kb = k + (size_t)cell * S * hd;
  const T* vb = v + (size_t)cell * S * hd;
  const float* pad_row = pad + (size_t)(cell / H) * S;
  const uint32_t base =
      cell_base(launch_seed(seed, seed_ptr), global_cell(cell, H, cm));

  stage_rows(qs, hd, q + (size_t)cell * Tq * hd, hd, row0, BR, Tq, hd);
  stage_rows(dos, hd, dout + (size_t)cell * Tq * hd, hd, row0, BR, Tq, hd);
  float M[R], L[R];
  walk_max_sum(qs, ks, kb, hd, S, hd, scale, row0, pad_row, causal, M, L);

  // p and dp of this lane's key for the warp's R rows, as the plain version
  // has them; the tiles of k and v are staged
  auto p_dp = [&](int col, float p[R], float dp[R]) {
    float s[R], dpd[R];
    dots(s, ks + lane * (hd + 1), qs + warp * R * hd, hd, hd);
    dots(dpd, vs + lane * (hd + 1), dos + warp * R * hd, hd, hd);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + warp * R + r;
      p[r] = __fdiv_rn(expf(masked_score(s[r], scale, row, col, pad_row,
                                         causal) - M[r]), L[r]);
      dp[r] = keep_at(row, col, S, base, threshold) ? __fmul_rn(dpd[r], inv)
                                                    : 0.f;
    }
  };
  auto stage_kv = [&](int k0) {
    __syncthreads();
    stage_rows(ks, hd + 1, kb, hd, k0, KT, S, hd);
    stage_rows(vs, hd + 1, vb, hd, k0, KT, S, hd);
    __syncthreads();
  };

  float delta[R];
#pragma unroll
  for (int r = 0; r < R; ++r) delta[r] = 0.f;
  for (int k0 = 0; k0 < S; k0 += KT) {
    stage_kv(k0);
    if (k0 + lane < S) {
      float p[R], dp[R];
      p_dp(k0 + lane, p, dp);
#pragma unroll
      for (int r = 0; r < R; ++r) delta[r] += __fmul_rn(dp[r], p[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    delta[r] = warp_sum(delta[r]);
    const int row = row0 + warp * R + r;
    if (lane == 0 && row < Tq) {
      float* st = stats + ((size_t)cell * Tq + row) * 3;
      st[0] = M[r];
      st[1] = L[r];
      st[2] = delta[r];
    }
  }

  float acc[R][NI];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += KT) {
    stage_kv(k0);
    float ds[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ds[r] = 0.f;
    if (k0 + lane < S) {
      float p[R], dp[R];
      p_dp(k0 + lane, p, dp);
#pragma unroll
      for (int r = 0; r < R; ++r)
        ds[r] = __fmul_rn(p[r], __fsub_rn(dp[r], delta[r]));
    }
    const int n = min(KT, S - k0);
    for (int cc = 0; cc < n; ++cc) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float w = __shfl_sync(0xffffffffu, ds[r], cc);
        if (w != 0.f) axpy(acc[r], w, ks + cc * (hd + 1), hd);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + warp * R + r;
    if (row >= Tq) continue;
    T* dqrow = dq + ((size_t)cell * Tq + row) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store(dqrow + d, __fmul_rn(acc[r][i], scale));
    }
  }
}

// BR keys a block: dk and dv, reduced over the query rows a tile at a time.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dropout_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ pad,
                        const T* __restrict__ dout,
                        const float* __restrict__ stats, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Tq, int S, int hd,
                        float scale, bool causal, uint32_t seed,
                        const uint32_t* __restrict__ seed_ptr,
                        uint32_t threshold, float inv, CellMap cm) {
  extern __shared__ float smem[];
  float* ks = smem;                     // BR x hd
  float* vs = ks + BR * hd;             // BR x hd
  float* qs = vs + BR * hd;             // KT x (hd + 1)
  float* dos = qs + KT * (hd + 1);      // KT x (hd + 1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x;
  const int col0 = blockIdx.y * BR;
  const T* qb = q + (size_t)cell * Tq * hd;
  const T* dob = dout + (size_t)cell * Tq * hd;
  const float* pad_row = pad + (size_t)(cell / H) * S;
  const float* st = stats + (size_t)cell * Tq * 3;
  const uint32_t base =
      cell_base(launch_seed(seed, seed_ptr), global_cell(cell, H, cm));

  stage_rows(ks, hd, k + (size_t)cell * S * hd, hd, col0, BR, S, hd);
  stage_rows(vs, hd, v + (size_t)cell * S * hd, hd, col0, BR, S, hd);

  float adk[R][NI], adv[R][NI];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) adk[r][i] = adv[r][i] = 0.f;
  for (int r0 = 0; r0 < Tq; r0 += KT) {
    __syncthreads();
    stage_rows(qs, hd + 1, qb, hd, r0, KT, Tq, hd);
    stage_rows(dos, hd + 1, dob, hd, r0, KT, Tq, hd);
    __syncthreads();
    const int row = r0 + lane;
    float pd[R], ds[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pd[r] = ds[r] = 0.f;
    if (row < Tq) {
      float s[R], dpd[R];
      dots(s, qs + lane * (hd + 1), ks + warp * R * hd, hd, hd);
      dots(dpd, dos + lane * (hd + 1), vs + warp * R * hd, hd, hd);
      const float M = st[row * 3], L = st[row * 3 + 1];
      const float delta = st[row * 3 + 2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int col = col0 + warp * R + r;
        if (col >= S) continue;
        const float p = __fdiv_rn(
            expf(masked_score(s[r], scale, row, col, pad_row, causal) - M), L);
        const bool kept = keep_at(row, col, S, base, threshold);
        const float dp = kept ? __fmul_rn(dpd[r], inv) : 0.f;
        ds[r] = __fmul_rn(p, __fsub_rn(dp, delta));
        pd[r] = kept ? __fmul_rn(p, inv) : 0.f;
      }
    }
    const int n = min(KT, Tq - r0);
    for (int rr = 0; rr < n; ++rr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float wv = __shfl_sync(0xffffffffu, pd[r], rr);
        const float wk = __shfl_sync(0xffffffffu, ds[r], rr);
        if (wv != 0.f) axpy(adv[r], wv, dos + rr * (hd + 1), hd);
        if (wk != 0.f) axpy(adk[r], wk, qs + rr * (hd + 1), hd);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int col = col0 + warp * R + r;
    if (col >= S) continue;
    const size_t koff = ((size_t)cell * S + col) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) {
        store(dv + koff + d, adv[r][i]);
        store(dk + koff + d, __fmul_rn(adk[r][i], scale));
      }
    }
  }
}

// shared memory of a kernel that holds `resident` sets of BR rows and
// `tiles` tiles of KT padded rows
int smem_bytes(int resident, int tiles, int hd) {
  return (resident * BR * hd + tiles * KT * (hd + 1)) * (int)sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int B, int H, int Tq, int S, int hd) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || Tq < 1 || S < 1 ||
         hd < 1 || hd > MAX_HD;
}

template <typename T, bool DROPOUT, bool LAYER = false>
int launch_rows(const void* q, const void* k, const void* v, const void* pad,
                void* out, Cells cq, Cells ck, Cells co, int B, int H, int Tq,
                int S, int hd, int causal, int norm_first, unsigned seed,
                const unsigned* seed_ptr, unsigned threshold,
                float one_minus_r, void* stream,
                CellMap cm = CellMap{0, 0, 0}) {
  if (bad_shape(B, H, Tq, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (!DROPOUT) cm = CellMap{0, H, 0};
  if (bad_map(H, cm)) return static_cast<int>(cudaErrorInvalidValue);
  const double log2e = LAYER ? 1.4426950408889634 : 1.0;
  const float scale = (float)(log2e / sqrt((double)hd));
  const int smem = smem_bytes(1, 2, hd);
  const cudaError_t e =
      allow_smem(attention_rows_kernel<T, DROPOUT, LAYER>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Tq + BR - 1) / BR, H, B);
  attention_rows_kernel<T, DROPOUT, LAYER>
      <<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(pad),
          static_cast<OutOf<T, LAYER>*>(out), cq, ck, co, Tq, S, hd, scale,
          causal != 0, norm_first != 0, seed, seed_ptr, threshold,
          one_minus_r, cm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* pad,
               const void* dout, void* dq, void* dk, void* dv, void* stats,
               int B, int H, int Tq, int S, int hd, int causal, unsigned seed,
               const unsigned* seed_ptr, unsigned threshold, float inv,
               CellMap cm, void* stream) {
  if (bad_shape(B, H, Tq, S, hd) || Tq > 65535 * BR || S > 65535 * BR ||
      (long long)B * H > 2147483647LL || bad_map(H, cm))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = (float)(1.0 / sqrt((double)hd));
  const int smem = smem_bytes(2, 2, hd);
  cudaError_t err = allow_smem(dropout_bwd_rows_kernel<T>, smem);
  if (err == cudaSuccess) err = allow_smem(dropout_bwd_keys_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = (cudaStream_t)stream;
  dropout_bwd_rows_kernel<T>
      <<<dim3(B * H, (Tq + BR - 1) / BR), WARPS * 32, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(pad),
          static_cast<const T*>(dout), static_cast<T*>(dq),
          static_cast<float*>(stats), H, Tq, S, hd, scale, causal != 0, seed,
          seed_ptr, threshold, inv, cm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dropout_bwd_keys_kernel<T>
      <<<dim3(B * H, (S + BR - 1) / BR), WARPS * 32, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(pad),
          static_cast<const T*>(dout), static_cast<const float*>(stats),
          static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, S, hd, scale,
          causal != 0, seed, seed_ptr, threshold, inv, cm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Attention without dropout. bhtd = 0: q, out (B, Tq, H*hd) and k, v
// (B, S, H*hd) with row strides ldq, ldkv and ldo elements (so the column
// blocks of a fused (B, T, 3D) tensor can be passed as three pointers);
// bhtd = 1: q, out (B, H, Tq, hd), k, v (B, H, S, hd), contiguous, the
// strides not read. All of one dtype (bf16 or f32); pad: (B, S) f32, read
// only when has_pad. mode 0: out = (sum p v) / rowsum(p); mode 1: p /
// rowsum(p) rounded to v's dtype before the product; mode 2: the int8
// layer's numerics (bf16 in, out f32; no causal mask or pad).
extern "C" int mit_attention_any_shape(const void* q, const void* k,
                                       const void* v, const void* pad,
                                       void* out, int B, int H, int Tq, int S,
                                       int hd, int ldq, int ldkv, int ldo,
                                       int bhtd, int causal, int has_pad,
                                       int mode, int bf16, void* stream) {
  const Cells cq = cells_of(bhtd != 0, H, Tq, hd, ldq);
  const Cells ck = cells_of(bhtd != 0, H, S, hd, ldkv);
  const Cells co = cells_of(bhtd != 0, H, Tq, hd, ldo);
  const void* p = has_pad ? pad : nullptr;
  if (mode == 2) {
    if (!bf16 || causal || has_pad)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_rows<__nv_bfloat16, false, true>(
        q, k, v, nullptr, out, cq, ck, co, B, H, Tq, S, hd, 0, 0, 0, nullptr, 0,
        1.f, stream);
  }
  const int norm_first = mode;
  return bf16 ? launch_rows<__nv_bfloat16, false>(q, k, v, p, out, cq, ck, co,
                                                  B, H, Tq, S, hd, causal,
                                                  norm_first, 0, nullptr, 0,
                                                  1.f, stream)
              : launch_rows<float, false>(q, k, v, p, out, cq, ck, co, B, H,
                                          Tq, S, hd, causal, norm_first, 0,
                                          nullptr, 0, 1.f, stream);
}

// Attention with dropout, forward. q, out: (B, H, T, hd); k, v:
// (B, H, S, hd), contiguous, all f32 (bf16 = 0) or all bf16; pad: (B, S) f32.
// b_offset, h_total, h_offset: the keep-mask's cell map (dropout_hash.cuh);
// seed_ptr: null, or a device word read in place of seed (launch_seed).
extern "C" int mit_dropout_attention_any_shape_fwd(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    int B, int H, int T, int S, int hd, int causal, int bf16, unsigned seed,
    const unsigned* seed_ptr, unsigned threshold, float one_minus_r,
    int b_offset, int h_total, int h_offset, void* stream) {
  const Cells cq = cells_of(true, H, T, hd, hd);
  const Cells ck = cells_of(true, H, S, hd, hd);
  const CellMap cm{b_offset, h_total, h_offset};
  return bf16 ? launch_rows<__nv_bfloat16, true>(q, k, v, pad, out, cq, ck, cq,
                                                 B, H, T, S, hd, causal, 1,
                                                 seed, seed_ptr, threshold,
                                                 one_minus_r, stream, cm)
              : launch_rows<float, true>(q, k, v, pad, out, cq, ck, cq, B, H,
                                         T, S, hd, causal, 1, seed, seed_ptr,
                                         threshold, one_minus_r, stream, cm);
}

// Attention with dropout, backward. The same q, k, v and pad, dout like q;
// dq like q, dk and dv like k; stats: (B*H, T, 3) f32 workspace; the cell
// map as the forward's.
extern "C" int mit_dropout_attention_any_shape_bwd(
    const void* q, const void* k, const void* v, const void* pad,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int B, int H,
    int T, int S, int hd, int causal, int bf16, unsigned seed,
    const unsigned* seed_ptr, unsigned threshold, float inv, int b_offset,
    int h_total, int h_offset, void* stream) {
  const CellMap cm{b_offset, h_total, h_offset};
  return bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, pad, dout, dq, dk, dv,
                                          stats, B, H, T, S, hd, causal, seed,
                                          seed_ptr, threshold, inv, cm, stream)
              : launch_bwd<float>(q, k, v, pad, dout, dq, dk, dv, stats, B, H,
                                  T, S, hd, causal, seed, seed_ptr, threshold,
                                  inv, cm, stream);
}
