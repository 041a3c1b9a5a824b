// flash_attention_dropout: attention with dropout on the probabilities, its
// backward, and a dump of its keep-mask, for sm_90a.
//
// Replaces the TPU kernels of mit_tpu/ops/pallas_dropout_attention.py:
// _fwd_kernel (:77, pallas_call :149), _bwd_kernel (:91, pallas_call :172)
// and the kernel of dump_dropout_mask (:223, pallas_call :231). Per grid cell
// (b, h), flattened as cell = b*H + h, with head_dim 64:
//   s    = (q . k^T) * 1/8 in f32, + -1e9 where col > row (causal), + pad[b]
//   p    = exp(s - rowmax(s)) / rowsum                (normalized first)
//   keep = murmur3(idx ^ seed*2654435761 ^ cell*0x9E3779B9) >= threshold,
//          idx = row*S + col, all uint32 with wrapping products
//   pd   = keep ? p / (1 - r) : 0, rounded to v's dtype
//   out  = pd . v with f32 accumulation, stored in q's dtype
// and the backward, all in f32 with inv = 1/(1 - r) rounded to f32:
//   dv = (keep ? p*inv : 0)^T . do
//   dp = keep ? (do . v^T) * inv : 0
//   ds = p * (dp - rowsum(dp * p))
//   dq = (ds . k) * 1/8      dk = (ds^T . q) * 1/8
// stored in the input dtype. The keep-mask is a stateless hash, so the
// backward regenerates the forward's mask, and the dump kernel writes the
// same mask for the tests. threshold = min(int(r * 2^32), 2^32 - 1), 1 - r
// and inv are computed on the host, as the JAX kernels compute them.
// Arithmetic on the probabilities uses the _rn intrinsics, so no multiply
// and add are contracted into an FMA the plain version does not make.
//
// What bounds it on the H100. The decoder's self-attention has T = S = 99
// and hd = 64 (at MAX_SEQ_LEN 100), so a whole (T, S) probability tile and
// the cell's q, k, v and do fit in one block's shared memory. The f32
// forward (dropout_fwd_kernel, which keeps full f32 products) takes one
// block per (cell, 32 query rows) and holds the 32 x S scores; the bf16
// forward runs on the tensor cores (dropout_fwd_tc_kernel, described where
// it stands below; a cell's bytes bound it at 0.004 ms for the training
// shape, and what it spends is exp, two divisions and a hash per
// probability, and the latency of one short block). The
// backward takes one block per cell, holding q, k, v, do (f32, rows padded to 65)
// and the T x S probabilities: 199 KB at T = S = 128 of the 227 KB a block
// may use, 140 KB at 99. So dk and dv reduce over T inside the block, with
// no atomics and no second pass. The bound is S <= 128 and T <= 128; beyond
// it, and at another head_dim, the wrapper launches the kernels of
// attention_any_shape.cu. These two kernels multiply in f32 FMAs on the CUDA cores,
// fed from shared memory, about four shared-memory reads per FMA pair:
// shared-memory bandwidth bounds it. At batch 32 and 8 heads the backward
// has 256 blocks, about two per SM. Tensor cores for the backward, and
// fewer reads of its tiles, are later work.
//
// Every entry point returns cudaGetLastError() after its launch (or the
// error of setting the shared-memory size); the wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "wgmma.cuh"

namespace {

constexpr int LD = HD + 1;        // padded shared-memory row: no bank conflicts
constexpr int MAX_LEN = 128;      // T and S bound
constexpr int WORDS = MAX_LEN / 32;
constexpr int BQ = 32;            // forward: query rows per block
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e9f;
constexpr float SCALE = 0.125f;   // 1/sqrt(64), exact

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

// rows [0, nrows) x HD of a contiguous (rows, 64) matrix into dst (stride
// LD, f32); rows past `valid` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int nrows,
                                          int valid) {
  for (int i = threadIdx.x; i < nrows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    dst[r * LD + c] = r < valid ? to_f32(src[(size_t)r * HD + c]) : 0.f;
  }
}

// Masked, scaled scores of rows [0, nq) (query rows q0 + r) into ps (stride
// pld), in the order of the reference: s * scale, + causal, + pad.
__device__ __forceinline__ void scores(float* ps, int pld, const float* qs,
                                       const float* ks, int nq, int q0, int S,
                                       const float* pad_row, bool causal) {
  for (int i = threadIdx.x; i < nq * S; i += THREADS) {
    const int r = i / S, c = i % S;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) acc = fmaf(qs[r * LD + d], ks[c * LD + d], acc);
    float x = __fmul_rn(acc, SCALE);
    if (causal) x = __fadd_rn(x, c <= q0 + r ? 0.f : NEG_INF);
    ps[r * pld + c] = __fadd_rn(x, pad_row[c]);
  }
}

// One warp's row of scores → its normalized probabilities, in place. Lane l
// holds columns l, l + 32, l + 64 and l + 96.
__device__ __forceinline__ void softmax_row(float* row, int S, float p[WORDS]) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const int c = lane + 32 * w;
    p[w] = c < S ? row[c] : -INFINITY;
    m = fmaxf(m, p[w]);
  }
  m = warp_max(m);
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    p[w] = lane + 32 * w < S ? expf(p[w] - m) : 0.f;
    l += p[w];
  }
  l = warp_sum(l);
#pragma unroll
  for (int w = 0; w < WORDS; ++w) p[w] = __fdiv_rn(p[w], l);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ pad,
                   T* __restrict__ out, int H, int Tq, int S, bool causal,
                   uint32_t seed, uint32_t threshold, float one_minus_r) {
  extern __shared__ float smem[];
  const int pld = S + 1;
  float* qs = smem;                  // BQ x LD
  float* ks = qs + BQ * LD;          // S x LD
  float* vs = ks + S * LD;           // S x LD
  float* ps = vs + S * LD;           // BQ x pld

  const int cell = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, Tq - q0);
  const size_t qoff = ((size_t)cell * Tq + q0) * HD;
  const size_t kvoff = (size_t)cell * S * HD;
  const float* pad_row = pad + (size_t)(cell / H) * S;
  const uint32_t base = cell_base(seed, (uint32_t)cell);

  load_rows(qs, q + qoff, nq, nq);
  load_rows(ks, k + kvoff, S, S);
  load_rows(vs, v + kvoff, S, S);
  __syncthreads();
  scores(ps, pld, qs, ks, nq, q0, S, pad_row, causal);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nq; r += WARPS) {
    float p[WORDS];
    softmax_row(ps + r * pld, S, p);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const int c = lane + 32 * w;
      if (c < S) {
        const bool kp = keep_at(q0 + r, c, S, base, threshold);
        ps[r * pld + c] = round_like(kp ? __fdiv_rn(p[w], one_minus_r) : 0.f, v);
      }
    }
  }
  __syncthreads();

  // out = pd . v: thread (j, group) owns column j of rows group + 4i
  const int j = threadIdx.x % HD, g = threadIdx.x / HD;
  constexpr int GROUPS = THREADS / HD;
  float o[BQ / GROUPS];
#pragma unroll
  for (int i = 0; i < BQ / GROUPS; ++i) o[i] = 0.f;
  for (int c = 0; c < S; ++c) {
    const float vv = vs[c * LD + j];
#pragma unroll
    for (int i = 0; i < BQ / GROUPS; ++i)
      o[i] = fmaf(ps[(g + GROUPS * i) * pld + c], vv, o[i]);
  }
#pragma unroll
  for (int i = 0; i < BQ / GROUPS; ++i) {
    const int r = g + GROUPS * i;
    if (r < nq) store(out + qoff + (size_t)r * HD + j, o[i]);
  }
}

// ----------------------------------------------------------------------
// The bf16 forward on the tensor cores.
//
// S <= 128 and hd = 64, so a cell's K and V are 16 KB each in bf16: they
// come in once a block by 16-byte cp.async (Q and K in one group, V in a
// second that lands under the scores) into 64-row tiles in the 128-byte
// swizzle, and wgmma reads them there. A warpgroup owns 64 query rows and
// holds their whole score rows in registers, 64 rows x 128 keys as two
// m64n64 accumulators, 64 f32 a thread: the exact row max, expf, the IEEE
// division by the row sum and by 1 - r are the reference's operations in
// its order, with no second walk. A bf16 product is exact in f32, so the
// scores differ from the CUDA-core kernel's only in the order of the sum.
// pd, rounded to bf16, is the A operand of P.V from registers, 16 keys a
// step over whole tiles (V's rows past S are zero-filled, pd there is 0).
// exp, the two divisions and the hash are most of what the kernel executes,
// so an 8-key tile whose probabilities are all exactly 0 (above the
// diagonal of the warp's 16 rows, or past S) skips them.
//
// The keep bit is drawn per accumulator element: element d[nt][e] of key
// tile kt stands for row frag_row(...) of the warpgroup and key
// 64 kt + frag_col(...) (wgmma.cuh), and keep_at takes the query row in the
// cell and that key. The pieces are laid out for the backward to take:
// load_cell_async, the fragment map, masked_score and keep_at on it.
//
// A block has NW warps, 4 or 8: one warpgroup and 64 query rows (two blocks
// a cell at T = 99) or two and 128 (one block a cell, K and V loaded once).
// ----------------------------------------------------------------------
constexpr int KT = MAX_LEN / 64;      // key tiles a cell
// a row whose max is below this has seen only masked keys
constexpr float ROW_MASKED = -5e8f;

// the score of (row, col) from the raw product, in the reference's order
__device__ __forceinline__ float masked_score(float acc, int row, int col,
                                              int S, float pad_col,
                                              bool causal) {
  float x = __fmul_rn(acc, SCALE);
  if (causal) x = __fadd_rn(x, col <= row ? 0.f : NEG_INF);
  x = __fadd_rn(x, pad_col);
  return col < S ? x : -INFINITY;
}

// a cell's rows [0, valid) of a contiguous (rows, 64) bf16 matrix into
// 64-row tiles, rows up to the next multiple of 16 zero-filled
__device__ __forceinline__ void load_cell_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int valid) {
  load_rows_async(dst, src, ((valid + 15) >> 4) << 4, valid, HD);
}

template <int NW>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 4 : 2)
dropout_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ pad,
                      __nv_bfloat16* __restrict__ out, int H, int Tq, int S,
                      bool causal, uint32_t seed, uint32_t threshold,
                      float one_minus_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - smem_u32(smem_raw)) & 1023));
  __nv_bfloat16* ks = qs + (NW / 4) * TILE;
  __nv_bfloat16* vs = ks + KT * TILE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cell = blockIdx.x;
  const int q0 = blockIdx.y * (NW * 16);
  const int grow = q0 + (warp >> 2) * 64;       // the warpgroup's first row
  const bool active = grow < Tq;
  const __nv_bfloat16* qb = q + ((size_t)cell * Tq + q0) * HD;
  const size_t kvoff = (size_t)cell * S * HD;
  const float* pad_row = pad + (size_t)(cell / H) * S;
  const uint32_t base = cell_base(seed, (uint32_t)cell);

  // whole tiles, zero past the last row: a product over a tile then needs
  // no test for where the rows end
  const int nkt = S > 64 ? 2 : 1;               // key tiles in use
  load_rows_async(qs, qb, NW * 16, min(NW * 16, Tq - q0), HD);
  load_cell_async(ks, k + kvoff, S);
  cp_async_commit();
  load_rows_async(vs, v + kvoff, nkt * 64, S, HD);
  cp_async_commit();
  cp_async_wait<1>();                           // Q and K
  // cp.async wrote the tiles; wgmma reads them through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  unsigned pf[KT][4][4];          // pd in bf16, as the A operand of P.V
  if (active) {
    // the first product of a tile overwrites its accumulator; with one key
    // tile the second accumulator is never read below -inf's select
    float s[KT][8][4];
    const unsigned long long dq = wg_desc(qs + (warp >> 2) * TILE);
    wg_fence();
#pragma unroll
    for (int ks4 = 0; ks4 < 4; ++ks4)
      wgmma_ss(s[0], dq + 2 * ks4, wg_desc(ks) + 2 * ks4, ks4 > 0);
    // (K's second tile holds zeros or stale bytes past S; their scores are
    // replaced by -inf whatever they are)
#pragma unroll
    for (int ks4 = 0; ks4 < 4; ++ks4)
      wgmma_ss(s[1], dq + 2 * ks4, wg_desc(ks + TILE) + 2 * ks4, ks4 > 0);
    wg_commit_wait(s[0]);
    wg_touch(s[1]);

    // masked scores and the exact row max: this thread holds, of rows
    // r0 = frag_row(.., 0) and r0 + 8, two keys of every 8
    const int r0 = grow + frag_row(warp & 3, lane, 0);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kt * 64 + frag_col(lane, nt, e);
          const float pc = col < S ? __ldg(pad_row + col) : 0.f;
          const float x0 = masked_score(s[kt][nt][e], r0, col, S, pc, causal);
          const float x1 =
              masked_score(s[kt][nt][2 + e], r0 + 8, col, S, pc, causal);
          s[kt][nt][e] = x0;
          s[kt][nt][2 + e] = x1;
          m0 = fmaxf(m0, x0);
          m1 = fmaxf(m1, x1);
        }
    // a row's keys lie in the 4 lanes of a quad
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // An 8-key tile of this warp's 16 rows is dead, every p in it exactly
    // 0, where its keys lie past S, or above the diagonal of all 16 rows
    // while each of those rows has seen an unmasked key (its max is not a
    // masked score's -1e9, so exp(-1e9 - max) = 0 in f32; a row whose
    // visible keys are all padded shares its max with those keys, and then
    // no tile of the warp is skipped). A warp with no row below Tq has
    // nothing to store: all of its tiles are dead.
    const int wrow = grow + (warp & 3) * 16;    // the warp's first row
    const bool seen = __all_sync(
        0xffffffffu, (m0 > ROW_MASKED || r0 >= Tq) &&
                         (m1 > ROW_MASKED || r0 + 8 >= Tq));
    auto dead = [&](int kt, int nt) {
      const int col = kt * 64 + nt * 8;
      return col >= S || wrow >= Tq || (causal && seen && col > wrow + 15);
    };
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (dead(kt, nt)) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[kt][nt][e] = expf(s[kt][nt][e] - m0);          // exp(-inf) = 0
          s[kt][nt][2 + e] = expf(s[kt][nt][2 + e] - m1);
          l0 += s[kt][nt][e];
          l1 += s[kt][nt][2 + e];
        }
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // p = e / l; pd = keep ? p / (1 - r) : 0, rounded to bf16
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (dead(kt, nt)) continue;
          const int row = grow + frag_row(warp & 3, lane, e);
          const int col = kt * 64 + frag_col(lane, nt, e);
          const float p = __fdiv_rn(s[kt][nt][e], e < 2 ? l0 : l1);
          pd[e] = keep_at(row, col, S, base, threshold)
                      ? __fdiv_rn(p, one_minus_r) : 0.f;
        }
        // accumulator tiles 2kk, 2kk+1 are the A fragment of k-step kk
        pf[kt][nt >> 1][(nt & 1) * 2] = pack_bf16(pd[0], pd[1]);
        pf[kt][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pd[2], pd[3]);
      }
  }

  cp_async_wait<0>();                           // V
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (!active) return;

  // out = pd . v: 16 keys (rows of the V tiles) a step over the whole tiles
  // in use; pd and V's rows are zero past S
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_bt(o, pf[0][kk], wg_desc(vs) + 128 * kk);
  if (nkt > 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_bt(o, pf[1][kk], wg_desc(vs + TILE) + 128 * kk);
  }
  wg_commit_wait(o);

  // through the warp's own (spent) query rows in shared memory, then 16
  // bytes a lane, four rows a store
  const int g = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* mine = qs + warp * 16 * HD;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    *reinterpret_cast<unsigned*>(mine + tile_at(g, col)) =
        pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<unsigned*>(mine + tile_at(g + 8, col)) =
        pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + (size_t)cell * Tq * HD;
  const int wrow = q0 + warp * 16;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = it * 4 + (lane >> 3), c = (lane & 7) * 8;
    if (wrow + r < Tq)
      *reinterpret_cast<uint4*>(ob + (size_t)(wrow + r) * HD + c) =
          *reinterpret_cast<const uint4*>(mine + tile_at(r, c));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ pad,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                   int S, bool causal, uint32_t seed, uint32_t threshold,
                   float inv) {
  extern __shared__ float smem[];
  const int pld = S + 1;
  float* qs = smem;                  // Tq x LD
  float* dos = qs + Tq * LD;         // Tq x LD
  float* ks = dos + Tq * LD;         // S x LD
  float* vs = ks + S * LD;           // S x LD
  float* ps = vs + S * LD;           // Tq x pld: p, then ds
  __shared__ uint32_t keep_bits[MAX_LEN * WORDS];

  const int cell = blockIdx.x;
  const size_t qoff = (size_t)cell * Tq * HD;
  const size_t kvoff = (size_t)cell * S * HD;
  const float* pad_row = pad + (size_t)(cell / H) * S;
  const uint32_t base = cell_base(seed, (uint32_t)cell);

  load_rows(qs, q + qoff, Tq, Tq);
  load_rows(dos, dout + qoff, Tq, Tq);
  load_rows(ks, k + kvoff, S, S);
  load_rows(vs, v + kvoff, S, S);
  __syncthreads();
  scores(ps, pld, qs, ks, Tq, 0, S, pad_row, causal);
  __syncthreads();

  // p (normalized, undropped) in place, and the keep-mask as bits
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < Tq; r += WARPS) {
    float p[WORDS];
    softmax_row(ps + r * pld, S, p);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const int c = lane + 32 * w;
      if (c < S) ps[r * pld + c] = p[w];
      const unsigned bits = __ballot_sync(
          0xffffffffu, c < S && keep_at(r, c, S, base, threshold));
      if (lane == 0) keep_bits[r * WORDS + w] = bits;
    }
  }
  __syncthreads();

  auto kept = [&](int r, int c) {
    return (keep_bits[r * WORDS + (c >> 5)] >> (c & 31)) & 1u;
  };
  const int j = threadIdx.x % HD, g = threadIdx.x / HD;
  constexpr int GROUPS = THREADS / HD;

  // dv = pd^T . do: thread (j, group) owns column j of key rows group + 4i
  for (int c = g; c < S; c += GROUPS) {
    float acc = 0.f;
    for (int r = 0; r < Tq; ++r) {
      const float pd = kept(r, c) ? __fmul_rn(ps[r * pld + c], inv) : 0.f;
      acc = fmaf(pd, dos[r * LD + j], acc);
    }
    store(dv + kvoff + (size_t)c * HD + j, acc);
  }
  __syncthreads();            // every read of p for dv before ds replaces it

  // dp and ds, one warp per query row
  for (int r = warp; r < Tq; r += WARPS) {
    float dp[WORDS], p[WORDS];
    float rs = 0.f;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const int c = lane + 32 * w;
      dp[w] = 0.f;
      p[w] = 0.f;
      if (c < S) {
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          acc = fmaf(dos[r * LD + d], vs[c * LD + d], acc);
        dp[w] = kept(r, c) ? __fmul_rn(acc, inv) : 0.f;
        p[w] = ps[r * pld + c];
        rs += __fmul_rn(dp[w], p[w]);
      }
    }
    rs = warp_sum(rs);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const int c = lane + 32 * w;
      if (c < S) ps[r * pld + c] = __fmul_rn(p[w], __fsub_rn(dp[w], rs));
    }
  }
  __syncthreads();

  // dq = (ds . k) * scale: thread (j, group) owns column j of query rows
  for (int r = g; r < Tq; r += GROUPS) {
    float acc = 0.f;
    for (int c = 0; c < S; ++c) acc = fmaf(ps[r * pld + c], ks[c * LD + j], acc);
    store(dq + qoff + (size_t)r * HD + j, __fmul_rn(acc, SCALE));
  }
  // dk = (ds^T . q) * scale
  for (int c = g; c < S; c += GROUPS) {
    float acc = 0.f;
    for (int r = 0; r < Tq; ++r) acc = fmaf(ps[r * pld + c], qs[r * LD + j], acc);
    store(dk + kvoff + (size_t)c * HD + j, __fmul_rn(acc, SCALE));
  }
}

__global__ void dump_mask_kernel(uint8_t* __restrict__ out, int Tq, int S,
                                 uint32_t seed, uint32_t threshold) {
  const int cell = blockIdx.x;
  const uint32_t base = cell_base(seed, (uint32_t)cell);
  uint8_t* o = out + (size_t)cell * Tq * S;
  for (int i = threadIdx.x; i < Tq * S; i += blockDim.x)
    o[i] = keep_at(i / S, i % S, S, base, threshold) ? 1 : 0;
}

size_t fwd_smem(int S) {
  return sizeof(float) * ((size_t)BQ * LD + 2 * (size_t)S * LD +
                          (size_t)BQ * (S + 1));
}

size_t bwd_smem(int Tq, int S) {
  return sizeof(float) * (2 * (size_t)Tq * LD + 2 * (size_t)S * LD +
                          (size_t)Tq * (S + 1));
}

bool bad_shape(int cells, int Tq, int S) {
  return cells <= 0 || Tq <= 0 || S <= 0 || Tq > MAX_LEN || S > MAX_LEN;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* pad,
               void* out, int B, int H, int Tq, int S, int causal,
               unsigned seed, unsigned threshold, float one_minus_r,
               void* stream) {
  if (bad_shape(B * H, Tq, S)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(S);
  cudaError_t err = cudaFuncSetAttribute(
      dropout_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  dropout_fwd_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<T*>(out), H, Tq, S, causal != 0, seed, threshold,
      one_minus_r);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* pad,
                  void* out, int B, int H, int Tq, int S, int causal,
                  unsigned seed, unsigned threshold, float one_minus_r,
                  void* stream) {
  if (bad_shape(B * H, Tq, S)) return static_cast<int>(cudaErrorInvalidValue);
  // the tiles, and the room to start them at 1024 bytes
  const int smem =
      (NW / 4 + 2 * KT) * TILE * (int)sizeof(__nv_bfloat16) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dropout_fwd_tc_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Tq + NW * 16 - 1) / (NW * 16));
  dropout_fwd_tc_kernel<NW><<<grid, NW * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(pad),
      static_cast<__nv_bfloat16*>(out), H, Tq, S, causal != 0, seed, threshold,
      one_minus_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* pad,
               const void* dout, void* dq, void* dk, void* dv, int B, int H,
               int Tq, int S, int causal, unsigned seed, unsigned threshold,
               float inv, void* stream) {
  if (bad_shape(B * H, Tq, S)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(Tq, S);
  cudaError_t err = cudaFuncSetAttribute(
      dropout_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dropout_bwd_kernel<T><<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, S, causal != 0, seed, threshold, inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, H, T, 64); k, v: (B, H, S, 64), contiguous, all f32 (bf16 = 0)
// or all bf16 (bf16 = 1); pad: (B, S) f32. T, S <= 128. warps = 4 or 8: the
// tensor-core kernel with that many warps a block (bf16 only, tensors at
// 16-byte boundaries); warps = 0: the CUDA-core kernel, the route of f32
// and, for bf16, a yardstick for measurements.
extern "C" int mit_flash_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    int B, int H, int T, int S, int causal, int bf16, int warps,
    unsigned seed, unsigned threshold, float one_minus_r, void* stream) {
  if (warps != 0) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    if (warps == 4)
      return launch_fwd_tc<4>(q, k, v, pad, out, B, H, T, S, causal, seed,
                              threshold, one_minus_r, stream);
    if (warps == 8)
      return launch_fwd_tc<8>(q, k, v, pad, out, B, H, T, S, causal, seed,
                              threshold, one_minus_r, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, pad, out, B, H, T, S,
                                          causal, seed, threshold,
                                          one_minus_r, stream)
              : launch_fwd<float>(q, k, v, pad, out, B, H, T, S, causal, seed,
                                  threshold, one_minus_r, stream);
}

// the same q, k, v and pad, dout like q; dq like q, dk and dv like k
extern "C" int mit_flash_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* pad,
    const void* dout, void* dq, void* dk, void* dv, int B, int H, int T,
    int S, int causal, int bf16, unsigned seed, unsigned threshold, float inv,
    void* stream) {
  return bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, pad, dout, dq, dk, dv, B,
                                          H, T, S, causal, seed, threshold,
                                          inv, stream)
              : launch_bwd<float>(q, k, v, pad, dout, dq, dk, dv, B, H, T, S,
                                  causal, seed, threshold, inv, stream);
}

// out: (cells, T, S) bytes, 1 where kept
extern "C" int mit_dump_dropout_mask(void* out, int cells, int T, int S,
                                     unsigned seed, unsigned threshold,
                                     void* stream) {
  if (cells <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dump_mask_kernel<<<cells, 256, 0, (cudaStream_t)stream>>>(
      static_cast<uint8_t*>(out), T, S, seed, threshold);
  return static_cast<int>(cudaGetLastError());
}
