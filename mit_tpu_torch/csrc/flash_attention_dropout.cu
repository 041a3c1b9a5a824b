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
// and hd = 64 (at MAX_SEQ_LEN 100), so a cell's q, k, v and do and its
// whole (T, S) probability tile fit in one block's shared memory. The f32
// kernels (dropout_fwd_kernel, dropout_bwd_kernel) keep full f32 products
// on the CUDA cores: the forward takes one block per (cell, 32 query rows)
// and holds the 32 x S scores; the backward one block per cell, holding q,
// k, v, do (rows padded to 65) and the T x S probabilities (199 KB at
// T = S = 128, 140 KB at 99), so dk and dv reduce over T inside the block,
// with no atomics and no second pass; shared-memory reads bound both, about
// four per FMA pair. bf16 runs on the tensor cores: the forward
// (dropout_fwd_tc_kernel) and the backward (dropout_bwd_tc_kernel), each
// described where it stands below. A cell's bytes bound them at 0.004 and
// 0.007 ms for the training shape; what they spend is exp, a division and a
// hash per probability and the latency of short blocks. The bound is
// S <= 128 and T <= 128; beyond it, and at another head_dim, the wrapper
// launches the kernels of attention_any_shape.cu.
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
                   uint32_t seed, uint32_t threshold, float one_minus_r,
                   CellMap cm) {
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
  const uint32_t base = cell_base(seed, global_cell(cell, H, cm));

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
                      float one_minus_r, CellMap cm) {
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
  const uint32_t base = cell_base(seed, global_cell(cell, H, cm));

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

// ----------------------------------------------------------------------
// The bf16 backward on the tensor cores.
//
// One block a cell, two warpgroups. Q, dO, K and V come in once by 16-byte
// cp.async as 128-row tiles in the 128-byte swizzle, zero past T or S (a
// product over a tile then needs no test for where rows end, and no stale
// byte meets a zero). The block walks the cell twice:
//
// Phase A, warpgroup w owns query rows 64w .. 64w + 63. S = Q.K^T and
// dP = dO.V^T by wgmma into registers (64 rows x 128 keys each, as the
// forward holds its scores); then the forward's operations in its order
// (masked_score, the exact row max, expf, the IEEE division by the row sum)
// and the keep bit per accumulator element; pd = keep ? p*inv : 0,
// dp = keep ? acc*inv : 0, the row's delta = sum(dp*p) over the thread's
// elements then the quad, ds = p*(dp - delta). The JAX kernel keeps pd and
// ds in f32 inside its products, so each goes into them as a pair of bf16
// values, hi = bf16(x) and lo = bf16(x - hi), two wgmmas into one f32
// accumulator: q, k, v and do are bf16, a bf16 product is exact in f32, so
// only the order of the sums moves (|x - hi - lo| <= 2^-16 |x|). The pairs
// go to shared memory as [key tile][128 query rows][64 keys]; then
// dQ = dS.K, dS read K-major from there and K transposed.
//
// Phase B, warpgroup w owns keys 64w .. 64w + 63: dV = PD^T.dO and
// dK = dS^T.Q, both operands read transposed from shared memory (16 query
// rows a k-step). dq, dk and dv go out through spent tiles, 16 bytes a lane.
//
// What costs is what the forward spends: expf, a division and a hash per
// probability, now with ds and the pairs; the 32 k-steps of the products
// are a small part. So an 8-key tile of a warp's 16 rows whose pd and ds are
// all exactly 0 skips that work and stores zeros (the forward's rule: past
// S, rows past T, or above the diagonal of all 16 rows while each of them
// has seen an unmasked key), while the products take every k-step.
// Register pressure bounds the latency the warps can hide: 255 registers a
// thread, 8 warps an SM. Shared memory: 64 KB of inputs and 128 KB of
// pairs, one block an SM; 256 cells run in two waves over 132 SMs.
// ----------------------------------------------------------------------
constexpr int RG = MAX_LEN / 16;      // k-steps of 16 over 128 rows or keys

// x0, x1 as bf16 pairs: hi = bf16(x), lo = bf16(x - hi) (x - hi is exact)
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(__fsub_rn(x0, __uint_as_float(hi << 16)),
                 __fsub_rn(x1, __uint_as_float(hi & 0xFFFF0000u)));
}

__device__ __forceinline__ void store_u32(__nv_bfloat16* p, unsigned x) {
  *reinterpret_cast<unsigned*>(p) = x;
}

// a warp's 16 accumulator rows, rows row0 .. row0 + 15 of a (rows, 64) bf16
// matrix, those below `valid` to global memory, through the 16 x 64 staging
// tile `mine`: 4-byte stores in, then 16 bytes a lane, four rows a store
__device__ __forceinline__ void store_rows(const float (&o)[8][4],
                                           __nv_bfloat16* mine,
                                           __nv_bfloat16* out, int row0,
                                           int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    store_u32(mine + tile_at(g, col), pack_bf16(o[nt][0], o[nt][1]));
    store_u32(mine + tile_at(g + 8, col), pack_bf16(o[nt][2], o[nt][3]));
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = it * 4 + (lane >> 3), c = (lane & 7) * 8;
    if (row0 + r < valid)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * HD + c) =
          *reinterpret_cast<const uint4*>(mine + tile_at(r, c));
  }
}

__global__ void __launch_bounds__(256, 1)
dropout_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ pad,
                      const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dq,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int Tq, int S,
                      bool causal, uint32_t seed, uint32_t threshold,
                      float inv, CellMap cm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q, dO, K, V: 128 rows each (two tiles); then the pairs, 128 query rows
  // by 64 keys for each kind and key tile
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - smem_u32(smem_raw)) & 1023));
  __nv_bfloat16* dos = qs + KT * TILE;
  __nv_bfloat16* ks = dos + KT * TILE;
  __nv_bfloat16* vs = ks + KT * TILE;
  __nv_bfloat16* pairs = vs + KT * TILE;
  enum { PD_HI, PD_LO, DS_HI, DS_LO };
  auto pair_at = [&](int kind, int kt) {
    return pairs + (kind * KT + kt) * KT * TILE;
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int cell = blockIdx.x;
  const size_t qoff = (size_t)cell * Tq * HD;
  const size_t kvoff = (size_t)cell * S * HD;
  const float* pad_row = pad + (size_t)(cell / H) * S;
  const uint32_t base = cell_base(seed, global_cell(cell, H, cm));

  // every tile, zero past T or S: every product reads all 128 rows
  load_rows_async(qs, q + qoff, MAX_LEN, Tq, HD);
  load_rows_async(ks, k + kvoff, MAX_LEN, S, HD);
  load_rows_async(dos, dout + qoff, MAX_LEN, Tq, HD);
  load_rows_async(vs, v + kvoff, MAX_LEN, S, HD);
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ---- phase A: the warpgroup's 64 query rows against every key ----
  const int grow = wg * 64;                     // the warpgroup's first row
  const int wrow = grow + wq * 16;              // the warp's first row
  const int r0 = grow + frag_row(wq, lane, 0);  // this thread's rows r0, r0+8
  const int t4 = lane & 3;
  const bool rows_on = grow < Tq;
  if (rows_on) {
    float s[KT][8][4], dp[KT][8][4];
    const unsigned long long dq_a = wg_desc(qs + wg * TILE);
    const unsigned long long do_a = wg_desc(dos + wg * TILE);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int ks4 = 0; ks4 < 4; ++ks4)
        wgmma_ss(s[kt], dq_a + 2 * ks4, wg_desc(ks + kt * TILE) + 2 * ks4,
                 ks4 > 0);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int ks4 = 0; ks4 < 4; ++ks4)
        wgmma_ss(dp[kt], do_a + 2 * ks4, wg_desc(vs + kt * TILE) + 2 * ks4,
                 ks4 > 0);
    wg_commit_wait(s[0]);
    wg_touch(s[1]);
    wg_touch(dp[0]);
    wg_touch(dp[1]);

    // masked scores and the exact row max, as the forward
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
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // the forward's dead 8-key tiles (see dropout_fwd_tc_kernel): there p,
    // and so pd and ds, are exactly 0
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

    // p = e / l, the keep bit, pd (to shared memory as pairs), dp; delta.
    // Rows past T keep nothing: their pd is 0 and, with dO's zero rows,
    // so are dp, delta and ds.
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float pd[4] = {0.f, 0.f, 0.f, 0.f};
        if (!dead(kt, nt)) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = grow + frag_row(wq, lane, e);
            const int col = kt * 64 + frag_col(lane, nt, e);
            const float p = __fdiv_rn(s[kt][nt][e], e < 2 ? l0 : l1);
            const bool kp =
                row < Tq && keep_at(row, col, S, base, threshold);
            const float gp = kp ? __fmul_rn(dp[kt][nt][e], inv) : 0.f;
            pd[e] = kp ? __fmul_rn(p, inv) : 0.f;
            s[kt][nt][e] = p;
            dp[kt][nt][e] = gp;
            if (e < 2)
              d0 += __fmul_rn(gp, p);
            else
              d1 += __fmul_rn(gp, p);
          }
        }
        const int col = nt * 8 + 2 * t4;
        unsigned hi, lo;
        split_pair(pd[0], pd[1], hi, lo);
        store_u32(pair_at(PD_HI, kt) + tile_at(r0, col), hi);
        store_u32(pair_at(PD_LO, kt) + tile_at(r0, col), lo);
        split_pair(pd[2], pd[3], hi, lo);
        store_u32(pair_at(PD_HI, kt) + tile_at(r0 + 8, col), hi);
        store_u32(pair_at(PD_LO, kt) + tile_at(r0 + 8, col), lo);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }

    // ds = p (dp - delta), as pairs to shared memory
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (!dead(kt, nt)) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = __fmul_rn(s[kt][nt][e],
                             __fsub_rn(dp[kt][nt][e], e < 2 ? d0 : d1));
        }
        const int col = nt * 8 + 2 * t4;
        unsigned hi, lo;
        split_pair(x[0], x[1], hi, lo);
        store_u32(pair_at(DS_HI, kt) + tile_at(r0, col), hi);
        store_u32(pair_at(DS_LO, kt) + tile_at(r0, col), lo);
        split_pair(x[2], x[3], hi, lo);
        store_u32(pair_at(DS_HI, kt) + tile_at(r0 + 8, col), hi);
        store_u32(pair_at(DS_LO, kt) + tile_at(r0 + 8, col), lo);
      }
  } else {
    // rows past T (T <= 64): zero pairs, which the products read
#pragma unroll
    for (int kind = 0; kind < 4; ++kind)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + 2 * t4;
          store_u32(pair_at(kind, kt) + tile_at(r0, col), 0u);
          store_u32(pair_at(kind, kt) + tile_at(r0 + 8, col), 0u);
        }
  }
  // the pairs were written by the generic proxy; wgmma reads them through
  // the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ---- dQ (phase A's rows), then phase B: the warpgroup's 64 keys ----
  // Both warpgroups run every k-step, zeros and all: a wgmma in
  // a branch makes ptxas serialize every wgmma of the kernel (C7520), and
  // the tensor cores' time is small beside the rest.
  float dqa[8][4], dva[8][4], dka[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = dva[nt][e] = dka[nt][e] = 0.f;
  const unsigned long long kb = wg_desc(ks);
  const unsigned long long dob = wg_desc(dos), qb = wg_desc(qs);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < RG; ++kk) {
    // dS (K-major: the warpgroup's rows of key tile kk / 4, 16 keys a
    // step) against K read transposed
    const int kt = kk >> 2, k4 = kk & 3;
    wgmma_ss_bt(dqa, wg_desc(pair_at(DS_HI, kt) + wg * TILE) + 2 * k4,
                kb + 128 * kk);
    wgmma_ss_bt(dqa, wg_desc(pair_at(DS_LO, kt) + wg * TILE) + 2 * k4,
                kb + 128 * kk);
  }
#pragma unroll
  for (int kk = 0; kk < RG; ++kk) {
    // PD^T.dO and dS^T.Q over the warpgroup's keys, 16 query rows a step
    wgmma_ss_tt(dva, wg_desc(pair_at(PD_HI, wg)) + 128 * kk, dob + 128 * kk);
    wgmma_ss_tt(dva, wg_desc(pair_at(PD_LO, wg)) + 128 * kk, dob + 128 * kk);
    wgmma_ss_tt(dka, wg_desc(pair_at(DS_HI, wg)) + 128 * kk, qb + 128 * kk);
    wgmma_ss_tt(dka, wg_desc(pair_at(DS_LO, wg)) + 128 * kk, qb + 128 * kk);
  }
  wg_commit_wait(dqa);
  wg_touch(dva);
  wg_touch(dka);

  if (rows_on) {
    // through V's tile of these rows (no product reads V after phase A)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[nt][e] = __fmul_rn(dqa[nt][e], SCALE);
    store_rows(dqa, vs + wg * TILE + wq * 16 * HD, dq + qoff, wrow, Tq);
  }
  if (grow < S) {
    // through this warpgroup's pd pairs, which only its own products read:
    // every warp of the group is past them first
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nt][e] = __fmul_rn(dka[nt][e], SCALE);
    store_rows(dva, pair_at(PD_HI, wg) + wq * 16 * HD, dv + kvoff, wrow, S);
    store_rows(dka, pair_at(PD_LO, wg) + wq * 16 * HD, dk + kvoff, wrow, S);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ pad,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                   int S, bool causal, uint32_t seed, uint32_t threshold,
                   float inv, CellMap cm) {
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
  const uint32_t base = cell_base(seed, global_cell(cell, H, cm));

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

__global__ void dump_mask_kernel(uint8_t* __restrict__ out, int H, int Tq,
                                 int S, uint32_t seed, uint32_t threshold,
                                 CellMap cm) {
  const int cell = blockIdx.x;
  const uint32_t base = cell_base(seed, global_cell(cell, H, cm));
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
               CellMap cm, void* stream) {
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
      one_minus_r, cm);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* pad,
                  void* out, int B, int H, int Tq, int S, int causal,
                  unsigned seed, unsigned threshold, float one_minus_r,
                  CellMap cm, void* stream) {
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
      one_minus_r, cm);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const void* q, const void* k, const void* v, const void* pad,
               const void* dout, void* dq, void* dk, void* dv, int B, int H,
               int Tq, int S, int causal, unsigned seed, unsigned threshold,
               float inv, CellMap cm, void* stream) {
  if (bad_shape(B * H, Tq, S)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(Tq, S);
  cudaError_t err = cudaFuncSetAttribute(
      dropout_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dropout_bwd_kernel<float><<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, S, causal != 0,
      seed, threshold, inv, cm);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* pad, const void* dout, void* dq, void* dk,
                  void* dv, int B, int H, int Tq, int S, int causal,
                  unsigned seed, unsigned threshold, float inv, CellMap cm,
                  void* stream) {
  if (bad_shape(B * H, Tq, S)) return static_cast<int>(cudaErrorInvalidValue);
  // Q, dO, K, V and the four pair arrays, and the room to start at 1024
  const int smem = (4 * KT + 4 * KT * KT) * TILE *
                       (int)sizeof(__nv_bfloat16) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dropout_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dropout_bwd_tc_kernel<<<B * H, 256, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(pad),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, S, causal != 0, seed, threshold,
      inv, cm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, H, T, 64); k, v: (B, H, S, 64), contiguous, all f32 (bf16 = 0)
// or all bf16 (bf16 = 1); pad: (B, S) f32. T, S <= 128. warps = 4 or 8: the
// tensor-core kernel with that many warps a block (bf16 only, tensors at
// 16-byte boundaries); warps = 0: the CUDA-core kernel, the route of f32
// and, for bf16, a yardstick for measurements. b_offset, h_total, h_offset:
// the cell map of the keep-mask (dropout_hash.cuh; 0, H, 0 on one device).
extern "C" int mit_flash_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    int B, int H, int T, int S, int causal, int bf16, int warps,
    unsigned seed, unsigned threshold, float one_minus_r, int b_offset,
    int h_total, int h_offset, void* stream) {
  const CellMap cm{b_offset, h_total, h_offset};
  if (bad_map(H, cm)) return static_cast<int>(cudaErrorInvalidValue);
  if (warps != 0) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    if (warps == 4)
      return launch_fwd_tc<4>(q, k, v, pad, out, B, H, T, S, causal, seed,
                              threshold, one_minus_r, cm, stream);
    if (warps == 8)
      return launch_fwd_tc<8>(q, k, v, pad, out, B, H, T, S, causal, seed,
                              threshold, one_minus_r, cm, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, pad, out, B, H, T, S,
                                          causal, seed, threshold,
                                          one_minus_r, cm, stream)
              : launch_fwd<float>(q, k, v, pad, out, B, H, T, S, causal, seed,
                                  threshold, one_minus_r, cm, stream);
}

// the same q, k, v and pad, dout like q; dq like q, dk and dv like k. bf16
// runs on the tensor cores (q, k, v and dout at 16-byte boundaries), f32 on
// the CUDA cores.
extern "C" int mit_flash_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* pad,
    const void* dout, void* dq, void* dk, void* dv, int B, int H, int T,
    int S, int causal, int bf16, unsigned seed, unsigned threshold, float inv,
    int b_offset, int h_total, int h_offset, void* stream) {
  const CellMap cm{b_offset, h_total, h_offset};
  if (bad_map(H, cm)) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_bwd_tc(q, k, v, pad, dout, dq, dk, dv, B, H, T, S,
                              causal, seed, threshold, inv, cm, stream)
              : launch_bwd(q, k, v, pad, dout, dq, dk, dv, B, H, T, S, causal,
                           seed, threshold, inv, cm, stream);
}

// out: (cells, T, S) bytes, 1 where kept; cells = B * H, under the cell map
extern "C" int mit_dump_dropout_mask(void* out, int cells, int H, int T, int S,
                                     unsigned seed, unsigned threshold,
                                     int b_offset, int h_total, int h_offset,
                                     void* stream) {
  const CellMap cm{b_offset, h_total, h_offset};
  if (cells <= 0 || H <= 0 || cells % H || T <= 0 || S <= 0 || bad_map(H, cm))
    return static_cast<int>(cudaErrorInvalidValue);
  dump_mask_kernel<<<cells, 256, 0, (cudaStream_t)stream>>>(
      static_cast<uint8_t*>(out), H, T, S, seed, threshold, cm);
  return static_cast<int>(cudaGetLastError());
}
