// flash_attention_btd and flash_attention: multi-head attention in the
// (B, T, D) activation layout, heads as column blocks of hd columns, and in
// (B, H, T, hd), for sm_90a, at hd = 64 and at 72 to 128 in multiples of 8.
//
// Replaces the TPU kernel _attn_kernel_btd in mit_tpu/ops/pallas_attention.py
// (behind flash_attention_btd / _flash_forward_btd) and computes the same
// thing, per head h (columns h*hd .. h*hd+hd-1):
//   s   = (q_h . k_h^T) * 1/sqrt(hd)                     in f32
//   s  += -1e9 where col > row              (causal)
//   s  += pad[b, col]                       (has_pad)
//   p   = exp(s - rowmax(s))
//   out = (round_to_v_dtype(p) . v_h, f32 accumulation) / rowsum(p)
// cast to the dtype of q. -1e9 rather than -inf keeps a fully masked row
// finite: it comes out as the reference's softmax gives it, not NaN.
//
// Two kernels compute it. bf16 inputs take flash_attention_btd_tc_kernel, on
// the tensor cores; f32 inputs (which must keep full f32 products: TF32
// would keep 10 mantissa bits) take flash_attention_f32_kernel, on the CUDA
// cores. Both serve the (B, T, D), the fused-QKV and the (B, H, T, 64)
// entries. A third, flash_attention_btd_kernel, is the first CUDA-core
// kernel of the port, which every entry ran before those two: it is reached
// only through the entries named *_cudacore and *_v1, for measurements.
//
// The bf16 kernel: what bounds it on the H100, and what the design does.
// At the encoder's shape (B = 64, T = S = 197, 12 heads) the function moves
// 77 MB (0.023 ms at 3.35 TB/s) and does 7.6 GFLOP (0.008 ms at the bf16
// tensor-core peak): bytes bound it, and the CUDA cores, at 67 TFLOP/s less
// what shared-memory traffic leaves of it, are thirty times too slow. So:
// - Both products are wgmma (m64n64k16, bf16 in, f32 accumulate; a bf16
//   product is exact in f32, so the scores are the reference's up to the
//   order of the sum). A warpgroup of 4 warps owns 64 query rows; Q and the
//   K tile (for the scores) and the V tile (for P.V, read transposed) are
//   named by descriptors and read from shared memory by the tensor cores
//   themselves, once for the 64 rows.
// - The probabilities never leave registers: a warp's share of the f32
//   score accumulator, after exp and rounding to bf16, IS the A operand
//   wgmma takes from registers for the P.V product, 16 keys a step.
// - K and V tiles of 64 keys stay bf16 in shared memory and come in by
//   16-byte cp.async into a ring of three stages, two tiles ahead, with one
//   barrier a tile. Rows are 128 bytes with their 16-byte chunks XORed by
//   the row (the 128-byte swizzle the descriptors name; cp.async writes it
//   by computing the address), tiles at 1024 bytes, and a proxy fence
//   stands between cp.async's writes and wgmma's reads. Rows past S are
//   zero-filled (src-size 0), so 0 * V stays 0, and only whole 16-key steps
//   that hold a key below S are loaded or multiplied in P.V: S = 197 costs
//   208 keys there, not 256.
// - A tile with no causal, padded or out-of-range key skips the masks; exp
//   is one MUFU instruction, ex2.approx of (x - max) * log2 e.
// - A block of 4 or 8 warps owns 64 or 128 query rows of one (batch, head),
//   so a head's K and V are read twice at T = 197, not seven times.
// - Softmax, three modes. ONLINE (the (B, T, D) and fused-QKV entries): one
//   product for the scores and an online softmax (a running row max; the
//   sums and the output are rescaled by exp(m_old - m_new) when it grows).
//   p is rounded to bf16 against the running max, not the final one, so p
//   before rounding is no longer bit for bit the reference's number; the
//   error stays that of one bf16 rounding per probability, far inside the
//   bf16 limit of 2e-2. LAYER (the int8 whole-layer numerics): that is not
//   good enough, because the context is requantized to int8 right after,
//   and a difference of one bf16 rounding per probability flips enough
//   codes to push the layer past its bound against the plain version
//   (relative L2 8e-3 against 5e-3, measured). So LAYER walks the key tiles
//   twice, first for the exact row max from the scores alone (K tiles
//   only), then for exp2(s - max), the row sum and P.V: p is the
//   reference's number, at a third more time. NORM (the (B, H, T, 64)
//   entry, whose reference normalizes the probabilities BEFORE it rounds
//   them to bf16 for P.V): the first walk takes the row max and the row
//   sum (online over the K tiles: a sum rescaled when the max grows, which
//   differs from the sum against the final max only in f32 rounding), the
//   second takes p = exp(s - max) * (1 / sum), rounds it and multiplies;
//   nothing is divided at the end. Holding a whole score row in registers
//   instead would take 128 registers a thread at S = 256 and a second code
//   path above it.
// - Causal: the walk ends at the block's diagonal, which is exact while
//   each row has seen a visible key (the skipped terms are exp(-1e9 - m) =
//   0 in f32). A row whose visible keys are all padded shares its max of
//   -1e9 with the causally masked keys that are NOT padded, and the
//   reference spreads it over those too; by a block-wide vote at the
//   diagonal a block with such a row (running max below -5e8) walks on.
//   NORM votes at the end of its first walk and lengthens both.
// - The bf16 output goes through the warp's own query rows in shared memory
//   and leaves in 16-byte stores, scaled by one reciprocal a row.
// A first design on mma.sync.m16n8k16 (a warp to 16 or 32 query rows, K
// and V fragments by ldmatrix from rows padded to 144 bytes, every warp its
// own copy of them: four times wgmma's shared-memory traffic) computed the
// same numbers in 0.072 ms at the encoder shape (0.085 at 32 rows a warp)
// against wgmma's 0.059, and was taken out.
// What holds the kernel now (NVIDIA H100 80GB HBM3 at 700 W, the encoder
// shape: 0.059 ms against the bound of 0.023 and a cuDNN call's 0.045 to
// 0.050): not a pipe but latency. A block lives for four key tiles, so its
// first loads are a quarter of its life, and a warpgroup waits for each of
// its two products before it goes on. A persistent block that walks heads
// and keeps loads in flight across them is the next step.
//
// The f32 kernel: what bounds it, and what the design does. At the BLIP-384
// shape (8, 12, 577, 64) the function is two products of 8.2 GFLOP together:
// 0.122 ms at the 67 TFLOP/s of the f32 pipes, against 0.007 ms for its
// 14 MB. Operations bound it, so the design issues as little beside the
// FMAs as it can:
// - One walk over the keys with an online softmax: q.k^T is computed once.
//   In f32 nothing is rounded between the softmax and P.V, so (sum p v) / l
//   with p against a running max differs from the reference only in f32
//   rounding, in both layouts (the (B, H, T, 64) reference normalizes p
//   first; sum (p / l) v is the same number up to that rounding).
// - A block of 128 threads owns 128 query rows; a thread owns 8 x 8 of a
//   128 x 64 score tile and 8 x 8 of the 128 x 64 output. Its operands come
//   from shared memory 16 bytes a load along head_dim: 16 loads feed 256
//   FMAs in either product, where 4 x 4 tiles of scalars took 8 for 16.
//   Rows are padded to 68 floats, so the 8 rows a quarter-warp reads lie in
//   8 different bank groups.
// - The probabilities go from the score registers to the P.V operand
//   through shared memory, but a row of P is written and read by the same 8
//   lanes of one warp: no block barrier stands between the two products.
//   Its 8-column groups are XORed by the row group, which makes the scalar
//   stores conflict-free and leaves the 16-byte loads aligned.
// - K and V tiles of 64 keys come in by 16-byte cp.async with no
//   conversion pass, V under the score product and the next K under P.V;
//   rows past S are zero-filled and the 8-key groups past S are skipped.
// - A warp whose 32 query rows lie past T takes part in the loads and the
//   barriers only.
// - exp is ex2.approx of (x - max) * log2 e, the difference first, as in
//   the bf16 kernel. A head's K and V are read 5 times at T = 577, where
//   32-row blocks read them 19 times.
//
// Fused QKV. Both kernels also replace _attn_kernel_btd_fusedqkv
// (pallas_attention.py:196, behind flash_attention_btd_fusedqkv) and the
// attention stage of the int8 whole-layer kernel (_attn_body in
// mit_tpu/ops/pallas_int8_layer.py:69-127). There q, k and v are the column
// blocks 0, D and 2D of one (B, T, 3D) tensor, as the fused QKV projection
// writes it: the loads take a row stride (3D) and a column offset, so no
// split or copy of that tensor is made. The whole-layer kernel's numerics
// differ in three places, selected by LAYER: the scores
// are scaled by log2(e)/sqrt(64) and exponentiated with exp2f (the same p
// up to rounding), the context is o * (1 / rowsum) rather than o / rowsum,
// and it is written in f32 from bf16 qkv.
//
// (B, H, T, hd) layout. Both kernels also replace _attn_kernel_allheads
// (pallas_attention.py:86, behind flash_attention), which the JAX package
// runs where one (T, D) batch cell would not fit its fast memory. The
// Pallas cell holds every head's whole (T, hd) and (S, hd) tiles and one
// (T, S) score block; here the grid is the same (batch, head, query tile)
// as in (B, T, D), with a row stride of 64 and head h of batch b at
// ((b*H + h)*T) rows. Its numerics differ in one place: the probabilities
// are normalized BEFORE P.V, probs = p / rowsum(p), rounded to v's dtype,
// and the product is the output (NORM above; in f32 nothing is rounded and
// the f32 kernel divides after the product).
//
// Heads wider than 64 (ViT-H/14's 80, and every multiple of 8 up to 128).
// Both kernels are templates on the padded width HDP, hd rounded up to a
// multiple of 16 (64 itself at 64: that instantiation is the kernel the text
// above describes); every HDP is its own instantiation, because a wgmma
// behind a runtime branch serializes them all. The columns from hd to HDP
// are zero-filled by the loads (cp.async with src-size 0, as for rows past
// S) and never stored; hd sets the loads, the stores and the scale.
// - bf16: a Q, K or V tile is two 64-column panels in the 128-byte swizzle,
//   each the tile the descriptors already name. Q.K^T takes HDP / 16
//   k-steps across the panels; P.V one wgmma a panel and 16-key step,
//   m64n64k16 on the first and m64nNk16 with N = HDP - 64 (16 to 64) on the
//   second, into HDP / 2 accumulators a thread. The K and V ring has two
//   stages (96 KB a block of 8 warps): two blocks an SM up to HDP 96 (128
//   registers), one at 112 and 128 (163 to 199); a block still owns 64 or
//   128 query rows (bf16_tiling: at ViT-H/14's 257 rows, 8 warps took
//   0.148 ms against 4 warps' 0.221 on the H100).
// - f32: 4 query rows a thread (64 a block), so that a thread's 4 x HDP/8
//   output accumulators do not spill; the output's 4-column groups go round
//   the 8 lanes of a row. Two blocks an SM up to HDP 112, one at 128 (79 to
//   115 KB of shared memory).
// What bounds them is what bounds the 64-column kernels: bytes in bf16 (at
// ViT-H/14's (64, 257, 1280) 168 MB, 0.050 ms), f32 operations in f32.
//
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 128;    // 16 column lanes x 8 row lanes
constexpr int LD = HD + 1;      // padded shared-memory row: no bank conflicts
constexpr int PLD = BK + 1;
constexpr float NEG_INF = -1e9f;
constexpr float SCALE = 0.125f;                        // 1/sqrt(64), exact
constexpr float SCALE2 = 0.18033688011112042f;         // log2(e)/sqrt(64)
constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------------------
// The first CUDA-core kernel (f32 and bf16, both layouts): two walks over
// the keys with q.k^T in both, 4 x 4 register tiles of scalars, synchronous
// converting loads. No path of the port runs it; the *_cudacore and *_v1
// entries keep it so that a run can time the kernels above against it.
// ----------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// p is rounded to v's dtype before P.V, as the reference casts it.
__device__ __forceinline__ float round_like(float x, const float*) {
  return x;
}
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [0, nrows) x HD columns of a row-major matrix with row stride `ld`
// into dst (row stride LD, f32); rows past `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int nrows,
                                          int valid, int ld) {
  for (int i = threadIdx.x; i < nrows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    dst[r * LD + c] = r < valid ? to_f32(src[(size_t)r * ld + c]) : 0.f;
  }
}

// Masked, scaled scores of this thread's 4 x 4 cells: rows ty + 8i of the
// query tile, columns tx + 16j of the key tile. Columns past S are -inf so
// they drop out of the max and the sum.
__device__ __forceinline__ void tile_scores(float s[4][4], const float* qs,
                                            const float* ks, int q0, int k0,
                                            int S, const float* pad_row,
                                            bool causal, int tx, int ty,
                                            float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 8 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      float x = s[i][j] * scale;
      if (causal) x += col <= row ? 0.f : NEG_INF;
      if (pad_row != nullptr && col < S) x += pad_row[col];
      s[i][j] = col < S ? x : -INFINITY;
    }
  }
}

// q rows have stride ldq, k and v rows stride ldkv, out rows stride D
// (the model width); head h is columns h*64 .. h*64+63 of each. With BHTD
// the tensors are (B, H, T|S, 64): ldq = ldkv = D = 64 and head h of batch b
// starts (b*H + h) * (Tq or S) rows in.
template <typename T, typename OutT, bool LAYER, bool BHTD>
__global__ void __launch_bounds__(THREADS)
flash_attention_btd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ pad,
                           OutT* __restrict__ out, int Tq, int S, int D,
                           int ldq, int ldkv, bool causal) {
  __shared__ float qs[BQ * LD];
  __shared__ float kvs[BK * LD];   // the K tile, then the V tile
  __shared__ float ps[BQ * PLD];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const size_t cell = BHTD ? (size_t)b * gridDim.y + h : (size_t)b;
  const int col0 = BHTD ? 0 : h * HD;
  const T* qb = q + (cell * Tq + q0) * ldq + col0;
  const T* kb = k + cell * S * ldkv + col0;
  const T* vb = v + cell * S * ldkv + col0;
  const float* pad_row = pad != nullptr ? pad + (size_t)b * S : nullptr;
  const float scale = LAYER ? SCALE2 : SCALE;

  load_tile(qs, qb, BQ, min(BQ, Tq - q0), ldq);

  float s[4][4];

  // Pass 1: exact row max over every key tile (BHTD: and the row sum).
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile(kvs, kb + (size_t)k0 * ldkv, BK, min(BK, S - k0), ldkv);
    __syncthreads();
    tile_scores(s, qs, kvs, q0, k0, S, pad_row, causal, tx, ty, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) mt = fmaxf(mt, s[i][j]);
      // this thread's columns so far may all lie past S: then mt is -inf
      if (BHTD && mt > -INFINITY) {
        float sum = l[i] * expf(m[i] - mt);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - mt);
        l[i] = sum;
      }
      m[i] = mt;
    }
  }
  // the 16 lanes that share a row are one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mine = m[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    if (BHTD) {
      l[i] *= expf(mine - m[i]);     // 0 * exp(-inf) = 0 for an empty lane
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    }
  }

  // Pass 2: p = exp(s - max), its row sum, and P.V (BHTD: p / rowsum, P.V).
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile(kvs, kb + (size_t)k0 * ldkv, BK, min(BK, S - k0), ldkv);
    __syncthreads();
    tile_scores(s, qs, kvs, q0, k0, S, pad_row, causal, tx, ty, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = LAYER ? exp2f(s[i][j] - m[i]) : expf(s[i][j] - m[i]);
        if (BHTD) p = __fdiv_rn(p, l[i]);
        else l[i] += p;
        ps[(ty + 8 * i) * PLD + tx + 16 * j] = round_like(p, v);
      }
    __syncthreads();
    load_tile(kvs, vb + (size_t)k0 * ldkv, BK, min(BK, S - k0), ldkv);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 8 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = kvs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }
  if (!BHTD) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }

  OutT* ob = out + (cell * Tq + q0) * D + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= Tq) continue;
    const float inv = LAYER ? __fdiv_rn(1.f, l[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(ob + (size_t)r * D + tx + 16 * j,
            BHTD ? o[i][j]
                 : LAYER ? __fmul_rn(o[i][j], inv) : o[i][j] / l[i]);
  }
}

// ----------------------------------------------------------------------
// f32 on the CUDA cores (see the head of this file)
// ----------------------------------------------------------------------
constexpr int FN = 64;            // keys a tile
constexpr int FTHREADS = 128;     // 16 row groups (ty) x 8 column groups (tx)

// Padded head widths HDP (64, or 80 to 128 by 16): query rows a thread
// owns, the block's rows (4 warps of 4 * rows), the row stride of q, k and
// v in shared memory (16-byte aligned, 4 banks on) and the shared memory
// of a block (100 KB at 64, 79 to 115 KB past it: two blocks an SM up to
// HDP 112, one at 128)
#define MIT_HD __host__ __device__ constexpr
MIT_HD int f32_row_tiles(int hdp) { return hdp == 64 ? 8 : 4; }
MIT_HD int f32_rows(int hdp) { return 16 * f32_row_tiles(hdp); }
MIT_HD int f32_ld(int hdp) { return hdp + 4; }
MIT_HD int f32_smem(int hdp) {
  return (f32_rows(hdp) * f32_ld(hdp) + 2 * FN * f32_ld(hdp) +
          f32_rows(hdp) * FN) * (int)sizeof(float);
}

// rows [0, nrows) x HDP f32 of a matrix with row stride `ld` into dst (row
// stride FLD), 16 bytes a thread; rows past `valid` (>= 1) and columns past
// `hd` are zero
template <int HDP>
__device__ __forceinline__ void load_f32_rows_async(float* dst,
                                                    const float* src,
                                                    int nrows, int valid,
                                                    int ld, int hd) {
  constexpr int FLD = f32_ld(HDP);
  if constexpr (HDP == HD) {
    for (int i = threadIdx.x; i < nrows * (HD / 4); i += FTHREADS) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = r < valid;
      cp_async16(dst + r * FLD + c, src + (size_t)(ok ? r : 0) * ld + c, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * (HDP / 4); i += FTHREADS) {
      const int r = i / (HDP / 4), c = (i % (HDP / 4)) * 4;
      const bool ok = r < valid && c < hd;
      cp_async16(dst + r * FLD + c,
                 src + (size_t)(ok ? r : 0) * ld + (ok ? c : 0), ok);
    }
  }
}

// q rows have stride ldq, k and v rows stride ldkv, out rows stride D (the
// model width); head h is columns h*hd .. h*hd+hd-1 of each. With bhtd the
// tensors are (B, H, T|S, hd): ldq = ldkv = D = hd and head h of batch b
// starts (b*H + h) * (Tq or S) rows in. HDP is hd rounded up to 16 (64
// itself at 64); the columns from hd to HDP are zero in shared memory.
//
// Thread (ty, tx) owns RI query rows of the block, rbase + 4 i with rbase =
// 4 RI (ty / 4) + ty % 4; of a score tile the keys tx + 8 j, and of the
// output the 4-column groups tx + 8 c (columns 4 tx + 32 c onwards; at 64,
// 4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3). The 8 lanes that share
// ty are neighbours in one warp, a warp owns 4 RI rows, and the 4 row
// groups of a warp read neighbouring rows, in different banks. RI is 8 at
// HDP 64 and 4 past it (64 query rows a block): at 8 the output's 8 x
// HDP/8 accumulators spilled at HDP 80 and 96 (140 bytes a thread at 255
// registers, ptxas on the H100's toolkit).
template <int HDP>
__global__ void __launch_bounds__(FTHREADS, 2)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ pad,
                           float* __restrict__ out, int Tq, int S, int D,
                           int ldq, int ldkv, bool causal, bool bhtd,
                           int hd_arg, float scale_arg) {
  constexpr int RI = f32_row_tiles(HDP);
  constexpr int FM = f32_rows(HDP);
  constexpr int FLD = f32_ld(HDP);
  constexpr int NC = (HDP + 31) / 32;   // a thread's 4-column output groups / 8
  const int hd = HDP == HD ? HD : hd_arg;
  const float scale = HDP == HD ? SCALE : scale_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // FM x FLD
  float* ks = qs + FM * FLD;                        // FN x FLD
  float* vs = ks + FN * FLD;                        // FN x FLD
  float* ps = vs + FN * FLD;                        // FM x FN, swizzled

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int q0 = blockIdx.x * FM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(FM, Tq - q0);
  // a warp owns 4 RI rows; one with no row below Tq only loads and waits
  const bool active = (threadIdx.x >> 5) * 4 * RI < nq;
  // a row of P is written and read by the 8 lanes that share ty; its
  // 8-column groups are XORed by ty mod 4 (the row mod 4), so the 4 row
  // groups of a warp store to 4 different bank groups
  const int sw = (ty & 3) << 3;
  // this thread's RI rows: rbase + 4 i, inside its warp's 4 RI
  const int rbase = (ty >> 2) * 4 * RI + (ty & 3);

  const size_t cell = bhtd ? (size_t)b * gridDim.y + h : (size_t)b;
  const int col0 = bhtd ? 0 : h * hd;
  const float* qb = q + (cell * Tq + q0) * ldq + col0;
  const float* kb = k + cell * S * ldkv + col0;
  const float* vb = v + cell * S * ldkv + col0;
  const float* pad_row = pad != nullptr ? pad + (size_t)b * S : nullptr;

  const int nkt = (S + FN - 1) / FN;
  // whole 8-key groups: the scores skip the groups past S, P.V the 4-key
  // steps past S, and what they read beyond S is zero
  auto tile_rows = [&](int kt) { return (min(FN, S - kt * FN) + 7) & ~7; };

  load_f32_rows_async<HDP>(qs, qb, FM, nq, ldq, hd);
  load_f32_rows_async<HDP>(ks, kb, tile_rows(0), min(FN, S), ldkv, hd);
  cp_async_commit();

  float o[RI][4 * NC];            // unnormalized output
  float m[RI], l[RI];   // running row max; this lane's share of the sum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * FN;
    const int valid = min(FN, S - k0);
    // V comes in under the scores; every warp left the last tile's P.V at
    // the barrier that ended it
    load_f32_rows_async<HDP>(vs, vb + (size_t)k0 * ldkv, tile_rows(kt),
                             valid, ldkv, hd);
    cp_async_commit();
    cp_async_wait<1>();           // this tile's K (and, the first time, Q)
    __syncthreads();

    // One key tile for this thread. FULL: all 64 keys are below S, and the
    // code is compiled without the tests for that.
    auto scores = [&](auto full_tile) {
      constexpr bool FULL = decltype(full_tile)::value;
      const int nj = FULL ? 8 : (valid + 7) >> 3;     // 8-key groups in use
      float s[RI][8];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      const float* qrow = qs + rbase * FLD;
#pragma unroll 2
      for (int d = 0; d < HDP; d += 4) {
        float4 qv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * FLD + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!FULL && j >= nj) continue;
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * FLD + d);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }

      // scale and masks in the reference's order; keys past S at -inf
      float padv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        padv[j] = pad_row != nullptr && (FULL || col < S)
                      ? __ldg(pad_row + col) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = q0 + rbase + 4 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = k0 + tx + 8 * j;
          float x = s[i][j] * scale;
          if (causal) x += col <= row ? 0.f : NEG_INF;
          if (pad_row != nullptr) x += padv[j];
          if (!FULL && col >= S) x = -INFINITY;
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        // online softmax: the tile's first key is below S, so the new max
        // is finite, and exp(-inf) = 0 covers the first tile
#pragma unroll
        for (int off = 1; off <= 4; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[i], mx);
        const float a = ex2((m[i] - mn) * LOG2E);
        m[i] = mn;
        l[i] *= a;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) o[i][c] *= a;
        // the difference first: at a masked row's -1e9 a fused
        // x log2 e - max log2 e would leave a rounding, not 0
        float* prow = ps + (rbase + 4 * i) * FN;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = ex2((s[i][j] - mn) * LOG2E);
          l[i] += p;
          prow[(tx + 8 * j) ^ sw] = p;
        }
      }
    };
    if (active) {
      if (valid == FN) scores(std::true_type{});
      else scores(std::false_type{});
    }

    cp_async_wait<0>();           // this tile's V
    __syncthreads();              // and every warp is done with its K
    if (kt + 1 < nkt) {           // the next K comes in under P.V
      load_f32_rows_async<HDP>(ks, kb + (size_t)(k0 + FN) * ldkv,
                               tile_rows(kt + 1), min(FN, S - k0 - FN), ldkv,
                               hd);
    }
    cp_async_commit();

    if (active) {
      const int steps = (valid + 3) >> 2;             // 4-key steps in use
      const float* prow = ps + rbase * FN;
#pragma unroll 2
      for (int j4 = 0; j4 < steps; ++j4) {
        float4 pv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          pv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * FN +
                                                   ((4 * j4) ^ sw));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // a group past HDP (the last one's upper lanes at HDP 80 and
          // 112) reads the next row or P's first: never stored
          const float* vr = vs + (4 * j4 + jj) * FLD + 4 * tx;
          float4 vv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            vv[c] = *reinterpret_cast<const float4*>(vr + 32 * c);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float p = jj == 0 ? pv[i].x
                          : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              o[i][4 * c + 0] = fmaf(p, vv[c].x, o[i][4 * c + 0]);
              o[i][4 * c + 1] = fmaf(p, vv[c].y, o[i][4 * c + 1]);
              o[i][4 * c + 2] = fmaf(p, vv[c].z, o[i][4 * c + 2]);
              o[i][4 * c + 3] = fmaf(p, vv[c].w, o[i][4 * c + 3]);
            }
          }
        }
      }
    }
    __syncthreads();              // every warp is done with this V
  }
  if (!active) return;

  float* ob = out + (cell * Tq + q0) * D + col0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = rbase + 4 * i;
    if (r >= nq) continue;
    float* orow = ob + (size_t)r * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      // columns 4 (tx + 8 c) .. + 3: below hd, a multiple of 8, or not at all
      if (HDP != HD && 4 * tx + 32 * c >= hd) continue;
      *reinterpret_cast<float4*>(orow + 32 * c) = make_float4(
          o[i][4 * c] / l[i], o[i][4 * c + 1] / l[i], o[i][4 * c + 2] / l[i],
          o[i][4 * c + 3] / l[i]);
    }
  }
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores (see the head of this file)
// ----------------------------------------------------------------------
constexpr int BN = 64;            // keys per tile
constexpr int WGR = 64;           // query rows a warpgroup
// a row whose running max is below this has seen only masked keys so far
constexpr float ROW_MASKED = -5e8f;
// the softmax's three forms (see the head of this file)
constexpr int ONLINE_MODE = 0, LAYER_MODE = 1, NORM_MODE = 2;

// The padded head width HDP (64, or 80 to 128 by 16) sets the tiles: a Q,
// K or V tile is NP = HDP / 64 rounded up panels of 64 columns (TILE
// elements each, 1024-byte aligned). At 64, three stages of K and V and 3
// (4 warps) or 2 (8 warps) blocks an SM; past it the ring has two stages,
// so that two blocks of 8 warps fit an SM (96 KB each) as they do at 64.
MIT_HD int tc_panels(int hdp) { return (hdp + 63) / 64; }
MIT_HD int tc_stages(int hdp) { return hdp == HD ? 3 : 2; }
MIT_HD int tc_min_blocks(int nw, int hdp) {
  return hdp == HD ? (nw == 4 ? 3 : 2) : (nw == 4 || hdp <= 96 ? 2 : 1);
}

// rows [0, nrows) x HDP columns of a bf16 matrix with row stride `ld` into
// wide tiles at dst: row r to tile r / 64 (NP panels apart), column c to
// panel c / 64. Rows past `valid` (>= 1) and columns past `hd` (a multiple
// of 8, so a 16-byte chunk is all in or all out) are zero.
template <int HDP>
__device__ __forceinline__ void load_wide_rows_async(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src,
                                                     int nrows, int valid,
                                                     int ld, int hd) {
  if constexpr (HDP == HD) {
    load_rows_async(dst, src, nrows, valid, ld);
  } else {
    constexpr int CH = HDP / 8;             // 16-byte chunks a row
    constexpr int WT = tc_panels(HDP) * TILE;
    for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r < valid && c < hd;
      cp_async16(dst + (r >> 6) * WT + (c >> 6) * TILE +
                     tile_at(r & 63, c & 63),
                 src + (size_t)(ok ? r : 0) * ld + (ok ? c : 0), ok);
    }
  }
}

// P.V for 16 keys: o (HDP columns) += p . v, one wgmma a panel of the V
// tile at descriptor dv (panels 512 descriptor units apart)
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 8][4],
                                         const unsigned (&a)[4],
                                         unsigned long long dv) {
  if constexpr (HDP == HD) {
    wgmma_rs_bt(o, a, dv);
  } else {
    wgmma_rs_bt_at<8, 0>(o, a, dv);
    wgmma_rs_bt_at<HDP / 8 - 8, 8>(o, a, dv + TILE * 2 / 16);
  }
}

// A block of NW warps, NW / 4 warpgroups, owns `rows` query rows of one
// (batch, head), a multiple of 64 and at most 16 * NW; warpgroup w owns
// rows 64w onwards and warp i of it rows 16i of those. Strides as in
// flash_attention_f32_kernel. Dynamic shared memory, from the first 1024
// bytes boundary (the swizzle is a function of the address): the query
// tiles, then tc_stages(HDP) stages of a K tile and a V tile. hd (HDP at
// 64) sets the columns loaded and stored and `scale`, 1/sqrt(hd) (LAYER:
// log2(e)/sqrt(hd)), computed by the launcher as the plain versions do.
//
// LAYER_MODE (the whole-layer numerics; never causal or padded) and
// NORM_MODE (the (B, H, T, hd) numerics) walk the key tiles twice, first
// over the K tiles alone: LAYER for the exact row max of the raw scores,
// NORM for the row max and the row sum of the masked ones. ONLINE_MODE
// walks once, with an online softmax.

template <int NW, int MODE, int HDP>
__global__ void __launch_bounds__(NW * 32, tc_min_blocks(NW, HDP))
flash_attention_btd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ pad,
                              typename std::conditional<MODE == LAYER_MODE,
                                                        float,
                                                        __nv_bfloat16>::type*
                                  __restrict__ out,
                              int Tq, int S, int D, int ldq, int ldkv,
                              int rows, bool causal, bool bhtd, int hd_arg,
                              float scale_arg) {
  constexpr bool LAYER = MODE == LAYER_MODE;
  constexpr bool NORM = MODE == NORM_MODE;
  constexpr int WT = tc_panels(HDP) * TILE;   // elements of a wide tile
  constexpr int STAGES = tc_stages(HDP);
  constexpr int AHEAD = STAGES - 1;           // tiles loaded ahead: 2 or 1
  constexpr int ONT = HDP / 8;                // 8-column tiles of the output
  const int hd = HDP == HD ? HD : hd_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - smem_u32(smem_raw)) & 1023));
  __nv_bfloat16* kvs = qs + (NW / 4) * WT;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;          // row of the fragment
  const int t4 = lane & 3;          // column pair of the fragment
  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  // (B, T, D): head h is a column block of batch cell b; (B, H, T, hd):
  // head h of batch b is cell b*H + h, with rows of hd
  const size_t cell = bhtd ? (size_t)b * gridDim.y + h : (size_t)b;
  const int col0 = bhtd ? 0 : h * hd;
  const __nv_bfloat16* qb = q + (cell * Tq + q0) * ldq + col0;
  const __nv_bfloat16* kb = k + cell * S * ldkv + col0;
  const __nv_bfloat16* vb = v + cell * S * ldkv + col0;
  const float* pad_row = pad != nullptr ? pad + (size_t)b * S : nullptr;
  const float scale = HDP == HD ? (LAYER ? SCALE2 : SCALE) : scale_arg;

  // a warpgroup multiplies as one: its warps past Tq go along, on zero rows
  const int grow = (warp >> 2) * WGR;               // its first row here
  const bool active = grow < rows && q0 + grow < Tq;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;   // this thread's

  const int nkt = (S + BN - 1) / BN;
  // causal: the key tiles that reach below the diagonal of this block
  int kt_end = causal ? min(nkt, (min(q0 + rows, Tq) - 1) / BN + 1) : nkt;
  // the steps before first_pv are the first walk of LAYER (the max) and
  // NORM (the max and the sum), over the K tiles alone
  int first_pv = MODE == ONLINE_MODE ? 0 : kt_end;

  auto load_kv = [&](int step, int stage) {
    const int k0 = (step >= first_pv ? step - first_pv : step) * BN;
    const int valid = min(BN, S - k0);
    const int nrows = ((valid + 15) >> 4) << 4;     // whole 16-key steps
    __nv_bfloat16* ks = kvs + stage * 2 * WT;
    load_wide_rows_async<HDP>(ks, kb + (size_t)k0 * ldkv, nrows, valid, ldkv,
                              hd);
    if (step >= first_pv)
      load_wide_rows_async<HDP>(ks + WT, vb + (size_t)k0 * ldkv, nrows, valid,
                                ldkv, hd);
    cp_async_commit();
  };

  load_wide_rows_async<HDP>(qs, qb, rows, Tq - q0, ldq, hd);
  load_kv(0, 0);
  if constexpr (AHEAD == 2) {
    if (1 < first_pv + kt_end) load_kv(1, 1);
    else cp_async_commit();
  }

  float o[ONT][4];                  // this warp's 16 x HDP output, unnormalized
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // row max (rows g, g + 8)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the row sum
  float inv0 = 1.f, inv1 = 1.f;           // NORM: 1 / row sum, second walk
  // a row of this thread that exists and has seen only masked keys so far
  auto row_masked = [&]() {
    return active && ((m0 <= ROW_MASKED && row0 < Tq) ||
                      (m1 <= ROW_MASKED && row1 < Tq));
  };

  // STAGES stages, AHEAD tiles ahead: a tile is waited for, then one
  // barrier (every warp is done with the tile before it, whose stage the
  // load started next refills), then the load of the tile AHEAD on. A step
  // that has nothing to load commits an empty group, so the count holds.
  for (int step = 0; step < first_pv + kt_end; ++step) {
    const int stage = step % STAGES;
    cp_async_wait<AHEAD - 1>();
    // cp.async wrote the tile; wgmma reads it through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (step + AHEAD < first_pv + kt_end)
      load_kv(step + AHEAD, (step + AHEAD) % STAGES);
    else cp_async_commit();

    if (LAYER && step == first_pv) {
      // the max of the raw scores is in hand: a row's columns lie in the 4
      // lanes of a quad; scaling is monotonic, so it commutes with the max
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      m0 *= scale;
      m1 *= scale;
    }
    if (NORM && step == first_pv) {
      // the max and the sum are in hand (the max is the quad's already)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      inv0 = __fdiv_rn(1.f, l0);
      inv1 = __fdiv_rn(1.f, l1);
    }

    const bool pv = step >= first_pv;
    const int k0 = (pv ? step - first_pv : step) * BN;
    // One key tile for this warp. FULL: all 64 keys are below S, and the
    // tile's code is compiled without the tests for that: a predicate, even
    // a uniform one, between two wgmma makes the compiler serialize them,
    // and one in the softmax's loops keeps it from overlapping the exps.
    auto tile = [&](auto full_tile) {
      constexpr bool FULL = decltype(full_tile)::value;
      const int valid = FULL ? BN : S - k0;
      const int steps = FULL ? 4 : (valid + 15) >> 4;   // 16-key steps in use
      const __nv_bfloat16* ks = kvs + stage * 2 * WT;

      // scores: HDP / 16 k-steps (four a panel; a panel is 512 descriptor
      // units on) of the warpgroup's 64 query rows by the tile's 64 keys
      // (those past S are masked below, whatever lies there)
      float s[8][4];
      const unsigned long long dq = wg_desc(qs + (warp >> 2) * WT);
      const unsigned long long dk = wg_desc(ks);
      wg_fence();
#pragma unroll
      for (int ks4 = 0; ks4 < HDP / 16; ++ks4)
        wgmma_ss(s, dq + 512 * (ks4 >> 2) + 2 * (ks4 & 3),
                 dk + 512 * (ks4 >> 2) + 2 * (ks4 & 3), ks4 > 0);
      wg_commit_wait(s);

      if (LAYER && !pv) {
        // first walk: the max of the raw scores over the keys below S
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (FULL || k0 + nt * 8 + 2 * t4 + e < S) {
              m0 = fmaxf(m0, s[nt][e]);
              m1 = fmaxf(m1, s[nt][2 + e]);
            }
        return;
      }
      // scale and masks, as the CUDA-core kernel applies them. Most tiles
      // have none: all keys below S, below the block's diagonal and
      // unpadded (the three tests are uniform over the warp)
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool diagonal = causal && k0 + BN - 1 > q0 + warp * 16;
      if (FULL && !diagonal && pad_row == nullptr) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nt][e] *= scale;
            s[nt][2 + e] *= scale;
            mx0 = fmaxf(mx0, s[nt][e]);
            mx1 = fmaxf(mx1, s[nt][2 + e]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          if (FULL || nt < 2 * steps)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + nt * 8 + 2 * t4 + e;
              float x0 = s[nt][e] * scale, x1 = s[nt][2 + e] * scale;
              if (causal) {
                x0 += col <= row0 ? 0.f : NEG_INF;
                x1 += col <= row1 ? 0.f : NEG_INF;
              }
              if (pad_row != nullptr && (FULL || col < S)) {
                const float p = __ldg(pad_row + col);
                x0 += p;
                x1 += p;
              }
              if (!FULL && col >= S) x0 = x1 = -INFINITY;
              s[nt][e] = x0;
              s[nt][2 + e] = x1;
              mx0 = fmaxf(mx0, x0);
              mx1 = fmaxf(mx1, x1);
            }
      }
      float mn0 = m0, mn1 = m1;
      if (MODE == ONLINE_MODE || (NORM && !pv)) {
        // online softmax: the first key of a tile is below S, so the new
        // max is finite; exp(-inf) = 0 covers the first tile. A row's
        // columns lie in the 4 lanes of a quad.
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        mn0 = fmaxf(m0, mx0);
        mn1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - mn0) * LOG2E);
        const float a1 = ex2((m1 - mn1) * LOG2E);
        m0 = mn0;
        m1 = mn1;
        l0 *= a0;
        l1 *= a1;
        if (!NORM) {
#pragma unroll
          for (int nt = 0; nt < ONT; ++nt) {
            o[nt][0] *= a0;
            o[nt][1] *= a0;
            o[nt][2] *= a1;
            o[nt][3] *= a1;
          }
        }
      }
      if (NORM && !pv) {
        // first walk: the row sum against the running max, no product
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (!FULL && nt >= 2 * steps) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            l0 += ex2((s[nt][e] - mn0) * LOG2E);
            l1 += ex2((s[nt][2 + e] - mn1) * LOG2E);
          }
        }
        return;
      }
      // p = exp(x - max) as 2^((x - max) log2 e). The difference comes
      // first: at a masked row's -1e9 a fused x log2 e - max log2 e would
      // leave the rounding of the second product, not 0. LAYER's scores
      // are in log2 units already, and its p must be the reference's
      // exp2(x - max) to the bit. Keys past S within a step are at -inf,
      // p = 0; the steps past them are left out here and in P.V.
      unsigned pf[4][4];          // p in bf16, as the A operand of P.V
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (!FULL && nt >= 2 * steps) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float d0 = s[nt][e] - mn0, d1 = s[nt][2 + e] - mn1;
          if (!LAYER) {
            d0 *= LOG2E;
            d1 *= LOG2E;
          }
          s[nt][e] = ex2(d0);
          s[nt][2 + e] = ex2(d1);
          if (NORM) {
            // normalized before it is rounded, as the (B, H, T, hd)
            // reference has it
            s[nt][e] *= inv0;
            s[nt][2 + e] *= inv1;
          } else {
            l0 += s[nt][e];
            l1 += s[nt][2 + e];
          }
        }
        // accumulator tiles 2kk, 2kk+1 are the A fragment of k-step kk
        pf[nt >> 1][(nt & 1) * 2] = pack_bf16(s[nt][0], s[nt][1]);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      }

      // P.V: p from registers, 16 keys (rows of the V tile) a step, and
      // only the steps with a key below S (the rows up to the end of the
      // last such step are zero-filled, the rest never loaded)
      const unsigned long long dv = wg_desc(ks + WT);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (FULL || kk < steps) wgmma_pv<HDP>(o, pf[kk], dv + 128 * kk);
      // (letting this run on under the next tile's scores, with a fourth
      // stage to keep the V tile alive, gained nothing when timed)
      wg_commit_wait(o);
    };
    if (active) {
      if (S - k0 >= BN) tile(std::true_type{});
      else tile(std::false_type{});
    }

    // Causal: a tile wholly above the block's diagonal adds exp(-1e9 - m)
    // = 0 to every row whose max is a visible key's, so the walk ends at
    // the diagonal. A row that has seen only masked keys shares its max
    // with the masked keys above the diagonal that are not padded, and the
    // reference spreads it over those too: if the block has such a row it
    // walks on to the last tile. Rare, so those tiles were not prefetched.
    // NORM votes at the end of its first walk and lengthens both walks;
    // the first tiles of the second walk were prefetched, so they land
    // before their stages are loaded anew.
    if (step + 1 == (NORM ? first_pv : kt_end) &&
        kt_end < nkt) {                             // causal, so not LAYER
      if (NORM) cp_async_wait<0>();
      if (__syncthreads_or(row_masked())) {
        kt_end = nkt;
        if (NORM) first_pv = nkt;
        load_kv(step + 1, (step + 1) % STAGES);
        if constexpr (AHEAD == 2) {
          if (step + 2 < first_pv + kt_end)
            load_kv(step + 2, (step + 2) % STAGES);
          else cp_async_commit();
        }
      }
    }
  }
  if (!active) return;

  if (!NORM) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }
  // NORM's probabilities were normalized before the product
  const float i0 = NORM ? 1.f : __fdiv_rn(1.f, l0);
  const float i1 = NORM ? 1.f : __fdiv_rn(1.f, l1);
  if (LAYER) {
    // f32 out, o * (1 / l) as the layer kernel has it: a quad writes 32
    // contiguous bytes of a row
    float* ob = reinterpret_cast<float*>(out) + cell * Tq * D + col0;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (HDP != HD && nt * 8 >= hd) continue;
      if (row0 < Tq)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * D + col) =
            make_float2(__fmul_rn(o[nt][0], i0), __fmul_rn(o[nt][1], i0));
      if (row1 < Tq)
        *reinterpret_cast<float2*>(ob + (size_t)row1 * D + col) =
            make_float2(__fmul_rn(o[nt][2], i1), __fmul_rn(o[nt][3], i1));
    }
  } else if constexpr (HDP == HD) {
    // bf16 out: into the warp's own (spent) query rows in shared memory and
    // from there 16 bytes a lane, four rows a store. o * (1 / l) for o / l:
    // one division a row, and the difference (an f32 rounding) vanishes in
    // the rounding to bf16
    __nv_bfloat16* mine = qs + warp * 16 * HD;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(mine + tile_at(g, col)) =
          pack_bf16(o[nt][0] * i0, o[nt][1] * i0);
      *reinterpret_cast<unsigned*>(mine + tile_at(g + 8, col)) =
          pack_bf16(o[nt][2] * i1, o[nt][3] * i1);
    }
    __syncwarp();
    __nv_bfloat16* ob =
        reinterpret_cast<__nv_bfloat16*>(out) + cell * Tq * D + col0;
    const int wrow = q0 + warp * 16;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + (lane >> 3), c = (lane & 7) * 8;
      if (wrow + r < Tq)
        *reinterpret_cast<uint4*>(ob + (size_t)(wrow + r) * D + c) =
            *reinterpret_cast<const uint4*>(mine + tile_at(r, c));
    }
  } else {
    // the same for HDP columns: the warp's 16 rows of each panel, then
    // HDP / 8 chunks of 16 bytes a row, those below hd stored
    __nv_bfloat16* mine = qs + (warp >> 2) * WT + (warp & 3) * 16 * HD;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      const int col = (nt & 7) * 8 + 2 * t4;
      __nv_bfloat16* panel = mine + (nt >> 3) * TILE;
      *reinterpret_cast<unsigned*>(panel + tile_at(g, col)) =
          pack_bf16(o[nt][0] * i0, o[nt][1] * i0);
      *reinterpret_cast<unsigned*>(panel + tile_at(g + 8, col)) =
          pack_bf16(o[nt][2] * i1, o[nt][3] * i1);
    }
    __syncwarp();
    __nv_bfloat16* ob =
        reinterpret_cast<__nv_bfloat16*>(out) + cell * Tq * D + col0;
    const int wrow = q0 + warp * 16;
    constexpr int CH = HDP / 8;
#pragma unroll
    for (int it = 0; it < HDP / 16; ++it) {       // 16 rows x CH chunks
      const int i = it * 32 + lane;
      const int r = i / CH, c = (i % CH) * 8;
      if (wrow + r < Tq && c < hd)
        *reinterpret_cast<uint4*>(ob + (size_t)(wrow + r) * D + c) =
            *reinterpret_cast<const uint4*>(mine + (c >> 6) * TILE +
                                            tile_at(r, c & 63));
    }
  }
}

// the padded head width of hd: 64 itself, 65..128 in multiples of 8 up to
// a multiple of 16; 0 where the tiled kernels take no such heads
int padded_head_dim(int hd) {
  if (hd == HD) return HD;
  if (hd > HD && hd <= 2 * HD && hd % 8 == 0) return (hd + 15) / 16 * 16;
  return 0;
}

template <int NW, int MODE, int HDP>
int launch_tc(const void* q, const void* k, const void* v, const void* pad,
              void* out, int B, int heads, int Tq, int S, int D, int ldq,
              int ldkv, int rows, int causal, int has_pad, int bhtd, int hd,
              void* stream) {
  using OutT = typename std::conditional<MODE == LAYER_MODE, float,
                                         __nv_bfloat16>::type;
  if (rows < WGR || rows % WGR || rows > NW * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // the tiles, and the room to start them at 1024 bytes
  const int smem = (NW / 4 + 2 * tc_stages(HDP)) * tc_panels(HDP) * TILE *
                       (int)sizeof(__nv_bfloat16) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_btd_tc_kernel<NW, MODE, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = (float)((MODE == LAYER_MODE ? 1.4426950408889634 : 1.0) /
                              sqrt((double)hd));
  const dim3 grid((Tq + rows - 1) / rows, heads, B);
  flash_attention_btd_tc_kernel<NW, MODE, HDP>
      <<<grid, NW * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          has_pad ? static_cast<const float*>(pad) : nullptr,
          static_cast<OutT*>(out), Tq, S, D, ldq, ldkv, rows, causal != 0,
          bhtd != 0, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int HDP>
int launch_tc_warps(int warps, const void* q, const void* k, const void* v,
                    const void* pad, void* out, int B, int heads, int Tq,
                    int S, int D, int ldq, int ldkv, int rows, int causal,
                    int has_pad, int bhtd, int hd, void* stream) {
  if (warps == 4)
    return launch_tc<4, MODE, HDP>(q, k, v, pad, out, B, heads, Tq, S, D, ldq,
                                   ldkv, rows, causal, has_pad, bhtd, hd,
                                   stream);
  if (warps == 8)
    return launch_tc<8, MODE, HDP>(q, k, v, pad, out, B, heads, Tq, S, D, ldq,
                                   ldkv, rows, causal, has_pad, bhtd, hd,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// `warps` warps a block, 4 or 8 (one warpgroup or two), each block `rows`
// query rows; heads of hd columns (padded_head_dim picks the instantiation)
template <int MODE>
int launch_tc_tiled(int warps, const void* q, const void* k, const void* v,
                    const void* pad, void* out, int B, int heads, int Tq,
                    int S, int D, int ldq, int ldkv, int rows, int causal,
                    int has_pad, int bhtd, int hd, void* stream) {
  if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || Tq < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MIT_TC_CASE(HDP)                                                     \
  case HDP:                                                                  \
    return launch_tc_warps<MODE, HDP>(warps, q, k, v, pad, out, B, heads, Tq, \
                                      S, D, ldq, ldkv, rows, causal, has_pad, \
                                      bhtd, hd, stream);
  switch (padded_head_dim(hd)) {
    MIT_TC_CASE(64)
    MIT_TC_CASE(80)
    MIT_TC_CASE(96)
    MIT_TC_CASE(112)
    MIT_TC_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MIT_TC_CASE
}

template <int HDP>
int launch_f32_at(const void* q, const void* k, const void* v,
                  const void* pad, void* out, int B, int heads, int Tq, int S,
                  int D, int ldq, int ldkv, int causal, int has_pad, int bhtd,
                  int hd, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_f32_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem(HDP));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = (float)(1.0 / sqrt((double)hd));
  const dim3 grid((Tq + f32_rows(HDP) - 1) / f32_rows(HDP), heads, B);
  flash_attention_f32_kernel<HDP>
      <<<grid, FTHREADS, f32_smem(HDP), (cudaStream_t)stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v),
          has_pad ? static_cast<const float*>(pad) : nullptr,
          static_cast<float*>(out), Tq, S, D, ldq, ldkv, causal != 0,
          bhtd != 0, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const void* pad,
               void* out, int B, int heads, int Tq, int S, int D, int ldq,
               int ldkv, int causal, int has_pad, int bhtd, int hd,
               void* stream) {
  if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || Tq < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MIT_F32_CASE(HDP)                                                  \
  case HDP:                                                                \
    return launch_f32_at<HDP>(q, k, v, pad, out, B, heads, Tq, S, D, ldq,  \
                              ldkv, causal, has_pad, bhtd, hd, stream);
  switch (padded_head_dim(hd)) {
    MIT_F32_CASE(64)
    MIT_F32_CASE(80)
    MIT_F32_CASE(96)
    MIT_F32_CASE(112)
    MIT_F32_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MIT_F32_CASE
}

// the first CUDA-core kernel, for the measuring entries
template <typename T, typename OutT = T, bool LAYER = false,
          bool BHTD = false>
int launch_v1(const void* q, const void* k, const void* v, const void* pad,
              void* out, int B, int Tq, int S, int D, int ldq, int ldkv,
              int causal, int has_pad, void* stream, int heads = 0) {
  const dim3 grid((Tq + BQ - 1) / BQ, BHTD ? heads : D / HD, B);
  flash_attention_btd_kernel<T, OutT, LAYER, BHTD>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v),
          has_pad ? static_cast<const float*>(pad) : nullptr,
          static_cast<OutT*>(out), Tq, S, D, ldq, ldkv, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry below takes heads of hd columns: 64, or 72 to 128 in
// multiples of 8 (padded_head_dim); any other hd returns
// cudaErrorInvalidValue.
//
// q, out: (B, Tq, D); k, v: (B, S, D), all contiguous f32 at 16-byte
// boundaries; pad: (B, S) f32, read only when has_pad. D must be a multiple
// of hd.
extern "C" int mit_flash_attention_btd_f32(const void* q, const void* k,
                                           const void* v, const void* pad,
                                           void* out, int B, int Tq, int S,
                                           int D, int hd, int causal,
                                           int has_pad, void* stream) {
  if (hd < 1 || D % hd) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(q, k, v, pad, out, B, D / hd, Tq, S, D, D, D, causal,
                    has_pad, 0, hd, stream);
}

// bf16: the tensor-core kernel. A block has `warps` warps, 4 or 8 (one
// warpgroup or two), and owns `rows` query rows, 64 a warpgroup.
extern "C" int mit_flash_attention_btd_bf16(const void* q, const void* k,
                                            const void* v, const void* pad,
                                            void* out, int B, int Tq, int S,
                                            int D, int hd, int causal,
                                            int has_pad, int warps, int rows,
                                            void* stream) {
  if (hd < 1 || D % hd) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc_tiled<ONLINE_MODE>(warps, q, k, v, pad, out, B, D / hd, Tq,
                                      S, D, D, D, rows, causal, has_pad, 0,
                                      hd, stream);
}

// qkv: (B, T, 3D) contiguous; out: (B, T, D). mode 0: f32 in and out (the
// f32 kernel); mode 1: bf16 in and out; mode 2: bf16 in, f32 out, the
// whole-layer kernel's numerics (exp2, o * (1 / rowsum)). Modes 1 and 2 run
// the tensor-core kernel with `warps` and `rows` as above. D must be a
// multiple of hd.
extern "C" int mit_flash_attention_fusedqkv(const void* qkv, void* out, int B,
                                            int T, int D, int hd, int mode,
                                            int warps, int rows,
                                            void* stream) {
  if (hd < 1 || D % hd) return static_cast<int>(cudaErrorInvalidValue);
  // q, k and v are the column blocks 0, D, 2D of qkv, with row stride 3D
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const float* q32 = static_cast<const float*>(qkv);
  switch (mode) {
    case 0:
      return launch_f32(q32, q32 + D, q32 + 2 * D, nullptr, out, B, D / hd, T,
                        T, D, 3 * D, 3 * D, 0, 0, 0, hd, stream);
    case 1:
      return launch_tc_tiled<ONLINE_MODE>(warps, q, q + D, q + 2 * D, nullptr,
                                          out, B, D / hd, T, T, D, 3 * D,
                                          3 * D, rows, 0, 0, 0, hd, stream);
    case 2:
      return launch_tc_tiled<LAYER_MODE>(warps, q, q + D, q + 2 * D, nullptr,
                                         out, B, D / hd, T, T, D, 3 * D, 3 * D,
                                         rows, 0, 0, 0, hd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, out: (B, H, Tq, hd); k, v: (B, H, S, hd), all contiguous and of one
// dtype (is_bf16 or f32) at 16-byte boundaries; pad: (B, S) f32, read only
// when has_pad. f32 runs the f32 kernel; bf16 the tensor-core kernel in its
// NORM mode (probabilities normalized before they are rounded for P.V, see
// the head of this file), with `warps` and `rows` as above.
extern "C" int mit_flash_attention_bhtd(const void* q, const void* k,
                                        const void* v, const void* pad,
                                        void* out, int B, int H, int Tq, int S,
                                        int hd, int causal, int has_pad,
                                        int is_bf16, int warps, int rows,
                                        void* stream) {
  if (is_bf16)
    return launch_tc_tiled<NORM_MODE>(warps, q, k, v, pad, out, B, H, Tq, S,
                                      hd, hd, hd, rows, causal, has_pad, 1, hd,
                                      stream);
  return launch_f32(q, k, v, pad, out, B, H, Tq, S, hd, hd, hd, causal,
                    has_pad, 1, hd, stream);
}

// For measurements only, not for the port's paths: bf16 (B, T, D) through
// the first CUDA-core kernel, as every bf16 call ran before the tensor-core
// kernel. q rows have stride ldq, k and v rows stride ldkv (elements), so the
// column blocks of a fused (B, T, 3D) tensor can be passed as three pointers.
// layer = 0: bf16 out; layer = 1: f32 out with the whole-layer numerics.
extern "C" int mit_flash_attention_btd_bf16_cudacore(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    int B, int Tq, int S, int D, int ldq, int ldkv, int causal, int has_pad,
    int layer, void* stream) {
  if (layer)
    return launch_v1<__nv_bfloat16, float, true>(q, k, v, pad, out, B, Tq, S,
                                                 D, ldq, ldkv, causal, has_pad,
                                                 stream);
  return launch_v1<__nv_bfloat16>(q, k, v, pad, out, B, Tq, S, D, ldq, ldkv,
                                  causal, has_pad, stream);
}

// For measurements only: the first CUDA-core kernel at the shapes the f32
// kernel and the NORM mode took over. bhtd = 0: f32 (B, T, H*64) tensors;
// bhtd = 1: (B, H, T, 64) tensors, f32 or bf16.
extern "C" int mit_flash_attention_v1(const void* q, const void* k,
                                      const void* v, const void* pad,
                                      void* out, int B, int H, int Tq, int S,
                                      int causal, int has_pad, int is_bf16,
                                      int bhtd, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Tq < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!bhtd) {
    if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_v1<float>(q, k, v, pad, out, B, Tq, S, H * HD, H * HD,
                            H * HD, causal, has_pad, stream);
  }
  if (is_bf16)
    return launch_v1<__nv_bfloat16, __nv_bfloat16, false, true>(
        q, k, v, pad, out, B, Tq, S, HD, HD, HD, causal, has_pad, stream, H);
  return launch_v1<float, float, false, true>(q, k, v, pad, out, B, Tq, S, HD,
                                              HD, HD, causal, has_pad, stream,
                                              H);
}
