// flash_attention_btd: multi-head attention in the (B, T, D) activation
// layout, heads as column blocks of HEAD_DIM = 64, for sm_90a.
//
// Replaces the TPU kernel _attn_kernel_btd in mit_tpu/ops/pallas_attention.py
// (behind flash_attention_btd / _flash_forward_btd) and computes the same
// thing, per head h (columns h*64 .. h*64+63):
//   s   = (q_h . k_h^T) * 1/sqrt(64)                     in f32
//   s  += -1e9 where col > row              (causal)
//   s  += pad[b, col]                       (has_pad)
//   p   = exp(s - rowmax(s))
//   out = (round_to_v_dtype(p) . v_h, f32 accumulation) / rowsum(p)
// cast to the dtype of q. -1e9 rather than -inf keeps a fully masked row
// finite: it comes out as the reference's softmax gives it, not NaN.
//
// Two kernels compute it. bf16 inputs of the (B, T, D) and fused-QKV entries
// take flash_attention_btd_tc_kernel, on the tensor cores; f32 inputs (which
// must keep full f32 products: TF32 would keep 10 mantissa bits) and the
// (B, H, T, hd) entry take flash_attention_btd_kernel, on the CUDA cores.
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
// - Softmax. Without LAYER, one product for the scores and an online
//   softmax (a running row max; the sums and the output are rescaled by
//   exp(m_old - m_new) when it grows). p is rounded to bf16 against the
//   running max, not the final one, so p before rounding is no longer bit
//   for bit the reference's number; the error stays that of one bf16
//   rounding per probability, far inside the bf16 limit of 2e-2. With LAYER
//   (the int8 whole-layer numerics) that is not good enough: the context is
//   requantized to int8 right after, and a difference of one bf16 rounding
//   per probability flips enough codes to push the layer past its bound
//   against the plain version (relative L2 8e-3 against 5e-3, measured). So
//   LAYER walks the key tiles twice, first for the exact row max from the
//   scores alone (K tiles only), then for exp2(s - max), the row sum and
//   P.V: p is the reference's number, as in the CUDA-core kernel, at a
//   third more time. Holding a whole score row in registers instead would
//   take 128 registers a thread at S = 256 and a second code path above it.
// - Causal: the walk ends at the block's diagonal, which is exact while
//   each row has seen a visible key (the skipped terms are exp(-1e9 - m) =
//   0 in f32). A row whose visible keys are all padded shares its max of
//   -1e9 with the causally masked keys that are NOT padded, and the
//   reference spreads it over those too; by a block-wide vote at the
//   diagonal a block with such a row (running max below -5e8) walks on.
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
// The CUDA-core kernel (f32, and both dtypes in (B, H, T, hd)). A block
// owns one (batch, head, 32-query tile) and streams K and V in 64-row
// tiles, converted to f32 on the way into shared memory. The arithmetic is
// f32 FMA fed from shared memory in 4 x 4 register tiles: two shared-memory
// loads per FMA pair, so shared-memory bandwidth, at about half the f32 FMA
// peak, is its bound. Its softmax is two passes, not online: pass 1 walks
// the key tiles for the exact row max; pass 2 walks them again, recomputes
// the scores, and takes exp(s - max), the row sum and P.V. So p is the
// number the single-block reference computes before it is rounded to v's
// dtype, at the price of the q.k^T product computed twice.
//
// Fused QKV. Both kernels also replace _attn_kernel_btd_fusedqkv
// (pallas_attention.py:196, behind flash_attention_btd_fusedqkv) and the
// attention stage of the int8 whole-layer kernel (_attn_body in
// mit_tpu/ops/pallas_int8_layer.py:69-127). There q, k and v are the column
// blocks 0, D and 2D of one (B, T, 3D) tensor, as the fused QKV projection
// writes it: the loads take a row stride (3D) and a column offset, so no
// split or copy of that tensor is made. The whole-layer kernel's numerics
// differ in three places, selected by the LAYER template flag: the scores
// are scaled by log2(e)/sqrt(64) and exponentiated with exp2f (the same p
// up to rounding), the context is o * (1 / rowsum) rather than o / rowsum,
// and it is written in f32 from bf16 qkv.
//
// (B, H, T, hd) layout. The CUDA-core kernel also replaces
// _attn_kernel_allheads (pallas_attention.py:86, behind flash_attention), which
// the JAX package runs where one (T, D) batch cell would not fit its fast
// memory. The Pallas cell holds every head's whole (T, hd) and (S, hd) tiles
// and one (T, S) score block; here the grid is the same (batch, head,
// 32-query tile) and K and V stream in the same 64-row tiles, with a row
// stride of 64 and head h of batch b at ((b*H + h)*T) rows (the BHTD
// template flag). Its numerics differ in one place: the probabilities are
// normalized BEFORE P.V, probs = p / rowsum(p), rounded to v's dtype, and
// the product is the output. So pass 1 also takes the row sum, online per
// thread (a running max and a sum rescaled when the max grows, combined
// across the 16 lanes of a row at the end), and pass 2 divides p by it
// before rounding. The sum differs from a sum of exp(s - final max) only in
// f32 rounding order.
//
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int HD = 64;          // head_dim
constexpr int BQ = 32;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 128;    // 16 column lanes x 8 row lanes
constexpr int LD = HD + 1;      // padded shared-memory row: no bank conflicts
constexpr int PLD = BK + 1;
constexpr float NEG_INF = -1e9f;
constexpr float SCALE = 0.125f;                        // 1/sqrt(64), exact
constexpr float SCALE2 = 0.18033688011112042f;         // log2(e)/sqrt(64)
constexpr float LOG2E = 1.4426950408889634f;

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
// bf16 on the tensor cores (see the head of this file)
// ----------------------------------------------------------------------
constexpr int BN = 64;            // keys per tile
constexpr int WGR = 64;           // query rows a warpgroup
constexpr int STAGES = 3;         // K and V tiles in shared memory
constexpr int TILE = 64 * HD;     // elements of a 64-row tile (8 KB)
// a row whose running max is below this has seen only masked keys so far
constexpr float ROW_MASKED = -5e8f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; zeros when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// two f32 rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}
// 2^x for x <= 0 in one MUFU instruction. exp2f adds only the scaling that
// keeps results below 2^-126 from flushing to zero, and a probability that
// small adds nothing to a sum whose largest term is 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Where element (r, c) of a 64-column bf16 tile lies in shared memory: rows
// of 128 bytes, the 16-byte chunks of row r XORed by r mod 8. That is the
// 128-byte swizzle the wgmma descriptors name.
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * HD + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// rows [0, nrows) x HD columns of a bf16 matrix with row stride `ld` into
// the tile dst, 16 bytes a thread; rows past `valid` (>= 1) are zero.
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int nrows, int valid, int ld) {
  for (int i = threadIdx.x; i < nrows * (HD / 8); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r < valid;
    cp_async16(dst + tile_at(r, c), src + (size_t)(ok ? r : 0) * ld + c, ok);
  }
}

// wgmma: a warpgroup (4 warps) multiplies 64 rows at a time; B, and A unless
// it is in registers, are read from shared memory through a descriptor.
// This one names a tile in the layout of tile_at, 1024 bytes aligned: start
// address, 8-row groups 1024 bytes apart, 128-byte swizzle. A k-step of 16
// along the 64 contiguous columns adds 32 bytes to the start (2 in the
// descriptor's 16-byte units); along the rows, for a transposed operand, 16
// rows (128 units).
__device__ __forceinline__ unsigned long long wg_desc(const void* p) {
  return ((unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4)) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// close the group of products started so far and wait for it; d, their
// accumulator, is not read before
__device__ __forceinline__ void wg_commit_wait(float (&d)[8][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}
#define MIT_WG_D(d)                                                          \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),            \
      "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]),            \
      "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]),            \
      "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),            \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),            \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]),            \
      "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define MIT_WG_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
// The accumulator d is 64 x 64 f32 over the warpgroup. Warp w of the group
// holds rows 16w .. 16w+15, and lane (g, t) = (lane / 4, lane % 4) of it
// holds, for each 8-column tile nt: d[nt][0], d[nt][1] = row g, columns
// 8 nt + 2t, + 1; d[nt][2], d[nt][3] = row g + 8, the same columns.
//
// d = a . b^T, or += if accumulate: a (64 x 16) and b (64 x 16) both from
// shared memory, 16 contiguous columns of their tiles
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4],
                                         unsigned long long a,
                                         unsigned long long b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIT_WG_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MIT_WG_D(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d += a . b: a (this warp's 16 rows x 16) from registers, b (16 rows x 64
// columns of its tile, so transposed) from shared memory. Lane (g, t) gives
// a[0] = (row g, columns 2t, 2t+1), a[1] = (row g + 8, the same), a[2] =
// (row g, columns 2t + 8, + 9), a[3] = (row g + 8, the same): two
// neighbouring 8-column tiles of an accumulator, rounded to bf16.
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[8][4],
                                            const unsigned (&a)[4],
                                            unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIT_WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MIT_WG_D(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A block of NW warps, NW / 4 warpgroups, owns `rows` query rows of one
// (batch, head), a multiple of 64 and at most 16 * NW; warpgroup w owns
// rows 64w onwards and warp i of it rows 16i of those. Strides as in
// flash_attention_btd_kernel. Dynamic shared memory, from the first 1024
// bytes boundary (the swizzle is a function of the address): the query
// tiles, then STAGES stages of a K tile and a V tile.
//
// LAYER (the whole-layer numerics; never causal or padded) walks the key
// tiles twice: first for the exact row max, from the scores alone, then
// for exp2(s - max), the row sum and P.V, so p is the reference's number
// before it is rounded. Otherwise one walk, with an online softmax.
template <int NW, bool LAYER>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 3 : 2)
flash_attention_btd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ pad,
                              typename std::conditional<LAYER, float,
                                                        __nv_bfloat16>::type*
                                  __restrict__ out,
                              int Tq, int S, int D, int ldq, int ldkv,
                              int rows, bool causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - smem_u32(smem_raw)) & 1023));
  __nv_bfloat16* kvs = qs + (NW / 4) * TILE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;          // row of the fragment
  const int t4 = lane & 3;          // column pair of the fragment
  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = q + ((size_t)b * Tq + q0) * ldq + h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * ldkv + h * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * ldkv + h * HD;
  const float* pad_row = pad != nullptr ? pad + (size_t)b * S : nullptr;
  const float scale = LAYER ? SCALE2 : SCALE;

  // a warpgroup multiplies as one: its warps past Tq go along, on zero rows
  const int grow = (warp >> 2) * WGR;               // its first row here
  const bool active = grow < rows && q0 + grow < Tq;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;   // this thread's

  const int nkt = (S + BN - 1) / BN;
  // causal: the key tiles that reach below the diagonal of this block
  int kt_end = causal ? min(nkt, (min(q0 + rows, Tq) - 1) / BN + 1) : nkt;
  const int first_pv = LAYER ? nkt : 0;   // the steps before it take the max

  auto load_kv = [&](int step, int stage) {
    const int k0 = (step >= first_pv ? step - first_pv : step) * BN;
    const int valid = min(BN, S - k0);
    const int nrows = ((valid + 15) >> 4) << 4;     // whole 16-key steps
    __nv_bfloat16* ks = kvs + stage * 2 * TILE;
    load_rows_async(ks, kb + (size_t)k0 * ldkv, nrows, valid, ldkv);
    if (step >= first_pv)
      load_rows_async(ks + TILE, vb + (size_t)k0 * ldkv, nrows, valid, ldkv);
    cp_async_commit();
  };

  load_rows_async(qs, qb, rows, Tq - q0, ldq);
  load_kv(0, 0);
  if (1 < first_pv + kt_end) load_kv(1, 1);
  else cp_async_commit();

  float o[8][4];                    // this warp's 16 x 64 output, unnormalized
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // row max (rows g, g + 8)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the row sum
  // a row of this thread that exists and has seen only masked keys so far
  auto row_masked = [&]() {
    return active && ((m0 <= ROW_MASKED && row0 < Tq) ||
                      (m1 <= ROW_MASKED && row1 < Tq));
  };

  // Three stages, two tiles ahead: a tile is waited for, then one barrier
  // (every warp is done with the tile before it, whose stage the load
  // started next refills), then the load of the tile after next. A step
  // that has nothing to load commits an empty group, so the count holds.
  for (int step = 0; step < first_pv + kt_end; ++step) {
    const int stage = step % STAGES;
    cp_async_wait<1>();
    // cp.async wrote the tile; wgmma reads it through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (step + 2 < first_pv + kt_end) load_kv(step + 2, (step + 2) % STAGES);
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
      const __nv_bfloat16* ks = kvs + stage * 2 * TILE;

      // scores: four k-steps of the warpgroup's 64 query rows by the tile's
      // 64 keys (those past S are masked below, whatever lies there)
      float s[8][4];
      const unsigned long long dq = wg_desc(qs + (warp >> 2) * TILE);
      const unsigned long long dk = wg_desc(ks);
      wg_fence();
#pragma unroll
      for (int ks4 = 0; ks4 < 4; ++ks4)
        wgmma_ss(s, dq + 2 * ks4, dk + 2 * ks4, ks4 > 0);
      wg_commit_wait(s);

      if (!pv) {
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
      if (!LAYER) {
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
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          o[nt][0] *= a0;
          o[nt][1] *= a0;
          o[nt][2] *= a1;
          o[nt][3] *= a1;
        }
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
          l0 += s[nt][e];
          l1 += s[nt][2 + e];
        }
        // accumulator tiles 2kk, 2kk+1 are the A fragment of k-step kk
        pf[nt >> 1][(nt & 1) * 2] = pack_bf16(s[nt][0], s[nt][1]);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      }

      // P.V: p from registers, 16 keys (rows of the V tile) a step, and
      // only the steps with a key below S (the rows up to the end of the
      // last such step are zero-filled, the rest never loaded)
      const unsigned long long dv = wg_desc(ks + TILE);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (FULL || kk < steps) wgmma_rs_bt(o, pf[kk], dv + 128 * kk);
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
    if (step + 1 == kt_end && kt_end < nkt) {       // causal, so not LAYER
      if (__syncthreads_or(row_masked())) {
        kt_end = nkt;
        load_kv(step + 1, (step + 1) % STAGES);
        if (step + 2 < nkt) load_kv(step + 2, (step + 2) % STAGES);
        else cp_async_commit();
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = __fdiv_rn(1.f, l0), i1 = __fdiv_rn(1.f, l1);
  if (LAYER) {
    // f32 out, o * (1 / l) as the layer kernel has it: a quad writes 32
    // contiguous bytes of a row
    float* ob = reinterpret_cast<float*>(out) + ((size_t)b * Tq) * D + h * HD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (row0 < Tq)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * D + col) =
            make_float2(__fmul_rn(o[nt][0], i0), __fmul_rn(o[nt][1], i0));
      if (row1 < Tq)
        *reinterpret_cast<float2*>(ob + (size_t)row1 * D + col) =
            make_float2(__fmul_rn(o[nt][2], i1), __fmul_rn(o[nt][3], i1));
    }
  } else {
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
        reinterpret_cast<__nv_bfloat16*>(out) + ((size_t)b * Tq) * D + h * HD;
    const int wrow = q0 + warp * 16;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + (lane >> 3), c = (lane & 7) * 8;
      if (wrow + r < Tq)
        *reinterpret_cast<uint4*>(ob + (size_t)(wrow + r) * D + c) =
            *reinterpret_cast<const uint4*>(mine + tile_at(r, c));
    }
  }
}

template <int NW, bool LAYER>
int launch_tc(const void* q, const void* k, const void* v, const void* pad,
              void* out, int B, int Tq, int S, int D, int ldq, int ldkv,
              int rows, int causal, int has_pad, void* stream) {
  using OutT =
      typename std::conditional<LAYER, float, __nv_bfloat16>::type;
  if (rows < WGR || rows % WGR || rows > NW * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // the tiles, and the room to start them at 1024 bytes
  const int smem =
      (NW / 4 + 2 * STAGES) * TILE * (int)sizeof(__nv_bfloat16) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_btd_tc_kernel<NW, LAYER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Tq + rows - 1) / rows, D / HD, B);
  flash_attention_btd_tc_kernel<NW, LAYER>
      <<<grid, NW * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          has_pad ? static_cast<const float*>(pad) : nullptr,
          static_cast<OutT*>(out), Tq, S, D, ldq, ldkv, rows, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

// `warps` warps a block, 4 or 8 (one warpgroup or two), each block `rows`
// query rows
template <bool LAYER>
int launch_tc_tiled(int warps, const void* q, const void* k, const void* v,
                    const void* pad, void* out, int B, int Tq, int S, int D,
                    int ldq, int ldkv, int rows, int causal, int has_pad,
                    void* stream) {
  if (warps == 4)
    return launch_tc<4, LAYER>(q, k, v, pad, out, B, Tq, S, D, ldq, ldkv,
                               rows, causal, has_pad, stream);
  if (warps == 8)
    return launch_tc<8, LAYER>(q, k, v, pad, out, B, Tq, S, D, ldq, ldkv,
                               rows, causal, has_pad, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename OutT = T, bool LAYER = false,
          bool BHTD = false>
int launch(const void* q, const void* k, const void* v, const void* pad,
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

// q, out: (B, Tq, D); k, v: (B, S, D), all contiguous and of one dtype;
// pad: (B, S) f32, read only when has_pad. D must be a multiple of 64.
extern "C" int mit_flash_attention_btd_f32(const void* q, const void* k,
                                           const void* v, const void* pad,
                                           void* out, int B, int Tq, int S,
                                           int D, int causal, int has_pad,
                                           void* stream) {
  return launch<float>(q, k, v, pad, out, B, Tq, S, D, D, D, causal, has_pad,
                       stream);
}

// bf16: the tensor-core kernel. A block has `warps` warps, 4 or 8 (one
// warpgroup or two), and owns `rows` query rows, 64 a warpgroup.
extern "C" int mit_flash_attention_btd_bf16(const void* q, const void* k,
                                            const void* v, const void* pad,
                                            void* out, int B, int Tq, int S,
                                            int D, int causal, int has_pad,
                                            int warps, int rows,
                                            void* stream) {
  return launch_tc_tiled<false>(warps, q, k, v, pad, out, B, Tq, S, D, D, D,
                                rows, causal, has_pad, stream);
}

// qkv: (B, T, 3D) contiguous; out: (B, T, D). mode 0: f32 in and out (the
// CUDA-core kernel); mode 1: bf16 in and out; mode 2: bf16 in, f32 out, the
// whole-layer kernel's numerics (exp2, o * (1 / rowsum)). Modes 1 and 2 run
// the tensor-core kernel with `warps` and `rows` as above. D must be a
// multiple of 64.
extern "C" int mit_flash_attention_fusedqkv(const void* qkv, void* out, int B,
                                            int T, int D, int mode, int warps,
                                            int rows, void* stream) {
  // q, k and v are the column blocks 0, D, 2D of qkv, with row stride 3D
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const float* q32 = static_cast<const float*>(qkv);
  switch (mode) {
    case 0:
      return launch<float>(q32, q32 + D, q32 + 2 * D, nullptr, out, B, T, T,
                           D, 3 * D, 3 * D, 0, 0, stream);
    case 1:
      return launch_tc_tiled<false>(warps, q, q + D, q + 2 * D, nullptr, out,
                                    B, T, T, D, 3 * D, 3 * D, rows, 0, 0,
                                    stream);
    case 2:
      return launch_tc_tiled<true>(warps, q, q + D, q + 2 * D, nullptr, out,
                                   B, T, T, D, 3 * D, 3 * D, rows, 0, 0,
                                   stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// For measurements only, not for the port's paths: bf16 through the
// CUDA-core kernel, as every bf16 call ran before the tensor-core kernel.
// q rows have stride ldq, k and v rows stride ldkv (elements), so the column
// blocks of a fused (B, T, 3D) tensor can be passed as three pointers.
// layer = 0: bf16 out; layer = 1: f32 out with the whole-layer numerics.
extern "C" int mit_flash_attention_btd_bf16_cudacore(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    int B, int Tq, int S, int D, int ldq, int ldkv, int causal, int has_pad,
    int layer, void* stream) {
  if (layer)
    return launch<__nv_bfloat16, float, true>(q, k, v, pad, out, B, Tq, S, D,
                                              ldq, ldkv, causal, has_pad,
                                              stream);
  return launch<__nv_bfloat16>(q, k, v, pad, out, B, Tq, S, D, ldq, ldkv,
                               causal, has_pad, stream);
}

// q, out: (B, H, Tq, 64); k, v: (B, H, S, 64), all contiguous and of one
// dtype (is_bf16 or f32); pad: (B, S) f32, read only when has_pad.
// Probabilities are normalized before P.V (see the head of this file).
extern "C" int mit_flash_attention_bhtd(const void* q, const void* k,
                                        const void* v, const void* pad,
                                        void* out, int B, int H, int Tq, int S,
                                        int causal, int has_pad, int is_bf16,
                                        void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Tq < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, false, true>(
        q, k, v, pad, out, B, Tq, S, HD, HD, HD, causal, has_pad, stream, H);
  return launch<float, float, false, true>(q, k, v, pad, out, B, Tq, S, HD, HD,
                                           HD, causal, has_pad, stream, H);
}
