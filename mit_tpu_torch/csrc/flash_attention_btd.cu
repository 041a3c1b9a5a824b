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
// What bounds it on the H100. The Pallas kernel holds one batch row's whole
// (T, D) q/k/v tiles in VMEM and loops over heads inside the cell. A
// Hopper block has at most 227 KB of shared memory, and at S = 577 one
// head's f32 K and V tiles alone take 295 KB, so a block here owns one
// (batch, head, 32-query tile) and streams K and V in 64-row tiles. At the
// encoder's shape (B = 64, T = S = 197, 12 heads) that is 5,376 blocks,
// enough to fill 132 SMs several times over. The arithmetic is f32 FMA on
// the CUDA cores (f32 inputs must keep full f32 products), fed from shared
// memory in 4 x 4 register tiles: two shared-memory loads per FMA pair, so
// shared-memory bandwidth, at about half the f32 FMA peak, is the bound.
// Tensor cores (mma / wgmma for bf16) and TMA loads are later work.
//
// Softmax over key tiles: two passes, not an online softmax. Pass 1 walks
// the key tiles for the exact row max; pass 2 walks them again, recomputes
// the scores, and takes exp(s - max), the row sum and P.V. So p is the same
// number the single-block reference computes before it is rounded to v's
// dtype: only the f32 summation order differs, where an online softmax would
// round p against a running max and rescale the sums. The price is the
// q.k^T product computed twice (three tile products instead of two).
//
// Fused QKV. The same kernel also replaces _attn_kernel_btd_fusedqkv
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
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
// (the model width); head h is columns h*64 .. h*64+63 of each.
template <typename T, typename OutT, bool LAYER>
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

  const T* qb = q + ((size_t)b * Tq + q0) * ldq + h * HD;
  const T* kb = k + (size_t)b * S * ldkv + h * HD;
  const T* vb = v + (size_t)b * S * ldkv + h * HD;
  const float* pad_row = pad != nullptr ? pad + (size_t)b * S : nullptr;
  const float scale = LAYER ? SCALE2 : SCALE;

  load_tile(qs, qb, BQ, min(BQ, Tq - q0), ldq);

  float s[4][4];

  // Pass 1: exact row max over every key tile.
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile(kvs, kb + (size_t)k0 * ldkv, BK, min(BK, S - k0), ldkv);
    __syncthreads();
    tile_scores(s, qs, kvs, q0, k0, S, pad_row, causal, tx, ty, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[i] = fmaxf(m[i], s[i][j]);
  }
  // the 16 lanes that share a row are one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));

  // Pass 2: p = exp(s - max), its row sum, and P.V.
  float l[4] = {0.f, 0.f, 0.f, 0.f};
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
        const float p = LAYER ? exp2f(s[i][j] - m[i]) : expf(s[i][j] - m[i]);
        l[i] += p;
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

  OutT* ob = out + ((size_t)b * Tq + q0) * D + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= Tq) continue;
    const float inv = LAYER ? __fdiv_rn(1.f, l[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(ob + (size_t)r * D + tx + 16 * j,
            LAYER ? __fmul_rn(o[i][j], inv) : o[i][j] / l[i]);
  }
}

template <typename T, typename OutT = T, bool LAYER = false>
int launch(const void* q, const void* k, const void* v, const void* pad,
           void* out, int B, int Tq, int S, int D, int ldq, int ldkv,
           int causal, int has_pad, void* stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, D / HD, B);
  flash_attention_btd_kernel<T, OutT, LAYER>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v),
          has_pad ? static_cast<const float*>(pad) : nullptr,
          static_cast<OutT*>(out), Tq, S, D, ldq, ldkv, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

// q, k and v as the column blocks of one (B, T, 3D) tensor
template <typename T, typename OutT = T, bool LAYER = false>
int launch_fused(const void* qkv, void* out, int B, int T_, int D,
                 void* stream) {
  const T* q = static_cast<const T*>(qkv);
  return launch<T, OutT, LAYER>(q, q + D, q + 2 * D, nullptr, out, B, T_, T_,
                                D, 3 * D, 3 * D, 0, 0, stream);
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

extern "C" int mit_flash_attention_btd_bf16(const void* q, const void* k,
                                            const void* v, const void* pad,
                                            void* out, int B, int Tq, int S,
                                            int D, int causal, int has_pad,
                                            void* stream) {
  return launch<__nv_bfloat16>(q, k, v, pad, out, B, Tq, S, D, D, D, causal,
                               has_pad, stream);
}

// qkv: (B, T, 3D) contiguous; out: (B, T, D). mode 0: f32 in and out;
// mode 1: bf16 in and out; mode 2: bf16 in, f32 out, the whole-layer
// kernel's numerics (exp2, o * (1 / rowsum)). D must be a multiple of 64.
extern "C" int mit_flash_attention_fusedqkv(const void* qkv, void* out, int B,
                                            int T, int D, int mode,
                                            void* stream) {
  switch (mode) {
    case 0: return launch_fused<float>(qkv, out, B, T, D, stream);
    case 1: return launch_fused<__nv_bfloat16>(qkv, out, B, T, D, stream);
    case 2:
      return launch_fused<__nv_bfloat16, float, true>(qkv, out, B, T, D,
                                                      stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
