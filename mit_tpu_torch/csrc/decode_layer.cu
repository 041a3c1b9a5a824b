// fused_decode_layer: one post-LN transformer decoder layer for one token per
// batch row, over a KV cache, in one launch, for sm_90a.
//
// Replaces the TPU kernel _decode_layer_kernel in
// mit_tpu/ops/pallas_decode_layer.py (behind fused_decode_layer / _impl) and
// computes the same thing, with the same rounding points. For B rows of one
// token each, width D = 512, 8 heads of 64, FF width F, cache length T;
// x, the caches and the weight matrices in the compute dtype (bf16 or f32);
// biases, LayerNorm parameters, madd and cross in f32:
//   qkv   = x . wqkv + bqkv                      f32 accumulation
//   k_new, v_new are emitted rounded to the compute dtype, but the f32 rows
//   serve this step's t == pos term
//   s[h,t] = (q_h . k_cache[t,h]) / 8, and at t == pos (q_h . k_new_h) / 8;
//   s    += madd[t]              (-1e9, not -inf: a fully masked row is finite)
//   p     = exp(s - max s);  den = sum p
//   ctx_h = (sum_{t != pos} p[t] v_cache[t,h] + p[pos] v_new_h) / den
//   x1    = LN1(x + round(ctx) . wo + bo)
//   x2    = LN2(x1 + cross)
//   mid   = relu(round(x2) . w1 + b1)
//   x3    = LN3(x2 + round(mid) . w2 + b2)       -> round(x3)
// where round() is the cast to the compute dtype, p is NOT rounded before
// P.V, the residual stream stays f32 from x to x3, and LN uses the biased
// variance and rsqrt(var + eps).
//
// What bounds it on the H100, and the design. The Pallas kernel keeps a
// layer's weights (6.3 MB in bf16) resident in VMEM across a grid of batch
// blocks. An SM has 227 KB of shared memory, so here the weights stay in
// the 50 MB L2 and every block streams them. The three LayerNorms need a
// whole row in one place, so a block owns ROWS batch rows and walks the
// whole layer for them. The work is far below the card's ridge (3.1 M
// multiply-adds a row against 6.3 MB of weights), so bytes bound it: each
// block's stream of the weights from L2 and of its rows' caches from device
// memory. One SM draws a layer's weights no faster than in about 70 us, so
// the launch must fill the card with blocks rather than rows per block:
// ROWS is 1 up to B = 96 (greedy decoding at batch 64: 64 blocks), 2 up to
// B = 256 (beam search at 192 rows: 96 blocks), else 4, where the L2's own
// rate (every block reads all the weights) becomes the limit.
//   - The four products are matrix-vector products on the CUDA cores: a
//     thread owns 16 bytes of output columns (8 bf16 or 4 f32), reads W in
//     16-byte loads that a warp coalesces into whole rows, eight in flight,
//     and keeps ROWS x VEC f32 sums. Where a product has fewer column
//     groups than the block has threads (N = 512: 64 groups), the K range
//     is cut into slices whose partial sums meet in shared memory and are
//     added in slice order, so the result does not change from run to run.
//     Every block reads the same weights, so a block starts its walk over
//     k at an offset of its own and wraps around (the stagger): the blocks
//     then do not ask the same L2 lines at the same moment.
//   - Attention: each batch row has 16 / ROWS warps over interleaved t. A warp
//     reads a cache row (1 KB in bf16) once for all 8 heads, 16 columns a
//     lane, and reduces each head's 4 lanes with shuffles. The t == pos
//     column is then replaced from the f32 k_new. Softmax is a warp per
//     (row, head). P.V has the same mapping as the scores; the warps'
//     partial contexts are summed through shared memory in warp order.
//   - The kernel can write the fresh rows into the caches itself
//     (write_cache): a block touches only its own batch rows, and the
//     t == pos terms never read the cache.
// Tensor cores (wgmma needs 64 rows), TMA and a split of one layer's
// columns over several SMs are later work.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 512;              // model width
constexpr int HD = 64;              // head_dim
constexpr int H = D / HD;           // 8 heads
constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;    // warps per block
constexpr int LANE_COLS = D / 32;   // 16 columns of a row per lane
constexpr int MAX_SMEM = 232448;    // 227 KB
constexpr float SCALE = 0.125f;     // 1/sqrt(64), exact
static_assert(LANE_COLS * 4 == HD, "a head is 4 lanes of 16 columns");
// ROWS, the batch rows a block owns, is a template parameter (1, 2 or 4):
// NW / ROWS warps share a row in the attention phases.

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// the value of x after a cast to the compute dtype
__device__ __forceinline__ float round_like(float x, const float*) {
  return x;
}
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  // a bf16 is the high half of an f32; element 0 lies in the low 16 bits
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16);
  f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16);
  f[7] = __uint_as_float(u.w & 0xffff0000u);
}

// a lane's LANE_COLS contiguous elements of a cache row (plain loads: the
// kernel may write other rows of the same tensor)
template <typename T>
__device__ __forceinline__ void load_lane(const T* p, float* f) {
  constexpr int V = Vec<T>::N;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < LANE_COLS / V; ++i) {
    const uint4 u = p4[i];
    unpack(u, f + i * V, static_cast<const T*>(nullptr));
  }
}

// K slices of a product with N output columns
template <typename T>
__device__ __forceinline__ int slices(int N) {
  const int ng = N / Vec<T>::N;
  return ng >= THREADS ? 1 : THREADS / ng;
}

// acc[r][v] += in[r * ldin + k] * W[k * N + n0 + v] for k in [ka, kb)
template <typename T, int ROWS>
__device__ __forceinline__ void gemv_span(float (&acc)[ROWS][Vec<T>::N],
                                          const float* __restrict__ in,
                                          int ldin, const T* __restrict__ wp,
                                          int N, int ka, int kb) {
  constexpr int V = Vec<T>::N;
  wp += (size_t)ka * N;
#pragma unroll 8
  for (int k = ka; k < kb; ++k) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(wp));
    wp += N;
    float w[V];
    unpack(u, w, static_cast<const T*>(nullptr));
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float a = in[r * ldin + k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(a, w[v], acc[r][v]);
    }
  }
}

// part[(slice * ROWS + r) * N + n] = sum over the slice's k of
// in[r * ldin + k] * W[k * N + n]; W is (K, N) row-major in device memory,
// `in` holds ROWS rows in shared memory. N must be a multiple of Vec<T>::N.
// With `stagger`, a block starts its walk over k at an offset of its own
// and wraps around, so that the blocks, which all read the same W, do not
// ask the same L2 lines at the same moment; the sum's order then differs
// from block to block, by f32 rounding only.
template <typename T, int ROWS>
__device__ __forceinline__ void gemv(const float* __restrict__ in, int ldin,
                                     const T* __restrict__ W, int K, int N,
                                     float* __restrict__ part, bool stagger) {
  constexpr int V = Vec<T>::N;
  const int ng = N / V;
  const int ks = slices<T>(N);
  const int slice = threadIdx.x / ng;
  if (slice >= ks) return;
  const int kchunk = (K + ks - 1) / ks;
  const int k0 = slice * kchunk;
  const int k1 = min(K, k0 + kchunk);
  // a multiple of 8 rows, so the unrolled loop keeps whole groups
  const int km = !stagger || k1 <= k0
                     ? k0
                     : k0 + (int)((blockIdx.x * 40u) % (unsigned)(k1 - k0));
  for (int g = threadIdx.x - slice * ng; g < ng; g += THREADS) {
    float acc[ROWS][V];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
    const T* wp = W + (size_t)g * V;
    gemv_span<T, ROWS>(acc, in, ldin, wp, N, km, k1);
    gemv_span<T, ROWS>(acc, in, ldin, wp, N, k0, km);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        part[(size_t)(slice * ROWS + r) * N + g * V + v] = acc[r][v];
  }
}

template <int ROWS>
__device__ __forceinline__ float slice_sum(const float* part, int ks, int N,
                                           int r, int n) {
  float s = 0.f;
  for (int sl = 0; sl < ks; ++sl) s += part[(size_t)(sl * ROWS + r) * N + n];
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// LayerNorm of one row held by one warp: lane holds columns j * 32 + lane
__device__ __forceinline__ void layer_norm(float* v, const float* scale,
                                           const float* bias, float eps,
                                           int lane) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < LANE_COLS; ++j) sum += v[j];
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < LANE_COLS; ++j) {
    const float c = v[j] - mean;
    sq = fmaf(c, c, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int j = 0; j < LANE_COLS; ++j) {
    const int col = j * 32 + lane;
    v[j] = (v[j] - mean) * rstd * scale[col] + bias[col];
  }
}

struct Params {
  const void* x;        // (B, D) compute dtype
  const int* pos;       // (B,)
  const float* madd;    // (B, T)
  void* kc;             // (B, T, D) compute dtype
  void* vc;
  const float* cross;   // (B, D)
  const void* wqkv;     // (D, 3D) compute dtype
  const float* bqkv;    // (3D,)
  const void* wo;       // (D, D)
  const float* bo;
  const float *ln1s, *ln1b, *ln2s, *ln2b, *ln3s, *ln3b;
  const void* w1;       // (D, F)
  const float* b1;
  const void* w2;       // (F, D)
  const float* b2;
  void *xo, *knew, *vnew;   // (B, D) compute dtype
  int B, T, F, write_cache, stagger;
  float eps;
};

__host__ __device__ inline int act_ld(int F) { return F > D ? F : D; }
__host__ __device__ inline int part_floats(int F, int rows) {
  int n = THREADS * 8;                 // slices * N never exceeds this
  if (3 * D > n) n = 3 * D;
  if (F > n) n = F;
  n *= rows;
  return n > NW * D ? n : NW * D;      // and the P.V partial contexts
}
__host__ __device__ inline int score_floats(int T, int rows) {
  return (rows * H * (T | 1) + 3) & ~3;
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS) decode_layer_kernel(Params p) {
  constexpr int WPR = NW / ROWS;             // warps per batch row
  static_assert(NW % ROWS == 0, "warps divide among the rows");
  extern __shared__ __align__(16) float smem[];
  const int T_ = p.T, F = p.F, B = p.B;
  const int ldact = act_ld(F);
  const int LT = T_ | 1;                     // odd score rows: no bank clash
  float* xs = smem;                          // ROWS x D, the f32 residual
  float* qkv = xs + ROWS * D;                // ROWS x 3D, f32 q, k_new, v_new
  float* act = qkv + ROWS * 3 * D;           // ROWS x ldact, a product's input
  float* sc = act + ROWS * ldact;            // ROWS x H x LT scores, then p
  float* part = sc + score_floats(T_, ROWS); // partial sums
  float* den = part + part_floats(F, ROWS);  // ROWS x H
  float* ppos = den + ROWS * H;              // ROWS x H, p at t == pos
  int* spos = reinterpret_cast<int*>(ppos + ROWS * H);   // ROWS

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * ROWS;
  const T* tnull = nullptr;

  const T* x = static_cast<const T*>(p.x);
  T* kc = static_cast<T*>(p.kc);
  T* vc = static_cast<T*>(p.vc);

  // x into the residual and the first product's input; rows past B are 0
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const float v = b0 + r < B ? to_f32(x[(size_t)(b0 + r) * D + d]) : 0.f;
    xs[i] = v;
    act[r * ldact + d] = v;
  }
  if (tid < ROWS) {
    const int ps = b0 + tid < B ? p.pos[b0 + tid] : -1;
    spos[tid] = ps >= 0 && ps < T_ ? ps : -1;
  }
  __syncthreads();

  // qkv = x . wqkv + bqkv; the fresh rows go out rounded
  gemv<T, ROWS>(act, ldact, static_cast<const T*>(p.wqkv), D, 3 * D, part,
                p.stagger);
  __syncthreads();
  {
    const int ks = slices<T>(3 * D);
    T* knew = static_cast<T*>(p.knew);
    T* vnew = static_cast<T*>(p.vnew);
    for (int i = tid; i < ROWS * 3 * D; i += THREADS) {
      const int r = i / (3 * D), n = i % (3 * D);
      const float v = slice_sum<ROWS>(part, ks, 3 * D, r, n) + p.bqkv[n];
      qkv[i] = v;
      const int b = b0 + r;
      if (n >= D && b < B) {
        const bool is_k = n < 2 * D;
        const int d = is_k ? n - D : n - 2 * D;
        store((is_k ? knew : vnew) + (size_t)b * D + d, v);
        if (p.write_cache && spos[r] >= 0)
          store((is_k ? kc : vc) + ((size_t)b * T_ + spos[r]) * D + d, v);
      }
    }
  }
  __syncthreads();

  // scores over the cache: WPR warps per row over interleaved t, a cache
  // row read once for all heads (a head is 4 lanes of 16 columns)
  {
    const int r = warp / WPR, ts = warp % WPR;
    const int b = b0 + r;
    if (b < B) {
      float q[LANE_COLS];
#pragma unroll
      for (int j = 0; j < LANE_COLS; ++j)
        q[j] = qkv[r * 3 * D + lane * LANE_COLS + j];
      float* srow = sc + (r * H + (lane >> 2)) * LT;
      const float* mrow = p.madd + (size_t)b * T_;
#pragma unroll 2
      for (int t = ts; t < T_; t += WPR) {
        float kv[LANE_COLS];
        load_lane(kc + ((size_t)b * T_ + t) * D + lane * LANE_COLS, kv);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < LANE_COLS; ++j) s = fmaf(q[j], kv[j], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if ((lane & 3) == 0) srow[t] = s * SCALE + mrow[t];
      }
    }
  }
  __syncthreads();
  // the t == pos column from the f32 k_new
  if (tid < ROWS * H) {
    const int r = tid / H, h = tid % H;
    const int ps = spos[r];
    if (b0 + r < B && ps >= 0) {
      const float* q = qkv + r * 3 * D + h * HD;
      const float* kn = q + D;
      float s = 0.f;
      for (int e = 0; e < HD; ++e) s = fmaf(q[e], kn[e], s);
      sc[(r * H + h) * LT + ps] =
          s * SCALE + p.madd[(size_t)(b0 + r) * T_ + ps];
    }
  }
  __syncthreads();

  // softmax numerators, a warp per (row, head); p at t == pos is set aside
  for (int i = warp; i < ROWS * H; i += NW) {
    const int r = i / H;
    if (b0 + r >= B) continue;
    float* row = sc + i * LT;
    const int ps = spos[r];
    float m = -INFINITY;
    for (int t = lane; t < T_; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float sum = 0.f, at = 0.f;
    for (int t = lane; t < T_; t += 32) {
      const float e = expf(row[t] - m);
      sum += e;
      if (t == ps) at = e;
      row[t] = t == ps ? 0.f : e;
    }
    sum = warp_sum(sum);
    at = warp_sum(at);
    if (lane == 0) {
      den[i] = sum;
      ppos[i] = at;
    }
  }
  __syncthreads();

  // P.V over the cache: WPR warps per row over interleaved t
  {
    const int r = warp / WPR, ts = warp % WPR;
    const int b = b0 + r;
    float acc[LANE_COLS];
#pragma unroll
    for (int j = 0; j < LANE_COLS; ++j) acc[j] = 0.f;
    if (b < B) {
      const float* prow = sc + (r * H + (lane >> 2)) * LT;
#pragma unroll 2
      for (int t = ts; t < T_; t += WPR) {
        float vv[LANE_COLS];
        load_lane(vc + ((size_t)b * T_ + t) * D + lane * LANE_COLS, vv);
        const float pt = prow[t];
#pragma unroll
        for (int j = 0; j < LANE_COLS; ++j) acc[j] = fmaf(pt, vv[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < LANE_COLS; ++j)
      part[warp * D + lane * LANE_COLS + j] = acc[j];
  }
  __syncthreads();
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D, h = d / HD;
    float c = 0.f;
    if (b0 + r < B) {
#pragma unroll
      for (int w = 0; w < WPR; ++w) c += part[(r * WPR + w) * D + d];
      c = fmaf(ppos[r * H + h], qkv[r * 3 * D + 2 * D + d], c);
      c = c / den[r * H + h];
    }
    act[r * ldact + d] = round_like(c, tnull);
  }
  __syncthreads();

  // x1 = LN1(x + ctx . wo + bo); x2 = LN2(x1 + cross)
  gemv<T, ROWS>(act, ldact, static_cast<const T*>(p.wo), D, D, part,
                p.stagger);
  __syncthreads();
  {
    const int ks = slices<T>(D);
    for (int i = tid; i < ROWS * D; i += THREADS) {
      const int r = i / D, n = i % D;
      xs[i] += slice_sum<ROWS>(part, ks, D, r, n) + p.bo[n];
    }
  }
  __syncthreads();
  if (warp < ROWS) {
    const int r = warp, b = b0 + r;
    float v[LANE_COLS];
#pragma unroll
    for (int j = 0; j < LANE_COLS; ++j) v[j] = xs[r * D + j * 32 + lane];
    layer_norm(v, p.ln1s, p.ln1b, p.eps, lane);
    if (b < B) {
#pragma unroll
      for (int j = 0; j < LANE_COLS; ++j)
        v[j] += p.cross[(size_t)b * D + j * 32 + lane];
    }
    layer_norm(v, p.ln2s, p.ln2b, p.eps, lane);
#pragma unroll
    for (int j = 0; j < LANE_COLS; ++j) {
      xs[r * D + j * 32 + lane] = v[j];
      act[r * ldact + j * 32 + lane] = round_like(v[j], tnull);
    }
  }
  __syncthreads();

  // mid = relu(x2 . w1 + b1), rounded
  gemv<T, ROWS>(act, ldact, static_cast<const T*>(p.w1), D, F, part,
                p.stagger);
  __syncthreads();
  {
    const int ks = slices<T>(F);
    for (int i = tid; i < ROWS * F; i += THREADS) {
      const int r = i / F, n = i % F;
      const float m = slice_sum<ROWS>(part, ks, F, r, n) + p.b1[n];
      act[r * ldact + n] = round_like(fmaxf(m, 0.f), tnull);
    }
  }
  __syncthreads();

  // x3 = LN3(x2 + mid . w2 + b2)
  gemv<T, ROWS>(act, ldact, static_cast<const T*>(p.w2), F, D, part,
                p.stagger);
  __syncthreads();
  {
    const int ks = slices<T>(D);
    for (int i = tid; i < ROWS * D; i += THREADS) {
      const int r = i / D, n = i % D;
      xs[i] += slice_sum<ROWS>(part, ks, D, r, n) + p.b2[n];
    }
  }
  __syncthreads();
  if (warp < ROWS && b0 + warp < B) {
    const int r = warp;
    float v[LANE_COLS];
#pragma unroll
    for (int j = 0; j < LANE_COLS; ++j) v[j] = xs[r * D + j * 32 + lane];
    layer_norm(v, p.ln3s, p.ln3b, p.eps, lane);
    T* xo = static_cast<T*>(p.xo) + (size_t)(b0 + r) * D;
#pragma unroll
    for (int j = 0; j < LANE_COLS; ++j) store(xo + j * 32 + lane, v[j]);
  }
}

template <typename T, int ROWS>
int launch(const Params& p, void* stream) {
  const size_t floats = (size_t)ROWS * D + ROWS * 3 * D +
                        (size_t)ROWS * act_ld(p.F) + score_floats(p.T, ROWS) +
                        part_floats(p.F, ROWS) + 2 * ROWS * H + ROWS;
  const size_t bytes = floats * sizeof(float);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      decode_layer_kernel<T, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_layer_kernel<T, ROWS>
      <<<(p.B + ROWS - 1) / ROWS, THREADS, bytes, (cudaStream_t)stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const Params& p, int rows, void* stream) {
  switch (rows) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shapes as in the head of this file; every tensor contiguous and 16-byte
// aligned. d and heads must be 512 and 8, f a multiple of 8. flags: bit 0,
// the compute dtype is bf16 (else f32); bit 1, also write the fresh rows
// into kc and vc at pos; bit 2, no stagger; bits 4-6, the batch rows per
// block (1, 2 or 4; 0 picks by b), both for measurement. A pos outside
// [0, T) matches no column.
extern "C" int mit_fused_decode_layer(
    const void* x, const void* pos, const void* madd, void* kc, void* vc,
    const void* cross, const void* wqkv, const void* bqkv, const void* wo,
    const void* bo, const void* ln1s, const void* ln1b, const void* ln2s,
    const void* ln2b, const void* ln3s, const void* ln3b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* xo, void* knew,
    void* vnew, int b, int t, int d, int heads, int f, int flags, float eps,
    void* stream) {
  if (d != D || heads != H || b < 1 || t < 1 || f < 8 || f % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.pos = static_cast<const int*>(pos);
  p.madd = static_cast<const float*>(madd);
  p.kc = kc;
  p.vc = vc;
  p.cross = static_cast<const float*>(cross);
  p.wqkv = wqkv;
  p.bqkv = static_cast<const float*>(bqkv);
  p.wo = wo;
  p.bo = static_cast<const float*>(bo);
  p.ln1s = static_cast<const float*>(ln1s);
  p.ln1b = static_cast<const float*>(ln1b);
  p.ln2s = static_cast<const float*>(ln2s);
  p.ln2b = static_cast<const float*>(ln2b);
  p.ln3s = static_cast<const float*>(ln3s);
  p.ln3b = static_cast<const float*>(ln3b);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.xo = xo;
  p.knew = knew;
  p.vnew = vnew;
  p.B = b;
  p.T = t;
  p.F = f;
  p.write_cache = (flags >> 1) & 1;
  p.stagger = !((flags >> 2) & 1);
  p.eps = eps;
  int rows = (flags >> 4) & 7;
  if (rows == 0) rows = b <= 96 ? 1 : b <= 256 ? 2 : 4;
  return (flags & 1) ? launch_rows<__nv_bfloat16>(p, rows, stream)
                     : launch_rows<float>(p, rows, stream);
}
