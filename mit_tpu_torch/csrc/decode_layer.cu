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
// blocks. Here they stay in the 50 MB L2, and the work is far below the
// card's ridge (3.1 M multiply-adds a row against 6.3 MB of weights), so
// bytes bound it: the weights from L2, the caches from device memory. The
// launch is one cooperative persistent grid (GRID_PER_SM blocks on every SM,
// cudaLaunchCooperativeKernel, so all are resident) that walks the layer in
// seven phases with a grid barrier between phases that need whole rows, and
// each phase spreads its work over every block:
//   1. qkv = x . wqkv + bqkv (f32, into the workspace);
//   2. attention, four warps to a (row, head): the scores from the cache
//      (the t == pos term from the f32 fresh row), softmax, P.V; it also
//      emits the fresh rows rounded and writes them into the caches
//      (write_cache), and leaves round(ctx);
//   3. round(ctx) . wo into KS partial sums;
//   4. a block to a row: x1 = LN1(x + (sum of the partials + bo)),
//      x2 = LN2(x1 + cross), kept in f32 and rounded;
//   5. mid = round(relu(round(x2) . w1 + b1));
//   6. round(mid) . w2 into KS partial sums;
//   7. a block to a row: x3 = LN3(x2 + (sum + b2)), rounded out.
// A product is cut into items of V output columns (16 bytes of the compute
// dtype: 8 bf16 or 4 f32) by one of KS slices of K, spread over the blocks,
// so each weight element is read by one block (once per 64 batch rows),
// where the first design read all of them in every block. An item copies
// 64 input rows by 128 k, and the 128 rows of its 16 bytes of W, into
// shared memory with cp.async, two tiles in flight (the next while this one
// is multiplied); lane l of warp w owns rows l and l + 32 and k 16 w ..
// 16 w + 15 of each tile, and keeps 2 x V f32 sums on the CUDA cores
// (tensor cores would need bf16 inputs or TF32, which would change the f32
// numerics). The eight warps' sums meet in shared memory and are added in
// warp order; the KS partials are added in slice order by the phase that
// reads them. The attention phase gives each (row, head) four warps: a
// thread to a key for the scores, a thread to 8 columns and every 16th key
// for P.V, so a cache row's loads are all in flight together. Every f32 sum
// has a fixed order, and a launch repeats bit for bit.
// Scratch (qkv, round(ctx) and round(x2), x2, the partials, mid) is a
// workspace the wrapper allocates; the grid barrier is eight arrival
// counters and a generation word in device memory, which every barrier
// leaves ready for the next, so two launches of this kernel must not run at
// the same time. A LayerNorm phase gives each row a block.
//
// The entry point returns cudaGetLastError() after its launch (or the
// launch's error); the Python wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 512;              // model width
constexpr int HD = 64;              // head_dim
constexpr int H = D / HD;           // 8 heads
constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;    // warps a block
constexpr int RC = 64;              // batch rows an item stages at a time
constexpr int KTILE = 128;          // k an item stages at a time
constexpr int KW = KTILE / NW;      // k of a staged tile a warp owns
constexpr int MAX_T = 2048;         // cache length (shared memory of phase 2)
constexpr int MAX_KS = 4;           // slices of K of the D-column products
constexpr int MAX_DEVICES = 64;
constexpr float SCALE = 0.125f;     // 1/sqrt(64), exact
static_assert(KW % 4 == 0, "a warp reads its k four at a time");

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

// The grid barrier's words: BAR_LANES arrival counters, 128 bytes apart (a
// block counts itself on counter blockIdx.x % BAR_LANES, so no counter takes
// every block's atomic), and the generation.
constexpr int BAR_LANES = 8;
constexpr int BAR_STRIDE = 32;
constexpr int BAR_GEN = BAR_LANES * BAR_STRIDE;

// Every block of the grid arrives, and none goes on before all have; the
// writes before it are seen by the reads after it. Block 0 waits until the
// counters add up to the grid, sets them back to 0 and then advances the
// generation, which every other block waits for.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* vbar = bar;
    const unsigned g = vbar[BAR_GEN];
    __threadfence();
    atomicAdd(bar + blockIdx.x % BAR_LANES * BAR_STRIDE, 1u);
    if (blockIdx.x == 0) {
      unsigned n;
      do {
        n = 0;
#pragma unroll
        for (int i = 0; i < BAR_LANES; ++i) n += vbar[i * BAR_STRIDE];
      } while (n < gridDim.x);
#pragma unroll
      for (int i = 0; i < BAR_LANES; ++i) atomicExch(bar + i * BAR_STRIDE, 0u);
      __threadfence();
      atomicAdd(bar + BAR_GEN, 1u);
    } else {
      while (vbar[BAR_GEN] == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
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
  // the workspace: f32 qkv (B, 3D), x2 (B, D) and the partial sums
  // (KS, B, D); in the compute dtype round(ctx), then round(x2) (B, D), and
  // mid (B, F)
  float *qkv, *x2, *part;
  void *act, *mid;
  unsigned* bar;
  int B, T, F, KS, write_cache;
  float eps;
};

// what an item does with its column sums
enum { EPI_QKV = 0, EPI_PART = 1, EPI_RELU = 2 };

// 16 bytes from global to shared memory; zeros when !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4 consecutive values of T from shared memory as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// shared memory of a product: two stages of RC input rows by KTILE k (in
// T, rows padded by 16 bytes) and KTILE rows of 16 bytes of W, then the
// warps' sums
template <typename T>
struct ProductSmem {
  static constexpr int ROW = KTILE * (int)sizeof(T) + 16;
  static constexpr int X = RC * ROW;
  static constexpr int STAGE = X + KTILE * 16;
  static constexpr int BYTES =
      2 * STAGE + NW * RC * Vec<T>::N * (int)sizeof(float);
};

// out[b, n] = sum_k in[b, k] * W[k, n] for every row b < B and every
// column n < N: W (K, N) and `in` (B, K) in the compute dtype T, row-major.
// Items of V columns by one of `ks` slices of K, spread over the grid. The
// next tile of the input rows and of the item's W columns is copied in by
// cp.async while this one is multiplied. EPI_QKV: qkv = sum + bias;
// EPI_PART: part[slice] = sum; EPI_RELU: mid = round(relu(sum + bias)).
template <typename T, int EPI>
__device__ void product(const T* __restrict__ in, const T* __restrict__ W,
                        int K, int N, int ks, const float* __restrict__ bias,
                        const Params& p, char* smem) {
  using S = ProductSmem<T>;
  constexpr int V = Vec<T>::N;
  constexpr int CHR = KTILE * (int)sizeof(T) / 16;   // 16-byte chunks a row
  float* red = reinterpret_cast<float*>(smem + 2 * S::STAGE);  // NW x RC x V
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = N / V;
  const int kchunk = ((K + ks - 1) / ks + 15) / 16 * 16;
  for (int item = blockIdx.x; item < groups * ks; item += gridDim.x) {
    const int g = item % groups, slice = item / groups;
    const int ka = slice * kchunk, kb = min(K, ka + kchunk);
    const int tiles = kb > ka ? (kb - ka + KTILE - 1) / KTILE : 0;
    const T* wcol = W + (size_t)g * V;
    for (int r0 = 0; r0 < p.B; r0 += RC) {
      // tile tt (k from ka + tt KTILE) of the rows and of W into stage st;
      // a multiple of 8 k, so a 16-byte chunk is all in or all out
      auto stage = [&](int tt, int st) {
        const int kt = ka + tt * KTILE, kn = min(KTILE, kb - kt);
        char* xs = smem + st * S::STAGE;
        for (int i = threadIdx.x; i < RC * CHR; i += THREADS) {
          const int r = i / CHR, c = i % CHR;
          const bool ok = r0 + r < p.B && c * 16 < kn * (int)sizeof(T);
          const T* src = ok ? in + (size_t)(r0 + r) * K + kt + c * 16 / sizeof(T)
                            : in;
          cp_async16(xs + r * S::ROW + c * 16, src, ok);
        }
        for (int i = threadIdx.x; i < KTILE; i += THREADS)
          cp_async16(xs + S::X + i * 16,
                     i < kn ? wcol + (size_t)(kt + i) * N : wcol, i < kn);
        cp_async_commit();
      };
      float acc[2][V];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[rr][v] = 0.f;
      if (tiles > 0) stage(0, 0);
      for (int tt = 0; tt < tiles; ++tt) {
        if (tt + 1 < tiles) stage(tt + 1, (tt + 1) & 1);
        else cp_async_commit();         // one group a tile
        cp_async_wait_1();              // this thread's part of tile tt
        __syncthreads();
        const char* xs = smem + (tt & 1) * S::STAGE;
        const T* rows = reinterpret_cast<const T*>(xs);
        const uint4* wt = reinterpret_cast<const uint4*>(xs + S::X);
        const int kn = min(KTILE, kb - ka - tt * KTILE);
#pragma unroll
        for (int q = 0; q < KW; q += 4) {
          const int kk = warp * KW + q;  // kn is a multiple of 8
          if (kk >= kn) break;
          float w[4][V];
#pragma unroll
          for (int u = 0; u < 4; ++u) unpack(wt[kk + u], w[u], rows);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float4 a = load4(rows + (lane + 32 * rr) * (S::ROW /
                                          (int)sizeof(T)) + kk);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[rr][v] = fmaf(a.x, w[0][v], acc[rr][v]);
              acc[rr][v] = fmaf(a.y, w[1][v], acc[rr][v]);
              acc[rr][v] = fmaf(a.z, w[2][v], acc[rr][v]);
              acc[rr][v] = fmaf(a.w, w[3][v], acc[rr][v]);
            }
          }
        }
        __syncthreads();                // stage tt & 1 is refilled next
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int v = 0; v < V; ++v)
          red[(warp * RC + lane + 32 * rr) * V + v] = acc[rr][v];
      __syncthreads();
      for (int o = threadIdx.x; o < RC * V; o += THREADS) {
        const int r = o / V, v = o % V, b = r0 + r, n = g * V + v;
        if (b >= p.B) continue;
        float sum = red[o];
#pragma unroll
        for (int w = 1; w < NW; ++w) sum += red[w * RC * V + o];
        if (EPI == EPI_QKV) {
          p.qkv[(size_t)b * 3 * D + n] = sum + bias[n];
        } else if (EPI == EPI_PART) {
          p.part[((size_t)slice * p.B + b) * D + n] = sum;
        } else {
          store(static_cast<T*>(p.mid) + (size_t)b * p.F + n,
                fmaxf(sum + bias[n], 0.f));
        }
      }
      __syncthreads();                  // red is spent
    }
  }
}

// floats of shared memory a quad of warps uses in the attention phase
__host__ __device__ inline int quad_floats(int T) {
  return (3 * HD + T + 16 * HD + 12 + 3) & ~3;
}

// Four warps (a quad, 128 threads; two quads a block) to each (row, head):
// a thread to a key for the scores and the softmax, then P.V with a thread
// to 8 columns of the head and every 16th key, the 16 partial sums added
// in order. The fresh rows go out rounded (and into the caches), round(ctx)
// into p.act.
template <typename T>
__device__ void attention(const Params& p, float* smem) {
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = warp >> 2, qw = warp & 3, qt = threadIdx.x & 127;
  const int T_ = p.T;
  const T* tnull = nullptr;
  float* qs = smem + quad * quad_floats(T_);
  float* kn = qs + HD;
  float* vn = kn + HD;
  float* pv = vn + HD;                  // 16 x HD partial contexts
  float* red = pv + 16 * HD;            // the warps' max, sum, p at pos
  float* sc = red + 12;                 // T scores, then probabilities
  T* kc = static_cast<T*>(p.kc);
  T* vc = static_cast<T*>(p.vc);
  for (int base = blockIdx.x * 2; base < p.B * H; base += gridDim.x * 2) {
    const int it = base + quad;
    const bool on = it < p.B * H;       // both quads meet every barrier
    const int b = on ? it / H : 0, h = it % H;
    const int ps0 = on ? p.pos[b] : -1;
    const int ps = ps0 >= 0 && ps0 < T_ ? ps0 : -1;
    if (on && qt < HD) {
      const float* qrow = p.qkv + (size_t)b * 3 * D + h * HD;
      const float kv = __ldcg(qrow + D + qt), vv = __ldcg(qrow + 2 * D + qt);
      qs[qt] = __ldcg(qrow + qt);
      kn[qt] = kv;
      vn[qt] = vv;
      const size_t at = (size_t)b * D + h * HD + qt;
      store(static_cast<T*>(p.knew) + at, kv);
      store(static_cast<T*>(p.vnew) + at, vv);
      if (p.write_cache && ps >= 0) {
        const size_t c = ((size_t)b * T_ + ps) * D + h * HD + qt;
        store(kc + c, kv);
        store(vc + c, vv);
      }
    }
    __syncthreads();
    // scores, a thread to a key; the t == pos term from the f32 fresh row
    float m = -INFINITY;
    const float* mrow = p.madd + (size_t)b * T_;
    for (int t = qt; on && t < T_; t += 128) {
      float s = 0.f;
      if (t == ps) {
        for (int e = 0; e < HD; ++e) s = fmaf(qs[e], kn[e], s);
      } else {
        // the row in halves of 32 columns, each half's loads together
        const uint4* row = reinterpret_cast<const uint4*>(
            kc + ((size_t)b * T_ + t) * D + h * HD);
        constexpr int NU = 32 / V;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 u[NU];
#pragma unroll
          for (int i = 0; i < NU; ++i) u[i] = row[half * NU + i];
#pragma unroll
          for (int i = 0; i < NU; ++i) {
            float f[V];
            unpack(u[i], f, tnull);
#pragma unroll
            for (int v = 0; v < V; ++v)
              s = fmaf(qs[half * 32 + i * V + v], f[v], s);
          }
        }
      }
      s = s * SCALE + mrow[t];
      sc[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    if (lane == 0) red[qw] = m;
    __syncthreads();
    m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
    float sum = 0.f, at = 0.f;
    for (int t = qt; on && t < T_; t += 128) {
      const float e = expf(sc[t] - m);
      sum += e;
      if (t == ps) at = e;
      sc[t] = t == ps ? 0.f : e;
    }
    sum = warp_sum(sum);
    at = warp_sum(at);
    if (lane == 0) {
      red[4 + qw] = sum;
      red[8 + qw] = at;
    }
    __syncthreads();
    const float den = ((red[4] + red[5]) + red[6]) + red[7];
    const float ppos = ((red[8] + red[9]) + red[10]) + red[11];
    // P.V: thread (tg, dg) sums p[t] v[t, 8 dg .. 8 dg + 7] over t = tg,
    // tg + 16, ...; a probability of exactly 0 (a masked key, the t == pos
    // slot) adds nothing and its row is not read
    const int dg = qt & 7, tg = qt >> 3;
    float acc[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] = 0.f;
    const T* vcol = vc + (size_t)b * T_ * D + h * HD + dg * 8;
    for (int t0 = tg; on && t0 < T_; t0 += 64) {
      float pt[4], f[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + 16 * u;
        pt[u] = t < T_ ? sc[t] : 0.f;
        if (pt[u] != 0.f) {
          const uint4* src = reinterpret_cast<const uint4*>(vcol + (size_t)t * D);
#pragma unroll
          for (int i = 0; i < 8 / V; ++i) unpack(src[i], f[u] + i * V, tnull);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (pt[u] != 0.f) {
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[v] = fmaf(pt[u], f[u][v], acc[v]);
        }
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) pv[tg * HD + dg * 8 + v] = acc[v];
    __syncthreads();
    if (on && qt < HD) {
      float c = pv[qt];
#pragma unroll
      for (int g = 1; g < 16; ++g) c += pv[g * HD + qt];
      store(static_cast<T*>(p.act) + (size_t)b * D + h * HD + qt,
            fmaf(ppos, vn[qt], c) / den);
    }
    __syncthreads();                    // this item's shared memory is spent
  }
}

// the sum of x over the block, every thread's in warp order, then the
// warps' in order; red: NW floats of shared memory
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) t += red[w];
  __syncthreads();                      // red is spent
  return t;
}

// LayerNorm of one row held by the block: thread i holds columns i and
// i + THREADS
__device__ __forceinline__ void block_layer_norm(float (&v)[2],
                                                 const float* scale,
                                                 const float* bias, float eps,
                                                 float* red) {
  const float mean = block_sum(v[0] + v[1], red) / D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float c = v[j] - mean;
    sq = fmaf(c, c, sq);
  }
  const float rstd = rsqrtf(block_sum(sq, red) / D + eps);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = threadIdx.x + j * THREADS;
    v[j] = (v[j] - mean) * rstd * scale[col] + bias[col];
  }
}

// a block to each row: v = base + (sum of the KS partials + bias), then
// LN1, + cross and LN2 (FIRST; base x, out x2 in f32 and rounded), or LN3
// (base x2, out rounded). Every load of a row is issued before the first
// sum.
template <typename T, bool FIRST>
__device__ void norms(const Params& p, float* smem) {
  static_assert(D == 2 * THREADS, "a thread holds two columns");
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = threadIdx.x + j * THREADS;
      const size_t at = (size_t)b * D + col;
      float part[MAX_KS];
#pragma unroll
      for (int sl = 0; sl < MAX_KS; ++sl)
        part[sl] = sl < p.KS ? __ldcg(p.part + (size_t)sl * p.B * D + at) : 0.f;
      float s = part[0];
#pragma unroll
      for (int sl = 1; sl < MAX_KS; ++sl)
        if (sl < p.KS) s += part[sl];
      const float base = FIRST ? to_f32(static_cast<const T*>(p.x)[at])
                               : __ldcg(p.x2 + at);
      v[j] = base + (s + (FIRST ? p.bo : p.b2)[col]);
    }
    if (FIRST) {
      block_layer_norm(v, p.ln1s, p.ln1b, p.eps, smem);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        v[j] += p.cross[(size_t)b * D + threadIdx.x + j * THREADS];
      block_layer_norm(v, p.ln2s, p.ln2b, p.eps, smem);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t at = (size_t)b * D + threadIdx.x + j * THREADS;
        p.x2[at] = v[j];
        store(static_cast<T*>(p.act) + at, v[j]);
      }
    } else {
      block_layer_norm(v, p.ln3s, p.ln3b, p.eps, smem);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        store(static_cast<T*>(p.xo) + (size_t)b * D + threadIdx.x + j * THREADS,
              v[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) decode_layer_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  float* fsmem = reinterpret_cast<float*>(smem);
  const T* act = static_cast<const T*>(p.act);
  product<T, EPI_QKV>(static_cast<const T*>(p.x),
                      static_cast<const T*>(p.wqkv), D, 3 * D, 1, p.bqkv, p,
                      smem);
  grid_sync(p.bar);
  attention<T>(p, fsmem);
  grid_sync(p.bar);
  product<T, EPI_PART>(act, static_cast<const T*>(p.wo), D, D, p.KS,
                       nullptr, p, smem);
  grid_sync(p.bar);
  norms<T, true>(p, fsmem);
  grid_sync(p.bar);
  product<T, EPI_RELU>(act, static_cast<const T*>(p.w1), D, p.F, 1, p.b1, p,
                       smem);
  grid_sync(p.bar);
  product<T, EPI_PART>(static_cast<const T*>(p.mid),
                       static_cast<const T*>(p.w2), p.F, D, p.KS, nullptr, p,
                       smem);
  grid_sync(p.bar);
  norms<T, false>(p, fsmem);
}

template <typename T>
size_t smem_bytes(int t) {
  const size_t attn = (size_t)2 * quad_floats(t) * sizeof(float);
  const size_t prod = ProductSmem<T>::BYTES;
  return prod > attn ? prod : attn;
}

template <typename T>
int launch(Params p, int grid, void* stream) {
  const size_t smem = smem_bytes<T>(p.T);
  // the largest shared memory a launch has asked for, set once a card
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(decode_layer_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)decode_layer_kernel<T>,
                                  dim3(grid), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as in the head of this file; every tensor contiguous and 16-byte
// aligned. d and heads must be 512 and 8, f a multiple of 8, 1 <= t <= 2048.
// flags: bit 0, the compute dtype is bf16 (else f32); bit 1, also write the
// fresh rows into kc and vc at pos. A pos outside [0, T) matches no column.
// grid: blocks, all resident at once; ks: the slices of K of the two
// products with D columns. workspace: `workspace_bytes` bytes, at least
// 4 (3D + D + ks D) B + size (D + f) B with size the compute dtype's bytes.
// barrier: BAR_GEN + 1 unsigned words, 0 before the first launch; each
// launch leaves the counters at 0 and advances the generation word.
extern "C" int mit_fused_decode_layer(
    const void* x, const void* pos, const void* madd, void* kc, void* vc,
    const void* cross, const void* wqkv, const void* bqkv, const void* wo,
    const void* bo, const void* ln1s, const void* ln1b, const void* ln2s,
    const void* ln2b, const void* ln3s, const void* ln3b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* xo, void* knew,
    void* vnew, void* workspace, void* barrier, int b, int t, int d,
    int heads, int f, int flags, int grid, int ks, long long workspace_bytes,
    float eps, void* stream) {
  const bool bf16 = flags & 1;
  const long long size = bf16 ? 2 : 4;
  const long long need =
      4LL * (3 * D + D + (long long)ks * D) * b + size * (D + f) * b;
  if (d != D || heads != H || b < 1 || t < 1 || t > MAX_T || f < 8 ||
      f % 8 != 0 || grid < 1 || ks < 1 || ks > MAX_KS ||
      workspace_bytes < need)
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
  float* ws = static_cast<float*>(workspace);
  p.qkv = ws;
  p.x2 = p.qkv + (size_t)b * 3 * D;
  p.part = p.x2 + (size_t)b * D;
  p.act = p.part + (size_t)ks * b * D;
  p.mid = static_cast<char*>(p.act) + (size_t)size * b * D;
  p.bar = static_cast<unsigned*>(barrier);
  p.B = b;
  p.T = t;
  p.F = f;
  p.KS = ks;
  p.write_cache = (flags >> 1) & 1;
  p.eps = eps;
  return bf16 ? launch<__nv_bfloat16>(p, grid, stream)
              : launch<float>(p, grid, stream);
}
