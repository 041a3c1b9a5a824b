// encoder_fused: the float encoder's elementwise passes between its
// products, for sm_90a. Two forward-only kernels:
//
//   add_layer_norm   at each sublayer boundary of a pre-LN layer:
//                    y = x + (a + bias),  h = LayerNorm(y) * scale + shift
//   bias_act         after fc1:  out = act(a + bias), act = GELU (erf) or
//                    quick_gelu
//
// Replaces no Pallas kernel: these are the elementwise fusions that XLA
// makes around the products of the JAX package's float encoder
// (mit_tpu/models/vision.py, vision_forward: layer_norm, the bias adds,
// the residual adds and the activation). PyTorch runs them as separate
// passes: at CLIP ViT-L/14's (64 x 257, 1024) each LayerNorm makes about
// ten passes over f32 copies of the row, and each bias, residual and
// activation step one more.
//
// Numerics. Both kernels repeat the roundings of the PyTorch composition
// (ops/encoder_fused.py, *_reference) in registers: the f32 bias rounds to
// the compute dtype, the bias add and the residual add round to it, and
// the activation rounds where the composition's separate ops do (quick_gelu:
// 1.702 * v, the sigmoid and the product). The arithmetic uses the _rn
// intrinsics, so nvcc contracts nothing into an FMA, and the library's
// expf / erff (built without --use_fast_math), so y and bias_act's output
// are bitwise the composition's on the card. The LayerNorm takes the f32
// mean and biased variance of the rounded row in another order than
// PyTorch's reductions, so h may differ by one rounding of the compute
// dtype (and by f32's noise, about 1e-7 of the terms, where the scale's and
// the shift's terms cancel and h lies near 0).
//
// What bounds them on the H100: device memory. add_layer_norm reads x and
// a and writes y and h, 8 bytes an element in bf16: 135 MB at CLIP-L's
// (16448, 1024), about 40 us at 3.35 TB/s. A warp owns a row and holds it
// in registers (16-byte loads, CHUNKS of them a lane: 5 at D 1280 in bf16),
// so the row is read from device memory once and the variance is a second
// pass over registers; 8 rows a block of 256 threads. The biases and the
// LayerNorm's scale and shift are read in f32 from the parameter tree
// through the read-only cache. bias_act reads and writes 4 bytes an
// element in bf16: 270 MB at (16448, 4096), about 81 us; one 16-byte
// vector a thread.
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;                 // warps a block, one row each
constexpr int THREADS = ROWS * 32;
constexpr int ACT_THREADS = 256;
constexpr int ACT_GELU = 1, ACT_QUICK_GELU = 2;   // ops/int8_mlp.py ACTS

// values in 16 bytes
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// the value as the compute dtype holds it
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// N f32 values of a parameter row, 16 bytes a load
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) load16(p + i, v + i);
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One warp a row of D = nchunks * V values; lane l holds chunks l, l + 32,
// ... (CHUNKS of them, the last ones past nchunks empty). x, bias: null for
// none; ln_s null: no LayerNorm (h not written); y null: y not written.
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(THREADS)
add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ a,
                      const float* __restrict__ bias,
                      const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, T* __restrict__ y,
                      T* __restrict__ h, int M, int D, long long x_stride,
                      long long a_stride, float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= M) return;                 // the whole warp
  const int nchunks = D / V;
  const T* xr = x == nullptr ? nullptr : x + row * x_stride;
  const T* ar = a + row * a_stride;
  const size_t out = (size_t)row * D;

  float v[CHUNKS][V];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = lane + 32 * j;
    if (c >= nchunks) continue;
    const int col = c * V;
    load16(ar + col, v[j]);
    if (bias != nullptr) {
      float b[V];
      load_f32<V>(bias + col, b);
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[j][k] = rnd(__fadd_rn(v[j][k], rnd(b[k], T())), T());
    }
    if (xr != nullptr) {
      float r[V];
      load16(xr + col, r);
#pragma unroll
      for (int k = 0; k < V; ++k) v[j][k] = rnd(__fadd_rn(r[k], v[j][k]), T());
    }
    if (y != nullptr) store16(y + out + col, v[j]);
#pragma unroll
    for (int k = 0; k < V; ++k) s = __fadd_rn(s, v[j][k]);
  }
  if (ln_s == nullptr) return;

  const float mean = __fdiv_rn(warp_sum(s), (float)D);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    if (lane + 32 * j >= nchunks) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float c = __fsub_rn(v[j][k], mean);
      q = __fadd_rn(q, __fmul_rn(c, c));
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)D), eps));
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = lane + 32 * j;
    if (c >= nchunks) continue;
    const int col = c * V;
    float g[V], b[V], o[V];
    load_f32<V>(ln_s + col, g);
    load_f32<V>(ln_b + col, b);
#pragma unroll
    for (int k = 0; k < V; ++k)
      o[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][k], mean), r), g[k]),
                       b[k]);
    store16(h + out + col, o);
  }
}

// act(a + bias) as the composition rounds it: v = a + bias; quick_gelu
// v * sigmoid(1.702 * v) with each of the three steps rounded, GELU
// v * 0.5 * (1 + erf(v / sqrt(2))) in f32 and rounded once (ATen's
// formulas for F.gelu and torch.sigmoid).
template <typename T, int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == ACT_QUICK_GELU) {
    const float t = rnd(__fmul_rn(v, 1.702f), T());
    // 1 / u correctly rounded: the IEEE divide's result, in fewer steps
    const float sig = rnd(__frcp_rn(__fadd_rn(1.f, expf(-t))), T());
    return __fmul_rn(v, sig);
  }
  return __fmul_rn(__fmul_rn(v, 0.5f),
                   __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752440f))));
}

template <typename T, int ACT>
__global__ void __launch_bounds__(ACT_THREADS)
bias_act_kernel(const T* __restrict__ a, const float* __restrict__ bias,
                T* __restrict__ out, unsigned nvec, unsigned fvec) {
  constexpr int V = Vec<T>::N;
  const unsigned i = blockIdx.x * ACT_THREADS + threadIdx.x;
  if (i >= nvec) return;
  float v[V], b[V];
  load16(a + (size_t)i * V, v);
  load_f32<V>(bias + (i % fvec) * V, b);
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = act<T, ACT>(rnd(__fadd_rn(v[k], rnd(b[k], T())), T()));
  store16(out + (size_t)i * V, v);
}

template <typename T, int CHUNKS>
void launch_ln(const void* x, const void* a, const void* bias,
               const void* ln_s, const void* ln_b, void* y, void* h, int M,
               int D, long long x_stride, long long a_stride, float eps,
               cudaStream_t stream) {
  add_layer_norm_kernel<T, CHUNKS>
      <<<(M + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(a),
          static_cast<const float*>(bias), static_cast<const float*>(ln_s),
          static_cast<const float*>(ln_b), static_cast<T*>(y),
          static_cast<T*>(h), M, D, x_stride, a_stride, eps);
}

// CHUNKS = ceil(D / (32 V)), 1 to 8 in bf16 and 1 to 16 in f32: D <= 2048
template <typename T>
int dispatch_ln(const void* x, const void* a, const void* bias,
                const void* ln_s, const void* ln_b, void* y, void* h, int M,
                int D, long long x_stride, long long a_stride, float eps,
                cudaStream_t stream) {
  const int chunks = (D / Vec<T>::N + 31) / 32;
  bool launched = true;
#define MIT_LN_CASE(C)                                                    \
  case C:                                                                 \
    launch_ln<T, C>(x, a, bias, ln_s, ln_b, y, h, M, D, x_stride,         \
                    a_stride, eps, stream);                               \
    break;
  switch (chunks) {
    MIT_LN_CASE(1) MIT_LN_CASE(2) MIT_LN_CASE(3) MIT_LN_CASE(4)
    MIT_LN_CASE(5) MIT_LN_CASE(6) MIT_LN_CASE(7) MIT_LN_CASE(8)
    default: launched = false;
  }
  if constexpr (Vec<T>::N == 4) {
    if (!launched) {
      launched = true;
      switch (chunks) {
        MIT_LN_CASE(9) MIT_LN_CASE(10) MIT_LN_CASE(11) MIT_LN_CASE(12)
        MIT_LN_CASE(13) MIT_LN_CASE(14) MIT_LN_CASE(15) MIT_LN_CASE(16)
        default: launched = false;
      }
    }
  }
#undef MIT_LN_CASE
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_act(const void* a, const void* bias, void* out, int M, int F,
                 int act_code, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const unsigned nvec = (unsigned)((size_t)M * F / V);
  const unsigned blocks = (nvec + ACT_THREADS - 1) / ACT_THREADS;
  const T* in = static_cast<const T*>(a);
  const float* b = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  if (act_code == ACT_GELU)
    bias_act_kernel<T, ACT_GELU><<<blocks, ACT_THREADS, 0, stream>>>(
        in, b, o, nvec, (unsigned)(F / V));
  else if (act_code == ACT_QUICK_GELU)
    bias_act_kernel<T, ACT_QUICK_GELU><<<blocks, ACT_THREADS, 0, stream>>>(
        in, b, o, nvec, (unsigned)(F / V));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, D) rows x_stride elements apart, or null (no residual); a: (M, D)
// rows a_stride apart; bias: (D,) f32 or null; ln_s, ln_b: (D,) f32, or
// both null (no LayerNorm, h not written); y, h: (M, D) contiguous, y null
// where it is not written. dtype 0 f32, 1 bf16; D a multiple of 16 bytes'
// values, at most 2048; rows and pointers 16-byte aligned.
extern "C" int mit_add_layer_norm(const void* x, const void* a,
                                  const void* bias, const void* ln_s,
                                  const void* ln_b, void* y, void* h, int M,
                                  int D, long long x_stride,
                                  long long a_stride, int dtype, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_ln<__nv_bfloat16>(x, a, bias, ln_s, ln_b, y, h, M, D,
                                      x_stride, a_stride, eps, s);
  return dispatch_ln<float>(x, a, bias, ln_s, ln_b, y, h, M, D, x_stride,
                            a_stride, eps, s);
}

// a, out: (M, F) contiguous; bias: (F,) f32; act 1 GELU (erf), 2
// quick_gelu; dtype 0 f32, 1 bf16; F a multiple of 16 bytes' values and
// M * F / (values in 16 bytes) below 2^32.
extern "C" int mit_bias_act(const void* a, const void* bias, void* out, int M,
                            int F, int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_act<__nv_bfloat16>(a, bias, out, M, F, act, s);
  return dispatch_act<float>(a, bias, out, M, F, act, s);
}
