// quantize_rows: per-row symmetric int8 quantization of an (M, K) f32 or
// bf16 matrix, with an optional LayerNorm prologue, for sm_90a.
//
// Replaces the row quantizer of the TPU int8 kernels, _quantize_rows in
// mit_tpu/ops/pallas_int8_mlp.py (:72, the prologue of _linear_kernel and
// _mlp_kernel), and with the LayerNorm the LN + quantize prologue of the
// whole-layer kernel (_ln and _attn_body / _mlp_body in
// mit_tpu/ops/pallas_int8_layer.py:42-45, 89-90, 136-137). Per row:
//   [y = (x - mean) * (1 / sqrt(var + eps)) * ln_scale + ln_bias]   in f32
//   amax = max(max |y|, 1e-8)
//   code = clip(rint(y * (127 / amax)), -127, 127)                   int8
//   scale = amax * (1 / 127)                                          f32
// Rounding is half to even (rintf). The multiplies, the 127 / amax divide
// and the LayerNorm's elementwise steps use the _rn intrinsics, so nvcc
// contracts nothing into an FMA and the codes and scales are bitwise those
// of the plain PyTorch version for the same f32 row (build without
// --use_fast_math, so that the divide and sqrt stay IEEE). With the
// LayerNorm, its sums run in another order than the plain version's, so a
// code can move by one where y * inv lies within an ulp of a half.
//
// What bounds it on the H100: device memory. It reads M*K elements and
// writes M*K bytes and M scales; at the fc2 input of ViT-B at batch 64
// (12,608 x 3,072 f32) that is 194 MB, about 60 us at 3.35 TB/s. A block
// owns one row and stages it in shared memory as f32 (K*4 bytes, 12 KB at
// K = 3,072), so the LayerNorm's mean, variance and normalise passes and
// the amax and quantize passes read shared memory, and the row is read
// from device memory once. The row max is one in-block reduction (warp
// shuffles, then one word per warp). int8_mlp_fused.cu runs the MLP half's
// two quantizers on chip (the hidden's row max across a cluster, the
// LayerNorm's sums in this kernel's order) where ops/int8_mlp.py
// mlp_kernel_for picks it: a few images and the CLS rows. At batch 64 the
// MLP half still runs here and in int8_gemm.cu, faster on an H100.
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum (or max) of one value per thread over the block; every thread gets
// the result. `red` holds one word per warp.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                     // red may still be read from before
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, int8_t* __restrict__ x8,
                     float* __restrict__ sx, int K, float eps) {
  extern __shared__ float row[];
  __shared__ float red[WARPS];
  const size_t base = (size_t)blockIdx.x * K;

  for (int i = threadIdx.x; i < K; i += THREADS) row[i] = to_f32(x[base + i]);

  // Each thread reads back only the elements it wrote, so the passes below
  // need no barrier of their own; block_reduce synchronises.
  if (ln_s != nullptr) {
    float s = 0.f;
    for (int i = threadIdx.x; i < K; i += THREADS) s += row[i];
    const float mean = __fdiv_rn(block_reduce<false>(s, red), (float)K);
    float v = 0.f;
    for (int i = threadIdx.x; i < K; i += THREADS) {
      const float c = __fsub_rn(row[i], mean);
      v = __fadd_rn(v, __fmul_rn(c, c));
    }
    const float var = __fdiv_rn(block_reduce<false>(v, red), (float)K);
    const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    for (int i = threadIdx.x; i < K; i += THREADS)
      row[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(row[i], mean), r),
                                   ln_s[i]),
                         ln_b[i]);
  }

  float a = 0.f;
  for (int i = threadIdx.x; i < K; i += THREADS) a = fmaxf(a, fabsf(row[i]));
  const float amax = fmaxf(block_reduce<true>(a, red), 1e-8f);
  const float inv = __fdiv_rn(127.f, amax);
  for (int i = threadIdx.x; i < K; i += THREADS) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(row[i], inv)), -127.f), 127.f);
    x8[base + i] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = __fmul_rn(amax, 1.f / 127.f);
}

template <typename T>
int launch(const void* x, const void* ln_s, const void* ln_b, void* x8,
           void* sx, int M, int K, float eps, void* stream) {
  quantize_rows_kernel<T>
      <<<M, THREADS, K * sizeof(float), (cudaStream_t)stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(ln_s),
          static_cast<const float*>(ln_b), static_cast<int8_t*>(x8),
          static_cast<float*>(sx), K, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) contiguous; ln_s, ln_b: (K,) f32, or both null for no
// LayerNorm; x8: (M, K) int8; sx: (M,) f32. K * 4 bytes must fit the
// 48 KB of shared memory a block gets without opting in.
extern "C" int mit_quantize_rows_f32(const void* x, const void* ln_s,
                                     const void* ln_b, void* x8, void* sx,
                                     int M, int K, float eps, void* stream) {
  return launch<float>(x, ln_s, ln_b, x8, sx, M, K, eps, stream);
}

extern "C" int mit_quantize_rows_bf16(const void* x, const void* ln_s,
                                      const void* ln_b, void* x8, void* sx,
                                      int M, int K, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, ln_s, ln_b, x8, sx, M, K, eps, stream);
}
