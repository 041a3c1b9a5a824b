// What the int8 kernels (int8_gemm.cu, int8_mlp_fused.cu) share, for
// sm_90a: the epilogue's numbers (the polynomial erf, the dequantize, bias,
// activation and residual steps with the _rn intrinsics in the plain
// version's order), mbarriers, TMA loads of K-major int8 tiles in the
// 128-byte swizzle and their tensor maps. Everything has internal linkage.

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int TMA_K = 128;              // bytes of K a TMA box (a swizzle row)

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2 };
enum { RES_NONE = 0, RES_F32 = 1, RES_BF16 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_S32 = 2 };

// keeps the compiler from moving reads or writes of d across the wgmma
// fences and waits around it
template <int NT>
__device__ __forceinline__ void wg_touch_s32(int (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// rows [row, row + box rows) x bytes [k, k + TMA_K) of a tensor map's matrix
// into shared memory, completing `bytes` of the barrier's phase
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int k, int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(k), "r"(row),
      "r"(bar)
      : "memory");
}

// erf(z) = z * P(z^2), clamped to |z| <= 3 (pallas_int8_mlp.py:39-69)
__device__ __forceinline__ float erf_poly(float z) {
  z = fminf(fmaxf(z, -3.f), 3.f);
  const float u = __fmul_rn(z, z);
  float p = 3.8978985791e-06f;
  p = __fadd_rn(__fmul_rn(p, u), -1.4152522556e-04f);
  p = __fadd_rn(__fmul_rn(p, u), 2.1716450163e-03f);
  p = __fadd_rn(__fmul_rn(p, u), -1.8627491535e-02f);
  p = __fadd_rn(__fmul_rn(p, u), 1.0037558057e-01f);
  p = __fadd_rn(__fmul_rn(p, u), -3.6740184481e-01f);
  p = __fadd_rn(__fmul_rn(p, u), 1.1265645860e+00f);
  return __fmul_rn(z, p);
}

// ACT is a template argument so that an element's code holds its own
// activation alone (a runtime choice is compiled into predicated code that
// computes every activation for every element)
template <int ACT>
__device__ __forceinline__ float epilogue(int acc, float s, float sw,
                                          bool has_bias, float bias,
                                          bool has_res, float res) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(s, sw));
  if (has_bias) y = __fadd_rn(y, bias);
  if (ACT == ACT_GELU) {
    y = __fmul_rn(__fmul_rn(0.5f, y),
                  __fadd_rn(1.f, erf_poly(__fmul_rn(y, 0.7071067811865475f))));
  } else if (ACT == ACT_QUICK_GELU) {
    y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, y)))));
  }
  return has_res ? __fadd_rn(res, y) : y;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the tensor map of a K-contiguous int8 matrix with `rows` rows: boxes of
// `box_rows` rows by TMA_K bytes in the 128-byte swizzle, zeros past the
// edges
cudaError_t encode_map(CUtensorMap* map, const void* base, int rows, int K,
                       int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {TMA_K, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                            const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
