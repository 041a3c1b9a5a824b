// int8_gemm: A8 (M, K) int8 . W8 (K, N) int8 -> exact int32, with the
// dequantize epilogue of the encoder's int8 kernels, for sm_90a.
//
// Replaces the GEMM and epilogue of the TPU int8 kernels: _linear_kernel
// (mit_tpu/ops/pallas_int8_mlp.py:212, behind int8_linear), the two GEMMs
// of _mlp_kernel (:88, behind fused_int8_mlp) and the four GEMMs of the
// whole-layer kernel (_dq in mit_tpu/ops/pallas_int8_layer.py:48, behind
// fused_int8_vit_layer and fused_int8_vit_layer_split). Per element:
//   acc = sum_k a8[m, k] * w8[k, n]                         exact int32
//   y   = float(acc) * (sx[m] * sw[n]) [+ bias[n]]           f32
//   y   = gelu(y) | quick_gelu(y)                            (optional)
//   y   = res[m, n] + y                                      (optional)
// written as f32 or bf16, or acc itself (out_kind 2, for checking). GELU
// is the int8 kernels' clamped odd polynomial for erf (pallas_int8_mlp.py
// :39-69), not exact erf. The epilogue's products and sums use the _rn
// intrinsics in the plain version's order: nvcc contracts none of them
// into an FMA, so the output is the plain version's up to the last ulp of
// expf in quick_gelu.
//
// What bounds it on the H100. The encoder's GEMMs at batch 64 are
// M = 12,608 rows against K x N of 768 x 2304, 768 x 768, 768 x 3072 and
// 3072 x 768: about 1.07 T multiply-adds per encoder pass, which makes
// them compute-bound (a 128 x 128 tile does 128 int8 MACs per byte it
// loads, far above the card's 590 ops/byte int8 ridge for the whole
// matrix). The int8 tensor cores are reached here through mma.sync
// m16n8k32 (s8 . s8 -> s32), the Ampere-style warp-level MMA that Hopper
// still runs, not through wgmma: a simple, right kernel first. A block of
// 8 warps owns a 128 x 128 output tile (each warp 64 x 32: 4 x 4 mma
// tiles, 64 int32 accumulators a thread) and walks K in 64-byte steps
// through two shared-memory stages filled by cp.async, so the next step's
// loads overlap this step's MMAs. Shared-memory rows are padded from 64 to
// 80 bytes, which makes the 32-bit fragment loads conflict-free. The
// mma.sync B operand wants K contiguous for each output column, so the
// weight is stored that way (the port's QuantizedLinear keeps w8 as a
// K-contiguous (K, N) view, made once at load). wgmma with TMA loads, a
// deeper pipeline and a persistent grid are later work.
//
// Ragged edges: rows past M and columns past N are zero-filled by
// cp.async (src-size 0) and not stored; K must be a multiple of 16 (one
// cp.async chunk), N a multiple of 8; the wrapper raises otherwise.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;            // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 16;            // bytes per shared-memory row
constexpr int TILE = BM * LDS;          // bytes of one operand's stage

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2 };
enum { RES_NONE = 0, RES_F32 = 1, RES_BF16 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_S32 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// One 128-row x 64-byte tile of a K-contiguous int8 matrix with `rows`
// rows into shared memory: 512 chunks of 16 bytes, two per thread.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int r0, int rows, int k0, int K) {
#pragma unroll
  for (int c = threadIdx.x; c < BM * BK / 16; c += THREADS) {
    const int r = c >> 2, kc = (c & 3) * 16;
    const bool valid = r0 + r < rows && k0 + kc < K;
    const int8_t* g = valid ? src + (size_t)(r0 + r) * K + k0 + kc : src;
    cp_async16(dst + r * LDS + kc, g, valid);
  }
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

__device__ __forceinline__ float epilogue(int acc, float s, float sw,
                                          const float* bias, int n, int act,
                                          const void* res, int res_kind,
                                          size_t idx) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(s, sw));
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (act == ACT_GELU) {
    y = __fmul_rn(__fmul_rn(0.5f, y),
                  __fadd_rn(1.f, erf_poly(__fmul_rn(y, 0.7071067811865475f))));
  } else if (act == ACT_QUICK_GELU) {
    y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, y)))));
  }
  if (res_kind == RES_F32) {
    y = __fadd_rn(static_cast<const float*>(res)[idx], y);
  } else if (res_kind == RES_BF16) {
    y = __fadd_rn(
        __bfloat162float(static_cast<const __nv_bfloat16*>(res)[idx]), y);
  }
  return y;
}

template <int OUT>
__global__ void __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, const void* __restrict__ res,
                 void* __restrict__ out, int M, int N, int K, int act,
                 int res_kind) {
  __shared__ __align__(16) int8_t smem[2][2][TILE];   // [stage][A, B]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: rows wm*64, cols wn*32
  const int g = lane >> 2, tig = lane & 3;   // mma groupID, thread in group

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (K + BK - 1) / BK;
  load_tile(smem[0][0], A, m0, M, 0, K);
  load_tile(smem[0][1], Bt, n0, N, 0, K);
  cp_async_commit();

  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      const int st = (kt + 1) & 1;
      load_tile(smem[st][0], A, m0, M, (kt + 1) * BK, K);
      load_tile(smem[st][1], Bt, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();        // possibly empty: keeps the group count even
    cp_async_wait_1();        // every group but the newest: stage kt is in
    __syncthreads();

    const int8_t* As = smem[kt & 1][0];
    const int8_t* Bs = smem[kt & 1][1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = As + (wm * 64 + i * 16 + g) * LDS + kk + tig * 4;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LDS);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn * 32 + j * 8 + g) * LDS + kk + tig * 4;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();          // stage kt is refilled two steps from now
  }

  // Epilogue: accumulator e of tile (i, j) is row g (+8 for e >= 2),
  // column 2 * tig + (e & 1) of that 16 x 8 tile.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float s = OUT == OUT_S32 ? 0.f : sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tig * 2;
        if (n >= N) continue;           // N % 8 == 0: n + 1 < N as well
        const int v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        const size_t idx = (size_t)m * N + n;
        if (OUT == OUT_S32) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + idx) =
              make_int2(v0, v1);
          continue;
        }
        const float y0 =
            epilogue(v0, s, sw[n], bias, n, act, res, res_kind, idx);
        const float y1 =
            epilogue(v1, s, sw[n + 1], bias, n + 1, act, res, res_kind, idx + 1);
        if (OUT == OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
              make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + idx) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

}  // namespace

// a8: (M, K) int8, row-major; bt: the weight as (N, K) int8, row-major
// (w8 (K, N) stored K-contiguous); sx: (M,) f32; sw: (N,) f32; bias: (N,)
// f32 or null; res: (M, N) f32 (res_kind 1) or bf16 (2), or null (0);
// out: (M, N) f32 (out_kind 0), bf16 (1) or raw int32 accumulators (2).
// act: 0 none, 1 gelu (polynomial erf), 2 quick_gelu. K % 16 == 0,
// N % 8 == 0, a8 and bt 16-byte aligned.
extern "C" int mit_int8_gemm(const void* a8, const void* bt, const void* sx,
                             const void* sw, const void* bias, const void* res,
                             void* out, int M, int N, int K, int act,
                             int res_kind, int out_kind, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto* s = (cudaStream_t)stream;
  const auto* A = static_cast<const int8_t*>(a8);
  const auto* B = static_cast<const int8_t*>(bt);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fw = static_cast<const float*>(sw);
  const auto* fb = static_cast<const float*>(bias);
  if (out_kind == OUT_F32) {
    int8_gemm_kernel<OUT_F32><<<grid, THREADS, 0, s>>>(
        A, B, fx, fw, fb, res, out, M, N, K, act, res_kind);
  } else if (out_kind == OUT_BF16) {
    int8_gemm_kernel<OUT_BF16><<<grid, THREADS, 0, s>>>(
        A, B, fx, fw, fb, res, out, M, N, K, act, res_kind);
  } else if (out_kind == OUT_S32) {
    int8_gemm_kernel<OUT_S32><<<grid, THREADS, 0, s>>>(
        A, B, fx, fw, fb, res, out, M, N, K, act, res_kind);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
