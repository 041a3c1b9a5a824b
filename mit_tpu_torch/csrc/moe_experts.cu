// Grouped SwiGLU experts of a mixture-of-experts layer (Kimi-VL-A3B's
// language model, DeepSeek-V3's layout): for every expert e with rows,
//
//   hidden[r] = bf16(silu(x[token[r]] . Wg[e]) * (x[token[r]] . Wu[e]))
//   y[r]      = bf16(hidden[r] . Wd[e])
//
// over the routes r in offsets[e] .. offsets[e + 1] (the routes sorted by
// expert; ops/moe.py `group_routes`). Replaces no TPU kernel: the JAX
// package has no expert layer. It was added because the alternative, a
// library product an expert and a matrix, is 64 x 3 launches a layer and
// some 5,000 a decode step.
//
// What bounds it on the H100: at decode (64 rows x 6 routes = 384 routes
// over 64 experts, about 6 rows an expert) the bytes: every hit expert's
// three 2048 x 1408 bf16 matrices, 17.3 MB, read once a step. At prefill
// (30,720 routes, about 480 rows an expert) the operations, 531 GFLOP a
// layer. The design serves both with one tiling on the tensor cores
// (mma.sync m16n8k16 bf16, f32 sums): a block takes 64 rows of one
// expert and 64 output columns, and walks K in 64-deep stages through a
// three-stage cp.async ring in shared memory. The grid is (row tiles,
// column tiles); the row tiles are counted on the device from the offsets,
// so the host launches without reading anything back: the grid's first
// dimension is an upper bound (ceil(R / 64) + E) and blocks past the last
// tile return at once. An expert with no rows has no tile and its weights
// are never read. At decode one row tile an expert, so each weight tile is
// read by one block; at prefill the row tiles of one expert sit side by
// side in the grid and share its weight tiles through L2.
//
// Two launches, gate-and-up then down, with the bf16 hidden between them
// in device memory (the composition's rounding point).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;        // rows of one expert a block: 4 warps x 16
constexpr int BN = 64;        // output columns a block
constexpr int BK = 64;        // depth a stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LD = 72;        // a shared row: 64 values + 8, 144 bytes, so
                              // ldmatrix's 8 rows fall in 8 distinct banks

template <int NB>
struct Smem {
  static constexpr int A = BM * LD;             // values a stage
  static constexpr int B = BK * LD;             // values a stage a matrix
  static constexpr int STAGE = A + NB * B;
  static constexpr int BYTES = STAGES * STAGE * 2;
};

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
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The row tile `t` of the grid: its expert, first sorted route and rows.
// False past the last tile.
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets,
                                          int E, int t, int& e, int& row0,
                                          int& rows) {
  int seen = 0;
  for (int i = 0; i < E; ++i) {
    const int lo = __ldg(offsets + i), hi = __ldg(offsets + i + 1);
    const int n = (hi - lo + BM - 1) / BM;
    if (t < seen + n) {
      e = i;
      row0 = lo + (t - seen) * BM;
      rows = min(BM, hi - row0);
      return true;
    }
    seen += n;
  }
  return false;
}

// One block's 64 x 64 output tile of NB products sharing the A rows:
// acc[m] += A (rows x K) . B_m[:, n0 : n0 + 64] (K x N, row-major).
// A's row r is a_rows[r] (null past `rows`: zeros).
template <int NB>
__device__ __forceinline__ void tile_products(
    const __nv_bfloat16* const* a_rows, int K,
    const __nv_bfloat16* const (&b)[NB], int N, int n0, int rows,
    __nv_bfloat16* smem, float (&acc)[NB][8][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kc = (tid & 7) * 8;          // this thread's 16 bytes of a row
  const int r0 = tid >> 3;               // its rows: r0 + 16 i
  auto load = [&](int stage, int k0) {
    __nv_bfloat16* sa = smem + stage * Smem<NB>::STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      const __nv_bfloat16* src = a_rows[i] ? a_rows[i] + k0 + kc : b[0];
      cp_async16(sa + r * LD + kc, src, a_rows[i] != nullptr);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      __nv_bfloat16* sb = sa + Smem<NB>::A + m * Smem<NB>::B;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = r0 + 16 * i;
        cp_async16(sb + k * LD + kc, b[m] + (size_t)(k0 + k) * N + n0 + kc,
                   true);
      }
    }
  };
  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  const bool active = warp * 16 < rows;  // warp-uniform
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait_ring();
    __syncthreads();
    const int pf = ks + STAGES - 1;
    if (pf < nk) load(pf % STAGES, pf * BK);
    cp_async_commit();
    if (!active) continue;
    const __nv_bfloat16* sa = smem + (ks % STAGES) * Smem<NB>::STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + (warp * 16 + (lane & 15)) * LD + kk +
                         (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        const __nv_bfloat16* sb = sa + Smem<NB>::A + m * Smem<NB>::B;
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                         * LD + np * 16 + (lane >> 4) * 8);
          mma16816(acc[m][2 * np], a, bf[0], bf[1]);
          mma16816(acc[m][2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// hidden (R, F) = bf16(silu(x Wg) * (x Wu)), the rows gathered by token
__global__ void __launch_bounds__(THREADS)
    moe_gate_up_kernel(const __nv_bfloat16* __restrict__ x,
                       const int* __restrict__ token,
                       const int* __restrict__ offsets,
                       const __nv_bfloat16* __restrict__ wg,
                       const __nv_bfloat16* __restrict__ wu,
                       __nv_bfloat16* __restrict__ hidden, int D, int F,
                       int E) {
  int e, row0, rows;
  if (!find_tile(offsets, E, blockIdx.x, e, row0, rows)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* a_rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 3) + 16 * i;
    a_rows[i] = r < rows ? x + (size_t)__ldg(token + row0 + r) * D : nullptr;
  }
  const size_t we = (size_t)e * D * F;
  const __nv_bfloat16* const b[2] = {wg + we, wu + we};
  float acc[2][8][4] = {};
  tile_products<2>(a_rows, D, b, F, n0, rows, smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
      if (r >= rows) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float g = acc[0][j][2 * h + q], u = acc[1][j][2 * h + q];
        v[q] = g / (1.0f + expf(-g)) * u;
      }
      store2(hidden + (size_t)(row0 + r) * F + col, v[0], v[1]);
    }
  }
}

// y (R, D) = bf16(hidden Wd), rows in sorted-route order
__global__ void __launch_bounds__(THREADS)
    moe_down_kernel(const __nv_bfloat16* __restrict__ hidden,
                    const int* __restrict__ offsets,
                    const __nv_bfloat16* __restrict__ wd,
                    __nv_bfloat16* __restrict__ y, int D, int F, int E) {
  int e, row0, rows;
  if (!find_tile(offsets, E, blockIdx.x, e, row0, rows)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* a_rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 3) + 16 * i;
    a_rows[i] = r < rows ? hidden + (size_t)(row0 + r) * F : nullptr;
  }
  const __nv_bfloat16* const b[1] = {wd + (size_t)e * F * D};
  float acc[1][8][4] = {};
  tile_products<1>(a_rows, F, b, D, n0, rows, smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
      if (r < rows)
        store2(y + (size_t)(row0 + r) * D + col, acc[0][j][2 * h],
               acc[0][j][2 * h + 1]);
    }
  }
}

}  // namespace

// x (T, D), token (R,) and offsets (E + 1,) int32, wg and wu (E, D, F), wd
// (E, F, D), the workspace hidden (R, F) and the output y (R, D), all bf16
// but the indices, contiguous. `tiles` bounds the row tiles
// (ceil(R / 64) + E). D and F multiples of 64. Returns cudaGetLastError().
extern "C" int mit_moe_experts(const void* x, const void* token,
                               const void* offsets, const void* wg,
                               const void* wu, const void* wd, void* hidden,
                               void* y, int D, int F, int E, int R, int tiles,
                               void* stream) {
  static bool attrs = false;
  if (!attrs) {
    cudaFuncSetAttribute(moe_gate_up_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Smem<2>::BYTES);
    cudaFuncSetAttribute(moe_down_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Smem<1>::BYTES);
    attrs = true;
  }
  if (R == 0 || tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  moe_gate_up_kernel<<<dim3(tiles, F / BN), THREADS, Smem<2>::BYTES, s>>>(
      static_cast<const bf*>(x), static_cast<const int*>(token),
      static_cast<const int*>(offsets), static_cast<const bf*>(wg),
      static_cast<const bf*>(wu), static_cast<bf*>(hidden), D, F, E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_down_kernel<<<dim3(tiles, D / BN), THREADS, Smem<1>::BYTES, s>>>(
      static_cast<const bf*>(hidden), static_cast<const int*>(offsets),
      static_cast<const bf*>(wd), static_cast<bf*>(y), D, F, E);
  return static_cast<int>(cudaGetLastError());
}
