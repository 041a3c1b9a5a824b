// Shared pieces of the tensor-core kernels (sm_90a): 16-byte cp.async
// loads into 64-column tiles in the 128-byte swizzle, the wgmma descriptors
// that name such tiles (a row of 64 bf16 or of 128 int8), the wgmma
// products the attention kernels use, and how an accumulator's elements map
// to rows and columns (f32 and s32 alike). Heads wider than 64 columns are
// held as two such tiles side by side (panels, TILE elements apart), and
// P.V runs one product a panel: m64n64k16 on a full panel, m64nNk16 with N
// = 16, 32 or 48 on the last one (wgmma_rs_bt_at). Included by
// flash_attention_btd.cu, flash_attention_dropout.cu and int8_gemm.cu;
// everything has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;            // head_dim: a tile row is 64 bf16, 128 bytes
constexpr int TILE = 64 * HD;     // elements of a 64-row tile (8 KB)

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
// 2^x for x <= 0 in one MUFU operation. exp2f adds only the scaling that
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
// accumulator (NT tiles of 8 columns), is not read before
template <int NT>
__device__ __forceinline__ void wg_commit_wait(float (&d)[NT][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}
// keeps reads of d, an accumulator of products that wg_commit_wait has just
// waited for beside its own, from moving above that wait
template <int NT>
__device__ __forceinline__ void wg_touch(float (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
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
// The same product into N = 8 NT columns of a wider accumulator: d's
// 8-column tiles OFF .. OFF + NT - 1 += a . b, b the first N columns of 16
// rows of a tile (transposed). A head of 65 to 128 columns runs it once a
// panel and 16-key step: NT = 8 on a full panel, 2, 4 or 6 on the last.
#define MIT_WG_T(d, i) \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
template <int NT, int OFF, int TOTAL>
__device__ __forceinline__ void wgmma_rs_bt_at(float (&d)[TOTAL][4],
                                               const unsigned (&a)[4],
                                               unsigned long long b) {
  static_assert(OFF + NT <= TOTAL, "the product's columns lie in d");
  if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 1;\n}\n"
        : MIT_WG_T(d, OFF), MIT_WG_T(d, OFF + 1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : MIT_WG_T(d, OFF), MIT_WG_T(d, OFF + 1), MIT_WG_T(d, OFF + 2),
          MIT_WG_T(d, OFF + 3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (NT == 6) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, "
        "%27}, %28, p, 1, 1, 1;\n}\n"
        : MIT_WG_T(d, OFF), MIT_WG_T(d, OFF + 1), MIT_WG_T(d, OFF + 2),
          MIT_WG_T(d, OFF + 3), MIT_WG_T(d, OFF + 4), MIT_WG_T(d, OFF + 5)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(NT == 8, "N is 16, 32, 48 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIT_WG_REGS
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MIT_WG_T(d, OFF), MIT_WG_T(d, OFF + 1), MIT_WG_T(d, OFF + 2),
          MIT_WG_T(d, OFF + 3), MIT_WG_T(d, OFF + 4), MIT_WG_T(d, OFF + 5),
          MIT_WG_T(d, OFF + 6), MIT_WG_T(d, OFF + 7)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}
// d += a . b: a (64 x 16) from shared memory as in wgmma_ss, b (16 rows x
// 64 columns of its tile, so transposed) as in wgmma_rs_bt
__device__ __forceinline__ void wgmma_ss_bt(float (&d)[8][4],
                                            unsigned long long a,
                                            unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIT_WG_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MIT_WG_D(d)
      : "l"(a), "l"(b), "r"(1));
}
// d += a^T . b with both operands transposed in shared memory: a names 16
// rows x 64 columns of a tile (the 16 rows are the sum's k, the 64 columns
// d's rows) and b 16 rows x 64 columns (the same k; d's columns). Both
// advance a k-step of 16 rows by 128 descriptor units, as b of wgmma_rs_bt.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[8][4],
                                            unsigned long long a,
                                            unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIT_WG_REGS
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : MIT_WG_D(d)
      : "l"(a), "l"(b), "r"(1));
}

// The (row, column) of accumulator element d[nt][e] within the warpgroup's
// 64 x 64 tile, for warp `warp` (0..3) of the group and lane `lane`.
__device__ __forceinline__ int frag_row(int warp, int lane, int e) {
  return warp * 16 + (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int lane, int nt, int e) {
  return nt * 8 + 2 * (lane & 3) + (e & 1);
}

}  // namespace
