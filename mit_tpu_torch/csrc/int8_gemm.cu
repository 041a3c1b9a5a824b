// int8_gemm: A8 (M, K) int8 . W8 (K, N) int8 -> exact int32, with the
// dequantize epilogue of the encoder's int8 kernels, for sm_90a.
//
// Replaces the GEMM and epilogue of the TPU int8 kernels: _linear_kernel
// (mit_tpu/ops/pallas_int8_mlp.py:212, behind int8_linear), the two GEMMs
// of _mlp_kernel (:88, behind fused_int8_mlp) and the four GEMMs of the
// whole-layer kernel (_dq in mit_tpu/ops/pallas_int8_layer.py:48, behind
// fused_int8_vit_layer and fused_int8_vit_layer_split); the MLP's two
// wherever ops/int8_mlp.py mlp_kernel_for sends the MLP half to the
// composition (batch 64) rather than to int8_mlp_fused.cu. Per element:
//   acc = sum_k a8[m, k] * w8[k, n]                         exact int32
//   y   = float(acc) * (sx[m] * sw[n]) [+ bias[n]]           f32
//   y   = gelu(y) | quick_gelu(y)                            (optional)
//   y   = res[m, n] + y                                      (optional)
// written as f32 or bf16, or acc itself (out_kind 2, for checking). GELU
// is the int8 kernels' clamped odd polynomial for erf (pallas_int8_mlp.py
// :39-69), not exact erf. The epilogue's products and sums use the _rn
// intrinsics in the plain version's order: nvcc contracts none of them
// into an FMA, so the output is the plain version's up to the last ulp of
// expf in quick_gelu. The accumulators are exact, so no tiling changes them.
//
// What bounds it on the H100. The encoder's GEMMs at batch 64 are
// M = 12,608 rows against K x N of 768 x 2304, 768 x 768, 768 x 3072 and
// 3072 x 768: 178.5 G int8 operations a layer, compute-bound on the int8
// tensor cores (1,979 TOP/s dense) except where the epilogue's bytes rule:
// fc1 writes a 155 MB f32 hidden, the out-projection reads and writes f32
// residuals. The design, a warp-specialised persistent kernel:
//   - One block an SM walks its output tiles of 128 x 128 (tile blockIdx.x,
//     + gridDim.x, ...; neighbouring blocks share rows of A). Warpgroup 0
//     is the producer: one thread issues TMA loads of 128 rows of A and of
//     B (the weight stored as (N, K) rows, ops/quant.py kernel_layout) by
//     128 bytes of K into a ring of STAGES stages, each guarded by a "full"
//     mbarrier (the bytes landed) and an "empty" one (its products are
//     done). TMA zero-fills past M, N and K, and writes the 128-byte
//     swizzle that wg_desc (wgmma.cuh) names: a row of 128 int8 K-values is
//     the byte layout of 64 bf16, so a k32 step adds 32 bytes to a
//     descriptor's start.
//   - Warpgroups 1 and 2 are consumers and take the block's tiles in turn
//     (ping-pong): each multiplies a whole 128 x 128 tile with
//     wgmma.mma_async m64n128k32 .s32.s8.s8 (two 64-row halves, 128 int32
//     accumulators a thread, setmaxnreg 232), one group of products in
//     flight while it waits for the next stage. A third pair of mbarriers
//     orders them: one starts a tile's products when the other has issued
//     its last, so one warpgroup's epilogue runs while the other's products
//     keep the tensor cores busy.
//   - The epilogue goes through shared memory a warp at a time: the
//     accumulator (the f32 fragment map of wgmma.cuh, frag_row/frag_col) is
//     written 8 rows by 128 columns to the warp's own buffer, read back 16
//     bytes a lane, and a warp writes 128 adjacent outputs of a row at once
//     (whole 32-byte sectors), from a loop short enough for the
//     instruction cache. The residual's rows come in by cp.async one group
//     of 8 rows ahead (the first while the last products finish), so the
//     epilogue of one tile waits on memory about once.
// The tensor maps are encoded on the host for each call, through
// cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"), so nothing links
// libcuda.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include "int8_common.cuh"

namespace {

constexpr int BM = 128;                 // rows a tile
constexpr int BN = 128;                 // columns a tile
constexpr int BK = TMA_K;               // bytes of K a stage (a swizzle row)
constexpr int NT = BN / 8;              // 8-column fragments a 64-row half
constexpr int STAGES = 4;
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int LDE = BN + 4;             // ints a row of an epilogue buffer
constexpr int EPI_WORDS = 8 * LDE;      // a warp's buffer: 8 rows
constexpr int RES_BYTES = 8 * BN * 4;   // 8 rows of an f32 residual
constexpr int BARS = 2 * STAGES + 2;    // full, empty, the consumers' order
constexpr int SMEM = STAGES * STAGE + 8 * EPI_WORDS * 4 +
                     8 * 2 * RES_BYTES + BARS * 8 +
                     1024;              // + room to align to 1024

// d (+)= a . b^T over k32: a (64 rows x 32 bytes) and b (128 rows x 32
// bytes), both K-major int8 tiles in shared memory, exact int32 sums;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4],
                                         unsigned long long a,
                                         unsigned long long b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct Args {
  const float *sx, *sw, *bias;
  const void* res;
  void* out;
  int M, N, K, act, res_kind;
};

// the `half`-th 8 rows of a warp's 16 rows of a 64-row accumulator half
// into the warp's buffer: lane (g, t) holds d[nt][2 half], d[nt][2 half + 1]
// of row g, columns 8 nt + 2t, + 1 (frag_row, frag_col)
__device__ __forceinline__ void stage_rows(const int (&d)[NT][4], int half,
                                           int* buf) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = frag_row(0, lane, 2 * half) - 8 * half;
    *reinterpret_cast<int2*>(buf + r * LDE + frag_col(lane, nt, 0)) =
        make_int2(d[nt][2 * half], d[nt][2 * half + 1]);
  }
}

// Rows m0 .. m0 + 7 x columns n0 .. n0 + 127 of the residual (bytes `esize`
// an element) into `dst` with cp.async, 16 bytes a copy, zeros past M or N
__device__ __forceinline__ void load_res(uint8_t* dst, const Args& a,
                                         int esize, int m0, int n0) {
  const int lane = threadIdx.x & 31;
  const int cpr = BN * esize / 16;      // copies a row
  for (int i = lane; i < 8 * cpr; i += 32) {
    const int r = i / cpr, c = i % cpr;
    const int m = m0 + r, n = n0 + c * 16 / esize;
    const bool ok = m < a.M && n < a.N;
    const uint8_t* src = static_cast<const uint8_t*>(a.res) +
                         (ok ? ((size_t)m * a.N + n) * esize : 0);
    cp_async16(dst + r * BN * esize + c * 16, src, ok);
  }
}

// Rows m0 .. m0 + 7 x columns n0 .. n0 + 127 from the warp's buffer through
// the epilogue, 4 columns a lane: a warp stores 128 adjacent outputs of a
// row at once. `res`: the same rows of the residual in shared memory (see
// load_res). sw and bias: this lane's 4 columns of the scales and the bias
// (0 without one).
template <int OUT, int ACT>
__device__ __forceinline__ void store_rows(const int* buf, const uint8_t* res,
                                           int m0, int n0, const Args& a,
                                           float4 sw, float4 bias) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + 4 * lane;
  const bool cols = n < a.N;            // N % 8 == 0: all four are in
  const int ml = m0 + (lane & 7);
  const float sxl = OUT != OUT_S32 && ml < a.M ? a.sx[ml] : 0.f;
  const bool hb = a.bias != nullptr, hr = a.res_kind != RES_NONE;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float s = __shfl_sync(0xffffffffu, sxl, r);
    const int m = m0 + r;
    if (!cols || m >= a.M) continue;
    const int4 v = *reinterpret_cast<const int4*>(buf + r * LDE + 4 * lane);
    const size_t idx = (size_t)m * a.N + n;
    if (OUT == OUT_S32) {
      *reinterpret_cast<int4*>(static_cast<int*>(a.out) + idx) = v;
      continue;
    }
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.res_kind == RES_F32) {
      q = *reinterpret_cast<const float4*>(res + (r * BN + 4 * lane) * 4);
    } else if (a.res_kind == RES_BF16) {
      const uint2 u =
          *reinterpret_cast<const uint2*>(res + (r * BN + 4 * lane) * 2);
      q = make_float4(__uint_as_float(u.x << 16),
                      __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16),
                      __uint_as_float(u.y & 0xffff0000u));
    }
    const float y0 = epilogue<ACT>(v.x, s, sw.x, hb, bias.x, hr, q.x);
    const float y1 = epilogue<ACT>(v.y, s, sw.y, hb, bias.y, hr, q.y);
    const float y2 = epilogue<ACT>(v.z, s, sw.z, hb, bias.z, hr, q.z);
    const float y3 = epilogue<ACT>(v.w, s, sw.w, hb, bias.w, hr, q.w);
    if (OUT == OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + idx) =
          make_float4(y0, y1, y2, y3);
    } else {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + idx) =
          make_uint2(pack_bf16(y0, y1), pack_bf16(y2, y3));
    }
  }
}

template <int OUT>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* epi = reinterpret_cast<int*>(smem + STAGES * STAGE);
  uint8_t* resb = reinterpret_cast<uint8_t*>(epi + 8 * EPI_WORDS);
  const unsigned bars = smem_u32(resb + 8 * 2 * RES_BYTES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  // order(c): consumer c may start its next tile's products
  auto order = [&](int c) { return bars + 8 * (2 * STAGES + c); };

  const int tiles_n = (a.N + BN - 1) / BN;
  const int tiles = (a.M + BM - 1) / BM * tiles_n;
  const int KT = (a.K + BK - 1) / BK;
  // this block's tiles are blockIdx.x + i * gridDim.x, i < mine; step
  // j = i * KT + kt of the ring is k-step kt of tile i
  const int mine = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x) + 1;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);           // every thread of the consumer
    }
    mbar_init(order(0), 128);
    mbar_init(order(1), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int i = 0; i < mine; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          const int j = i * KT + kt, s = j % STAGES;
          mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
          mbar_expect(full(s), STAGE);
          const unsigned dst = smem_u32(smem + s * STAGE);
          tma_load(dst, &map_a, kt * BK, m0, full(s));
          tma_load(dst + A_BYTES, &map_b, kt * BK, n0, full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;                 // consumer 0 or 1
    const int warp = (threadIdx.x >> 5) & 3;
    int* buf = epi + (c * 4 + warp) * EPI_WORDS;
    uint8_t* rbuf = resb + (c * 4 + warp) * 2 * RES_BYTES;   // two chunks
    const int esize = a.res_kind == RES_F32 ? 4 : 2;
    const bool hr = OUT != OUT_S32 && a.res_kind != RES_NONE;
    // the rows of epilogue group q (0..3) of this warp in a tile from m0
    auto rows_of = [&](int m0, int q) {
      return m0 + 64 * (q >> 1) + 16 * warp + 8 * (q & 1);
    };
    int d[2][NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[h][i][e] = 0;
    // A wait on a barrier's phase parity cannot tell a phase from the one
    // two phases on, so no warpgroup may wait for a step of the ring before
    // every earlier step was waited for: a consumer starts a tile's products
    // only after the other consumer has waited for all of the tile before.
    // That is also the ping-pong: one's products run while the other
    // drains its last group and stores its tile.
    for (int i = c, turn = 0; i < mine; i += 2, ++turn) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      if (i > 0) mbar_wait(order(c), (c == 0 ? turn - 1 : turn) & 1);
      for (int kt = 0; kt < KT; ++kt) {
        const int j = i * KT + kt, s = j % STAGES;
        mbar_wait(full(s), (j / STAGES) & 1);
        const uint8_t* st = smem + s * STAGE;
        const unsigned long long da = wg_desc(st);
        const unsigned long long db = wg_desc(st + A_BYTES);
        wg_touch_s32(d[0]);
        wg_touch_s32(d[1]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          // the second 64-row half of A starts 64 rows (8 KB, 512 units) on
          wgmma_s8(d[0], da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
          wgmma_s8(d[1], da + 512 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        wg_touch_s32(d[0]);
        wg_touch_s32(d[1]);
        // the products of step j - 1 are done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0) mbar_arrive(empty((j - 1) % STAGES));
      }
      if (i + 1 < mine) mbar_arrive(order(1 - c));
      // the first group's residual rows are on their way while the last
      // products finish
      if (hr) load_res(rbuf, a, esize, rows_of(m0, 0), n0);
      cp_async_commit();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      wg_touch_s32(d[0]);
      wg_touch_s32(d[1]);
      mbar_arrive(empty((i * KT + KT - 1) % STAGES));
      // the epilogue, a warp's 32 rows in four groups of 8 through its
      // buffer; one copy of the epilogue's code (the loop is not unrolled,
      // each case names its registers)
      const int lane = threadIdx.x & 31, n = n0 + 4 * lane;
      float4 sw = make_float4(0.f, 0.f, 0.f, 0.f), bias = sw;
      if (OUT != OUT_S32 && n < a.N) {
        sw = *reinterpret_cast<const float4*>(a.sw + n);
        if (a.bias != nullptr)
          bias = *reinterpret_cast<const float4*>(a.bias + n);
      }
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        __syncwarp();                     // the buffers' last reads are done
        // the next group's residual rows into the other half of rbuf
        if (hr && q < 3)
          load_res(rbuf + ((q + 1) & 1) * RES_BYTES, a, esize,
                   rows_of(m0, q + 1), n0);
        cp_async_commit();
        switch (q) {
          case 0: stage_rows(d[0], 0, buf); break;
          case 1: stage_rows(d[0], 1, buf); break;
          case 2: stage_rows(d[1], 0, buf); break;
          default: stage_rows(d[1], 1, buf); break;
        }
        cp_async_wait<1>();               // this group's residual rows
        __syncwarp();
        const uint8_t* rq = rbuf + (q & 1) * RES_BYTES;
        const int mq = rows_of(m0, q);
        if (OUT == OUT_S32 || a.act == ACT_NONE)
          store_rows<OUT, ACT_NONE>(buf, rq, mq, n0, a, sw, bias);
        else if (a.act == ACT_GELU)
          store_rows<OUT, ACT_GELU>(buf, rq, mq, n0, a, sw, bias);
        else
          store_rows<OUT, ACT_QUICK_GELU>(buf, rq, mq, n0, a, sw, bias);
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int OUT>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const Args& a,
           cudaStream_t stream) {
  // a card's SMs, and the kernel's shared memory allowed on it, once
  static int sms_of[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    int sms = 0;
    e = cudaFuncSetAttribute(int8_gemm_kernel<OUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const long long tiles =
      (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_gemm_kernel<OUT><<<grid, THREADS, SMEM, stream>>>(ma, mb, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a8: (M, K) int8, row-major; bt: the weight as (N, K) int8, row-major
// (w8 (K, N) stored K-contiguous); sx: (M,) f32; sw: (N,) f32; bias: (N,)
// f32 or null; res: (M, N) f32 (res_kind 1) or bf16 (2), or null (0);
// out: (M, N) f32 (out_kind 0), bf16 (1) or raw int32 accumulators (2).
// act: 0 none, 1 gelu (polynomial erf), 2 quick_gelu. K % 16 == 0,
// N % 8 == 0; a8, bt, sw, bias, res and out 16-byte aligned.
extern "C" int mit_int8_gemm(const void* a8, const void* bt, const void* sx,
                             const void* sw, const void* bias, const void* res,
                             void* out, int M, int N, int K, int act,
                             int res_kind, int out_kind, void* stream) {
  if (M < 1 || N < 8 || N % 8 || K < 16 || K % 16 || out_kind < 0 ||
      out_kind > OUT_S32)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  cudaError_t e = encode_map(&ma, a8, M, K, BM);
  if (e == cudaSuccess) e = encode_map(&mb, bt, N, K, BN);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(sx), static_cast<const float*>(sw),
               static_cast<const float*>(bias), res, out, M, N, K, act,
               res_kind};
  auto* s = (cudaStream_t)stream;
  switch (out_kind) {
    case OUT_F32: return launch<OUT_F32>(ma, mb, a, s);
    case OUT_BF16: return launch<OUT_BF16>(ma, mb, a, s);
    default: return launch<OUT_S32>(ma, mb, a, s);
  }
}
