// int8_mlp_fused: the int8 MLP half of a ViT layer in one kernel for
// sm_90a, with the hidden kept on chip.
//
// Replaces the TPU kernels _mlp_half_kernel (mit_tpu/ops/pallas_int8_layer
// .py:297, the MLP pass of fused_int8_vit_layer_split, called at :567),
// the MLP half of the whole-layer kernel (_mlp_body, :134-151, behind
// fused_int8_vit_layer) and _mlp_kernel (mit_tpu/ops/pallas_int8_mlp.py
// :88-111, behind fused_int8_mlp). For rows x of (M, D), term for term:
//   h      = LN(x) in f32 (mean, biased variance, rsqrt(var + eps), scale,
//            bias), or x itself without the LayerNorm
//   h8, sh = quantize_rows(h)
//   mid    = act(acc(h8 . w1) * (sh * s1) + b1)          f32, (M, F)
//   m8, sm = quantize_rows(mid)       the exact max of |mid| over all F
//   y      = acc(m8 . w2) * (sm * s2) + b2 [+ x]          f32
// written as f32 or bf16. The elementwise steps are int8_gemm.cu's and
// quantize_rows.cu's (int8_common.cuh), and the LayerNorm's sums run in
// quantize_rows.cu's order (row_sum below), so the output is the
// composition's (quantize_rows, int8_gemm, quantize_rows, int8_gemm) bit
// for bit, up to the last ulp of expf in quick_gelu.
//
// What bounds it on the H100: the int8 tensor cores, 4 M D F operations
// (119 G at ViT-B's batch 64, 0.060 ms at 1,979 TOP/s). The composition
// also moves the f32 hidden through device memory three times (fc1 writes
// it, the quantizer reads it and writes its int8 codes, fc2 reads those):
// 0.40 GB at ViT-B's batch 64, 0.88 GB at ViT-H/14's. A row's quantizer
// needs the max over all F columns, which no 128 x 128 GEMM tile holds.
// The design: a thread block cluster of C = 8 blocks holds 64 rows, one
// block an SM, and the hidden never leaves the cluster's shared memory.
// What crosses between blocks goes by bulk copies (cp.async.bulk and
// cp.reduce.async.bulk, shared::cta to shared::cluster) that complete the
// bytes of the receiver's mbarrier, so no block waits on a peer's threads.
//   - Prologue. Each consumer warp of the cluster takes one of the 64 rows
//     (block r: rows 8r .. 8r + 7), normalizes and quantizes it into H8
//     (64 rows x D of int8 in the 128-byte swizzle that wgmma reads); a
//     block's 8 rows are one 1 KB segment of each H8 tile, pushed to the 7
//     peers with their 8 scales.
//   - fc1. Block r owns hidden columns [r F/8, (r + 1) F/8): each of its
//     two consumer warpgroups F/16 of them, as chunks of 64 columns
//     (wgmma m64n64k32 .s32.s8.s8, A = H8, B = TMA tiles of w1 through a
//     ring of STAGES stages fed by one producer thread, as in
//     int8_gemm.cu). The accumulators stay in registers (F/16 / 2 a
//     thread: 96 at ViT-B, 160 at ViT-H/14) and become mid in place.
//   - The row max. Each block reduces |mid| over its columns, pushes its
//     64 maxima to the peers, takes the max over the 8, quantizes its mid
//     into HID (its F/8 columns of the int8 hidden, in the swizzle) and
//     keeps the row scales in registers.
//   - fc2, split over K. Block r multiplies its own HID (A) by the rows of
//     w2 that its columns meet (B, TMA tiles by 128 columns), for each
//     block's D/8 output columns in turn (D/16 a warpgroup: m64nNk32, N =
//     48, 64 or 80); a warp stages its 16 rows of each group's int32 sums
//     and adds them into the owner's ACC (cp.reduce.async.bulk .add.u32:
//     integer sums in any order are the same sums). Two accumulators: a
//     group's sums go out while the next group's products run.
//   - Once all 8 blocks' sums are in its ACC, a block dequantizes, adds the
//     bias and the residual and writes its D/8 columns of y.
// Bytes through device memory: x read (and, for the residual, its block's
// columns again, from L2), y written, the weights once a cluster from L2.
// On an H100 it beats the composition only up to a few images (16 at
// ViT-B's width, 4 at CLIP-L's, 2 at ViT-H's) and over the last layer's
// CLS rows, where the composition's four launches set the pace; at batch
// 64 it is 1.2-1.7 x slower (PERF.md; phase by phase with
// tools/mlp_phases.py): one block an SM runs its phases one after another,
// and fc2 sends 64 D int32 of partial sums a block (196 KB at ViT-B) in
// 11.3 us of a ViT-B block's 28.4. The geometries are template arguments:
// (D, F) = (768, 3072) (ViT-B/16, CLIP-B/32, BLIP-base), (1024, 4096)
// (CLIP ViT-L/14) and (1280, 5120) (ViT-H/14); ops/int8_mlp.py
// mlp_kernel_for decides which calls run it.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>

#include "int8_common.cuh"

namespace {

constexpr int C = 8;                    // blocks a cluster
constexpr int ROWS = 64;                // rows a cluster
constexpr int RPB = ROWS / C;           // prologue rows a block: one a consumer warp
constexpr int CN = 64;                  // fc1 columns a chunk (m64n64k32)
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int LOADERS = 96;             // warps 1-3 of the producer warpgroup
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;      // an SM's shared memory a block
constexpr int TILE8 = ROWS * TMA_K;     // a 64-row tile of 128 int8 K-values

// Phase stamps, for measurements only: built with -DMIT_MLP_PROFILE (the
// tools/mlp_phases.py runbook), the first consumer thread of a block writes
// %globaltimer at each phase boundary into slot i of its row of g_prof
// (MIT_STAMP) and adds the ns spent in some waits of fc2 into others
// (MIT_ACC_BEGIN / MIT_ACC_END). A default build compiles them out.
#ifdef MIT_MLP_PROFILE
constexpr int PROF_BLOCKS = 4096, PROF_SLOTS = 16;
__device__ unsigned long long g_prof[PROF_BLOCKS * PROF_SLOTS];
__device__ __forceinline__ unsigned long long mit_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MIT_STAMP(i)                                                \
  do {                                                              \
    if (blockIdx.x < PROF_BLOCKS)                                   \
      g_prof[blockIdx.x * PROF_SLOTS + (i)] = mit_now();            \
  } while (0)
#define MIT_ACC_BEGIN const unsigned long long acc_t0 = mit_now();
#define MIT_ACC_END(i)                                              \
  if (cidx == 0 && blockIdx.x < PROF_BLOCKS)                        \
    g_prof[blockIdx.x * PROF_SLOTS + (i)] += mit_now() - acc_t0;
#else
#define MIT_STAMP(i) \
  do {               \
  } while (0)
#define MIT_ACC_BEGIN
#define MIT_ACC_END(i)
#endif

#define MIT_S8_T(d, i) "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])
// d (+)= a . b^T over k32: a (64 rows x 32 bytes) and b (8 NT rows x 32
// bytes), K-major int8 tiles in shared memory, exact int32 sums;
// accumulate = 0 overwrites d
template <int NT>
struct WgmmaS8;
template <>
struct WgmmaS8<6> {
  static __device__ __forceinline__ void run(int (&d)[6][4],
                                             unsigned long long a,
                                             unsigned long long b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p;\n}\n"
        : MIT_S8_T(d, 0), MIT_S8_T(d, 1), MIT_S8_T(d, 2), MIT_S8_T(d, 3), MIT_S8_T(d, 4), MIT_S8_T(d, 5)
        : "l"(a), "l"(b), "r"(acc));
  }
};
template <>
struct WgmmaS8<8> {
  static __device__ __forceinline__ void run(int (&d)[8][4],
                                             unsigned long long a,
                                             unsigned long long b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : MIT_S8_T(d, 0), MIT_S8_T(d, 1), MIT_S8_T(d, 2), MIT_S8_T(d, 3), MIT_S8_T(d, 4), MIT_S8_T(d, 5), MIT_S8_T(d, 6), MIT_S8_T(d, 7)
        : "l"(a), "l"(b), "r"(acc));
  }
};
template <>
struct WgmmaS8<10> {
  static __device__ __forceinline__ void run(int (&d)[10][4],
                                             unsigned long long a,
                                             unsigned long long b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p;\n}\n"
        : MIT_S8_T(d, 0), MIT_S8_T(d, 1), MIT_S8_T(d, 2), MIT_S8_T(d, 3), MIT_S8_T(d, 4), MIT_S8_T(d, 5), MIT_S8_T(d, 6), MIT_S8_T(d, 7), MIT_S8_T(d, 8), MIT_S8_T(d, 9)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <int D, int F>
struct Geo {
  static constexpr int KT1 = D / TMA_K;     // fc1 k-steps, tiles of H8
  static constexpr int FB = F / C;          // hidden columns a block
  static constexpr int FW = FB / 2;         // ... a consumer warpgroup
  static constexpr int NCH = FW / CN;       // fc1 chunks a warpgroup
  static constexpr int HT = FB / TMA_K;     // tiles of HID: fc2's k-steps
  static constexpr int DB = D / C;          // output columns a block
  static constexpr int DW = DB / 2;         // ... a consumer warpgroup
  static constexpr int NT2 = DW / 8;
  static constexpr int B1 = 2 * CN * TMA_K; // bytes of a fc1 stage
  static constexpr int B2 = DB * TMA_K;     // bytes of a fc2 stage
  static constexpr int SB = B1 > B2 ? B1 : B2;
  static constexpr int H8 = KT1 * TILE8;    // then ACC and the staging
  static constexpr int PART = ROWS * DW * 4;  // a warpgroup's partial sums
  static constexpr int HID = HT * TILE8;
  // s1, b1 (FB each), s2, b2 (DB each); sh (ROWS), the warpgroups' row
  // maxima (2 ROWS), the blocks' (C ROWS)
  static constexpr int SMALL = (2 * FB + 2 * DB + (1 + 2 + C) * ROWS) * 4;
  static constexpr int BARS = 2 * MAX_STAGES + 4;
  static constexpr int FIXED = H8 + HID + SMALL + BARS * 8 + 1024;
  static constexpr int STAGES =
      (SMEM_LIMIT - FIXED) / SB < MAX_STAGES ? (SMEM_LIMIT - FIXED) / SB
                                              : MAX_STAGES;
  static constexpr int RING = STAGES * SB;
  static constexpr int SMEM = RING + FIXED;
  static_assert(D % TMA_K == 0, "D is whole tiles");
  static_assert(FW % CN == 0 && FB % TMA_K == 0, "F splits into chunks");
  static_assert(DW % 8 == 0 && DW >= 48 && DW <= 80, "fc2's N is 48 to 80");
  static_assert(4 * PART == H8, "ACC and the staging fill H8");
  static_assert(STAGES >= 3 && SMEM <= SMEM_LIMIT, "fits an SM");
};

struct MlpArgs {
  const void* x;                        // (M, D) f32 or bf16
  const float *ln_s, *ln_b;             // (D,) each, or null: no LayerNorm
  const float *s1, *b1, *s2, *b2;       // b1, b2 may be null
  void* out;                            // (M, D) f32 or bf16
  int M, x_bf16, residual, out_bf16;
  float eps;
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of `addr` (this block's shared memory) in block `rank`
__device__ __forceinline__ unsigned peer(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// bytes [src, src + size) of this block's shared memory into dst, a
// shared::cluster address of any block of the cluster, completing `size`
// bytes of the phase of `bar` (a barrier of dst's block); with ADD, dst's
// u32 words become dst + src (exact, wrapping: two's complement int32)
template <bool ADD>
__device__ __forceinline__ void bulk_push(unsigned dst, unsigned src,
                                          unsigned size, unsigned bar) {
  if (ADD)
    asm volatile(
        "cp.reduce.async.bulk.shared::cluster.shared::cta.mbarrier::"
        "complete_tx::bytes.add.u32 [%0], [%1], %2, [%3];\n" ::"r"(dst),
        "r"(src), "r"(size), "r"(bar)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
        "r"(src), "r"(size), "r"(bar)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk pushes have read their sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until they are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's generic-proxy writes of shared memory before later
// reads by wgmma (the async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// byte b (0..127) of row r of a 64-row int8 tile in the 128-byte swizzle
// (tile_at of wgmma.cuh in bytes)
__device__ __forceinline__ int swz(int r, int b) {
  return r * TMA_K + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}
__device__ __forceinline__ int quant(float y, float inv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.f), 127.f);
}

// The sum of a row in quantize_rows.cu's order, for a warp that holds the
// row as v[i][e] = element 128 i + 4 lane + e. quantize_rows.cu runs 256
// threads: thread t adds elements t, t + 256, ... in turn from 0, a warp
// adds its 32 sums by the xor tree (16, 8, 4, 2, 1), and the eight warps'
// sums are added in order. Here thread t = 4 lane + e + 128 (i & 1) holds
// element i >> 1 of its run, its lane in the tree is 4 (lane % 8) + e and
// its warp lane / 8 + 4 (i & 1): the tree's xor 16, 8 and 4 are shuffles
// to lanes lane ^ 4, ^ 2 and ^ 1, its xor 2 and 1 are e ^ 2 and e ^ 1.
// Every sum is the same pair of f32 numbers added, so the result is
// quantize_rows.cu's bit for bit.
template <int KT>
__device__ __forceinline__ float row_sum(const float (&v)[KT][4]) {
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i & 1][e] = __fadd_rn(s[i & 1][e], v[i][e]);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[h][e] = __fadd_rn(s[h][e], __shfl_xor_sync(0xffffffffu, s[h][e], off));
  float w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float u0 = __fadd_rn(s[h][0], s[h][2]);   // xor 2
    const float u1 = __fadd_rn(s[h][1], s[h][3]);
    w[h] = __fadd_rn(u0, u1);                       // xor 1: e = 0's sum
  }
  // warp W's sum lies in lanes 8 (W % 4) .. + 7, half W / 4
  float total = __shfl_sync(0xffffffffu, w[0], 0);
#pragma unroll
  for (int W = 1; W < 8; ++W)
    total = __fadd_rn(total, __shfl_sync(0xffffffffu, w[W / 4], 8 * (W % 4)));
  return total;
}

template <int D, int F, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
int8_mlp_fused_kernel(const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const MlpArgs a) {
  using G = Geo<D, F>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* h8 = ring + G::RING;         // fc1's A; then ACC and the staging
  uint8_t* hid = h8 + G::H8;            // this block's columns of the hidden
  float* s1 = reinterpret_cast<float*>(hid + G::HID);
  float* b1 = s1 + G::FB;
  float* s2 = b1 + G::FB;               // this block's output columns
  float* b2 = s2 + G::DB;
  float* sh = b2 + G::DB;               // [row]
  float* amxp = sh + ROWS;              // [warpgroup][row]
  float* amx = amxp + 2 * ROWS;         // [block][row]
  const unsigned bars = smem_u32(amx + C * ROWS);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  const unsigned h8_full = bars + 8 * 2 * MAX_STAGES;  // the peers' rows
  const unsigned amx_full = h8_full + 8;  // the peers' row maxima
  const unsigned acc_full = h8_full + 16; // every block's partial sums
  const unsigned params = h8_full + 24;   // s1, b1, s2, b2 staged

  const unsigned rank = cluster_rank();
  const int m0 = (int)cluster_index() * ROWS;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int c = wg - 1;                   // consumer warpgroup 0 or 1

  // a consumer warp's prologue row is on its way before anything waits
  const int rr = (int)rank * RPB + c * 4 + warp;
  float v[G::KT1][4];
  float4 lns[G::KT1], lnb[G::KT1];
  if (wg > 0 && a.ln_s != nullptr) {
#pragma unroll
    for (int i = 0; i < G::KT1; ++i) {
      lns[i] = *reinterpret_cast<const float4*>(a.ln_s + i * TMA_K + 4 * lane);
      lnb[i] = *reinterpret_cast<const float4*>(a.ln_b + i * TMA_K + 4 * lane);
    }
  }
  if (wg > 0) {
    const int m = m0 + rr;
#pragma unroll
    for (int i = 0; i < G::KT1; ++i) {
      const int col = i * TMA_K + 4 * lane;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < a.M) {
        const size_t idx = (size_t)m * D + col;
        if (a.x_bf16) {
          const uint2 u = *reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(a.x) + idx);
          q = make_float4(__uint_as_float(u.x << 16),
                          __uint_as_float(u.x & 0xffff0000u),
                          __uint_as_float(u.y << 16),
                          __uint_as_float(u.y & 0xffff0000u));
        } else {
          q = *reinterpret_cast<const float4*>(static_cast<const float*>(a.x) +
                                               idx);
        }
      }
      v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
    }
  }

  if (threadIdx.x == 128) MIT_STAMP(0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(h8_full, 1);
    mbar_init(amx_full, 1);
    mbar_init(acc_full, 1);
    mbar_init(params, LOADERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the bytes the peers' pushes bring: their rows of H8 and of sh, their
    // row maxima, and every block's partial sums of this block's columns
    mbar_expect(h8_full, (C - 1) * (G::KT1 * RPB * TMA_K + RPB * 4));
    mbar_expect(amx_full, (C - 1) * ROWS * 4);
    mbar_expect(acc_full, C * 2 * G::PART);
  }
  // every block of the cluster runs, its barriers set, before any block
  // pushes to a peer
  cluster_sync_all();
  if (threadIdx.x == 128) MIT_STAMP(1);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // the weight tiles of fc1, then of fc2, through one ring
      for (int j = 0; j < G::NCH; ++j)
        for (int kt = 0; kt < G::KT1; ++kt) {
          const int step = j * G::KT1 + kt, s = step % STAGES;
          mbar_wait(empty(s), ((step / STAGES) & 1) ^ 1);
          mbar_expect(full(s), G::B1);
          const unsigned dst = smem_u32(ring + s * G::SB);
          const int n0 = (int)rank * G::FB + j * CN;
          tma_load(dst, &map_w1, kt * TMA_K, n0, full(s));
          tma_load(dst + CN * TMA_K, &map_w1, kt * TMA_K, n0 + G::FW, full(s));
        }
      MIT_STAMP(13);
      // fc2: this block's F/8 columns of w2 for each block's D/8 outputs
      for (int i = 0; i < C; ++i)
        for (int q = 0; q < G::HT; ++q) {
          const int step = G::NCH * G::KT1 + i * G::HT + q, s = step % STAGES;
          mbar_wait(empty(s), ((step / STAGES) & 1) ^ 1);
          mbar_expect(full(s), G::B2);
          tma_load(smem_u32(ring + s * G::SB), &map_w2,
                   (int)rank * G::FB + q * TMA_K,
                   (int)((rank + i) % C) * G::DB, full(s));
        }
      MIT_STAMP(14);
    } else if (threadIdx.x >= 32) {
      // the block's columns of the scales and biases into shared memory
      for (int n = threadIdx.x - 32; n < G::FB; n += LOADERS) {
        const int col = (int)rank * G::FB + n;
        s1[n] = a.s1[col];
        b1[n] = a.b1 != nullptr ? a.b1[col] : 0.f;
      }
      for (int n = threadIdx.x - 32; n < G::DB; n += LOADERS) {
        const int col = (int)rank * G::DB + n;
        s2[n] = a.s2[col];
        b2[n] = a.b2 != nullptr ? a.b2[col] : 0.f;
      }
      mbar_arrive(params);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cidx = threadIdx.x - 128;     // 0 .. 255

  // ---- prologue: one row a warp into H8, then to every peer ----
  {
    if (a.ln_s != nullptr) {
      const float mean = __fdiv_rn(row_sum<G::KT1>(v), (float)D);
      float sq[G::KT1][4];
#pragma unroll
      for (int i = 0; i < G::KT1; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dv = __fsub_rn(v[i][e], mean);
          sq[i][e] = __fmul_rn(dv, dv);
        }
      const float var = __fdiv_rn(row_sum<G::KT1>(sq), (float)D);
      const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, a.eps)));
#pragma unroll
      for (int i = 0; i < G::KT1; ++i) {
        const float s4[4] = {lns[i].x, lns[i].y, lns[i].z, lns[i].w};
        const float b4[4] = {lnb[i].x, lnb[i].y, lnb[i].z, lnb[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[i][e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mean), r), s4[e]), b4[e]);
      }
    }
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < G::KT1; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(v[i][e]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float amax = fmaxf(mx, 1e-8f);
    const float inv = __fdiv_rn(127.f, amax);
#pragma unroll
    for (int i = 0; i < G::KT1; ++i) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= (unsigned)(quant(v[i][e], inv) & 0xff) << (8 * e);
      *reinterpret_cast<unsigned*>(h8 + i * TILE8 + swz(rr, 4 * lane)) = word;
    }
    if (lane == 0) sh[rr] = __fmul_rn(amax, 1.f / 127.f);
    fence_async();
  }
  consumers_sync();
  // this block's RPB rows: a contiguous segment of each H8 tile, and of sh
  constexpr int PUSHES = (C - 1) * (G::KT1 + 1);
  if (cidx < PUSHES) {
    const unsigned p = (rank + 1 + cidx / (G::KT1 + 1)) % C;
    const int i = cidx % (G::KT1 + 1);
    const unsigned src =
        i < G::KT1 ? smem_u32(h8 + i * TILE8 + rank * RPB * TMA_K)
                   : smem_u32(sh + rank * RPB);
    bulk_push<false>(peer(src, p), src,
                     i < G::KT1 ? RPB * TMA_K : RPB * 4, peer(h8_full, p));
  }
  if (cidx == 0) MIT_STAMP(2);
  mbar_wait(h8_full, 0);
  if (cidx == 0) MIT_STAMP(3);

  // ---- fc1: this warpgroup's F/16 columns, NCH chunks of 64 ----
  int d[G::NCH][8][4];
#pragma unroll
  for (int j = 0; j < G::NCH; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][i][e] = 0;
  const unsigned long long dh = wg_desc(h8);   // H8's tile i: + 512 i
#pragma unroll
  for (int j = 0; j < G::NCH; ++j) {
#pragma unroll 1
    for (int kt = 0; kt < G::KT1; ++kt) {
      const int step = j * G::KT1 + kt, s = step % STAGES;
      mbar_wait(full(s), (step / STAGES) & 1);
      const unsigned long long da = dh + kt * (TILE8 >> 4);
      const unsigned long long db = wg_desc(ring + s * G::SB + c * CN * TMA_K);
      wg_touch_s32(d[j]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_K / 32; ++kk)
        WgmmaS8<8>::run(d[j], da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      wg_commit();
      wg_touch_s32(d[j]);
      wg_wait<1>();                       // step - 1's products are done
      if (step > 0) mbar_arrive(empty((step - 1) % STAGES));
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int j = 0; j < G::NCH; ++j) wg_touch_s32(d[j]);
  mbar_arrive(empty((G::NCH * G::KT1 - 1) % STAGES));
  if (cidx < PUSHES) bulk_wait_read();    // H8 is reused below
  if (cidx == 0) MIT_STAMP(4);

  // ---- mid = act(dequantized fc1 + b1), in place, and its row maxima ----
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;           // this thread's rows: r0, r0 + 8
  const bool hb1 = a.b1 != nullptr;
  float mx0 = 0.f, mx1 = 0.f;
  mbar_wait(params, 0);
  {
    const float sh0 = sh[r0], sh1 = sh[r0 + 8];
#pragma unroll
    for (int j = 0; j < G::NCH; ++j)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = c * G::FW + j * CN + nt * 8 + 2 * t;
        const float2 sw = *reinterpret_cast<const float2*>(s1 + n);
        const float2 bb = *reinterpret_cast<const float2*>(b1 + n);
        const float y0 = epilogue<ACT>(d[j][nt][0], sh0, sw.x, hb1, bb.x, false, 0.f);
        const float y1 = epilogue<ACT>(d[j][nt][1], sh0, sw.y, hb1, bb.y, false, 0.f);
        const float y2 = epilogue<ACT>(d[j][nt][2], sh1, sw.x, hb1, bb.x, false, 0.f);
        const float y3 = epilogue<ACT>(d[j][nt][3], sh1, sw.y, hb1, bb.y, false, 0.f);
        mx0 = fmaxf(mx0, fmaxf(fabsf(y0), fabsf(y1)));
        mx1 = fmaxf(mx1, fmaxf(fabsf(y2), fabsf(y3)));
        d[j][nt][0] = __float_as_int(y0);
        d[j][nt][1] = __float_as_int(y1);
        d[j][nt][2] = __float_as_int(y2);
        d[j][nt][3] = __float_as_int(y3);
      }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  if (t == 0) {
    amxp[c * ROWS + r0] = mx0;
    amxp[c * ROWS + r0 + 8] = mx1;
  }
  consumers_sync();                       // both warpgroups past fc1, too
  // this block's row maxima; ACC zeroed before any peer can add to it (a
  // peer adds only after it has this block's maxima)
  if (cidx < ROWS) amx[rank * ROWS + cidx] = fmaxf(amxp[cidx], amxp[ROWS + cidx]);
  for (int i = cidx; i < 2 * G::PART / 16; i += CONSUMERS)
    reinterpret_cast<int4*>(h8)[i] = make_int4(0, 0, 0, 0);
  fence_async();
  consumers_sync();
  if (cidx < C - 1) {
    const unsigned p = (rank + 1 + cidx) % C;
    const unsigned src = smem_u32(amx + rank * ROWS);
    bulk_push<false>(peer(src, p), src, ROWS * 4, peer(amx_full, p));
  }
  if (cidx == 0) MIT_STAMP(5);
  mbar_wait(amx_full, 0);
  if (cidx == 0) MIT_STAMP(6);

  // ---- m8 into HID; the row scales sm stay in registers ----
  float sm0, sm1;
  {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int p = 0; p < C; ++p) {
      a0 = fmaxf(a0, amx[p * ROWS + r0]);
      a1 = fmaxf(a1, amx[p * ROWS + r0 + 8]);
    }
    a0 = fmaxf(a0, 1e-8f);
    a1 = fmaxf(a1, 1e-8f);
    const float inv0 = __fdiv_rn(127.f, a0), inv1 = __fdiv_rn(127.f, a1);
    sm0 = __fmul_rn(a0, 1.f / 127.f);
    sm1 = __fmul_rn(a1, 1.f / 127.f);
#pragma unroll
    for (int j = 0; j < G::NCH; ++j)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int hc = c * G::FW + j * CN + nt * 8 + 2 * t;
        uint8_t* tile = hid + (hc / TMA_K) * TILE8;
        const int b = hc % TMA_K;
        const unsigned lo =
            (unsigned)(quant(__int_as_float(d[j][nt][0]), inv0) & 0xff) |
            ((unsigned)(quant(__int_as_float(d[j][nt][1]), inv0) & 0xff) << 8);
        const unsigned hi =
            (unsigned)(quant(__int_as_float(d[j][nt][2]), inv1) & 0xff) |
            ((unsigned)(quant(__int_as_float(d[j][nt][3]), inv1) & 0xff) << 8);
        *reinterpret_cast<uint16_t*>(tile + swz(r0, b)) = (uint16_t)lo;
        *reinterpret_cast<uint16_t*>(tile + swz(r0 + 8, b)) = (uint16_t)hi;
      }
  }
  fence_async();
  consumers_sync();                       // HID whole
  if (cidx == 0) MIT_STAMP(7);

  // ---- fc2: partial sums over this block's F/8 hidden columns for each
  // block's D/8 output columns, added into that block's ACC. ACC and the
  // staging are [warpgroup][warp][16 rows][DW] int32: a warp stages and
  // pushes its own 16 rows. Two accumulators: a group's sums go out while
  // the next group's products run. ----
  constexpr int WPART = G::PART / 4;      // a warp's partial sums, bytes
  int* stage_w = reinterpret_cast<int*>(h8 + 2 * G::PART + c * G::PART +
                                        warp * WPART);
  const unsigned long long dhid = wg_desc(hid);
  int d2[2][G::NT2][4];
  // k-step q of group i into acc
  auto kstep = [&](int i, int q, int (&acc)[G::NT2][4]) {
    const int step = G::NCH * G::KT1 + i * G::HT + q, s = step % STAGES;
    {
      MIT_ACC_BEGIN
      mbar_wait(full(s), (step / STAGES) & 1);
      MIT_ACC_END(11)
    }
    const unsigned long long da = dhid + q * (TILE8 >> 4);
    const unsigned long long db = wg_desc(ring + s * G::SB + c * G::DW * TMA_K);
    wg_touch_s32(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TMA_K / 32; ++kk)
      WgmmaS8<G::NT2>::run(acc, da + 2 * kk, db + 2 * kk, q > 0 || kk > 0);
    wg_commit();
    wg_touch_s32(acc);
    wg_wait<1>();                         // every earlier k-step is done
    if (step > G::NCH * G::KT1) mbar_arrive(empty((step - 1) % STAGES));
  };
  // this warp's 16 rows of group i's sums, in acc, into its staging once
  // its last push has read it, then added into the owner's ACC
  auto send = [&](int i, int (&acc)[G::NT2][4]) {
    {
      MIT_ACC_BEGIN
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      MIT_ACC_END(15)
    }
    {
      MIT_ACC_BEGIN
#pragma unroll
      for (int nt = 0; nt < G::NT2; ++nt) {
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<int2*>(stage_w + g * G::DW + col) =
            make_int2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<int2*>(stage_w + (g + 8) * G::DW + col) =
            make_int2(acc[nt][2], acc[nt][3]);
      }
      fence_async();
      __syncwarp();
      MIT_ACC_END(10)
    }
    if (lane == 0) {
      const unsigned owner = (rank + i) % C;
      bulk_push<true>(
          peer(smem_u32(h8 + c * G::PART + warp * WPART), owner),
          smem_u32(stage_w), WPART, peer(acc_full, owner));
    }
  };
#pragma unroll
  for (int i = 0; i < C; ++i) {
    kstep(i, 0, d2[i & 1]);
    if (i > 0) {
      wg_touch_s32(d2[(i - 1) & 1]);
      send(i - 1, d2[(i - 1) & 1]);
    }
#pragma unroll 1
    for (int q = 1; q < G::HT; ++q) kstep(i, q, d2[i & 1]);
  }
  {
    MIT_ACC_BEGIN
    wg_wait<0>();
    MIT_ACC_END(12)
  }
  wg_touch_s32(d2[(C - 1) & 1]);
  mbar_arrive(empty((G::NCH * G::KT1 + C * G::HT - 1) % STAGES));
  send(C - 1, d2[(C - 1) & 1]);
  if (cidx == 0) MIT_STAMP(8);

  // ---- y = dequantized ACC + b2 [+ x] ----
  const bool hb2 = a.b2 != nullptr, hr = a.residual != 0;
  float2 res[G::NT2][2];
#pragma unroll
  for (int nt = 0; nt < G::NT2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      const size_t idx =
          (size_t)m * D + rank * G::DB + c * G::DW + nt * 8 + 2 * t;
      res[nt][h] = make_float2(0.f, 0.f);
      if (hr && m < a.M) {
        if (a.x_bf16) {
          const unsigned u = *reinterpret_cast<const unsigned*>(
              static_cast<const __nv_bfloat16*>(a.x) + idx);
          res[nt][h] = make_float2(__uint_as_float(u << 16),
                                   __uint_as_float(u & 0xffff0000u));
        } else {
          res[nt][h] = *reinterpret_cast<const float2*>(
              static_cast<const float*>(a.x) + idx);
        }
      }
    }
  mbar_wait(acc_full, 0);
  const int* acc = reinterpret_cast<const int*>(h8 + c * G::PART + warp * WPART);
#pragma unroll
  for (int nt = 0; nt < G::NT2; ++nt) {
    const int col = nt * 8 + 2 * t;
    const int n = (int)rank * G::DB + c * G::DW + col;
    const float2 sw = *reinterpret_cast<const float2*>(s2 + c * G::DW + col);
    const float2 bb = *reinterpret_cast<const float2*>(b2 + c * G::DW + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      if (m >= a.M) continue;
      const int2 q = *reinterpret_cast<const int2*>(acc + (g + 8 * h) * G::DW + col);
      const size_t idx = (size_t)m * D + n;
      const float s = h ? sm1 : sm0;
      const float y0 = epilogue<ACT_NONE>(q.x, s, sw.x, hb2, bb.x, hr, res[nt][h].x);
      const float y1 = epilogue<ACT_NONE>(q.y, s, sw.y, hb2, bb.y, hr, res[nt][h].y);
      if (a.out_bf16) {
        *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(a.out) + idx) =
            pack_bf16(y0, y1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + idx) =
            make_float2(y0, y1);
      }
    }
  }
  bulk_wait();                            // this thread's pushes are done
  if (cidx == 0) MIT_STAMP(9);
}

constexpr int MAX_DEVICES = 64;

template <int D, int F, int ACT>
cudaError_t prepare(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int tiles, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(int8_mlp_fused_kernel<D, F, ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geo<D, F>::SMEM);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(tiles * C);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = Geo<D, F>::SMEM;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int D, int F, int ACT>
int launch(const void* w1t, const void* w2t, const MlpArgs& a,
           cudaStream_t stream) {
  CUtensorMap m1, m2;
  cudaError_t e = encode_map(&m1, w1t, F, D, CN);
  if (e == cudaSuccess) e = encode_map(&m2, w2t, D, F, Geo<D, F>::DB);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (e == cudaSuccess)
    e = prepare<D, F, ACT>(&cfg, &attr, (a.M + ROWS - 1) / ROWS, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, int8_mlp_fused_kernel<D, F, ACT>, m1, m2, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int F>
int info(int* smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = prepare<D, F, ACT_GELU>(&cfg, &attr, 1, nullptr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(
        clusters, int8_mlp_fused_kernel<D, F, ACT_GELU>, &cfg);
  *smem = Geo<D, F>::SMEM;
  return static_cast<int>(e);
}

}  // namespace

// x: (M, D) f32 (x_bf16 0) or bf16 (1), contiguous; ln_s, ln_b: (D,) f32,
// or both null for no LayerNorm; w1t: fc1's weight as (F, D) int8 rows
// (w1 (D, F) stored K-contiguous, ops/quant.py kernel_layout); s1, b1:
// (F,) f32 (b1 may be null); w2t: fc2's as (D, F); s2, b2: (D,) f32 (b2
// may be null); out: (M, D) f32 (out_bf16 0) or bf16 (1). residual 1 adds
// x to y. act: 1 gelu (polynomial erf), 2 quick_gelu. (D, F) is one of
// (768, 3072), (1024, 4096), (1280, 5120). Every pointer 16-byte aligned.
extern "C" int mit_int8_mlp_fused(const void* x, const void* ln_s,
                                  const void* ln_b, const void* w1t,
                                  const void* s1, const void* b1,
                                  const void* w2t, const void* s2,
                                  const void* b2, void* out, int M, int D,
                                  int F, int x_bf16, int act, int residual,
                                  int out_bf16, float eps, void* stream) {
  if (M < 1 || (ln_s == nullptr) != (ln_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs a{x, static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<const float*>(s1),
                  static_cast<const float*>(b1), static_cast<const float*>(s2),
                  static_cast<const float*>(b2), out, M, x_bf16, residual,
                  out_bf16, eps};
  auto* s = (cudaStream_t)stream;
#define MIT_MLP_CASE(d_, f_)                                          \
  if (D == d_ && F == f_) {                                           \
    if (act == ACT_GELU) return launch<d_, f_, ACT_GELU>(w1t, w2t, a, s); \
    if (act == ACT_QUICK_GELU)                                        \
      return launch<d_, f_, ACT_QUICK_GELU>(w1t, w2t, a, s);          \
  }
  MIT_MLP_CASE(768, 3072)
  MIT_MLP_CASE(1024, 4096)
  MIT_MLP_CASE(1280, 5120)
#undef MIT_MLP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef MIT_MLP_PROFILE
// the stamps of the last launches (n words), and all of them set to 0
extern "C" int mit_int8_mlp_fused_profile(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, n * 8));
}
extern "C" int mit_int8_mlp_fused_profile_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_prof);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_prof));
  return static_cast<int>(e);
}
#endif

// The kernel's dynamic shared memory a block and how many of its clusters
// the current card holds at once (cudaOccupancyMaxActiveClusters), for a
// (D, F) it takes.
extern "C" int mit_int8_mlp_fused_info(int D, int F, int* smem,
                                       int* clusters) {
  if (D == 768 && F == 3072) return info<768, 3072>(smem, clusters);
  if (D == 1024 && F == 4096) return info<1024, 4096>(smem, clusters);
  if (D == 1280 && F == 5120) return info<1280, 5120>(smem, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}
