// Staged matrix product C[M,N] = A[M,K] @ B[K,N], hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel staged_matmul / _matmul_kernel of
// src/repro/kernels/jet_staged_matmul.py: A and B are consumed in K
// fragments staged through a small recycled buffer, products are summed
// in a float32 accumulator that never leaves the core, and the result is
// cast to the output type once.  A, B and C are row-major and contiguous.
//
// Design: the Pallas grid (M/bm, N/bn, K/bk) ran its K axis in order with
// the accumulator in VMEM scratch; its VMEM blocks (256 x 256 x 512 by
// default, 1.25 MB of staging) do not fit a block's 227 KB of shared
// memory.  Here one block owns one tile of C (128 x 128, or 128 x 256 on
// the wgmma path), keeps the accumulator in registers and walks K itself.
// Out-of-range elements load as 0, which gives the TPU's zero padding, and
// out-of-range outputs are not written.  Three kernels, the wgmma one in
// two tile widths, chosen by the wrapper from the type and the shape alone
// (jet_staged_matmul.variant):
//
// * float32 (simt_f32): on the CUDA cores, no TF32 (the reference sums
//   float32 products in float32).  Fragments of K = 8, double-buffered;
//   256 threads, each an 8 x 8 block of C (two 4 x 4 quadrants, float4
//   reads of both operands from shared memory).
// * bfloat16, K and N multiples of 8 (wgmma_bf16, wgmma_bf16_n256): a
//   ring of K = 64 stages in dynamic shared memory, filled by TMA and
//   drained by wgmma.  Warpgroup 0 is the producer: one thread waits for a
//   free stage (its "empty" mbarrier), announces the stage's bytes on its
//   "full" mbarrier and issues 2-D TMA loads, A's box {64 (K), 128 (M)}
//   and BN / 64 B boxes {64 (N), 64 (K)}, all with the 128-byte swizzle;
//   boxes past the edge are filled with zeros by TMA, so the main loop
//   needs no masks.  Warpgroups 1 and 2 each own 64 rows x BN columns of
//   C (wgmma.m64nBNk16, BN / 2 float32 accumulators a thread): they wait
//   for a full stage, issue four wgmmas on it straight from shared memory
//   (A K-major; B N-major, read transposed), keep one wgmma group in
//   flight and hand the previous stage back to the producer once
//   wgmma.wait_group says it has been read.  The epilogue converts the
//   registers to the output type (round to nearest) and stores them with
//   the ragged rows and columns masked.  TMA needs 16-byte global strides,
//   hence the alignment rule.  Tiles of 128 x 256 (4 stages, 48 KB each)
//   load each A box once per 256 columns of C instead of 128 (25 % fewer
//   bytes from L2 per product), and are used when they still give a full
//   wave of blocks; smaller products take 128 x 128 tiles (5 stages of
//   32 KB), which fill more SMs.
// * other bfloat16 shapes (mma_sync_bf16): mma.sync.m16n8k16 with float32
//   accumulation.  Fragments of K = 32, loaded through registers and
//   double-buffered; 8 warps as 2 x 4, each a 64 x 32 block of C.  B is
//   stored transposed in shared memory so both operands' fragments are
//   32-bit loads; rows are padded to 40 elements.
//
// Bound: operations at the sizes the repository uses (2 M N K flops
// against 2 or 4 bytes per element of A, B and C once: ~330 flops per byte
// at [1024, 2048] @ [2048, 8192], above both ridges): 0.035 ms for that
// product in bfloat16 at 989 TFLOP/s.  One k-block of a 128 x 256 tile is
// 8 x 128 tensor-core clocks, ~0.56 us at the SM's share of that peak;
// the ring keeps three more k-blocks in flight to hide the loads behind
// it.  The grid is not persistent and the epilogue does not overlap the
// next tile's loads.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ------------------------------------------------------------------------
// float32, CUDA cores
// ------------------------------------------------------------------------
constexpr int kF32BM = 128, kF32BN = 128, kF32BK = 8, kF32Pad = 4;

template <typename TO>
__global__ void __launch_bounds__(256)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             TO* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[2][kF32BK][kF32BM + kF32Pad];
  __shared__ __align__(16) float bs[2][kF32BK][kF32BN + kF32Pad];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kF32BM, n0 = blockIdx.x * kF32BN;
  // loaders: A row tid/2, K columns (tid%2)*4..+3; B K row tid/32,
  // columns (tid%32)*4..+3
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const bool vec_a = (k % 4) == 0, vec_b = (n % 4) == 0;
  float ra[4], rb[4];

  auto fetch = [&](int k0) {
    const int gm = m0 + a_row, gk = k0 + a_col;
    if (vec_a && gm < m && gk + 3 < k) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(a + (long long)gm * k + gk));
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = (gm < m && gk + i < k) ? __ldg(a + (long long)gm * k + gk + i)
                                       : 0.f;
    }
    const int bk = k0 + b_row, bn = n0 + b_col;
    if (vec_b && bk < k && bn + 3 < n) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(b + (long long)bk * n + bn));
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[i] = (bk < k && bn + i < n) ? __ldg(b + (long long)bk * n + bn + i)
                                       : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) as[buf][a_col + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&bs[buf][b_row][b_col]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (k + kF32BK - 1) / kF32BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kF32BK);
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < n) c[(long long)gm * n + gn] = from_f<TO>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------------
// bfloat16, tensor cores (mma.sync)
// ------------------------------------------------------------------------
constexpr int kBfBM = 128, kBfBN = 128, kBfBK = 32, kBfLd = kBfBK + 8;

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ unsigned short bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO>
__global__ void __launch_bounds__(256)
bf16_gemm_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, TO* __restrict__ c,
                 int m, int n, int k) {
  // as[buf][row m][k], bs[buf][col n][k] (B transposed)
  __shared__ __align__(16) unsigned short as[2][kBfBM][kBfLd];
  __shared__ __align__(16) unsigned short bs[2][kBfBN][kBfLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kBfBM, n0 = blockIdx.x * kBfBN;
  // loaders: A row tid/2, K columns (tid%2)*16..+15; B K row tid/8,
  // columns (tid%8)*16..+15
  const int a_row = tid >> 1, a_col = (tid & 1) * 16;
  const int b_row = tid >> 3, b_col = (tid & 7) * 16;
  const bool vec_a = (k % 8) == 0, vec_b = (n % 8) == 0;
  uint4 ra[2], rb[2];

  auto fetch = [&](int k0) {
    const int gm = m0 + a_row, gk = k0 + a_col;
    if (vec_a && gm < m && gk + 15 < k) {
      const uint4* p = reinterpret_cast<const uint4*>(a + (long long)gm * k + gk);
      ra[0] = __ldg(p);
      ra[1] = __ldg(p + 1);
    } else {
      unsigned short u[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        u[i] = (gm < m && gk + i < k) ? bits(a + (long long)gm * k + gk + i)
                                      : (unsigned short)0;
      ra[0] = make_uint4(pack2(u[0], u[1]), pack2(u[2], u[3]),
                         pack2(u[4], u[5]), pack2(u[6], u[7]));
      ra[1] = make_uint4(pack2(u[8], u[9]), pack2(u[10], u[11]),
                         pack2(u[12], u[13]), pack2(u[14], u[15]));
    }
    const int bk = k0 + b_row, bn = n0 + b_col;
    if (vec_b && bk < k && bn + 15 < n) {
      const uint4* p = reinterpret_cast<const uint4*>(b + (long long)bk * n + bn);
      rb[0] = __ldg(p);
      rb[1] = __ldg(p + 1);
    } else {
      unsigned short u[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        u[i] = (bk < k && bn + i < n) ? bits(b + (long long)bk * n + bn + i)
                                      : (unsigned short)0;
      rb[0] = make_uint4(pack2(u[0], u[1]), pack2(u[2], u[3]),
                         pack2(u[4], u[5]), pack2(u[6], u[7]));
      rb[1] = make_uint4(pack2(u[8], u[9]), pack2(u[10], u[11]),
                         pack2(u[12], u[13]), pack2(u[14], u[15]));
    }
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<uint4*>(&as[buf][a_row][a_col]) = ra[0];
    *reinterpret_cast<uint4*>(&as[buf][a_row][a_col + 8]) = ra[1];
    const uint32_t w[8] = {rb[0].x, rb[0].y, rb[0].z, rb[0].w,
                           rb[1].x, rb[1].y, rb[1].z, rb[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bs[buf][b_col + 2 * i][b_row] = (unsigned short)(w[i] & 0xffffu);
      bs[buf][b_col + 2 * i + 1][b_row] = (unsigned short)(w[i] >> 16);
    }
  };

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (k + kBfBK - 1) / kBfBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kBfBK);
#pragma unroll
    for (int kk = 0; kk < kBfBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&as[cur][r][kk + t2]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&as[cur][r + 8][kk + t2]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&as[cur][r][kk + t2 + 8]);
        af[i][3] =
            *reinterpret_cast<const uint32_t*>(&as[cur][r + 8][kk + t2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cn = wn + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&bs[cur][cn][kk + t2]);
        bf[j][1] =
            *reinterpret_cast<const uint32_t*>(&bs[cur][cn][kk + t2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int gn = n0 + wn + j * 8 + t2 + (e & 1);
        if (gm < m && gn < n)
          c[(long long)gm * n + gn] = from_f<TO>(acc[i][j][e]);
      }
}

// ------------------------------------------------------------------------
// bfloat16, tensor cores (wgmma fed by TMA through an mbarrier ring)
// ------------------------------------------------------------------------
constexpr int kWgBM = 128, kWgBK = 64;
constexpr int kWgThreads = 384;               // producer + 2 consumers
constexpr int kWgABytes = kWgBM * kWgBK * 2;  // 16 KB: 128 rows of 128 B
constexpr int kWgBBox = kWgBK * 64 * 2;       // 8 KB: 64 K rows of 64 N

// The ring of a BN-column tile: a stage holds A's box and BN / 64 B boxes;
// 1 KB of slack aligns the stages to the 128-byte swizzle's 1 KB period;
// then a full and an empty mbarrier a stage.
template <int BN>
struct WgRing {
  static constexpr int kBoxes = BN / 64;
  static constexpr int kStageBytes = kWgABytes + kBoxes * kWgBBox;
  static constexpr int kStages = BN == 128 ? 5 : 4;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void acc_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x BN] += A[64 x 16] (K-major) @ B[16 x BN] (N-major: transposed)
template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_k16<128>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k16<256>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Needs k % 8 == 0 and n % 8 == 0 (16-byte TMA strides).
template <int BN, typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  TO* __restrict__ c, int m, int n, int k) {
  using R = WgRing<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  // stage s: A at base + s * kStageBytes, then B's BN / 64 boxes
  const uint32_t full = base + R::kStages * R::kStageBytes;
  const uint32_t empty = full + R::kStages * 8;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;
  const int nk = (k + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);      // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {              // producer: one thread issues TMA
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % R::kStages;
        const uint32_t sa = base + s * R::kStageBytes, sb = sa + kWgABytes;
        // the first pass over the ring finds every stage free
        mbar_wait(empty + 8 * s, ((uint32_t)(kb / R::kStages) & 1u) ^ 1u);
        // boxes past the edge count in full: TMA writes their zeros
        mbar_expect_tx(full + 8 * s, R::kStageBytes);
        tma_load_2d(sa, &map_a, full + 8 * s, kb * kWgBK, m0);
#pragma unroll
        for (int i = 0; i < R::kBoxes; ++i)
          tma_load_2d(sb + i * kWgBBox, &map_b, full + 8 * s, n0 + 64 * i,
                      kb * kWgBK);
      }
    }
  } else {
    // consumers: warpgroup 1 rows 0..63 of the tile, warpgroup 2 64..127
    const int cw = threadIdx.x / 128 - 1, lane = threadIdx.x & 31;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % R::kStages;
      const uint32_t sa = base + s * R::kStageBytes, sb = sa + kWgABytes;
      mbar_wait(full + 8 * s, (uint32_t)(kb / R::kStages) & 1u);
      acc_fence<BN / 2>(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // A: 128-byte rows (K), 8-row groups 1 KB apart; K + 16 is +32 B.
        // B: 128-byte rows (N) per K, 8-row groups 1 KB apart, the N boxes
        // 8 KB apart; K + 16 is +2 KB.
        wgmma_k16<BN>(d, smem_desc(sa + cw * 64 * 128 + kk * 32, 16, 1024),
                      smem_desc(sb + kk * 2048, kWgBBox, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // one group stays in flight; the one before it has read its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      acc_fence<BN / 2>(d);
      if (kb > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((kb - 1) % R::kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    acc_fence<BN / 2>(d);

    // warp w of a warpgroup holds rows 16w..16w+15 of its 64; d[4j + e] is
    // row lane / 4 + 8 (e / 2), column 8j + 2 (lane % 4) + e % 2
    const int r0 =
        m0 + cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const int cn = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gn = cn + 8 * j;
      if (gn >= n) continue;            // n is even: gn + 1 < n as well
      if (r0 < m) store2(c + (long long)r0 * n + gn, d[4 * j], d[4 * j + 1]);
      if (r0 + 8 < m)
        store2(c + (long long)(r0 + 8) * n + gn, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

template <typename TO>
int launch_f32(const void* a, const void* b, void* c, int m, int n, int k,
               cudaStream_t st) {
  const dim3 grid((unsigned)((n + kF32BN - 1) / kF32BN),
                  (unsigned)((m + kF32BM - 1) / kF32BM));
  sgemm_kernel<TO><<<grid, 256, 0, st>>>((const float*)a, (const float*)b,
                                         (TO*)c, m, n, k);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                cudaStream_t st) {
  const dim3 grid((unsigned)((n + kBfBN - 1) / kBfBN),
                  (unsigned)((m + kBfBM - 1) / kBfBM));
  bf16_gemm_kernel<TO><<<grid, 256, 0, st>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (TO*)c, m, n, k);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

struct Encoder {
  EncodeTiled fn;
  int err;   // CUDA runtime error of the lookup, 0 on success
};

const Encoder& encoder() {
  static const Encoder e = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && (q != cudaDriverEntryPointSuccess || !fn))
      err = cudaErrorSymbolNotFound;
    return Encoder{(EncodeTiled)fn, (int)err};
  }();
  return e;
}

// host time spent encoding tensor maps, for the smoke test's record
double g_encode_us = 0.0;
long long g_encodes = 0;

// A row-major bf16 [outer, inner] tensor, read in boxes of
// [box_outer, box_inner] with the 128-byte swizzle; boxes past the edge
// read zeros.
CUresult encode_2d(CUtensorMap* map, const void* ptr, int inner, int outer,
                   int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encoder().fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, typename TO>
int launch_wgmma(const void* a, const void* b, void* c, int m, int n, int k,
                 cudaStream_t st) {
  using R = WgRing<BN>;
  if (encoder().err) return encoder().err;
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap map_a, map_b;
  CUresult r = encode_2d(&map_a, a, k, m, kWgBK, kWgBM);
  if (r == CUDA_SUCCESS) r = encode_2d(&map_b, b, n, k, 64, kWgBK);
  g_encode_us += std::chrono::duration<double, std::micro>(
                     std::chrono::steady_clock::now() - t0).count();
  ++g_encodes;
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_gemm_kernel<BN, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + BN - 1) / BN),
                  (unsigned)((m + kWgBM - 1) / kWgBM));
  wgmma_gemm_kernel<BN, TO><<<grid, kWgThreads, R::kSmem, st>>>(
      map_a, map_b, (TO*)c, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int staged_matmul_fwd(const void* a, const void* b, void* c,
                                 int m, int n, int k, int in_dtype,
                                 int out_dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    return launch_f32<float>(a, b, c, m, n, k, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_f32<__nv_bfloat16>(a, b, c, m, n, k, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_bf16<float>(a, b, c, m, n, k, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_bf16<__nv_bfloat16>(a, b, c, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

// The wgmma kernel: bfloat16 a and b, k % 8 == 0 and n % 8 == 0, 16-byte
// aligned; tiles of 128 x bn columns, bn 128 or 256.  out_dtype: 0 =
// float32, 1 = bfloat16.  Returns 0 on success, a CUDA runtime error of
// the encoder lookup, the shared-memory attribute or the launch, or minus
// the CUresult of a failed tensor-map encode.
extern "C" int staged_matmul_wgmma_fwd(const void* a, const void* b, void* c,
                                       int m, int n, int k, int bn,
                                       int out_dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 8 || n % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 128 && out_dtype == 0)
    return launch_wgmma<128, float>(a, b, c, m, n, k, st);
  if (bn == 128 && out_dtype == 1)
    return launch_wgmma<128, __nv_bfloat16>(a, b, c, m, n, k, st);
  if (bn == 256 && out_dtype == 0)
    return launch_wgmma<256, float>(a, b, c, m, n, k, st);
  if (bn == 256 && out_dtype == 1)
    return launch_wgmma<256, __nv_bfloat16>(a, b, c, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a block of the wgmma kernel asks for.
extern "C" int staged_matmul_wgmma_smem_bytes(int bn) {
  return bn == 128 ? WgRing<128>::kSmem
                   : bn == 256 ? WgRing<256>::kSmem : -1;
}

// Host microseconds spent encoding tensor maps, and the launches that
// encoded them, since the library was loaded.
extern "C" void staged_matmul_encode_stats(double* us, long long* calls) {
  *us = g_encode_us;
  *calls = g_encodes;
}
