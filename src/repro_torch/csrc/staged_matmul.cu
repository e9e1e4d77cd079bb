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
// memory.  Here one block owns one 128 x 128 tile of C, keeps the
// accumulator in registers and walks K itself, with the K fragments of A
// and B double-buffered in shared memory (the next fragment is read from
// device memory into registers while the current one is multiplied).  The
// ragged edges are masked: out-of-range elements load as 0, which gives
// the TPU's zero padding, and out-of-range outputs are not written.
//
// * float32: on the CUDA cores, no TF32 (the reference sums float32
//   products in float32).  Fragments of K = 8; 256 threads, each an
//   8 x 8 block of C (two 4 x 4 quadrants, float4 reads of both operands
//   from shared memory).
// * bfloat16: on the tensor cores through mma.sync.m16n8k16 with float32
//   accumulation.  Fragments of K = 32; 8 warps as 2 x 4, each a 64 x 32
//   block of C (4 x 4 MMA tiles, 64 accumulators a thread).  B is stored
//   transposed in shared memory so both operands' fragments are 32-bit
//   loads; rows are padded to 40 elements (conflict-free fragment reads).
//
// Bound: operations at the sizes the repository uses (2 M N K flops
// against 2 or 4 bytes per element of A, B and C once: ~330 flops per byte
// at [1024, 2048] @ [2048, 8192], above both ridges).  Neither path uses
// TMA or wgmma yet, so the bfloat16 path is well below the tensor cores'
// peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
