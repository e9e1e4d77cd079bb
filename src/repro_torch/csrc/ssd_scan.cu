// Chunked Mamba2 SSD scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan / _ssd_kernel of
// src/repro/kernels/mamba2_ssd.py.  The recurrence
//     h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t^T,    y_t = c_t h_t
// is computed chunk by chunk: within a chunk of L steps a masked
// decay-attention, across chunks an (N, P) float32 state carry.
//
// Layout: x [B, T, H, P], dt [B, T, H], b / c [B, T, G, N], all contiguous
// and of one type (float32 or bfloat16); a [H] float32.  Out: y [B, T, H, P]
// in x's type and the final state h [B, H, N, P] float32.  Head h reads
// b / c of group h / (H / G).  The state starts at zero.
//
// Design: the Pallas grid (B, H, chunks) ran its chunk axis in order and
// kept the state in VMEM scratch between grid steps.  On Hopper blocks run
// in no order, so one block owns one (b, h) and walks its chunks in order
// in a loop, with the state in shared memory.  Per chunk the block stages
// x [L, P], b [L, N], dt and the prefix sum cum of dt*a in shared memory,
// then produces y row tile by row tile (kRows rows at a time): the scores
// c_l . b_m for m <= l, times exp(cum_l - cum_m) * dt_m, are held for the
// row tile only ([kRows, L], never the [L, L] matrix: at L = 256 that alone
// would be 256 KB, over the 227 KB a block may use).  y = scores @ x +
// exp(cum_l) * (c_l @ h); then the state moves on:
// h = exp(cum_{L-1}) h + sum_l b_l (dt_l exp(cum_{L-1} - cum_l)) x_l^T.
// Above the diagonal seg = cum_l - cum_m is positive and exp(seg) may
// overflow, so those entries are never computed: they are selected away,
// never multiplied by a zero mask (inf * 0 is NaN).
//
// Bound: operations.  Per (b, h) and chunk the work is ~L^2 (N + P)
// (causal half of the scores and of scores @ x) + 4 L N P flops against
// L (2N + P + 1) input and L P output elements: at L = 256, N = P = 64
// that is ~48 flop per byte, above the float32 ridge of 20.  The block count is
// B * H: at the serving path's B = 1, H = 64 that is 64 blocks on 132 SMs,
// so at most half the card works (a later kernel splits heads or chunks).
// Products read their operands from shared memory on the CUDA cores (no
// tensor cores: TF32 would break the float32 parity with the reference).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace

// Shared-memory bytes the kernel needs at (L, N, P); the wrapper checks it
// against the card's per-block limit before launching.
extern "C" long long ssd_scan_smem_bytes(int L, int N, int P) {
  const long long ns = N + 1;
  return (long long)sizeof(float) *
         ((long long)L * P + L * ns + (long long)N * P + 3LL * L +
          kRows * ns + (long long)kRows * L);
}

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, T* __restrict__ y,
           float* __restrict__ hout, int t_len, int H, int P, int G, int N,
           int L) {
  extern __shared__ float smem[];
  const int ns = N + 1;              // padded b / c rows: conflict-free
  float* xs = smem;                  // [L][P]
  float* bs = xs + L * P;            // [L][N+1]
  float* hs = bs + L * ns;           // [N][P]   the carried state
  float* cum = hs + N * P;           // [L]      prefix sum of dt * a
  float* dts = cum + L;              // [L]
  float* wts = dts + L;              // [L]      dt_l exp(cum_last - cum_l)
  float* cs = wts + L;               // [kRows][N+1]
  float* sc = cs + kRows * ns;       // [kRows][L]

  const int bi = blockIdx.x / H;
  const int hi = blockIdx.x - bi * H;
  const int gi = hi / (H / G);
  const float av = a[hi];
  const int tid = threadIdx.x;
  const int n_chunks = t_len / L;

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const long long row0 = (long long)bi * t_len + (long long)ci * L;
    __syncthreads();                 // last chunk is done with xs / bs / hs
    for (int e = tid; e < L * P; e += kThreads) {
      const int l = e / P, p = e - (e / P) * P;
      xs[e] = to_f(x[((row0 + l) * H + hi) * P + p]);
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, n = e - (e / N) * N;
      bs[l * ns + n] = to_f(b[((row0 + l) * G + gi) * N + n]);
    }
    for (int l = tid; l < L; l += kThreads)
      dts[l] = to_f(dt[(row0 + l) * H + hi]);
    __syncthreads();

    if (tid < 32) {                  // inclusive prefix sum, one warp
      const int per = (L + 31) / 32;
      const int beg = min(tid * per, L), end = min(beg + per, L);
      float run = 0.f;
      for (int l = beg; l < end; ++l) {
        run += dts[l] * av;
        cum[l] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, o);
        if (tid >= o) tot += up;
      }
      const float excl = tot - run;
      for (int l = beg; l < end; ++l) cum[l] += excl;
    }
    __syncthreads();
    const float c_last = cum[L - 1];
    for (int l = tid; l < L; l += kThreads)
      wts[l] = dts[l] * expf(c_last - cum[l]);

    for (int r0 = 0; r0 < L; r0 += kRows) {
      const int rows = min(kRows, L - r0);
      const int mmax = r0 + rows;    // keys m <= l < r0 + rows
      __syncthreads();               // last row tile is done with cs / sc
      for (int e = tid; e < rows * N; e += kThreads) {
        const int i = e / N, n = e - (e / N) * N;
        cs[i * ns + n] = to_f(c[((row0 + r0 + i) * G + gi) * N + n]);
      }
      __syncthreads();
      for (int e = tid; e < rows * mmax; e += kThreads) {
        const int i = e / mmax, m = e - (e / mmax) * mmax;
        const int l = r0 + i;
        float s = 0.f;
        if (m <= l) {
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot += cs[i * ns + n] * bs[m * ns + n];
          s = dot * expf(cum[l] - cum[m]) * dts[m];
        }
        sc[i * L + m] = s;
      }
      __syncthreads();
      for (int e = tid; e < rows * P; e += kThreads) {
        const int i = e / P, p = e - (e / P) * P;
        const int l = r0 + i;
        float yi = 0.f;
        for (int m = 0; m <= l; ++m) yi += sc[i * L + m] * xs[m * P + p];
        float ch = 0.f;
        for (int n = 0; n < N; ++n) ch += cs[i * ns + n] * hs[n * P + p];
        y[((row0 + l) * H + hi) * P + p] = from_f<T>(yi + expf(cum[l]) * ch);
      }
    }
    __syncthreads();                 // every row has read the old state
    const float decay = expf(c_last);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e - (e / P) * P;
      float s = 0.f;
      for (int l = 0; l < L; ++l) s += (bs[l * ns + n] * wts[l]) * xs[l * P + p];
      hs[e] = decay * hs[e] + s;
    }
  }
  __syncthreads();
  float* ho = hout + (long long)blockIdx.x * N * P;
  for (int e = tid; e < N * P; e += kThreads) ho[e] = hs[e];
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, void* y, float* h, int bsz, int t_len, int H,
           int P, int G, int N, int L, cudaStream_t stream) {
  const long long smem = ssd_scan_smem_bytes(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<(unsigned)(bsz * H), kThreads, (size_t)smem, stream>>>(
      (const T*)x, (const T*)dt, a, (const T*)b, (const T*)c, (T*)y, h,
      t_len, H, P, G, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and y).  T must divide by
// L and H by G.  Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const float* a,
                            const void* b, const void* c, void* y, float* h,
                            int bsz, int t_len, int H, int P, int G, int N,
                            int L, int dtype, void* stream) {
  if (L < 1 || t_len % L != 0 || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, y, h, bsz, t_len, H, P, G, N, L, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, h, bsz, t_len, H, P, G,
                                 N, L, st);
  return (int)cudaErrorInvalidValue;
}
