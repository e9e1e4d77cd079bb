// Flash attention backward, hand-written for Hopper (sm_90a).
//
// The reference's Pallas TPU kernel (flash_attention / _flash_kernel of
// src/repro/kernels/jet_flash_attention.py) is forward-only: on the TPU
// the gradient comes from JAX differentiating the plain attention.  On the
// card the forward's output comes from csrc/flash_attention.cu through
// ctypes, which autograd cannot see into, so the gradient of the training
// path needs a kernel of its own: this one.  It computes dq, dk and dv of
// o = softmax(scale * q k^T + mask) v with the forward's masks
// (right-aligned causality: query t sees key s when t + S - T >= s; a
// window: t + S - T - s < window; or none), GQA (the gradient of a K/V
// head sums over its Hq / Hkv query heads) and scale D**-0.5.
//
// Layout: q, o, do [B, Hq, T, D]; k, v [B, Hkv, S, D]; lse [B, Hq, T]
// float32, the forward's natural-log m + log l of each row; all
// contiguous.  float32 or bfloat16 in, float32 throughout, gradients out
// in the inputs' type.
//
// Three passes, FA2's design, enqueued from one C call; no atomics, so the
// result is the same bits run to run:
//
// 1. bwd_delta_kernel: delta[row] = sum_d do[row, d] * o[row, d], the
//    softmax's rowsum(dP o P), one warp a row.
// 2. bwd_dkdv_kernel: one block per (b, kv head, BK-key tile) walks the
//    group's query heads and the BQ-query tiles that see its keys
//    (causality and the window bound the range), recomputes
//    P = exp(scale q k^T - lse) and accumulates dv += P^T do and, with
//    dP = do v^T and dS = P o (dP - delta), dk += scale dS^T q in
//    registers.
// 3. bwd_dq_kernel: one block per (b, query head, BQ-query tile) walks
//    the key tiles its rows see and accumulates dq += scale dS k.
//
// A row with no visible key (causal with T > S) gets zero gradients: every
// P of it is masked to 0.
//
// Bound: operations.  The gradient needs 10 D flops per visible (query,
// key) pair (q k^T, do v^T, P^T do, dS^T q, dS k: 2 D each); this design
// does 14 D (passes 2 and 3 both recompute q k^T and do v^T), on the CUDA
// cores in float32.  The first design, right before fast: the products
// run as 4 x 4 register tiles per thread over shared-memory operands (the
// forward's simt scheme); the tensor cores are later work.
//
// Thread layout (256 threads, ty = tid / 16, tx = tid % 16): score tiles
// S, dP [BQ, BK]: thread (ty, tx) holds rows ty * RQ + i, columns
// tx + 16 j.  Accumulators dk, dv [BK, D]: rows ty * RK + i, columns
// tx + 16 j (DJ of them, guarded past D); dq [BQ, D]: rows ty * RQ + i.
// Shared rows: k, v padded to D + 1 words (column reads conflict free),
// q, do padded to D + 4 (the two rows a warp reads fall in distinct
// banks), P / dS to BK + 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ bool visible(int tq, int key, int s_len,
                                        int causal, int window) {
  bool ok = key < s_len;
  if (causal) ok = ok && tq >= key;
  if (window > 0) ok = ok && tq - key < window;
  return ok;
}

// Shared memory of passes 2 and 3 (the same plan, which
// jet_flash_attention.bwd_smem_bytes mirrors): k and v tiles, q and do
// tiles, one P / dS tile, lse and delta of the q tile.
size_t bwd_smem_bytes(int bq, int bk, int d) {
  return sizeof(float) * ((size_t)2 * bk * (d + 1) + (size_t)2 * bq * (d + 4) +
                          (size_t)bq * (bk + 1) + 2 * (size_t)bq);
}

// ---------------------------------------------------------------------------
// pass 1: delta = rowsum(do o)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f(orow[c]) * to_f(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// rows [r0, r0 + rows) of a [n, d] tensor into shared rows of stride st,
// times mul, zero past n
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, int rows, int d, int st,
                                          float mul) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - (i / d) * d;
    dst[r * st + c] =
        r0 + r < n ? to_f(src[(size_t)(r0 + r) * d + c]) * mul : 0.f;
  }
}

// S = q k^T (q pre-scaled) and dP = do v^T of this thread's RQ x RK cells
template <int BQ, int BK>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int d, float (&s)[BQ / 16][BK / 16],
                                       float (&dp)[BQ / 16][BK / 16]) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qst = d + 4, kst = d + 1;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    float qv[RQ], ov[RQ], kv[RK], vv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = qs[(ty * RQ + i) * qst + dd];
      ov[i] = dos[(ty * RQ + i) * qst + dd];
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      kv[j] = ks[(tx + 16 * j) * kst + dd];
      vv[j] = vs[(tx + 16 * j) * kst + dd];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += ov[i] * vv[j];
      }
  }
}

// P and dS of this thread's cells from S and dP (P, dS overwrite them);
// masked cells and rows past T give 0
template <int BQ, int BK>
__device__ __forceinline__ void probs(float (&s)[BQ / 16][BK / 16],
                                      float (&dp)[BQ / 16][BK / 16],
                                      const float* lse_s, const float* dl_s,
                                      int t0, int k0, int t_len, int s_len,
                                      int offset, int causal, int window) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const bool row_in = t0 + r < t_len;
    const int tq = t0 + r + offset;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int key = k0 + tx + 16 * j;
      const float p = row_in && visible(tq, key, s_len, causal, window)
                          ? expf(s[i][j] - lse_s[r])
                          : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: dk, dv
// ---------------------------------------------------------------------------
template <typename T, int BQ, int BK, int DJ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int hq, int hkv, int t_len, int s_len,
                int d, int causal, int window, float scale) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int kst = d + 1, qst = d + 4, pst = BK + 1;
  float* ks = smem;                 // [BK][d + 1]
  float* vs = ks + BK * kst;        // [BK][d + 1]
  float* qs = vs + BK * kst;        // [BQ][d + 4], scaled
  float* dos = qs + BQ * qst;       // [BQ][d + 4]
  float* ps = dos + BQ * qst;       // [BQ][BK + 1]: P, then dS
  float* lse_s = ps + BQ * pst;     // [BQ]
  float* dl_s = lse_s + BQ;         // [BQ]

  const int bkv = blockIdx.x;       // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv - (bkv / hkv) * hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * BK;   // key tile; the heaviest (causal) first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = s_len - t_len;
  const size_t kvbase = (size_t)bkv * s_len * d;

  load_tile(ks, k + kvbase, k0, s_len, BK, d, kst, 1.f);
  load_tile(vs, v + kvbase, k0, s_len, BK, d, kst, 1.f);

  // query rows that see a key of this tile: t + offset >= k0 (causal) and
  // t + offset - k1 < window
  const int k1 = min(k0 + BK, s_len) - 1;
  int t_lo = 0, t_hi = t_len;
  if (causal) t_lo = max(0, k0 - offset);
  if (window > 0) t_hi = min(t_hi, window + k1 - offset);
  const int i_lo = t_lo / BQ;
  const int i_hi = t_hi > t_lo ? (t_hi + BQ - 1) / BQ : i_lo;

  float dka[RK][DJ], dva[RK][DJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + kvh * group + g;
    const size_t qbase = (size_t)bh * t_len * d;
    for (int it = i_lo; it < i_hi; ++it) {
      const int t0 = it * BQ;
      __syncthreads();              // the last tile's q, do, P are free
      load_tile(qs, q + qbase, t0, t_len, BQ, d, qst, scale);
      load_tile(dos, dout + qbase, t0, t_len, BQ, d, qst, 1.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = t0 + r < t_len;
        lse_s[r] = in ? lse[(size_t)bh * t_len + t0 + r] : 0.f;
        dl_s[r] = in ? delta[(size_t)bh * t_len + t0 + r] : 0.f;
      }
      __syncthreads();

      float s[RQ][RK], dp[RQ][RK];
      scores<BQ, BK>(qs, dos, ks, vs, d, s, dp);
      probs<BQ, BK>(s, dp, lse_s, dl_s, t0, k0, t_len, s_len, offset,
                    causal, window);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j)
          ps[(ty * RQ + i) * pst + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dv += P^T do
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RK], ov[DJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) pv[i] = ps[qq * pst + ty * RK + i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int c = tx + 16 * j;
          ov[j] = c < d ? dos[qq * qst + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dva[i][j] += pv[i] * ov[j];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j)
          ps[(ty * RQ + i) * pst + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dk += dS^T (scale q)
      for (int qq = 0; qq < BQ; ++qq) {
        float dv_[RK], qv[DJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) dv_[i] = ps[qq * pst + ty * RK + i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int c = tx + 16 * j;
          qv[j] = c < d ? qs[qq * qst + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dka[i][j] += dv_[i] * qv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty * RK + i;
    if (key >= s_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dk[kvbase + (size_t)key * d + c] = from_f<T>(dka[i][j]);
        dv[kvbase + (size_t)key * d + c] = from_f<T>(dva[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: dq
// ---------------------------------------------------------------------------
template <typename T, int BQ, int BK, int DJ>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int hq, int hkv, int t_len, int s_len,
              int d, int causal, int window, float scale) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int kst = d + 1, qst = d + 4, pst = BK + 1;
  float* ks = smem;
  float* vs = ks + BK * kst;
  float* qs = vs + BK * kst;
  float* dos = qs + BQ * qst;
  float* ps = dos + BQ * qst;       // dS
  float* lse_s = ps + BQ * pst;
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - (bh / hq) * hq;
  const int kvh = h / (hq / hkv);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = s_len - t_len;
  const size_t qbase = (size_t)bh * t_len * d;
  const size_t kvbase = ((size_t)b * hkv + kvh) * s_len * d;

  load_tile(qs, q + qbase, t0, t_len, BQ, d, qst, scale);
  load_tile(dos, dout + qbase, t0, t_len, BQ, d, qst, 1.f);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = t0 + r < t_len;
    lse_s[r] = in ? lse[(size_t)bh * t_len + t0 + r] : 0.f;
    dl_s[r] = in ? delta[(size_t)bh * t_len + t0 + r] : 0.f;
  }

  // key tiles that hold a visible key for some row of this q tile
  const int last_t = min(t0 + BQ, t_len) - 1;
  int hi = s_len;
  if (causal) hi = min(hi, last_t + offset + 1);
  int lo = 0;
  if (window > 0) lo = max(0, t0 + offset - window + 1);
  const int j_lo = lo / BK;
  const int j_hi = (max(hi, 0) + BK - 1) / BK;

  float dqa[RQ][DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;

  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();                // the last tile's k, v, dS are free
    load_tile(ks, k + kvbase, k0, s_len, BK, d, kst, 1.f);
    load_tile(vs, v + kvbase, k0, s_len, BK, d, kst, 1.f);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    scores<BQ, BK>(qs, dos, ks, vs, d, s, dp);
    probs<BQ, BK>(s, dp, lse_s, dl_s, t0, k0, t_len, s_len, offset, causal,
                  window);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j)
        ps[(ty * RQ + i) * pst + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dq += dS k (scaled at the end)
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ], kv[DJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = ps[(ty * RQ + i) * pst + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < d ? ks[kk * kst + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] += dsv[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = t0 + ty * RQ + i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dq[qbase + (size_t)t * d + c] = from_f<T>(dqa[i][j] * scale);
    }
  }
}

template <typename T, int BQ, int BK, int DJ>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bsz, int hq, int hkv, int t_len,
           int s_len, int d, int causal, int window, float scale,
           cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(BQ, BK, d);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, BQ, BK, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, BQ, BK, DJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)bsz * hq * t_len;
  bwd_delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) /
                                   (kThreads / 32)),
                        kThreads, 0, st>>>((const T*)o, (const T*)dout,
                                           delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)(bsz * hkv), (unsigned)((s_len + BK - 1) / BK));
  bwd_dkdv_kernel<T, BQ, BK, DJ><<<g2, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, hq, hkv, t_len, s_len, d, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g3((unsigned)(bsz * hq), (unsigned)((t_len + BQ - 1) / BQ));
  bwd_dq_kernel<T, BQ, BK, DJ><<<g3, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, hq, hkv, t_len, s_len, d, causal, window, scale);
  return (int)cudaGetLastError();
}

// Tiles by head dim: 64 x 64 up to D = 128 (DJ output columns a thread,
// the smallest that covers D), 32 x 32 at D <= 256, where 64-row tiles
// would not fit the 227 KB of shared memory.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int bsz, int hq, int hkv, int t_len,
             int s_len, int d, int causal, int window, float scale,
             cudaStream_t st) {
#define REPRO_BWD(BQ, BK, DJ)                                              \
  return launch<T, BQ, BK, DJ>(q, k, v, o, dout, lse, delta, dq, dk, dv,   \
                               bsz, hq, hkv, t_len, s_len, d, causal,      \
                               window, scale, st)
  if (d <= 64) REPRO_BWD(64, 64, 4);
  if (d <= 80) REPRO_BWD(64, 64, 5);
  if (d <= 128) REPRO_BWD(64, 64, 8);
  REPRO_BWD(32, 32, 16);
#undef REPRO_BWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d a multiple of 8 up to 256.
// window <= 0 means no window.  delta: float32 scratch of B * Hq * T.
// Enqueues the three passes on the stream; returns the CUDA error of the
// launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int bsz, int hq, int hkv, int t_len,
                                   int s_len, int d, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || (dtype != 0 && dtype != 1) || d < 8 ||
      d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, (const float*)lse,
                           (float*)delta, dq, dk, dv, bsz, hq, hkv, t_len,
                           s_len, d, causal, window, scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse,
                                 (float*)delta, dq, dk, dv, bsz, hq, hkv,
                                 t_len, s_len, d, causal, window, scale, st);
}
