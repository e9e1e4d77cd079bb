// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention / _flash_kernel of
// src/repro/kernels/jet_flash_attention.py: causal, sliding-window or
// non-causal GQA attention with an online softmax whose (m, l, acc) carry
// is float32, and right-aligned causality (query t sees key s when
// t + S - T >= s, so a T < S query block attends like decode).
//
// Layout: q [B, Hq, T, D], k / v [B, Hkv, S, D], out [B, Hq, T, D], all
// contiguous; float32 or bfloat16 in, float32 arithmetic, out in q's type.
// The query's kv head is hq / (Hq / Hkv).
//
// Design: the Pallas grid (b*Hq, q tiles, kv tiles) ran its kv axis in
// order on one core, carrying (m, l, acc) in VMEM scratch.  On Hopper the
// blocks run in no order, so one block owns one (b*Hq, 64-row q tile) and
// loops over the 64-key kv tiles itself; the carry stays in registers for
// the whole loop.  256 threads: thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3 and key columns tx + 16*j of the score tile, and output
// columns tx + 16*j of those rows; a row's max and sum are reduced across
// its 16 threads with warp shuffles.  The scaled q tile, the k and v tiles
// and the probability tile sit in shared memory (at most 112 KB at
// D = 128).  Key tiles wholly past the causal diagonal or before the
// window of every row of the q tile are skipped: for a row with a visible
// key, a fully masked tile changes nothing (before its first visible key
// the correction factor exp(-1e30 - m) = 0 wipes it, after it p = 0).
//
// Bound: operations.  Per (b, hq) the work is 4*T*S*D flops (half of that
// under causality), against 2*D*(T + 2*S) + 2*T*D bytes; at the serving
// path's [1, 32, 1024, 64] that is ~64 flop per byte, above the card's
// float32 ridge (67 TFLOP/s over 3.35 TB/s = 20).  This first kernel runs
// on the CUDA cores (no tensor cores: TF32 would break the float32 parity
// with the reference); products read both operands from shared memory, so
// it is shared-memory-bandwidth bound well below the float32 peak.
//
// Arithmetic, as the reference: q is scaled by D**-0.5 first; masked
// scores are the sentinel -1e30, never -inf (exp(-inf - -inf) is NaN);
// the output is acc / max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBKV * (d + 1) +
                          (size_t)kBKV * d + (size_t)kBQ * kBKV);
}

// DJ: output columns per thread (tx + 16 * j for j < DJ, those < D).
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
             int t_len, int s_len, int d, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  const int kst = d + 1;               // padded k row: conflict-free columns
  float* qs = smem;                    // [kBQ][d]   scaled q
  float* ks = qs + kBQ * d;            // [kBKV][d+1]
  float* vs = ks + kBKV * kst;         // [kBKV][d]
  float* ps = vs + kBKV * d;           // [kBQ][kBKV] probabilities

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - (bh / hq) * hq;
  const int kvh = h / (hq / hkv);
  const int t0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int offset = s_len - t_len;
  const long long qbase = (long long)bh * t_len * d;
  const long long kbase = ((long long)b * hkv + kvh) * (long long)s_len * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - (i / d) * d;
    const int t = t0 + r;
    qs[i] = t < t_len ? to_f(q[qbase + (long long)t * d + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DJ; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that hold a visible key for some row of this q tile
  const int last_t = min(t0 + kBQ, t_len) - 1;
  int hi = s_len;
  if (causal) hi = min(hi, last_t + offset + 1);
  int lo = 0;
  if (window > 0) lo = max(0, t0 + offset - window + 1);
  const int j_lo = lo / kBKV;
  const int j_hi = (max(hi, 0) + kBKV - 1) / kBKV;

  for (int j = j_lo; j < j_hi; ++j) {
    const int s0 = j * kBKV;
    __syncthreads();                   // last tile's ks / vs / ps are free
    for (int i = tid; i < kBKV * d; i += kThreads) {
      const int r = i / d, c = i - (i / d) * d;
      const int s = s0 + r;
      const bool in = s < s_len;
      const long long g = kbase + (long long)s * d + c;
      ks[r * kst + c] = in ? to_f(k[g]) : 0.f;
      vs[i] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * d + dd];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[(tx + 16 * jj) * kst + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] += qv[i] * kv[jj];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tq = t0 + ty * 4 + i + offset;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int s = s0 + tx + 16 * jj;
        bool ok = s < s_len;
        if (causal) ok = ok && tq >= s;
        if (window > 0) ok = ok && tq - s < window;
        if (!ok) sc[i][jj] = kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        ps[(ty * 4 + i) * kBKV + tx + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DJ; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int ss = 0; ss < kBKV; ++ss) {
      float vv[DJ];
#pragma unroll
      for (int c = 0; c < DJ; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? vs[ss * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * kBKV + ss];
#pragma unroll
        for (int c = 0; c < DJ; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= t_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DJ; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        out[qbase + (long long)t * d + col] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int bsz,
           int hq, int hkv, int t_len, int s_len, int d, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(bsz * hq), (unsigned)((t_len + kBQ - 1) / kBQ));
  flash_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hkv, t_len, s_len,
      d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int bsz, int hq, int hkv, int t_len, int s_len, int d,
             int causal, int window, float scale, cudaStream_t st) {
  // two widths keep the build short: D <= 64 (zamba2, gemma's 64-wide
  // heads) and D <= 128 (danube's 80); columns past D are guarded off
  if (d <= 64)
    return launch<T, 4>(q, k, v, out, bsz, hq, hkv, t_len, s_len, d, causal,
                        window, scale, st);
  return launch<T, 8>(q, k, v, out, bsz, hq, hkv, t_len, s_len, d, causal,
                      window, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int bsz,
                                   int hq, int hkv, int t_len, int s_len,
                                   int d, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, bsz, hq, hkv, t_len, s_len, d,
                           causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, bsz, hq, hkv, t_len, s_len,
                                   d, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
