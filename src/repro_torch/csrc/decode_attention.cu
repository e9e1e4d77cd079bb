// One-token GQA decode attention over a paged KV cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_paged / _decode_kernel
// of src/repro/kernels/jet_decode_attention.py.  Inputs: q [B, Hq, D];
// k / v pages [P, page, Hkv, D]; page table [B, maxp] int32 (-1 = hole);
// lengths [B] int32.  Outputs: o [B, Hq, D] in q's type and lse [B, Hq]
// float32, so that partial results over shards of the pages merge
// (ref.combine_partial_attention).  q and the pages may each be float32
// or bfloat16; all arithmetic is float32.
//
// Design: the Pallas grid (B, maxp) ran its page axis in order on one
// core, with the table and lengths scalar-prefetched and (m, l, acc) in
// VMEM scratch.  Here one block owns one (sequence, KV head): it reads
// its own length and table entries (in place of the scalar prefetch) and
// walks the sequence's positions in order, 64 at a time, so a tile spans
// several pages (or part of one).  The tile's K and V rows are loaded with
// 16-byte loads one tile ahead into registers, so the next tile's reads
// are in flight while this one is computed, and are stored to shared
// memory as float32.  Per tile, for the group's G = Hq / Hkv query heads:
// scores (thread = one position x up to NG heads), the online softmax
// (one warp per head), then P @ V (thread = 4 columns x up to NG heads,
// the accumulator in registers for the whole walk).
//
// As in the reference: q is scaled by D**-0.5 after its cast to float32;
// a hole (-1) reads page 0 (and an entry past the pool its last page, as
// the reference's gather clamps); positions >= length score -1e30, never
// -inf; positions past maxp * page do not exist; at the end
// l = max(l, 1e-30), o = acc / l and lse = m + log(l), so a length-0 row
// gives o = 0 and lse = -1e30 (the reference's plain gather gives the
// mean of v there, with the same lse).
//
// Bound: bytes.  The kernel reads K and V once (4 * D bytes per position
// and KV head in bfloat16) and does 4 * G * D flops on them: G flops per
// byte, under the card's float32 ridge of 20 for G <= 16.  Only B * Hkv
// blocks run (32 at B = 8 with 4 KV heads): a split over pages merged
// through lse is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // positions per tile
constexpr int kMaxD = 128;
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

// K rows in shared memory: a stride whose float4 count is odd, so that
// lanes reading one float4 of consecutive rows hit distinct banks
__host__ __device__ inline int k_stride(int d) {
  return ((d / 4) % 2 == 0) ? d + 4 : d;
}

size_t smem_bytes(int g, int d) {
  return sizeof(float) * ((size_t)g * d + (size_t)kTile * k_stride(d) +
                          (size_t)kTile * d + (size_t)g * kTile + 3 * g);
}

// 16-byte chunk of VEC elements of T
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void store_f(float* dst, const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(to_f(e[i]), to_f(e[i + 1]), to_f(e[i + 2]),
                    to_f(e[i + 3]));
}

// TQ: type of q and o; TKV: type of the pages; NG: query heads a thread
// owns in each phase (the group G is at most 4 * NG)
template <typename TQ, typename TKV, int NG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
              const TKV* __restrict__ vp, const int* __restrict__ table,
              const int* __restrict__ lengths, TQ* __restrict__ out,
              float* __restrict__ lse, int hq, int hkv, int d, int n_pool,
              int page, int maxp, float scale) {
  constexpr int VEC = Vec<TKV>::kN;
  constexpr int CH = kTile * kMaxD / VEC / kThreads;  // chunks per thread
  extern __shared__ float smem[];
  const int g_n = hq / hkv;
  const int ks = k_stride(d);
  float* qs = smem;                       // [G][d] scaled q
  float* kt = qs + g_n * d;               // [kTile][ks]
  float* vt = kt + kTile * ks;            // [kTile][d]
  float* ps = vt + kTile * d;             // [G][kTile] scores, then p
  float* m_s = ps + g_n * kTile;          // [G]
  float* l_s = m_s + g_n;                 // [G]
  float* c_s = l_s + g_n;                 // [G] correction of this tile

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int tid = threadIdx.x;
  const int h0 = kvh * g_n;               // first query head of the group
  const int* row = table + (long long)b * maxp;
  // positions past maxp pages do not exist, as in the reference
  const int len = max(0, min(lengths[b], maxp * page));

  for (int i = tid; i < g_n * d; i += kThreads)
    qs[i] = to_f(q[((long long)b * hq + h0) * d + i]) * scale;
  for (int i = tid; i < g_n; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int cpr = d / VEC;                // chunks per row
  const int n_chunks = kTile * cpr;
  uint4 kr[CH], vr[CH];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const int t = idx / cpr;
      const int pos = t0 + t;
      kr[c] = make_uint4(0u, 0u, 0u, 0u);
      vr[c] = kr[c];
      if (idx < n_chunks && pos < len) {
        const int lp = pos / page;
        const int phys = min(max(__ldg(row + lp), 0), n_pool - 1);
        const long long at =
            (((long long)phys * page + (pos - lp * page)) * hkv + kvh) * d +
            (long long)(idx - t * cpr) * VEC;
        kr[c] = __ldg(reinterpret_cast<const uint4*>(kp + at));
        vr[c] = __ldg(reinterpret_cast<const uint4*>(vp + at));
      }
    }
  };

  // P @ V ownership: 4 columns (dq) x heads gs, gs + gsl, ...
  const int nq = d / 4;
  const int gsl = kThreads / nq;
  const int pv_dq = tid % nq, pv_gs = tid / nq;
  float acc[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // scores ownership: position st x heads sg, sg + 4, ...
  const int st = tid % kTile, sg = tid / kTile;
  const int warp = tid / 32, lane = tid % 32;

  if (len > 0) fetch(0);
  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();                      // last tile's kt / vt / ps free
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      if (idx < n_chunks) {
        const int t = idx / cpr, col = (idx - t * cpr) * VEC;
        store_f<TKV>(kt + t * ks + col, kr[c]);
        store_f<TKV>(vt + t * d + col, vr[c]);
      }
    }
    __syncthreads();
    if (t0 + kTile < len) fetch(t0 + kTile);   // in flight meanwhile

    // scores
    {
      float sc[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) sc[i] = 0.f;
      for (int c = 0; c < d; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + st * ks + c);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int g = sg + 4 * i;
          if (g < g_n) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + g * d + c);
            sc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      }
      const bool in = t0 + st < len;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = sg + 4 * i;
        if (g < g_n) ps[g * kTile + st] = in ? sc[i] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int g = warp; g < g_n; g += kThreads / 32) {
      const float s0 = ps[g * kTile + lane], s1 = ps[g * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[g * kTile + lane] = p0;
      ps[g * kTile + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v over the tile's positions
    if (pv_gs < gsl) {
      const int n_t = min(kTile, len - t0);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = pv_gs + gsl * i;
        if (g < g_n) {
          const float corr = c_s[g];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
        }
      }
      for (int t = 0; t < n_t; ++t) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vt + t * d + 4 * pv_dq);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int g = pv_gs + gsl * i;
          if (g < g_n) {
            const float p = ps[g * kTile + t];
            acc[i][0] += p * vv.x;
            acc[i][1] += p * vv.y;
            acc[i][2] += p * vv.z;
            acc[i][3] += p * vv.w;
          }
        }
      }
    }
  }
  __syncthreads();

  if (pv_gs < gsl) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = pv_gs + gsl * i;
      if (g < g_n) {
        const float l = fmaxf(l_s[g], 1e-30f);
        TQ* o = out + ((long long)b * hq + h0 + g) * d + 4 * pv_dq;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = from_f<TQ>(acc[i][e] / l);
      }
    }
  }
  for (int g = tid; g < g_n; g += kThreads)
    lse[(long long)b * hq + h0 + g] = m_s[g] + logf(fmaxf(l_s[g], 1e-30f));
}

template <typename TQ, typename TKV, int NG>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* out, float* lse, int bsz, int hq,
           int hkv, int d, int n_pool, int page, int maxp, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hq / hkv, d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<TQ, TKV, NG><<<bsz * hkv, kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, table, lengths,
      (TQ*)out, lse, hq, hkv, d, n_pool, page, maxp, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_group(const void* q, const void* kp, const void* vp, const int* table,
             const int* lengths, void* out, float* lse, int bsz, int hq,
             int hkv, int d, int n_pool, int page, int maxp, float scale,
             cudaStream_t st) {
  const int g = hq / hkv;
  if (g <= 4)
    return launch<TQ, TKV, 1>(q, kp, vp, table, lengths, out, lse, bsz, hq,
                              hkv, d, n_pool, page, maxp, scale, st);
  if (g <= 16)
    return launch<TQ, TKV, 4>(q, kp, vp, table, lengths, out, lse, bsz, hq,
                              hkv, d, n_pool, page, maxp, scale, st);
  return launch<TQ, TKV, 8>(q, kp, vp, table, lengths, out, lse, bsz, hq,
                            hkv, d, n_pool, page, maxp, scale, st);
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  Needs D <= 128 with
// D * sizeof(page element) a multiple of 16 bytes, Hq / Hkv <= 32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* kp, const void* vp, const int* table,
    const int* lengths, void* out, float* lse, int bsz, int hq, int hkv,
    int d, int n_pool, int page, int maxp, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  const int vec = kv_dtype == 0 ? 4 : 8;
  if (d < 1 || d > kMaxD || d % vec != 0 || hkv < 1 || hq % hkv != 0 ||
      hq / hkv > 32 || page < 1 || maxp < 1 || n_pool < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return by_group<float, float>(q, kp, vp, table, lengths, out, lse, bsz,
                                  hq, hkv, d, n_pool, page, maxp, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_group<float, __nv_bfloat16>(q, kp, vp, table, lengths, out,
                                          lse, bsz, hq, hkv, d, n_pool, page,
                                          maxp, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_group<__nv_bfloat16, float>(q, kp, vp, table, lengths, out,
                                          lse, bsz, hq, hkv, d, n_pool, page,
                                          maxp, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_group<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, table, lengths, out, lse, bsz, hq, hkv, d, n_pool, page,
        maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}
