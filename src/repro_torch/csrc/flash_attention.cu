// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention / _flash_kernel of
// src/repro/kernels/jet_flash_attention.py: causal, sliding-window or
// non-causal GQA attention with an online softmax whose (m, l, acc) carry
// is float32, and right-aligned causality (query t sees key s when
// t + S - T >= s, so a T < S query block attends like decode).
//
// Layout: q [B, Hq, T, D], k / v [B, Hkv, S, D], out [B, Hq, T, D], all
// contiguous; float32 or bfloat16 in, float32 accumulation, out in q's
// type.  The query's kv head is hq / (Hq / Hkv).
//
// Arithmetic, as the reference: scores are q . k scaled by D**-0.5;
// masked scores are the sentinel -1e30, never -inf (exp(-inf - -inf) is
// NaN); the output is acc / max(l, 1e-30).
//
// Bound: operations.  Per (b, hq) the work is 4*T*S*D flops over the
// visible (query, key) pairs (about half of T*S under causality) against
// 2*D*(T + 2*S) + 2*T*D elements moved; at the serving path's
// [1, 32, 1024, 64] float32 that is ~64 flop per byte, above both the
// float32 ridge (67 TFLOP/s over 3.35 TB/s = 20) and the TF32 one.
//
// Two kernels, picked by jet_flash_attention.variant before the launch:
//
// * flash_mma_kernel (variants mma_bf16, mma_3xtf32; D a multiple of 8,
//   D <= 256): the products on the tensor cores through mma.sync.
//   - One block of 4 warps owns one (b*Hq, 64-row q tile); each warp owns
//     16 rows and walks the block's K/V tiles (64 keys; 32 for float32 at
//     D > 80) with its (m, l, acc) carry in registers.  Key tiles wholly
//     past the causal diagonal or before the window of every row of the q
//     tile are never loaded; a warp skips the products of a tile no row of
//     its own sees, and masks only tiles some of its rows see in part.
//     (For a row with a visible key, a fully masked tile changes nothing:
//     before its first visible key the correction exp(-1e30 - m) = 0 wipes
//     it, after it p = 0.)  The q tiles run heaviest first.
//   - K/V tiles arrive by 16-byte cp.async (zero fill past S and past D)
//     in a ring of 2 stages: tile j+1 is in flight while tile j is
//     computed.  Shared-memory rows are the head dim zero-padded to its
//     tile (zeros add nothing to q . k) plus 16 bytes, an odd number of
//     16-byte units, so ldmatrix reads its 8 rows from 8 distinct bank
//     groups.
//   - The two types share one fragment layout in bytes: a 32-bit register
//     holds two bfloat16 or one float32, so m16n8k16 bf16 and m16n8k8 tf32
//     take their A, B and C fragments from the same ldmatrix addresses.
//     S = Q.K^T takes Q and K by ldmatrix; O += P.V takes P from the S
//     accumulators, never through shared memory.
//   - bfloat16 (mma_bf16): m16n8k16 with float32 accumulators.  The q
//     fragments stay in registers for the whole loop (D <= 128); S is
//     scaled by D**-0.5 in float32 after the exact bf16 products (scaling
//     q first would round it to bfloat16 once more).  V's B fragments come
//     from ldmatrix.trans; the two n8 accumulator tiles of a 16-key slice
//     pack into one k16 A fragment (cvt.rn.bf16x2.f32).
//   - float32 (mma_3xtf32): m16n8k8 tf32 through a 3xTF32 split that keeps
//     float32 accuracy.  q is scaled in float32 first, as the reference
//     does.  Each operand x splits into big = cvt.rna.tf32(x) and small =
//     x - big (exact), of which the tensor core reads tf32's bits; each
//     product is small.big + big.small + big.big into the float32
//     accumulator.  An operand is held to 2**-21 of itself, and the
//     dropped small.small term is below 2**-22 of the product.  The C
//     fragment (cols 2t, 2t+1) is not the tf32 A fragment (cols t, t+4),
//     so each 8-key slice of P.V runs its keys in the order
//     0, 2, 4, 6, 1, 3, 5, 7 (logical k = t is key 2t, k = t + 4 is key
//     2t + 1): P's A fragment is then the accumulator itself, and V's B
//     fragment reads rows 2t and 2t + 1 (scalar loads, bank-conflict free
//     at a row stride of 4 mod 8 words).
//   - Head-dim tiles of 32, 64, 80, 128 and 256 (the smallest that holds
//     D; each registry head dim has its own), so every loop over the head
//     dim has a fixed trip count and a tile's products are one block of
//     straight-line code that ptxas can interleave.  A 3xTF32 kernel's
//     ceiling is the TF32 rate over 3, 495 / 3 = 165 TFLOP/s.
//
// * flash_simt_kernel (variant simt; any other D <= 128): the first
//   kernel, on the CUDA cores in float32.  256 threads: thread (ty, tx) owns
//   query rows 4*ty .. 4*ty+3 and key columns tx + 16*j of the score tile,
//   and output columns tx + 16*j of those rows; the scaled q tile, the k
//   and v tiles and the probability tile sit in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// --------------------------------------------------------------------------
// simt: float32 on the CUDA cores
// --------------------------------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBKV = 64;
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

size_t simt_smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBKV * (d + 1) +
                          (size_t)kBKV * d + (size_t)kBQ * kBKV);
}

// DJ: output columns per thread (tx + 16 * j for j < DJ, those < D).
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int hq,
                  int hkv, int t_len, int s_len, int d, int causal,
                  int window, float scale) {
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
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int bsz, int hq, int hkv, int t_len, int s_len, int d,
                int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(bsz * hq), (unsigned)((t_len + kBQ - 1) / kBQ));
  flash_simt_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hkv, t_len, s_len,
      d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* out,
                  int bsz, int hq, int hkv, int t_len, int s_len, int d,
                  int causal, int window, float scale, cudaStream_t st) {
  // two widths keep the build short: D <= 64 and D <= 128; columns past D
  // are guarded off
  if (d <= 64)
    return launch_simt<T, 4>(q, k, v, out, bsz, hq, hkv, t_len, s_len, d,
                             causal, window, scale, st);
  return launch_simt<T, 8>(q, k, v, out, bsz, hq, hkv, t_len, s_len, d,
                           causal, window, scale, st);
}

// --------------------------------------------------------------------------
// mma: the tensor cores through mma.sync
// --------------------------------------------------------------------------
constexpr int kMmaThreads = 128;      // 4 warps, 16 q rows each
constexpr int kMmaBQ = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Per type and head-dim tile DT (the head dim zero-padded to DT): keys a
// K/V tile (32 for float32 past D = 80: two blocks to an SM at D = 128,
// one at 256, where a 64-key K plus V tile alone would take 128 KB); the
// ring's depth; whether the q fragments stay in registers (32 of them: DT <=
// 128 in bfloat16, DT <= 64 in float32, where the split doubles them);
// 32-byte steps over the head dim, n8 output tiles, and the shared row,
// DT's bytes plus 16.  Every loop over the head dim has a trip count known
// to the compiler, so each tile's products form one block of code that
// ptxas can interleave.
template <typename T, int DT>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBKV = (kF32 && DT > 80) ? 32 : 64;
  static constexpr int kStages = 2;   // K/V ring depth
  static constexpr bool kQReg = DT * (int)sizeof(T) <= 256;
  static constexpr int kKSteps = DT * (int)sizeof(T) / 32;
  static constexpr int kDTiles = DT / 8;
  static constexpr int kRow = DT * (int)sizeof(T) + 16;
};

// f(DT) at the head-dim tile of D: the smallest of 32, 64, 80, 128, 256
// that holds it (each registry head dim has its own), as an
// std::integral_constant; D <= 256.
template <typename F>
auto with_d_tile(int d, F&& f) {
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 80) return f(std::integral_constant<int, 80>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

template <typename T, int DT>
size_t mma_smem_bytes() {
  using TL = Tile<T, DT>;
  return (size_t)TL::kRow * (kMmaBQ + 2 * TL::kStages * TL::kBKV);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small.  big is cvt.rna.tf32.f32(x) (to nearest, ties away,
// at tf32's 11 significant bits) in two integer operations: add half the
// weight of the 13 dropped bits to the magnitude and clear them (the cvt
// itself compiles to a longer guarded sequence on sm_90, a fifth slower on
// the H100 at the serve path's shape).  small = x - big is exact, and the
// tensor core reads its tf32 bits (the upper 19).  A NaN x keeps a NaN
// small, so NaN still propagates; an infinite x gives NaN.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(__uint_as_float(x),
                                    __uint_as_float(big)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A operand of one 32-byte step (16 rows) and B operand of one step and
// one n8 tile, from the registers ldmatrix (or the accumulators) give.
template <typename T>
struct AFrag;
template <typename T>
struct BFrag;
template <>
struct AFrag<__nv_bfloat16> {
  uint32_t x[4];
  __device__ __forceinline__ void set(const uint32_t* r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = r[i];
  }
};
template <>
struct BFrag<__nv_bfloat16> {
  uint32_t x[2];
  __device__ __forceinline__ void set(uint32_t r0, uint32_t r1) {
    x[0] = r0;
    x[1] = r1;
  }
};
template <>
struct AFrag<float> {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const uint32_t* r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(r[i], big[i], small[i]);
  }
};
template <>
struct BFrag<float> {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(uint32_t r0, uint32_t r1) {
    split_tf32(r0, big[0], small[0]);
    split_tf32(r1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma(float* c,
                                    const AFrag<__nv_bfloat16>& a,
                                    const BFrag<__nv_bfloat16>& b) {
  mma_bf16(c, a.x, b.x[0], b.x[1]);
}

// 3xTF32: small.big + big.small + big.big, in that order
__device__ __forceinline__ void mma(float* c, const AFrag<float>& a,
                                    const BFrag<float>& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// __launch_bounds__(.., 1) lets ptxas use the registers its schedule wants
// (113-241; two blocks to an SM up to D = 128): 15-35 % faster in float32
// on the H100 than its default budget, which spilled at D = 80.
template <typename T, int DT>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int hq,
                 int hkv, int t_len, int s_len, int d, int causal,
                 int window, float scale) {
  using TL = Tile<T, DT>;
  constexpr int BKV = TL::kBKV, kStages = TL::kStages;
  constexpr bool F32 = TL::kF32;
  constexpr int ES = sizeof(T);
  constexpr int rs = TL::kRow;                // shared row, bytes
  constexpr int pchunk = DT * ES / 16;        // 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char mma_smem[];

  const int nchunk = d * ES / 16;             // ... holding D's values
  unsigned char* qs = mma_smem;               // [64][rs]
  unsigned char* kv0 = mma_smem + kMmaBQ * rs;  // stage: K [BKV][rs], V

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - (bh / hq) * hq;
  const int kvh = h / (hq / hkv);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;  // heaviest first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int offset = s_len - t_len;
  const T* qg = q + (size_t)bh * t_len * d;
  const T* kg = k + ((size_t)b * hkv + kvh) * (size_t)s_len * d;
  const T* vg = v + ((size_t)b * hkv + kvh) * (size_t)s_len * d;

  // kv tiles that hold a visible key for some row of this q tile
  const int last_t = min(t0 + kMmaBQ, t_len) - 1;
  int hi = s_len;
  if (causal) hi = min(hi, last_t + offset + 1);
  int lo = 0;
  if (window > 0) lo = max(0, t0 + offset - window + 1);
  const int j_lo = lo / BKV;
  const int ntiles = max((max(hi, 0) + BKV - 1) / BKV - j_lo, 0);

  // rows [r0, r0 + rows) of a [n, d] tensor into shared rows, zero past n
  // and past d
  auto load_rows = [&](unsigned char* dst, const T* src, int r0, int n,
                       int rows) {
    for (int i = tid; i < rows * pchunk; i += kMmaThreads) {
      const int r = i / pchunk, c = i - (i / pchunk) * pchunk;
      const bool in = r0 + r < n && c < nchunk;
      const T* from = in ? src + (size_t)(r0 + r) * d + c * (16 / ES) : src;
      cp_async16(smem_u32(dst + r * rs + c * 16), from, in);
    }
  };
  auto load_tile = [&](int i) {
    unsigned char* ks = kv0 + (i % kStages) * 2 * BKV * rs;
    load_rows(ks, kg, (j_lo + i) * BKV, s_len, BKV);
    load_rows(ks + BKV * rs, vg, (j_lo + i) * BKV, s_len, BKV);
  };

  load_rows(qs, qg, t0, t_len, kMmaBQ);
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  if constexpr (F32) {   // q * D**-0.5 in float32 first, as the reference
    for (int i = tid; i < kMmaBQ * DT; i += kMmaThreads) {
      float* p = reinterpret_cast<float*>(qs + (i / DT) * rs) + i % DT;
      *p *= scale;
    }
    __syncthreads();
  }

  // ldmatrix addresses of this lane: A (16 rows x 32 bytes: row halves
  // 0-7 / 8-15 by lane bit 3, byte halves by bit 4), B from K (keys 0-7 /
  // 8-15 by bit 4, byte halves by bit 3), B from V transposed (keys by bit
  // 3, 16-byte column halves by bit 4)
  const int wr = warp * 16;
  const uint32_t q_addr = smem_u32(qs) +
      (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;
  const int k_off =
      ((lane & 7) + (lane >> 4) * 8) * rs + ((lane >> 3) & 1) * 16;
  const int v_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;

  AFrag<T> qf[TL::kQReg ? TL::kKSteps : 1];
  if constexpr (TL::kQReg) {
#pragma unroll
    for (int kk = 0; kk < TL::kKSteps; ++kk) {
      uint32_t r[4];
      ldsm_x4(r, q_addr + kk * 32);
      qf[kk].set(r);
    }
  }

  float o[TL::kDTiles][4];
#pragma unroll
  for (int i = 0; i < TL::kDTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // this warp's rows and the keys its first and last row see
  const int r_lo = t0 + wr, r_hi = min(r_lo + 15, t_len - 1);
  const bool live = r_lo < t_len;
  const int see_hi_first =
      causal ? min(r_lo + offset, s_len - 1) : s_len - 1;
  const int see_hi_last = causal ? min(r_hi + offset, s_len - 1) : s_len - 1;
  const int see_lo_first =
      window > 0 ? max(r_lo + offset - window + 1, 0) : 0;
  const int see_lo_last =
      window > 0 ? max(r_hi + offset - window + 1, 0) : 0;

  for (int i = 0; i < ntiles; ++i) {
    const int s0 = (j_lo + i) * BKV, s1 = s0 + BKV - 1;
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* ks = kv0 + (i % kStages) * 2 * BKV * rs;
    const unsigned char* vs = ks + BKV * rs;
    if (live && s0 <= see_hi_last && s1 >= see_lo_first) {
      const bool full = s0 >= see_lo_last && s1 <= see_hi_first;
      float s[BKV / 8][4];
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

      // S = Q K^T
      const uint32_t k_addr = smem_u32(ks) + k_off;
#pragma unroll
      for (int kk = 0; kk < TL::kKSteps; ++kk) {
        AFrag<T> a;
        if constexpr (TL::kQReg) {
          a = qf[kk];
        } else {
          uint32_t r[4];
          ldsm_x4(r, q_addr + kk * 32);
          a.set(r);
        }
#pragma unroll
        for (int n2 = 0; n2 < BKV / 16; ++n2) {
          uint32_t r[4];
          ldsm_x4(r, k_addr + n2 * 16 * rs + kk * 32);
          BFrag<T> b0, b1;
          b0.set(r[0], r[1]);
          b1.set(r[2], r[3]);
          mma(s[2 * n2], a, b0);
          mma(s[2 * n2 + 1], a, b1);
        }
      }

      // scale (bfloat16: after the exact products), mask, online softmax
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (!F32) s[n][e] *= scale;
          if (!full) {
            const int tqo = r_lo + g + (e >> 1) * 8 + offset;
            const int key = s0 + n * 8 + 2 * tq + (e & 1);
            bool ok = key < s_len;
            if (causal) ok = ok && tqo >= key;
            if (window > 0) ok = ok && tqo - key < window;
            if (!ok) s[n][e] = kNegInf;
          }
        }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
          s[n][e] = p;
          l[e >> 1] += p;      // this lane's part; the quad sums at the end
        }
#pragma unroll
      for (int dt = 0; dt < TL::kDTiles; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }

      // O += P V
      if constexpr (F32) {
        // keys 8n + 2tq and 8n + 2tq + 1 of this lane's B rows, column g
        const float* v_lane =
            reinterpret_cast<const float*>(vs + 2 * tq * rs) + g;
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
          AFrag<T> pa;
          const uint32_t r[4] = {__float_as_uint(s[n][0]),
                                 __float_as_uint(s[n][2]),
                                 __float_as_uint(s[n][1]),
                                 __float_as_uint(s[n][3])};
          pa.set(r);
          const float* v0 = reinterpret_cast<const float*>(
              reinterpret_cast<const unsigned char*>(v_lane) + 8 * n * rs);
          const float* v1 = reinterpret_cast<const float*>(
              reinterpret_cast<const unsigned char*>(v0) + rs);
#pragma unroll
          for (int dt = 0; dt < TL::kDTiles; ++dt) {
            BFrag<T> bb;
            bb.set(__float_as_uint(v0[8 * dt]), __float_as_uint(v1[8 * dt]));
            mma(o[dt], pa, bb);
          }
        }
      } else {
        const uint32_t v_addr = smem_u32(vs) + v_off;
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) {
          AFrag<T> pa;
          pa.x[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
          pa.x[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
          pa.x[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          pa.x[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
          for (int d2 = 0; d2 < TL::kDTiles / 2; ++d2) {
            uint32_t r[4];
            ldsm_x4_trans(r, v_addr + kc * 16 * rs + d2 * 32);
            BFrag<T> b0, b1;
            b0.set(r[0], r[1]);
            b1.set(r[2], r[3]);
            mma(o[2 * d2], pa, b0);
            mma(o[2 * d2 + 1], pa, b1);
          }
        }
      }
    }
    __syncthreads();                 // every warp is done with this stage
    if (i + kStages < ntiles) load_tile(i + kStages);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r_lo + g + 8 * r;
    if (t >= t_len) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = out + ((size_t)bh * t_len + t) * d;
#pragma unroll
    for (int dt = 0; dt < TL::kDTiles; ++dt) {
      const int col = 8 * dt + 2 * tq;
      if (col < d)
        store2(orow + col, o[dt][2 * r] / den, o[dt][2 * r + 1] / den);
    }
  }
}

template <typename T, int DT>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int bsz, int hq, int hkv, int t_len, int s_len, int d,
               int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<T, DT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(bsz * hq),
                  (unsigned)((t_len + kMmaBQ - 1) / kMmaBQ));
  flash_mma_kernel<T, DT><<<grid, kMmaThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hkv, t_len, s_len,
      d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mma(const void* q, const void* k, const void* v, void* out,
                 int bsz, int hq, int hkv, int t_len, int s_len, int d,
                 int causal, int window, float scale, cudaStream_t st) {
  return with_d_tile(d, [&](auto dt) {
    return launch_mma<T, decltype(dt)::value>(q, k, v, out, bsz, hq, hkv,
                                              t_len, s_len, d, causal,
                                              window, scale, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt (1 <= D <= 128),
// 1 = mma (D a multiple of 8, D <= 256; mma_3xtf32 for float32, mma_bf16
// for bfloat16).  window <= 0 means no window.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int bsz,
                                   int hq, int hkv, int t_len, int s_len,
                                   int d, int causal, int window,
                                   float scale, int dtype, int variant,
                                   void* stream) {
  if (hkv < 1 || hq % hkv != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return dispatch_simt<float>(q, k, v, out, bsz, hq, hkv, t_len, s_len,
                                  d, causal, window, scale, st);
    return dispatch_simt<__nv_bfloat16>(q, k, v, out, bsz, hq, hkv, t_len,
                                        s_len, d, causal, window, scale, st);
  }
  if (variant != 1 || d < 8 || d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_mma<float>(q, k, v, out, bsz, hq, hkv, t_len, s_len, d,
                               causal, window, scale, st);
  return dispatch_mma<__nv_bfloat16>(q, k, v, out, bsz, hq, hkv, t_len,
                                     s_len, d, causal, window, scale, st);
}
