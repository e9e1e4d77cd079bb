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
// b / c of group h / (H / G).  The state starts at zero.  Above the
// diagonal seg = cum_l - cum_m is positive and exp(seg) may overflow, so
// those entries are selected away, never multiplied by a zero mask
// (inf * 0 is NaN).
//
// Bound: operations.  Per (b, h) and chunk the work is ~L^2 (N + P)
// (causal half of the scores and of scores @ x) + 4 L N P flops against
// L (2N + P + 1) input and L P output elements: at L = 256, N = P = 64
// that is ~48 flop per byte, above the float32 ridge of 20 and near the
// ridge of the 3xTF32 ceiling below (165 TFLOP/s over 3.35 TB/s = 49).
//
// Two kernels, picked by mamba2_ssd.variant before the launch:
//
// * mma_3xtf32 (N and P multiples of 8, at most 128): three passes on the
//   current stream, each parallel over chunks, the products on the tensor
//   cores through mma.sync m16n8k8 TF32.  The Pallas grid ran its chunk
//   axis in order with the state in VMEM; here the chunks run at once, as
//   the Mamba2 SSD algorithm splits them:
//   1. ssd_state_kernel, one block per (b, h, chunk): one warp takes the
//      chunk's prefix sum cum of dt * a (in float64, written to a float32
//      scratch [B, H, T]), then S = sum_l b_l (dt_l exp(cum_last - cum_l)) x_l^T,
//      an [N, L] . [L, P] product over 64-row tiles of the chunk that
//      arrive by cp.async in a 2-stage ring; S goes to a float32 scratch
//      [B, H, chunks, N, P] (4 MB at the serve path: it stays in L2).
//   2. ssd_carry_kernel, one thread per (b, h, n, p): the state entering
//      chunk k is h_in[k] = exp(cum_last[k-1]) h_in[k-1] + S[k-1], h_in[0]
//      = 0, written over S in place; the last state is h.
//   3. ssd_output_kernel, one block of 4 warps per (b, h, chunk, 64-row
//      tile), each warp 16 rows, as flash attention's mma kernel: y =
//      exp(cum_l) (c_l . h_in) + sum over 64-key tiles up to the diagonal
//      of select(m <= l, (c_l . b_m) exp(cum_l - cum_m) dt_m, 0) x_m.  The
//      c tile's A fragments come by ldmatrix (in registers for N <= 64), so
//      do the b tile's B fragments; the scores' accumulators are the A
//      fragment of scores @ x once each 8-key slice runs its keys in the
//      order 0, 2, 4, 6, 1, 3, 5, 7 (C holds columns 2t, 2t + 1 of a row,
//      the TF32 A fragment columns t, t + 4), and x's B fragment reads
//      rows 2t and 2t + 1.  The 64-row tiles run heaviest first.
//   Float32 accuracy on the tensor cores: each operand x splits into big =
//   its TF32 rounding to nearest and small = x - big (exact), of which the
//   tensor core reads TF32's bits; each product is small.big + big.small +
//   big.big into the float32 accumulator, so an operand is held to 2**-21
//   of itself and the dropped small.small term is below 2**-22 of a
//   product.  The ceiling is the TF32 rate over 3, 495 / 3 = 165 TFLOP/s.
//   bfloat16 inputs are widened to float32 as they are staged and take the
//   same path.  Widths are zero-padded to tiles of 64 or 128 (each loop
//   over N or P has a fixed trip count); ragged row and key edges of a
//   chunk (any L) are zero-filled and masked.  At the serve path (B = 1,
//   H = 64, T = 1024, L = 256) the passes run 256, 1,024 and 1,024 blocks.
//
// * ssd_simt_kernel (simt, any other N, P): the first kernel, on the CUDA
//   cores in float32.  One block per (b, h) walks its chunks in order with
//   the state in shared memory; per chunk it stages x [L, P], b [L, N],
//   dt and cum, then produces y row tile by row tile (kRows rows): the
//   scores for m <= l are held for the row tile only ([kRows, L]), y =
//   scores @ x + exp(cum_l) (c_l @ h); then the state moves on.  B * H
//   blocks: 64 at the serve path, half the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

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

// The largest dynamic shared memory a kernel was allowed so far, per
// device: cudaFuncSetAttribute costs host time on every call, so it is
// made again only when a launch asks for more.  One per kernel
// instantiation.
struct SmemAttr {
  static constexpr int kDevices = 16;
  std::atomic<long long> allowed[kDevices] = {};
  template <typename K>
  cudaError_t allow(K* kernel, long long bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && allowed[dev].load() >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && dev < kDevices) allowed[dev].store(bytes);
    return err;
  }
};

// What one launch runs, kernel by kernel in launch order: its dynamic
// shared memory and blocks.  The launchers size their requests by it and
// ssd_scan_plan reports it.
struct Launch {
  int kernels = 0;
  long long smem[3] = {0, 0, 0};
  long long blocks[3] = {0, 0, 0};
};

// --------------------------------------------------------------------------
// simt: float32 on the CUDA cores
// --------------------------------------------------------------------------
long long simt_smem_bytes(int L, int N, int P) {
  const long long ns = N + 1;
  return (long long)sizeof(float) *
         ((long long)L * P + L * ns + (long long)N * P + 3LL * L +
          kRows * ns + (long long)kRows * L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_simt_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, T* __restrict__ y,
                float* __restrict__ hout, int t_len, int H, int P, int G,
                int N, int L) {
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

Launch simt_plan(int bsz, int H, int P, int N, int L) {
  Launch pl;
  pl.kernels = 1;
  pl.smem[0] = simt_smem_bytes(L, N, P);
  pl.blocks[0] = (long long)bsz * H;
  return pl;
}

template <typename T>
int launch_simt(const void* x, const void* dt, const float* a, const void* b,
                const void* c, void* y, float* h, int bsz, int t_len, int H,
                int P, int G, int N, int L, cudaStream_t stream) {
  static SmemAttr attr;
  const Launch pl = simt_plan(bsz, H, P, N, L);
  cudaError_t err = attr.allow(ssd_simt_kernel<T>, pl.smem[0]);
  if (err != cudaSuccess) return (int)err;
  ssd_simt_kernel<T><<<(unsigned)pl.blocks[0], kThreads, (size_t)pl.smem[0],
                       stream>>>((const T*)x, (const T*)dt, a, (const T*)b,
                                 (const T*)c, (T*)y, h, t_len, H, P, G, N, L);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// mma_3xtf32: three chunk-parallel passes on the tensor cores
// --------------------------------------------------------------------------
constexpr int kMmaThreads = 128;      // 4 warps
constexpr int kTile = 64;             // rows of a row tile, keys of a key tile
constexpr int kStages = 2;            // cp.async ring depth
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;       // chunks a carry thread loads at once

// Shared-memory plan per width tile (N zero-padded to NT, P to PT; each
// 64 or 128), in floats.  Pass 1 reads its fragments by scalar loads at
// rows t and t + 4, conflict-free at a row stride of 8 mod 32 words.
// Pass 3 reads c and b by ldmatrix (rows of an odd number of 16-byte
// units: NT + 4 words), x at rows 2t and 2t + 1 (PT + 4 words, 4 mod 8),
// and h_in, staged in the ring before the first key tile, at rows t and
// t + 4 (PT + 8 words).
template <int NT, int PT>
struct Plan {
  static constexpr int kBS = NT + 8;                 // pass 1: b row
  static constexpr int kXS1 = PT + 8;                // pass 1: x row
  static constexpr int kStateStage = kTile * (kBS + kXS1) + kTile;  // + w
  static constexpr int kStateFloats = kStages * kStateStage;
  static constexpr int kCS = NT + 4;                 // pass 3: c and b rows
  static constexpr int kXS = PT + 4;                 // pass 3: x row
  static constexpr int kHS = PT + 8;                 // pass 3: h_in row
  static constexpr int kOutStage = kTile * (kCS + kXS) + 2 * kTile;
  static constexpr int kRing = kStages * kOutStage > NT * kHS
                                   ? kStages * kOutStage : NT * kHS;
  static constexpr int kOutFloats = kTile * kCS + kRing;
  static constexpr int kKSteps = NT / 8;             // 8-wide steps over N
  static constexpr int kPTiles = PT / 8;             // n8 tiles over P
  static constexpr bool kCReg = NT <= 64;            // c fragments held
};

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
// itself compiles to a longer guarded sequence on sm_90).  small = x - big
// is exact, and the tensor core reads its tf32 bits (the upper 19).  A NaN
// x keeps a NaN small, so NaN still propagates; an infinite x gives NaN.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(__uint_as_float(x),
                                    __uint_as_float(big)));
}

// A operand of one k8 step (16 rows) and B operand of one k8 step and one
// n8 tile, split for 3xTF32.
struct AFrag {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const uint32_t* r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(r[i], big[i], small[i]);
  }
  __device__ __forceinline__ void set(float r0, float r1, float r2,
                                      float r3) {
    const uint32_t r[4] = {__float_as_uint(r0), __float_as_uint(r1),
                           __float_as_uint(r2), __float_as_uint(r3)};
    set(r);
  }
};
struct BFrag {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float r0, float r1) {
    split_tf32(__float_as_uint(r0), big[0], small[0]);
    split_tf32(__float_as_uint(r1), big[1], small[1]);
  }
  __device__ __forceinline__ void set(uint32_t r0, uint32_t r1) {
    set(__uint_as_float(r0), __uint_as_float(r1));
  }
};

// 3xTF32: small.big + big.small + big.big, in that order
__device__ __forceinline__ void mma(float* c, const AFrag& a,
                                    const BFrag& b) {
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

// Rows [0, rows) x columns [0, CT) of a tile into shared memory (row
// stride ss floats); row r of the source starts at src + r * ld.  Zero
// past `valid` rows and past `cols` columns (a multiple of 8).  float32
// arrives by 16-byte cp.async (the caller commits and waits); bfloat16 is
// widened to float32 through registers.
template <typename S, int CT>
__device__ __forceinline__ void stage(float* dst, int ss, const S* src,
                                      long long ld, int rows, int valid,
                                      int cols, int tid) {
  constexpr int kQuads = CT / 4;
  for (int i = tid; i < rows * kQuads; i += kMmaThreads) {
    const int r = i / kQuads, q = i - (i / kQuads) * kQuads;
    const bool in = r < valid && 4 * q < cols;
    const S* from = in ? src + r * ld + 4 * q : src;
    float* to = dst + r * ss + 4 * q;
    if constexpr (std::is_same<S, float>::value) {
      cp_async16(smem_u32(to), from, in);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const uint2 raw = *reinterpret_cast<const uint2*>(from);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(to) = v;
    }
  }
}

// Pass 1: per (b, h, chunk) the prefix sum cum (to the scratch) and the
// chunk's state S = sum_l b_l (dt_l exp(cum_last - cum_l)) x_l^T (to st).
// Warp w owns rows n of [16 MT w, 16 MT (w + 1)) and every column p.
template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ b,
                 float* cum, float* __restrict__ st, int t_len, int H,
                 int P, int G, int N, int L) {
  using PL = Plan<NT, PT>;
  constexpr int MT = NT / 64;                 // m16 tiles a warp
  extern __shared__ __align__(128) float smem[];
  __shared__ float cum_last_s;

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  float* cg = cum + (long long)bh * t_len + (long long)ci * L;
  const T* dtg = dt + row0 * H + hi;
  const int ntiles = (L + kTile - 1) / kTile;

  auto load_tile = [&](int i) {
    float* bs = smem + (i % kStages) * PL::kStateStage;
    float* xs = bs + kTile * PL::kBS;
    const int l0 = i * kTile;
    stage<T, NT>(bs, PL::kBS, b + ((row0 + l0) * G + gi) * N,
                 (long long)G * N, kTile, L - l0, N, tid);
    stage<T, PT>(xs, PL::kXS1, x + ((row0 + l0) * H + hi) * P,
                 (long long)H * P, kTile, L - l0, P, tid);
  };
  // w_l = dt_l exp(cum_last - cum_l) of tile i, 0 past L; after the scan
  auto load_w = [&](int i, int j) {
    float* ws = smem + (i % kStages) * PL::kStateStage +
                kTile * (PL::kBS + PL::kXS1);
    const int l = i * kTile + j;
    ws[j] = l < L ? to_f(dtg[(long long)l * H]) * expf(cum_last_s - cg[l])
                  : 0.f;
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  // Inclusive prefix sum of dt * a, in float64 and rounded to float32 once
  // an element.  In float32 the lanes' serial sums, the warp scan and the
  // exclusive sum taken as a difference each round at |cum| (~100 at the
  // serve path), and exp(cum_l - cum_m) turns those roundings into
  // relative error of y: twice the plain version's own.
  if (warp == 0) {
    const double av = a[hi];
    const int per = (L + 31) / 32;
    const int beg = min(lane * per, L), end = min(beg + per, L);
    double run = 0.0;
    for (int l = beg; l < end; ++l)
      run += (double)to_f(dtg[(long long)l * H]) * av;
    double tot = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot += up;
    }
    run = tot - run;
    for (int l = beg; l < end; ++l) {
      run += (double)to_f(dtg[(long long)l * H]) * av;
      const float v = (float)run;
      cg[l] = v;
      if (l == L - 1) cum_last_s = v;     // the carry reads the same value
    }
  }
  __syncthreads();                   // cum (global) and cum_last_s are set
  for (int j = tid; j < kStages * kTile; j += kMmaThreads)
    if (j / kTile < ntiles) load_w(j / kTile, j % kTile);

  float acc[MT][PL::kPTiles][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int pt = 0; pt < PL::kPTiles; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][pt][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* bs = smem + (i % kStages) * PL::kStateStage;
    const float* xs = bs + kTile * PL::kBS;
    const float* ws = xs + kTile * PL::kXS1;
#pragma unroll 2
    for (int kk = 0; kk < kTile / 8; ++kk) {
      const int l = 8 * kk + t;
      const float w0 = ws[l], w1 = ws[l + 4];
      // A[n][l] = b[l][n] w_l: rows n0 + g, n0 + g + 8; columns l, l + 4
      AFrag af[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int n0 = (warp * MT + mi) * 16 + g;
        af[mi].set(bs[l * PL::kBS + n0] * w0, bs[l * PL::kBS + n0 + 8] * w0,
                   bs[(l + 4) * PL::kBS + n0] * w1,
                   bs[(l + 4) * PL::kBS + n0 + 8] * w1);
      }
#pragma unroll
      for (int pt = 0; pt < PL::kPTiles; ++pt) {
        BFrag bf;
        bf.set(xs[l * PL::kXS1 + 8 * pt + g],
               xs[(l + 4) * PL::kXS1 + 8 * pt + g]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma(acc[mi][pt], af[mi], bf);
      }
    }
    __syncthreads();                 // every warp is done with this stage
    if (i + kStages < ntiles) {
      load_tile(i + kStages);
      if (tid < kTile) load_w(i + kStages, tid);
    }
    cp_async_commit();
  }

  float* so = st + ((long long)bh * nc + ci) * N * P;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = (warp * MT + mi) * 16 + g + 8 * r;
      if (n >= N) continue;
#pragma unroll
      for (int pt = 0; pt < PL::kPTiles; ++pt) {
        const int p = 8 * pt + 2 * t;
        if (p < P)
          store2(so + (long long)n * P + p, acc[mi][pt][2 * r],
                 acc[mi][pt][2 * r + 1]);
      }
    }
}

// Pass 2: h_in[k] = exp(cum_last[k-1]) h_in[k-1] + S[k-1] over the chunks
// of one (b, h), element by element, in place over S; h = the last state.
// The loads of kCarryBatch chunks are issued before their stores, so the
// chain waits on memory once a batch, not once a chunk.
__global__ void __launch_bounds__(kCarryThreads)
ssd_carry_kernel(float* __restrict__ st, const float* __restrict__ cum,
                 float* __restrict__ hout, long long n_elems, int nc,
                 int t_len, int L, int NP) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= n_elems) return;
  const long long bh = i / NP, e = i - (i / NP) * NP;
  float* s = st + bh * nc * NP + e;
  const float* cl = cum + bh * t_len + L - 1;
  float h = 0.f;
  for (int k0 = 0; k0 < nc; k0 += kCarryBatch) {
    float sk[kCarryBatch], ck[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const bool in = k0 + j < nc;
      sk[j] = in ? s[(long long)(k0 + j) * NP] : 0.f;
      ck[j] = in ? cl[(long long)(k0 + j) * L] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j)
      if (k0 + j < nc) {
        s[(long long)(k0 + j) * NP] = h;
        h = expf(ck[j]) * h + sk[j];
      }
  }
  hout[i] = h;
}

// Pass 3: y of one 64-row tile of one (b, h, chunk).
template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ b, const T* __restrict__ c,
                  const float* __restrict__ cum,
                  const float* __restrict__ st, T* __restrict__ y,
                  int t_len, int H, int P, int G, int N, int L) {
  using PL = Plan<NT, PT>;
  constexpr int rs = PL::kCS * 4;             // c / b shared row, bytes
  extern __shared__ __align__(128) float smem[];
  float* cs = smem;                           // [64][kCS]
  float* ring = cs + kTile * PL::kCS;         // stages, or h_in first

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int rt = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int r0 = rt * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  const float* cg = cum + (long long)bh * t_len + (long long)ci * L;
  const int ntiles = rt + 1;                  // key tiles up to the diagonal

  stage<T, NT>(cs, PL::kCS, c + ((row0 + r0) * G + gi) * N,
               (long long)G * N, kTile, L - r0, N, tid);
  if (ci > 0)
    stage<float, PT>(ring, PL::kHS,
                     st + ((long long)bh * nc + ci) * N * P, P, NT, N, P,
                     tid);
  cp_async_commit();

  // this lane's rows (within the chunk) and their cum
  const int wr = warp * 16;
  const int la = r0 + wr + g, lb = la + 8;
  const float cum_a = la < L ? cg[la] : 0.f;
  const float cum_b = lb < L ? cg[lb] : 0.f;

  // ldmatrix addresses of this lane: A from c (16 rows x 32 bytes: row
  // halves by lane bit 3, byte halves by bit 4), B from b (keys 0-7 /
  // 8-15 by bit 4, byte halves by bit 3)
  const uint32_t c_addr = smem_u32(cs) +
      (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * rs +
                    ((lane >> 3) & 1) * 16;

  cp_async_wait<0>();
  __syncthreads();
  AFrag cf[PL::kCReg ? PL::kKSteps : 1];
  if constexpr (PL::kCReg) {
#pragma unroll
    for (int kk = 0; kk < PL::kKSteps; ++kk) {
      uint32_t r[4];
      ldsm_x4(r, c_addr + kk * 32);
      cf[kk].set(r);
    }
  }

  float o[PL::kPTiles][4];
#pragma unroll
  for (int pt = 0; pt < PL::kPTiles; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[pt][e] = 0.f;

  // o = exp(cum_l) (c_l . h_in): B[n][p] = h_in[n][p], rows t and t + 4
  if (ci > 0) {
#pragma unroll
    for (int kk = 0; kk < PL::kKSteps; ++kk) {
      AFrag af;
      if constexpr (PL::kCReg) {
        af = cf[kk];
      } else {
        uint32_t r[4];
        ldsm_x4(r, c_addr + kk * 32);
        af.set(r);
      }
      const float* h0 = ring + (8 * kk + t) * PL::kHS + g;
      const float* h1 = h0 + 4 * PL::kHS;
#pragma unroll
      for (int pt = 0; pt < PL::kPTiles; ++pt) {
        BFrag bf;
        bf.set(h0[8 * pt], h1[8 * pt]);
        mma(o[pt], af, bf);
      }
    }
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int pt = 0; pt < PL::kPTiles; ++pt) {
      o[pt][0] *= ea;
      o[pt][1] *= ea;
      o[pt][2] *= eb;
      o[pt][3] *= eb;
    }
    __syncthreads();                 // the ring is free for the key tiles
  }

  auto load_tile = [&](int i) {
    float* bsk = ring + (i % kStages) * PL::kOutStage;
    float* xsk = bsk + kTile * PL::kCS;
    float* cumk = xsk + kTile * PL::kXS;
    float* dtk = cumk + kTile;
    const int m0 = i * kTile;
    stage<T, NT>(bsk, PL::kCS, b + ((row0 + m0) * G + gi) * N,
                 (long long)G * N, kTile, L - m0, N, tid);
    stage<T, PT>(xsk, PL::kXS, x + ((row0 + m0) * H + hi) * P,
                 (long long)H * P, kTile, L - m0, P, tid);
    if (tid < kTile) {
      const int m = m0 + tid;
      cumk[tid] = m < L ? cg[m] : 0.f;
      dtk[tid] = m < L ? to_f(dt[(row0 + m) * H + hi]) : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* bsk = ring + (i % kStages) * PL::kOutStage;
    const float* xsk = bsk + kTile * PL::kCS;
    const float* cumk = xsk + kTile * PL::kXS;
    const float* dtk = cumk + kTile;

    // S = C B^T over N
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const uint32_t k_addr = smem_u32(bsk) + k_off;
#pragma unroll
    for (int kk = 0; kk < PL::kKSteps; ++kk) {
      AFrag af;
      if constexpr (PL::kCReg) {
        af = cf[kk];
      } else {
        uint32_t r[4];
        ldsm_x4(r, c_addr + kk * 32);
        af.set(r);
      }
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        uint32_t r[4];
        ldsm_x4(r, k_addr + n2 * 16 * rs + kk * 32);
        BFrag b0, b1;
        b0.set(r[0], r[1]);
        b1.set(r[2], r[3]);
        mma(s[2 * n2], af, b0);
        mma(s[2 * n2 + 1], af, b1);
      }
    }

    // select(m <= l, S exp(cum_l - cum_m) dt_m, 0); only the diagonal
    // tile holds keys past a row
    const bool diag = i == rt;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * n + 2 * t + (e & 1);
        const int row = wr + g + (e >> 1) * 8;
        const float v = s[n][e] *
            expf(((e >> 1) ? cum_b : cum_a) - cumk[key]) * dtk[key];
        s[n][e] = (!diag || key <= row) ? v : 0.f;
      }

    // o += S X: each 8-key slice in the order 0, 2, 4, 6, 1, 3, 5, 7, so
    // the accumulators are the A fragment; x rows 2t and 2t + 1, column g
    const float* x_lane = xsk + 2 * t * PL::kXS + g;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      AFrag pa;
      pa.set(s[n][0], s[n][2], s[n][1], s[n][3]);
      const float* x0 = x_lane + 8 * n * PL::kXS;
      const float* x1 = x0 + PL::kXS;
#pragma unroll
      for (int pt = 0; pt < PL::kPTiles; ++pt) {
        BFrag bf;
        bf.set(x0[8 * pt], x1[8 * pt]);
        mma(o[pt], pa, bf);
      }
    }
    __syncthreads();                 // every warp is done with this stage
    if (i + kStages < ntiles) load_tile(i + kStages);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = r ? lb : la;
    if (l >= L) continue;
    T* yrow = y + ((row0 + l) * H + hi) * P;
#pragma unroll
    for (int pt = 0; pt < PL::kPTiles; ++pt) {
      const int p = 8 * pt + 2 * t;
      if (p < P) store2(yrow + p, o[pt][2 * r], o[pt][2 * r + 1]);
    }
  }
}

// The three passes: states, one block per (b, h, chunk); the carry, one
// thread per state element; y, one block per (b, h, chunk, row tile).
template <int NT, int PT>
Launch mma_plan(int bsz, int t_len, int H, int P, int N, int L) {
  using PL = Plan<NT, PT>;
  const long long chunks = (long long)bsz * H * (t_len / L);
  Launch pl;
  pl.kernels = 3;
  pl.smem[0] = sizeof(float) * PL::kStateFloats;
  pl.blocks[0] = chunks;
  pl.blocks[1] = ((long long)bsz * H * N * P + kCarryThreads - 1) /
                 kCarryThreads;
  pl.smem[2] = sizeof(float) * PL::kOutFloats;
  pl.blocks[2] = chunks * ((L + kTile - 1) / kTile);
  return pl;
}

template <typename T, int NT, int PT>
int launch_mma(const void* x, const void* dt, const float* a, const void* b,
               const void* c, void* y, float* h, float* cum, float* st,
               int bsz, int t_len, int H, int P, int G, int N, int L,
               cudaStream_t stream) {
  static SmemAttr state_attr, output_attr;
  const Launch pl = mma_plan<NT, PT>(bsz, t_len, H, P, N, L);
  cudaError_t err = state_attr.allow(ssd_state_kernel<T, NT, PT>, pl.smem[0]);
  if (err != cudaSuccess) return (int)err;
  err = output_attr.allow(ssd_output_kernel<T, NT, PT>, pl.smem[2]);
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<T, NT, PT><<<(unsigned)pl.blocks[0], kMmaThreads,
                                (size_t)pl.smem[0], stream>>>(
      (const T*)x, (const T*)dt, a, (const T*)b, cum, st, t_len, H, P, G, N,
      L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_carry_kernel<<<(unsigned)pl.blocks[1], kCarryThreads, 0, stream>>>(
      st, cum, h, (long long)bsz * H * N * P, t_len / L, t_len, L, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)pl.blocks[0],
                  (unsigned)(pl.blocks[2] / pl.blocks[0]));
  ssd_output_kernel<T, NT, PT><<<grid, kMmaThreads, (size_t)pl.smem[2],
                                 stream>>>(
      (const T*)x, (const T*)dt, (const T*)b, (const T*)c, cum, st, (T*)y,
      t_len, H, P, G, N, L);
  return (int)cudaGetLastError();
}

// f(NT, PT) at the width tiles of N and P: 64 or 128 each, the smallest
// that holds it, as std::integral_constants; N, P <= 128.
template <typename F>
auto with_tiles(int n, int p, F&& f) {
  using W64 = std::integral_constant<int, 64>;
  using W128 = std::integral_constant<int, 128>;
  if (n <= 64) return p <= 64 ? f(W64(), W64()) : f(W64(), W128());
  return p <= 64 ? f(W128(), W64()) : f(W128(), W128());
}

template <typename T>
int dispatch_mma(const void* x, const void* dt, const float* a, const void* b,
                 const void* c, void* y, float* h, float* cum, float* st,
                 int bsz, int t_len, int H, int P, int G, int N, int L,
                 cudaStream_t stream) {
  return with_tiles(N, P, [&](auto nt, auto pt) {
    return launch_mma<T, decltype(nt)::value, decltype(pt)::value>(
        x, dt, a, b, c, y, h, cum, st, bsz, t_len, H, P, G, N, L, stream);
  });
}

}  // namespace

// What a launch of `variant` (0 = simt, 1 = mma_3xtf32) at these sizes
// runs, as the launchers size it: for each kernel in launch order (simt:
// ssd_simt_kernel; mma_3xtf32: ssd_state_kernel, ssd_carry_kernel,
// ssd_output_kernel) its dynamic shared memory in bytes and its blocks,
// into smem[3] and blocks[3] (0 past the last kernel).  Returns the number
// of kernels, or -1 for sizes no variant takes.
extern "C" int ssd_scan_plan(int variant, int bsz, int t_len, int H, int P,
                             int N, int L, long long* smem,
                             long long* blocks) {
  if (L < 1 || t_len % L != 0 || N < 1 || P < 1) return -1;
  Launch pl;
  if (variant == 0) {
    pl = simt_plan(bsz, H, P, N, L);
  } else if (variant == 1 && N % 8 == 0 && N <= 128 && P % 8 == 0 &&
             P <= 128) {
    pl = with_tiles(N, P, [&](auto nt, auto pt) {
      return mma_plan<decltype(nt)::value, decltype(pt)::value>(
          bsz, t_len, H, P, N, L);
    });
  } else {
    return -1;
  }
  for (int i = 0; i < 3; ++i) {
    smem[i] = pl.smem[i];
    blocks[i] = pl.blocks[i];
  }
  return pl.kernels;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and y).  variant: 0 =
// simt, 1 = mma_3xtf32 (N and P multiples of 8, at most 128; cum [B, H, T]
// and st [B, H, T / L, N, P] float32 scratch, unused by simt).  T must
// divide by L and H by G.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const float* a,
                            const void* b, const void* c, void* y, float* h,
                            float* cum, float* st, int bsz, int t_len, int H,
                            int P, int G, int N, int L, int dtype,
                            int variant, void* stream) {
  if (L < 1 || t_len % L != 0 || G < 1 || H % G != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  if (variant == 0) {
    if (dtype == 0)
      return launch_simt<float>(x, dt, a, b, c, y, h, bsz, t_len, H, P, G, N,
                                L, st_);
    return launch_simt<__nv_bfloat16>(x, dt, a, b, c, y, h, bsz, t_len, H, P,
                                      G, N, L, st_);
  }
  if (variant != 1 || N < 8 || N > 128 || N % 8 != 0 || P < 8 || P > 128 ||
      P % 8 != 0 || cum == nullptr || st == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_mma<float>(x, dt, a, b, c, y, h, cum, st, bsz, t_len, H,
                               P, G, N, L, st_);
  return dispatch_mma<__nv_bfloat16>(x, dt, a, b, c, y, h, cum, st, bsz,
                                     t_len, H, P, G, N, L, st_);
}
