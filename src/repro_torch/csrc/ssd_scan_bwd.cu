// Backward of the chunked Mamba2 SSD scan, hand-written for Hopper (sm_90a).
//
// The gradient of csrc/ssd_scan.cu's (y, h) at upstream dy and dh.  The
// reference has no backward kernel: its Pallas kernel ssd_scan
// (src/repro/kernels/mamba2_ssd.py) has no transpose rule, so JAX trains
// through the plain chunked scan (src/repro/kernels/ref.py,
// ssd_chunked_ref).  This kernel replaces that gradient on the card; its
// plain version is repro_torch.kernels.ref.ssd_chunked_bwd_ref, whose four
// steps are the passes below.
//
// Per (b, h) and chunk k of L steps, with l, m in-chunk steps: cum the
// prefix sum of dt a, dec_lm = exp(cum_l - cum_m) for m <= l (selected
// away above the diagonal, where it may overflow: never multiplied by 0),
// s_lm = (c_l . b_m) dec_lm, DX_lm = dy_l . x_m, A_lm = DX_lm dec_lm dt_m,
// w_m = dt_m exp(cum_last - cum_m), H_k the state entering chunk k and G_k
// the gradient of the state leaving it (G_last = dh, or 0).
//
// Layout as the forward: x, dy [B, T, H, P], dt [B, T, H], b / c
// [B, T, G, N], one type (float32 or bfloat16); a [H] float32; dh
// [B, H, N, P] float32 or none.  Out: dx, ddt, db, dc in the inputs' type,
// da [H] float32.
//
// Bound: operations.  Per (b, h, chunk) the work is ~L^2 (3N + 2P) (the
// causal halves of c.b and dy.x, and of the products into dx, db, dc)
// + 8 L N P flops against L (2N + 2P + 1) elements in and out: at
// L = 256, N = P = 64 about 150 flop a byte, far above the float32 ridge.
// Both designs are deterministic: no atomics, every sum in a fixed order
// (the training loop's bitwise resume relies on it).
//
// Two designs of the same passes, picked by mamba2_ssd.bwd_variant before
// the launch:
//
// * bwd_mma_3xtf32 (N and P multiples of 8 up to 128, where the forward
//   runs mma_3xtf32 and keeps its states): the products of passes 0, 2, 4
//   and 5 on the tensor cores through mma.sync m16n8k8 TF32 with the
//   3xTF32 split (fragments, cp.async and the split from mma_sync.cuh),
//   float32 accuracy; bfloat16 inputs are widened to float32 as they are
//   staged.  4 warps a block, each warp 16 rows of the block's 64-row
//   tile, flash attention's backward layout
//   (csrc/flash_attention_bwd.cu):
//   - the key pass (flash's dk/dv pass): a warp owns 16 keys m.  Their b
//     and x rows are the A operands (ldmatrix from the block's own
//     tiles); the row tiles' c and dy (l >= m) arrive through a 2-stage
//     cp.async ring and are the B operands (ldmatrix), so S^T = B C^T and
//     DX^T = X DY^T land in the warp's accumulators, rows = its keys.  The
//     mask and the decay are applied there (selected before the exp above
//     the diagonal), and s dt_m and A = DX dec dt_m feed dx += (s dt)^T dy
//     and db += A^T c straight from the accumulators as A operands (each
//     8-wide slice of rows in the order 0, 2, 4, 6, 1, 3, 5, 7; dy and c
//     read at rows 2t, 2t + 1 by scalar loads).  The state terms
//     w_m (b_m . G) and w_m (G x_m) are products of the same tiles with
//     G_k, staged in the ring's second stage before the first row tile;
//     b^T G x is (b . G) . x, summed over a quad by shuffles in a fixed
//     order, as is sum_l s_lm DX_lm.  Where N or P is 128 the key pass
//     runs two blocks a key tile (kSplit): one dx, ddt and dcum, one db,
//     so that no instantiation spills;
//   - the row pass (flash's dq pass): a warp owns 16 rows l; S = C B^T and
//     DX = DY X^T from the key tiles m <= l of the ring, then dc += A b;
//     the state term exp(cum_l) dy_l . H_k is a product with K = P, H_k
//     staged first;
//   - D_k and, with the states recomputed, S_k: [N, L] . [L, P] products
//     as the forward's ssd_state_kernel runs them.
//   Shared rows of the ldmatrix tiles are the width tile plus 4 words (an
//   odd number of 16-byte units: 8 rows read from 8 distinct bank groups,
//   and the scalar rows 2t, 2t + 1 conflict-free).  Every accumulator
//   chain spans at most a chunk (256 rows) plus a state term.
// * bwd_simt (the first design; bwd_simt_recompute after a simt forward,
//   and for every width bwd_mma_3xtf32 does not take): everything in
//   float32 on the CUDA cores, a 16 x 16 thread grid, each thread a 4 x 4
//   or wider register tile, operands from shared memory padded to
//   conflict-free rows.
//
// Passes, enqueued by one C call on the current stream:
//   0. ssd_bwd_state_kernel (only when the forward left no states: its
//      simt variant keeps none), one block per (b, h, chunk): cum in
//      float64 (as the forward's tensor-core pass) and the chunk's state
//      S_k = sum_l b_l w_l x_l^T;
//   1. ssd_bwd_state_carry_kernel (with 0), one thread per (b, h, n, p):
//      H_k in place over S (the forward's carry);
//   2. ssd_bwd_dstate_kernel, one block per (b, h, chunk):
//      D_k = sum_l exp(cum_l) c_l dy_l^T;
//   3. ssd_bwd_grad_carry_kernel, one thread per (b, h, n, p): G_k in place
//      over D, from G_last = dh back: G_(k-1) = exp(cum_last) G_k + D_k;
//   4. ssd_bwd_key_kernel, one block per (b, h, chunk, 64-key tile): for
//      its keys m, dx_m = dt_m sum_l s_lm dy_l + w_m G^T b_m (final),
//      db_m = sum_l A_lm c_l + w_m G x_m (a per-head partial), the direct
//      part of ddt_m, sum_l s_lm DX_lm + exp(cum_last - cum_m) b_m^T G x_m,
//      and its share of dcum, - dt_m sum_l s_lm DX_lm - Q_m with
//      Q_m = w_m b_m^T G x_m; the chunk's first key tile also <G_k, H_k>;
//   5. ssd_bwd_query_kernel, one block per (b, h, chunk, 64-row tile): for
//      its rows l, dc_l = sum_m A_lm b_m + exp(cum_l) H dy_l (a per-head
//      partial) and its share of dcum, sum_m s_lm dt_m DX_lm
//      + exp(cum_l) c_l^T H dy_l (passes 4 and 5 each compute c.b and dy.x
//      for their tiles: no partial crosses a block);
//   6. ssd_bwd_dt_kernel, one warp per (b, h, chunk): dcum (its last row
//      plus exp(cum_last) <G, H> + sum_m Q_m), its reverse cumsum r in
//      float64, ddt = direct + a r, and the chunk's share of da,
//      sum_l dt_l r_l;
//   7. ssd_bwd_da_kernel, one thread per head: da over batch and chunks;
//   8. ssd_bwd_group_kernel, one thread per (b, t, g, n): db and dc summed
//      over the heads of each group, in head order.
// Widths N and P up to 128 (zero-padded to tiles of 64 or 128); any chunk
// (ragged 64-row tiles are zero-filled and masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;         // a 16 x 16 thread grid
constexpr int kSide = 16;
constexpr int kTile = 64;             // rows of a row tile, keys of a key tile
constexpr int kTS = kTile + 1;        // padded row of a 64 x 64 score tile
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;        // chunks a carry thread loads at once
constexpr int kScanWarps = 8;         // warps (chunks) a block of pass 6
constexpr int kMaxKernels = 9;

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
// device (cudaFuncSetAttribute costs host time on every call).
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

// Shared memory per width tile (N zero-padded to NT, P to PT), in floats.
// Every tile row is padded by one word: the thread grid reads 16
// consecutive rows of a tile at one column (conflict-free at an odd row
// stride) or 16 consecutive columns of one row.
template <int NT, int PT>
struct Plan {
  static constexpr int kNS = NT + 1;                 // b / c tile row
  static constexpr int kPS = PT + 1;                 // x / dy tile row
  static constexpr int kNTile = kTile * kNS;
  static constexpr int kPTile = kTile * kPS;
  static constexpr int kStateMat = NT * kPS;         // an [N, P] state
  // passes 0 and 2: a u tile (b or c, scaled by its row weight), a v tile
  // (x or dy) and the weights
  static constexpr int kStateFloats = kNTile + kPTile + kTile;
  // pass 4: the key tile's b, x and cum, dt, w, exp(cum_last - cum); then
  // G_k, and in its place per row tile c, dy, cum and the two score tiles
  static constexpr int kKeyRing = kNTile + kPTile + kTile + 2 * kTile * kTS;
  static constexpr int kKeyFloats =
      kNTile + kPTile + 4 * kTile +
      (kStateMat > kKeyRing ? kStateMat : kKeyRing);
  // pass 5: the row tile's c, dy, cum and exp(cum); then H_k, and in its
  // place per key tile b, x, cum, dt and the A tile
  static constexpr int kQueryRing = kNTile + kPTile + 2 * kTile + kTile * kTS;
  static constexpr int kQueryFloats =
      kNTile + kPTile + 2 * kTile +
      (kStateMat > kQueryRing ? kStateMat : kQueryRing);
  static constexpr int kNJ = NT / kSide;             // columns a thread, N
  static constexpr int kPJ = PT / kSide;             // columns a thread, P
};

// Rows [0, ROWS) x columns [0, CT) of a tile into shared memory (row
// stride ss floats); row r of the source starts at src + r * ld.  Zero
// past `valid` rows and `cols` columns; row r scaled by scale[r] where
// scale is given.
template <int ROWS, int CT, typename S>
__device__ __forceinline__ void stage(float* dst, int ss, const S* src,
                                      long long ld, int valid, int cols,
                                      const float* scale) {
  for (int i = threadIdx.x; i < ROWS * CT; i += kThreads) {
    const int r = i / CT, q = i - (i / CT) * CT;
    float v = 0.f;
    if (r < valid && q < cols) {
      v = to_f(src[(long long)r * ld + q]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ss + q] = v;
  }
}

// Sum over the 16 lanes of a half warp (the threads of one grid row), in
// a fixed order: every lane gets the same sum.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kSide / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The inclusive prefix sum of dt a over one chunk (dtg: its first dt, a
// row every H) in float64 by one warp, each element rounded to float32
// once, as the forward's tensor-core pass writes it: into cg, the last
// also into *last.
template <typename T>
__device__ __forceinline__ void chunk_cum(const T* dtg, int H, double av,
                                          float* cg, float* last, int L,
                                          int lane) {
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
    const float f = (float)run;
    cg[l] = f;
    if (l == L - 1) *last = f;
  }
}

// Passes 0 and 2: per (b, h, chunk) out[n][p] = sum_l u_l[n] alpha_l v_l[p].
// kStates: u = b, v = x, alpha_l = dt_l exp(cum_last - cum_l), after
// computing cum (into the cum scratch); else u = c, v = dy,
// alpha_l = exp(cum_l), cum read.  Thread (ty, tx) owns rows
// n = ty + 16 i and columns p = tx + 16 j.
template <typename T, int NT, int PT, bool kStates>
__device__ __forceinline__ void chunk_state(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ dt,
    const float* __restrict__ a, float* cum, float* __restrict__ out,
    int t_len, int H, int P, int G, int N, int L) {
  using PL = Plan<NT, PT>;
  constexpr int NI = NT / kSide;
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                            // [64][NT + 1]
  float* vs = us + PL::kNTile;                 // [64][PT + 1]
  float* al = vs + PL::kPTile;                 // [64]
  __shared__ float cum_last_s;

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  float* cg = cum + (long long)bh * t_len + (long long)ci * L;
  const T* dtg = kStates ? dt + row0 * H + hi : nullptr;

  if (kStates) {
    if (tid < 32) chunk_cum(dtg, H, a[hi], cg, &cum_last_s, L, tid);
    __syncthreads();
  }
  const float cum_last = kStates ? cum_last_s : cg[L - 1];

  float acc[NI][PL::kPJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < PL::kPJ; ++j) acc[i][j] = 0.f;

  const int ntiles = (L + kTile - 1) / kTile;
  for (int lt = 0; lt < ntiles; ++lt) {
    const int l0 = lt * kTile;
    __syncthreads();                   // the last tile is consumed
    if (tid < kTile) {
      const int l = l0 + tid;
      float w = 0.f;
      if (l < L)
        w = kStates ? to_f(dtg[(long long)l * H]) * expf(cum_last - cg[l])
                    : expf(cg[l]);
      al[tid] = w;
    }
    __syncthreads();
    stage<kTile, NT>(us, PL::kNS, u + ((row0 + l0) * G + gi) * N,
                     (long long)G * N, L - l0, N, al);
    stage<kTile, PT>(vs, PL::kPS, v + ((row0 + l0) * H + hi) * P,
                     (long long)H * P, L - l0, P, nullptr);
    __syncthreads();
    const int rows = min(kTile, L - l0);
    for (int l = 0; l < rows; ++l) {
      float ur[NI], vr[PL::kPJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) ur[i] = us[l * PL::kNS + ty + kSide * i];
#pragma unroll
      for (int j = 0; j < PL::kPJ; ++j)
        vr[j] = vs[l * PL::kPS + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PL::kPJ; ++j) acc[i][j] += ur[i] * vr[j];
    }
  }

  float* o = out + ((long long)bh * nc + ci) * N * P;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int n = ty + kSide * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < PL::kPJ; ++j) {
      const int p = tx + kSide * j;
      if (p < P) o[(long long)n * P + p] = acc[i][j];
    }
  }
}

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ b,
                     float* cum, float* __restrict__ st, int t_len, int H,
                     int P, int G, int N, int L) {
  chunk_state<T, NT, PT, true>(b, x, dt, a, cum, st, t_len, H, P, G, N, L);
}

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dstate_kernel(const T* __restrict__ dy, const T* __restrict__ c,
                      float* cum, float* __restrict__ gst, int t_len, int H,
                      int P, int G, int N, int L) {
  chunk_state<T, NT, PT, false>(c, dy, (const T*)nullptr, nullptr, cum, gst,
                                t_len, H, P, G, N, L);
}

// Passes 1 and 3, element by element over the chunks of one (b, h), in
// place: forward, s[k] <- h_in[k] with h_in[0] = 0 and
// h_in[k+1] = exp(cum_last[k]) h_in[k] + s[k]; reverse, s[k] <- G_k with
// G_last = g0 (or 0) and G_(k-1) = exp(cum_last[k]) G_k + s[k].  The
// loads of kCarryBatch chunks are issued before their stores (as the
// forward's carry), so the chain waits on memory once a batch.
__device__ __forceinline__ void carry(float* __restrict__ st,
                                      const float* __restrict__ cum,
                                      const float* __restrict__ g0,
                                      long long n_elems, int nc, int t_len,
                                      int L, int NP, bool reverse) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= n_elems) return;
  const long long bh = i / NP, e = i - (i / NP) * NP;
  float* s = st + bh * nc * NP + e;
  const float* cl = cum + bh * t_len + L - 1;
  float h = g0 != nullptr ? g0[i] : 0.f;
  for (int j0 = 0; j0 < nc; j0 += kCarryBatch) {
    float sk[kCarryBatch], dk[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const int k = reverse ? nc - 1 - (j0 + j) : j0 + j;
      const bool in = j0 + j < nc;
      sk[j] = in ? s[(long long)k * NP] : 0.f;
      dk[j] = in ? expf(cl[(long long)k * L]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const int k = reverse ? nc - 1 - (j0 + j) : j0 + j;
      if (j0 + j < nc) {
        s[(long long)k * NP] = h;
        h = dk[j] * h + sk[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kCarryThreads)
ssd_bwd_state_carry_kernel(float* __restrict__ st,
                           const float* __restrict__ cum, long long n_elems,
                           int nc, int t_len, int L, int NP) {
  carry(st, cum, nullptr, n_elems, nc, t_len, L, NP, false);
}

__global__ void __launch_bounds__(kCarryThreads)
ssd_bwd_grad_carry_kernel(float* __restrict__ gst,
                          const float* __restrict__ cum,
                          const float* __restrict__ dh, long long n_elems,
                          int nc, int t_len, int L, int NP) {
  carry(gst, cum, dh, n_elems, nc, t_len, L, NP, true);
}

// Pass 4: one 64-key tile of one (b, h, chunk).  Thread (ty, tx) owns keys
// m = ty + 16 i (i < 4); of a score tile the rows l = tx + 16 j (j < 4),
// of dx the columns p = tx + 16 j, of db the columns n = tx + 16 j.
template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_key_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const T* __restrict__ b, const T* __restrict__ c,
                   const T* __restrict__ dy, const float* __restrict__ cum,
                   const float* __restrict__ st,
                   const float* __restrict__ gst, T* __restrict__ dx,
                   float* __restrict__ dbh, float* __restrict__ ddt0,
                   float* __restrict__ dcum1, float* __restrict__ qm,
                   float* __restrict__ gh, int t_len, int H, int P, int G,
                   int N, int L) {
  using PL = Plan<NT, PT>;
  constexpr int NJ = PL::kNJ, PJ = PL::kPJ;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                            // [64][NT + 1] keys' b
  float* xs = bs + PL::kNTile;                 // [64][PT + 1] keys' x
  float* cumk = xs + PL::kPTile;               // [64]
  float* dtk = cumk + kTile;                   // [64]
  float* wk = dtk + kTile;                     // [64] dt exp(cum_last - cum)
  float* ek = wk + kTile;                      // [64] exp(cum_last - cum)
  float* ring = ek + kTile;
  float* gs = ring;                            // [NT][PT + 1] G_k, first
  float* cs = ring;                            // [64][NT + 1] rows' c
  float* dys = cs + PL::kNTile;                // [64][PT + 1] rows' dy
  float* cuml = dys + PL::kPTile;              // [64]
  float* sm = cuml + kTile;                    // [64][65] s dt_m, by key
  float* am = sm + kTile * kTS;                // [64][65] A, by key
  __shared__ float red[kThreads / 32];

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int kt = blockIdx.y, m0 = kt * kTile;
  const int nq = (L + kTile - 1) / kTile;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  const float* cg = cum + (long long)bh * t_len + (long long)ci * L;
  const long long sbase = ((long long)bh * nc + ci) * N * P;
  const float cum_last = cg[L - 1];

  stage<kTile, NT>(bs, PL::kNS, b + ((row0 + m0) * G + gi) * N,
                   (long long)G * N, L - m0, N, nullptr);
  stage<kTile, PT>(xs, PL::kPS, x + ((row0 + m0) * H + hi) * P,
                   (long long)H * P, L - m0, P, nullptr);
  stage<NT, PT>(gs, PL::kPS, gst + sbase, P, N, P, nullptr);
  if (tid < kTile) {
    const int m = m0 + tid;
    float cm = 0.f, d = 0.f, e = 0.f;
    if (m < L) {
      cm = cg[m];
      d = to_f(dt[(row0 + m) * H + hi]);
      e = expf(cum_last - cm);
    }
    cumk[tid] = cm;
    dtk[tid] = d;
    ek[tid] = e;
    wk[tid] = d * e;
  }
  __syncthreads();

  // the state terms: dx = w_m (b_m . G), db = w_m (G x_m), b_m^T G x_m
  float dxa[4][PJ], dba[4][NJ], bgx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < PJ; ++j) dxa[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dba[i][j] = 0.f;
  }
  for (int n = 0; n < NT; ++n) {
    float br[4], gr[PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) br[i] = bs[(ty + kSide * i) * PL::kNS + n];
#pragma unroll
    for (int j = 0; j < PJ; ++j) gr[j] = gs[n * PL::kPS + tx + kSide * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) dxa[i][j] += br[i] * gr[j];
  }
  for (int p = 0; p < PT; ++p) {
    float xr[4], gr[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) xr[i] = xs[(ty + kSide * i) * PL::kPS + p];
#pragma unroll
    for (int j = 0; j < NJ; ++j) gr[j] = gs[(tx + kSide * j) * PL::kPS + p];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dba[i][j] += xr[i] * gr[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + kSide * i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      part += bs[m * PL::kNS + tx + kSide * j] * dba[i][j];
    bgx[i] = row_sum(part);
    const float w = wk[m];
#pragma unroll
    for (int j = 0; j < PJ; ++j) dxa[i][j] *= w;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dba[i][j] *= w;
  }
  // <G_k, H_k>, once a chunk, in a fixed order
  if (kt == 0) {
    float part = 0.f;
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e - (e / P) * P;
      part += gs[n * PL::kPS + p] * st[sbase + e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w];
      gh[(long long)bh * nc + ci] = s;
    }
  }

  float sdx[4] = {0.f, 0.f, 0.f, 0.f};     // sum_l s_lm DX_lm
  for (int qt = kt; qt < nq; ++qt) {
    const int l0 = qt * kTile;
    __syncthreads();                   // G_k, or the last row tile, consumed
    stage<kTile, NT>(cs, PL::kNS, c + ((row0 + l0) * G + gi) * N,
                     (long long)G * N, L - l0, N, nullptr);
    stage<kTile, PT>(dys, PL::kPS, dy + ((row0 + l0) * H + hi) * P,
                     (long long)H * P, L - l0, P, nullptr);
    if (tid < kTile) cuml[tid] = l0 + tid < L ? cg[l0 + tid] : 0.f;
    __syncthreads();

    float cb[4][4], dxm[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = dxm[i][j] = 0.f;
    for (int n = 0; n < NT; ++n) {
      float br[4], cr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) br[i] = bs[(ty + kSide * i) * PL::kNS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) cr[j] = cs[(tx + kSide * j) * PL::kNS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] += br[i] * cr[j];
    }
    for (int p = 0; p < PT; ++p) {
      float xr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = xs[(ty + kSide * i) * PL::kPS + p];
#pragma unroll
      for (int j = 0; j < 4; ++j) dr[j] = dys[(tx + kSide * j) * PL::kPS + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dxm[i][j] += xr[i] * dr[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = tx + kSide * j;
        float sv = 0.f, av = 0.f;
        if (l0 + l >= m0 + m && l0 + l < L) {
          const float dec = expf(cuml[l] - cumk[m]);
          const float s = cb[i][j] * dec;
          sdx[i] += s * dxm[i][j];
          sv = s * dtk[m];
          av = dxm[i][j] * dec * dtk[m];
        }
        sm[m * kTS + l] = sv;
        am[m * kTS + l] = av;
      }
    }
    __syncthreads();
    const int rows = min(kTile, L - l0);
    for (int l = 0; l < rows; ++l) {
      float sr[4], ar[4], dr[PJ], cr[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sr[i] = sm[(ty + kSide * i) * kTS + l];
        ar[i] = am[(ty + kSide * i) * kTS + l];
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) dr[j] = dys[l * PL::kPS + tx + kSide * j];
#pragma unroll
      for (int j = 0; j < NJ; ++j) cr[j] = cs[l * PL::kNS + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) dxa[i][j] += sr[i] * dr[j];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dba[i][j] += ar[i] * cr[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + kSide * i, mg = m0 + m;
    const float sd = row_sum(sdx[i]);
    if (mg >= L) continue;
    if (tx == 0) {
      const long long r = (long long)bh * t_len + (long long)ci * L + mg;
      const float q = wk[m] * bgx[i];
      ddt0[r] = sd + ek[m] * bgx[i];
      dcum1[r] = -dtk[m] * sd - q;
      qm[r] = q;
    }
    T* dxr = dx + ((row0 + mg) * H + hi) * P;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int p = tx + kSide * j;
      if (p < P) dxr[p] = from_f<T>(dxa[i][j]);
    }
    float* dbr = dbh + ((row0 + mg) * H + hi) * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + kSide * j;
      if (n < N) dbr[n] = dba[i][j];
    }
  }
}

// Pass 5: one 64-row tile of one (b, h, chunk).  Thread (ty, tx) owns rows
// l = ty + 16 i (i < 4); of a score tile the keys m = tx + 16 j (j < 4),
// of dc the columns n = tx + 16 j.
template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_query_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy, const float* __restrict__ cum,
                     const float* __restrict__ st, float* __restrict__ dch,
                     float* __restrict__ dcum2, int t_len, int H, int P,
                     int G, int N, int L) {
  using PL = Plan<NT, PT>;
  constexpr int NJ = PL::kNJ;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                            // [64][NT + 1] rows' c
  float* dys = cs + PL::kNTile;                // [64][PT + 1] rows' dy
  float* cuml = dys + PL::kPTile;              // [64]
  float* el = cuml + kTile;                    // [64] exp(cum)
  float* ring = el + kTile;
  float* hs = ring;                            // [NT][PT + 1] H_k, first
  float* bs = ring;                            // [64][NT + 1] keys' b
  float* xs = bs + PL::kNTile;                 // [64][PT + 1] keys' x
  float* cumk = xs + PL::kPTile;               // [64]
  float* dtk = cumk + kTile;                   // [64]
  float* am = dtk + kTile;                     // [64][65] A, by row

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int qt = blockIdx.y, l0 = qt * kTile;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  const float* cg = cum + (long long)bh * t_len + (long long)ci * L;

  stage<kTile, NT>(cs, PL::kNS, c + ((row0 + l0) * G + gi) * N,
                   (long long)G * N, L - l0, N, nullptr);
  stage<kTile, PT>(dys, PL::kPS, dy + ((row0 + l0) * H + hi) * P,
                   (long long)H * P, L - l0, P, nullptr);
  if (tid < kTile) {
    const int l = l0 + tid;
    const float cl = l < L ? cg[l] : 0.f;
    cuml[tid] = cl;
    el[tid] = l < L ? expf(cl) : 0.f;
  }

  float dca[4][NJ], rowt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rowt[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dca[i][j] = 0.f;
  }
  // the state term: dc = exp(cum_l) H dy_l; dcum += c_l . that (H_0 = 0)
  if (ci > 0) {
    stage<NT, PT>(hs, PL::kPS, st + ((long long)bh * nc + ci) * N * P, P,
                  N, P, nullptr);
    __syncthreads();
    for (int p = 0; p < PT; ++p) {
      float dr[4], hr[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dys[(ty + kSide * i) * PL::kPS + p];
#pragma unroll
      for (int j = 0; j < NJ; ++j) hr[j] = hs[(tx + kSide * j) * PL::kPS + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dca[i][j] += dr[i] * hr[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + kSide * i;
      const float e = el[l];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dca[i][j] *= e;
        rowt[i] += cs[l * PL::kNS + tx + kSide * j] * dca[i][j];
      }
    }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int m0 = kt * kTile;
    __syncthreads();                   // H_k, or the last key tile, consumed
    stage<kTile, NT>(bs, PL::kNS, b + ((row0 + m0) * G + gi) * N,
                     (long long)G * N, L - m0, N, nullptr);
    stage<kTile, PT>(xs, PL::kPS, x + ((row0 + m0) * H + hi) * P,
                     (long long)H * P, L - m0, P, nullptr);
    if (tid < kTile) {
      const int m = m0 + tid;
      cumk[tid] = m < L ? cg[m] : 0.f;
      dtk[tid] = m < L ? to_f(dt[(row0 + m) * H + hi]) : 0.f;
    }
    __syncthreads();

    float cb[4][4], dxm[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = dxm[i][j] = 0.f;
    for (int n = 0; n < NT; ++n) {
      float cr[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cr[i] = cs[(ty + kSide * i) * PL::kNS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = bs[(tx + kSide * j) * PL::kNS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] += cr[i] * br[j];
    }
    for (int p = 0; p < PT; ++p) {
      float dr[4], xr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dys[(ty + kSide * i) * PL::kPS + p];
#pragma unroll
      for (int j = 0; j < 4; ++j) xr[j] = xs[(tx + kSide * j) * PL::kPS + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dxm[i][j] += dr[i] * xr[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = tx + kSide * j;
        float av = 0.f;
        if (m0 + m <= l0 + l && l0 + l < L) {
          av = dxm[i][j] * expf(cuml[l] - cumk[m]) * dtk[m];
          rowt[i] += cb[i][j] * av;
        }
        am[l * kTS + m] = av;
      }
    }
    __syncthreads();
    const int keys = min(kTile, L - m0);
    for (int m = 0; m < keys; ++m) {
      float ar[4], br[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = am[(ty + kSide * i) * kTS + m];
#pragma unroll
      for (int j = 0; j < NJ; ++j) br[j] = bs[m * PL::kNS + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dca[i][j] += ar[i] * br[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = ty + kSide * i, lg = l0 + l;
    const float rt = row_sum(rowt[i]);
    if (lg >= L) continue;
    if (tx == 0)
      dcum2[(long long)bh * t_len + (long long)ci * L + lg] = rt;
    float* dcr = dch + ((row0 + lg) * H + hi) * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + kSide * j;
      if (n < N) dcr[n] = dca[i][j];
    }
  }
}

// Pass 6: one warp per (b, h, chunk).  dcum = dcum1 + dcum2, the last row
// plus exp(cum_last) <G, H> + sum_m Q_m; r its reverse inclusive cumsum
// (float64: the terms cancel); ddt = ddt0 + a r; the chunk's share of da,
// sum_l dt_l r_l.  Each lane takes a run of consecutive steps.
template <typename T>
__global__ void __launch_bounds__(kScanWarps * 32)
ssd_bwd_dt_kernel(const T* __restrict__ dt, const float* __restrict__ a,
                  const float* __restrict__ cum,
                  const float* __restrict__ ddt0,
                  const float* __restrict__ dcum1,
                  const float* __restrict__ dcum2,
                  const float* __restrict__ qm, const float* __restrict__ gh,
                  T* __restrict__ ddt, float* __restrict__ dapart,
                  long long n_chunks, int t_len, int H, int L) {
  const long long wid =
      (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= n_chunks) return;
  const int nc = t_len / L;
  const long long bh = wid / nc;
  const int ci = (int)(wid - bh * nc);
  const int bi = (int)(bh / H), hi = (int)(bh - (bh / H) * H);
  const long long base = bh * t_len + (long long)ci * L;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  const int per = (L + 31) / 32;
  const int beg = min(lane * per, L), end = min(beg + per, L);

  double qs = 0.0;
  for (int l = beg; l < end; ++l) qs += qm[base + l];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qs += __shfl_xor_sync(0xffffffffu, qs, o);
  const double extra =
      (double)expf(cum[base + L - 1]) * (double)gh[wid] + qs;

  double seg = 0.0;
  for (int l = beg; l < end; ++l)
    seg += (double)dcum1[base + l] + (double)dcum2[base + l] +
           (l == L - 1 ? extra : 0.0);
  double tot = seg;                    // sum over this lane and later lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double dn = __shfl_down_sync(0xffffffffu, tot, o);
    if (lane + o < 32) tot += dn;
  }
  double run = tot - seg;              // sum over later lanes
  const float av = a[hi];
  double dap = 0.0;
  for (int l = end - 1; l >= beg; --l) {
    run += (double)dcum1[base + l] + (double)dcum2[base + l] +
           (l == L - 1 ? extra : 0.0);
    const float r = (float)run;
    const float d = to_f(dt[(row0 + l) * H + hi]);
    ddt[(row0 + l) * H + hi] = from_f<T>(ddt0[base + l] + av * r);
    dap += (double)d * run;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dap += __shfl_xor_sync(0xffffffffu, dap, o);
  if (lane == 0) dapart[wid] = (float)dap;
}

// Pass 7: da[h] = sum over batch and chunks of the chunks' shares, in order.
__global__ void __launch_bounds__(kCarryThreads)
ssd_bwd_da_kernel(const float* __restrict__ dapart, float* __restrict__ da,
                  int bsz, int H, int nc) {
  const int h = blockIdx.x * kCarryThreads + threadIdx.x;
  if (h >= H) return;
  double s = 0.0;
  for (int bi = 0; bi < bsz; ++bi)
    for (int k = 0; k < nc; ++k)
      s += dapart[((long long)bi * H + h) * nc + k];
  da[h] = (float)s;
}

// Pass 8: db and dc [B, T, G, N] from the per-head partials [B, T, H, N],
// the heads of a group added in order.
template <typename T>
__global__ void __launch_bounds__(kCarryThreads)
ssd_bwd_group_kernel(const float* __restrict__ dbh,
                     const float* __restrict__ dch, T* __restrict__ db,
                     T* __restrict__ dc, long long n_elems, int H, int G,
                     int N) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= n_elems) return;
  const int rep = H / G;
  const long long bt = i / ((long long)G * N);
  const int gn = (int)(i - bt * G * N);
  const int g = gn / N, n = gn - (gn / N) * N;
  const long long src = (bt * H + (long long)g * rep) * N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    sb += dbh[src + (long long)r * N];
    sc += dch[src + (long long)r * N];
  }
  db[i] = from_f<T>(sb);
  dc[i] = from_f<T>(sc);
}

// --------------------------------------------------------------------------
// bwd_mma_3xtf32: passes 0, 2, 4 and 5 on the tensor cores
// --------------------------------------------------------------------------
constexpr int kMmaThreads = 128;      // 4 warps of 16 rows
constexpr int kStages = 2;            // cp.async ring depth

// Shared memory per width tile (N zero-padded to NT, P to PT), in floats.
// The key and row passes read b, c, x and dy rows by ldmatrix and by
// scalar loads at rows 2t, 2t + 1 (the width tile plus 4 words: an odd
// number of 16-byte units, conflict-free for both); G_k and H_k, [N][P],
// take the P rows' padding and fill one ring stage at most.  The state
// passes read rows t and t + 4 (plus 8 words), as the forward's.
template <int NT, int PT>
struct MmaPlan {
  static constexpr int kNS = NT + 4;                 // b / c row
  static constexpr int kPS = PT + 4;                 // x / dy, G / H row
  static constexpr int kUS = NT + 8;                 // state passes: b / c
  static constexpr int kVS = PT + 8;                 // state passes: x / dy
  static constexpr int kStateStage = kTile * (kUS + kVS) + kTile;  // + weights
  static constexpr int kStateFloats = kStages * kStateStage;
  static constexpr int kOwn = kTile * (kNS + kPS);   // a block's own two tiles
  // key pass: b, x, then cum, dt, w, exp(cum_last - cum) of its keys; a
  // stage: c, dy and cum of a row tile
  static constexpr int kKeyStage = kOwn + kTile;
  static constexpr int kKeyFloats = kOwn + 4 * kTile + kStages * kKeyStage;
  // row pass: c, dy, then cum and exp(cum) of its rows; a stage: b, x, cum
  // and dt of a key tile
  static constexpr int kQueryStage = kOwn + 2 * kTile;
  static constexpr int kQueryFloats =
      kOwn + 2 * kTile + kStages * kQueryStage;
  static_assert(NT * kPS <= kKeyStage && NT * kPS <= kQueryStage,
                "G_k and H_k fit one ring stage");
  // a key tile's dx and db in two blocks where either width is 128: the
  // accumulators of both beside the two score tiles would spill
  static constexpr bool kSplit = NT > 64 || PT > 64;
  static constexpr int kRoles = kSplit ? 2 : 1;
};

// Sum over the 4 lanes of a quad (the lanes that hold one accumulator
// row), in a fixed order: every lane gets the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [0, ROWS) x columns [0, CT) of a tile into shared memory (row
// stride ss floats); row r of the source starts at src + r * ld.  Zero
// past `valid` rows and past `cols` columns (a multiple of 8).  float32
// arrives by 16-byte cp.async (the caller commits and waits); bfloat16 is
// widened to float32 through registers.
template <typename S, int ROWS, int CT>
__device__ __forceinline__ void stage_rows(float* dst, int ss, const S* src,
                                           long long ld, int valid,
                                           int cols) {
  constexpr int kQuads = CT / 4;
  for (int i = threadIdx.x; i < ROWS * kQuads; i += kMmaThreads) {
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

// The A operand of an accumulator's 8-column slice: each slice's columns
// in the order 0, 2, 4, 6, 1, 3, 5, 7 (C holds columns 2t, 2t + 1 of its
// rows, the TF32 A fragment columns t, t + 4), so the B operand reads its
// rows 2t and 2t + 1.
__device__ __forceinline__ void acc_frag(AFrag<float>& f, const float* s) {
  const uint32_t r[4] = {fbits(s[0]), fbits(s[2]), fbits(s[1]),
                         fbits(s[3])};
  f.set(r);
}

// Passes 0 and 2 on the tensor cores: per (b, h, chunk) out[n][p] =
// sum_l u_l[n] alpha_l v_l[p], the forward's ssd_state_kernel product.
// kStates: u = b, v = x, alpha_l = dt_l exp(cum_last - cum_l), after the
// prefix sum (into the cum scratch); else u = c, v = dy, alpha_l =
// exp(cum_l), cum read.  Warp w owns rows n of [16 MT w, 16 MT (w + 1))
// and every column p; A[n][l] = u_l[n] alpha_l and B[l][p] = v_l[p] by
// scalar loads at rows t and t + 4.
template <typename T, int NT, int PT, bool kStates>
__device__ __forceinline__ void chunk_state_mma(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ dt,
    const float* __restrict__ a, float* cum, float* __restrict__ out,
    int t_len, int H, int P, int G, int N, int L) {
  using PL = MmaPlan<NT, PT>;
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
  const T* dtg = kStates ? dt + row0 * H + hi : nullptr;
  const int ntiles = (L + kTile - 1) / kTile;

  auto load_tile = [&](int i) {
    float* us = smem + (i % kStages) * PL::kStateStage;
    float* vs = us + kTile * PL::kUS;
    const int l0 = i * kTile;
    stage_rows<T, kTile, NT>(us, PL::kUS, u + ((row0 + l0) * G + gi) * N,
                             (long long)G * N, L - l0, N);
    stage_rows<T, kTile, PT>(vs, PL::kVS, v + ((row0 + l0) * H + hi) * P,
                             (long long)H * P, L - l0, P);
  };
  // alpha of row j of tile i, 0 past L; after the prefix sum
  auto load_w = [&](int i, int j) {
    float* ws = smem + (i % kStages) * PL::kStateStage +
                kTile * (PL::kUS + PL::kVS);
    const int l = i * kTile + j;
    float w = 0.f;
    if (l < L)
      w = kStates ? to_f(dtg[(long long)l * H]) * expf(cum_last_s - cg[l])
                  : expf(cg[l]);
    ws[j] = w;
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }
  if (kStates && warp == 0) chunk_cum(dtg, H, a[hi], cg, &cum_last_s, L, lane);
  __syncthreads();                   // cum and cum_last_s are set
  for (int j = tid; j < kStages * kTile; j += kMmaThreads)
    if (j / kTile < ntiles) load_w(j / kTile, j % kTile);

  float acc[MT][PT / 8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int pt = 0; pt < PT / 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][pt][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* us = smem + (i % kStages) * PL::kStateStage;
    const float* vs = us + kTile * PL::kUS;
    const float* ws = vs + kTile * PL::kVS;
#pragma unroll 2
    for (int kk = 0; kk < kTile / 8; ++kk) {
      const int l = 8 * kk + t;
      const float w0 = ws[l], w1 = ws[l + 4];
      AFrag<float> af[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int n0 = (warp * MT + mi) * 16 + g;
        const uint32_t r[4] = {fbits(us[l * PL::kUS + n0] * w0),
                               fbits(us[l * PL::kUS + n0 + 8] * w0),
                               fbits(us[(l + 4) * PL::kUS + n0] * w1),
                               fbits(us[(l + 4) * PL::kUS + n0 + 8] * w1)};
        af[mi].set(r);
      }
#pragma unroll
      for (int pt = 0; pt < PT / 8; ++pt) {
        BFrag<float> bf;
        bf.set(fbits(vs[l * PL::kVS + 8 * pt + g]),
               fbits(vs[(l + 4) * PL::kVS + 8 * pt + g]));
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

  float* o = out + ((long long)bh * nc + ci) * N * P;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = (warp * MT + mi) * 16 + g + 8 * r;
      if (n >= N) continue;
#pragma unroll
      for (int pt = 0; pt < PT / 8; ++pt) {
        const int p = 8 * pt + 2 * t;
        if (p < P)
          store2(o + (long long)n * P + p, acc[mi][pt][2 * r],
                 acc[mi][pt][2 * r + 1]);
      }
    }
}

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_bwd_state_mma_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                         const float* __restrict__ a, const T* __restrict__ b,
                         float* cum, float* __restrict__ st, int t_len, int H,
                         int P, int G, int N, int L) {
  chunk_state_mma<T, NT, PT, true>(b, x, dt, a, cum, st, t_len, H, P, G, N,
                                   L);
}

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_bwd_dstate_mma_kernel(const T* __restrict__ dy, const T* __restrict__ c,
                          float* cum, float* __restrict__ gst, int t_len,
                          int H, int P, int G, int N, int L) {
  chunk_state_mma<T, NT, PT, false>(c, dy, (const T*)nullptr, nullptr, cum,
                                    gst, t_len, H, P, G, N, L);
}

// Pass 4 on the tensor cores: one 64-key tile of one (b, h, chunk); kDx:
// dx, the direct ddt, dcum1, Q and (first key tile) <G, H>; kDb: the db
// partial.  Warp w owns keys m = 16 w + g and 16 w + g + 8 of the tile
// (accumulator rows); of a score tile column 8n + 2t + (e & 1) is row l of
// the row tile.
template <typename T, int NT, int PT, bool kDx, bool kDb>
__device__ __forceinline__ void key_tile_mma(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ dy, const float* __restrict__ cum,
    const float* __restrict__ st, const float* __restrict__ gst,
    T* __restrict__ dx, float* __restrict__ dbh, float* __restrict__ ddt0,
    float* __restrict__ dcum1, float* __restrict__ qm,
    float* __restrict__ gh, int t_len, int H, int P, int G, int N, int L) {
  using PL = MmaPlan<NT, PT>;
  constexpr int rsN = PL::kNS * 4, rsP = PL::kPS * 4;   // bytes a row
  extern __shared__ __align__(128) float smem[];
  float* bs = smem;                            // [64][kNS] keys' b
  float* xs = bs + kTile * PL::kNS;            // [64][kPS] keys' x
  float* cumk = xs + kTile * PL::kPS;          // [64]
  float* dtk = cumk + kTile;                   // [64]
  float* wk = dtk + kTile;                     // [64] dt exp(cum_last - cum)
  float* ek = wk + kTile;                      // [64] exp(cum_last - cum)
  float* ring = ek + kTile;                    // stages: c, dy, cum
  float* gs = ring + PL::kKeyStage;            // [NT][kPS] G_k, first
  __shared__ float red[kMmaThreads / 32];

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int kt = blockIdx.y, m0 = kt * kTile;  // the heaviest first
  const int ntiles = (L + kTile - 1) / kTile - kt;   // row tiles l >= m0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  const float* cg = cum + (long long)bh * t_len + (long long)ci * L;
  const long long sbase = ((long long)bh * nc + ci) * N * P;
  const float cum_last = cg[L - 1];

  auto load_tile = [&](int i) {
    float* cs = ring + (i % kStages) * PL::kKeyStage;
    float* dys = cs + kTile * PL::kNS;
    float* cl = dys + kTile * PL::kPS;
    const int l0 = (kt + i) * kTile;
    stage_rows<T, kTile, NT>(cs, PL::kNS, c + ((row0 + l0) * G + gi) * N,
                             (long long)G * N, L - l0, N);
    stage_rows<T, kTile, PT>(dys, PL::kPS, dy + ((row0 + l0) * H + hi) * P,
                             (long long)H * P, L - l0, P);
    if (tid < kTile) cl[tid] = l0 + tid < L ? cg[l0 + tid] : 0.f;
  };

  // the keys' tiles, the first row tile and G_k (in the second stage)
  if (kDx)
    stage_rows<T, kTile, NT>(bs, PL::kNS, b + ((row0 + m0) * G + gi) * N,
                             (long long)G * N, L - m0, N);
  stage_rows<T, kTile, PT>(xs, PL::kPS, x + ((row0 + m0) * H + hi) * P,
                           (long long)H * P, L - m0, P);
  load_tile(0);
  stage_rows<float, NT, PT>(gs, PL::kPS, gst + sbase, P, N, P);
  cp_async_commit();
  if (tid < kTile) {
    const int m = m0 + tid;
    float cm = 0.f, d = 0.f, e = 0.f;
    if (m < L) {
      cm = cg[m];
      d = to_f(dt[(row0 + m) * H + hi]);
      e = expf(cum_last - cm);
    }
    cumk[tid] = cm;
    dtk[tid] = d;
    ek[tid] = e;
    wk[tid] = d * e;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this lane's keys; ldmatrix addresses: A from the warp's 16 key rows
  // (row halves by lane bit 3, byte halves by bit 4), B from a tile whose
  // rows are the product's columns (rows 0-7 / 8-15 by bit 4, byte halves
  // by bit 3)
  const int wk0 = warp * 16, ka = wk0 + g, kb = ka + 8;
  const float cum_a = cumk[ka], cum_b = cumk[kb];
  const float dt_a = dtk[ka], dt_b = dtk[kb];
  const int a_row = wk0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t b_a = smem_u32(bs) + a_row * rsN + (lane >> 4) * 16;
  const uint32_t x_a = smem_u32(xs) + a_row * rsP + (lane >> 4) * 16;
  const int bn_row = (lane & 7) + (lane >> 4) * 8;
  const int bn_off = ((lane >> 3) & 1) * 16;

  // a role's unused accumulators are never read: the compiler drops them
  float dxa[PT / 8][4], dba[NT / 8][4];
#pragma unroll
  for (int pt = 0; pt < PT / 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[pt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[nt][e] = 0.f;

  // the state terms: dx = w_m (b_m . G), db = w_m (G x_m), and
  // b_m^T G x_m = (b_m . G) . x_m before the weight
  float bgx[2] = {0.f, 0.f};
  if constexpr (kDx) {
    // B[n][p] = G[n][p]: rows 8 kk + t and + 4, column 8 pt + g
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk) {
      uint32_t r[4];
      AFrag<float> af;
      ldsm_x4(r, b_a + kk * 32);
      af.set(r);
      const float* g0 = gs + (8 * kk + t) * PL::kPS + g;
      const float* g1 = g0 + 4 * PL::kPS;
#pragma unroll
      for (int pt = 0; pt < PT / 8; ++pt) {
        BFrag<float> bf;
        bf.set(fbits(g0[8 * pt]), fbits(g1[8 * pt]));
        mma(dxa[pt], af, bf);
      }
    }
#pragma unroll
    for (int pt = 0; pt < PT / 8; ++pt) {
      const float2 xa = *reinterpret_cast<const float2*>(
          xs + ka * PL::kPS + 8 * pt + 2 * t);
      const float2 xb = *reinterpret_cast<const float2*>(
          xs + kb * PL::kPS + 8 * pt + 2 * t);
      bgx[0] += dxa[pt][0] * xa.x + dxa[pt][1] * xa.y;
      bgx[1] += dxa[pt][2] * xb.x + dxa[pt][3] * xb.y;
    }
    bgx[0] = quad_sum(bgx[0]);
    bgx[1] = quad_sum(bgx[1]);
    const float wa = wk[ka], wb = wk[kb];
#pragma unroll
    for (int pt = 0; pt < PT / 8; ++pt) {
      dxa[pt][0] *= wa;
      dxa[pt][1] *= wa;
      dxa[pt][2] *= wb;
      dxa[pt][3] *= wb;
    }
  }
  if constexpr (kDb) {
    // B[p][n] = G[n][p]: ldmatrix over G's rows n
    const uint32_t g_b = smem_u32(gs) + bn_row * rsP + bn_off;
#pragma unroll
    for (int kk = 0; kk < PT / 8; ++kk) {
      uint32_t r[4];
      AFrag<float> af;
      ldsm_x4(r, x_a + kk * 32);
      af.set(r);
#pragma unroll
      for (int n2 = 0; n2 < NT / 16; ++n2) {
        BFrag<float> b0, b1;
        ldsm_x4(r, g_b + n2 * 16 * rsP + kk * 32);
        b0.set(r[0], r[1]);
        b1.set(r[2], r[3]);
        mma(dba[2 * n2], af, b0);
        mma(dba[2 * n2 + 1], af, b1);
      }
    }
    const float wa = wk[ka], wb = wk[kb];
#pragma unroll
    for (int nt = 0; nt < NT / 8; ++nt) {
      dba[nt][0] *= wa;
      dba[nt][1] *= wa;
      dba[nt][2] *= wb;
      dba[nt][3] *= wb;
    }
  }
  // <G_k, H_k>, once a chunk, in a fixed order
  if (kDx && kt == 0) {
    float part = 0.f;
    for (int e = tid; e < N * P; e += kMmaThreads) {
      const int n = e / P, p = e - (e / P) * P;
      part += gs[n * PL::kPS + p] * st[sbase + e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kMmaThreads / 32; ++w) s += red[w];
      gh[(long long)bh * nc + ci] = s;
    }
  }
  __syncthreads();                   // G_k is consumed: its stage is free
  if (1 < ntiles) load_tile(1);
  cp_async_commit();

  float sd[2] = {0.f, 0.f};          // sum_l s_lm DX_lm, this lane's part
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* cs = ring + (i % kStages) * PL::kKeyStage;
    const float* dys = cs + kTile * PL::kNS;
    const float* cl = dys + kTile * PL::kPS;
    const int l0 = (kt + i) * kTile;

    // S^T = B C^T (kDx) and DX^T = X DY^T: rows = this warp's keys
    float sa[kTile / 8][4], da[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = da[n][e] = 0.f;
    if constexpr (kDx) {
      const uint32_t c_b = smem_u32(cs) + bn_row * rsN + bn_off;
#pragma unroll
      for (int kk = 0; kk < NT / 8; ++kk) {
        uint32_t r[4];
        AFrag<float> af;
        ldsm_x4(r, b_a + kk * 32);
        af.set(r);
#pragma unroll
        for (int n2 = 0; n2 < kTile / 16; ++n2) {
          BFrag<float> b0, b1;
          ldsm_x4(r, c_b + n2 * 16 * rsN + kk * 32);
          b0.set(r[0], r[1]);
          b1.set(r[2], r[3]);
          mma(sa[2 * n2], af, b0);
          mma(sa[2 * n2 + 1], af, b1);
        }
      }
    }
    const uint32_t dy_b = smem_u32(dys) + bn_row * rsP + bn_off;
#pragma unroll
    for (int kk = 0; kk < PT / 8; ++kk) {
      uint32_t r[4];
      AFrag<float> af;
      ldsm_x4(r, x_a + kk * 32);
      af.set(r);
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        BFrag<float> b0, b1;
        ldsm_x4(r, dy_b + n2 * 16 * rsP + kk * 32);
        b0.set(r[0], r[1]);
        b1.set(r[2], r[3]);
        mma(da[2 * n2], af, b0);
        mma(da[2 * n2 + 1], af, b1);
      }
    }

    // the mask (l >= m, l < L: selected before the exp, which overflows
    // above the diagonal), the decay and dt_m: s = S^T dec, sd += s DX,
    // then s dt_m and A = DX dec dt_m in place
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = 8 * n + 2 * t + (e & 1);
        const int key = (e >> 1) ? kb : ka;
        const bool in = l0 + l >= m0 + key && l0 + l < L;
        const float dec =
            in ? expf(cl[l] - ((e >> 1) ? cum_b : cum_a)) : 0.f;
        const float dk = (e >> 1) ? dt_b : dt_a;
        if constexpr (kDx) {
          const float s = sa[n][e] * dec;
          sd[e >> 1] += s * da[n][e];
          sa[n][e] = s * dk;
        }
        if constexpr (kDb) da[n][e] = da[n][e] * dec * dk;
      }

    // dx_m += sum_l s_ml dt_m dy_l and db_m += sum_l A_ml c_l: the
    // accumulators (rows = keys) are the A operands; dy and c rows 8n + 2t
    // and 8n + 2t + 1, column g
    if constexpr (kDx) {
      const float* d_l = dys + 2 * t * PL::kPS + g;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        AFrag<float> pa;
        acc_frag(pa, sa[n]);
        const float* d0 = d_l + 8 * n * PL::kPS;
        const float* d1 = d0 + PL::kPS;
#pragma unroll
        for (int pt = 0; pt < PT / 8; ++pt) {
          BFrag<float> bf;
          bf.set(fbits(d0[8 * pt]), fbits(d1[8 * pt]));
          mma(dxa[pt], pa, bf);
        }
      }
    }
    if constexpr (kDb) {
      const float* c_l = cs + 2 * t * PL::kNS + g;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        AFrag<float> pa;
        acc_frag(pa, da[n]);
        const float* c0 = c_l + 8 * n * PL::kNS;
        const float* c1 = c0 + PL::kNS;
#pragma unroll
        for (int nt = 0; nt < NT / 8; ++nt) {
          BFrag<float> bf;
          bf.set(fbits(c0[8 * nt]), fbits(c1[8 * nt]));
          mma(dba[nt], pa, bf);
        }
      }
    }
    __syncthreads();                 // every warp is done with this stage
    if (i + kStages < ntiles) load_tile(i + kStages);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? kb : ka, mg = m0 + key;
    if constexpr (kDx) {
      const float s = quad_sum(sd[r]);
      if (mg < L) {
        if (t == 0) {
          const long long rr = (long long)bh * t_len + (long long)ci * L + mg;
          const float q = wk[key] * bgx[r];
          ddt0[rr] = s + ek[key] * bgx[r];
          dcum1[rr] = -dtk[key] * s - q;
          qm[rr] = q;
        }
        T* dxr = dx + ((row0 + mg) * H + hi) * P;
#pragma unroll
        for (int pt = 0; pt < PT / 8; ++pt) {
          const int p = 8 * pt + 2 * t;
          if (p < P) store2(dxr + p, dxa[pt][2 * r], dxa[pt][2 * r + 1]);
        }
      }
    }
    if constexpr (kDb) {
      if (mg < L) {
        float* dbr = dbh + ((row0 + mg) * H + hi) * N;
#pragma unroll
        for (int nt = 0; nt < NT / 8; ++nt) {
          const int n = 8 * nt + 2 * t;
          if (n < N) store2(dbr + n, dba[nt][2 * r], dba[nt][2 * r + 1]);
        }
      }
    }
  }
}

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_bwd_key_mma_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ b, const T* __restrict__ c,
                       const T* __restrict__ dy,
                       const float* __restrict__ cum,
                       const float* __restrict__ st,
                       const float* __restrict__ gst, T* __restrict__ dx,
                       float* __restrict__ dbh, float* __restrict__ ddt0,
                       float* __restrict__ dcum1, float* __restrict__ qm,
                       float* __restrict__ gh, int t_len, int H, int P,
                       int G, int N, int L) {
  if constexpr (MmaPlan<NT, PT>::kSplit) {
    if (blockIdx.z == 0)
      key_tile_mma<T, NT, PT, true, false>(x, dt, b, c, dy, cum, st, gst, dx,
                                           dbh, ddt0, dcum1, qm, gh, t_len,
                                           H, P, G, N, L);
    else
      key_tile_mma<T, NT, PT, false, true>(x, dt, b, c, dy, cum, st, gst, dx,
                                           dbh, ddt0, dcum1, qm, gh, t_len,
                                           H, P, G, N, L);
  } else {
    key_tile_mma<T, NT, PT, true, true>(x, dt, b, c, dy, cum, st, gst, dx,
                                        dbh, ddt0, dcum1, qm, gh, t_len, H,
                                        P, G, N, L);
  }
}

// Pass 5 on the tensor cores: one 64-row tile of one (b, h, chunk), the
// heaviest first.  Warp w owns rows l = 16 w + g and 16 w + g + 8 of the
// tile; of a score tile column 8n + 2t + (e & 1) is key m of the key tile.
template <typename T, int NT, int PT>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_bwd_query_mma_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                         const T* __restrict__ b, const T* __restrict__ c,
                         const T* __restrict__ dy,
                         const float* __restrict__ cum,
                         const float* __restrict__ st,
                         float* __restrict__ dch, float* __restrict__ dcum2,
                         int t_len, int H, int P, int G, int N, int L) {
  using PL = MmaPlan<NT, PT>;
  constexpr int rsN = PL::kNS * 4, rsP = PL::kPS * 4;   // bytes a row
  extern __shared__ __align__(128) float smem[];
  float* cs = smem;                            // [64][kNS] rows' c
  float* dys = cs + kTile * PL::kNS;           // [64][kPS] rows' dy
  float* cuml = dys + kTile * PL::kPS;         // [64]
  float* el = cuml + kTile;                    // [64] exp(cum)
  float* ring = el + kTile;                    // stages: b, x, cum, dt
  float* hs = ring + PL::kQueryStage;          // [NT][kPS] H_k, first

  const int nc = t_len / L;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int gi = hi / (H / G);
  const int qt = gridDim.y - 1 - blockIdx.y, l0 = qt * kTile;
  const int ntiles = qt + 1;                   // key tiles m0 <= l0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)bi * t_len + (long long)ci * L;
  const float* cg = cum + (long long)bh * t_len + (long long)ci * L;

  auto load_tile = [&](int i) {
    float* bs = ring + (i % kStages) * PL::kQueryStage;
    float* xs = bs + kTile * PL::kNS;
    float* ck = xs + kTile * PL::kPS;
    float* dk = ck + kTile;
    const int m0 = i * kTile;
    stage_rows<T, kTile, NT>(bs, PL::kNS, b + ((row0 + m0) * G + gi) * N,
                             (long long)G * N, L - m0, N);
    stage_rows<T, kTile, PT>(xs, PL::kPS, x + ((row0 + m0) * H + hi) * P,
                             (long long)H * P, L - m0, P);
    if (tid < kTile) {
      const int m = m0 + tid;
      ck[tid] = m < L ? cg[m] : 0.f;
      dk[tid] = m < L ? to_f(dt[(row0 + m) * H + hi]) : 0.f;
    }
  };

  stage_rows<T, kTile, NT>(cs, PL::kNS, c + ((row0 + l0) * G + gi) * N,
                           (long long)G * N, L - l0, N);
  stage_rows<T, kTile, PT>(dys, PL::kPS, dy + ((row0 + l0) * H + hi) * P,
                           (long long)H * P, L - l0, P);
  load_tile(0);
  if (ci > 0)                        // H_0 = 0: no state term
    stage_rows<float, NT, PT>(hs, PL::kPS,
                              st + ((long long)bh * nc + ci) * N * P, P, N,
                              P);
  cp_async_commit();
  if (tid < kTile) {
    const int l = l0 + tid;
    const float cl = l < L ? cg[l] : 0.f;
    cuml[tid] = cl;
    el[tid] = l < L ? expf(cl) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16, la = wr + g, lb = la + 8;
  const float cum_a = cuml[la], cum_b = cuml[lb];
  const int a_row = wr + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t c_a = smem_u32(cs) + a_row * rsN + (lane >> 4) * 16;
  const uint32_t dy_a = smem_u32(dys) + a_row * rsP + (lane >> 4) * 16;
  const int bn_row = (lane & 7) + (lane >> 4) * 8;
  const int bn_off = ((lane >> 3) & 1) * 16;

  float dca[NT / 8][4], rt[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dca[nt][e] = 0.f;
  // the state term: dc = exp(cum_l) H dy_l, B[p][n] = H[n][p] by ldmatrix
  // over H's rows n; dcum += c_l . that
  if (ci > 0) {
    const uint32_t h_b = smem_u32(hs) + bn_row * rsP + bn_off;
#pragma unroll
    for (int kk = 0; kk < PT / 8; ++kk) {
      uint32_t r[4];
      AFrag<float> af;
      ldsm_x4(r, dy_a + kk * 32);
      af.set(r);
#pragma unroll
      for (int n2 = 0; n2 < NT / 16; ++n2) {
        BFrag<float> b0, b1;
        ldsm_x4(r, h_b + n2 * 16 * rsP + kk * 32);
        b0.set(r[0], r[1]);
        b1.set(r[2], r[3]);
        mma(dca[2 * n2], af, b0);
        mma(dca[2 * n2 + 1], af, b1);
      }
    }
    const float ea = el[la], eb = el[lb];
#pragma unroll
    for (int nt = 0; nt < NT / 8; ++nt) {
      dca[nt][0] *= ea;
      dca[nt][1] *= ea;
      dca[nt][2] *= eb;
      dca[nt][3] *= eb;
      const float2 c2a = *reinterpret_cast<const float2*>(
          cs + la * PL::kNS + 8 * nt + 2 * t);
      const float2 c2b = *reinterpret_cast<const float2*>(
          cs + lb * PL::kNS + 8 * nt + 2 * t);
      rt[0] += c2a.x * dca[nt][0] + c2a.y * dca[nt][1];
      rt[1] += c2b.x * dca[nt][2] + c2b.y * dca[nt][3];
    }
  }
  __syncthreads();                   // H_k is consumed: its stage is free
  if (1 < ntiles) load_tile(1);
  cp_async_commit();

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* bs = ring + (i % kStages) * PL::kQueryStage;
    const float* xs = bs + kTile * PL::kNS;
    const float* ck = xs + kTile * PL::kPS;
    const float* dk = ck + kTile;
    const int m0 = i * kTile;

    // S = C B^T and DX = DY X^T: rows = this warp's rows
    float sa[kTile / 8][4], da[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = da[n][e] = 0.f;
    const uint32_t b_b = smem_u32(bs) + bn_row * rsN + bn_off;
    const uint32_t x_b = smem_u32(xs) + bn_row * rsP + bn_off;
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk) {
      uint32_t r[4];
      AFrag<float> af;
      ldsm_x4(r, c_a + kk * 32);
      af.set(r);
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        BFrag<float> b0, b1;
        ldsm_x4(r, b_b + n2 * 16 * rsN + kk * 32);
        b0.set(r[0], r[1]);
        b1.set(r[2], r[3]);
        mma(sa[2 * n2], af, b0);
        mma(sa[2 * n2 + 1], af, b1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < PT / 8; ++kk) {
      uint32_t r[4];
      AFrag<float> af;
      ldsm_x4(r, dy_a + kk * 32);
      af.set(r);
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        BFrag<float> b0, b1;
        ldsm_x4(r, x_b + n2 * 16 * rsP + kk * 32);
        b0.set(r[0], r[1]);
        b1.set(r[2], r[3]);
        mma(da[2 * n2], af, b0);
        mma(da[2 * n2 + 1], af, b1);
      }
    }

    // A = select(m <= l < L, DX exp(cum_l - cum_m) dt_m, 0); dcum2 +=
    // S A, this lane's part
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * n + 2 * t + (e & 1);
        const int row = (e >> 1) ? lb : la;
        const bool in = m0 + m <= l0 + row && l0 + row < L;
        const float av =
            in ? da[n][e] * expf(((e >> 1) ? cum_b : cum_a) - ck[m]) * dk[m]
               : 0.f;
        rt[e >> 1] += sa[n][e] * av;
        da[n][e] = av;
      }

    // dc += A . b: A from the accumulators, b rows 8n + 2t and + 1, column g
    const float* b_l = bs + 2 * t * PL::kNS + g;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      AFrag<float> pa;
      acc_frag(pa, da[n]);
      const float* b0r = b_l + 8 * n * PL::kNS;
      const float* b1r = b0r + PL::kNS;
#pragma unroll
      for (int nt = 0; nt < NT / 8; ++nt) {
        BFrag<float> bf;
        bf.set(fbits(b0r[8 * nt]), fbits(b1r[8 * nt]));
        mma(dca[nt], pa, bf);
      }
    }
    __syncthreads();                 // every warp is done with this stage
    if (i + kStages < ntiles) load_tile(i + kStages);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float s = quad_sum(rt[r]);
    const int lg = l0 + (r ? lb : la);
    if (lg >= L) continue;
    if (t == 0) dcum2[(long long)bh * t_len + (long long)ci * L + lg] = s;
    float* dcr = dch + ((row0 + lg) * H + hi) * N;
#pragma unroll
    for (int nt = 0; nt < NT / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n < N) store2(dcr + n, dca[nt][2 * r], dca[nt][2 * r + 1]);
    }
  }
}

// What one backward launch runs, kernel by kernel in launch order (passes
// 0 and 1 only when the states are recomputed): dynamic shared memory and
// blocks (bwd_mma_3xtf32's key pass: kRoles blocks a key tile).
struct Launch {
  int kernels = 0;
  long long smem[kMaxKernels] = {};
  long long blocks[kMaxKernels] = {};
};

template <int NT, int PT>
Launch bwd_plan(bool mma, bool recompute, int bsz, int t_len, int H, int N,
                int P, int G, int L) {
  using PL = Plan<NT, PT>;
  using ML = MmaPlan<NT, PT>;
  const long long chunks = (long long)bsz * H * (t_len / L);
  const long long tiles = (L + kTile - 1) / kTile;
  const long long states = ((long long)bsz * H * N * P + kCarryThreads - 1) /
                           kCarryThreads;
  const long long state_smem =
      sizeof(float) * (mma ? ML::kStateFloats : PL::kStateFloats);
  Launch pl;
  auto add = [&](long long smem, long long blocks) {
    pl.smem[pl.kernels] = smem;
    pl.blocks[pl.kernels] = blocks;
    ++pl.kernels;
  };
  if (recompute) {
    add(state_smem, chunks);
    add(0, states);
  }
  add(state_smem, chunks);
  add(0, states);
  add(sizeof(float) * (mma ? ML::kKeyFloats : PL::kKeyFloats),
      chunks * tiles * (mma ? ML::kRoles : 1));
  add(sizeof(float) * (mma ? ML::kQueryFloats : PL::kQueryFloats),
      chunks * tiles);
  add(0, (chunks + kScanWarps - 1) / kScanWarps);
  add(0, (H + kCarryThreads - 1) / kCarryThreads);
  add(0, ((long long)bsz * t_len * G * N + kCarryThreads - 1) / kCarryThreads);
  return pl;
}

// f(NT, PT) at the width tiles of N and P as std::integral_constants, N,
// P <= 128: for bwd_simt each the smallest of 64 and 128 that holds it;
// for bwd_mma_3xtf32 (mma) both 64 or both 128, which halves its
// instantiations (each takes minutes of ptxas) for widths no model runs.
template <typename F>
auto with_tiles(bool mma, int n, int p, F&& f) {
  using W64 = std::integral_constant<int, 64>;
  using W128 = std::integral_constant<int, 128>;
  if (mma) return n <= 64 && p <= 64 ? f(W64(), W64()) : f(W128(), W128());
  if (n <= 64) return p <= 64 ? f(W64(), W64()) : f(W64(), W128());
  return p <= 64 ? f(W128(), W64()) : f(W128(), W128());
}

// Scratch floats, in this order: G_k [B, H, T/L, N, P]; the per-head db
// and dc partials [B, T, H, N] each; ddt0, dcum1, dcum2, Q [B, H, T]
// each; <G, H> and da's shares [B, H, T/L] each.
struct Scratch {
  float *gst, *dbh, *dch, *ddt0, *dcum1, *dcum2, *qm, *gh, *dapart;
  long long total;
  Scratch(float* base, int bsz, int t_len, int H, int N, int P, int L) {
    const long long nc = t_len / L;
    const long long n_st = (long long)bsz * H * nc * N * P;
    const long long n_part = (long long)bsz * t_len * H * N;
    const long long n_row = (long long)bsz * H * t_len;
    const long long n_chunk = (long long)bsz * H * nc;
    float* q = base;
    gst = q;   q += base ? n_st : 0;
    dbh = q;   q += base ? n_part : 0;
    dch = q;   q += base ? n_part : 0;
    ddt0 = q;  q += base ? n_row : 0;
    dcum1 = q; q += base ? n_row : 0;
    dcum2 = q; q += base ? n_row : 0;
    qm = q;    q += base ? n_row : 0;
    gh = q;    q += base ? n_chunk : 0;
    dapart = q;
    total = n_st + 2 * n_part + 4 * n_row + 2 * n_chunk;
  }
};

// A kernel launched with its plan's dynamic shared memory, allowed first.
template <typename K, typename... A>
cudaError_t run(K* kernel, SmemAttr& attr, dim3 grid, int threads,
                long long smem, cudaStream_t stream, A... args) {
  if (smem > 0) {
    const cudaError_t err = attr.allow(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, (size_t)smem, stream>>>(args...);
  return cudaGetLastError();
}

// The passes of one backward launch: bwd_mma_3xtf32's kernels (kMma) or
// bwd_simt's, the carries and the tail shared.
template <typename T, int NT, int PT, bool kMma>
int launch_bwd(const void* x_, const void* dt_, const float* a,
               const void* b_, const void* c_, const void* dy_,
               const float* dh, float* st, float* cum, bool recompute,
               float* scratch, void* dx, void* ddt, float* da, void* db,
               void* dc, int bsz, int t_len, int H, int P, int G, int N,
               int L, cudaStream_t stream) {
  static SmemAttr state_attr, dstate_attr, key_attr, query_attr, none;
  const T *x = (const T*)x_, *dt = (const T*)dt_, *b = (const T*)b_,
          *c = (const T*)c_, *dy = (const T*)dy_;
  const float *cumc = cum, *stc = st;
  const Launch pl =
      bwd_plan<NT, PT>(kMma, recompute, bsz, t_len, H, N, P, G, L);
  const Scratch s(scratch, bsz, t_len, H, N, P, L);
  const int nc = t_len / L;
  const long long n_state = (long long)bsz * H * N * P;
  const unsigned tiles = (unsigned)((L + kTile - 1) / kTile);
  const unsigned chunks = (unsigned)((long long)bsz * H * nc);
  const int threads = kMma ? kMmaThreads : kThreads;
  int k = 0;
  cudaError_t err;
  auto grid1 = [&](int i) { return dim3((unsigned)pl.blocks[i]); };
  if (recompute) {
    if constexpr (kMma)
      err = run(ssd_bwd_state_mma_kernel<T, NT, PT>, state_attr, grid1(k),
                threads, pl.smem[k], stream, x, dt, a, b, cum, st, t_len, H,
                P, G, N, L);
    else
      err = run(ssd_bwd_state_kernel<T, NT, PT>, state_attr, grid1(k),
                threads, pl.smem[k], stream, x, dt, a, b, cum, st, t_len, H,
                P, G, N, L);
    if (err != cudaSuccess) return (int)err;
    ++k;
    err = run(ssd_bwd_state_carry_kernel, none, grid1(k), kCarryThreads, 0,
              stream, st, cumc, n_state, nc, t_len, L, N * P);
    if (err != cudaSuccess) return (int)err;
    ++k;
  }
  if constexpr (kMma)
    err = run(ssd_bwd_dstate_mma_kernel<T, NT, PT>, dstate_attr, grid1(k),
              threads, pl.smem[k], stream, dy, c, cum, s.gst, t_len, H, P, G,
              N, L);
  else
    err = run(ssd_bwd_dstate_kernel<T, NT, PT>, dstate_attr, grid1(k),
              threads, pl.smem[k], stream, dy, c, cum, s.gst, t_len, H, P, G,
              N, L);
  if (err != cudaSuccess) return (int)err;
  ++k;
  err = run(ssd_bwd_grad_carry_kernel, none, grid1(k), kCarryThreads, 0,
            stream, s.gst, cumc, dh, n_state, nc, t_len, L, N * P);
  if (err != cudaSuccess) return (int)err;
  ++k;
  const float* gstc = s.gst;
  if constexpr (kMma)
    err = run(ssd_bwd_key_mma_kernel<T, NT, PT>, key_attr,
              dim3(chunks, tiles, MmaPlan<NT, PT>::kRoles), threads,
              pl.smem[k], stream, x, dt, b, c, dy, cumc, stc, gstc, (T*)dx,
              s.dbh, s.ddt0, s.dcum1, s.qm, s.gh, t_len, H, P, G, N, L);
  else
    err = run(ssd_bwd_key_kernel<T, NT, PT>, key_attr, dim3(chunks, tiles),
              threads, pl.smem[k], stream, x, dt, b, c, dy, cumc, stc, gstc,
              (T*)dx, s.dbh, s.ddt0, s.dcum1, s.qm, s.gh, t_len, H, P, G, N,
              L);
  if (err != cudaSuccess) return (int)err;
  ++k;
  if constexpr (kMma)
    err = run(ssd_bwd_query_mma_kernel<T, NT, PT>, query_attr,
              dim3(chunks, tiles), threads, pl.smem[k], stream, x, dt, b, c,
              dy, cumc, stc, s.dch, s.dcum2, t_len, H, P, G, N, L);
  else
    err = run(ssd_bwd_query_kernel<T, NT, PT>, query_attr,
              dim3(chunks, tiles), threads, pl.smem[k], stream, x, dt, b, c,
              dy, cumc, stc, s.dch, s.dcum2, t_len, H, P, G, N, L);
  if (err != cudaSuccess) return (int)err;
  ++k;
  err = run(ssd_bwd_dt_kernel<T>, none, grid1(k), kScanWarps * 32, 0, stream,
            dt, a, cumc, (const float*)s.ddt0, (const float*)s.dcum1,
            (const float*)s.dcum2, (const float*)s.qm, (const float*)s.gh,
            (T*)ddt, s.dapart, (long long)chunks, t_len, H, L);
  if (err != cudaSuccess) return (int)err;
  ++k;
  err = run(ssd_bwd_da_kernel, none, grid1(k), kCarryThreads, 0, stream,
            (const float*)s.dapart, da, bsz, H, nc);
  if (err != cudaSuccess) return (int)err;
  ++k;
  return (int)run(ssd_bwd_group_kernel<T>, none, grid1(k), kCarryThreads, 0,
                  stream, (const float*)s.dbh, (const float*)s.dch, (T*)db,
                  (T*)dc, (long long)bsz * t_len * G * N, H, G, N);
}

bool takes(int bsz, int t_len, int H, int P, int G, int N, int L) {
  return bsz >= 1 && L >= 1 && t_len >= L && t_len % L == 0 && G >= 1 &&
         H % G == 0 && N >= 1 && N <= 128 && P >= 1 && P <= 128;
}

// variant 0 = bwd_simt (any width), 1 = bwd_mma_3xtf32 (N and P
// multiples of 8)
bool takes_variant(int variant, int N, int P) {
  return variant == 0 || (variant == 1 && N % 8 == 0 && P % 8 == 0);
}

}  // namespace

// Scratch floats a backward launch at these sizes needs (see Scratch); the
// same for either variant.
extern "C" long long ssd_scan_bwd_scratch(int bsz, int t_len, int H, int P,
                                          int G, int N, int L) {
  if (!takes(bsz, t_len, H, P, G, N, L)) return -1;
  return Scratch(nullptr, bsz, t_len, H, N, P, L).total;
}

// What a backward launch of `variant` (0 = bwd_simt, 1 = bwd_mma_3xtf32)
// at these sizes runs (recompute: the states are recomputed first), as
// the launcher sizes it: for each kernel in launch order its dynamic
// shared memory in bytes and its blocks, into smem[9] and blocks[9].
// Returns the number of kernels, or -1 for sizes the variant does not
// take.
extern "C" int ssd_scan_bwd_plan(int variant, int recompute, int bsz,
                                 int t_len, int H, int P, int G, int N,
                                 int L, long long* smem, long long* blocks) {
  if (!takes(bsz, t_len, H, P, G, N, L) || !takes_variant(variant, N, P))
    return -1;
  const Launch pl = with_tiles(variant == 1, N, P, [&](auto nt, auto pt) {
    return bwd_plan<decltype(nt)::value, decltype(pt)::value>(
        variant == 1, recompute != 0, bsz, t_len, H, N, P, G, L);
  });
  for (int i = 0; i < kMaxKernels; ++i) {
    smem[i] = pl.smem[i];
    blocks[i] = pl.blocks[i];
  }
  return pl.kernels;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c, dy and dx, ddt, db, dc).
// variant: 0 = bwd_simt, 1 = bwd_mma_3xtf32 (N and P multiples of 8; x,
// b, c and dy 16-byte aligned).  st [B, H, T/L, N, P] and cum [B, H, T]
// float32: the forward's states entering each chunk and in-chunk prefix
// sums (have_states = 1, the tensor-core forward's scratch), or space
// this call fills (have_states = 0).  dh [B, H, N, P] float32 or null.
// scratch: the floats ssd_scan_bwd_scratch asks for.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const float* a,
                            const void* b, const void* c, const void* dy,
                            const float* dh, float* st, float* cum,
                            int have_states, float* scratch, void* dx,
                            void* ddt, float* da, void* db, void* dc, int bsz,
                            int t_len, int H, int P, int G, int N, int L,
                            int dtype, int variant, void* stream) {
  if (!takes(bsz, t_len, H, P, G, N, L) || !takes_variant(variant, N, P) ||
      (dtype != 0 && dtype != 1) || st == nullptr || cum == nullptr ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool recompute = have_states == 0, mma = variant == 1;
  return with_tiles(mma, N, P, [&](auto nt, auto pt) {
    constexpr int NT = decltype(nt)::value, PT = decltype(pt)::value;
    auto go = [&](auto t, auto m) {
      using T = decltype(t);
      return launch_bwd<T, NT, PT, decltype(m)::value>(
          x, dt, a, b, c, dy, dh, st, cum, recompute, scratch, dx, ddt, da,
          db, dc, bsz, t_len, H, P, G, N, L, s);
    };
    using Mma = std::true_type;
    using Simt = std::false_type;
    if constexpr (NT == PT) {
      if (mma)
        return dtype == 0 ? go(float(), Mma()) : go(__nv_bfloat16(), Mma());
    }
    return dtype == 0 ? go(float(), Simt()) : go(__nv_bfloat16(), Simt());
  });
}
