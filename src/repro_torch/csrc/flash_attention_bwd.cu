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
// contiguous.  float32 or bfloat16 in, float32 accumulation, gradients out
// in the inputs' type.
//
// Three passes, FA2's split, enqueued from one C call.  No atomics: every
// gradient element is summed by one thread in a fixed order, so the
// result is the same bits run to run.  The only scratch is one float2 a
// row:
//
// 1. bwd_delta_kernel: stats[row] = (lse, delta = sum_d do[row, d] o[row,
//    d]), the softmax's rowsum(dP o P), one warp a row; each head's rows
//    padded with zeros to a multiple of 64 (kPadT), so that a query tile
//    reads its stats by 16-byte cp.async.
// 2. dk/dv pass: one block per (b, kv head, 64-key tile) walks the
//    group's query heads and the query tiles that see its keys (causality
//    and the window bound the range), recomputes P = exp(scale q k^T -
//    lse), and accumulates dv += P^T do and, with dP = do v^T and dS = P o
//    (dP - delta), dk += scale dS^T q in registers.
// 3. dq pass: one block per (b, query head, 64-row query tile) walks the
//    key tiles its rows see and accumulates dq += scale dS k.
//
// Both passes recompute the scores: 14 D flops per visible (query, key)
// pair against the 10 D the gradient needs (q k^T, do v^T, P^T do, dS^T q,
// dS k: 2 D each).  A one-pass design would need dq summed over key tiles:
// deterministically, a float32 partial per key tile ([key tiles, B Hq, T,
// D], ~2.7 GB at the train path's q [2, 32, 4096, 80]) and its reduction,
// which costs more device-memory time than the recompute costs on the
// tensor cores.
//
// A row with no visible key (causal with T > S) gets zero gradients: every
// P of it is masked to 0.
//
// Bound: operations, 10 D flops a visible pair on the tensor cores (bf16
// at 989 TFLOP/s; float32 through 3xTF32, at most 495 / 3 = 165).
//
// Two designs of passes 2 and 3, picked by
// jet_flash_attention.bwd_variant from the type before the launch:
//
// * bwd_mma_bf16 / bwd_mma_3xtf32: the five products on the tensor cores
//   through mma.sync (fragments, cp.async and the 3xTF32 split from
//   mma_sync.cuh), 4 warps a block, each warp 16 rows of the block's tile:
//   - dk/dv pass: a warp owns 16 keys.  It computes S^T = k q^T and
//     dP^T = v do^T (k and v the A operands, by ldmatrix from the block's
//     K/V tile; q and do the B operands, ldmatrix from the ring), so that
//     P^T and dS^T are already in its accumulators, rows = its keys.  They
//     feed dv += P^T do and dk += dS^T q straight from registers as the A
//     operand: bf16 packs pairs (the forward's P.V), float32 runs each
//     8-query slice in the order 0, 2, 4, 6, 1, 3, 5, 7 and reads do and
//     q at rows 2tq and 2tq + 1 (scalar loads, bank-conflict free at a row
//     of 4 mod 8 words); bf16 reads them by ldmatrix.trans.  lse and delta
//     are indexed by column, from the stage's stats.  The GQA sum stays in
//     the accumulators across the group's heads, in head order.
//   - dq pass: a warp owns 16 query rows, the forward's loop shape with
//     the extra dP product: S = q k^T, dP = do v^T, then dq += dS k with k
//     as the B operand (bf16 ldmatrix.trans; float32 scalar rows 2tq,
//     2tq + 1).  lse and delta of its two rows a lane sit in registers.
//   - Copies: 16-byte cp.async in a ring of 2 stages (Q/dO tiles and their
//     stats in the dk/dv pass, K/V tiles in the dq pass; the block's own
//     tile once), zero fill past T, S and D; shared rows are the head dim
//     zero-padded to its tile (32, 64, 80, 128, 256, so every loop has a
//     fixed trip count) plus 16 bytes, an odd number of 16-byte units, so
//     ldmatrix reads 8 rows from 8 distinct bank groups.  A warp skips the
//     products of a tile none of its rows sees and masks only tiles its
//     rows see in part.
//   - float32 adds its accumulators into its own rows of dk, dv or dq in
//     device memory (float32 adds, in a fixed order) and restarts them
//     every 256 rows: one tensor-core accumulator chained over thousands
//     of rows drifts (kFlushRows).
//   - Tiles (Plan, which jet_flash_attention.bwd_plan mirrors): the ring's
//     query tile of the dk/dv pass and key tile of the dq pass are 64 / 32
//     / 16 rows by type and head-dim tile, so that a block's shared memory
//     lets two blocks share an SM where it can and the score accumulators
//     (2 x rows / 8 n8 tiles) fit beside dk and dv (2 x D / 8 n8 tiles)
//     without spilling.  At D = 256 dk and dv of a 16-key warp would take
//     256 registers a thread, so the dk/dv pass splits the head dim of the
//     accumulators in two halves, one block each (2 x 128 columns); both
//     halves recompute S and dP (18 D flops a visible pair instead of 14).
//
// * bwd_simt (the first design, kept for a forced comparison only): every
//   product on the CUDA cores in float32, bf16 widened as it is staged,
//   4 x 4 register tiles of FMAs over shared-memory operands (256 threads,
//   ty = tid / 16, tx = tid % 16): score tiles S, dP [BQ, BK]: thread
//   (ty, tx) holds rows ty * RQ + i, columns tx + 16 j; dk, dv [BK, D]:
//   rows ty * RK + i, columns tx + 16 j (DJ of them, guarded past D); dq
//   [BQ, D]: rows ty * RQ + i.  Shared rows: k, v padded to D + 1 words,
//   q, do to D + 4, P / dS to BK + 1.  64 x 64 tiles up to D = 128, 32 x
//   32 past it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;       // the delta pass and bwd_simt
constexpr int kMmaThreads = 128;    // the mma passes: 4 warps of 16 rows
constexpr int kBlock = 64;          // keys of a dk/dv block, rows of a dq block
constexpr int kStages = 2;          // ring depth of the mma passes
constexpr int kPadT = 64;           // stats rows a head: T rounded up to this
constexpr float kLog2e = 1.4426950408889634f;

// dk, dv and dq sum over every query (key) their rows see: up to 16,384
// at the train path (4 heads x 4,096).  The tensor core adds each mma
// step into its float32 accumulator with a truncating addition, so one
// accumulator chained over all of them drifts in one direction, by up to
// an ulp a step: 1.2e-4 of dk's and dv's largest magnitude at the train
// path on the H100 with 3xTF32's 3 steps per 8 rows (chip_smoke.py's
// tolerance is 2e-5).  So in float32 a block adds its accumulators into
// its own rows of the float32 gradient in device memory (an IEEE add,
// round to nearest; the first time a store) and restarts them every
// kFlushRows rows (query tiles in the dk/dv pass, key tiles in the dq
// pass), at most 96 chained steps.  Each element has one owner thread,
// and the flushes come at fixed iterations: no atomics, the same bits run
// to run.  Sums of fresh accumulators in registers would need a second
// set of them, which spilled.  bf16 keeps one chain: 1 step per 16 rows
// drifts at most ~6e-5 at 16,384 rows, far below the bf16 rounding of P
// and dS (2**-9).  The score chains (S, dP: D / 8 steps, 3 each for
// 3xTF32) are bounded by the head dim.  tests/test_torch_flash_bwd.py
// models the truncation: 1.2e-4 chained, 2.6e-6 flushed.
constexpr int kFlushRows = 256;

__host__ __device__ __forceinline__ int pad_rows(int t_len) {
  return (t_len + kPadT - 1) / kPadT * kPadT;
}

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

// whether query row t sees key s (both absolute; rows past T and keys
// past S see nothing)
__device__ __forceinline__ bool sees(int t, int s, int t_len, int s_len,
                                     int offset, int causal, int window) {
  const int gap = t + offset - s;
  bool ok = t < t_len && s < s_len;
  if (causal) ok = ok && gap >= 0;
  if (window > 0) ok = ok && gap < window;
  return ok;
}

// some query of [qa, qb] sees some key of [ka, kb]
__device__ __forceinline__ bool any_sees(int qa, int qb, int ka, int kb,
                                         int t_len, int s_len, int offset,
                                         int causal, int window) {
  qb = min(qb, t_len - 1);
  kb = min(kb, s_len - 1);
  if (qa > qb || ka > kb) return false;
  if (causal && qb + offset - ka < 0) return false;
  if (window > 0 && qa + offset - kb >= window) return false;
  return true;
}

// every query of [qa, qb] sees every key of [ka, kb]
__device__ __forceinline__ bool all_see(int qa, int qb, int ka, int kb,
                                        int t_len, int s_len, int offset,
                                        int causal, int window) {
  return qb < t_len && kb < s_len && (!causal || qa + offset - kb >= 0) &&
         (window <= 0 || qb + offset - ka < window);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One accumulator row (r: C-fragment rows g / g + 8) of a thread's n8
// tiles times mul into row[8 dt + 2 tq], columns below ncol, if in; a
// float32 row adds what row holds unless first (a group of tiles loads
// before it stores, so the loads' latencies overlap); bf16 is
// stored once.  The accumulators restart at 0.
template <typename T, int DA>
__device__ __forceinline__ void flush_row(T* row, float (&acc)[DA / 8][4],
                                          int r, float mul, bool in,
                                          int ncol, bool first) {
  constexpr int kChunk = 4;           // n8 tiles a group of loads
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int d0 = 0; d0 < DA / 8; d0 += kChunk) {
    float2 was[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int col = 8 * (d0 + j) + 2 * tq;
      was[j] = make_float2(0.f, 0.f);
      if (sizeof(T) == 4 && !first && in && d0 + j < DA / 8 && col < ncol)
        was[j] = *reinterpret_cast<const float2*>(row + col);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int dt = d0 + j, col = 8 * dt + 2 * tq;
      if (dt < DA / 8) {
        if (in && col < ncol)
          store2(row + col, acc[dt][2 * r] * mul + was[j].x,
                 acc[dt][2 * r + 1] * mul + was[j].y);
        acc[dt][2 * r] = acc[dt][2 * r + 1] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: stats = (lse, delta = rowsum(do o)), rows padded to kPadT
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, float2* __restrict__ stats,
                 long long rows, int t_len, int d) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int t_pad = pad_rows(t_len);
  const long long bh = row / t_pad;
  const int t = (int)(row - bh * t_pad);
  float2 out = make_float2(0.f, 0.f);
  if (t < t_len) {
    const size_t src = (size_t)bh * t_len + t;
    const T* orow = o + src * d;
    const T* drow = dout + src * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc += to_f(orow[c]) * to_f(drow[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    out = make_float2(lse[src], acc);
  }
  if (lane == 0) stats[row] = out;
}

// ---------------------------------------------------------------------------
// bwd_mma_bf16 / bwd_mma_3xtf32
// ---------------------------------------------------------------------------
// Per type and head-dim tile DT: the shared row (DT's bytes plus 16), the
// 32-byte k steps over the head dim and the 16-byte chunks of a row; the
// dk/dv columns a block accumulates (DA, at most 128: two blocks split
// D = 256) and the split; the query rows a ring stage holds in the dk/dv
// pass (BQ) and the keys a stage holds in the dq pass (BK); each pass's
// dynamic shared memory.  The stage sizes keep the score accumulators
// (BQ or BK floats a thread) beside dk and dv (DA floats) or dq (DT / 2)
// within the register file, and two blocks on an SM up to D = 128 (and
// the bf16 dk/dv pass at 256): float32 past D = 64 and bf16 past D = 80
// halve or quarter them.  Of the sizes that fit, these timed fastest on
// the H100 at the train path's D = 80 f32, vision's 128 f32 and gemma's
// 256 bf16 (tools/flash_bwd_plans.py; PERF.md).
template <typename T, int DT>
struct Plan {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kES = sizeof(T);
  static constexpr int kRow = DT * kES + 16;
  static constexpr int kKSteps = DT * kES / 32;
  static constexpr int kChunks = DT * kES / 16;
  static constexpr int kDA = DT > 128 ? 128 : DT;
  static constexpr int kSplit = DT / kDA;
  static constexpr int kBQ = DT <= 64   ? 64
                             : kF32       ? (DT <= 80 ? 32 : 16)
                             : DT <= 80   ? 64
                             : DT <= 128  ? 32
                                          : 16;
  static constexpr int kBK =
      kF32 ? (DT <= 64 ? 64 : DT <= 80 ? 32 : 16) : (DT <= 128 ? 64 : 32);
  static constexpr int kStageDkdv = 2 * kBQ * kRow + 8 * kBQ;
  static constexpr int kStageDq = 2 * kBK * kRow;
  static constexpr size_t kSmemDkdv =
      (size_t)2 * kBlock * kRow + (size_t)kStages * kStageDkdv;
  static constexpr size_t kSmemDq =
      (size_t)2 * kBlock * kRow + (size_t)kStages * kStageDq;
};

// f(DT) at the head-dim tile of D: the smallest of 32, 64, 80, 128, 256
// that holds it, as an std::integral_constant; D <= 256.
template <typename F>
auto with_d_tile(int d, F&& f) {
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 80) return f(std::integral_constant<int, 80>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

// rows [r0, r0 + rows) of a [n, d] tensor into shared rows of rs bytes by
// 16-byte cp.async, zero past n and past d
template <typename T, int CHUNKS>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src,
                                          int r0, int n, int rows, int d,
                                          int rs) {
  constexpr int ES = sizeof(T);
  const int nchunk = d * ES / 16;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += kMmaThreads) {
    const int r = i / CHUNKS, c = i - (i / CHUNKS) * CHUNKS;
    const bool in = r0 + r < n && c < nchunk;
    const T* from = in ? src + (size_t)(r0 + r) * d + c * (16 / ES) : src;
    cp_async16(smem_u32(dst + r * rs + c * 16), from, in);
  }
}

__device__ __forceinline__ uint32_t fbits(float x) {
  return __float_as_uint(x);
}

// pass 2: dk, dv.  Grid (B * Hkv * split, key tiles of 64).
template <typename T, int DT>
__global__ void __launch_bounds__(kMmaThreads, 1)
bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float2* __restrict__ stats, T* __restrict__ dk,
                    T* __restrict__ dv, int hq, int hkv, int t_len,
                    int s_len, int d, int causal, int window, float scale) {
  using PL = Plan<T, DT>;
  constexpr int BQ = PL::kBQ, DA = PL::kDA, rs = PL::kRow, ES = PL::kES;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  unsigned char* ks = bwd_smem;               // [64][rs]
  unsigned char* vs = ks + kBlock * rs;       // [64][rs]
  unsigned char* ring = vs + kBlock * rs;     // stage: q, do [BQ][rs], stats

  const int bkv = blockIdx.x / PL::kSplit;
  const int c0 = (blockIdx.x - bkv * PL::kSplit) * DA;   // dk/dv columns
  const int b = bkv / hkv, kvh = bkv - (bkv / hkv) * hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * kBlock;         // the heaviest (causal) first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int offset = s_len - t_len;
  const int t_pad = pad_rows(t_len);
  const size_t kvbase = (size_t)bkv * s_len * d;

  // the query tiles that see a key of this block: t + offset >= k0
  // (causal) and t + offset - k1 < window
  const int k1 = min(k0 + kBlock, s_len) - 1;
  int t_lo = 0, t_hi = t_len;
  if (causal) t_lo = max(0, k0 - offset);
  if (window > 0) t_hi = min(t_hi, window + k1 - offset);
  const int i_lo = t_lo / BQ;
  const int n_qt = t_hi > t_lo ? (t_hi + BQ - 1) / BQ - i_lo : 0;
  const int n_it = group * n_qt;              // (head, query tile) pairs

  auto load_stage = [&](int i) {
    unsigned char* st = ring + (i % kStages) * PL::kStageDkdv;
    const int gi = i / n_qt, t0 = (i_lo + i - gi * n_qt) * BQ;
    const size_t bh = (size_t)b * hq + kvh * group + gi;
    load_rows<T, PL::kChunks>(st, q + bh * t_len * d, t0, t_len, BQ, d, rs);
    load_rows<T, PL::kChunks>(st + BQ * rs, dout + bh * t_len * d, t0, t_len,
                              BQ, d, rs);
    const float2* sg = stats + bh * t_pad + t0;
    for (int c = threadIdx.x; c < BQ / 2; c += kMmaThreads)
      cp_async16(smem_u32(st + 2 * BQ * rs + c * 16), sg + 2 * c, true);
  };

  load_rows<T, PL::kChunks>(ks, k + kvbase, k0, s_len, kBlock, d, rs);
  load_rows<T, PL::kChunks>(vs, v + kvbase, k0, s_len, kBlock, d, rs);
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_it) load_stage(i);
    cp_async_commit();
  }

  // ldmatrix addresses of this lane: A from the warp's 16 K / V rows (row
  // halves by lane bit 3, byte halves by bit 4); B from q / do rows (rows
  // 0-7 / 8-15 by bit 4, byte halves by bit 3); B transposed from q / do
  // (query rows by bit 3, 16-byte column halves by bit 4), at column c0
  const int wk = warp * 16, key_lo = k0 + wk;
  const int a_off =
      (wk + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;
  const uint32_t k_a = smem_u32(ks) + a_off, v_a = smem_u32(vs) + a_off;
  const int bn_off =
      ((lane & 7) + (lane >> 4) * 8) * rs + ((lane >> 3) & 1) * 16;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * rs +
                     (lane >> 4) * 16 + c0 * ES;

  float dka[DA / 8][4], dva[DA / 8][4];
#pragma unroll
  for (int i = 0; i < DA / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  // this thread's dk (times scale) and dv into its elements of the output,
  // added to what an earlier flush stored there; the accumulators restart
  auto flush = [&](bool first) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + g + 8 * r;
      flush_row<T, DA>(dk + kvbase + (size_t)key * d + c0, dka, r, scale,
                       key < s_len, d - c0, first);
      flush_row<T, DA>(dv + kvbase + (size_t)key * d + c0, dva, r, 1.f,
                       key < s_len, d - c0, first);
    }
  };
  constexpr int kFlushIt = kFlushRows / BQ;

  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* qs = ring + (i % kStages) * PL::kStageDkdv;
    const unsigned char* dos = qs + BQ * rs;
    const float4* st4 = reinterpret_cast<const float4*>(dos + BQ * rs);
    const int t0 = (i_lo + i % n_qt) * BQ;
    if (any_sees(t0, t0 + BQ - 1, key_lo, key_lo + 15, t_len, s_len, offset,
                 causal, window)) {
      const bool full = all_see(t0, t0 + BQ - 1, key_lo, key_lo + 15, t_len,
                                s_len, offset, causal, window);
      // S^T = K Q^T and dP^T = V dO^T: rows = this warp's keys
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      const uint32_t q_b = smem_u32(qs) + bn_off, o_b = smem_u32(dos) + bn_off;
#pragma unroll
      for (int kk = 0; kk < PL::kKSteps; ++kk) {
        uint32_t r[4];
        AFrag<T> ka, va;
        ldsm_x4(r, k_a + kk * 32);
        ka.set(r);
        ldsm_x4(r, v_a + kk * 32);
        va.set(r);
#pragma unroll
        for (int n2 = 0; n2 < BQ / 16; ++n2) {
          BFrag<T> b0, b1;
          ldsm_x4(r, q_b + n2 * 16 * rs + kk * 32);
          b0.set(r[0], r[1]);
          b1.set(r[2], r[3]);
          mma(s[2 * n2], ka, b0);
          mma(s[2 * n2 + 1], ka, b1);
          ldsm_x4(r, o_b + n2 * 16 * rs + kk * 32);
          b0.set(r[0], r[1]);
          b1.set(r[2], r[3]);
          mma(dp[2 * n2], va, b0);
          mma(dp[2 * n2 + 1], va, b1);
        }
      }
      // P^T and dS^T: column 8n + 2tq + (e & 1) is a query, row g + 8 (e >>
      // 1) a key; (lse, delta) of the lane's two queries in one float4
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float4 ld = st4[4 * n + tq];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2f((s[n][e] * scale - ((e & 1) ? ld.z : ld.x)) *
                          kLog2e);
      }
      if (!full) {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!sees(t0 + 8 * n + 2 * tq + (e & 1), key_lo + g + 8 * (e >> 1),
                      t_len, s_len, offset, causal, window))
              s[n][e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float4 ld = st4[4 * n + tq];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? ld.w : ld.y));
      }

      // dv += P^T dO, dk += dS^T Q: the accumulators are the A operands
      if constexpr (PL::kF32) {
        // queries 8n + 2tq and 8n + 2tq + 1 of this lane's B rows, column g
        const unsigned char* o_l = dos + 2 * tq * rs + (c0 + g) * 4;
        const unsigned char* q_l = qs + 2 * tq * rs + (c0 + g) * 4;
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          AFrag<T> pa, da;
          const uint32_t rp[4] = {fbits(s[n][0]), fbits(s[n][2]),
                                  fbits(s[n][1]), fbits(s[n][3])};
          const uint32_t rd[4] = {fbits(dp[n][0]), fbits(dp[n][2]),
                                  fbits(dp[n][1]), fbits(dp[n][3])};
          pa.set(rp);
          da.set(rd);
          const float* o0 = reinterpret_cast<const float*>(o_l + 8 * n * rs);
          const float* o1 = reinterpret_cast<const float*>(o_l + 8 * n * rs +
                                                           rs);
          const float* q0 = reinterpret_cast<const float*>(q_l + 8 * n * rs);
          const float* q1 = reinterpret_cast<const float*>(q_l + 8 * n * rs +
                                                           rs);
#pragma unroll
          for (int dt = 0; dt < DA / 8; ++dt) {
            BFrag<T> bo, bq;
            bo.set(fbits(o0[8 * dt]), fbits(o1[8 * dt]));
            mma(dva[dt], pa, bo);
            bq.set(fbits(q0[8 * dt]), fbits(q1[8 * dt]));
            mma(dka[dt], da, bq);
          }
        }
      } else {
        const uint32_t q_t = smem_u32(qs) + bt_off;
        const uint32_t o_t = smem_u32(dos) + bt_off;
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          AFrag<T> pa, da;
          pa.x[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
          pa.x[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
          pa.x[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          pa.x[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
          da.x[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
          da.x[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
          da.x[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
          da.x[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
          for (int d2 = 0; d2 < DA / 16; ++d2) {
            uint32_t r[4];
            BFrag<T> b0, b1;
            ldsm_x4_trans(r, o_t + kc * 16 * rs + d2 * 32);
            b0.set(r[0], r[1]);
            b1.set(r[2], r[3]);
            mma(dva[2 * d2], pa, b0);
            mma(dva[2 * d2 + 1], pa, b1);
            ldsm_x4_trans(r, q_t + kc * 16 * rs + d2 * 32);
            b0.set(r[0], r[1]);
            b1.set(r[2], r[3]);
            mma(dka[2 * d2], da, b0);
            mma(dka[2 * d2 + 1], da, b1);
          }
        }
      }
    }
    if constexpr (PL::kF32)
      if ((i + 1) % kFlushIt == 0 && i + 1 < n_it) flush(i + 1 == kFlushIt);
    __syncthreads();                  // every warp is done with this stage
    if (i + kStages < n_it) load_stage(i + kStages);
    cp_async_commit();
  }
  flush(!PL::kF32 || n_it <= kFlushIt);
}

// pass 3: dq.  Grid (B * Hq, query tiles of 64).
template <typename T, int DT>
__global__ void __launch_bounds__(kMmaThreads, 1)
bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float2* __restrict__ stats, T* __restrict__ dq,
                  int hq, int hkv, int t_len, int s_len, int d, int causal,
                  int window, float scale) {
  using PL = Plan<T, DT>;
  constexpr int BK = PL::kBK, rs = PL::kRow;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  unsigned char* qs = bwd_smem;               // [64][rs]
  unsigned char* dos = qs + kBlock * rs;      // [64][rs]
  unsigned char* ring = dos + kBlock * rs;    // stage: k, v [BK][rs]

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - (bh / hq) * hq;
  const int kvh = h / (hq / hkv);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kBlock;   // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int offset = s_len - t_len;
  const size_t qbase = (size_t)bh * t_len * d;
  const size_t kvbase = ((size_t)b * hkv + kvh) * s_len * d;

  // key tiles that hold a visible key for some row of this query tile
  const int last_t = min(t0 + kBlock, t_len) - 1;
  int hi = s_len;
  if (causal) hi = min(hi, last_t + offset + 1);
  int lo = 0;
  if (window > 0) lo = max(0, t0 + offset - window + 1);
  const int j_lo = lo / BK;
  const int ntiles = max((max(hi, 0) + BK - 1) / BK - j_lo, 0);

  auto load_stage = [&](int i) {
    unsigned char* st = ring + (i % kStages) * PL::kStageDq;
    load_rows<T, PL::kChunks>(st, k + kvbase, (j_lo + i) * BK, s_len, BK, d,
                              rs);
    load_rows<T, PL::kChunks>(st + BK * rs, v + kvbase, (j_lo + i) * BK,
                              s_len, BK, d, rs);
  };
  load_rows<T, PL::kChunks>(qs, q + qbase, t0, t_len, kBlock, d, rs);
  load_rows<T, PL::kChunks>(dos, dout + qbase, t0, t_len, kBlock, d, rs);
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < ntiles) load_stage(i);
    cp_async_commit();
  }

  // ldmatrix addresses as in the dk/dv pass, with q / do as A and k / v as
  // B (k also transposed, for dq += dS k)
  const int wr = warp * 16, r_lo = t0 + wr;
  const int a_off =
      (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;
  const uint32_t q_a = smem_u32(qs) + a_off, o_a = smem_u32(dos) + a_off;
  const int bn_off =
      ((lane & 7) + (lane >> 4) * 8) * rs + ((lane >> 3) & 1) * 16;
  const int bt_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;
  // (lse, delta) of rows g and g + 8 (zeros past T: the pad)
  const float2* srow = stats + (size_t)bh * pad_rows(t_len) + r_lo + g;
  const float2 st[2] = {srow[0], srow[8]};

  float dqa[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;

  // this thread's dq (times scale) into its elements of the output, added
  // to what an earlier flush stored there; the accumulators restart
  auto flush = [&](bool first) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r_lo + g + 8 * r;
      flush_row<T, DT>(dq + qbase + (size_t)t * d, dqa, r, scale,
                       t < t_len, d, first);
    }
  };
  constexpr int kFlushIt = kFlushRows / BK;

  for (int i = 0; i < ntiles; ++i) {
    const int s0 = (j_lo + i) * BK;
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* ks = ring + (i % kStages) * PL::kStageDq;
    const unsigned char* vs = ks + BK * rs;
    if (any_sees(r_lo, r_lo + 15, s0, s0 + BK - 1, t_len, s_len, offset,
                 causal, window)) {
      const bool full = all_see(r_lo, r_lo + 15, s0, s0 + BK - 1, t_len,
                                s_len, offset, causal, window);
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S = Q K^T, dP = dO V^T
      const uint32_t k_b = smem_u32(ks) + bn_off, v_b = smem_u32(vs) + bn_off;
#pragma unroll
      for (int kk = 0; kk < PL::kKSteps; ++kk) {
        uint32_t r[4];
        AFrag<T> qa, oa;
        ldsm_x4(r, q_a + kk * 32);
        qa.set(r);
        ldsm_x4(r, o_a + kk * 32);
        oa.set(r);
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          BFrag<T> b0, b1;
          ldsm_x4(r, k_b + n2 * 16 * rs + kk * 32);
          b0.set(r[0], r[1]);
          b1.set(r[2], r[3]);
          mma(s[2 * n2], qa, b0);
          mma(s[2 * n2 + 1], qa, b1);
          ldsm_x4(r, v_b + n2 * 16 * rs + kk * 32);
          b0.set(r[0], r[1]);
          b1.set(r[2], r[3]);
          mma(dp[2 * n2], oa, b0);
          mma(dp[2 * n2 + 1], oa, b1);
        }
      }
      // P and dS: row g + 8 (e >> 1), key column 8n + 2tq + (e & 1)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2f((s[n][e] * scale - st[e >> 1].x) * kLog2e);
      if (!full) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!sees(r_lo + g + 8 * (e >> 1), s0 + 8 * n + 2 * tq + (e & 1),
                      t_len, s_len, offset, causal, window))
              s[n][e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - st[e >> 1].y);

      // dq += dS K: dS is the A operand from the accumulators
      if constexpr (PL::kF32) {
        // keys 8n + 2tq and 8n + 2tq + 1 of this lane's B rows, column g
        const unsigned char* k_l = ks + 2 * tq * rs + g * 4;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          AFrag<T> da;
          const uint32_t rd[4] = {fbits(dp[n][0]), fbits(dp[n][2]),
                                  fbits(dp[n][1]), fbits(dp[n][3])};
          da.set(rd);
          const float* k0r = reinterpret_cast<const float*>(k_l + 8 * n * rs);
          const float* k1r =
              reinterpret_cast<const float*>(k_l + (8 * n + 1) * rs);
#pragma unroll
          for (int dt = 0; dt < DT / 8; ++dt) {
            BFrag<T> bb;
            bb.set(fbits(k0r[8 * dt]), fbits(k1r[8 * dt]));
            mma(dqa[dt], da, bb);
          }
        }
      } else {
        const uint32_t k_t = smem_u32(ks) + bt_off;
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
          AFrag<T> da;
          da.x[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
          da.x[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
          da.x[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
          da.x[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
          for (int d2 = 0; d2 < DT / 16; ++d2) {
            uint32_t r[4];
            BFrag<T> b0, b1;
            ldsm_x4_trans(r, k_t + kc * 16 * rs + d2 * 32);
            b0.set(r[0], r[1]);
            b1.set(r[2], r[3]);
            mma(dqa[2 * d2], da, b0);
            mma(dqa[2 * d2 + 1], da, b1);
          }
        }
      }
    }
    if constexpr (PL::kF32)
      if ((i + 1) % kFlushIt == 0 && i + 1 < ntiles)
        flush(i + 1 == kFlushIt);
    __syncthreads();                  // every warp is done with this stage
    if (i + kStages < ntiles) load_stage(i + kStages);
    cp_async_commit();
  }
  flush(!PL::kF32 || ntiles <= kFlushIt);
}

template <typename T, int DT>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const float2* stats, void* dq, void* dk,
               void* dv, int bsz, int hq, int hkv, int t_len, int s_len,
               int d, int causal, int window, float scale, cudaStream_t st) {
  using PL = Plan<T, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_mma_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PL::kSmemDkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_mma_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PL::kSmemDq);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)(bsz * hkv * PL::kSplit),
                (unsigned)((s_len + kBlock - 1) / kBlock));
  bwd_dkdv_mma_kernel<T, DT><<<g2, kMmaThreads, PL::kSmemDkdv, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dk,
      (T*)dv, hq, hkv, t_len, s_len, d, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g3((unsigned)(bsz * hq),
                (unsigned)((t_len + kBlock - 1) / kBlock));
  bwd_dq_mma_kernel<T, DT><<<g3, kMmaThreads, PL::kSmemDq, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dq,
      hq, hkv, t_len, s_len, d, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bwd_simt: the first design, on the CUDA cores
// ---------------------------------------------------------------------------
// Shared memory of its two passes (one plan, which
// jet_flash_attention.bwd_plan mirrors): k and v tiles, q and do tiles,
// one P / dS tile, lse and delta of the q tile.
size_t simt_smem_bytes(int bq, int bk, int d) {
  return sizeof(float) * ((size_t)2 * bk * (d + 1) + (size_t)2 * bq * (d + 4) +
                          (size_t)bq * (bk + 1) + 2 * (size_t)bq);
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

// lse and delta of the q tile's rows from the stats (zeros past T)
template <int BQ>
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s,
                                           const float2* stats, size_t bh,
                                           int t0, int t_len) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const float2 st = stats[bh * pad_rows(t_len) + t0 + r];
    lse_s[r] = st.x;
    dl_s[r] = st.y;
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
__device__ __forceinline__ void simt_probs(float (&s)[BQ / 16][BK / 16],
                                           float (&dp)[BQ / 16][BK / 16],
                                           const float* lse_s,
                                           const float* dl_s, int t0, int k0,
                                           int t_len, int s_len, int offset,
                                           int causal, int window) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int key = k0 + tx + 16 * j;
      const float p = sees(t0 + r, key, t_len, s_len, offset, causal, window)
                          ? expf(s[i][j] - lse_s[r])
                          : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

template <typename T, int BQ, int BK, int DJ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float2* __restrict__ stats, T* __restrict__ dk,
                     T* __restrict__ dv, int hq, int hkv, int t_len,
                     int s_len, int d, int causal, int window, float scale) {
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
      load_stats<BQ>(lse_s, dl_s, stats, bh, t0, t_len);
      __syncthreads();

      float s[RQ][RK], dp[RQ][RK];
      scores<BQ, BK>(qs, dos, ks, vs, d, s, dp);
      simt_probs<BQ, BK>(s, dp, lse_s, dl_s, t0, k0, t_len, s_len, offset,
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

template <typename T, int BQ, int BK, int DJ>
__global__ void __launch_bounds__(kThreads)
bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float2* __restrict__ stats, T* __restrict__ dq,
                   int hq, int hkv, int t_len, int s_len, int d, int causal,
                   int window, float scale) {
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
  load_stats<BQ>(lse_s, dl_s, stats, bh, t0, t_len);

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
    simt_probs<BQ, BK>(s, dp, lse_s, dl_s, t0, k0, t_len, s_len, offset,
                       causal, window);
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
int launch_simt(const void* q, const void* k, const void* v,
                const void* dout, const float2* stats, void* dq, void* dk,
                void* dv, int bsz, int hq, int hkv, int t_len, int s_len,
                int d, int causal, int window, float scale,
                cudaStream_t st) {
  const size_t smem = simt_smem_bytes(BQ, BK, d);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_simt_kernel<T, BQ, BK, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_simt_kernel<T, BQ, BK, DJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)(bsz * hkv), (unsigned)((s_len + BK - 1) / BK));
  bwd_dkdv_simt_kernel<T, BQ, BK, DJ><<<g2, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dk,
      (T*)dv, hq, hkv, t_len, s_len, d, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g3((unsigned)(bsz * hq), (unsigned)((t_len + BQ - 1) / BQ));
  bwd_dq_simt_kernel<T, BQ, BK, DJ><<<g3, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dq,
      hq, hkv, t_len, s_len, d, causal, window, scale);
  return (int)cudaGetLastError();
}

// simt tiles by head dim: 64 x 64 up to D = 128 (DJ output columns a
// thread, the smallest that covers D), 32 x 32 at D <= 256, where 64-row
// tiles would not fit the 227 KB of shared memory.  (query tile, key tile)
int simt_tile(int d) { return d <= 128 ? 64 : 32; }

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v,
                  const void* dout, const float2* stats, void* dq, void* dk,
                  void* dv, int bsz, int hq, int hkv, int t_len, int s_len,
                  int d, int causal, int window, float scale,
                  cudaStream_t st) {
#define REPRO_BWD(BQ, BK, DJ)                                                \
  return launch_simt<T, BQ, BK, DJ>(q, k, v, dout, stats, dq, dk, dv, bsz,   \
                                    hq, hkv, t_len, s_len, d, causal,        \
                                    window, scale, st)
  if (d <= 64) REPRO_BWD(64, 64, 4);
  if (d <= 80) REPRO_BWD(64, 64, 5);
  if (d <= 128) REPRO_BWD(64, 64, 8);
  REPRO_BWD(32, 32, 16);
#undef REPRO_BWD
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float2* stats, void* dq,
             void* dk, void* dv, int bsz, int hq, int hkv, int t_len,
             int s_len, int d, int causal, int window, float scale,
             int variant, cudaStream_t st) {
  const long long rows = (long long)bsz * hq * pad_rows(t_len);
  bwd_delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) /
                                   (kThreads / 32)),
                        kThreads, 0, st>>>((const T*)o, (const T*)dout, lse,
                                           stats, rows, t_len, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (variant == 0)
    return dispatch_simt<T>(q, k, v, dout, stats, dq, dk, dv, bsz, hq, hkv,
                            t_len, s_len, d, causal, window, scale, st);
  return with_d_tile(d, [&](auto dt) {
    return launch_mma<T, decltype(dt)::value>(q, k, v, dout, stats, dq, dk,
                                              dv, bsz, hq, hkv, t_len, s_len,
                                              d, causal, window, scale, st);
  });
}

template <typename T>
void mma_plan(int d, int* out) {
  with_d_tile(d, [&](auto dt) {
    using PL = Plan<T, decltype(dt)::value>;
    out[0] = PL::kBQ;
    out[1] = PL::kBK;
    out[2] = PL::kSplit;
    out[3] = (int)PL::kSmemDkdv;
    out[4] = (int)PL::kSmemDq;
    out[5] = PL::kF32 ? kFlushRows : 0;
    return 0;
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = bwd_simt, 1 = the mma
// design (bwd_mma_3xtf32 for float32, bwd_mma_bf16 for bfloat16).  d a
// multiple of 8 up to 256.  window <= 0 means no window.  stats: float32
// scratch of B * Hq * T_pad * 2, T_pad = T rounded up to a multiple of 64.
// Enqueues the three passes on the stream; returns the CUDA error of the
// launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* stats, void* dq, void* dk, void* dv,
                                   int bsz, int hq, int hkv, int t_len,
                                   int s_len, int d, int causal, int window,
                                   float scale, int dtype, int variant,
                                   void* stream) {
  if (hkv < 1 || hq % hkv != 0 || (dtype != 0 && dtype != 1) ||
      (variant != 0 && variant != 1) || d < 8 || d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, (const float*)lse,
                           (float2*)stats, dq, dk, dv, bsz, hq, hkv, t_len,
                           s_len, d, causal, window, scale, variant, st);
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse,
                                 (float2*)stats, dq, dk, dv, bsz, hq, hkv,
                                 t_len, s_len, d, causal, window, scale,
                                 variant, st);
}

// The tile plan the launcher sizes its launches by, for
// jet_flash_attention.bwd_plan to be held against: out[0] the dk/dv
// pass's query rows a stage, out[1] the dq pass's keys a stage, out[2] the
// dk/dv column split, out[3] / out[4] the two passes' dynamic shared
// memory in bytes, out[5] the rows between float32 flushes (0: none)
// (bwd_simt: its one tile for both passes and its one plan).  Returns 0,
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_bwd_plan(int dtype, int variant, int d,
                                        int* out) {
  if ((dtype != 0 && dtype != 1) || (variant != 0 && variant != 1) ||
      d < 8 || d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    const int t = simt_tile(d);
    out[0] = out[1] = t;
    out[2] = 1;
    out[3] = out[4] = (int)simt_smem_bytes(t, t, d);
    out[5] = 0;
  } else if (dtype == 0) {
    mma_plan<float>(d, out);
  } else {
    mma_plan<__nv_bfloat16>(d, out);
  }
  return 0;
}
