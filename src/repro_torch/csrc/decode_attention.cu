// One-token GQA decode attention over a paged KV cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_paged / _decode_kernel
// of src/repro/kernels/jet_decode_attention.py.  Inputs: q [B, Hq, D];
// k / v pages [P, page, Hkv, D]; page table [B, maxp] int32 (-1 = hole);
// lengths [B] int32.  Outputs: o [B, Hq, D] in q's type and lse [B, Hq]
// float32, so that partial results over shards of the pages merge
// (ref.combine_partial_attention).  q and the pages may each be float32
// or bfloat16.
//
// As in the reference: scores are q . k * D**-0.5 in float32; a hole (-1)
// reads page 0 (and an entry past the pool its last page, as the
// reference's gather clamps); positions >= length score -1e30, never
// -inf; positions past maxp * page do not exist; at the end
// l = max(l, 1e-30), o = acc / l and lse = m + log(l), so a length-0 row
// gives o = 0 and lse = -1e30 (the reference's plain gather gives the
// mean of v there, with the same lse).
//
// Bound: bytes.  K and V are read once (4 * D bytes per position and KV
// head in bfloat16, 8 * D in float32) for 4 * G * D flops, G = Hq / Hkv
// <= 32: at most 64 flops a byte in bfloat16 (the tensor cores' ridge is
// ~295) and 16 in float32 (the CUDA cores' is 20).  So the design is about
// keeping enough bytes in flight on every SM.
//
// Design.  The Pallas grid (B, maxp) walked a sequence's pages in order on
// one core with (m, l, acc) in VMEM.  Here:
//
// 1. Split-KV.  decode_split_*_kernel runs B * Hkv * head tiles * S blocks.
//    Split s owns positions [s * chunk, (s + 1) * chunk) of its sequence in
//    logical order (chunk a multiple of 64, so a range may start mid-page)
//    and reads each position's page from the table entries it preloads
//    into shared memory.  The host picks S from B, Hkv, the table's width
//    and the card's SM count (never from the lengths, which stay on the
//    card); a split whose range starts at or past the length processes
//    nothing and writes m = -1e30, l = 0, acc = 0 (processing a fully
//    masked tile would give exp(-1e30 - -1e30) = 1 a position).  With S > 1
//    each split writes its raw (m, l, acc) to float32 partials and
//    decode_merge_kernel, one block per (b, query head), merges them:
//    m = max m_s, l = sum l_s e^(m_s - m), acc = sum acc_s e^(m_s - m),
//    then the reference's emit.  With S = 1 the split kernel emits o and
//    lse itself.  No atomics: the result does not depend on block order.
// 2. Each of a block's 4 warps owns every 4th step of the split's
//    positions (16 positions a step on the tensor cores, 8 on the CUDA
//    cores) and streams them through its own 3-stage ring of 16-byte
//    cp.async copies in the pages' own type, zero-filled past the range.
//    A warp keeps its own (m, l, acc) for the block's query heads, so the
//    walk has no block barrier; the warps' triples merge once, at the end
//    of the split, through shared memory.
// 3. Products.
//    * bfloat16 pages (mma_bf16, mma_bf16x2): mma.sync m16n8k16 with
//      float32 accumulators.  A head tile is 16 query heads (zero rows past
//      the group; G > 16 takes two head tiles, which read the same pages
//      from L2), the A operand of S = Q K^T, from shared memory by
//      ldmatrix; K by ldmatrix and V by ldmatrix.trans are the B operands,
//      as in flash_attention.cu.  Scores are scaled in float32 after the
//      exact bf16 products.  A float32 operand is split into two bf16
//      halves, hi = bf16(x), lo = bf16(x - hi), two products keeping ~16
//      significant bits: q when q is float32 (mma_bf16x2) and P when o is
//      float32 (the same variant).  With a bf16 q and o (mma_bf16), P is
//      rounded to bf16 once, as flash does.  The S tile's C fragment is
//      P's A fragment: P.V never goes through shared memory.  Head-dim
//      tiles of 64, 128 and 256 (rows zero-filled past D).
//    * float32 pages (simt_f32): the CUDA cores.  Lane (t, quarter) of a
//      warp step holds position t's partial dots for all heads of its head
//      tile (1, 4, 8 or 16 heads) over a quarter of the head dim, reading
//      one K float4 for several heads' q; P goes through a small per-warp
//      buffer, and lane j owns output columns 4j (and 4j + 128).
//
// decode_attention_plan reports what a launch runs (variant, S, the
// chunk, each kernel's blocks and dynamic shared memory); the wrapper
// (kernels/jet_decode_attention.py) sizes the partials by it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;               // cp.async ring depth of a warp
constexpr int kTile = 64;                // a split's range is whole tiles
constexpr int kMmaRows = 16;             // mma: positions a step, heads a tile
constexpr int kSimtRows = 8;             // simt: positions a step
constexpr int kMaxSplits = 256;
constexpr int kMergeThreads = 64;        // a float4 column each at D = 256
constexpr int kBlocksPerSm = 4;          // what the split count aims at
constexpr long long kSmemLimit = 232448; // opt-in shared memory per block

enum Variant { kSimtF32 = 0, kMmaBf16 = 1, kMmaBf16x2 = 2 };

__host__ __device__ inline int mma_dtile(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}
// a shared bf16 row: the head-dim tile plus 16 bytes, an odd number of
// 16-byte units, so ldmatrix reads its 8 rows from 8 distinct bank groups
__host__ __device__ inline int mma_row_bytes(int d) {
  return 2 * mma_dtile(d) + 16;
}
// a shared float32 row in floats: D, or D + 4 where D / 4 is even, an odd
// number of 16-byte units, so 8 rows' float4 at one column hit distinct
// banks
__host__ __device__ inline int simt_stride(int d) {
  return (d / 4) % 2 ? d : d + 4;
}
inline int simt_heads(int g) {
  return g == 1 ? 1 : g <= 4 ? 4 : g <= 8 ? 8 : 16;
}

// Byte offsets of a split block's dynamic shared memory: each warp's ring
// (reused at the end for the warps' accumulators), the head tile's q, each
// warp's (m, l) a head, simt's per-warp P, then the table entries.
struct Layout {
  int q, ml, pb, tab;
  __host__ __device__ Layout(int variant, int d, int rows) {
    int ring, qb, pbb;
    if (variant == kSimtF32) {
      const int rs = 4 * simt_stride(d);
      ring = kWarps * kStages * 2 * kSimtRows * rs;
      qb = rows * rs;
      pbb = kWarps * kSimtRows * rows * 4;
    } else {
      const int rb = mma_row_bytes(d);
      ring = kWarps * kStages * 2 * kMmaRows * rb;
      qb = (variant == kMmaBf16x2 ? 2 : 1) * kMmaRows * rb;
      pbb = 0;
    }
    q = ring;
    ml = q + qb;
    pb = ml + ((kWarps * rows * 8 + 15) / 16) * 16;
    tab = pb + pbb;
  }
};

struct Plan {
  int variant = 0, rows = 0, htiles = 0, splits = 0, chunk = 0, kernels = 0;
  long long smem[2] = {0, 0}, blocks[2] = {0, 0};
};

bool make_plan(int q_dtype, int kv_dtype, int bsz, int hq, int hkv, int d,
               int page, int maxp, int forced, int sms, Plan& p) {
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1))
    return false;
  const int vec = kv_dtype == 0 ? 4 : 8;
  if (bsz < 1 || d < 1 || d > 256 || d % vec != 0 || hkv < 1 ||
      hq % hkv != 0 || hq / hkv > 32 || page < 1 || maxp < 1 || sms < 1 ||
      forced < 0 || forced > kMaxSplits ||
      (long long)maxp * page > (1LL << 30))
    return false;
  const int g = hq / hkv;
  p.variant = kv_dtype == 0 ? kSimtF32 : q_dtype == 1 ? kMmaBf16 : kMmaBf16x2;
  p.rows = p.variant == kSimtF32 ? simt_heads(g) : kMmaRows;
  p.htiles = (g + p.rows - 1) / p.rows;
  const long long tiles = ((long long)maxp * page + kTile - 1) / kTile;
  const long long base = Layout(p.variant, d, p.rows).tab;
  // a range of c tiles starting anywhere spans <= c * kTile / page + 2
  // table entries
  auto smem_of = [&](long long c) {
    return base + ((4 * (c * kTile / page + 2) + 15) / 16) * 16;
  };
  long long ct;
  if (forced > 0) {
    p.splits = forced;
    ct = (tiles + forced - 1) / forced;
    if (smem_of(ct) > kSmemLimit) return false;
  } else {
    const long long per = (long long)bsz * hkv * p.htiles;
    long long s = (kBlocksPerSm * (long long)sms + per - 1) / per;
    s = std::min(std::max(s, 1LL), tiles);
    ct = (tiles + s - 1) / s;
    // the widest range whose table entries still fit
    const long long room = (kSmemLimit - base - 16) / 4 - 2;
    ct = std::max(1LL, std::min(ct, room * page / kTile));
    p.splits = (int)((tiles + ct - 1) / ct);
    if (p.splits > kMaxSplits) return false;
  }
  p.chunk = (int)(ct * kTile);
  p.smem[0] = smem_of(ct);
  p.blocks[0] = (long long)bsz * hkv * p.htiles * p.splits;
  p.kernels = p.splits > 1 ? 2 : 1;
  if (p.kernels == 2) {
    p.smem[1] = 4LL * p.splits;
    p.blocks[1] = (long long)bsz * hq;
  }
  return true;
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* table;
  const int* lengths;
  void* out;
  float* lse;
  float* part;     // acc [S, B, Hq, D], then (m, l) [S, B, Hq, 2]
  int bsz, hq, hkv, d, n_pool, page, maxp, splits, chunk, htiles;
  float scale;
};

// What one split block owns: sequence b, KV head kvh, head tile ht (query
// heads h0 .. h0 + nh - 1), split s, positions [p0, pend) (none when
// pend <= p0), and the table entries [e0, e0 + ne) they read.
struct Split {
  int b, kvh, ht, s, h0, nh, p0, pend, e0, ne;
};

__device__ __forceinline__ Split split_of(const Args& a, int rows) {
  Split sp;
  int idx = blockIdx.x;
  sp.ht = idx % a.htiles;        // head tiles of one split run side by side
  idx /= a.htiles;
  sp.s = idx % a.splits;
  idx /= a.splits;
  sp.kvh = idx % a.hkv;
  sp.b = idx / a.hkv;
  const int g = a.hq / a.hkv;
  sp.h0 = sp.kvh * g + sp.ht * rows;
  sp.nh = min(rows, g - sp.ht * rows);
  // positions past maxp pages do not exist, as in the reference
  const int len = max(0, min(__ldg(a.lengths + sp.b), a.maxp * a.page));
  sp.p0 = sp.s * a.chunk;
  sp.pend = min(sp.p0 + a.chunk, len);
  sp.e0 = sp.p0 / a.page;
  sp.ne = sp.pend > sp.p0 ? (sp.pend - 1) / a.page - sp.e0 + 1 : 0;
  return sp;
}

// the split's table entries, a hole read as page 0 and an entry past the
// pool as its last page
__device__ __forceinline__ void load_table(const Args& a, const Split& sp,
                                           int* tab) {
  const int* row = a.table + (size_t)sp.b * a.maxp + sp.e0;
  for (int i = threadIdx.x; i < sp.ne; i += kThreads)
    tab[i] = min(max(__ldg(row + i), 0), a.n_pool - 1);
}

// element offset of position p's row (this KV head) in the pages, or -1
// where p is not this lane's row or lies past the range
__device__ __forceinline__ long long row_offset(const Args& a,
                                                const Split& sp,
                                                const int* tab, int p,
                                                bool mine) {
  if (!mine || p >= sp.pend) return -1;
  const int lp = p / a.page;
  return (((long long)tab[lp - sp.e0] * a.page + (p - lp * a.page)) * a.hkv +
          sp.kvh) * a.d;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Merge the block's warps and write the split's result.  Each warp has
// stored its (m, l) a head in ml [warp][rows][2] and its acc, scaled by
// exp(m_w - m), in ob [warp][rows][obs].  One split: o = acc / max(l,
// 1e-30) in q's type and lse = m + log(max(l, 1e-30)); else the raw
// (m, l, acc) into the partials.
template <typename TQ>
__device__ void store_split(const Args& a, const Split& sp, const float* ob,
                            int obs, const float* ml, int rows) {
  const int c4n = a.d / 4;
  for (int i = threadIdx.x; i < sp.nh * c4n; i += kThreads) {
    const int r = i / c4n, c = i - r * c4n;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml[(w * rows + r) * 2]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* mlw = ml + (w * rows + r) * 2;
      l += mlw[1] * exp2f((mlw[0] - m) * kLog2e);
      const float4 v =
          *reinterpret_cast<const float4*>(ob + (w * rows + r) * obs + 4 * c);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const size_t hrow = (size_t)sp.b * a.hq + sp.h0 + r;
    if (a.splits == 1) {
      const float den = fmaxf(l, 1e-30f);
      store4(static_cast<TQ*>(a.out) + hrow * a.d + 4 * c,
             make_float4(acc.x / den, acc.y / den, acc.z / den,
                         acc.w / den));
      if (c == 0) a.lse[hrow] = m + logf(den);
    } else {
      const size_t row = (size_t)sp.s * a.bsz * a.hq + hrow;
      store4(a.part + row * a.d + 4 * c, acc);
      if (c == 0) {
        float* mlp = a.part + (size_t)a.splits * a.bsz * a.hq * a.d + 2 * row;
        mlp[0] = m;
        mlp[1] = l;
      }
    }
  }
}

// --------------------------------------------------------------------------
// bfloat16 pages: mma.sync m16n8k16
// --------------------------------------------------------------------------
// TQ: q's (and o's) type; float32 q takes the hi/lo split of q and P.
// DT: the head-dim tile (64, 128, 256).
template <typename TQ, int DT>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_mma_kernel(Args a) {
  constexpr bool X2 = std::is_same<TQ, float>::value;
  constexpr int RB = 2 * DT + 16;             // bytes of a shared row
  constexpr int PCH = DT / 8;                 // 16-byte chunks of a row
  constexpr int STEP = 2 * kMmaRows * RB;     // a step: K rows, then V rows
  constexpr int OBS = DT + 4;                 // accumulator row, floats
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(X2 ? kMmaBf16x2 : kMmaBf16, a.d, kMmaRows);
  unsigned char* qs = smem + lay.q;           // [hi; lo] [16][RB]
  float* ml = reinterpret_cast<float*>(smem + lay.ml);
  int* tab = reinterpret_cast<int*>(smem + lay.tab);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Split sp = split_of(a, kMmaRows);
  load_table(a, sp, tab);

  // the head tile's q as bf16 halves, zero past D and past the group
  const TQ* qg = static_cast<const TQ*>(a.q) + ((size_t)sp.b * a.hq + sp.h0) * a.d;
  for (int i = tid; i < kMmaRows * DT; i += kThreads) {
    const int r = i / DT, c = i - r * DT;
    const float x = (r < sp.nh && c < a.d) ? to_f(qg[(size_t)r * a.d + c]) : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    reinterpret_cast<__nv_bfloat16*>(qs + r * RB)[c] = hi;
    if constexpr (X2)
      reinterpret_cast<__nv_bfloat16*>(qs + (kMmaRows + r) * RB)[c] =
          __float2bfloat16_rn(x - __bfloat162float(hi));
  }
  __syncthreads();

  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.kp);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.vp);
  const int nchunk = a.d / 8;                 // chunks holding D's values
  unsigned char* ring = smem + warp * kStages * STEP;
  const int n_steps =
      sp.pend > sp.p0 ? (sp.pend - sp.p0 + kMmaRows - 1) / kMmaRows : 0;
  const int mine = n_steps > warp ? (n_steps - warp + kWarps - 1) / kWarps : 0;

  // this warp's step i: rows of positions p0 + (warp + 4i) * 16 + r; lane r
  // finds row r's page, every lane copies 16-byte chunks of K and V
  auto load_step = [&](int i) {
    const int pbase = sp.p0 + (warp + kWarps * i) * kMmaRows;
    const long long off = row_offset(a, sp, tab, pbase + lane, lane < kMmaRows);
    unsigned char* dst = ring + (i % kStages) * STEP;
#pragma unroll
    for (int j = 0; j < kMmaRows * PCH / 32; ++j) {
      const int idx = lane + 32 * j;
      const int r = idx / PCH, c = idx - r * PCH;
      const long long ro = __shfl_sync(0xffffffffu, off, r);
      const bool in = ro >= 0 && c < nchunk;
      const size_t at = in ? (size_t)ro + 8 * c : 0;
      cp_async16(smem_u32(dst + r * RB + c * 16), kp + at, in);
      cp_async16(smem_u32(dst + (kMmaRows + r) * RB + c * 16), vp + at, in);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) load_step(i);
    cp_async_commit();
  }

  // ldmatrix addresses of this lane: A (16 rows x 32 bytes: row halves by
  // lane bit 3, byte halves by bit 4), B from K (positions 0-7 / 8-15 by
  // bit 4, byte halves by bit 3), B from V transposed (positions by bit 3,
  // 16-byte column halves by bit 4)
  const uint32_t q_addr = smem_u32(qs) +
      ((lane & 7) + ((lane >> 3) & 1) * 8) * RB + (lane >> 4) * 16;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * RB + ((lane >> 3) & 1) * 16;
  const int v_off = kMmaRows * RB +
      ((lane & 7) + ((lane >> 3) & 1) * 8) * RB + (lane >> 4) * 16;

  float o[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                   // step i landed; step i - 1 is read
    if (i + kStages - 1 < mine) load_step(i + kStages - 1);
    cp_async_commit();
    const uint32_t st = smem_u32(ring + (i % kStages) * STEP);

    // S = Q K^T: heads x 16 positions, two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(kb, st + k_off + kk * 32);
      ldsm_x4(qa, q_addr + kk * 32);
      mma_bf16(s[0], qa, kb[0], kb[1]);
      mma_bf16(s[1], qa, kb[2], kb[3]);
      if constexpr (X2) {
        ldsm_x4(qa, q_addr + kMmaRows * RB + kk * 32);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }
    }

    // scale after the products, mask past the range, online softmax
    const int pbase = sp.p0 + (warp + kWarps * i) * kMmaRows;
    const int room = sp.pend - pbase;         // positions of this step in range
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = 8 * n + 2 * tq + (e & 1) < room ? s[n][e] * a.scale
                                                  : kNegInf;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
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
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
        s[n][e] = p;
        l[e >> 1] += p;      // this lane's part; the quad sums at the end
      }
#pragma unroll
    for (int dt = 0; dt < DT / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the two C tiles are P's k16 A fragment
    uint32_t ph[4], pl[4];
    if constexpr (X2) {
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
    } else {
      ph[0] = pack_bf16(s[0][0], s[0][1]);
      ph[1] = pack_bf16(s[0][2], s[0][3]);
      ph[2] = pack_bf16(s[1][0], s[1][1]);
      ph[3] = pack_bf16(s[1][2], s[1][3]);
    }
#pragma unroll
    for (int d2 = 0; d2 < DT / 16; ++d2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, st + v_off + d2 * 32);
      mma_bf16(o[2 * d2], ph, vb[0], vb[1]);
      mma_bf16(o[2 * d2 + 1], ph, vb[2], vb[3]);
      if constexpr (X2) {
        mma_bf16(o[2 * d2], pl, vb[0], vb[1]);
        mma_bf16(o[2 * d2 + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // merge the warps: (m, l) first, then acc scaled to the block's m, over
  // the drained rings
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  cp_async_wait<0>();
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml[(warp * kMmaRows + g + 8 * r) * 2] = m[r];
      ml[(warp * kMmaRows + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  float* ob = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mb = fmaxf(mb, ml[(w * kMmaRows + row) * 2]);
    const float f = exp2f((m[r] - mb) * kLog2e);
    float* orow = ob + (warp * kMmaRows + row) * OBS + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT / 8; ++dt)
      *reinterpret_cast<float2*>(orow + 8 * dt) =
          make_float2(o[dt][2 * r] * f, o[dt][2 * r + 1] * f);
  }
  __syncthreads();
  store_split<TQ>(a, sp, ob, OBS, ml, kMmaRows);
}

// --------------------------------------------------------------------------
// float32 pages: the CUDA cores
// --------------------------------------------------------------------------
// TQ: q's (and o's) type.  HT: query heads a block (zero q rows past the
// group).  DCH: 128-column chunks of the head dim a lane owns in P.V.
template <typename TQ, int HT, int DCH>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_simt_kernel(Args a) {
  constexpr int STEP = 2 * kSimtRows;          // rows a step: K, then V
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(kSimtF32, a.d, HT);
  const int ks = simt_stride(a.d);
  float* qs = reinterpret_cast<float*>(smem + lay.q);    // [HT][ks], scaled
  float* ml = reinterpret_cast<float*>(smem + lay.ml);
  int* tab = reinterpret_cast<int*>(smem + lay.tab);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Split sp = split_of(a, HT);
  load_table(a, sp, tab);

  // q * D**-0.5 in float32, as the reference
  const TQ* qg = static_cast<const TQ*>(a.q) + ((size_t)sp.b * a.hq + sp.h0) * a.d;
  for (int i = tid; i < HT * a.d; i += kThreads) {
    const int r = i / a.d, c = i - r * a.d;
    qs[r * ks + c] = r < sp.nh ? to_f(qg[(size_t)r * a.d + c]) * a.scale : 0.f;
  }
  __syncthreads();

  const float* kp = static_cast<const float*>(a.kp);
  const float* vp = static_cast<const float*>(a.vp);
  const int cpr = a.d / 4;                     // 16-byte chunks of a row
  float* ring = reinterpret_cast<float*>(smem) + warp * kStages * STEP * ks;
  float* pb = reinterpret_cast<float*>(smem + lay.pb) + warp * kSimtRows * HT;
  const int n_steps =
      sp.pend > sp.p0 ? (sp.pend - sp.p0 + kSimtRows - 1) / kSimtRows : 0;
  const int mine = n_steps > warp ? (n_steps - warp + kWarps - 1) / kWarps : 0;

  auto load_step = [&](int i) {
    const int pbase = sp.p0 + (warp + kWarps * i) * kSimtRows;
    const long long off = row_offset(a, sp, tab, pbase + lane, lane < kSimtRows);
    float* dst = ring + (i % kStages) * STEP * ks;
    for (int j0 = 0; j0 < kSimtRows * cpr; j0 += 32) {
      const int idx = j0 + lane;
      const int r = min(idx / cpr, kSimtRows - 1), c = idx - (idx / cpr) * cpr;
      const long long ro = __shfl_sync(0xffffffffu, off, r);
      if (idx < kSimtRows * cpr) {
        const bool in = ro >= 0;
        const size_t at = in ? (size_t)ro + 4 * c : 0;
        cp_async16(smem_u32(dst + r * ks + 4 * c), kp + at, in);
        cp_async16(smem_u32(dst + (kSimtRows + r) * ks + 4 * c), vp + at, in);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) load_step(i);
    cp_async_commit();
  }

  const int t = lane & 7, qt = lane >> 3;    // scores: position, quarter
  float acc[HT][4 * DCH];
#pragma unroll
  for (int h = 0; h < HT; ++h)
#pragma unroll
    for (int e = 0; e < 4 * DCH; ++e) acc[h][e] = 0.f;
  float m[HT], l[HT];
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                   // step i landed; step i - 1 is read
    if (i + kStages - 1 < mine) load_step(i + kStages - 1);
    cp_async_commit();
    const float* kt = ring + (i % kStages) * STEP * ks;
    const float* vt = kt + kSimtRows * ks;

    // scores: position t's dot with every head over chunks qt, qt + 4, ..
    float sc[HT];
#pragma unroll
    for (int h = 0; h < HT; ++h) sc[h] = 0.f;
    for (int c = qt; c < cpr; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kt + t * ks + 4 * c);
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + h * ks + 4 * c);
        sc[h] = fmaf(qv.x, kv.x, sc[h]);
        sc[h] = fmaf(qv.y, kv.y, sc[h]);
        sc[h] = fmaf(qv.z, kv.z, sc[h]);
        sc[h] = fmaf(qv.w, kv.w, sc[h]);
      }
    }
    const bool valid = sp.p0 + (warp + kWarps * i) * kSimtRows + t < sp.pend;
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      float s = sc[h] + __shfl_xor_sync(0xffffffffu, sc[h], 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      s = valid ? s : kNegInf;
      float mx = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[h], mx);
      const float corr = exp2f((m[h] - mn) * kLog2e);
      const float p = exp2f((s - mn) * kLog2e);
      float sum = p + __shfl_xor_sync(0xffffffffu, p, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[h] = l[h] * corr + sum;
      m[h] = mn;
#pragma unroll
      for (int e = 0; e < 4 * DCH; ++e) acc[h][e] *= corr;
      if (qt == 0) pb[t * HT + h] = p;
    }
    __syncwarp();

    // acc += P V: lane owns columns 4 * (lane + 32 j)
#pragma unroll 2
    for (int tt = 0; tt < kSimtRows; ++tt) {
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        const int col = 4 * (lane + 32 * j);
        const float4 vv = col < a.d
            ? *reinterpret_cast<const float4*>(vt + tt * ks + col)
            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int h = 0; h < HT; ++h) {
          const float p = pb[tt * HT + h];
          acc[h][4 * j] = fmaf(p, vv.x, acc[h][4 * j]);
          acc[h][4 * j + 1] = fmaf(p, vv.y, acc[h][4 * j + 1]);
          acc[h][4 * j + 2] = fmaf(p, vv.z, acc[h][4 * j + 2]);
          acc[h][4 * j + 3] = fmaf(p, vv.w, acc[h][4 * j + 3]);
        }
      }
    }
  }

  // merge the warps (every lane holds the warp's m and l)
  cp_async_wait<0>();
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      ml[(warp * HT + h) * 2] = m[h];
      ml[(warp * HT + h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  float* ob = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, ml[(w * HT + h) * 2]);
    const float f = exp2f((m[h] - mb) * kLog2e);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      const int col = 4 * (lane + 32 * j);
      if (col < a.d)
        store4(ob + (warp * HT + h) * a.d + col,
               make_float4(acc[h][4 * j] * f, acc[h][4 * j + 1] * f,
                           acc[h][4 * j + 2] * f, acc[h][4 * j + 3] * f));
    }
  }
  __syncthreads();
  store_split<TQ>(a, sp, ob, a.d, ml, HT);
}

// --------------------------------------------------------------------------
// the merge of S > 1 splits: one block per (b, query head)
// --------------------------------------------------------------------------
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  __syncthreads();                  // red is free from an earlier use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kMergeThreads / 32; ++i)
    v = kMax ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// (kMergeThreads, 1): ptxas's default budget for 64 threads spilled
template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads, 1)
decode_merge_kernel(Args a) {
  extern __shared__ float wts[];    // [S]: exp(m_s - m)
  __shared__ float red[kMergeThreads / 32];
  const size_t bh = blockIdx.x, rows = (size_t)a.bsz * a.hq;
  const float* ml = a.part + (size_t)a.splits * rows * a.d + 2 * bh;
  float mx = kNegInf;
  for (int s = threadIdx.x; s < a.splits; s += kMergeThreads)
    mx = fmaxf(mx, ml[2 * s * rows]);
  const float m = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < a.splits; s += kMergeThreads) {
    const float f = exp2f((ml[2 * s * rows] - m) * kLog2e);
    wts[s] = f;
    sum += ml[2 * s * rows + 1] * f;
  }
  const float l = block_reduce<false>(sum, red);   // also publishes wts
  const float den = fmaxf(l, 1e-30f);
  for (int c = threadIdx.x; c < a.d / 4; c += kMergeThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.splits; ++s) {
      const float f = wts[s];
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          a.part + (s * rows + bh) * a.d) + c);
      acc.x = fmaf(f, v.x, acc.x);
      acc.y = fmaf(f, v.y, acc.y);
      acc.z = fmaf(f, v.z, acc.z);
      acc.w = fmaf(f, v.w, acc.w);
    }
    store4(static_cast<TQ*>(a.out) + bh * a.d + 4 * c,
           make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den));
  }
  if (threadIdx.x == 0) a.lse[bh] = m + logf(den);
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------
// The dynamic shared memory a kernel may use is raised once per device to
// the largest request so far, not on every launch.
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

template <typename K>
int launch(K* kernel, SmemAttr& attr, const Plan& p, const Args& a,
           cudaStream_t st) {
  cudaError_t err = attr.allow(kernel, p.smem[0]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.blocks[0], kThreads, (size_t)p.smem[0], st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, int DT>
int launch_mma(const Plan& p, const Args& a, cudaStream_t st) {
  static SmemAttr attr;
  return launch(decode_split_mma_kernel<TQ, DT>, attr, p, a, st);
}

template <typename TQ, int HT, int DCH>
int launch_simt(const Plan& p, const Args& a, cudaStream_t st) {
  static SmemAttr attr;
  return launch(decode_split_simt_kernel<TQ, HT, DCH>, attr, p, a, st);
}

template <typename TQ, int DCH>
int simt_by_heads(const Plan& p, const Args& a, cudaStream_t st) {
  switch (p.rows) {
    case 1: return launch_simt<TQ, 1, DCH>(p, a, st);
    case 4: return launch_simt<TQ, 4, DCH>(p, a, st);
    case 8: return launch_simt<TQ, 8, DCH>(p, a, st);
    default: return launch_simt<TQ, 16, DCH>(p, a, st);
  }
}

template <typename TQ>
int run(const Plan& p, const Args& a, cudaStream_t st) {
  int err;
  if (p.variant == kSimtF32) {
    err = a.d > 128 ? simt_by_heads<TQ, 2>(p, a, st)
                    : simt_by_heads<TQ, 1>(p, a, st);
  } else {
    const int dt = mma_dtile(a.d);
    err = dt == 64    ? launch_mma<TQ, 64>(p, a, st)
          : dt == 128 ? launch_mma<TQ, 128>(p, a, st)
                      : launch_mma<TQ, 256>(p, a, st);
  }
  if (err != 0 || p.kernels == 1) return err;
  decode_merge_kernel<TQ><<<(unsigned)p.blocks[1], kMergeThreads,
                            (size_t)p.smem[1], st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan at these sizes: out[0] variant (0 simt_f32, 1 mma_bf16,
// 2 mma_bf16x2), out[1] splits S, out[2] positions a split, out[3] head
// tiles, out[4] / out[5] the split kernel's dynamic shared memory and
// blocks, out[6] / out[7] the merge kernel's (0 when S = 1).  splits = 0
// lets the plan choose S for a card of sm_count SMs.  q_dtype / kv_dtype:
// 0 = float32, 1 = bfloat16.  Returns the kernels a launch runs (1 or 2),
// or -1 for sizes the kernel does not take.
extern "C" int decode_attention_plan(int q_dtype, int kv_dtype, int bsz,
                                     int hq, int hkv, int d, int page,
                                     int maxp, int splits, int sm_count,
                                     long long* out) {
  Plan p;
  if (!make_plan(q_dtype, kv_dtype, bsz, hq, hkv, d, page, maxp, splits,
                 sm_count, p))
    return -1;
  const long long v[8] = {p.variant, p.splits, p.chunk, p.htiles,
                          p.smem[0], p.blocks[0], p.smem[1], p.blocks[1]};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return p.kernels;
}

// Enqueues the split kernel and, when the plan has S > 1, the merge on the
// stream.  part: float32 scratch of S * B * Hq * (D + 2) values (unused
// when S = 1).  Needs D <= 256 whose rows are whole 16-byte vectors of the
// pages' type and Hq / Hkv <= 32.  Returns the CUDA error of the launches
// (0 on success).
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* kp, const void* vp, const int* table,
    const int* lengths, void* out, float* lse, float* part, int bsz, int hq,
    int hkv, int d, int n_pool, int page, int maxp, float scale,
    int q_dtype, int kv_dtype, int splits, int sm_count, void* stream) {
  Plan p;
  if (n_pool < 1 || !make_plan(q_dtype, kv_dtype, bsz, hq, hkv, d, page,
                               maxp, splits, sm_count, p) ||
      (p.kernels == 2 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, kp, vp, table, lengths, out, lse, part, bsz, hq, hkv, d,
               n_pool, page, maxp, p.splits, p.chunk, p.htiles, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0) return run<float>(p, a, st);
  return run<__nv_bfloat16>(p, a, st);
}
