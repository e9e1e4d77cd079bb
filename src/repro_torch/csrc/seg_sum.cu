// Deterministic batched segment sum of the sparse fabric tick, written
// by hand for Hopper.
//
// Replaces src/repro/fabric/vector.py:1768, `_make_step_sparse.seg_sum`:
// in the reference an XLA scatter-add (and np.add.at in its numpy
// backend), not a Pallas kernel.  On the card PyTorch's `index_add_` /
// `scatter_add_` on floats are atomic, so their summation order, and
// with it the last bits, change from run to run.  The sparse engine needs
// the same bits every run: a captured tick must equal its eager twin
// element for element, and two runs of one grid must agree.
//
// Computes, for every row g and bin b,
//   out[g, b] = sum of vals[g, perm[j]] for j in offsets[b] .. offsets[b+1]
// in ascending j, starting from 0.0f, with round-to-nearest adds.  perm is
// a *stable* sort of the entries by bin (the host plan, `fused.seg_plan`),
// so each bin adds its entries in entry order: the order of np.add.at and
// of PyTorch's CPU `index_add_`, hence bit-equal to the plain version run
// on the CPU in float32.  No tree reduction: it would change the bits.
//
// Layout: vals [rows, n] and out [rows, size] row-major, perm [n] and
// offsets [size + 1] int32, shared by every row; long_bins [n_long] int32,
// the bins of at least kLongMin entries, ascending (the plan's, whose
// `fused.SEG_LONG_MIN` is the same number).
//
// Two kernels:
//
// * `seg_sum_kernel` (`warp_fold`, the one `seg_sum_f32` launches).  The
//   add order is part of the function, so a bin's adds are a serial chain
//   of 4-cycle FADDs: that chain is the floor.  What the design keeps off
//   it is every load.
//   - Long bins (the plan's `long_bins`: an incast receiver's (TC, port)
//     bin holds up to the whole row) go to one warp each.  A step of 128
//     entries: each lane loads four indices (coalesced, issued a step
//     ahead) and gathers their values into the warp's 512-byte scratch;
//     then every lane folds the scratch in entry order, four values a
//     broadcast load.  Only the adds are on the chain.  A block would add
//     nothing: one agent must fold.
//   - Short bins stay at one thread each, as a pipeline over a thread's
//     bins: the offsets two bins ahead and the first four indices one bin
//     ahead are in flight while it folds a bin, four values, four adds.
//   - A step's entries past the bin's end are padded with -0.0f, and
//     x + (-0.0f) == x bit for bit for every x under round-to-nearest
//     (+0 + -0 = +0): the unrolled folds carry no guard an entry.
//   - Staging.  A block a row (up to 1,024 threads: a warp a long bin, a
//     thread a short one) copies its row and `perm` into shared memory by
//     4-byte `cp.async`, all in flight at once, while each thread loads
//     its first bins' offsets into registers.  With more rows than SMs, one persistent block an SM walks
//     its rows, each arriving by a 1-D bulk asynchronous copy
//     (`cp.async.bulk`, TMA, completion on an mbarrier: the row's 16-byte
//     aligned middle, threads copying its ragged ends), double-buffered
//     where two rows fit (2 x 96 KB at the [4096, 24576] check): the copy
//     of row r + grid is in flight while row r is summed.  `perm` is
//     staged where it fits beside the rows, else read from device memory
//     (L2); rows past shared memory (58,104 floats) too.
//   Bound: at the tick's shapes ([4, 1158] into 693 bins, 192 entries in
//   the longest bin at 256 hosts, 768 at 1,024) the launch and the
//   longest bin's chain (longest x 4 cycles); at [4096, 24576] device
//   memory bytes (the row once, the output once).
// * `seg_sum_bin_thread_kernel` (`bin_thread`, the first design, kept for
//   timing it beside the new one: `seg_sum_bin_thread_f32`).  One block a
//   row, the row staged by threads, one thread a bin walking its segment
//   through dependent loads (perm[j], then the staged value, then the
//   add: ~60 cycles an entry).
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // bin_thread
constexpr int kFoldThreads = 1024;       // warp_fold
constexpr long long kMaxSmem = 232448;   // H100: 227 KB a block, opt-in
constexpr int kBarBytes = 16;            // two mbarriers, one a buffer
constexpr int kLongMin = 32;             // entries of a bin a warp folds
constexpr int kDevices = 16;

// ------------------------------------------------------------------------
// bin_thread: the first design
// ------------------------------------------------------------------------
template <bool kStaged>
__global__ void seg_sum_bin_thread_kernel(const float* __restrict__ vals,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ offsets,
                                          float* __restrict__ out, int n,
                                          int size) {
  extern __shared__ float row_s[];
  const long long row = blockIdx.x;
  const float* v = vals + row * (long long)n;
  const float* src = v;
  if (kStaged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) row_s[i] = v[i];
    __syncthreads();
    src = row_s;
  }
  float* o = out + row * size;
  for (int b = threadIdx.x; b < size; b += blockDim.x) {
    const int lo = offsets[b];
    const int hi = offsets[b + 1];
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) acc = __fadd_rn(acc, src[perm[j]]);
    o[b] = acc;
  }
}

// ------------------------------------------------------------------------
// warp_fold
// ------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Floats from the last 16-byte boundary at or below `v`: a staged row
// keeps element i at buf[shift + i], so that its aligned middle lands on
// a 16-byte boundary of the buffer.
__device__ __forceinline__ int row_shift(const float* v) {
  return (int)((reinterpret_cast<uintptr_t>(v) >> 2) & 3);
}

// Starts the copy of row `v` (n floats) into `buf`: where `tma`, the
// aligned middle by one bulk copy that thread 0 issues on `bar` and the
// ragged ends by the threads' own loads (the caller waits on `bar` and
// syncs); else all of it by 4-byte cp.async (the caller waits for the
// group and syncs).
__device__ __forceinline__ void stage_row(const float* v, float* buf, int n,
                                          int tma, uint32_t bar) {
  float* dst = buf + row_shift(v);
  if (tma) {
    const int h = (4 - row_shift(v)) & 3;               // ragged head
    const int e = (int)(((reinterpret_cast<uintptr_t>(v + n) & ~uintptr_t(15))
                         - reinterpret_cast<uintptr_t>(v)) >> 2);  // tail
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)(e - h) * 4u;
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(dst + h), v + h, bytes, bar);
    }
    for (int i = threadIdx.x; i < h; i += blockDim.x) dst[i] = v[i];
    for (int i = e + threadIdx.x; i < n; i += blockDim.x) dst[i] = v[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(smem_u32(dst + i), v + i);
    cp_async_commit();
  }
}

// Folds 32 * chunks values of `s` (a warp's scratch, every lane reading
// the same address: a broadcast) into acc in order, four a load.
template <int kChunks>
__device__ __forceinline__ float fold_scratch(float acc, const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int q = 0; q < 8 * kChunks; ++q) {
    const float4 x = s4[q];
    acc = __fadd_rn(acc, x.x);
    acc = __fadd_rn(acc, x.y);
    acc = __fadd_rn(acc, x.z);
    acc = __fadd_rn(acc, x.w);
  }
  return acc;
}

// One warp folds a long bin [lo, hi) in entry order; every lane returns
// the sum.  128 entries a step: each lane loads four indices (the next
// step's are in flight during this step's fold) and gathers their values
// into the warp's scratch (128 floats), which every lane then folds.
__device__ __forceinline__ float fold_long(const float* src, const int* pm,
                                           int lo, int hi, int lane,
                                           float* scratch) {
  float acc = 0.0f;
  int p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lo + 32 * k + lane;
    p[k] = j < hi ? pm[j] : -1;
  }
  for (int g = lo; g < hi; g += 128) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      scratch[32 * k + lane] = p[k] >= 0 ? src[p[k]] : -0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = g + 128 + 32 * k + lane;
      p[k] = j < hi ? pm[j] : -1;
    }
    __syncwarp();
    const int left = hi - g;                  // the same in all lanes
    if (left >= 128) {
      acc = fold_scratch<4>(acc, scratch);
    } else {
      acc = fold_scratch<1>(acc, scratch);
      if (left > 32) acc = fold_scratch<1>(acc, scratch + 32);
      if (left > 64) acc = fold_scratch<1>(acc, scratch + 64);
      if (left > 96) acc = fold_scratch<1>(acc, scratch + 96);
    }
    __syncwarp();
  }
  return acc;
}

// One thread folds a short bin [lo, hi) whose first four indices `p` it
// loaded a bin ahead: four values, four adds, then four indices, four
// values, four adds for the rest.
__device__ __forceinline__ float fold_short(const float* src, const int* pm,
                                            int lo, int hi, const int* p) {
  float acc = 0.0f;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = p[k] >= 0 ? src[p[k]] : -0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, v[k]);
  for (int j = lo + 4; j < hi; j += 4) {
    int q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = j + k < hi ? pm[j + k] : -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = q[k] >= 0 ? src[q[k]] : -0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, v[k]);
  }
  return acc;
}

// Every bin of one row: the long bins a warp each (warps 0, 1, .. in
// turn), then the short bins a thread each, on the warps that hold no
// long bin when there are fewer long bins than warps.  A thread's short
// bins run as a pipeline: the offsets two bins ahead and the first four
// indices one bin ahead are in flight while it folds a bin.  The first
// offsets each thread needs are loaded before it waits for the row (the
// `first` row of a block: its cp.async groups and a block sync; a bulk
// copy: its mbarrier `bar` at `parity`), so that they arrive meanwhile.
__device__ __forceinline__ void sum_row(const float* src, const int* pm,
                                        const int* __restrict__ of,
                                        const int* __restrict__ long_bins,
                                        float* __restrict__ o, int size,
                                        int n_long,
                                        float* scratch, bool first,
                                        bool tma, uint32_t bar,
                                        uint32_t parity) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int busy = n_long < warps ? n_long : 0;
  const int step = blockDim.x - 32 * busy;
  int b = tid - 32 * busy;
  int lo = 0, hi = 0, nlo = 0, nhi = 0, llo = 0, lhi = 0;
  if (warp < n_long) {
    const int bin = long_bins[warp];
    llo = of[bin];
    lhi = of[bin + 1];
  }
  if (warp >= busy && b < size) {
    lo = of[b];
    hi = of[b + 1];
    if (b + step < size) {
      nlo = of[b + step];
      nhi = of[b + step + 1];
    }
  }
  if (first) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (tma) mbar_wait(bar, parity);
  for (int k = warp; k < n_long; k += warps) {
    if (k != warp) {
      const int bin = long_bins[k];
      llo = of[bin];
      lhi = of[bin + 1];
    }
    const float acc = fold_long(src, pm, llo, lhi, lane,
                                scratch + 128 * warp);
    if (lane == 0) o[long_bins[k]] = acc;
  }
  if (warp < busy) return;
  int p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = lo + k < hi ? pm[lo + k] : -1;
  for (; b < size; b += step) {
    int np[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) np[k] = nlo + k < nhi ? pm[nlo + k] : -1;
    int nnlo = 0, nnhi = 0;
    if (b + 2 * step < size) {
      nnlo = of[b + 2 * step];
      nnhi = of[b + 2 * step + 1];
    }
    if (hi - lo < kLongMin) o[b] = fold_short(src, pm, lo, hi, p);
    lo = nlo;
    hi = nhi;
    nlo = nnlo;
    nhi = nnhi;
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = np[k];
  }
}

// Shared memory: two mbarriers, `buffers` row buffers of `row_floats`,
// the long bins' warps' scratch (128 floats a warp that holds one), then
// (kIdx) perm.  kRow: rows staged (else read from device memory); kIdx:
// perm staged (else read from device memory, as the offsets always are:
// a thread loads its own).
template <bool kRow, bool kIdx>
__global__ void __launch_bounds__(kFoldThreads, 1)
seg_sum_kernel(const float* __restrict__ vals, const int* __restrict__ perm,
               const int* __restrict__ offsets,
               const int* __restrict__ long_bins, float* __restrict__ out,
               long long rows, int n, int size, int n_long,
               int buffers, int row_floats, int tma) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + kBarBytes);
  float* scratch = bufs + (size_t)buffers * row_floats;
  const int fold_warps = min(n_long, (int)(blockDim.x >> 5));
  int* perm_s = reinterpret_cast<int*>(scratch + 128 * fold_warps);
  if (kIdx) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(smem_u32(perm_s + i), perm + i);
    cp_async_commit();
  }
  if (tma && threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tma) __syncthreads();
  uint32_t phase = 0;       // bit k: the parity buffer k's barrier waits on
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const int b = buffers == 2 ? (it & 1) : 0;
    const float* v = vals + row * (long long)n;
    const bool first = it == 0 || buffers < 2;
    if (kRow && first)
      stage_row(v, bufs + (size_t)b * row_floats, n, tma,
                smem_u32(&bars[b]));
    if (buffers == 2 && row + gridDim.x < rows)
      stage_row(v + (long long)gridDim.x * n,
                bufs + (size_t)(b ^ 1) * row_floats, n, tma,
                smem_u32(&bars[b ^ 1]));
    const bool wait = kRow && tma;
    const uint32_t bar = smem_u32(&bars[b]), parity = (phase >> b) & 1u;
    if (wait) phase ^= 1u << b;
    // compile-time choices, so that the loads know their memory space
    const float* src =
        kRow ? bufs + (size_t)b * row_floats + row_shift(v) : v;
    const int* pm = kIdx ? perm_s : perm;
    sum_row(src, pm, offsets, long_bins, out + row * (long long)size, size,
            n_long, scratch, first, wait, bar, parity);
    __syncthreads();
  }
}

// The largest dynamic shared memory a kernel was allowed so far, per
// device: cudaFuncSetAttribute costs host time, so a launch above 48 KB
// makes it again only when it asks for more than was allowed (and a
// captured launch, which an eager one at the same sizes precedes, never
// does).
struct SmemAttr {
  std::atomic<long long> allowed[kDevices] = {};
  cudaError_t allow(const void* fn, int dev, long long bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    if (dev < kDevices && allowed[dev].load() >= bytes) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && dev < kDevices) allowed[dev].store(bytes);
    return err;
  }
};

using FoldKernel = void (*)(const float*, const int*, const int*,
                            const int*, float*, long long, int, int, int,
                            int, int, int);
// by 2 * (rows staged) + (indices staged)
const FoldKernel kFold[4] = {seg_sum_kernel<false, false>,
                             seg_sum_kernel<false, true>,
                             seg_sum_kernel<true, false>,
                             seg_sum_kernel<true, true>};
SmemAttr fold_attr[4];
SmemAttr bin_thread_attr;
std::atomic<int> sm_count[kDevices] = {};

cudaError_t current(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  *sms = *dev < kDevices ? sm_count[*dev].load() : 0;
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < kDevices) sm_count[*dev].store(*sms);
  return err;
}

struct Layout {
  long long grid, row_floats, smem;
  int threads, buffers, idx_staged, tma;
};

// The launch of `seg_sum_kernel` at these sizes on a card of `sms` SMs
// (`seg_sum_layout` reports it).  A block a row, of a warp a long bin
// and a thread a short one (128 to 1,024 threads); with more rows than
// SMs, one persistent block of 1,024 an SM, its rows arriving by bulk
// copy, two buffers where two rows fit.
Layout layout(long long rows, int n, int size, int n_long, int sms) {
  Layout L;
  L.row_floats = ((long long)n + 7) / 4 * 4;   // n + a shift of <= 3, 16 B
  const long long row_bytes = L.row_floats * 4;
  const long long idx_bytes = (long long)n * 4;            // perm
  const bool persistent = rows > sms;
  L.grid = persistent ? sms : rows;
  const long long want = 32LL * (n_long + (size + 31LL) / 32);
  L.threads = persistent ? kFoldThreads
              : (int)(want < 128 ? 128 : want > kFoldThreads ? kFoldThreads
                                                             : want);
  const long long scratch =
      512LL * (n_long < L.threads / 32 ? n_long : L.threads / 32);
  const bool tma = persistent && n >= 8;
  L.buffers = kBarBytes + row_bytes + scratch > kMaxSmem ? 0
              : tma && kBarBytes + 2 * row_bytes + scratch <= kMaxSmem ? 2
                                                                       : 1;
  L.tma = tma && L.buffers > 0;
  const long long fixed = kBarBytes + L.buffers * row_bytes + scratch;
  L.idx_staged = fixed + idx_bytes <= kMaxSmem;
  L.smem = fixed + (L.idx_staged ? idx_bytes : 0);
  return L;
}

}  // namespace

// The launch `seg_sum_f32` makes: out = {grid, threads, buffers, indices
// staged, bulk copy, shared memory bytes}; `sms` <= 0 asks the current
// device.
extern "C" int seg_sum_layout(long long rows, int n, int size, int n_long,
                              int sms, long long* out) {
  if (sms <= 0) {
    int dev = 0;
    cudaError_t err = current(&dev, &sms);
    if (err != cudaSuccess) return (int)err;
  }
  const Layout L = layout(rows, n, size, n_long, sms);
  out[0] = L.grid;
  out[1] = L.threads;
  out[2] = L.buffers;
  out[3] = L.idx_staged;
  out[4] = L.tma;
  out[5] = L.smem;
  return 0;
}

extern "C" int seg_sum_f32(const float* vals, const int* perm,
                           const int* offsets, const int* long_bins,
                           float* out, long long rows, int n, int size,
                           int n_long, void* stream) {
  if (rows <= 0 || size <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = current(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const Layout L = layout(rows, n, size, n_long, sms);
  const int which = 2 * (L.buffers > 0) + L.idx_staged;
  err = fold_attr[which].allow(reinterpret_cast<const void*>(kFold[which]),
                               dev, L.smem);
  if (err != cudaSuccess) return (int)err;
  kFold[which]<<<(unsigned int)L.grid, L.threads, (size_t)L.smem,
                 (cudaStream_t)stream>>>(
      vals, perm, offsets, long_bins, out, rows, n, size, n_long,
      L.buffers, (int)L.row_floats, L.tma);
  return (int)cudaGetLastError();
}

extern "C" int seg_sum_bin_thread_f32(const float* vals, const int* perm,
                                      const int* offsets, float* out,
                                      long long rows, int n, int size,
                                      void* stream) {
  if (rows <= 0 || size <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const long long smem = (long long)n * (long long)sizeof(float);
  if (smem <= kMaxSmem) {                 // the row fits: staged
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = bin_thread_attr.allow(
        reinterpret_cast<const void*>(seg_sum_bin_thread_kernel<true>), dev,
        smem);
    if (err != cudaSuccess) return (int)err;
    seg_sum_bin_thread_kernel<true><<<(unsigned int)rows, kThreads,
                                      (size_t)smem, s>>>(
        vals, perm, offsets, out, n, size);
  } else {
    seg_sum_bin_thread_kernel<false><<<(unsigned int)rows, kThreads, 0, s>>>(
        vals, perm, offsets, out, n, size);
  }
  return (int)cudaGetLastError();
}
