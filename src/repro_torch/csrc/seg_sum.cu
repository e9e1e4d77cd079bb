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
// offsets [size + 1] int32, shared by every row.
//
// Design: one block a row.  The row's n values are staged in shared
// memory with coalesced loads (up to 227 KB = 58,112 floats; 1,158 at the
// 256-host pod grid, 24,576 = 96 KB at the large check), then one thread a
// bin walks its segment of perm, reading the staged values.  Rows that do
// not fit read their values from device memory instead.  Writes of
// neighbouring bins by neighbouring threads are coalesced.
//
// Bound: device-memory bytes.  Each value is read once and each output
// written once, with one add per value; at the tick's shapes ([4, 1158]
// into 693 bins) a call is a few blocks and the launch itself dominates,
// so the design keeps one launch for the whole grid and allocates
// nothing.
#include <atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxSmem = 232448;   // H100: 227 KB a block, opt-in

template <bool kStaged>
__global__ void seg_sum_kernel(const float* __restrict__ vals,
                               const int* __restrict__ perm,
                               const int* __restrict__ offsets,
                               float* __restrict__ out, int n, int size) {
  extern __shared__ float row_s[];
  const long long row = blockIdx.x;
  const float* v = vals + row * (long long)n;
  const float* src = v;
  if (kStaged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) row_s[i] = v[i];
    __syncthreads();
    src = row_s;
  }
  float* o = out + row * (long long)size;
  for (int b = threadIdx.x; b < size; b += blockDim.x) {
    const int lo = offsets[b];
    const int hi = offsets[b + 1];
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) acc = __fadd_rn(acc, src[perm[j]]);
    o[b] = acc;
  }
}

// The largest dynamic shared memory the staged kernel was allowed so far,
// per device: cudaFuncSetAttribute costs host time, so a launch above
// 48 KB makes it again only when it asks for more than was allowed.
struct SmemAttr {
  static constexpr int kDevices = 16;
  std::atomic<long long> allowed[kDevices] = {};
  cudaError_t allow(long long bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && allowed[dev].load() >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(seg_sum_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && dev < kDevices) allowed[dev].store(bytes);
    return err;
  }
};

SmemAttr staged_attr;

}  // namespace

// 1 when a row of n values is staged in shared memory, 0 when it is read
// from device memory (for the wrapper's report).
extern "C" int seg_sum_staged(int n) {
  return (long long)n * (long long)sizeof(float) <= kMaxSmem ? 1 : 0;
}

extern "C" int seg_sum_f32(const float* vals, const int* perm,
                           const int* offsets, float* out, long long rows,
                           int n, int size, void* stream) {
  if (rows <= 0 || size <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const long long smem = (long long)n * (long long)sizeof(float);
  if (seg_sum_staged(n)) {
    if (smem > 48 * 1024) {
      cudaError_t err = staged_attr.allow(smem);
      if (err != cudaSuccess) return (int)err;
    }
    seg_sum_kernel<true><<<(unsigned int)rows, kThreads, (size_t)smem, s>>>(
        vals, perm, offsets, out, n, size);
  } else {
    seg_sum_kernel<false><<<(unsigned int)rows, kThreads, 0, s>>>(
        vals, perm, offsets, out, n, size);
  }
  return (int)cudaGetLastError();
}
