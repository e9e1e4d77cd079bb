// Priority water-fills of the vector fabric tick, hand-written for Hopper.
//
// Replaces the two Pallas TPU kernels of src/repro/fabric/fused.py:
//   priority_grants  <- _grants_call  (strict-priority drain water-fill,
//                       OutputPort.drain's arithmetic)
//   priority_admit   <- _admit_call   (QoS RNIC admission water-fill,
//                       HostDatapath's receive-buffer grant)
//
// Layout: demand/can/out are [rows, Q, N] row-major, budget/crumb/space
// [rows, N]; rows is the flattened leading (grid) shape.  One thread owns
// one (row, column) and runs the Q priority rounds in registers, so the
// sequential class loop never leaves the thread and neighbouring threads
// touch neighbouring columns (coalesced loads and stores per class).
//
// Bound: device-memory bytes.  Each element is read once and each output
// written once, with ~7 flops per (class, column); at the fabric engine's
// shapes ([48, 3, 14] grants: ~24 KB per call) a call is a few thousand
// threads and the launch itself dominates, so the design keeps one launch
// per call for the whole grid and allocates nothing.
//
// Numerics: the result must equal the plain PyTorch version bit for bit,
// as the reference pins its Pallas kernel to its ref tier.  Hence the
// explicit round-to-nearest intrinsics (no FMA contraction whatever the
// compiler flags), the reference's op order including
// den = demand > 0 ? demand : 1, and a minimum that propagates NaN and
// returns its first operand on ties, as torch.minimum does (fminf drops
// NaN and is therefore not used).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float min_like_torch(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return (b < a) ? b : a;
}

__global__ void grants_kernel(const float* __restrict__ demand,
                              const uint8_t* __restrict__ can,
                              const float* __restrict__ budget,
                              const float* __restrict__ crumb,
                              float* __restrict__ out,
                              long long rows, int nq, int n) {
  const long long cell = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (cell >= rows * n) return;
  const long long row = cell / n;
  const long long col = cell - row * n;
  const long long base = row * nq * (long long)n + col;
  float left = budget[cell];
  const float cr = crumb[cell];
  for (int q = 0; q < nq; ++q) {
    const long long i = base + (long long)q * n;
    const float d = demand[i];
    const float den = d > 0.0f ? d : 1.0f;
    const float frac = can[i] ? min_like_torch(1.0f, __fdiv_rn(left, den))
                              : 0.0f;
    out[i] = frac;
    left = __fsub_rn(left, __fmul_rn(frac, d));
    left = left < cr ? 0.0f : left;
  }
}

__global__ void admit_kernel(const float* __restrict__ demand,
                             const float* __restrict__ space,
                             float* __restrict__ out,
                             long long rows, int nq, int n) {
  const long long cell = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (cell >= rows * n) return;
  const long long row = cell / n;
  const long long col = cell - row * n;
  const long long base = row * nq * (long long)n + col;
  float sp = space[cell];
  for (int q = 0; q < nq; ++q) {
    const long long i = base + (long long)q * n;
    const float a = min_like_torch(demand[i], sp);
    out[i] = a;
    sp = __fsub_rn(sp, a);
  }
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long cells) {
  return (unsigned int)((cells + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int priority_grants_f32(const float* demand, const uint8_t* can,
                                   const float* budget, const float* crumb,
                                   float* out, long long rows, int nq, int n,
                                   void* stream) {
  grants_kernel<<<blocks_for(rows * n), kThreads, 0,
                  (cudaStream_t)stream>>>(demand, can, budget, crumb, out,
                                          rows, nq, n);
  return (int)cudaGetLastError();
}

extern "C" int priority_admit_f32(const float* demand, const float* space,
                                  float* out, long long rows, int nq, int n,
                                  void* stream) {
  admit_kernel<<<blocks_for(rows * n), kThreads, 0,
                 (cudaStream_t)stream>>>(demand, space, out, rows, nq, n);
  return (int)cudaGetLastError();
}
