// Shared building blocks of the port's mma.sync kernels (sm_90a):
// 16-byte cp.async with zero fill, ldmatrix (plain and transposed), the
// bf16 m16n8k16 product with float32 accumulators, bf16 packing, the tf32
// m16n8k8 product and the 3xTF32 split that keeps float32 accuracy, and
// the typed fragments (AFrag / BFrag / mma) that run one code path over
// either type.
//
// Fragment layouts are PTX's for mma.m16n8k16 (lane = 4 * g + tq): an A
// fragment holds rows g and g + 8 at k columns 2tq, 2tq + 1 (registers 0,
// 1) and 2tq + 8, 2tq + 9 (registers 2, 3); a B fragment holds k rows 2tq,
// 2tq + 1 and 2tq + 8, 2tq + 9 of column g; a C fragment holds rows g
// (0, 1) and g + 8 (2, 3) at columns 2tq, 2tq + 1.  So the two n8 C tiles
// of a 16-column slice, packed to bf16 pairs, are the A fragment of a k16
// step: a score tile feeds P.V from registers.
//
// The tf32 m16n8k8 fragments are the same bytes: a 32-bit register holds
// one float32, so an ldmatrix x4 over 16 rows x 32 bytes gives the A
// fragment (rows g, g + 8 at k columns tq, tq + 4) and one over 8 rows x
// 32 bytes the B fragment (k rows tq, tq + 4 of column g) of a k8 step.
// The C fragment (columns 2tq, 2tq + 1) is not the A fragment (columns tq,
// tq + 4): an accumulator feeds the next product's A operand when each
// 8-wide k slice runs its columns in the order 0, 2, 4, 6, 1, 3, 5, 7
// (logical k = tq is column 2tq, k = tq + 4 is column 2tq + 1), and the B
// operand reads its rows 2tq and 2tq + 1 to match.
//
// _build.library hashes this file into the cache key of every source that
// includes it, so an edit rebuilds them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in (src
// is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
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

// c += a . b, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x ~ hi + lo with hi = bf16(x) and lo = bf16(x - hi): two bf16 halves
// that keep about 16 significant bits of x, packed in pairs as
// pack_bf16 does
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// c += a . b, m16n8k8, tf32 operands (the upper 19 bits of each
// register), float32 accumulators
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
// is exact, and the tensor core reads its tf32 bits (the upper 19).  The
// 3xTF32 product small.big + big.small + big.big holds each operand to
// 2**-21 of itself; the dropped small.small term is below 2**-22 of the
// product.  A NaN x keeps a NaN small, so NaN still propagates; an
// infinite x gives NaN.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(__uint_as_float(x),
                                    __uint_as_float(big)));
}

// The A operand of one 32-byte k step (16 rows) and the B operand of one
// k step and one n8 tile, from the registers ldmatrix (or accumulators)
// give: bf16 as they are, float32 split for 3xTF32.
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

}  // namespace
