// TF32 tensor-core products of fp32 operands on mma.sync, shared by the
// kernels that need fp32 accuracy from the tensor cores (flash_attention.cu's
// fp32 route, ssm_scan.cu's chunk route).
//
// One TF32 product keeps about three decimal digits, too few for the fp32
// tolerance the kernels are held to. So an fp32 operand is split, x = hi +
// lo with hi = rna(x), rna being cvt.rna.tf32's rounding, and a.b is taken
// as hi.hi + hi.lo + lo.hi with fp32 accumulation (the dropped lo.lo term is
// ~2^-22 of the product). How lo is taken is the caller's choice (Split);
// an operand that is exact in TF32 (a bf16 value) has no lo half, so a
// product with one such side takes two TF32 products and one with two such
// sides takes one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

// How an operand becomes TF32 halves x = hi + lo:
//   EXACT: x is a TF32 value already (a bf16 value): hi = x, no lo;
//   RNA:   hi = rna(x), lo = rna(x - hi) (flash_attention.cu; the wrapper's
//          tf32_split models it bit for bit);
//   RAW:   hi = rna(x), lo = x - hi handed over whole, and the tensor core
//          reads its TF32 bits (truncation, as CUTLASS's 3xTF32 does), which
//          leaves ~2^-21 of x: two instructions a value fewer than RNA
//          (ssm_scan.cu).
enum Split { EXACT, RNA, RAW };

// cvt.rna.tf32.f32: round to nearest, ties away from zero, on the 13 bits
// below TF32's mantissa. Here as two integer operations on the bit pattern
// (the same value for every finite input; measured 18% faster for the
// whole of flash_attention.cu's fp32 kernel than the cvt instruction); the
// tests hold both, and the wrapper's plain model tf32_split, to one another.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ uint32_t tf32_rna_cvt(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
template <Split M>
__device__ __forceinline__ void as_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (M == EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32_rna(x);
    const float rest = x - __uint_as_float(hi);
    lo = M == RNA ? tf32_rna(rest) : __float_as_uint(rest);
  }
}
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// An A fragment split once, reused across the B fragments it meets.
template <Split M>
struct FragA {
  uint32_t hi[4], lo[4];
  FragA() = default;
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    set(a0, a1, a2, a3);
  }
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    as_tf32<M>(a0, hi[0], lo[0]);
    as_tf32<M>(a1, hi[1], lo[1]);
    as_tf32<M>(a2, hi[2], lo[2]);
    as_tf32<M>(a3, hi[3], lo[3]);
  }
};
// d[0..3] += a.b, the small terms first: lo.hi, hi.lo, hi.hi (a term with
// an EXACT side's lo is not issued)
template <Split MA, Split MB>
__device__ __forceinline__ void mma_acc(float* d, const FragA<MA>& a,
                                        float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  as_tf32<MB>(b0, bh0, bl0);
  as_tf32<MB>(b1, bh1, bl1);
  if constexpr (MA != EXACT) mma_tf32(d[0], d[1], d[2], d[3], a.lo, bh0, bh1);
  if constexpr (MB != EXACT) mma_tf32(d[0], d[1], d[2], d[3], a.hi, bl0, bl1);
  mma_tf32(d[0], d[1], d[2], d[3], a.hi, bh0, bh1);
}

__device__ __forceinline__ float lds(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

}  // namespace tf32mma
