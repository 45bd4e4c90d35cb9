// Building blocks shared by the matrix-product kernels (mnn.cu,
// attention.cu, attention_bwd.cu): float32-grade products on Hopper's
// tensor cores by the 3xTF32 split, and asynchronous copies into shared
// memory.
//
// A float32 x is split into a TF32 head and tail, x ~ hi + lo. A product
// a.b is then summed into one float32 accumulator from three tensor-core
// products, the small ones first: lo_a.hi_b, hi_a.lo_b, hi_a.hi_b. The
// kernels run each of the three over all their independent accumulators
// before the next, so no product waits for the one before it.
//
// Fragment layout of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16x8, row):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8x8, col):   b0 (k=t, n=g)   b1 (k=t+4, n=g)
//   C (16x8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// The exact split: hi = x rounded to TF32 (to nearest, ties away from
// zero), lo = (x - hi) rounded the same way; x - hi is exact in float32.
// The rounding is integer arithmetic on the bits (add half a TF32 step to
// the magnitude, clear the 13 low bits), which gives what
// `cvt.rna.tf32.f32` gives at the full rate of the integer pipe; the tensor
// core ignores the 13 low bits of an operand, so lo needs no clearing. The
// dropped lo_a.lo_b term is ~2^-22 of the product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// The cheaper split for outputs held to ~1e-5: hi is x cut to TF32 (the
// tensor core ignores the 13 low bits, so x itself is passed) and
// lo = x - hi, exact, cut the same way. lo is up to 2^-10 of x; the dropped
// lo_a.lo_b term and the cut of lo are up to 2^-20 of the product.
__device__ __forceinline__ void split_cut(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// c += a . b, one m16n8k8 TF32 tensor-core product
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared without passing through registers; `real`
// false writes zeros and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool real) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const int bytes = real ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared, the same way (through L1; any 4-byte aligned
// address)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool real) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const int bytes = real ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tf32x3
