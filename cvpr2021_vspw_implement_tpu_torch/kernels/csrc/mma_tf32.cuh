// Device primitives of the f32-accurate tensor-core kernels for Hopper
// (sm_90a): cp.async staging, the 3xTF32 operand split and the TF32
// mma.sync.  Included by tap_mma.cuh (the tap-convolutions of B2-B4) and by
// local_agg.cu (B5).
//
// 3xTF32: an f32 operand v is split into hi = tf32(v) and lo = tf32(v - hi),
// and a product is lo*hi + hi*lo + hi*hi (lo*lo dropped), which keeps about
// 21 of f32's 24 mantissa bits where one TF32 product keeps 11.  The tensor
// cores round their f32 sums toward zero, so a caller sends the products of
// each K step to a fresh tile (mma_tf32_fresh, then mma_tf32) and adds that
// tile to its accumulator in f32, which rounds to nearest.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mmatf32 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; src-size 0 writes zeros and reads nothing.
// .ca copies go through L1, for data that neighbouring copies read again
// (the taps of one channel chunk); .cg bypasses it, for data read once a
// block.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const float* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo + O(2^-22 |v|), both TF32, without cvt (which runs at the
// conversion unit's lower rate).  hi rounds as cvt.rna.tf32.f32 does (to
// nearest, ties away from zero): float bits are sign and magnitude, so
// adding half the weight of the 13 dropped bits to the magnitude and
// masking them rounds half away.  lo = v - hi is exact in f32 and skips the
// mask: the tensor cores read only the top 19 bits of a TF32 operand.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// d (+)= a * b on a 16x8x8 tile (row-major A, column-major B, f32
// accumulate); mma_tf32 accumulates into d, mma_tf32_fresh starts from 0.
// Not volatile: the compiler may interleave independent tiles' MMAs.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}


}  // namespace mmatf32
