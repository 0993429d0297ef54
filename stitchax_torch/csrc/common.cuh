// Shared helpers for the stitchax_torch kernels: element-type conversion
// between the storage type (float or bf16) and the fp32 the kernels compute in,
// and the tensor-core fragment helpers that K1 and K4 share: bf16 for their
// bf16 paths, 3xTF32 for their fp32 paths (and K5's).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed across the C interface (must match ops/kernels/library.py)
#define STX_FLOAT32 0
#define STX_BFLOAT16 1

__device__ __forceinline__ float stx_to_f(float x) { return x; }
__device__ __forceinline__ float stx_to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T stx_from_f(float x);
template <> __device__ __forceinline__ float stx_from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 stx_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to the storage type T and back (exact for float).
template <typename T> __device__ __forceinline__ float stx_round(float x) {
  return stx_to_f(stx_from_f<T>(x));
}

// ---- bf16 tensor-core helpers (K1 and K4) ----------------------------------

// two adjacent bf16 values as one 32-bit word (a 4-byte aligned address)
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, subnormal results flushed to zero (a
// weight below 2^-126 against the row's largest, 1, adds nothing that
// survives the output's rounding)
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ---- 3xTF32 tensor-core helpers (K1's and K4's fp32 paths) ------------------
//
// An fp32 value x is split as hi = tf32(x), lo = tf32(x - hi) (tf32: 10
// explicit mantissa bits, rounded to nearest with ties away from zero); a
// product a b is then taken as a_lo b_hi + a_hi b_lo + a_hi b_hi on the
// TF32 tensor cores with fp32 accumulators, which keeps about 22
// significant bits (a_lo b_lo, below fp32's last bit, is dropped).
//
// Fragments of `mma.m16n8k8` tf32 for lane (g, t) = (lane / 4, lane % 4):
// A (16x8) a0..a3 = rows g, g+8, g, g+8 at k = t, t, t+4, t+4; B (8x8)
// b0, b1 = k = t, t+4 at column g; C (16x8) c0..c3 = rows g, g, g+8, g+8
// at columns 2t, 2t+1, 2t, 2t+1. The k order of a product is free, so the
// kernels relabel k = t as 2t and k = t+4 as 2t+1 inside each 8-step: a
// lane's A and B operands are then two adjacent values, and a C tile's
// registers {c0, c2, c1, c3} are, without leaving their lane, the A
// fragment of the next product over its columns (S's keys for P V).

// the tf32 pattern of x (low 13 bits zero), as the tensor cores read it
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// two adjacent values (k = 2t, 2t+1 of one row or column) split and packed
// as one 16-byte chunk {hi, hi, lo, lo}: a B fragment's hi and lo halves
__device__ __forceinline__ uint4 split_pair(float x0, float x1) {
  uint4 r;
  split_tf32(x0, r.x, r.z);
  split_tf32(x1, r.y, r.w);
  return r;
}

// The split as K5 takes it (csrc/conv3x3.cu): hi rounded as cvt.rna rounds
// (to nearest, ties away from zero: half of the dropped 13 bits added to
// the magnitude, then cut) by two integer operations, where `cvt.rna`
// compiles to a compare-and-select sequence; lo = x - hi exactly, left in
// fp32 for the tensor cores, which read its top 10 mantissa bits (lo
// truncated: at most 2^-21 of x lost, against 2^-22 for a rounded lo).
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint4 split_pair_int(float x0, float x1) {
  uint4 r;
  split_tf32_int(x0, r.x, r.z);
  split_tf32_int(x1, r.y, r.w);
  return r;
}

// D (16x8, fp32) += A (16x8, tf32, row) * B (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B in 3xTF32, A split as ah / al, B as one {hi, hi, lo, lo} chunk;
// the two small cross products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint4 b) {
  mma_tf32(d, al, b.x, b.y);
  mma_tf32(d, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
}

// a 16-byte chunk of shared memory
__device__ __forceinline__ uint4 lds128(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}
