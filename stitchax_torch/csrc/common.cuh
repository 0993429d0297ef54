// Shared helpers for the stitchax_torch kernels: element-type conversion
// between the storage type (float or bf16) and the fp32 the kernels compute in,
// and the bf16 tensor-core fragment helpers that K1 and K4 share.
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
