// Shared helpers for the stitchax_torch kernels: element-type conversion
// between the storage type (float or bf16) and the fp32 the kernels compute in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
