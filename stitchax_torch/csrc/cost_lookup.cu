// K3: decoder cost lookup -- the (2r+1)^2 bilinear window of each pixel's own
// cost map at its current flow coordinate.
//
// Replaces the TPU kernel `cost_lookup_transposed`
// (stitchax/ops/pallas/cost_lookup.py:121, body `_kernel` :66), and holds the
// semantics of stitchax's production selector form `encode_flow_token`
// (stitchax/models/flowformer.py:635-668): out-of-bounds taps read zero,
// bilinear weights are rounded to the cost dtype, the vertical pass is
// accumulated in fp32 and rounded back to the cost dtype, the horizontal
// pass is accumulated in fp32, and channels are x-major (k = a*win + t with
// a the x offset and t the y offset).
//
// What bounds it on the H100: each pixel touches only a (win+1)^2 patch of
// its H2 x W2 map (100 of 4096 values at r = 4), so the work is a sparse
// gather of ~200 bytes plus 81 fp32 outputs per pixel: memory-bound, and at
// the main path's P = 8192 pixels a call moves ~4 MB, about a microsecond
// of HBM time, so the launch and the latency of the dependent loads set it.
//
// Design: one lane per patch row. A warp takes floor(32 / (win+1)) pixels
// (3 at r = 4, 30 of 32 lanes loading), reading the natural (P, H2, W2)
// layout (the TPU kernel's (H2, P, W2) transpose and radix-8 barrel select
// were for the TPU's vector unit and are not carried over). Each lane loads
// the win+1 values of its row once, as aligned pairs (one 32-bit load for
// two bf16) wherever both lie inside the row, into registers; the next row
// comes from the neighbouring lane by a shuffle, so the vertical pass needs
// no second load and no shared memory; the lane then forms its row's win
// outputs. Coordinates are read in their own dtype (fp32 or bf16) and
// widened exactly, as `.float()` does, so the caller copies nothing. Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, no fma
// contraction), as the plain PyTorch version's separate ops are, so the
// kernel is bit-equal to it in both dtypes. No shared memory: nothing to
// set per launch.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block

// two adjacent map values at an even index, in one load
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

template <typename T, typename TC, int R>
__global__ void __launch_bounds__(kWarps * 32)
cost_lookup_kernel(const T* __restrict__ cm, const TC* __restrict__ coords,
                   float* __restrict__ out, int P, int H2, int W2) {
  constexpr int WIN = 2 * R + 1;
  constexpr int WP = WIN + 1;          // patch side, lanes per pixel
  constexpr int PPW = 32 / WP;         // pixels per warp
  constexpr int NV = WP + 2;           // values loaded from an even start
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / WP, t = lane - slot * WP;  // pixel in warp, row
  const int p = (blockIdx.x * kWarps + warp) * PPW + slot;
  const bool active = slot < PPW && p < P;

  float fx = 0.f, fy = 0.f;
  int x0 = 0, y = 0;
  if (active) {
    const float cx = stx_to_f(coords[2 * (size_t)p]);
    const float cy = stx_to_f(coords[2 * (size_t)p + 1]);
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    fx = cx - fx0;
    fy = cy - fy0;
    x0 = (int)fx0 - R;
    y = (int)fy0 - R + t;
  }

  // this lane's patch row: values at x0 .. x0 + WP - 1, zero outside the map
  float row[WP];
  {
    const int xa = x0 - (x0 & 1);      // even start: pairs are aligned
    const int off = x0 - xa;           // 0 or 1
    float vals[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) vals[i] = 0.f;
    if (active && y >= 0 && y < H2) {
      const T* m = cm + ((size_t)p * H2 + y) * W2;
      const bool even = (W2 & 1) == 0;   // rows start at even indices
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int x = xa + i;
        if (i >= off + WP) {
          // past the patch (only with off = 0: the last pair)
        } else if (even && x >= 0 && x + 1 < W2) {
          load_pair(m + x, vals[i], vals[i + 1]);
        } else {
          if (x >= 0 && x < W2) vals[i] = stx_to_f(m[x]);
          if (x + 1 >= 0 && x + 1 < W2) vals[i + 1] = stx_to_f(m[x + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WP; ++i) row[i] = off ? vals[i + 1] : vals[i];
  }

  // vertical pass: this row and the next lane's, rounded to the cost dtype
  const float wy0 = stx_round<T>(1.f - fy), wy1 = stx_round<T>(fy);
  float vrow[WP];
#pragma unroll
  for (int i = 0; i < WP; ++i) {
    const float below = __shfl_down_sync(0xffffffffu, row[i], 1);
    vrow[i] = stx_round<T>(
        __fadd_rn(__fmul_rn(wy0, row[i]), __fmul_rn(wy1, below)));
  }
  if (!active || t >= WIN) return;

  // horizontal pass: outputs k = a*WIN + t of this row
  const float wx0 = stx_round<T>(1.f - fx), wx1 = stx_round<T>(fx);
  float* o = out + (size_t)p * WIN * WIN + t;
#pragma unroll
  for (int a = 0; a < WIN; ++a)
    o[a * WIN] = __fadd_rn(__fmul_rn(wx0, vrow[a]), __fmul_rn(wx1, vrow[a + 1]));
}

template <typename T, typename TC, int R>
cudaError_t launch(const void* cm, const void* coords, float* out, int P,
                   int H2, int W2, cudaStream_t stream) {
  constexpr int PPW = 32 / (2 * R + 2);
  const int per_block = kWarps * PPW;
  const int blocks = (P + per_block - 1) / per_block;
  cost_lookup_kernel<T, TC, R><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(cm), static_cast<const TC*>(coords), out, P, H2,
      W2);
  return cudaGetLastError();
}

template <typename T, typename TC>
cudaError_t launch_r(const void* cm, const void* coords, float* out, int P,
                     int H2, int W2, int r, cudaStream_t s) {
  switch (r) {
    case 1: return launch<T, TC, 1>(cm, coords, out, P, H2, W2, s);
    case 2: return launch<T, TC, 2>(cm, coords, out, P, H2, W2, s);
    case 3: return launch<T, TC, 3>(cm, coords, out, P, H2, W2, s);
    case 4: return launch<T, TC, 4>(cm, coords, out, P, H2, W2, s);
    case 5: return launch<T, TC, 5>(cm, coords, out, P, H2, W2, s);
    case 6: return launch<T, TC, 6>(cm, coords, out, P, H2, W2, s);
    case 7: return launch<T, TC, 7>(cm, coords, out, P, H2, W2, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_c(const void* cm, const void* coords, float* out, int P,
                     int H2, int W2, int r, int coord_dtype, cudaStream_t s) {
  if (coord_dtype == STX_FLOAT32)
    return launch_r<T, float>(cm, coords, out, P, H2, W2, r, s);
  if (coord_dtype == STX_BFLOAT16)
    return launch_r<T, __nv_bfloat16>(cm, coords, out, P, H2, W2, r, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// cm (P, H2, W2) in `dtype`, coords (P, 2) xy in `coord_dtype`, out
// (P, (2r+1)^2) fp32, 1 <= r <= 7. Returns a cudaError_t code (0 on
// success).
extern "C" int stx_cost_lookup(const void* cm, const void* coords, void* out,
                               int P, int H2, int W2, int r, int dtype,
                               int coord_dtype, void* stream) {
  if (P <= 0 || H2 <= 0 || W2 <= 0 || r < 1 || r > 7)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == STX_BFLOAT16)
    return (int)launch_c<__nv_bfloat16>(cm, coords, o, P, H2, W2, r,
                                        coord_dtype, s);
  if (dtype == STX_FLOAT32)
    return (int)launch_c<float>(cm, coords, o, P, H2, W2, r, coord_dtype, s);
  return (int)cudaErrorInvalidValue;
}
