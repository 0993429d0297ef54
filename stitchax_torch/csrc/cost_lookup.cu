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
// P = 8192 pixels small enough that launch latency is of the same order.
//
// Design: one warp per pixel, reading the natural (P, H2, W2) layout (the
// TPU kernel's (H2, P, W2) transpose and radix-8 barrel select were for the
// TPU's vector unit and are not carried over). Lanes first build the
// win x (win+1) vertically interpolated rows in shared memory (adjacent
// lanes read adjacent x), then produce the win^2 outputs from them. Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, no fma
// contraction), as the plain PyTorch version's separate ops are, so the
// kernel is bit-equal to it in both dtypes.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // pixels per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cost_lookup_kernel(const T* __restrict__ cm, const float* __restrict__ coords,
                   float* __restrict__ out, int P, int H2, int W2, int r) {
  extern __shared__ float rows_s[];
  const int win = 2 * r + 1;
  const int wp = win + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // whole warp exits together; only __syncwarp below

  const float cx = coords[2 * (size_t)p];
  const float cy = coords[2 * (size_t)p + 1];
  const float fx0 = floorf(cx), fy0 = floorf(cy);
  const float fx = cx - fx0, fy = cy - fy0;
  const int x0 = (int)fx0 - r;
  const int y0 = (int)fy0 - r;
  const float wy0 = stx_round<T>(1.f - fy), wy1 = stx_round<T>(fy);
  const float wx0 = stx_round<T>(1.f - fx), wx1 = stx_round<T>(fx);

  float* rows = rows_s + warp * win * wp;
  const T* m = cm + (size_t)p * H2 * W2;
  for (int i = lane; i < win * wp; i += 32) {
    const int t = i / wp, xi = i - (i / wp) * wp;
    const int x = x0 + xi, y = y0 + t;
    float a = 0.f, b = 0.f;
    if (x >= 0 && x < W2) {
      if (y >= 0 && y < H2) a = stx_to_f(m[(size_t)y * W2 + x]);
      if (y + 1 >= 0 && y + 1 < H2) b = stx_to_f(m[(size_t)(y + 1) * W2 + x]);
    }
    rows[i] = stx_round<T>(__fadd_rn(__fmul_rn(wy0, a), __fmul_rn(wy1, b)));
  }
  __syncwarp();

  float* o = out + (size_t)p * win * win;
  for (int k = lane; k < win * win; k += 32) {
    const int a = k / win, t = k - (k / win) * win;
    o[k] = __fadd_rn(__fmul_rn(wx0, rows[t * wp + a]),
                     __fmul_rn(wx1, rows[t * wp + a + 1]));
  }
}

template <typename T>
cudaError_t launch(const void* cm, const float* coords, float* out, int P,
                   int H2, int W2, int r, cudaStream_t stream) {
  const int win = 2 * r + 1;
  const size_t smem = (size_t)kWarps * win * (win + 1) * sizeof(float);
  auto kernel = cost_lookup_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (P + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(cm), coords, out, P, H2, W2, r);
  return cudaGetLastError();
}

}  // namespace

// cm (P, H2, W2) in `dtype`, coords (P, 2) fp32 xy, out (P, (2r+1)^2) fp32.
// Returns a cudaError_t code (0 on success).
extern "C" int stx_cost_lookup(const void* cm, const void* coords, void* out,
                               int P, int H2, int W2, int r, int dtype,
                               void* stream) {
  if (P <= 0 || H2 <= 0 || W2 <= 0 || r < 0 || r > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (dtype == STX_BFLOAT16) return (int)launch<__nv_bfloat16>(cm, c, o, P, H2, W2, r, s);
  if (dtype == STX_FLOAT32) return (int)launch<float>(cm, c, o, P, H2, W2, r, s);
  return (int)cudaErrorInvalidValue;
}
