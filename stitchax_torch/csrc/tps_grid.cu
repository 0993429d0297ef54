// K2: dense thin-plate-spline map at every output pixel.
//
// Replaces the TPU kernel `tps_eval_grid_pallas`
// (stitchax/ops/pallas/tps_kernel.py:53, body `_kernel` :27).
//
// For p = (x / out_w, y / out_h):
//   g(p) = kernel_scale * sum_k w_k U(|p - c_k|^2) + affine_scale * [1, px, py] A
// with U = d2 * log(max(d2, 1e-9)) * [d2 > 0] ('opencv') or
// 0.5 * d2 * log(d2 + 1e-8) ('kornia'). The (H*W, N) basis is never
// materialized; centers whose weight is zero drop out exactly.
//
// What bounds it on the H100: N log() evaluations and ~10 fp32 flops per
// center per pixel against 8 bytes written per pixel -- operation-bound on
// the fp32 pipes (and the SFU's log), hundreds of flops per byte.
//
// Design: one thread per output pixel; centers and weights (N up to a few
// hundred, fp32) are staged once per block in shared memory and read as
// broadcasts; accumulation in fp32 registers.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tps_grid_kernel(const float* __restrict__ ctrl, const float* __restrict__ kw,
                const float* __restrict__ aw, float* __restrict__ out, int N,
                int H, int W, int kornia, float kernel_scale,
                float affine_scale) {
  extern __shared__ float s[];  // cx[N], cy[N], wx[N], wy[N]
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    s[i] = ctrl[2 * i];
    s[N + i] = ctrl[2 * i + 1];
    s[2 * N + i] = kw[2 * i];
    s[3 * N + i] = kw[2 * i + 1];
  }
  __syncthreads();

  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)H * W) return;
  const float px = (float)(int)(idx % W) / (float)W;
  const float py = (float)(int)(idx / W) / (float)H;

  float gx = 0.f, gy = 0.f;
  for (int k = 0; k < N; ++k) {
    const float dx = px - s[k];
    const float dy = py - s[N + k];
    const float d2 = dx * dx + dy * dy;
    float u;
    if (kornia) {
      u = 0.5f * d2 * logf(d2 + 1e-8f);
    } else {
      u = d2 > 0.f ? d2 * logf(fmaxf(d2, 1e-9f)) : 0.f;
    }
    gx = fmaf(u, s[2 * N + k], gx);
    gy = fmaf(u, s[3 * N + k], gy);
  }
  out[2 * idx] = kernel_scale * gx + affine_scale * (aw[0] + px * aw[2] + py * aw[4]);
  out[2 * idx + 1] = kernel_scale * gy + affine_scale * (aw[1] + px * aw[3] + py * aw[5]);
}

constexpr int kMaxCenters = 8192;

}  // namespace

// ctrl (N, 2), kernel_w (N, 2), affine_w (3, 2), out (H, W, 2): fp32,
// contiguous. Returns a cudaError_t code (0 on success).
extern "C" int stx_tps_grid(const void* ctrl, const void* kernel_w,
                            const void* affine_w, void* out, int N, int H,
                            int W, int kornia, float kernel_scale,
                            float affine_scale, void* stream) {
  if (N <= 0 || N > kMaxCenters || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  // above 48 KiB (N > 3072) the dynamic shared memory needs the attribute;
  // it is set once, for the most centers the kernel takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      tps_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * kMaxCenters * (int)sizeof(float));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = 4 * (size_t)N * sizeof(float);
  const long long total = (long long)H * W;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  tps_grid_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ctrl), static_cast<const float*>(kernel_w),
      static_cast<const float*>(affine_w), static_cast<float*>(out), N, H, W,
      kornia, kernel_scale, affine_scale);
  return (int)cudaGetLastError();
}
