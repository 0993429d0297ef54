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
// What bounds it on the H100: one log and 11 fp32 flops per (pixel,
// center) pair against 8 bytes written per pixel -- hundreds of operations
// per byte, so the bound is the rate of the units that compute a pair. The
// log is the special-function unit's `lg2.approx` times ln 2 (`sfu_log`):
// one op per pair at 16 per clock per SM, which binds, where the precise
// `logf` is a range reduction and a ninth-degree polynomial on the fp32
// pipes; the pair's other ten instructions take those pipes about as long.
//
// Design: each thread evaluates kPix neighbouring pixels of one row, so
// one broadcast 16-byte shared-memory load of a center, packed as
// (cx, cy, wx, wy), and its row term dy serve all of them; px = x / W and
// py = y / H are computed per pixel as a division, as before, so the
// coordinates keep their bits. Centers (up to kMaxCenters) are staged once
// per block; accumulation in fp32 registers; 32-bit index math.

#include <climits>
#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPix = 4;  // pixels of a row per thread
constexpr int kMaxCenters = 8192;

// log(x) for x >= 1e-9 on the special-function unit: lg2.approx times
// ln 2, as `__logf` computes it, with `.ftz` sparing `__logf`'s fix-up of
// subnormal inputs (five more instructions a pair), which x never is
__device__ __forceinline__ float sfu_log(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * 0.693147180559945f;
}

template <bool kKornia>
__global__ void __launch_bounds__(kThreads)
tps_grid_kernel(const float* __restrict__ ctrl, const float* __restrict__ kw,
                const float* __restrict__ aw, float* __restrict__ out, int N,
                int H, int W, int groups, float kernel_scale,
                float affine_scale) {
  extern __shared__ float4 cs[];  // (cx, cy, wx, wy) per center
  for (int i = threadIdx.x; i < N; i += kThreads)
    cs[i] = make_float4(ctrl[2 * i], ctrl[2 * i + 1], kw[2 * i],
                        kw[2 * i + 1]);
  __syncthreads();

  const int gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid >= H * groups) return;
  const int y = gid / groups;
  const int x0 = (gid - y * groups) * kPix;
  const float py = (float)y / (float)H;
  float px[kPix], gx[kPix], gy[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    px[p] = (float)(x0 + p) / (float)W;
    gx[p] = gy[p] = 0.f;
  }

  for (int k = 0; k < N; ++k) {
    const float4 c = cs[k];
    const float dy = py - c.y;
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const float dx = px[p] - c.x;
      const float d2 = dx * dx + dy * dy;
      float u;
      if (kKornia) {
        u = 0.5f * d2 * sfu_log(d2 + 1e-8f);
      } else {
        u = d2 > 0.f ? d2 * sfu_log(fmaxf(d2, 1e-9f)) : 0.f;
      }
      gx[p] = fmaf(u, c.z, gx[p]);
      gy[p] = fmaf(u, c.w, gy[p]);
    }
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    if (x0 + p < W) {
      const float2 m = make_float2(
          kernel_scale * gx[p] + affine_scale * (aw[0] + px[p] * aw[2] + py * aw[4]),
          kernel_scale * gy[p] + affine_scale * (aw[1] + px[p] * aw[3] + py * aw[5]));
      reinterpret_cast<float2*>(out)[(size_t)y * W + x0 + p] = m;
    }
  }
}

template <bool kKornia>
cudaError_t launch(const float* ctrl, const float* kw, const float* aw,
                   float* out, int N, int H, int W, float kernel_scale,
                   float affine_scale, cudaStream_t stream) {
  auto kernel = tps_grid_kernel<kKornia>;
  // above 48 KiB (N > 3072) the dynamic shared memory needs the attribute;
  // it is set once, for the most centers the kernel takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxCenters * (int)sizeof(float4));
  if (attr != cudaSuccess) return attr;
  const int groups = (W + kPix - 1) / kPix;
  const int blocks = (int)(((long long)H * groups + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, (size_t)N * sizeof(float4), stream>>>(
      ctrl, kw, aw, out, N, H, W, groups, kernel_scale, affine_scale);
  return cudaGetLastError();
}

}  // namespace

// ctrl (N, 2), kernel_w (N, 2), affine_w (3, 2), out (H, W, 2): fp32,
// contiguous. Returns a cudaError_t code (0 on success).
extern "C" int stx_tps_grid(const void* ctrl, const void* kernel_w,
                            const void* affine_w, void* out, int N, int H,
                            int W, int kornia, float kernel_scale,
                            float affine_scale, void* stream) {
  if (N <= 0 || N > kMaxCenters || H <= 0 || W <= 0 ||
      (long long)H * ((W + kPix - 1) / kPix) > INT_MAX - kThreads)
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(ctrl);
  const float* k = static_cast<const float*>(kernel_w);
  const float* a = static_cast<const float*>(affine_w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(kornia ? launch<true>(c, k, a, o, N, H, W, kernel_scale,
                                     affine_scale, s)
                      : launch<false>(c, k, a, o, N, H, W, kernel_scale,
                                      affine_scale, s));
}
