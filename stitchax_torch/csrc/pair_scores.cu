// K6: the evaluation's per-pair scores, PSNR's squared error and SSIM's
// per-channel sums, on the card.
//
// It replaces no TPU kernel: stitchax scores its evaluation in numpy on the
// host (stitchax/metrics.py, evaluate.py). The port's evaluation loop
// (`validate_with_model`, evaluate.py) did the same after downloading the
// warped images, and the card waited out the scoring: more than half of a
// 12-pair 512^2 batch (PERF.md section 5). This kernel scores the batch
// where the alignment left it, and only (B, 4) numbers go to the host.
//
// The same numbers, not an approximation. The pair is first formed as
// `masked_pairs` (evaluate.py) forms it: each level clipped to [0, 255] and
// truncated (NaN to 0, as numpy's cast gives on x86), the coverage
// truncated to an integer mask (NaN and values outside int32 to 0), the
// product taken in uint8 (mod 256). Every sum PSNR and SSIM take over those
// uint8 images is then an integer: the squared error, and the 7x7 window
// sums of a, b, a^2, b^2 and ab (at most 49 * 255^2, int32). numpy's float64
// summed-area tables hold them exactly, so the kernel forms them exactly in
// integers and then evaluates `_ssim_channel`'s float64 expression
// (metrics.py) in numpy's order, each operation rounded on its own
// (`__dmul_rn`, `__dadd_rn`, `__dsub_rn`, `__ddiv_rn`: nothing contracted to
// an FMA), so that each pixel's S is numpy's bit for bit. Only the mean of S
// over the cropped interior [3, H-3) x [3, W-3) is summed in another order
// than numpy's pairwise sum (~1e-16 apart).
//
// What bounds it on the H100: the bytes. It reads img1 (fp32 x 3), the
// warped img2 (fp32 x 3) and the coverage (fp32) once, 28 bytes a pixel, and
// writes B x 4 doubles: 26 us for 12 pairs at 512^2 at 3.35 TB/s. Against
// that it does ~75 float64 operations a pixel and channel (six correctly
// rounded divisions), ~0.7 GFLOP a batch, ~50 us at the card's 34 TFLOP/s
// of float64 off the tensor cores.
//
// Design: one block of 256 threads per (pair, 32 x 32 tile of the image).
// The block stages its tile and a 3-pixel halo of the masked levels of all
// three channels in shared memory (the halo outside the image is zero; it
// feeds only windows that are cropped away), adding up the squared error
// of the tile's own pixels as it loads. For each channel it then takes the
// vertical 7-sums of a, b, a^2, b^2 and ab over the tile's rows and the
// halo's columns, then the horizontal 7-sums of those, and S at each
// interior pixel. Each thread sums its pixels in a fixed order and the
// block reduces in a fixed tree, to one partial per (pair, tile); a second
// kernel of one block a pair sums those partials in a fixed order. No
// floating-point atomics: a pair reads the same on every run.
//
// Inputs are read through their strides (in elements), so the channel
// slice of the 6-channel warp output that the evaluation step returns is
// read where it lies, without a copy. The wrapper (ops/kernels/
// pair_scores.py) checks types and devices; the C entry checks the sizes.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 7;
constexpr int kR = kWin / 2;             // 3
constexpr int kTile = 32;                // a block's tile of the image
constexpr int kHalo = kTile + 2 * kR;    // 38
constexpr int kLdLevel = kHalo + 2;      // bytes a staged row of levels
constexpr int kThreads = 256;
constexpr int kChannels = 3;

struct Strides {
  long long b, h, w, c;
};

// np.clip(x, 0, 255).astype(np.uint8): fmaxf returns 0 for NaN
__device__ __forceinline__ int level(float x) {
  return (int)fminf(fmaxf(x, 0.f), 255.f);
}

// valid.astype(np.uint8) as x86 numpy casts it: truncated, mod 256; NaN and
// values outside int32 give 0
__device__ __forceinline__ int coverage_mask(float v) {
  return fabsf(v) < 2147483648.f ? ((int)v & 255) : 0;
}

// `_ssim_channel`'s S at one pixel from its five window sums, in numpy's
// order of operations, each one rounded to nearest
__device__ __forceinline__ double ssim_at(int sa, int sb, int saa, int sbb,
                                          int sab, double cov_norm, double c1,
                                          double c2) {
  const double np_ = kWin * kWin;
  const double ux = __ddiv_rn((double)sa, np_);
  const double uy = __ddiv_rn((double)sb, np_);
  const double uxx = __ddiv_rn((double)saa, np_);
  const double uyy = __ddiv_rn((double)sbb, np_);
  const double uxy = __ddiv_rn((double)sab, np_);
  const double vx = __dmul_rn(cov_norm, __dsub_rn(uxx, __dmul_rn(ux, ux)));
  const double vy = __dmul_rn(cov_norm, __dsub_rn(uyy, __dmul_rn(uy, uy)));
  const double vxy = __dmul_rn(cov_norm, __dsub_rn(uxy, __dmul_rn(ux, uy)));
  const double num =
      __dmul_rn(__dadd_rn(__dmul_rn(__dmul_rn(2.0, ux), uy), c1),
                __dadd_rn(__dmul_rn(2.0, vxy), c2));
  const double den = __dmul_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(ux, ux), __dmul_rn(uy, uy)), c1),
      __dadd_rn(__dadd_rn(vx, vy), c2));
  return __ddiv_rn(num, den);
}

__global__ void __launch_bounds__(kThreads)
pair_scores_tiles(const float* __restrict__ img1, Strides s1,
                  const float* __restrict__ warped, Strides s2,
                  const float* __restrict__ valid, Strides sv, int H, int W,
                  double cov_norm, double c1, double c2,
                  unsigned long long* __restrict__ part_sse,
                  double* __restrict__ part_ssim) {
  __shared__ unsigned char la[kChannels][kHalo][kLdLevel];
  __shared__ unsigned char lb[kChannels][kHalo][kLdLevel];
  __shared__ int vsum[5][kTile][kHalo];
  __shared__ double red_s[kChannels][kThreads];
  __shared__ unsigned long long red_e[kThreads];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;

  // the masked levels of the tile and its halo; the tile's squared error
  unsigned long long sse = 0;
  for (int i = tid; i < kHalo * kHalo; i += kThreads) {
    const int hy = i / kHalo, hx = i % kHalo;
    const int y = y0 - kR + hy, x = x0 - kR + hx;
    int a[kChannels] = {0, 0, 0}, c[kChannels] = {0, 0, 0};
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float* p1 = img1 + b * s1.b + y * s1.h + x * s1.w;
      const float* p2 = warped + b * s2.b + y * s2.h + x * s2.w;
      const int m = coverage_mask(valid[b * sv.b + y * sv.h + x * sv.w]);
      const bool own = hy >= kR && hy < kR + kTile && hx >= kR &&
                       hx < kR + kTile;
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) {
        a[ch] = (level(p1[ch * s1.c]) * m) & 255;
        c[ch] = (level(p2[ch * s2.c]) * m) & 255;
        const int d = a[ch] - c[ch];
        if (own) sse += (unsigned long long)(d * d);
      }
    }
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) {
      la[ch][hy][hx] = (unsigned char)a[ch];
      lb[ch][hy][hx] = (unsigned char)c[ch];
    }
  }
  __syncthreads();

  double acc[kChannels] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) {
    // vertical 7-sums over the tile's rows, at every column of the halo
    for (int i = tid; i < kTile * kHalo; i += kThreads) {
      const int y = i / kHalo, x = i % kHalo;
      int sa = 0, sb = 0, saa = 0, sbb = 0, sab = 0;
#pragma unroll
      for (int j = 0; j < kWin; ++j) {
        const int u = la[ch][y + j][x], v = lb[ch][y + j][x];
        sa += u;
        sb += v;
        saa += u * u;
        sbb += v * v;
        sab += u * v;
      }
      vsum[0][y][x] = sa;
      vsum[1][y][x] = sb;
      vsum[2][y][x] = saa;
      vsum[3][y][x] = sbb;
      vsum[4][y][x] = sab;
    }
    __syncthreads();
    // horizontal 7-sums of those, and S at the tile's interior pixels
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int y = i / kTile, x = i % kTile;
      const int gy = y0 + y, gx = x0 + x;
      if (gy < kR || gy >= H - kR || gx < kR || gx >= W - kR) continue;
      int s[5] = {0, 0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int j = 0; j < kWin; ++j) s[k] += vsum[k][y][x + j];
      acc[ch] = __dadd_rn(acc[ch], ssim_at(s[0], s[1], s[2], s[3], s[4],
                                           cov_norm, c1, c2));
    }
    __syncthreads();   // vsum is the next channel's
  }

  // the block's sums in a fixed tree
  red_e[tid] = sse;
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) red_s[ch][tid] = acc[ch];
  __syncthreads();
  for (int step = kThreads / 2; step > 0; step >>= 1) {
    if (tid < step) {
      red_e[tid] += red_e[tid + step];
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch)
        red_s[ch][tid] = __dadd_rn(red_s[ch][tid], red_s[ch][tid + step]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long p =
        (long long)b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
        blockIdx.x;
    part_sse[p] = red_e[0];
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch)
      part_ssim[p * kChannels + ch] = red_s[ch][0];
  }
}

// one block a pair: its tiles' partials summed in a fixed order, written as
// out[b] = (squared error, SSIM sum of channel 0, 1, 2)
__global__ void __launch_bounds__(kThreads)
pair_scores_finish(const unsigned long long* __restrict__ part_sse,
                   const double* __restrict__ part_ssim, int tiles,
                   double* __restrict__ out) {
  __shared__ double red_s[kChannels][kThreads];
  __shared__ unsigned long long red_e[kThreads];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * tiles;
  unsigned long long e = 0;
  double acc[kChannels] = {0.0, 0.0, 0.0};
  for (int t = tid; t < tiles; t += kThreads) {
    e += part_sse[base + t];
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch)
      acc[ch] = __dadd_rn(acc[ch], part_ssim[(base + t) * kChannels + ch]);
  }
  red_e[tid] = e;
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) red_s[ch][tid] = acc[ch];
  __syncthreads();
  for (int step = kThreads / 2; step > 0; step >>= 1) {
    if (tid < step) {
      red_e[tid] += red_e[tid + step];
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch)
        red_s[ch][tid] = __dadd_rn(red_s[ch][tid], red_s[ch][tid + step]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    double* o = out + (long long)blockIdx.x * (kChannels + 1);
    o[0] = (double)red_e[0];   // exact: at most H W 3 255^2 < 2^53
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) o[1 + ch] = red_s[ch][0];
  }
}

}  // namespace

// img1, warped: (B, H, W, 3) fp32, valid: (B, H, W, 1) fp32, each given by
// its element strides (batch, row, column, channel; the coverage's channel
// stride unused). part_sse (B x tiles unsigned 64-bit) and part_ssim (B x
// tiles x 3 doubles) are scratch, tiles = ceil(H / 32) * ceil(W / 32); out
// is (B, 4) doubles. Two launches on `stream`: the tiles, then the finish.
extern "C" int stx_pair_scores(
    const void* img1, long long s1b, long long s1h, long long s1w,
    long long s1c, const void* warped, long long s2b, long long s2h,
    long long s2w, long long s2c, const void* valid, long long svb,
    long long svh, long long svw, int B, int H, int W, double cov_norm,
    double c1, double c2, void* part_sse, void* part_ssim, void* out,
    void* stream) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  if (B <= 0 || B > 65535 || H < kWin || W < kWin || tiles_y > 65535 ||
      (long long)H * W > (1LL << 35))     // the error stays under 2^53
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_scores_tiles<<<dim3(tiles_x, tiles_y, B), kThreads, 0, s>>>(
      static_cast<const float*>(img1), Strides{s1b, s1h, s1w, s1c},
      static_cast<const float*>(warped), Strides{s2b, s2h, s2w, s2c},
      static_cast<const float*>(valid), Strides{svb, svh, svw, 0}, H, W,
      cov_norm, c1, c2, static_cast<unsigned long long*>(part_sse),
      static_cast<double*>(part_ssim));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pair_scores_finish<<<B, kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(part_sse),
      static_cast<const double*>(part_ssim), tiles_x * tiles_y,
      static_cast<double*>(out));
  return (int)cudaGetLastError();
}
