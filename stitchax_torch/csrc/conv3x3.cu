// K5: 3x3 convolution, stride 1, zero padding 1, fp32 NHWC, with the bias
// and a ReLU fused: out = relu(conv3x3(x, w) + bias); or, for the input
// gradient of such a layer, the plain convolution without bias or ReLU.
//
// It replaces no TPU kernel: stitchax runs these convolutions in XLA. It
// was added for FlowFormer++'s motion encoder (`BasicMotionEncoder`,
// models/flowformer.py), whose three 3x3 convolutions (convc2 256 -> 192,
// convf2 128 -> 64, conv 256 -> 126 at 64^2) run in every decoder
// iteration. In fp32 with TF32 off, cuDNN takes them, and the input
// gradients of two of them, by FFT, whose complex GEMM runs on the CUDA
// cores: it was most of an evaluation batch's device time (PERF.md
// section 5).
//
// What bounds it on the H100: 2 * 9 * Cin * Cout flops per output pixel
// against (Cin + Cout) * 4 bytes (the input read once, the output written
// once): ~500 flops per byte at the encoder's widths, so the bound is the
// operations. At fp32's accuracy on the tensor cores (3xTF32, three TF32
// products a product, as K1's and K4's fp32 paths) that is 3 x the flops at
// 495 TFLOP/s: 11.5 ms of the ~1.9 TFLOP of an evaluation batch's 72 calls.
//
// Design: an implicit GEMM, M = B * H * W output pixels, N = Cout, K =
// 9 * Cin ordered tap by tap (ky, kx), channels inside a tap. The weight
// comes repacked as (Cout, 3, 3, Cin), K-major. A block of 4 warps owns a
// 128-pixel x 64-channel output tile and walks K in steps of one tap and
// 32 channels; a ring of 3 stages of A (128 x 32) and B (64 x 32) tiles in
// shared memory is fed by `cp.async`, 16 bytes a copy, straight from the
// NHWC input: the 1-pixel zero halo (and channels past Cin, and rows past
// Cout) are copies of size 0, which fill zeros, so no padded copy of the
// input is made. Rows are padded to 40 words, so that each fragment's
// 8-byte loads are free of bank conflicts. Each warp owns a 64 x 32 tile:
// per 8 of K, 4 x 4 `mma.sync.m16n8k8` tf32 products in 3xTF32, with the
// operands split into tf32 hi and lo parts as they leave shared memory,
// each split used by 4 products (`split_tf32_int`, `mma_3xtf32`;
// common.cuh: hi rounded by two integer operations, lo left for the tensor
// cores to truncate, took 17% off the time `split_tf32`'s `cvt.rna` took,
// at the same accuracy on the card), and K relabelled inside each 8-step
// (k = t as 2t, t + 4 as 2t + 1) so that a lane's two A or B values are
// one 8-byte load.
//
// Accumulation: the tensor cores do not round their fp32 sums to nearest
// (on the card, one accumulator carried over all of K = 2304 read ~3.7e-5
// from an fp64 convolution, against ~1e-6 for cuDNN's fp32), so each stage
// of 32 channels sums into fresh registers, which are then added to the
// running sum with ordinary fp32 adds: the tensor cores' chain is 12
// products of small partial sums.
//
// The epilogue adds the bias, applies the ReLU and stores straight from
// the accumulators, 8 bytes a lane and a full 32-byte sector a quad: rows
// of Cout = 126 are only 8-byte aligned, so 16-byte stores would need a
// staging pass. `wgmma` would be faster, but K5 is a few percent of an
// evaluation batch at this design.
//
// It takes fp32, Cin a multiple of 4 and 16-byte aligned tensors (the
// wrapper, ops/kernels/conv3x3.py, checks; the C entry checks the sizes).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;          // output pixels a block
constexpr int kBN = 64;           // output channels a block
constexpr int kBK = 32;           // channels of one tap a stage
constexpr int kStages = 3;
constexpr int kLd = kBK + 8;      // words a staged row: 160 bytes
constexpr int kThreads = 128;     // 4 warps: 2 along M x 2 along N
constexpr int kWM = 64, kWN = 32; // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kStageA = kBM * kLd;
constexpr int kStageB = kBN * kLd;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 4;
constexpr int kRowsA = kBM * (kBK / 4) / kThreads;  // A rows a thread copies
constexpr int kRowsB = kBN * (kBK / 4) / kThreads;
constexpr int kRowStep = kThreads / (kBK / 4);      // 16

// 16 bytes from global to shared memory, or 16 zero bytes if !valid (a
// copy of size 0: the source is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int M, int H, int W,
                        int Cin, int Cout, int relu) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kStages * kStageA;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int chunks = (Cin + kBK - 1) / kBK;
  const int KT = 9 * chunks;
  const long long Kw = 9LL * Cin;

  // each thread copies the 16-byte chunk `lc` of rows lr + 16 i: eight A
  // rows (pixels), whose (y, x) it keeps packed, and four B rows (output
  // channels) a stage
  const int lc = tid & 7, lr = tid >> 3;
  int a_yx[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int m = m0 + lr + kRowStep * i;
    const int hw = m % (H * W);
    // a pixel past M gets a row no tap reaches, so all its copies are zeros
    a_yx[i] = ((m < M ? hw / W : -2) << 16) | (hw % W);
  }

  auto load_stage = [&](int kt, int stage) {
    const int tap = kt / chunks;
    const int c = (kt - tap * chunks) * kBK + lc * 4;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool cv = c < Cin;
    float* as = As + stage * kStageA + lc * 4;
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const int row = lr + kRowStep * i;
      const int yy = (a_yx[i] >> 16) + dy, xx = (a_yx[i] & 0xffff) + dx;
      const bool v =
          cv && (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
      const float* src =
          v ? x + (long long)(m0 + row + dy * W + dx) * Cin + c : x;
      cp_async16(as + row * kLd, src, v);
    }
    float* bs = Bs + stage * kStageB + lc * 4;
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      const int row = lr + kRowStep * i;
      const int co = n0 + row;
      const bool v = cv && co < Cout;
      const float* src = v ? w + co * Kw + tap * Cin + c : w;
      cp_async16(bs + row * kLd, src, v);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    // stage kt has landed for every thread, and every warp is done with
    // the stage the next copy overwrites (computed in step kt - 1)
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next, next % kStages);
    cp_async_commit();

    const int stage = kt % kStages;
    const float* as = As + stage * kStageA + (wm * kWM + g) * kLd + 2 * t;
    const float* bs = Bs + stage * kStageB + (wn * kWN + g) * kLd + 2 * t;
    float part[kMT][kNT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // A fragment of m-tile mi: rows g, g + 8 at k = t (word 2t) and
      // k = t + 4 (word 2t + 1)
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float2 r0 =
            *reinterpret_cast<const float2*>(as + mi * 16 * kLd + kk);
        const float2 r1 =
            *reinterpret_cast<const float2*>(as + (mi * 16 + 8) * kLd + kk);
        split_tf32_int(r0.x, ah[mi][0], al[mi][0]);
        split_tf32_int(r1.x, ah[mi][1], al[mi][1]);
        split_tf32_int(r0.y, ah[mi][2], al[mi][2]);
        split_tf32_int(r1.y, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        // B fragment of n-tile ni: column g at k = t, t + 4
        const float2 c =
            *reinterpret_cast<const float2*>(bs + ni * 8 * kLd + kk);
        const uint4 b = split_pair_int(c.x, c.y);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
          mma_3xtf32(part[mi][ni], ah[mi], al[mi], b);
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();

  // epilogue: accumulator e of tile (mi, ni) is row g + 8 (e / 2), column
  // 2t + e % 2 of it
  const bool pairs = (Cout & 1) == 0;   // 8-byte aligned column pairs
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) {
    const int n = n0 + wn * kWN + ni * 8 + 2 * t;
    const float b0 = bias && n < Cout ? bias[n] : 0.f;
    const float b1 = bias && n + 1 < Cout ? bias[n + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * kWM + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        float* o = out + (long long)m * Cout + n;
        float v0 = acc[mi][ni][2 * h] + b0, v1 = acc[mi][ni][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (pairs && n + 1 < Cout) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < Cout) o[0] = v0;
          if (n + 1 < Cout) o[1] = v1;
        }
      }
  }
}

}  // namespace

// x (B, H, W, Cin) fp32, w (Cout, 3, 3, Cin) fp32, bias (Cout,) fp32 or
// null -> out (B, H, W, Cout) fp32, all contiguous; x and w 16-byte
// aligned. relu: 1 for relu(conv + bias), 0 for conv + bias.
extern "C" int stx_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int Cin, int Cout,
                           int relu, void* stream) {
  const long long M = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || H >= 32768 || W >= 32768 || Cin <= 0 ||
      Cin % 4 != 0 || Cout <= 0 || M > 0x7fffffffLL - kBM ||
      (Cout + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  conv3x3_tf32_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), (int)M, H, W,
      Cin, Cout, relu);
  return (int)cudaGetLastError();
}
