// K7: 3x3 convolution, stride 1, zero padding 1, fp32 NHWC, with the bias
// and a ReLU fused: out = relu(conv3x3(x, w) + bias); or, for the input
// gradient of such a layer, the convolution of the output's gradient with
// the weight transposed and flipped, without bias or ReLU.
//
// It replaces no TPU kernel: stitchax leaves these convolutions to XLA. It
// was added for the VGG16 of TransRef's training loss (`VGG16Features`,
// models/vgg.py): 13 convolutions a call (Cin, Cout 3-512, maps 512^2 down
// to 8^2), 152 GFLOP an image at 512^2, which cuDNN, in fp32 with TF32
// off, runs as SIMT implicit GEMMs on the CUDA cores, with an NCHW copy of
// each channels-last tensor and back (PERF.md section 5).
//
// What bounds it on the H100: 2 * 9 * Cin * Cout flops an output pixel
// against (Cin + Cout) * 4 bytes, 600-2300 flops a byte at the VGG's
// widths: the operations. At fp32's accuracy on the tensor cores (3xTF32:
// three TF32 products a product, as K1, K4 and K5 take them) that is 3 x
// the flops at 495 TFLOP/s, 165 TFLOP/s of fp32 work.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K = 9 *
// Cin taken tap by tap, 32 channels of one tap a stage. A tile is 128
// output pixels, a 16 x 8 box of the output map, by 128 channels (64 where
// N <= 64, 16 where N <= 16: conv1_1's input gradient), so that the
// stage's A operand is one TMA load of the input box shifted by the tap:
// the load fills the zero padding, the channels past Cin and the pixels
// past the map with zeros by itself. The weight comes split once a call
// (`conv3x3_wide_prep`) into tf32 hi and lo planes, (2, N, 9, Cin), K-major,
// padded to whole tiles; its stage is two TMA loads of N rows. Both land in
// a ring of 4 to 8 stages, 128-byte rows with the 128-byte swizzle, under
// `mbarrier`s.
//
// A block is persistent (one an SM, walking output tiles), with three
// warpgroups: one thread of the third issues the TMA loads and runs ahead
// into the next tile while the consumers store; the first two each own 64
// rows of the tile and run `wgmma` m64nNk8 tf32 with A from registers:
// each thread reads its A fragment out of the swizzled tile (conflict-free
// 4-byte loads), splits it into tf32 hi and lo (`split_tf32_int`, as K5),
// and each product is lo*hi + hi*lo + hi*hi against the weight's planes in
// shared memory. A warpgroup reads the next stage's A fragment while the
// current stage's products run, so that only the split and the adds below
// stand between two stages' products (8-21% off the 128-channel tiles'
// time on an H100, against the reads in series).
//
// Accumulation: the tensor cores do not round their fp32 sums to nearest
// (K5 read ~3.7e-5 from fp64 with one accumulator over K = 2304), so each
// stage sums into fresh registers (12 products deep), which are added to
// the running sum with ordinary fp32 adds; while one warpgroup waits for
// its products and adds, the other's keep the tensor cores busy.
//
// What bounds it on an H100: not the loads (the same time with the
// weight's or the input's loads left out) but the tensor cores and each
// stage's serial work around them: 59-74% of 3xTF32's rate at the VGG's
// 128-512-channel layers, ~50% at its 64-channel ones (batch 8). conv1_1's
// 3 channels fill a 32-channel stage a tap: it runs at cuDNN's pace.
//
// The epilogue adds the bias and applies the ReLU to the running sum, and
// stores NHWC straight from the registers, 16 bytes a lane after one
// shuffle between lane pairs; no NCHW copy is made. Offsets into the
// tensors are 64-bit: conv1_2's output at batch 32 is 2^31 bytes.
//
// It takes fp32, Cin and N multiples of 4 and 16-byte aligned tensors (the
// wrapper, ops/kernels/conv3x3_wide.py, pads and checks; the C entry
// checks the sizes).

#include <cuda.h>   // CUtensorMap and its encoder's types; libcuda is opened at run time
#include <dlfcn.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBK = 32;            // channels of one tap a stage: a 128-byte row
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxW = 16;          // a tile's pixels along W

// BN output channels a tile; 128 pixels (16 x 8) a tile, 64 a consumer
// warpgroup
template <int BN>
struct Cfg {
  static constexpr int kBM = kConsumers * 64;
  static constexpr int kBoxH = kBM / kBoxW;
  static constexpr int kBytesA = kBM * kBK * 4;
  static constexpr int kBytesB = BN * kBK * 4;       // one plane
  static constexpr int kStageBytes = kBytesA + 2 * kBytesB;
  // as many stages as 200 KB of shared memory hold, at most 8
  static constexpr int kStages =
      200 * 1024 / kStageBytes < 8 ? 200 * 1024 / kStageBytes : 8;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// the tile's output channels for N: 16, 64 or 128
constexpr int tile_n(int N) { return N <= 16 ? 16 : N <= 64 ? 64 : 128; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 4-d box of `map` at (c0, c1, c2, c3) into shared memory at `dst`,
// counted on `bar`; coordinates outside the tensor read zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma's descriptor of a K-major operand of 128-byte rows in the 128-byte
// swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// registers the in-flight wgmma writes: the compiler may not move their
// reads or writes across this point
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, fp32, 64 a thread) += A (64 x 8, tf32, registers) * B (8 x 128,
// tf32, shared memory, K-major, 128-byte swizzle); D = A B when !accumulate
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// D (64 x 64, fp32, 32 a thread) += A (64 x 8, tf32, registers) * B (8 x 64,
// tf32, shared memory, K-major, 128-byte swizzle); D = A B when !accumulate
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}


// D (64 x 16, fp32, 8 a thread) += A (64 x 8, tf32, registers) * B (8 x 16,
// tf32, shared memory, K-major, 128-byte swizzle); D = A B when !accumulate
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}


struct Tile {
  int n0, b, y0, x0;
};

template <int BN, int BoxH>
__device__ __forceinline__ Tile tile_at(long long tile, int n_tiles,
                                        int tiles_x, int tiles_y) {
  Tile t;
  t.n0 = static_cast<int>(tile % n_tiles) * BN;
  long long m = tile / n_tiles;
  t.x0 = static_cast<int>(m % tiles_x) * kBoxW;
  m /= tiles_x;
  t.y0 = static_cast<int>(m % tiles_y) * BoxH;
  t.b = static_cast<int>(m / tiles_y);
  return t;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wide_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int B, int H, int W, int Cin,
                        int N, int relu) {
  using C = Cfg<BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on 1024
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);
  uint64_t* empty = full + kStages;

  const int tiles_x = (W + kBoxW - 1) / kBoxW;
  const int tiles_y = (H + C::kBoxH - 1) / C::kBoxH;
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = static_cast<long long>(B) * tiles_y * tiles_x * n_tiles;
  const uint32_t chunks = (Cin + kBK - 1) / kBK;
  const uint32_t KT = 9 * chunks;
  // this block's tiles are blockIdx.x + j gridDim.x; its stages run on
  // through them, `it` counting both sides' stages alike
  const uint32_t total =
      blockIdx.x < tiles ? ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * KT : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumers * 4);   // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      Tile tl{};
      for (uint32_t it = 0; it < total; ++it) {
        const uint32_t kt = it % KT;
        if (kt == 0)
          tl = tile_at<BN, C::kBoxH>(blockIdx.x + (long long)(it / KT) * gridDim.x,
                                     n_tiles, tiles_x, tiles_y);
        const int s = it % kStages;
        mbar_wait(smem_u32(empty + s), ((it / kStages) & 1) ^ 1);
        const int tap = kt / chunks;
        const int c0 = (kt - tap * chunks) * kBK;
        const uint32_t st = smem_u32(smem + s * C::kStageBytes);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, C::kStageBytes);
        tma_load_4d(st, &tm_x, bar, c0, tl.x0 + tap % 3 - 1,
                    tl.y0 + tap / 3 - 1, tl.b);
        tma_load_4d(st + C::kBytesA, &tm_w, bar, c0, tap, tl.n0, 0);
        tma_load_4d(st + C::kBytesA + C::kBytesB, &tm_w, bar, c0, tap,
                    tl.n0, 1);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns the tile's rows 64 cw .. 64 cw + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int R = BN / 2;        // accumulators a thread
    const int cw = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    // the thread's A elements of a stage: rows r, r + 8 (r = 64 cw + 16 warp
    // + g, so r % 8 = g) at k = t, t + 4 of each 8-step; element (row, c) of
    // the swizzled tile is word row * 32 + ((c / 4) ^ (row % 8)) * 4 + c % 4
    const int a_off = (cw * 64 + warp * 16 + g) * 32 + t;
    float acc[R], part[R];

    // the raw A elements of stage `it`, once it has landed
    auto load = [&](float (&f)[16], uint32_t it) {
      const int s = it % kStages;
      mbar_wait(smem_u32(full + s), (it / kStages) & 1);
      const float* a0 =
          reinterpret_cast<const float*>(smem + s * C::kStageBytes) + a_off;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const int lo4 = ((2 * kb) ^ g) * 4, hi4 = ((2 * kb + 1) ^ g) * 4;
        f[4 * kb] = a0[lo4];
        f[4 * kb + 1] = a0[8 * 32 + lo4];
        f[4 * kb + 2] = a0[hi4];
        f[4 * kb + 3] = a0[8 * 32 + hi4];
      }
    };

    // epilogue: accumulator 4j + e is row 16 warp + g + 8 (e / 2), column
    // 8j + 2t + e % 2. Lane pairs (t, t ^ 1) swap halves so that an even t
    // holds row g, columns 8j + 2t .. + 3, and an odd t row g + 8, columns
    // 8j + 2t - 2 .. + 1: one 16-byte store
    auto store = [&](long long tile) {
      const Tile tl = tile_at<BN, C::kBoxH>(tile, n_tiles, tiles_x, tiles_y);
      const bool odd = t & 1;
      const int col = 2 * (t & ~1);
      const int row = cw * 64 + warp * 16 + g + (odd ? 8 : 0);
      const int y = tl.y0 + row / kBoxW, x = tl.x0 + row % kBoxW;
      const bool valid = y < H && x < W;
      float* o = out + ((static_cast<long long>(tl.b) * H + y) * W + x) * N;
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
        const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                       : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
        const int n = tl.n0 + 8 * j + col;
        if (!valid || n >= N) continue;
        if (bias) {
          const float4 bv = *reinterpret_cast<const float4*>(bias + n);
          v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
        }
        if (relu) {
          v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
          v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
        }
        *reinterpret_cast<float4*>(o + n) = v;
      }
    };

    // stage `it` from its raw A elements `cur`: split them, issue its 12
    // products into fresh accumulators, read the next stage's A elements
    // into `nxt` while they run, then add the stage to the running sum
    auto step = [&](float (&cur)[16], float (&nxt)[16], uint32_t it) {
      const uint8_t* st = smem + (it % kStages) * C::kStageBytes;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32_int(cur[4 * kb + e], ah[kb][e], al[kb][e]);
      const uint64_t dhi = smem_desc(smem_u32(st + C::kBytesA));
      const uint64_t dlo = smem_desc(smem_u32(st + C::kBytesA + C::kBytesB));
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        // k8 step kb is 32 bytes into each 128-byte row
        wgmma_tf32(part, al[kb], dhi + 2 * kb, kb > 0);
        wgmma_tf32(part, ah[kb], dlo + 2 * kb, 1);
        wgmma_tf32(part, ah[kb], dhi + 2 * kb, 1);
      }
      wgmma_commit();
      if (it + 1 < total) load(nxt, it + 1);
      wgmma_wait_all();
      fence_regs(part);
      if (lane == 0) mbar_arrive(smem_u32(empty + it % kStages));
      const uint32_t kt = it % KT;
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = kt == 0 ? part[i] : acc[i] + part[i];
      if (kt == KT - 1) store(blockIdx.x + (long long)(it / KT) * gridDim.x);
    };

    float fa[16], fb[16];
    if (total > 0) load(fa, 0);
    for (uint32_t it = 0; it < total; it += 2) {
      step(fa, fb, it);
      if (it + 1 < total) step(fb, fa, it + 1);
    }
  }
}

// The weight as K7's B operand: wp (2, Nw, 9, Cw) with wp[0] the tf32 hi
// part (rounded as `split_tf32_int` rounds) and wp[1] the rest, for the
// layer's weight w (O, I, 3, 3): GEMM column n, channel c of tap (ky, kx) is
// w[n][c][ky][kx] for the forward, w[c][n][2 - ky][2 - kx] for the input
// gradient; zero past the weight's own channels, up to whole tiles (Nw a
// multiple of the tile's columns, Cw of 32), so that no load of it leaves
// the tensor (TMA fills zeros past a tensor's end at a fraction of its
// rate)
__global__ void conv3x3_wide_prep(const float* __restrict__ w,
                                  float* __restrict__ wp, int N, int Cin,
                                  int O, int I, int input_grad) {
  const long long total = static_cast<long long>(N) * 9 * Cin;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % Cin);
    const int tap = static_cast<int>((i / Cin) % 9);
    const int n = static_cast<int>(i / (9LL * Cin));
    float v = 0.f;
    if (!input_grad && n < O && c < I)
      v = w[(static_cast<long long>(n) * I + c) * 9 + tap];
    else if (input_grad && n < I && c < O)
      v = w[(static_cast<long long>(c) * I + n) * 9 + 8 - tap];
    uint32_t hi, lo;
    split_tf32_int(v, hi, lo);
    wp[i] = __uint_as_float(hi);
    wp[total + i] = __uint_as_float(lo);
  }
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// a 4-d fp32 tensor map, dims innermost first, 128-byte swizzle, zeros
// outside the tensor
bool tensor_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                const cuuint32_t (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t strides[3] = {dims[0] * 4, dims[0] * dims[1] * 4,
                                 dims[0] * dims[1] * dims[2] * 4};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const float* x, const float* wp, const float* bias, float* out,
           int B, int H, int W, int Cin, int N, int relu, cudaStream_t stream) {
  using C = Cfg<BN>;
  const long long tiles = (long long)B * ((H + C::kBoxH - 1) / C::kBoxH) *
                          ((W + kBoxW - 1) / kBoxW) * ((N + BN - 1) / BN);
  if (tiles * 9 * ((Cin + kBK - 1) / kBK) >= (1LL << 31))  // a 32-bit count
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, x, {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B},
                  {(cuuint32_t)kBK, (cuuint32_t)kBoxW, (cuuint32_t)C::kBoxH, 1}) ||
      !tensor_map(&tm_w, wp, {(cuuint64_t)round_up(Cin, kBK), 9,
                              (cuuint64_t)round_up(N, BN), 2},
                  {(cuuint32_t)kBK, 1, (cuuint32_t)BN, 1}))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wide_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv3x3_wide_kernel<BN><<<grid, kThreads, C::kSmem, stream>>>(
      tm_x, tm_w, bias, out, B, H, W, Cin, N, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) fp32; w (O, I, 3, 3) fp32, the layer's weight; bias
// (N,) fp32 or null; wp fp32 scratch for the split weight, of
// `stx_conv3x3_wide_scratch(N, Cin)` floats;
// out (B, H, W, N) fp32; all contiguous and 16-byte aligned, Cin and N
// multiples of 4. input_grad 0: out = conv(x, w) + bias, N >= O, Cin >= I;
// 1: out = the input gradient from x, the gradient to the layer's output,
// N >= I, Cin >= O. relu: 1 to apply a ReLU to out.
extern "C" int stx_conv3x3_wide(const void* x, const void* w, const void* bias,
                                void* wp, void* out, int B, int H, int W,
                                int Cin, int N, int O, int I, int input_grad,
                                int relu, void* stream) {
  const int n_eff = input_grad ? I : O, c_eff = input_grad ? O : I;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 4 != 0 || N <= 0 ||
      N % 4 != 0 || n_eff > N || c_eff > Cin || O <= 0 || I <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Nw = round_up(N, tile_n(N)), Cw = round_up(Cin, kBK);
  const long long total = 9LL * Nw * Cw;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  conv3x3_wide_prep<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<float*>(wp), Nw, Cw, O, I,
      input_grad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wp);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  switch (tile_n(N)) {
    case 16: return launch<16>(xf, wf, bf, of, B, H, W, Cin, N, relu, st);
    case 64: return launch<64>(xf, wf, bf, of, B, H, W, Cin, N, relu, st);
    default: return launch<128>(xf, wf, bf, of, B, H, W, Cin, N, relu, st);
  }
}

// floats of the weight's scratch `wp` for N output channels and Cin input
// channels: 2 x Nw x 9 x Cw
extern "C" long long stx_conv3x3_wide_scratch(int N, int Cin) {
  return 2LL * round_up(N, tile_n(N)) * 9 * round_up(Cin, kBK);
}
