// K4: windowed (LSA) multi-head attention with per-window-position biases.
//
// Replaces the TPU kernel `window_attention_pallas`
// (tools/exp_window_attn.py:96, body `_kernel` :48), which computes
// stitchax's `window_attention_split` (stitchax/ops/window_attention.py:53).
//
// For bias-free projected streams qx/kx/vx (B, H, W, C), C = heads * d,
// the map is cut into ws x ws windows after zero padding H and W up to
// multiples of ws; at window position t the streams get q_bias[t],
// k_bias[t] (ws*ws, C) and v_bias (1, C) added, rounded to the stream's
// type as stitchax adds them. A padded position has a zero stream, so its
// q/k/v are exactly the biases: it takes part as a key and a value like any
// other token (the reference pads before projecting) -- nothing is masked.
// Each window and head then runs softmax(q k^T * d^-0.5) v over its T =
// ws*ws tokens; only the H x W valid outputs are written.
//
// What bounds it on the H100: per window 4*T*T*C flops against 8*C bytes
// per token in bf16 (q, k, v read once, out written once), i.e. about
// 4*T/8 = 25 flops per byte at T = 49 -- far below the card's ~295
// flops/byte ridge, so the bound is HBM bytes. Reading the streams where
// they lie (each takes its own token stride, so the three strided views of
// one fused qkv product are read in place) and adding the biases in the
// kernel removes the plain version's pad, partition, bias and merge copies.
// What holds the bf16 kernel above that bound is the instruction rate and
// latency of each warp's dependent chain per row tile (fragment loads,
// mma, row max, shuffles, exponentials, mma): neither deeper staging
// (cp.async) nor more resident warps moved it on the card (PERF.md).
//
// bf16 design (tensor cores, `mma.sync.m16n8k16` bf16 with fp32
// accumulators, as K1), templated on the window size so that every tile
// count and mask is known to the compiler: one block of 8 warps per
// (window, group of heads). It stages the group's biased Q, K and V as 64
// rows each in shared memory, row-major with rows padded by 16 bytes so
// that every `ldmatrix` is conflict-free: each token's channels are read
// with 16-byte loads, neighbouring threads on neighbouring addresses (each
// stream has channel stride 1, fused or not), the bias is added in fp32
// and the sum rounded to bf16; rows past T are zero. Each warp then owns
// one (head, 16-row tile) at a time: S = Q K^T (16 x T) in registers, only
// the tile padding (keys >= T) masked, the exact row max in one pass (all
// keys fit, so no online rescale), P = 2^(S * scale * log2 e - max) on the
// special-function unit and rounded to bf16 as the A fragment of P V, V's
// B fragments by `ldmatrix.trans`, P's row sums as P times a ones matrix
// on the tensor cores, the output normalised by that sum of the rounded P
// and rounded once. It goes back through the warp's own Q rows in shared
// memory and out with 16-byte stores, valid tokens only. A group holds at
// most 128 channels (52 KB of shared memory), and heads are split further
// while the grid would leave SMs idle (the B = 1, 64^2 call has 100
// windows for 132 SMs). The flop time is about 50x below the byte time, so
// the last row tile's idle rows cost nothing that shows; its rows past T
// take no exponentials.
//
// fp32 design (tensor cores in 3xTF32, `mma.sync.m16n8k8` tf32 with fp32
// accumulators, as K1's fp32 path; common.cuh): one TF32 pass would cost
// three digits of the fp32 comparisons, so each product a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi of the operands split into tf32 hi and
// lo parts. The blocking is the bf16 path's, one block of 8 warps per
// (window, group of heads <= 64 channels, so that two blocks share an SM),
// templated on the window size. It reads the group's q, k and v rows where
// they lie, 16 bytes a load for all heads of the group at once, adds the
// biases in fp32 and stores Q and K (rows to the next 16 / 8, zero past T)
// and V^T in shared memory already split, as 16-byte chunks {hi, hi, lo,
// lo} of two neighbouring channels (Q, K) or tokens (V^T), each row 16
// words past a multiple of 32 so that every fragment load is one
// conflict-free 16-byte load. Each warp then owns one (head, 16-row tile)
// at a time: S = Q K^T in three products a tile over the keys padded to
// the next 8, only the tile padding masked (padding is not masking), the
// exact row max in one pass, P = 2^(S * scale * log2 e - max), and P V in
// three more products with P split and S's accumulators used in place as
// its A fragment (each 8-step's k order relabelled, k = t as 2t and t+4 as
// 2t+1, so that no value changes lanes). The row sums take the unsplit P;
// the output is normalised once and the valid tokens' rows written
// straight out, 8 bytes a lane. At 4*T/16 = 12 flops per byte in fp32 the
// bound stays the bytes; the TF32 products keep the arithmetic out of
// their way. The TPU kernel's strips and per-head channel masks (heads-fold
// redundant work to fill the MXU) are not carried over.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxTokens = 64;  // ws*ws: four 16-row tiles

// --------------------------- bf16 tensor-core path ---------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 128;  // channels of one block's group of heads
// Q, K and V of 64 rows at the largest group
constexpr int kMaxSmem = 3 * kMaxTokens * (kMaxGroup + 8) * 2;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// 8 bf16 stream values plus 8 bf16 biases, added in fp32 and rounded to
// bf16 (as stitchax adds them in the stream's type)
__device__ __forceinline__ uint4 add_bias(uint4 x, uint4 bias) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&bias);
  uint4 r;
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fa = __bfloat1622float2(a[e]);
    const float2 fc = __bfloat1622float2(c[e]);
    o[e] = pack_bf16(__floats2bfloat162_rn(fa.x + fc.x, fa.y + fc.y));
  }
  return r;
}

// Four 8x8 bf16 matrices from shared memory: lanes 8m..8m+7 give the
// 16-byte row addresses of matrix m, and register m of lane (g, t) holds
// row g, columns 2t, 2t+1 of it (`.trans`: rows 2t, 2t+1 of column g) --
// mma A and B fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int D, int WS>
__global__ void __launch_bounds__(kThreads)
window_attention_mma_kernel(const bf16* __restrict__ qx,
                            const bf16* __restrict__ kx,
                            const bf16* __restrict__ vx,
                            const bf16* __restrict__ qb,
                            const bf16* __restrict__ kb,
                            const bf16* __restrict__ vb,
                            bf16* __restrict__ out, int H, int W, int C,
                            int n_win_x, int n_win_img, int group,
                            long long qs, long long ks, long long vs,
                            long long qbs, long long kbs, float scale_log2) {
  constexpr int T = WS * WS;
  constexpr int NT = (T + 7) / 8;    // 8-key tiles of S
  constexpr int KS = (T + 15) / 16;  // 16-key steps of P V
  constexpr int RT = (T + 15) / 16;  // 16-row tiles of the window
  const int CB = group * D;  // this block's channels
  const int RS = CB + 8;     // row stride (bf16): 16-byte rows, no bank
                             // conflicts on fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // later the output
  bf16* k_s = q_s + kMaxTokens * RS;
  bf16* v_s = k_s + kMaxTokens * RS;

  const int b = blockIdx.x / n_win_img;
  const int w = blockIdx.x - b * n_win_img;
  const int wy = w / n_win_x, wx = w - (w / n_win_x) * n_win_x;
  const int c0 = blockIdx.y * CB;
  const size_t img = (size_t)b * H * W;  // first token of this image
  const int cpr = CB / 8;                // 16-byte chunks per row

  // stage the biased Q, K, V; rows T..63 are zero
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kMaxTokens * cpr; i += kThreads) {
    const int j = i / cpr, c = (i - j * cpr) * 8;
    uint4 q4 = zero, k4 = zero, v4 = zero;
    if (j < T) {
      const int y = wy * WS + j / WS, x = wx * WS + j % WS;
      if (y < H && x < W) {
        const size_t tok = img + (size_t)y * W + x;
        q4 = ld16(qx + tok * qs + c0 + c);
        k4 = ld16(kx + tok * ks + c0 + c);
        v4 = ld16(vx + tok * vs + c0 + c);
      }
      q4 = add_bias(q4, ld16(qb + j * qbs + c0 + c));
      k4 = add_bias(k4, ld16(kb + j * kbs + c0 + c));
      v4 = add_bias(v4, ld16(vb + c0 + c));
    }
    st16(q_s + j * RS + c, q4);
    st16(k_s + j * RS + c, k4);
    st16(v_s + j * RS + c, v4);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;  // fragment column pair (rows g = lane >> 2)
  const uint32_t ones = 0x3f803f80u;  // two bf16 1.0: B fragment of a
                                      // ones matrix, for P's row sums
  for (int item = warp; item < group * RT; item += kWarps) {
    const int h = item / RT, rt = item - (item / RT) * RT;
    const int ch = h * D;                  // the head's first channel
    const int ra = rt * 16 + (lane >> 2), rb = ra + 8;

    // q fragments (A, 16 x d): lanes 0-15 address rows rt*16 + lane,
    // lanes 16-31 the same rows 8 channels on
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], q_s + (rt * 16 + (lane & 15)) * RS + ch + kk * 16 +
                              (lane >> 4) * 8);

    // S = q K^T over the window's key tiles; one ldmatrix gives the B
    // fragments of two 8-key tiles (rows past T are staged zeros)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_s + ((nt + (lane >> 4)) * 8 + (lane & 7)) * RS + ch +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
        if (nt + 1 < NT) mma_bf16(s[nt + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask only the tile padding (keys >= T), then the exact row max
    float mx0 = -INFINITY, mx1 = -INFINITY;  // rows ra / rb
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if ((nt + 1) * 8 > T) {
        const int key = nt * 8 + 2 * t;
        if (key >= T) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= T) s[nt][1] = s[nt][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // in the exp2 domain: scale_log2 > 0 keeps the max the max
    const float m0 = mx0 * scale_log2, m1 = mx1 * scale_log2;

    // P = 2^(s * scale_log2 - m) in bf16, laid out as the A fragments of
    // P V (16 keys each); tiles past the keys are zero, and rows rb take
    // no exponentials when all of them are padding (the last tile at
    // T = 49)
    const bool rb_live = rt * 16 + 8 < T;  // warp-uniform
    uint32_t pf[KS][4];
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
      uint32_t p01 = 0u, p23 = 0u;
      if (nt < NT) {
        p01 = pack_bf16(__floats2bfloat162_rn(
            ex2_ftz(fmaf(s[nt][0], scale_log2, -m0)),
            ex2_ftz(fmaf(s[nt][1], scale_log2, -m0))));
        if (rb_live)
          p23 = pack_bf16(__floats2bfloat162_rn(
              ex2_ftz(fmaf(s[nt][2], scale_log2, -m1)),
              ex2_ftz(fmaf(s[nt][3], scale_log2, -m1))));
      }
      pf[nt / 2][(nt & 1) * 2 + 0] = p01;
      pf[nt / 2][(nt & 1) * 2 + 1] = p23;
    }

    // O = P V, and P's row sums as P times a ones matrix, both on the
    // tensor cores (fp32 sums of the rounded P); lanes 0-15 address keys
    // kk*16 + lane of output columns dn*8.., lanes 16-31 the same keys of
    // columns (dn+1)*8..
    float o[D / 8][4], l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_bf16(l, pf[kk], ones, ones);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_s + (kk * 16 + (lane & 15)) * RS + ch +
                                  dn * 8 + (lane >> 4) * 8);
        mma_bf16(o[dn], pf[kk], vf[0], vf[1]);
        mma_bf16(o[dn + 1], pf[kk], vf[2], vf[3]);
      }
    }

    // normalise by the rounded P's sum, round once, and park the rows in
    // this warp's own Q tile (no other warp reads it)
    const float i0 = 1.f / l[0], i1 = 1.f / l[2];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = ch + dn * 8 + 2 * t;
      if (ra < T)
        *reinterpret_cast<__nv_bfloat162*>(q_s + ra * RS + c) =
            __floats2bfloat162_rn(o[dn][0] * i0, o[dn][1] * i0);
      if (rb < T)
        *reinterpret_cast<__nv_bfloat162*>(q_s + rb * RS + c) =
            __floats2bfloat162_rn(o[dn][2] * i1, o[dn][3] * i1);
    }
  }
  __syncthreads();

  // the valid tokens' outputs, 16 bytes a thread
  for (int i = threadIdx.x; i < T * cpr; i += kThreads) {
    const int j = i / cpr, c = (i - j * cpr) * 8;
    const int y = wy * WS + j / WS, x = wx * WS + j % WS;
    if (y < H && x < W)
      st16(out + (img + (size_t)y * W + x) * C + c0 + c,
           ld16(q_s + j * RS + c));
  }
}

template <int D, int WS>
cudaError_t launch_bf16_ws(const bf16* qx, const bf16* kx, const bf16* vx,
                           const bf16* qb, const bf16* kb, const bf16* vb,
                           bf16* out, int B, int H, int W, int C, int heads,
                           long long qs, long long ks, long long vs,
                           long long qbs, long long kbs,
                           cudaStream_t stream) {
  auto kernel = window_attention_mma_kernel<D, WS>;
  // above 48 KiB (a group of 128 channels) the dynamic shared memory needs
  // the attribute; it is set once, for the largest group
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;

  const int nwy = (H + WS - 1) / WS, nwx = (W + WS - 1) / WS;
  const long long n_win = (long long)B * nwy * nwx;
  if (n_win > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the largest group of heads within kMaxGroup channels, halved while the
  // grid would be under two blocks per SM
  int group = heads;
  while (group > 1 && (heads % group != 0 || group * D > kMaxGroup)) --group;
  while (group % 2 == 0 && n_win * (heads / group) < 2LL * n_sm) group /= 2;

  const size_t smem = (size_t)3 * kMaxTokens * (group * D + 8) * sizeof(bf16);
  const dim3 grid((unsigned)n_win, heads / group);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, kThreads, smem, stream>>>(
      qx, kx, vx, qb, kb, vb, out, H, W, C, nwx, nwy * nwx, group, qs, ks,
      vs, qbs, kbs, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* qx, const void* kx, const void* vx,
                        const void* qb, const void* kb, const void* vb,
                        void* out, int B, int H, int W, int C, int heads,
                        int ws, long long qs, long long ks, long long vs,
                        long long qbs, long long kbs, cudaStream_t stream) {
#define STX_WS(WS)                                                          \
  case WS:                                                                  \
    return launch_bf16_ws<D, WS>(                                           \
        static_cast<const bf16*>(qx), static_cast<const bf16*>(kx),         \
        static_cast<const bf16*>(vx), static_cast<const bf16*>(qb),         \
        static_cast<const bf16*>(kb), static_cast<const bf16*>(vb),         \
        static_cast<bf16*>(out), B, H, W, C, heads, qs, ks, vs, qbs, kbs,   \
        stream)
  switch (ws) {
    STX_WS(1); STX_WS(2); STX_WS(3); STX_WS(4);
    STX_WS(5); STX_WS(6); STX_WS(7); STX_WS(8);
  }
#undef STX_WS
  return cudaErrorInvalidValue;
}

// ------------------------- fp32 path (3xTF32) --------------------------------

constexpr int kF32MaxGroup = 64;  // channels of one block's group of heads

// 16 words past a multiple of 32 at or above 2 * n: the stride of a row of
// n / 2 chunks {hi, hi, lo, lo} that a quarter warp (two rows, four chunks
// each) loads without a bank conflict
__host__ __device__ constexpr int f32_stride(int n) {
  return (2 * n + 15) / 32 * 32 + 16;
}

// Shared memory of one block (32-bit words): Q (RT*16 rows) and K (TP
// rows) as rows of CB/2 chunks (channels 2c, 2c+1 of one token), V^T as
// CB rows of TP/2 chunks (tokens 2p, 2p+1 of one channel).
template <int WS>
__host__ __device__ constexpr int f32_smem_words(int CB) {
  return ((WS * WS + 15) / 16 * 16 + (WS * WS + 7) / 8 * 8) * f32_stride(CB) +
         CB * f32_stride((WS * WS + 7) / 8 * 8);
}

// x, four fp32 values, split and stored as the chunks of channels (or
// tokens) 2c, 2c+1 and 2c+2, 2c+3 of one row
__device__ __forceinline__ void st_split4(uint32_t* row, int c, float4 x) {
  uint4* r = reinterpret_cast<uint4*>(row) + c / 2;
  r[0] = split_pair(x.x, x.y);
  r[1] = split_pair(x.z, x.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, int WS>
__global__ void __launch_bounds__(kThreads, 2)
window_attention_tf32_kernel(const float* __restrict__ qx,
                             const float* __restrict__ kx,
                             const float* __restrict__ vx,
                             const float* __restrict__ qb,
                             const float* __restrict__ kb,
                             const float* __restrict__ vb,
                             float* __restrict__ out, int H, int W, int C,
                             int n_win_x, int n_win_img, int group,
                             long long qs, long long ks, long long vs,
                             long long qbs, long long kbs, float scale_log2) {
  constexpr int T = WS * WS;
  constexpr int NT = (T + 7) / 8;    // 8-key tiles of S, 8-key steps of P V
  constexpr int TP = NT * 8;         // keys, padded
  constexpr int RT = (T + 15) / 16;  // 16-row tiles of the window
  constexpr int VRS = f32_stride(TP);
  const int CB = group * D;          // this block's channels
  const int RS = f32_stride(CB);     // Q / K row stride (words)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* k_s = q_s + RT * 16 * RS;
  uint32_t* v_s = k_s + TP * RS;

  const int b = blockIdx.x / n_win_img;
  const int w = blockIdx.x - b * n_win_img;
  const int wy = w / n_win_x, wx = w - (w / n_win_x) * n_win_x;
  const int c0 = blockIdx.y * CB;
  const size_t img = (size_t)b * H * W;  // first token of this image
  const int cpr = CB / 4;                // 16-byte loads per row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the biased Q and K, split, 16 bytes a load with neighbouring threads on
  // neighbouring channels of a token; a padded position's q and k are its
  // biases, rows past T are zero
#pragma unroll 2
  for (int i = threadIdx.x; i < RT * 16 * cpr; i += kThreads) {
    const int j = i / cpr, c = (i - j * cpr) * 4;
    float4 q4 = zero, k4 = zero;
    if (j < T) {
      const int y = wy * WS + j / WS, x = wx * WS + j % WS;
      if (y < H && x < W) {
        const size_t tok = img + (size_t)y * W + x;
        q4 = ldg4(qx + tok * qs + c0 + c);
        k4 = ldg4(kx + tok * ks + c0 + c);
      }
      q4 = add4(q4, ldg4(qb + j * qbs + c0 + c));
      k4 = add4(k4, ldg4(kb + j * kbs + c0 + c));
    }
    st_split4(q_s + j * RS, c, q4);
    if (j < TP) st_split4(k_s + j * RS, c, k4);
  }
  // the biased V^T, split: two tokens' 4 channels a thread, neighbouring
  // threads on neighbouring token pairs (conflict-free chunk stores)
#pragma unroll 2
  for (int i = threadIdx.x; i < (TP / 2) * cpr; i += kThreads) {
    const int cc = i / (TP / 2), p = i - cc * (TP / 2), c = cc * 4;
    float4 v2[2] = {zero, zero};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * p + e;
      if (j < T) {
        const int y = wy * WS + j / WS, x = wx * WS + j % WS;
        if (y < H && x < W) v2[e] = ldg4(vx + (img + (size_t)y * W + x) * vs +
                                         c0 + c);
        v2[e] = add4(v2[e], ldg4(vb + c0 + c));
      }
    }
    uint4* col = reinterpret_cast<uint4*>(v_s + c * VRS) + p;
    col[0] = split_pair(v2[0].x, v2[1].x);
    col[VRS / 4] = split_pair(v2[0].y, v2[1].y);
    col[VRS / 2] = split_pair(v2[0].z, v2[1].z);
    col[3 * VRS / 4] = split_pair(v2[0].w, v2[1].w);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  for (int item = warp; item < group * RT; item += kWarps) {
    const int h = item / RT, rt = item - (item / RT) * RT;
    const int ch = h * D;  // the head's first channel in the group
    const int ra = rt * 16 + g, rb = ra + 8;

    // q fragments, split: rows ra / rb, channels 2t, 2t+1 of each 8-step
    uint32_t qh[D / 8][4], ql[D / 8][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint4 xa = lds128(q_s + ra * RS + 2 * ch + kk * 16 + 4 * t);
      const uint4 xb = lds128(q_s + rb * RS + 2 * ch + kk * 16 + 4 * t);
      qh[kk][0] = xa.x; qh[kk][1] = xb.x; qh[kk][2] = xa.y; qh[kk][3] = xb.y;
      ql[kk][0] = xa.z; ql[kk][1] = xb.z; ql[kk][2] = xa.w; ql[kk][3] = xb.w;
    }

    // S = q K^T over the window's key tiles (rows past T are zeros)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint32_t* kr = k_s + (nt * 8 + g) * RS + 2 * ch + 4 * t;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_3xtf32(s[nt], qh[kk], ql[kk], lds128(kr + kk * 16));
    }

    // mask only the tile padding (keys >= T), then the exact row max
    float mx0 = -INFINITY, mx1 = -INFINITY;  // rows ra / rb
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if ((nt + 1) * 8 > T) {
        const int key = nt * 8 + 2 * t;
        if (key >= T) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= T) s[nt][1] = s[nt][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // in the exp2 domain: scale_log2 > 0 keeps the max the max
    const float m0 = mx0 * scale_log2, m1 = mx1 * scale_log2;

    // O = P V, 8 keys a step, with S tile nt's registers {c0, c2, c1, c3},
    // split, as P's A fragment (keys 2t, 2t+1 as k = t, t+4) and V^T's
    // chunk of those keys as the B fragment; rows rb take no exponentials
    // when all of them are padding (the last tile at T = 49)
    const bool rb_live = rt * 16 + 8 < T;  // warp-uniform
    float o[D / 8][4], l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    const uint32_t* vr = v_s + (ch + g) * VRS + 4 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = ex2_ftz(fmaf(s[nt][0], scale_log2, -m0));
      const float p1 = ex2_ftz(fmaf(s[nt][1], scale_log2, -m0));
      float p2 = 0.f, p3 = 0.f;
      if (rb_live) {
        p2 = ex2_ftz(fmaf(s[nt][2], scale_log2, -m1));
        p3 = ex2_ftz(fmaf(s[nt][3], scale_log2, -m1));
      }
      l0 += p0 + p1;
      l1 += p2 + p3;
      uint32_t ph[4], pl[4];
      split_tf32(p0, ph[0], pl[0]);
      split_tf32(p2, ph[1], pl[1]);
      split_tf32(p1, ph[2], pl[2]);
      split_tf32(p3, ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma_3xtf32(o[dn], ph, pl, lds128(vr + dn * 8 * VRS + nt * 16));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

    // normalise once and write the valid tokens' rows, 8 bytes a lane (a
    // quad writes a row's 32-byte sector of each 8 output channels)
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? rb : ra;
      if (j >= T) continue;
      const int y = wy * WS + j / WS, x = wx * WS + j % WS;
      if (y >= H || x >= W) continue;
      float* op = out + (img + (size_t)y * W + x) * C + c0 + ch + 2 * t;
      const float inv = r ? i1 : i0;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(op + dn * 8) =
            make_float2(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
  }
}

template <int D, int WS>
cudaError_t launch_f32_ws(const float* qx, const float* kx, const float* vx,
                          const float* qb, const float* kb, const float* vb,
                          float* out, int B, int H, int W, int C, int heads,
                          long long qs, long long ks, long long vs,
                          long long qbs, long long kbs, cudaStream_t stream) {
  auto kernel = window_attention_tf32_kernel<D, WS>;
  // above 48 KiB the dynamic shared memory needs the attribute (set once,
  // for the largest group); two blocks share an SM
  constexpr int kMaxSmem = f32_smem_words<WS>(kF32MaxGroup) * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  static const cudaError_t carve = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;

  const int nwy = (H + WS - 1) / WS, nwx = (W + WS - 1) / WS;
  const long long n_win = (long long)B * nwy * nwx;
  if (n_win > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the largest group of heads within kF32MaxGroup channels, halved while
  // the grid would be under two blocks per SM
  int group = heads;
  while (group > 1 && (heads % group != 0 || group * D > kF32MaxGroup))
    --group;
  while (group % 2 == 0 && n_win * (heads / group) < 2LL * n_sm) group /= 2;

  const size_t smem = (size_t)f32_smem_words<WS>(group * D) * 4;
  const dim3 grid((unsigned)n_win, heads / group);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, kThreads, smem, stream>>>(
      qx, kx, vx, qb, kb, vb, out, H, W, C, nwx, nwy * nwx, group, qs, ks,
      vs, qbs, kbs, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* qx, const void* kx, const void* vx,
                       const void* qb, const void* kb, const void* vb,
                       void* out, int B, int H, int W, int C, int heads,
                       int ws, long long qs, long long ks, long long vs,
                       long long qbs, long long kbs, cudaStream_t stream) {
#define STX_WS(WS)                                                          \
  case WS:                                                                  \
    return launch_f32_ws<D, WS>(                                            \
        static_cast<const float*>(qx), static_cast<const float*>(kx),       \
        static_cast<const float*>(vx), static_cast<const float*>(qb),       \
        static_cast<const float*>(kb), static_cast<const float*>(vb),       \
        static_cast<float*>(out), B, H, W, C, heads, qs, ks, vs, qbs, kbs,  \
        stream)
  switch (ws) {
    STX_WS(1); STX_WS(2); STX_WS(3); STX_WS(4);
    STX_WS(5); STX_WS(6); STX_WS(7); STX_WS(8);
  }
#undef STX_WS
  return cudaErrorInvalidValue;
}

}  // namespace

// qx/kx/vx (B, H, W, C) with channel stride 1 and token strides qs/ks/vs
// (elements; row stride W*ts, batch stride H*W*ts); q_bias/k_bias (ws*ws, C)
// with row strides qbs/kbs (0 for a broadcast row); v_bias (C); out
// (B, H, W, C) contiguous; one dtype. Every pointer is 16-byte aligned and
// every stride a multiple of 16 bytes (8 bf16, 4 fp32 values). Returns a
// cudaError_t code.
extern "C" int stx_window_attention(const void* qx, const void* kx,
                                    const void* vx, const void* qb,
                                    const void* kb, const void* vb, void* out,
                                    int B, int H, int W, int C, int heads,
                                    int ws, long long qs, long long ks,
                                    long long vs, long long qbs,
                                    long long kbs, int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0 || ws <= 0 || ws * ws > kMaxTokens ||
      B <= 0 || H <= 0 || W <= 0 || B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STX_WA(PATH, DIM)                                                   \
  return (int)PATH<DIM>(qx, kx, vx, qb, kb, vb, out, B, H, W, C, heads, ws, \
                        qs, ks, vs, qbs, kbs, s)
  if (dtype == STX_BFLOAT16) {
    if (d == 16) STX_WA(launch_bf16, 16);
    if (d == 32) STX_WA(launch_bf16, 32);
  } else if (dtype == STX_FLOAT32) {
    if (d == 16) STX_WA(launch_f32, 16);
    if (d == 32) STX_WA(launch_f32, 32);
  }
#undef STX_WA
  return (int)cudaErrorInvalidValue;
}
