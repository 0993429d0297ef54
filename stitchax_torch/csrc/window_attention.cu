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
//
// Design: one block of 64 threads per (window, head, batch). The head's
// biased K and V (T x d) are staged once in shared memory in fp32; thread
// t < T owns query row t, keeps q and the d-wide accumulator in registers
// and makes two passes over the keys (max, then exp-sum and the weighted
// sum of V), all in fp32, then rounds once to the output type. The TPU
// kernel's strips and per-head channel masks (heads-fold redundant work to
// fill the MXU) are not carried over.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;  // >= T = ws*ws for ws <= 8

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ qx, const T* __restrict__ kx,
                        const T* __restrict__ vx, const T* __restrict__ qb,
                        const T* __restrict__ kb, const T* __restrict__ vb,
                        T* __restrict__ out, int H, int W, int C, int ws,
                        int n_win_x, long long qs, long long ks,
                        long long vs, long long qbs, long long kbs,
                        float scale) {
  __shared__ float k_s[kThreads * D];
  __shared__ float v_s[kThreads * D];

  const int T_ = ws * ws;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int wy = blockIdx.x / n_win_x;
  const int wx = blockIdx.x - wy * n_win_x;
  const int c0 = h * D;
  const size_t base = (size_t)b * H * W;  // first token of this image

  for (int i = threadIdx.x; i < T_ * D; i += blockDim.x) {
    const int j = i / D, c = i - (i / D) * D;
    const int y = wy * ws + j / ws, x = wx * ws + j % ws;
    float kv = 0.f, vv = 0.f;
    if (y < H && x < W) {
      const size_t tok = base + (size_t)y * W + x;
      kv = stx_to_f(kx[tok * ks + c0 + c]);
      vv = stx_to_f(vx[tok * vs + c0 + c]);
    }
    k_s[i] = stx_round<T>(kv + stx_to_f(kb[(size_t)j * kbs + c0 + c]));
    v_s[i] = stx_round<T>(vv + stx_to_f(vb[c0 + c]));
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= T_) return;
  const int y = wy * ws + t / ws, x = wx * ws + t % ws;
  if (y >= H || x >= W) return;  // a padded query: its output is dropped
  const size_t tok = base + (size_t)y * W + x;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    qr[c] = stx_round<T>(stx_to_f(qx[tok * qs + c0 + c])
                         + stx_to_f(qb[(size_t)t * qbs + c0 + c]));

  float mx = -INFINITY;
  for (int j = 0; j < T_; ++j) {
    const float* kj = k_s + j * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], kj[c], s);
    mx = fmaxf(mx, s * scale);
  }

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float sum = 0.f;
  for (int j = 0; j < T_; ++j) {
    const float* kj = k_s + j * D;
    const float* vj = v_s + j * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], kj[c], s);
    const float p = expf(s * scale - mx);
    sum += p;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vj[c], acc[c]);
  }

  const float inv = 1.f / sum;
  T* op = out + tok * C + c0;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = stx_from_f<T>(acc[c] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* qx, const void* kx, const void* vx,
                   const void* qb, const void* kb, const void* vb, void* out,
                   int B, int H, int W, int C, int heads, int ws,
                   long long qs, long long ks, long long vs, long long qbs,
                   long long kbs, cudaStream_t stream) {
  const int nwy = (H + ws - 1) / ws, nwx = (W + ws - 1) / ws;
  const dim3 grid(nwy * nwx, heads, B);
  const float scale = 1.0f / sqrtf((float)D);
  window_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qx), static_cast<const T*>(kx),
      static_cast<const T*>(vx), static_cast<const T*>(qb),
      static_cast<const T*>(kb), static_cast<const T*>(vb),
      static_cast<T*>(out), H, W, C, ws, nwx, qs, ks, vs, qbs, kbs, scale);
  return cudaGetLastError();
}

}  // namespace

// qx/kx/vx (B, H, W, C) with channel stride 1 and token strides qs/ks/vs
// (elements; row stride W*ts, batch stride H*W*ts); q_bias/k_bias (ws*ws, C)
// with row strides qbs/kbs (0 for a broadcast row); v_bias (C); out
// (B, H, W, C) contiguous; one dtype. Returns a cudaError_t code.
extern "C" int stx_window_attention(const void* qx, const void* kx,
                                    const void* vx, const void* qb,
                                    const void* kb, const void* vb, void* out,
                                    int B, int H, int W, int C, int heads,
                                    int ws, long long qs, long long ks,
                                    long long vs, long long qbs,
                                    long long kbs, int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0 || ws <= 0 || ws * ws > kThreads ||
      B <= 0 || H <= 0 || W <= 0 || B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STX_WA(TYPE, DIM)                                                    \
  return (int)launch<TYPE, DIM>(qx, kx, vx, qb, kb, vb, out, B, H, W, C,     \
                                heads, ws, qs, ks, vs, qbs, kbs, s)
  if (dtype == STX_BFLOAT16) {
    if (d == 16) STX_WA(__nv_bfloat16, 16);
    if (d == 32) STX_WA(__nv_bfloat16, 32);
  } else if (dtype == STX_FLOAT32) {
    if (d == 16) STX_WA(float, 16);
    if (d == 32) STX_WA(float, 32);
  }
#undef STX_WA
  return (int)cudaErrorInvalidValue;
}
