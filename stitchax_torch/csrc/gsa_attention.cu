// K1: fused global-subsample attention (twins GSA core).
//
// Replaces the TPU kernel `gsa_attention_pallas`
// (stitchax/ops/pallas/gsa_attention.py:51, body `_kernel` :26).
//
// out[b, n, h*d:(h+1)*d] = softmax_j(q_bh[n] . k_bh[j] * d^-0.5) @ v_bh
// for q (B, N, C), k/v (B, M, C), C = heads * d; softmax in fp32, output in
// q's dtype, and no (B, heads, N, M) logits ever reach device memory.
//
// What bounds it on the H100: at the main-path shapes (M = 256, d = 16/32)
// the work is 4*N*M*C flops against the 2*2*N*C bytes of reading q and
// writing out in bf16 (plus K/V, small), i.e. ~M = 256 flops per byte --
// just below the card's ~295 flops/byte ridge (989 TFLOP/s bf16 tensor over
// 3.35 TB/s), so even a tensor-core kernel is bound by HBM bytes, with the
// tensor-core time close behind. This first kernel runs on the fp32 CUDA
// cores (67 TFLOP/s), which makes it operation-bound in practice, far from
// both limits, with the tensor cores idle.
//
// Design: one block per (query tile of 128 rows, head, batch). The head's
// K and V slices (M x d, storage dtype) are staged once in shared memory;
// every thread owns one query row, keeps q and the d-wide accumulator in
// registers, and makes two passes over the keys (max, then exp-sum and the
// weighted sum of V), reading K/V rows as shared-memory broadcasts. The
// TPU kernel's per-head channel mask (8x redundant FLOPs to fill the MXU)
// is not carried over. wgmma/TMA tiling is later work.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;  // query rows (threads) per block

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
gsa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     int N, int M, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + M * D;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const T* kb = k + (size_t)b * M * C + (size_t)h * D;
  const T* vb = v + (size_t)b * M * C + (size_t)h * D;
  for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
    const int j = i / D, c = i - (i / D) * D;
    ks[i] = kb[(size_t)j * C + c];
    vs[i] = vb[(size_t)j * C + c];
  }
  __syncthreads();

  const int n = blockIdx.x * kRows + threadIdx.x;
  if (n >= N) return;

  const T* qp = q + ((size_t)b * N + n) * C + (size_t)h * D;
  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = stx_to_f(qp[c]);

  float mx = -INFINITY;
  for (int j = 0; j < M; ++j) {
    const T* kj = ks + j * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], stx_to_f(kj[c]), s);
    mx = fmaxf(mx, s * scale);
  }

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float sum = 0.f;
  for (int j = 0; j < M; ++j) {
    const T* kj = ks + j * D;
    const T* vj = vs + j * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], stx_to_f(kj[c]), s);
    const float p = expf(s * scale - mx);
    sum += p;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = fmaf(p, stx_to_f(vj[c]), acc[c]);
  }

  const float inv = 1.f / sum;
  T* op = out + ((size_t)b * N + n) * C + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = stx_from_f<T>(acc[c] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int N, int M, int C, int heads,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)M * D * sizeof(T);
  auto kernel = gsa_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, heads, B);
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N, M, C, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, N, C), k/v (B, M, C), out (B, N, C), all contiguous, one dtype.
// Returns a cudaError_t code (0 on success).
extern "C" int stx_gsa_attention(const void* q, const void* k, const void* v,
                                 void* out, int B, int N, int M, int C,
                                 int heads, int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0 || M <= 0 || M > 256 || N <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == STX_BFLOAT16) {
    if (d == 16) return (int)launch<__nv_bfloat16, 16>(q, k, v, out, B, N, M, C, heads, s);
    if (d == 32) return (int)launch<__nv_bfloat16, 32>(q, k, v, out, B, N, M, C, heads, s);
  } else if (dtype == STX_FLOAT32) {
    if (d == 16) return (int)launch<float, 16>(q, k, v, out, B, N, M, C, heads, s);
    if (d == 32) return (int)launch<float, 32>(q, k, v, out, B, N, M, C, heads, s);
  }
  return (int)cudaErrorInvalidValue;
}
