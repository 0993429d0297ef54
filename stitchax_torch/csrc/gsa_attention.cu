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
// 3.35 TB/s), so the kernel is bound by bytes with the tensor-core time
// close behind. With d this small the softmax's exponentials (one per
// query and key, N*M*heads of them) are the next limit: the special-function
// units issue far fewer of them per clock than the tensor cores do products.
//
// bf16 design (tensor cores, `mma.sync.m16n8k16` bf16 with fp32
// accumulators): one block per (tile of kWarps*16*kTiles query rows, head,
// batch), 8 warps. The head's K (M x d, row-major) and V (transposed,
// d x M) are staged once in shared memory, padded so that every fragment
// load is one 32-bit word with no bank conflicts, with zero rows up to the
// next 64 keys. Each warp owns 16 query rows at a time: its q fragment stays
// in registers, and for each chunk of 64 keys it computes S = q K^T once on
// the tensor cores, masks keys past M, keeps a running row max and sum
// (online softmax, in the exp2 domain), rescales its output accumulators
// and adds P V with P rounded to bf16, reusing S's accumulator layout as
// the A fragment of the second product. The logits never leave registers
// and each q.k product is formed once. The row sum is taken over the
// bf16-rounded P, so the weights that multiply V are exactly normalised.
// The TPU kernel's per-head channel mask (8x redundant FLOPs to fill the
// MXU) is not carried over.
//
// fp32 inputs keep an exact fp32 path on the CUDA cores (TF32 would cost
// three digits of the fp32 comparisons): one thread per query row, two
// passes over the staged keys (max, then exp-sum and the weighted sum).

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxKeys = 256;

// ------------------------------ fp32 path -----------------------------------

constexpr int kRows = 128;  // query rows (threads) per block

template <int D>
__global__ void __launch_bounds__(kRows)
gsa_attention_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int N, int M, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + M * D;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const float* kb = k + (size_t)b * M * C + (size_t)h * D;
  const float* vb = v + (size_t)b * M * C + (size_t)h * D;
  for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
    const int j = i / D, c = i - (i / D) * D;
    ks[i] = kb[(size_t)j * C + c];
    vs[i] = vb[(size_t)j * C + c];
  }
  __syncthreads();

  const int n = blockIdx.x * kRows + threadIdx.x;
  if (n >= N) return;

  const float* qp = q + ((size_t)b * N + n) * C + (size_t)h * D;
  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = qp[c];

  float mx = -INFINITY;
  for (int j = 0; j < M; ++j) {
    const float* kj = ks + j * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], kj[c], s);
    mx = fmaxf(mx, s * scale);
  }

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float sum = 0.f;
  for (int j = 0; j < M; ++j) {
    const float* kj = ks + j * D;
    const float* vj = vs + j * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], kj[c], s);
    const float p = expf(s * scale - mx);
    sum += p;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vj[c], acc[c]);
  }

  const float inv = 1.f / sum;
  float* op = out + ((size_t)b * N + n) * C + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = acc[c] * inv;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int N, int M, int C, int heads,
                       cudaStream_t stream) {
  auto kernel = gsa_attention_f32_kernel<D>;
  // above 48 KiB (d = 32 at M = 256) the dynamic shared memory needs the
  // attribute; it is set once, for the largest M the kernel takes
  constexpr int kMaxSmem = 2 * kMaxKeys * D * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = 2 * (size_t)M * D * sizeof(float);
  const dim3 grid((N + kRows - 1) / kRows, heads, B);
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<grid, kRows, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, M, C, scale);
  return cudaGetLastError();
}

// --------------------------- bf16 tensor-core path ---------------------------

constexpr int kWarps = 8;     // warps per block, 16 query rows each
constexpr int kTiles = 2;     // 16-row tiles per warp (K/V staged once for all)
constexpr int kChunk = 64;    // keys per online-softmax step
constexpr int kBlockRows = kWarps * 16 * kTiles;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
gsa_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int N, int M, int C,
                         float scale_log2) {
  constexpr int KS = D + 8;  // K row stride (bf16): conflict-free B loads
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const int VS = Mp + 8;     // V^T row stride (bf16)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vt = ks + Mp * KS;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const __nv_bfloat16* kb = k + (size_t)b * M * C + (size_t)h * D;
  const __nv_bfloat16* vb = v + (size_t)b * M * C + (size_t)h * D;
  // stage K as is and V transposed, 8 values (16 bytes) per load; keys
  // past M are zero (their logits are masked, and 0 * 0 adds nothing)
  for (int i = threadIdx.x; i < Mp * (D / 8); i += blockDim.x) {
    const int j = i / (D / 8), c8 = (i - j * (D / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (j < M) {
      kv = *reinterpret_cast<const uint4*>(kb + (size_t)j * C + c8);
      vv = *reinterpret_cast<const uint4*>(vb + (size_t)j * C + c8);
    }
    *reinterpret_cast<uint4*>(ks + j * KS + c8) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(c8 + e) * VS + j] = ve[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair

  for (int tile = 0; tile < kTiles; ++tile) {
    const int row0 = blockIdx.x * kBlockRows + (tile * kWarps + warp) * 16;
    if (row0 >= N) break;  // warp-uniform
    const int ra = row0 + g, rb = row0 + g + 8;
    const __nv_bfloat16* qa_p = q + ((size_t)b * N + ra) * C + (size_t)h * D;
    const __nv_bfloat16* qb_p = q + ((size_t)b * N + rb) * C + (size_t)h * D;

    // q fragments (A, 16 x d): rows g / g+8, columns 2t, 2t+1 (+8)
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = ra < N ? ld32(qa_p + c) : 0u;
      qf[kk][1] = rb < N ? ld32(qb_p + c) : 0u;
      qf[kk][2] = ra < N ? ld32(qa_p + c + 8) : 0u;
      qf[kk][3] = rb < N ? ld32(qb_p + c + 8) : 0u;
    }

    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g / g+8
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sum

    for (int kc = 0; kc < Mp; kc += kChunk) {
      // S = q K^T for 64 keys: 8 tiles of 16 x 8
      float s[kChunk / 8][4];
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* kr = ks + (kc + nt * 8 + g) * KS + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
      // scale to the exp2 domain, mask keys past M, running max
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const int key = kc + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = key + (e & 1) < M ? s[nt][e] * scale_log2 : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // the first chunk holds key 0, so mx is finite from here on
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= a0;
        o[dn][1] *= a0;
        o[dn][2] *= a1;
        o[dn][3] *= a1;
      }
      // P in bf16, laid out as the A fragments of P V (16 keys each)
      uint32_t pf[kChunk / 16][4];
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(
            exp2f(s[nt][0] - m0), exp2f(s[nt][1] - m0));
        const __nv_bfloat162 p23 = __floats2bfloat162_rn(
            exp2f(s[nt][2] - m1), exp2f(s[nt][3] - m1));
        const float2 f01 = __bfloat1622float2(p01);
        const float2 f23 = __bfloat1622float2(p23);
        l0 += f01.x + f01.y;
        l1 += f23.x + f23.y;
        pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p01);
        pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p23);
      }
      // O += P V: V^T rows are output columns, keys contiguous
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const __nv_bfloat16* vr = vt + (dn * 8 + g) * VS + kc + kk * 16 +
                                    2 * t;
          mma_bf16(o[dn], pf[kk], ld32(vr), ld32(vr + 8));
        }
      }
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    __nv_bfloat16* oa = out + ((size_t)b * N + ra) * C + (size_t)h * D;
    __nv_bfloat16* ob = out + ((size_t)b * N + rb) * C + (size_t)h * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      if (ra < N)
        *reinterpret_cast<__nv_bfloat162*>(oa + c) =
            __floats2bfloat162_rn(o[dn][0] / l0, o[dn][1] / l0);
      if (rb < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + c) =
            __floats2bfloat162_rn(o[dn][2] / l1, o[dn][3] / l1);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int N, int M, int C, int heads,
                        cudaStream_t stream) {
  // at most 256 * 40 + 32 * 264 bf16 = 37 KiB: no attribute needed
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const size_t smem = ((size_t)Mp * (D + 8) + (size_t)D * (Mp + 8)) *
                      sizeof(__nv_bfloat16);
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, heads, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  gsa_attention_mma_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), N, M, C, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q (B, N, C), k/v (B, M, C), out (B, N, C), all contiguous, one dtype.
// Returns a cudaError_t code (0 on success).
extern "C" int stx_gsa_attention(const void* q, const void* k, const void* v,
                                 void* out, int B, int N, int M, int C,
                                 int heads, int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0 || M <= 0 || M > kMaxKeys || N <= 0 ||
      B <= 0)
    return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == STX_BFLOAT16) {
    if (d == 16) return (int)launch_bf16<16>(q, k, v, out, B, N, M, C, heads, s);
    if (d == 32) return (int)launch_bf16<32>(q, k, v, out, B, N, M, C, heads, s);
  } else if (dtype == STX_FLOAT32) {
    if (d == 16) return (int)launch_f32<16>(q, k, v, out, B, N, M, C, heads, s);
    if (d == 32) return (int)launch_f32<32>(q, k, v, out, B, N, M, C, heads, s);
  }
  return (int)cudaErrorInvalidValue;
}
