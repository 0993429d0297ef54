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
// fp32 design (tensor cores in 3xTF32, `mma.sync.m16n8k8` tf32 with fp32
// accumulators; common.cuh): one TF32 pass would cost three digits of the
// fp32 comparisons, so every product a b is taken as a_lo b_hi + a_hi b_lo
// + a_hi b_hi of the operands split into tf32 hi and lo parts, about 22
// significant bits. In fp32 the work is ~M/2 = 128 flops per byte of q
// and out, above the ~49 of 3xTF32 (495 / 3 TFLOP/s over 3.35 TB/s): the
// bound is the tensor cores' TF32 rate at three products a flop, with the
// exponentials on the special-function units next. The structure is the
// bf16 path's, with one block per (f32_warps * 16 * tiles query rows,
// head, batch): the head's K (Mp x d) and V^T (d x Mp) are staged once in
// shared memory, already split, as 16-byte chunks {hi, hi, lo, lo} of two
// neighbouring channels (K) or keys (V^T), with zero keys up to the next
// 64; each warp's q fragments (hi and lo) stay in registers; per chunk of
// 64 keys S = q K^T is formed once (three products a tile), masked past M
// in the last chunk, and an online softmax in the exp2 domain feeds P,
// split, to three more products with V. The k order of each 8-step is
// relabelled (k = t as 2t, k = t+4 as 2t+1) so that S's accumulators are
// P's A fragment in place (no shuffle) and every operand is one
// conflict-free 16-byte load. The row sum is taken over the unsplit P in
// fp32. K and V go through registers on their way in, 16 bytes a load,
// because they are split and V is transposed there (`cp.async` would land
// them unsplit). At d = 32 the split K and V fill 146 KiB, so one block
// holds an SM and takes 12 warps; at d = 16 (81 KiB) two blocks of 8 do.
// What holds it above its bound: `mma.sync` is Hopper's older tensor-core
// path (the full TF32 rate needs `wgmma`), and each warp's chain per
// chunk (three dependent products per tile, then the row max, shuffles,
// exponentials and the split of P, which `cvt.rna.tf32.f32` turns into
// integer instructions) has few warps beside it to hide in.

#include <cstdint>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxKeys = 256;

constexpr int kChunk = 64;    // keys per online-softmax step

// ------------------------- fp32 path (3xTF32) --------------------------------

constexpr int kF32MaxTiles = 4;  // 16-row tiles per warp at most

// warps per block, 16 query rows each: at d = 32 one block fills an SM's
// shared memory, so it takes as many warps as its registers allow; at
// d = 16 two blocks of 8 share an SM
template <int D>
__host__ __device__ constexpr int f32_warps() { return D == 32 ? 12 : 8; }

// Shared memory of one block (32-bit words): K as Mp rows of D/2 chunks
// {hi, hi, lo, lo} (channels 2c, 2c+1 of one key) and V^T as D rows of Mp/2
// chunks (keys 2p, 2p+1 of one channel); both row strides are 16 words
// past a multiple of 32, so a quarter warp's 16-byte loads (two rows, four
// chunks each) meet no bank conflict.
template <int D>
__host__ __device__ constexpr int f32_k_stride() { return 2 * D + 16; }
__host__ __device__ inline int f32_v_stride(int Mp) { return 2 * Mp + 16; }
template <int D>
__host__ __device__ inline size_t f32_smem_words(int Mp) {
  return (size_t)Mp * f32_k_stride<D>() + (size_t)D * f32_v_stride(Mp);
}

template <int D>
__global__ void __launch_bounds__(f32_warps<D>() * 32)
gsa_attention_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          int N, int M, int C, int tiles, float scale_log2) {
  constexpr int KRS = f32_k_stride<D>();
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const int VRS = f32_v_stride(Mp);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* vt = ks + Mp * KRS;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const float* kb = k + (size_t)b * M * C + (size_t)h * D;
  const float* vb = v + (size_t)b * M * C + (size_t)h * D;
  // K: 4 channels (16 bytes) of one key per load, neighbouring threads on
  // neighbouring channels; keys past M are zero (their logits are masked)
#pragma unroll 4
  for (int i = threadIdx.x; i < Mp * (D / 4); i += blockDim.x) {
    const int j = i / (D / 4), c4 = i - j * (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < M)
      x = *reinterpret_cast<const float4*>(kb + (size_t)j * C + 4 * c4);
    uint4* row = reinterpret_cast<uint4*>(ks + j * KRS);
    row[2 * c4] = split_pair(x.x, x.y);
    row[2 * c4 + 1] = split_pair(x.z, x.w);
  }
  // V^T: 4 channels of two keys per thread, neighbouring threads on
  // neighbouring key pairs (conflict-free chunk stores); keys past M are
  // zero, so their zero weights meet no garbage
#pragma unroll 2
  for (int i = threadIdx.x; i < (Mp / 2) * (D / 4); i += blockDim.x) {
    const int c4 = i / (Mp / 2), p = i - c4 * (Mp / 2);
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (2 * p < M)
      x0 = *reinterpret_cast<const float4*>(vb + (size_t)(2 * p) * C + 4 * c4);
    if (2 * p + 1 < M)
      x1 = *reinterpret_cast<const float4*>(vb + (size_t)(2 * p + 1) * C +
                                            4 * c4);
    uint4* col = reinterpret_cast<uint4*>(vt + 4 * c4 * VRS) + p;
    col[0] = split_pair(x0.x, x1.x);
    col[VRS / 4] = split_pair(x0.y, x1.y);
    col[VRS / 2] = split_pair(x0.z, x1.z);
    col[3 * VRS / 4] = split_pair(x0.w, x1.w);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  constexpr int kWarpsB = f32_warps<D>();
  const int block_rows = kWarpsB * 16 * tiles;

  for (int tile = 0; tile < tiles; ++tile) {
    const int row0 = blockIdx.x * block_rows + (tile * kWarpsB + warp) * 16;
    if (row0 >= N) break;  // warp-uniform
    const int ra = row0 + g, rb = row0 + g + 8;
    const float* qa_p = q + ((size_t)b * N + ra) * C + (size_t)h * D;
    const float* qb_p = q + ((size_t)b * N + rb) * C + (size_t)h * D;

    // q fragments (A, 16 x d), split: rows g / g+8, channels 2t, 2t+1 of
    // each 8-channel step (k = t, t+4)
    uint32_t qh[D / 8][4], ql[D / 8][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 + 2 * t;
      float2 xa = make_float2(0.f, 0.f), xb = xa;
      if (ra < N) xa = *reinterpret_cast<const float2*>(qa_p + c);
      if (rb < N) xb = *reinterpret_cast<const float2*>(qb_p + c);
      split_tf32(xa.x, qh[kk][0], ql[kk][0]);
      split_tf32(xb.x, qh[kk][1], ql[kk][1]);
      split_tf32(xa.y, qh[kk][2], ql[kk][2]);
      split_tf32(xb.y, qh[kk][3], ql[kk][3]);
    }

    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g / g+8
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sum

    for (int kc = 0; kc < Mp; kc += kChunk) {
      // S = q K^T for 64 keys: 8 tiles of 16 x 8, each logit formed once
      float s[kChunk / 8][4];
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const uint32_t* kr = ks + (kc + nt * 8 + g) * KRS + 4 * t;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
          mma_3xtf32(s[nt], qh[kk], ql[kk], lds128(kr + kk * 16));
      }
      // scale to the exp2 domain, mask keys past M (in the last chunk
      // only), running max
      const bool ragged = kc + kChunk > M;  // block-uniform
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const int key = kc + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= scale_log2;
          if (ragged && key + (e & 1) >= M) s[nt][e] = -INFINITY;
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
      const float a0 = ex2_ftz(m0 - mx0), a1 = ex2_ftz(m1 - mx1);
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
      // O += P V, 8 keys a step: S tile nt's registers {c0, c2, c1, c3},
      // split, are P's A fragment with keys 2t, 2t+1 as k = t, t+4, and V's
      // B fragment is the chunk of keys 2t, 2t+1 of output column g; the
      // row sums take the unsplit P
      const uint32_t* vr = vt + g * VRS + 2 * kc + 4 * t;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const float p0 = ex2_ftz(s[nt][0] - m0), p1 = ex2_ftz(s[nt][1] - m0);
        const float p2 = ex2_ftz(s[nt][2] - m1), p3 = ex2_ftz(s[nt][3] - m1);
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
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    float* oa = out + ((size_t)b * N + ra) * C + (size_t)h * D;
    float* ob = out + ((size_t)b * N + rb) * C + (size_t)h * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      if (ra < N)
        *reinterpret_cast<float2*>(oa + c) =
            make_float2(o[dn][0] * i0, o[dn][1] * i0);
      if (rb < N)
        *reinterpret_cast<float2*>(ob + c) =
            make_float2(o[dn][2] * i1, o[dn][3] * i1);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int N, int M, int C, int heads,
                       cudaStream_t stream) {
  auto kernel = gsa_attention_tf32_kernel<D>;
  // above 48 KiB the dynamic shared memory needs the attribute; it is set
  // once, for the largest M the kernel takes (146 KiB at d = 32, 81 KiB at
  // d = 16, where two blocks share an SM)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(f32_smem_words<D>(kMaxKeys) * sizeof(uint32_t)));
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
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const size_t smem = f32_smem_words<D>(Mp) * sizeof(uint32_t);
  // a block stages its head's K and V once for f32_warps * 16 * tiles
  // query rows: as many as keep the grid at two blocks per SM or more
  int tiles = kF32MaxTiles;
  auto blocks = [&](int tl) {
    const int rows = f32_warps<D>() * 16 * tl;
    return (long long)((N + rows - 1) / rows) * heads * B;
  };
  while (tiles > 1 && blocks(tiles) < 2LL * n_sm) tiles /= 2;
  const int rows = f32_warps<D>() * 16 * tiles;
  const dim3 grid((N + rows - 1) / rows, heads, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, f32_warps<D>() * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, M, C, tiles,
      scale_log2);
  return cudaGetLastError();
}

// --------------------------- bf16 tensor-core path ---------------------------

constexpr int kWarps = 8;     // warps per block, 16 query rows each
constexpr int kTiles = 2;     // 16-row tiles per warp (K/V staged once for all)
constexpr int kBlockRows = kWarps * 16 * kTiles;

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
