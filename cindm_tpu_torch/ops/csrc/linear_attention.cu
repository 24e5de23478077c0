// PreNormResidual(LinearAttentionTemporal) of the 1D denoiser for Hopper
// (sm_90a), one launch a block, 3xTF32 on the tensor cores.
//
// Replaces no Pallas kernel. It is the port of what XLA compiles inside the
// jitted forward for cindm_tpu/models/blocks.py:251 (PreNormResidual) over
// :167 (LinearAttentionTemporal) and :107 (ChannelLayerNorm):
//
//   xn = (x - mean) * rsqrt(var + eps) * g          over C, biased variance
//   q, k, v = xn @ wqkv                             4 heads of 32 each
//   k = softmax over T of k;  q = q * 32^-0.5
//   out = (per head q (k^T v)) @ wout + bout + x
//
// x, out [B, T, C]; wqkv [C, 384] and wout [128, C] in the JAX Dense
// layouts, as the port keeps them.
//
// What bounds it on an H100: operations. The flagship forward's eight
// blocks ((C, T) = (64, 24) ... (512, 3) at batch 5,376) do 61.0 GFLOP (the
// qkv and out products 55.0, both context contractions 6.1) against 0.43 GB
// of x, out and weights; 3xTF32 issues each product three times, 0.37 ms at
// 495 TFLOP/s, above the bytes' 0.13 ms at 3.35 TB/s (fp32 on the CUDA
// cores: 0.91 ms).
//
// Design: a thread block (eight warps) takes a tile of whole samples, 48
// rows (96 where T > 48; the rows past the last whole sample are padding),
// so the softmax over T and each sample's context never leave the chip: one
// read of x, one write of out. The tile's x is normalised in place in
// shared memory (a warp a row: the mean, then the biased variance, in
// fp32). The products run on mma.sync m16n8k8 tf32, each product as
// small*big + big*small + big*big (split_tf32_fast: the big half rounded to
// nearest, the small half the exact rest, which the tensor cores read as
// tf32), with no barrier inside them: a warp owns a slice of the output
// columns for all rows of the tile, reads A (xn, then the hidden tile) from
// shared memory and its B fragments straight from the weights in L2, a
// chunk of 16 input channels ahead of its tensor-core work (a block's
// weights are 0.1-1 MB, the same for every tile). First q | k | v of all
// four heads ([rows][384]: 16 slices of 24 columns, two a warp; q scaled
// as it is stored). Then a warp a (sample, head) on the CUDA cores in fp32,
// a lane a channel: the lane's column of k softmaxed over T
// (max-subtracted), the context k^T v [32][32] in the lanes' registers
// (lane e holds column e; k's rows are read as broadcast float4s), then
// each row's q . context into the hidden tile [rows][128], which takes the
// place of xn. Last the out product, hidden @ wout, a warp 16 output
// columns at a time, and its epilogue adds bout and the residual x (read
// again from L2) and stores each pair of values by 8 bytes. Padding rows
// and the rows of a ragged last tile past the batch are zeros and are not
// stored. Two blocks share an SM at C <= 128 (101 KB of shared memory,
// under 128 registers a thread), one at C = 256 and 512 (125 and 174 KB).
// Where the time goes (tools/attention_ablation.py; PERF.md): the qkv
// product, then the tile's load, LayerNorm and epilogue, then the CUDA-core
// attention, the out product and the weights' L2 reads, each 15-45% of the
// launch.
#include <cmath>

#include "stage_ring.cuh"

namespace {

using cindm::split_tf32_fast;

constexpr int kHeads = 4;
constexpr int kDimHead = 32;
constexpr int kHidden = kHeads * kDimHead;      // 128
constexpr int kHeadCols = 3 * kDimHead;         // a head's q | k | v
constexpr int kQkvCols = kHeads * kHeadCols;    // wqkv's columns, 384
constexpr int kThreads = 256;                   // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                      // input channels of B a warp loads ahead
constexpr int kSlice = 24;                      // q | k | v columns of a warp's slice (3 n8 blocks)
constexpr int kCMultiple = 16;                  // C in multiples of this (the out product's column pairs)
constexpr int kQkvStride = 392;                 // a row of the q | k | v tile (384 + 8)
constexpr int kHidStride = 132;                 // a row of the hidden tile (128 + 4: A-fragment banks)
constexpr float kScale = 0.17677669529663687f;  // dim_head^-0.5 as the plain version rounds it

__host__ __device__ constexpr int tile_rows(int T) { return T <= 48 ? 48 : 96; }

// Mirrors _build.attention_smem_bytes: xn [M][C + 4], then (in the same
// place) the hidden tile [M][132]; q | k | v [M][392].
__host__ __device__ inline size_t attention_smem_bytes(int C, int T) {
  const size_t M = tile_rows(T);
  return 4 * M * ((C + 4 > kHidStride ? C + 4 : kHidStride) + kQkvStride);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// One warp's acc[MB][NB] += A [16 MB rows][K] x B [K][NB n8 blocks], K a
// multiple of 8. A: shared memory, row stride astride. B: device
// memory (read-only), n8 block n's column bcol[n] of rows of ldb floats.
// Fragments of m16n8k8 tf32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g), g = lane / 4,
// t = lane % 4. The next chunk's B is in registers before this chunk's
// products start, so the loads' L2 latency runs under them.
template <int MB, int NB>
__device__ __forceinline__ void warp_product(const float* as, int astride, const float* __restrict__ b,
                                             int ldb, const int (&bcol)[NB], int K, float (&acc)[MB][NB][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  constexpr int kSteps = kChunk / 8;
  float bn[kSteps][NB][2];
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const bool in = k0 + s * 8 < K;
      const float* r0 = b + static_cast<long long>(in ? k0 + s * 8 + tq : 0) * ldb + gq;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        bn[s][n][0] = in ? __ldg(r0 + bcol[n]) : 0.f;
        bn[s][n][1] = in ? __ldg(r0 + 4 * ldb + bcol[n]) : 0.f;
      }
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    float bc[kSteps][NB][2];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int n = 0; n < NB; ++n) bc[s][n][0] = bn[s][n][0], bc[s][n][1] = bn[s][n][1];
    if (k0 + kChunk < K) load(k0 + kChunk);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (k0 + s * 8 >= K) break;  // a last chunk of K % 32 channels
      uint32_t bb[NB][2], bl[NB][2];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        split_tf32_fast(bc[s][n][0], bb[n][0], bl[n][0]);
        split_tf32_fast(bc[s][n][1], bb[n][1], bl[n][1]);
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float* ap = as + (m * 16 + gq) * astride + k0 + s * 8 + tq;
        uint32_t ab[4], al[4];
        split_tf32_fast(ap[0], ab[0], al[0]);
        split_tf32_fast(ap[8 * astride], ab[1], al[1]);
        split_tf32_fast(ap[4], ab[2], al[2]);
        split_tf32_fast(ap[8 * astride + 4], ab[3], al[3]);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          mma_tf32(acc[m][n], al, bb[n]);
          mma_tf32(acc[m][n], ab, bl[n]);
          mma_tf32(acc[m][n], ab, bb[n]);
        }
      }
    }
  }
}

// Two blocks an SM where their shared memory allows (48-row tiles at C <=
// 128): at most 128 registers a thread.
template <int MB>
__global__ void __launch_bounds__(kThreads, MB == 3 ? 2 : 1) linear_attention(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ wqkv,
    const float* __restrict__ wout, const float* __restrict__ bout, float* __restrict__ out, int B,
    int T, int C, float eps) {
  constexpr int M = 16 * MB;
  extern __shared__ __align__(16) float smem[];
  const int xstride = C + 4;
  float* xs = smem;  // [M][C + 4]: x, then xn; then the hidden tile [M][132]
  float* hid = smem;
  float* qkv = smem + M * (xstride > kHidStride ? xstride : kHidStride);  // [M][392]
  const int samples = M / T;
  const int rows = samples * T;  // the rows of whole samples; the rest is padding
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const long long nrows = static_cast<long long>(B) * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;

  // x's tile by 16-byte loads; padding and rows past the batch are zeros (their xn is 0)
  const int c4 = C / 4;
  for (int j = tid; j < M * c4; j += kThreads) {
    const int r = j / c4, c = (j - r * c4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && row0 + r < nrows) v = __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * C + c));
    *reinterpret_cast<float4*>(xs + r * xstride + c) = v;
  }
  __syncthreads();

  // ChannelLayerNorm in place, a warp a row
  const float inv_c = 1.0f / static_cast<float>(C);
  for (int r = warp; r < M; r += kWarps) {
    float* xr = xs + r * xstride;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += xr[c];
    const float mean = warp_sum(s) * inv_c;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mean;
      v = fmaf(d, d, v);
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_c + eps);
    for (int c = lane; c < C; c += 32) xr[c] = (xr[c] - mean) * rstd * __ldg(g + c);
  }
  __syncthreads();

  // q | k | v of every head, [rows][4 x 96]: 16 slices of 24 columns, a warp
  // two of them; an n8 block never crosses a head or a third of one
  for (int slice = warp; slice < kQkvCols / kSlice; slice += kWarps) {
    int bcol[3];
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const int tc = slice * kSlice + n * 8, h = tc / kHeadCols, hc = tc - h * kHeadCols;
      bcol[n] = (hc / kDimHead) * kHidden + h * kDimHead + hc % kDimHead;
    }
    float acc[MB][3][4] = {};
    warp_product<MB, 3>(xs, xstride, wqkv, kQkvCols, bcol, C, acc);
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const int col = slice * kSlice + n * 8 + 2 * tq;
      const float s = col % kHeadCols < kDimHead ? kScale : 1.0f;  // q
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float* p = qkv + (m * 16 + gq) * kQkvStride + col;
        *reinterpret_cast<float2*>(p) = make_float2(acc[m][n][0] * s, acc[m][n][1] * s);
        *reinterpret_cast<float2*>(p + 8 * kQkvStride) = make_float2(acc[m][n][2] * s, acc[m][n][3] * s);
      }
    }
  }
  __syncthreads();  // xn is dead: the hidden tile takes its place

  // a warp a (sample, head), a lane a channel
  for (int item = warp; item < samples * kHeads; item += kWarps) {
    const int smp = item / kHeads, h = item - smp * kHeads;
    float* base = qkv + smp * T * kQkvStride + h * kHeadCols;  // q | k | v of the sample's T rows
    // k's column `lane` softmaxed over T
    float* kc = base + kDimHead + lane;
    float mx = -INFINITY;
    for (int t = 0; t < T; ++t) mx = fmaxf(mx, kc[t * kQkvStride]);
    float sum = 0.f;
    for (int t = 0; t < T; ++t) {
      const float e = expf(kc[t * kQkvStride] - mx);
      kc[t * kQkvStride] = e;
      sum += e;
    }
    for (int t = 0; t < T; ++t) kc[t * kQkvStride] /= sum;
    __syncwarp();
    // context column `lane`: ctx[d] = sum over t of k[t][d] v[t][lane]
    float ctx[kDimHead];
#pragma unroll
    for (int d = 0; d < kDimHead; ++d) ctx[d] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* kr = base + t * kQkvStride + kDimHead;
      const float v = kr[kDimHead + lane];
#pragma unroll
      for (int d = 0; d < kDimHead; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
        ctx[d] = fmaf(k4.x, v, ctx[d]);
        ctx[d + 1] = fmaf(k4.y, v, ctx[d + 1]);
        ctx[d + 2] = fmaf(k4.z, v, ctx[d + 2]);
        ctx[d + 3] = fmaf(k4.w, v, ctx[d + 3]);
      }
    }
    // out[r][lane] = q[r] . ctx, into the hidden tile's column h * 32 + lane
    for (int t = 0; t < T; ++t) {
      const float* qr = base + t * kQkvStride;
      float o = 0.f;
#pragma unroll
      for (int d = 0; d < kDimHead; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
        o = fmaf(q4.x, ctx[d], o);
        o = fmaf(q4.y, ctx[d + 1], o);
        o = fmaf(q4.z, ctx[d + 2], o);
        o = fmaf(q4.w, ctx[d + 3], o);
      }
      hid[(smp * T + t) * kHidStride + h * kDimHead + lane] = o;
    }
  }
  __syncthreads();

  // the out product, a warp 16 output columns at a time; bias and residual in the epilogue
  for (int n0 = warp * 16; n0 < C; n0 += kWarps * 16) {
    const int bcol[2] = {n0, n0 + 8};
    float acc[MB][2][4] = {};
    warp_product<MB, 2>(hid, kHidStride, wout, C, bcol, kHidden, acc);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = n0 + n * 8 + 2 * tq;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bout + col));
#pragma unroll
      for (int m = 0; m < MB; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + gq + half * 8;
          if (r >= rows || row0 + r >= nrows) continue;
          const long long off = (row0 + r) * C + col;
          const float2 xv = __ldg(reinterpret_cast<const float2*>(x + off));
          float2 o;
          o.x = (acc[m][n][2 * half] + bv.x) + xv.x;
          o.y = (acc[m][n][2 * half + 1] + bv.y) + xv.y;
          *reinterpret_cast<float2*>(out + off) = o;
        }
      }
    }
  }
}

template <int MB>
cudaError_t launch(const float* x, const float* g, const float* wqkv, const float* wout, const float* bout,
                   float* out, int B, int T, int C, float eps, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(C, T);
  CINDM_TRY(cudaFuncSetAttribute(linear_attention<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(cindm::kSmemMax)));
  const int samples = tile_rows(T) / T;
  const int grid = (B + samples - 1) / samples;
  linear_attention<MB><<<grid, kThreads, smem, stream>>>(x, g, wqkv, wout, bout, out, B, T, C, eps);
  return cudaGetLastError();
}

}  // namespace

// C a multiple of 16, 0 < T <= 96, a tile within the card's shared memory;
// the wrapper (ops/linear_attention.py) checks the same.
extern "C" int cindm_linear_attention(const float* x, const float* g, const float* wqkv, const float* wout,
                                      const float* bout, float* out, int B, int T, int C, float eps,
                                      void* stream) {
  if (!x || !g || !wqkv || !wout || !bout || !out || B <= 0 || C <= 0 || C % kCMultiple || T <= 0 || T > 96 ||
      attention_smem_bytes(C, T) > cindm::kSmemMax)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return T <= 48 ? launch<3>(x, g, wqkv, wout, bout, out, B, T, C, eps, s)
                 : launch<6>(x, g, wqkv, wout, bout, out, B, T, C, eps, s);
}
