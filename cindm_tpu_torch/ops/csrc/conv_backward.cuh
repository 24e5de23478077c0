// Device code of the hand-written backward of the fused ResidualTemporalBlock
// and of the head Conv1d + GroupNorm + Mish (block_backward.cu), for Hopper
// (sm_90a).
//
// Replaces the TPU package's cindm_tpu/ops/fused_rtb.py:_fused_rtb_cv_bwd,
// which re-runs fused_rtb_reference under jax.vjp. Here nothing of the
// block is recomputed: the forward's saving instance (conv_gn_mish.cuh,
// kSave) keeps z = conv + bias before each GroupNorm, each GroupNorm's
// per-(sample, group) mean and rstd, and h, the second conv's input. With
// g the cotangent of a stage's output, yh = (z - mean) * rstd and
// y = yh * gs + gb:
//
//   dy  = g * mish'(y)                       dgs = sum dy * yh,  dgb = sum dy
//   dz  = rstd * (dy*gs - m[dy*gs] - yh * m[dy*gs * yh]),  db = sum dz
//         (m[.]: the mean over the T * og elements of one (sample, group))
//   din = conv5 of dz with w flipped in time and transposed  (dgrad)
//   dw[k][c][o] = sum_r in[r + k - 2][c] * dz[r][o], taps inside the sample (wgrad)
//
// Kernels, in launch order for one block:
//   stage_weights_t  w2 and w1 flipped and transposed, wres transposed, laid
//                    out as the stage's main loop reads them (one launch);
//   gn_mish_bwd      the second GroupNorm + Mish backward: g -> dz2;
//   dgrad_gn_stage   dh = conv_T(dz2, w2) through the forward's 3xTF32 wgmma
//                    main loop (conv_gemm), then in its epilogue dtemb = sum_t
//                    dh and the first GroupNorm + Mish backward: -> dz1;
//   dgrad_x_stage    dx = conv_T(dz1, w1) + (g @ wres^T | g), the 1x1
//                    product in the same accumulator; skipped when x needs
//                    no gradient;
//   wgrad            dw2, dw1 and dwres, split over the rows, 3xTF32 on the
//                    tensor cores (mma.sync m16n8k8);
//   grad_reduce      sums the split and per-tile partials into the gradients.
// The head runs gn_mish_bwd (its only GroupNorm), dgrad_x_stage without the
// residual, wgrad and grad_reduce.
//
// What bounds it on an H100: operations. The two dgrads and the wgrads do
// twice the forward's multiply-adds, and 3xTF32 issues each three times on
// the tensor cores: at batch 512 about 0.62 ms for the denoiser's 16 blocks
// at 495 TFLOP/s; the GroupNorm/Mish passes move about 0.1 GB there (0.03
// ms at 3.35 TB/s).
//
// Design. The GroupNorm backward needs two reductions over each (sample,
// group), so, as in the forward, a block tiles 192 rows of whole samples x
// an N tile of whole groups and keeps the tile in shared memory; the dgrad
// of conv2 is the forward's implicit GEMM over dz2 with the flipped weights,
// so its tile holds dh for whole samples and whole groups and the first
// GroupNorm's backward runs in its epilogue, with no round trip of dh.
// Every reduction across blocks goes through partials in device memory and
// a second pass in a fixed order, never through atomics, so a gradient
// repeats bit for bit from run to run. The weight gradients reduce over the
// rows, the slow axis of both operands' storage; wgmma's .tf32 form takes
// only K-major shared-memory operands, so wgrad uses mma.sync, whose
// operands both come from registers and may read the row-major staged
// tiles in any order: its taps are a shift of the activation's row index,
// masked at sample edges, at no cost in staging.
#pragma once

#include "conv_gn_mish.cuh"

namespace cindm {

constexpr int kWgRows = kTileRows;      // rows of whole samples per wgrad chunk
constexpr int kWgThreads = 256;         // 8 warps: 4 along input x 2 along output channels
constexpr int kWgTile = 64;             // input and output channels of a wgrad block
constexpr int kWgStride = kWgTile + 8;  // floats per staged row: conflict-free fragment reads
constexpr int kWgJobs = 3;              // dw2, dw1, dwres
constexpr int kReduceJobs = 10;
constexpr int kColParts = 7;  // dgs2, dgb2, db2, dbres, dgs1, dgb1, db1

// Mirror ops/_build.plan_backward; the launches refuse a plan that differs.
// gemm: the dgrad stage's ring comes first (it then holds the dh tile).
inline size_t gn_bwd_smem_bytes(int nt, int samples, int gpt, bool gemm) {
  return (gemm ? region0_bytes(nt) : tile_bytes(nt)) + tile_bytes(nt) +
         4 * size_t(samples) * gpt * 4 + 16;
}
inline size_t dgrad_x_smem_bytes(int nt) { return ring_bytes(nt) + 16; }
// wgrad stages the activations split (tf32 big and small planes) and the
// cotangent as it is
constexpr size_t wgrad_smem_bytes() { return 3 * size_t(kWgRows) * kWgStride * 4; }

// The GroupNorm + Mish backward of one tile (whole samples x whole groups).
struct GnBwd {
  const float* z;     // [B, T, O] conv output plus bias, saved by the forward
  const float* mean;  // [B, G]
  const float* rstd;  // [B, G]
  const float* gs;    // [O]
  const float* gb;    // [O]
  float* dz;          // [B, T, O]
  float* part;        // [3 or 4][row tiles][O]: dgs, dgb, db (, sum of d: dbres)
  float* dtemb;       // [B, O] per-sample sums over t of d, or null
  int colsum;         // write part[3], the column sums of d
  int B, T, O, G, samples, row_tiles;
};

namespace {

// d/dy Mish(y) = tanh(sp) + y sigmoid(y) sech^2(sp), sp = softplus(y). With
// e = e^y and n = e (e + 2) as in mish(): tanh(sp) = n / (n + 2) and
// sech^2(sp) = 4 (n + 1) / (n + 2)^2, which keeps its precision where tanh
// is near 1 (1 - tanh^2 would not). Clamped at y = 20 like mish().
__device__ __forceinline__ float mish_grad(float y) {
  const float e = expf(fminf(y, 20.0f));
  const float n = e * (e + 2.0f);
  const float d = n + 2.0f;
  return __fdividef(n, d) + y * __fdividef(e, 1.0f + e) * __fdividef(4.0f * (n + 1.0f), d * d);
}

// tile [192][NT + 4] holds d, the cotangent of Mish(GN(z)) at this block's
// rows and N tile (blockIdx.x, blockIdx.y); yh is a second such tile and st
// room for 4 * samples * gpt floats. Writes dz, the per-tile column partials
// and dtemb. Starts and ends with the tile complete (a barrier before).
template <int NT>
__device__ void gn_mish_bwd_tile(const GnBwd& a, float* tile, float* yh, float* st) {
  constexpr int kS = NT + 4;
  const int b0 = blockIdx.x * a.samples;
  const int ns = min(a.samples, a.B - b0);
  const int nrows = ns * a.T;
  const int row0 = b0 * a.T;
  const int n0 = blockIdx.y * NT;
  const int ncols = min(NT, a.O - n0);
  const int og = a.O / a.G;
  const int gpt = ncols / og;
  const int lane = threadIdx.x & 31;
  float* mean = st;
  float* rstd = mean + a.samples * gpt;
  float* m1 = rstd + a.samples * gpt;
  float* m2 = m1 + a.samples * gpt;
  float* part = a.part + static_cast<size_t>(blockIdx.x) * a.O + n0;
  const size_t pstride = static_cast<size_t>(a.row_tiles) * a.O;  // between partial kinds

  // 0. the tile's statistics; per-sample and per-column sums of d
  for (int p = threadIdx.x; p < ns * gpt; p += kThreads) {
    const size_t gi = static_cast<size_t>(b0 + p / gpt) * a.G + n0 / og + p % gpt;
    mean[p] = __ldg(a.mean + gi);
    rstd[p] = __ldg(a.rstd + gi);
  }
  if (a.dtemb != nullptr)
    for (int q = threadIdx.x; q < ns * (ncols / 4); q += kThreads) {
      const int s = q / (ncols / 4), c = 4 * (q % (ncols / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = 0; t < a.T; ++t) {
        const float4 d = *reinterpret_cast<const float4*>(tile + (s * a.T + t) * kS + c);
        v.x += d.x, v.y += d.y, v.z += d.z, v.w += d.w;
      }
      *reinterpret_cast<float4*>(a.dtemb + static_cast<size_t>(b0 + s) * a.O + n0 + c) = v;
    }
  if (a.colsum)
    for (int c = threadIdx.x; c < ncols; c += kThreads) {
      float v = 0.0f;
      for (int r = 0; r < nrows; ++r) v += tile[r * kS + c];
      part[3 * pstride + c] = v;
    }
  __syncthreads();

  // 1. yh and dy = d * mish'(y), four neighbouring columns a thread
  const int c = 4 * (threadIdx.x % (NT / 4));
  const float inv_t = 1.0f / a.T;
  float4 scale = make_float4(0.f, 0.f, 0.f, 0.f);
  int gl[4] = {0, 0, 0, 0};
  if (c < ncols) {
    scale = __ldg(reinterpret_cast<const float4*>(a.gs + n0 + c));
    const float4 shift = __ldg(reinterpret_cast<const float4*>(a.gb + n0 + c));
#pragma unroll
    for (int e = 0; e < 4; ++e) gl[e] = (c + e) / og;
    for (int r = threadIdx.x / (NT / 4); r < nrows; r += kThreads / (NT / 4)) {
      const int p = static_cast<int>((r + 0.5f) * inv_t) * gpt;  // r / T, exact for r < 192
      const float4 z = __ldg(reinterpret_cast<const float4*>(a.z + static_cast<size_t>(row0 + r) * a.O + n0 + c));
      float4* dp = reinterpret_cast<float4*>(tile + r * kS + c);
      const float4 d = *dp;
      float4 y4, dy;
      y4.x = (z.x - mean[p + gl[0]]) * rstd[p + gl[0]];
      y4.y = (z.y - mean[p + gl[1]]) * rstd[p + gl[1]];
      y4.z = (z.z - mean[p + gl[2]]) * rstd[p + gl[2]];
      y4.w = (z.w - mean[p + gl[3]]) * rstd[p + gl[3]];
      dy.x = d.x * mish_grad(y4.x * scale.x + shift.x);
      dy.y = d.y * mish_grad(y4.y * scale.y + shift.y);
      dy.z = d.z * mish_grad(y4.z * scale.z + shift.z);
      dy.w = d.w * mish_grad(y4.w * scale.w + shift.w);
      *dp = dy;
      *reinterpret_cast<float4*>(yh + r * kS + c) = y4;
    }
  }
  __syncthreads();

  // 2. column partials of dgs and dgb; per (sample, group) the means of
  //    dyh = dy * gs and of dyh * yh, one warp each (as tile_stats)
  for (int i = threadIdx.x; i < 2 * ncols; i += kThreads) {
    const int cc = i % ncols, kind = i / ncols;
    float v = 0.0f;
    for (int r = 0; r < nrows; ++r) v += kind == 0 ? tile[r * kS + cc] * yh[r * kS + cc] : tile[r * kS + cc];
    part[kind * pstride + cc] = v;
  }
  {
    const int n = a.T * og;
    const float inv_og = 1.0f / og;
    for (int p = threadIdx.x >> 5; p < ns * gpt; p += kWarps) {
      const int off = (p / gpt) * a.T * kS + (p % gpt) * og;
      const float* gsp = a.gs + n0 + (p % gpt) * og;
      float s1 = 0.0f, s2 = 0.0f;
      for (int e = lane; e < n; e += 32) {
        const int r = static_cast<int>((e + 0.5f) * inv_og);
        const int col = e - r * og;
        const float dyh = tile[off + r * kS + col] * __ldg(gsp + col);
        s1 += dyh;
        s2 += dyh * yh[off + r * kS + col];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        m1[p] = s1 / n;
        m2[p] = s2 / n;
      }
    }
  }
  __syncthreads();

  // 3. dz = rstd * (dyh - m[dyh] - yh * m[dyh * yh])
  if (c < ncols)
    for (int r = threadIdx.x / (NT / 4); r < nrows; r += kThreads / (NT / 4)) {
      const int p = static_cast<int>((r + 0.5f) * inv_t) * gpt;
      float4* dp = reinterpret_cast<float4*>(tile + r * kS + c);
      const float4 dy = *dp;
      const float4 y4 = *reinterpret_cast<const float4*>(yh + r * kS + c);
      float4 dz;
      dz.x = rstd[p + gl[0]] * (dy.x * scale.x - m1[p + gl[0]] - y4.x * m2[p + gl[0]]);
      dz.y = rstd[p + gl[1]] * (dy.y * scale.y - m1[p + gl[1]] - y4.y * m2[p + gl[1]]);
      dz.z = rstd[p + gl[2]] * (dy.z * scale.z - m1[p + gl[2]] - y4.z * m2[p + gl[2]]);
      dz.w = rstd[p + gl[3]] * (dy.w * scale.w - m1[p + gl[3]] - y4.w * m2[p + gl[3]]);
      *dp = dz;
      *reinterpret_cast<float4*>(a.dz + static_cast<size_t>(row0 + r) * a.O + n0 + c) = dz;
    }
  __syncthreads();

  // 4. column partials of db = sum dz
  for (int cc = threadIdx.x; cc < ncols; cc += kThreads) {
    float v = 0.0f;
    for (int r = 0; r < nrows; ++r) v += tile[r * kS + cc];
    part[2 * pstride + cc] = v;
  }
}

// The second GroupNorm + Mish backward (or the head's only one) on the CUDA
// cores: the tile of d comes in 16 bytes a thread.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1) gn_mish_bwd(const float* __restrict__ d, const GnBwd a) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* yh = tile + tile_bytes(NT) / 4;
  float* st = yh + tile_bytes(NT) / 4;
  const int b0 = blockIdx.x * a.samples;
  const int nrows = min(a.samples, a.B - b0) * a.T;
  const int n0 = blockIdx.y * NT;
  const int c = 4 * (threadIdx.x % (NT / 4));
  if (c < min(NT, a.O - n0))
    for (int r = threadIdx.x / (NT / 4); r < nrows; r += kThreads / (NT / 4))
      *reinterpret_cast<float4*>(tile + r * (NT + 4) + c) = __ldg(reinterpret_cast<const float4*>(
          d + static_cast<size_t>(b0 * a.T + r) * a.O + n0 + c));
  __syncthreads();
  gn_mish_bwd_tile<NT>(a, tile, yh, st);
}

struct DgradArgs {
  const float* dz;         // [B, T, Cin] the cotangent of the conv's output
  const uint32_t* ws;      // the conv's weights flipped and transposed (stage_weights_t)
  const float* g;          // dgrad_x: the block's output cotangent [B, T, Cres] for the
                           // residual (projected with wress, else added), or null
  const uint32_t* wress;   // wres^T laid out with K = 1, or null
  float* out;              // dgrad_x: dx [B, T, Cout]
  int B, T, Cin, Cout, Cres, samples;
};

// dh = conv_T(dz2, w2) for 192 rows x NT channels of whole groups, kept in
// shared memory for the first GroupNorm's backward.
template <int NT, int KW>
__global__ void __launch_bounds__(kThreads, 1) dgrad_gn_stage(const DgradArgs a, const GnBwd gn) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int b0 = blockIdx.x * a.samples;
  const int ns = min(a.samples, a.B - b0);
  const int lane = threadIdx.x & 31;
  const int gpt = min(NT, a.Cout - static_cast<int>(blockIdx.y) * NT) / (gn.O / gn.G);
  float* tile = reinterpret_cast<float*>(smem);
  float* yh = reinterpret_cast<float*>(smem + region0_bytes(NT));
  float* st = reinterpret_cast<float*>(smem + region0_bytes(NT) + tile_bytes(NT));
  const uint32_t bars = smem_u32(st + 4 * a.samples * gpt);
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
  }
  __syncthreads();
  const int nchunks = (a.Cin + kChunk - 1) / kChunk;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T);
  const char* wblocks = reinterpret_cast<const char*>(a.ws) +
                        blockIdx.y * nchunks * weight_block_bytes(NT, kConvK);
  conv_gemm<NT, kConvK, KW>(a.dz, a.Cin, b0 * a.T, ns * a.T, tr, wblocks, 0, smem, bars, acc);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tr.live[i])
        *reinterpret_cast<float2*>(tile + tr.r[i] * (NT + 4) + c) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  __syncthreads();
  gn_mish_bwd_tile<NT>(gn, tile, yh, st);
}

// dx = conv_T(dz1, w1) (+ g @ wres^T in the same accumulator | + g) for 192
// rows x NT input channels; no GroupNorm, so the N tile needs no whole
// groups (C = 8 runs 8 live columns of 64).
template <int NT, int KW>
__global__ void __launch_bounds__(kThreads, 1) dgrad_x_stage(const DgradArgs a) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int b0 = blockIdx.x * a.samples;
  const int ns = min(a.samples, a.B - b0);
  const int nrows = ns * a.T;
  const int row0 = b0 * a.T;
  const int n0 = blockIdx.y * NT;
  const int ncols = min(NT, a.Cout - n0);
  const int lane = threadIdx.x & 31;
  const uint32_t bars = smem_u32(smem + ring_bytes(NT));
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
  }
  __syncthreads();
  const int nchunks = (a.Cin + kChunk - 1) / kChunk;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T);
  conv_gemm<NT, kConvK, KW>(a.dz, a.Cin, row0, nrows, tr,
                            reinterpret_cast<const char*>(a.ws) +
                                blockIdx.y * nchunks * weight_block_bytes(NT, kConvK),
                            0, smem, bars, acc);
  if (a.wress != nullptr) {
    // the same fragment rows (position-major at T <= 3), one tap
    TileRows t1 = tr;
    t1.klo = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) t1.ok[i] = tr.live[i] ? 1u : 0u;
    conv_gemm<NT, 1, 1>(a.g, a.Cres, row0, nrows, t1,
                        reinterpret_cast<const char*>(a.wress) +
                            blockIdx.y * ((a.Cres + kChunk - 1) / kChunk) * weight_block_bytes(NT, 1),
                        nchunks, smem, bars, acc);
  }
  const float* ident = a.wress == nullptr ? a.g : nullptr;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (c < ncols) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!tr.live[i]) continue;
        const size_t gi = static_cast<size_t>(row0 + tr.r[i]) * a.Cout + n0 + c;
        float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        if (ident != nullptr) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(ident + gi));
          v.x += r.x, v.y += r.y;
        }
        *reinterpret_cast<float2*>(a.out + gi) = v;
      }
    }
  }
}

// One weight layout job of stage_weights_t: w [K][Os][Cs] laid out as the
// stage reads a conv from Cs to Os channels, flipped in time:
// staged[k][c][o] = w[K - 1 - k][o][c]. (For w [K][C][O] of a conv C -> O
// that is the conv O -> C whose forward is the original's dgrad.)
struct StageJobT {
  const float* w;
  uint32_t* out;
  int K, Cs, Os, nt;
  size_t total;  // words: staged_weight_bytes(nt, Cs, Os, K) / 4
};

// Up to three weight tensors in one launch, each as stage_weights lays out
// its weights, read transposed and flipped. Index arithmetic in 32 bits
// (a call stages far fewer than 2^32 words): 64-bit division would
// dominate the kernel.
__global__ void stage_weights_t(const StageJobT j0, const StageJobT j1, const StageJobT j2) {
  const uint32_t e1 = j0.total, e2 = e1 + j1.total, e3 = e2 + j2.total;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < e3; i += gridDim.x * blockDim.x) {
    const StageJobT& j = i < e1 ? j0 : (i < e2 ? j1 : j2);
    const uint32_t li = i - (i < e1 ? 0u : (i < e2 ? e1 : e2));
    const uint32_t plane = j.nt * 8;
    const uint32_t block = 2u * j.K * plane;
    const uint32_t nchunks = (j.Cs + kChunk - 1) / kChunk;
    const uint32_t b = li / block;
    const uint32_t rem = li - b * block;
    const uint32_t tp = rem / plane, e = rem % plane;
    const uint32_t n8 = e / 64, q = e % 64;
    const uint32_t ntile = b / nchunks, chunk = b % nchunks;
    const int o = static_cast<int>(ntile * j.nt + n8 * 8 + (q % 32) / 4);
    const int c = static_cast<int>(chunk * kChunk + (q / 32) * 4 + q % 4);
    uint32_t v = 0u;
    if (o < j.Os && c < j.Cs) {
      uint32_t big, small;
      split_tf32(j.w[(static_cast<size_t>(j.K - 1 - static_cast<int>(tp / 2)) * j.Os + o) * j.Cs + c],
                 big, small);
      v = tp % 2 ? small : big;
    }
    j.out[li] = v;
  }
}

// One weight gradient of wgrad: part[split][tap][c][o] = sum over the
// split's rows r of act[r + tap - 2][c] * dz[r][o] (tap 2 alone when
// taps == 1), taps inside the row's sample only.
struct WgradJob {
  const float* act;  // [B * T, Ca]
  const float* dz;   // [B * T, Od]
  float* part;       // [splits][taps][Ca][Od]
  int Ca, Od, taps, splits, cps;  // cps: row tiles per split
  int ctiles, otiles, block0;     // channel tiles of kWgTile; first block of the job
};
struct WgradArgs {
  WgradJob job[kWgJobs];
  int njobs, B, T, samples;
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A block owns 64 input x 64 output channels of one job and all its taps,
// over the row tiles of one split: each row tile (192 rows of whole
// samples) of act and dz is staged into shared memory in its own layout,
// act already split into tf32 big and small planes (each element serves
// five taps and two warps), and each warp multiplies 16 input x 32 output
// channels, 8 rows a step: A = act rows shifted by the tap (zero outside
// the sample), B = dz rows, split in registers once a step for all five
// taps; 3xTF32 as in the forward.
__global__ void __launch_bounds__(kWgThreads) wgrad(const WgradArgs a) {
  extern __shared__ float4 smem4[];
  uint32_t* xbig = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* xsmall = xbig + kWgRows * kWgStride;
  float* ds = reinterpret_cast<float*>(xsmall + kWgRows * kWgStride);
  WgradJob jb = a.job[0];
#pragma unroll
  for (int q = 1; q < kWgJobs; ++q)
    if (q < a.njobs && static_cast<int>(blockIdx.x) >= a.job[q].block0) jb = a.job[q];
  const int local = blockIdx.x - jb.block0;
  const int ct = local % jb.ctiles;
  const int ot = (local / jb.ctiles) % jb.otiles;
  const int sp = local / (jb.ctiles * jb.otiles);
  const int c0 = ct * kWgTile, o0 = ot * kWgTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cm = (warp & 3) * 16 + g;  // the thread's A rows cm, cm + 8 (input channels)
  const int on = (warp >> 2) * 32 + g;  // its B column within each n8 block (output channel)
  const int shift0 = jb.taps == 1 ? 0 : -kConvK / 2;

  float acc[kConvK][4][4];
#pragma unroll
  for (int k = 0; k < kConvK; ++k)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][n][i] = 0.0f;

  const int ntiles = (a.B + a.samples - 1) / a.samples;
  const int ch1 = min(ntiles, (sp + 1) * jb.cps);
  for (int ch = sp * jb.cps; ch < ch1; ++ch) {
    const int b0 = ch * a.samples;
    const int nrows = min(a.samples, a.B - b0) * a.T;
    const size_t row0 = static_cast<size_t>(b0) * a.T;
    __syncthreads();  // the last row tile's reads are done
    for (int i = threadIdx.x; i < kWgRows * (kWgTile / 4); i += kWgThreads) {
      const int r = i / (kWgTile / 4), q = 4 * (i % (kWgTile / 4));
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vd = va;
      if (r < nrows) {
        if (c0 + q < jb.Ca) va = __ldg(reinterpret_cast<const float4*>(jb.act + (row0 + r) * jb.Ca + c0 + q));
        if (o0 + q < jb.Od) vd = __ldg(reinterpret_cast<const float4*>(jb.dz + (row0 + r) * jb.Od + o0 + q));
      }
      uint4 big, small;
      split_tf32(va.x, big.x, small.x);
      split_tf32(va.y, big.y, small.y);
      split_tf32(va.z, big.z, small.z);
      split_tf32(va.w, big.w, small.w);
      *reinterpret_cast<uint4*>(xbig + r * kWgStride + q) = big;
      *reinterpret_cast<uint4*>(xsmall + r * kWgStride + q) = small;
      *reinterpret_cast<float4*>(ds + r * kWgStride + q) = vd;
    }
    __syncthreads();
    const int nsteps = (nrows + 7) / 8;
    for (int step = 0; step < nsteps; ++step) {
      const int ra = step * 8 + t, rb = ra + 4;  // the thread's rows of the step (k = t, t + 4)
      uint32_t bbig[4][2], bsmall[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split_tf32(ds[ra * kWgStride + on + 8 * n], bbig[n][0], bsmall[n][0]);
        split_tf32(ds[rb * kWgStride + on + 8 * n], bbig[n][1], bsmall[n][1]);
      }
      const int ta = ra % a.T, tb = rb % a.T;
#pragma unroll
      for (int k = 0; k < kConvK; ++k) {
        if (k < jb.taps) {
          const int sh = shift0 + k;
          const bool oka = ra < nrows && ta + sh >= 0 && ta + sh < a.T;
          const bool okb = rb < nrows && tb + sh >= 0 && tb + sh < a.T;
          const int ia = (oka ? ra + sh : ra) * kWgStride + cm;
          const int ib = (okb ? rb + sh : rb) * kWgStride + cm;
          // a0: (cm, k = t), a1: (cm + 8, t), a2: (cm, t + 4), a3: (cm + 8, t + 4)
          const uint32_t abig[4] = {oka ? xbig[ia] : 0u, oka ? xbig[ia + 8] : 0u,
                                    okb ? xbig[ib] : 0u, okb ? xbig[ib + 8] : 0u};
          const uint32_t asmall[4] = {oka ? xsmall[ia] : 0u, oka ? xsmall[ia + 8] : 0u,
                                      okb ? xsmall[ib] : 0u, okb ? xsmall[ib + 8] : 0u};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            mma_tf32(acc[k][n], asmall, bbig[n][0], bbig[n][1]);
            mma_tf32(acc[k][n], abig, bsmall[n][0], bsmall[n][1]);
            mma_tf32(acc[k][n], abig, bbig[n][0], bbig[n][1]);
          }
        }
      }
    }
  }
  // D fragment: (cm, 2t), (cm, 2t + 1), (cm + 8, 2t), (cm + 8, 2t + 1) of each n8 block
#pragma unroll
  for (int k = 0; k < kConvK; ++k) {
    if (k >= jb.taps) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int o = o0 + (warp >> 2) * 32 + 8 * n + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + cm + 8 * h;
        if (c < jb.Ca && o < jb.Od)
          *reinterpret_cast<float2*>(jb.part + ((static_cast<size_t>(sp) * jb.taps + k) * jb.Ca + c) * jb.Od + o) =
              make_float2(acc[k][n][2 * h], acc[k][n][2 * h + 1]);
      }
    }
  }
}

// dst[i] = sum over s of src[s * n + i], s in order: the split and per-tile
// partials summed in a fixed order, so gradients repeat bit for bit.
struct ReduceJob {
  const float* src;
  float* dst;
  int n, slices;
};
struct ReduceArgs {
  ReduceJob job[kReduceJobs];
  int njobs;
};

__global__ void grad_reduce(const ReduceArgs a) {
  ReduceJob jb = a.job[0];
#pragma unroll
  for (int q = 1; q < kReduceJobs; ++q)
    if (q == static_cast<int>(blockIdx.y)) jb = a.job[q];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < jb.n; i += gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < jb.slices; ++s) v += jb.src[static_cast<size_t>(s) * jb.n + i];
    jb.dst[i] = v;
  }
}

}  // namespace
}  // namespace cindm
