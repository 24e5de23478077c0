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
//   wgrad            dw1, dw2 and dwres, 3xTF32 wgmma over long runs of rows;
//   grad_reduce      sums the row splits' and row tiles' partials.
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
// repeats bit for bit from run to run.
//
// wgrad. dw[k][c][o] = sum_r act[r + k - 2][c] * d[r][o] is a GEMM with
// M = input channels, N = output channels and K = rows, the slow axis of
// both operands' storage. wgmma's .tf32 form takes only K-major operands
// from shared memory, and the tap's shift of K (masked at sample edges) can
// only be applied to an operand that threads load themselves. So A, the
// activations, goes to wgmma from registers: the producer stages act's rows
// as they lie, by TMA in two boxes of 32 channels (128-byte swizzle), and
// each thread's fragment reads row r + k - 2 for tap k, zero outside the
// row's sample, and splits it for 3xTF32 (split_tf32_fast). K position t
// of a step is row 2t, t + 4 row 2t + 1: the four rows a warp reads at once
// then fall on distinct banks under the swizzle, and a thread's five taps
// read six distinct rows, each once. B, the
// cotangent, arrives already K-major and split: the kernels that compute
// dz1 and dz2 (and gn_mish_bwd for g, dwres's B) also write it in the
// operand layout (write_wgrad_operand), wgmma's core matrices with rows as
// K, tile-major, so that one bulk copy stages a ring stage's k8 steps of
// 64 channels. A work item is 64 input x 64 output channels of one gradient
// over a long run of rows, all taps in one accumulator each; the plan
// (ops/_build.plan_backward) splits the rows only as far as the items
// would otherwise leave SMs idle (the narrow blocks at T = 24 and 12), and
// an item over every row writes its gradient itself. A persistent grid of
// one block an SM walks the items; a producer warp keeps a ring of
// kWgStages stages ahead of two consumer warpgroups (32 output channels
// each, 5 accumulators of m64n32: 80 registers a thread). At T = 3 (the
// widest blocks) rows go position-major within stages of 16 samples, so
// that a step issues only the 3 taps that stay inside the samples, where
// the general order issues 5 for every row (wgrad<true>).
//
// What bounds wgrad (PERF.md): at batch 512 its 3xTF32 operations take
// 0.31 ms on the tensor cores; the ring re-reads each operand once per
// channel tile of the other (L2 traffic), and each step's A fragments
// (loads, masks, splits) cost about as much issue time as its wgmmas.
#pragma once

#include <cuda.h>  // CUtensorMap (a type only: the library calls no driver function by name)

#include "conv_gn_mish.cuh"

namespace cindm {

constexpr int kReduceJobs = 10;
constexpr int kColParts = 7;  // dgs2, dgb2, db2, dbres, dgs1, dgb1, db1

// wgrad's work items and ring
constexpr int kWgTile = 64;        // input and output channels of a work item
constexpr int kWgRows = 64;        // rows of one ring stage: 8 k8 steps
constexpr int kWgRowsT3 = 48;      // at T = 3: 16 whole samples, 6 k8 steps of one position each
constexpr int kWgStages = 4;       // ring stages
constexpr int kWgHalo = kConvK / 2;  // act rows either side of a stage that its taps reach
constexpr int kWgARows = kWgRows + 2 * kWgHalo;  // rows of one activation box
constexpr int kWgABox = 32;  // channels of a box: 128 bytes, the span of the 128-byte swizzle
// one box of kWgARows rows x 128 bytes, in a slot aligned to the swizzle's 1,024-byte period
constexpr size_t kWgABoxBytes = (size_t(kWgARows) * 128 + 1023) / 1024 * 1024;
constexpr size_t kWgABytes = 2 * kWgABoxBytes;  // the item's 64 channels
constexpr size_t kWgBPlane = size_t(kWgTile) * 8 * 4;  // one k8 step of 64 channels, big or small
constexpr size_t kWgStageBytes = kWgABytes + (kWgRows / 8) * 2 * kWgBPlane;
constexpr int kWgConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer warp
constexpr int kWgJobs = 3;                     // dw1, dw2, dwres
static_assert(kWgStageBytes % 1024 == 0, "every stage's boxes start on the swizzle's period");

// Mirror ops/_build.plan_backward; the launches refuse a plan that differs.
// gemm: the dgrad stage's ring comes first (it then holds the dh tile).
inline size_t gn_bwd_smem_bytes(int nt, int samples, int gpt, bool gemm) {
  return (gemm ? region0_bytes(nt) : tile_bytes(nt)) + tile_bytes(nt) +
         4 * size_t(samples) * gpt * 4 + 16;
}
inline size_t dgrad_x_smem_bytes(int nt) { return ring_bytes(nt) + 16; }
// the ring (aligned up to 1,024 bytes in the kernel), then each slot's
// full and empty barriers
constexpr size_t wgrad_smem_bytes() { return 1024 + kWgStages * kWgStageBytes + 2 * kWgStages * 8; }

// Rows of one ring stage of wgrad at sample length T, and the groups of 8
// K positions of a cotangent's operand layout (at T = 3 whole stages of 6).
__host__ __device__ inline int wgrad_stage_rows(int T) { return T == 3 ? kWgRowsT3 : kWgRows; }
__host__ __device__ inline int wgrad_groups(int R, int T) {
  return T == 3 ? (R + kWgRowsT3 - 1) / kWgRowsT3 * (kWgRowsT3 / 8) : (R + 7) / 8;
}

// Words of a cotangent d [R, O] in wgrad's operand layout. Per tile of 64
// channels (ot), group q of 8 K positions and plane p (0: tf32 big, 1:
// small) a block of 512 words at ((ot Q + q) 2 + p) 512, Q = wgrad_groups,
// so that a ring stage's k8 steps for one channel tile are one contiguous
// run.
// In a block, n8 block n (64 words) holds channels 64 ot + 8n .. + 7 as
// wgmma's K-major core matrices, rows as K: word w is K position (w / 32) *
// 4 + w % 4 of channel 64 ot + 8n + (w % 32) / 4 (kLboBytes between the K
// halves, kSboBytes between n8 blocks, as the staged weights), and K
// position t is row 8q + 2t, t + 4 row 8q + 2t + 1: the rows a warp's A
// fragments read at once then lie two apart, on distinct banks under the
// 128-byte swizzle. At T = 3 the order is position-major within each
// stage of 48 rows (16 samples): group g of stage st holds position g / 2
// of samples 8 (g % 2) .. + 7, K position t sample 8 (g % 2) + 2t, t + 4
// sample 8 (g % 2) + 2t + 1: row 48 st + 3 sample + g / 2. Rows past R
// (to the stage's end at T = 3) and channels past O are zero.
inline size_t wgrad_operand_words(int R, int O, int T) {
  return size_t((O + kWgTile - 1) / kWgTile) * wgrad_groups(R, T) * 2 * 512;
}

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
  float* dzw;         // dz in wgrad's operand layout, or null
  float* gw;          // gn_mish_bwd: its input d in the operand layout, or null
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

// Writes rows [row0, row0 + nrows) x channels [n0, n0 + ncols) of a tile
// (row stride ks) into the operand layout `out` of a [R, O] cotangent; the
// tile with the last row also writes the zero rows of the last group, the
// one with the last channels the zero channels up to the next 64. A thread
// takes the 4 rows of one channel that make 16 bytes of a block (rows 2
// apart): conflict-free reads of the tile, and a run of threads writes a
// run of 16-byte words.
__device__ void write_wgrad_operand(const float* tile, int ks, int row0, int nrows, int R, int T,
                                    int n0, int ncols, int O, float* out) {
  const bool p3 = T == 3;  // position-major stages (a tile's rows are whole stages there)
  const int Q = wgrad_groups(R, T);
  const int rend = row0 + nrows, rpad = rend == R ? Q / (p3 ? 6 : 1) * (p3 ? kWgRowsT3 : 8) : rend;
  const int cend = n0 + ncols, cpad = cend == O ? (O + kWgTile - 1) / kWgTile * kWgTile : cend;
  const int units = 2 * (cpad - n0);  // per group of 8 K positions: channel x K half
  const int q0 = p3 ? row0 / kWgRowsT3 * 6 : row0 / 8;
  const int n = ((p3 ? rpad / kWgRowsT3 * 6 : (rpad + 7) / 8) - q0) * units;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int q = q0 + i / units, u = i % units;
    const int c = (u >> 4) * 8 + (u & 7);  // channel - n0: n8 block u / 16, channel u % 8
    const int kh = (u >> 3) & 1;            // K positions 4 kh .. 4 kh + 3
    // their rows: 2 apart from 8q + kh, or at T = 3 6 apart (samples 2 apart)
    const int g = q % 6;
    const int r = p3 ? q / 6 * kWgRowsT3 + 3 * (8 * (g & 1) + kh) + (g >> 1) : 8 * q + kh;
    const int dr = p3 ? 6 : 2;
    uint32_t big[4], small[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = r + dr * k >= row0 && r + dr * k < rend && n0 + c < cend
                          ? tile[(r + dr * k - row0) * ks + c] : 0.0f;
      split_tf32(v, big[k], small[k]);
    }
    const int o = n0 + c;
    uint32_t* w = dst + (size_t(o / kWgTile) * Q + q) * 2 * 512 + (o % kWgTile / 8) * 64 +
                  ((u >> 3) & 1) * 32 + (u & 7) * 4;
    if (r >= row0 && r + 3 * dr < rpad) {
      *reinterpret_cast<uint4*>(w) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(w + 512) = make_uint4(small[0], small[1], small[2], small[3]);
    } else {  // the rows of a group that another tile shares
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r + dr * k >= row0 && r + dr * k < rpad) {
          w[k] = big[k];
          w[512 + k] = small[k];
        }
    }
  }
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
  if (a.dzw != nullptr) write_wgrad_operand(tile, kS, row0, nrows, a.B * a.T, a.T, n0, ncols, a.O, a.dzw);

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
  if (a.gw != nullptr)  // dwres's cotangent: d itself
    write_wgrad_operand(tile, NT + 4, b0 * a.T, nrows, a.B * a.T, a.T, n0, min(NT, a.O - n0), a.O,
                        a.gw);
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
  int block0;  // the job's first thread block
};

constexpr int kStageTThreads = 256;
constexpr int kStageTCols = 8 * kChunk;  // Cs channels of one thread block: 8 chunks

// Thread blocks of one layout job: per N tile, group of 8 chunks and tap.
inline int stage_t_blocks(int K, int Cs, int Os, int nt) {
  return (Os + nt - 1) / nt * (((Cs + kChunk - 1) / kChunk + 7) / 8) * K;
}

// Up to three weight tensors in one launch. A thread block moves one tap of
// nt rows of w (the staged N tile) x 64 of their channels (8 chunks): it
// reads the rows along their contiguous axis, 256 bytes a row in 16-byte
// pieces, into shared memory, and writes the 8 chunks' big and small planes
// of that tap, each a contiguous run of nt x 8 words (stage_weights's
// layout). Bounded by bytes: each weight read once, two planes written.
__global__ void __launch_bounds__(kStageTThreads) stage_weights_t(const StageJobT j0, const StageJobT j1,
                                                                  const StageJobT j2) {
  __shared__ __align__(16) float s[128][kStageTCols + 4];  // + 4: conflict-free plane reads
  const int bx = static_cast<int>(blockIdx.x);
  StageJobT j = j0;
  if (bx >= j1.block0) j = bx < j2.block0 ? j1 : j2;
  const int local = bx - j.block0;
  const int nchunks = (j.Cs + kChunk - 1) / kChunk;
  const int ngroups = (nchunks + 7) / 8;
  const int tap = local % j.K;
  const int grp = local / j.K % ngroups;
  const int ntile = local / (j.K * ngroups);
  const int o0 = ntile * j.nt, c0 = grp * kStageTCols;
  const float* src = j.w + static_cast<size_t>(j.K - 1 - tap) * j.Os * j.Cs;
  for (int i = threadIdx.x; i < j.nt * (kStageTCols / 4); i += kStageTThreads) {
    const int ol = i / (kStageTCols / 4), c4 = 4 * (i % (kStageTCols / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (o0 + ol < j.Os && c0 + c4 < j.Cs)  // Cs is a multiple of 4
      v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(o0 + ol) * j.Cs + c0 + c4));
    *reinterpret_cast<float4*>(&s[ol][c4]) = v;
  }
  __syncthreads();
  // word e of a plane: channel (e / 64) * 8 + (e % 32) / 4 of input (e % 64) / 32 * 4 + e % 4
  const int plane = j.nt * 8;
  const size_t block = size_t(2 * j.K) * plane;
  const int nch = min(8, nchunks - grp * 8);
  uint32_t* out = j.out + (static_cast<size_t>(ntile) * nchunks + grp * 8) * block + 2 * tap * plane;
  for (int ch = 0; ch < nch; ++ch, out += block)
    for (int e = threadIdx.x; e < plane; e += kStageTThreads) {
      const int q = e & 63;
      uint32_t big, small;
      split_tf32(s[(e >> 6) * 8 + ((q & 31) >> 2)][ch * kChunk + (q >> 5) * 4 + (q & 3)], big, small);
      out[e] = big;
      out[plane + e] = small;
    }
}

// One weight gradient of wgrad: out[split][tap][c][o] = sum over the
// split's rows r of act[r + tap - 2][c] * d[r][o] (tap 2 alone when
// taps == 1), taps inside the row's sample only; d comes in the operand
// layout (write_wgrad_operand).
struct WgradJob {
  const float* act;  // [R, Ca] the conv's input
  const float* op;   // d [R, Od] in the operand layout
  float* out;        // [splits][taps][Ca][Od]: the gradient itself when splits == 1
  int Ca, taps, splits, sps;  // sps: ring stages (WgradArgs::rows rows each) per split
  int ctiles, otiles, item0;  // channel tiles of kWgTile; the job's first work item
};
struct WgradArgs {
  WgradJob job[kWgJobs];
  int njobs, nitems, R, T, Od;
  int rows;  // of a ring stage: wgrad_stage_rows(T)
};

// A work item: kWgTile input x kWgTile output channels of one job, every
// tap, over the rows [r0, r1) of split sp.
struct WgItem {
  WgradJob jb;
  int job, c0, o0, sp, r0, r1;
};

__device__ __forceinline__ WgItem wgrad_item(const WgradArgs& a, int item) {
  WgItem w;
  w.jb = a.job[0];
  w.job = 0;
#pragma unroll
  for (int q = 1; q < kWgJobs; ++q)
    if (q < a.njobs && item >= a.job[q].item0) w.jb = a.job[q], w.job = q;
  const int local = item - w.jb.item0;
  const int tiles = w.jb.ctiles * w.jb.otiles;
  w.sp = local / tiles;
  w.c0 = local % w.jb.ctiles * kWgTile;
  w.o0 = local % tiles / w.jb.ctiles * kWgTile;
  w.r0 = w.sp * w.jb.sps * a.rows;
  w.r1 = min(a.R, w.r0 + w.jb.sps * a.rows);
  return w;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}
// Arrive on the barrier and expect `bytes` more of transfers on it.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// A contiguous copy from global to shared memory by the bulk-copy engine,
// counted on the barrier's transfer count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A box of a 2D tensor (coordinates: channel c, row r; outside the tensor
// zeros) into shared memory by the Tensor Memory Accelerator, counted on
// the barrier's transfer count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// wgrad's split of an A fragment value, in 3 operations where split_tf32
// takes 9: big = v rounded to tf32 (nearest, ties away; NaN and inf are
// not kept apart, which only a NaN or inf input could tell), small = v -
// big exactly in fp32, handed over unrounded: the tensor cores read a tf32
// operand's top 19 bits, so small is truncated there, 2^-11 of |small| <=
// 2^-22 of |v|.
__device__ __forceinline__ void split_tf32_fast(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// D[64 x 32] += A[64 x 8] * B[8 x 32]: A in registers, B from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A consumer warpgroup's accumulators into the item's gradient (or its
// split's partial). D fragment: (cm, 2t), (cm, 2t + 1), (cm + 8, 2t), (cm +
// 8, 2t + 1) of each n8 block.
template <int TAPS>
__device__ __forceinline__ void wgrad_store(const WgradArgs& a, const WgItem& w, int wg, int cm, int t,
                                            const float (&acc)[TAPS][16]) {
  float* out = w.jb.out + static_cast<size_t>(w.sp) * TAPS * w.jb.Ca * a.Od;
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int o = w.o0 + 32 * wg + 8 * n + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = w.c0 + cm + 8 * h;
        if (c < w.jb.Ca && o < a.Od)
          *reinterpret_cast<float2*>(out + (static_cast<size_t>(k) * w.jb.Ca + c) * a.Od + o) =
              make_float2(acc[k][4 * n + 2 * h], acc[k][4 * n + 2 * h + 1]);
      }
    }
}

// A consumer warpgroup's share of one work item: TAPS accumulators of
// m64n32 over the item's stages (the tap count is a template parameter so
// that every step issues the same straight-line sequence of wgmmas); `it`
// counts the ring stages passed.
template <int TAPS>
__device__ __forceinline__ void wgrad_consume(const WgradArgs& a, const WgItem& w, char* smem,
                                              uint32_t full, uint32_t empty, int warp, int& it) {
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // output channels o0 + 32 wg .. + 31
  const int g = lane >> 2, t = lane & 3;
  const int cm = (warp & 3) * 16 + g;  // A rows (input channels) cm and cm + 8
  const int cc = cm % kWgABox;          // cm's channel in its box (cm + 8 in the same box)
  const int d8 = 8 % a.T;
  const int shift0 = TAPS == 1 ? 0 : -kWgHalo;
  // A's K position t of a step is row 2t of its 8, position t + 4 row 2t + 1
  // (the operand layout's order). Tap k reads row 2t + sh and 2t + 1 + sh
  // (sh = shift0 + k): TAPS + 1 distinct rows a thread, box rows 2t + d0 + d
  // of the step's 8 (d0: the first shift plus the halo), each at two pieces
  // (cm and cm + 8) placed by the swizzle; their offsets hold for every step.
  constexpr int kRows = TAPS + 1;
  constexpr int d0 = TAPS == 1 ? kWgHalo : 0;
  int off[kRows][2];
#pragma unroll
  for (int d = 0; d < kRows; ++d)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 2 * t + d0 + d;
      off[d][h] = b * kWgABox + 4 * (((cc >> 2) + 2 * h) ^ (b & 7)) + (cc & 3);
    }
  float acc[TAPS][16];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[k][i] = 0.0f;
  // positions in their samples of the thread's K rows of the step, 2t and 2t + 1
  int ta = (w.r0 + 2 * t) % a.T, tb = (w.r0 + 2 * t + 1) % a.T;
  for (int r0 = w.r0; r0 < w.r1; r0 += kWgRows, ++it) {
    const int slot = it % kWgStages;
    // the box of the thread's channels; row i's 16-byte piece p lies at piece p ^ (i % 8)
    const float* as = reinterpret_cast<const float*>(smem + slot * kWgStageBytes + (cm / kWgABox) * kWgABoxBytes);
    const uint32_t bs = smem_u32(smem + slot * kWgStageBytes + kWgABytes) + wg * 4 * kSboBytes;
    const int nk = (min(w.r1, r0 + kWgRows) - r0 + 7) / 8;
    mbar_wait(full + 8 * slot, (it / kWgStages) & 1);
    for (int j = 0; j < nk; ++j) {
      const int r = r0 + 8 * j + 2 * t;  // rows r and r + 1
      const float* rows = as + 8 * j * kWgABox;
      uint32_t vbig[kRows][2], vsmall[kRows][2];
#pragma unroll
      for (int d = 0; d < kRows; ++d)
#pragma unroll
        for (int h = 0; h < 2; ++h) split_tf32_fast(rows[off[d][h]], vbig[d][h], vsmall[d][h]);
      // a0: (cm, k = t), a1: (cm + 8, t), a2: (cm, t + 4), a3: (cm + 8, t + 4); zero where
      // the tap leaves the row's sample
      uint32_t abig[TAPS][4], asmall[TAPS][4];
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int sh = shift0 + k;
        const bool oka = r < a.R && ta + sh >= 0 && ta + sh < a.T;
        const bool okb = r + 1 < a.R && tb + sh >= 0 && tb + sh < a.T;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          abig[k][h] = oka ? vbig[k][h] : 0u;
          asmall[k][h] = oka ? vsmall[k][h] : 0u;
          abig[k][2 + h] = okb ? vbig[k + 1][h] : 0u;
          asmall[k][2 + h] = okb ? vsmall[k + 1][h] : 0u;
        }
      }
      const uint32_t big = bs + 2 * j * kWgBPlane;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        wgmma_tf32(acc[k], asmall[k], weight_desc(big));
        wgmma_tf32(acc[k], abig[k], weight_desc(big + kWgBPlane));
        wgmma_tf32(acc[k], abig[k], weight_desc(big));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int k = 0; k < TAPS; ++k) fence_acc(acc[k]);
      ta += d8;
      ta -= ta >= a.T ? a.T : 0;
      tb += d8;
      tb -= tb >= a.T ? a.T : 0;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp's reads of the slot are done
  }
  wgrad_store<TAPS>(a, w, wg, cm, t, acc);
}

// The same at T = 3, position-major: a stage holds 16 whole samples, and
// k8 step j takes position j / 2 of samples 8 (j % 2) .. + 7 (K position t
// sample 8 (j % 2) + 2t, t + 4 the next one), so every row of a step has
// the same taps inside its sample: position 0 taps 2..4, position 1 taps
// 1..3, position 2 taps 0..2. The step issues those three alone (9 wgmmas,
// not 15), with no masks: rows past R read TMA's zeros.
template <int TAPS>
__device__ __forceinline__ void wgrad_consume_t3(const WgradArgs& a, const WgItem& w, char* smem,
                                                 uint32_t full, uint32_t empty, int warp, int& it) {
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int cm = (warp & 3) * 16 + g;
  const int cc = cm % kWgABox;
  float acc[TAPS][16];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[k][i] = 0.0f;
  for (int r0 = w.r0; r0 < w.r1; r0 += kWgRowsT3, ++it) {
    const int slot = it % kWgStages;
    const float* as = reinterpret_cast<const float*>(smem + slot * kWgStageBytes + (cm / kWgABox) * kWgABoxBytes);
    const uint32_t bs = smem_u32(smem + slot * kWgStageBytes + kWgABytes) + wg * 4 * kSboBytes;
    mbar_wait(full + 8 * slot, (it / kWgStages) & 1);
#pragma unroll
    for (int j = 0; j < kWgRowsT3 / 8; ++j) {
      const int pos = j >> 1;
      // box row of the K position t's row (sample 8 (j % 2) + 2t at pos), before the tap's shift
      const int ba = 3 * (8 * (j & 1) + 2 * t) + pos + kWgHalo;
      uint32_t abig[TAPS][4], asmall[TAPS][4];
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int sh = TAPS == 1 ? 0 : k - kWgHalo;
        if (pos + sh < 0 || pos + sh > 2) continue;  // outside every sample: not issued
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b0 = ba + sh, b1 = ba + 3 + sh;  // rows of K positions t and t + 4
          split_tf32_fast(as[b0 * kWgABox + 4 * (((cc >> 2) + 2 * h) ^ (b0 & 7)) + (cc & 3)],
                          abig[k][h], asmall[k][h]);
          split_tf32_fast(as[b1 * kWgABox + 4 * (((cc >> 2) + 2 * h) ^ (b1 & 7)) + (cc & 3)],
                          abig[k][2 + h], asmall[k][2 + h]);
        }
      }
      const uint32_t big = bs + 2 * j * kWgBPlane;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int sh = TAPS == 1 ? 0 : k - kWgHalo;
        if (pos + sh < 0 || pos + sh > 2) continue;
        wgmma_tf32(acc[k], asmall[k], weight_desc(big));
        wgmma_tf32(acc[k], abig[k], weight_desc(big + kWgBPlane));
        wgmma_tf32(acc[k], abig[k], weight_desc(big));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int k = 0; k < TAPS; ++k) fence_acc(acc[k]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
  wgrad_store<TAPS>(a, w, wg, cm, t, acc);
}

// A persistent grid of one block an SM walks the work items (block b takes
// items b, b + gridDim.x, ...). Warp 8 is the producer: for each ring stage
// of an item it waits for the slot to be free, then one thread loads the
// stage's activation rows (kWgRows plus the two-row halo either side) as
// two TMA boxes of 32 channels and the cotangent's k8 steps of the item's
// 64 channels as one bulk copy, all completing on the slot's full barrier. Warpgroups 0 and 1 are the
// consumers, 32 output channels each, both over the item's 64 input
// channels: per k8 step each thread loads its A fragment rows for every
// tap from the staged activations, shifted by the tap and zero outside the
// row's sample, splits them, and the warpgroup issues taps x 3 wgmma
// m64n32k8 (3xTF32) into one accumulator a tap; after a stage's last step
// each consumer warp arrives on the slot's empty barrier.
// T3: the instance for T = 3 (wgrad_consume_t3), which launches then; an
// instance of its own, so that each holds one consumer's registers.
template <bool T3>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgrad(const WgradArgs a, const __grid_constant__ CUtensorMap act0,
          const __grid_constant__ CUtensorMap act1, const __grid_constant__ CUtensorMap act2) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;  // the swizzle's period
  const uint32_t full = smem_u32(smem + kWgStages * kWgStageBytes);
  const uint32_t empty = full + 8 * kWgStages;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kWgStages; ++q) {
      mbar_init(full + 8 * q);
      mbar_init(empty + 8 * q, kWgConsumers / 32);  // one arrival a consumer warp
    }
  }
  __syncthreads();
  // the role, warp-uniform as the compiler can see (a shuffle of lane 0's
  // value): wgmma is issued only in code it knows no warp diverges into
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int Q = wgrad_groups(a.R, a.T);  // groups of the operand layout
  int it = 0;  // ring stages so far: stage it fills slot it % kWgStages in round it / kWgStages

  if (warp == kWgConsumers / 32) {  // the producer
    for (int item = blockIdx.x; item < a.nitems; item += gridDim.x) {
      const WgItem w = wgrad_item(a, item);
      const CUtensorMap* map = w.job == 0 ? &act0 : (w.job == 1 ? &act1 : &act2);
      for (int r0 = w.r0; r0 < w.r1; r0 += a.rows, ++it) {
        const int slot = it % kWgStages;
        const uint32_t bar = full + 8 * slot;
        mbar_wait(empty + 8 * slot, ((it / kWgStages) & 1) ^ 1);
        if (lane == 0) {
          // k8 steps of the stage: at T = 3 all 6 (the layout's stages are whole)
          const int nk = T3 ? kWgRowsT3 / 8 : (min(w.r1, r0 + kWgRows) - r0 + 7) / 8;
          const int q = T3 ? r0 / kWgRowsT3 * 6 : r0 / 8;  // its first group
          const uint32_t bbytes = nk * 2 * kWgBPlane;
          char* st = smem + slot * kWgStageBytes;
          mbar_expect_tx(bar, 2 * kWgARows * 128 + bbytes);
          // act rows r0 - 2 .. r0 + 65, 32 channels a box; rows and channels outside are zeros
          tma_load_2d(st, map, w.c0, r0 - kWgHalo, bar);
          tma_load_2d(st + kWgABoxBytes, map, w.c0 + kWgABox, r0 - kWgHalo, bar);
          // the stage's k8 steps of the item's 64 output channels: one run of the operand layout
          bulk_load(st + kWgABytes,
                    w.jb.op + ((static_cast<size_t>(w.o0 / kWgTile) * Q + q) * 2) * 512, bbytes, bar);
        }
        __syncwarp();
      }
    }
    // leave only once the consumers have released every slot
    for (int q = 0; q < kWgStages; ++q, ++it) mbar_wait(empty + 8 * (it % kWgStages), ((it / kWgStages) & 1) ^ 1);
    return;
  }

  for (int item = blockIdx.x; item < a.nitems; item += gridDim.x) {
    const WgItem w = wgrad_item(a, item);
    if constexpr (T3) {
      if (w.jb.taps == kConvK)
        wgrad_consume_t3<kConvK>(a, w, smem, full, empty, warp, it);
      else
        wgrad_consume_t3<1>(a, w, smem, full, empty, warp, it);
    } else if (w.jb.taps == kConvK) {
      wgrad_consume<kConvK>(a, w, smem, full, empty, warp, it);
    } else {
      wgrad_consume<1>(a, w, smem, full, empty, warp, it);
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
