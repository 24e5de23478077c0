// Device code shared by fused_rtb.cu and fused_conv_gn.cu: one Conv1d +
// GroupNorm + Mish stage as an implicit GEMM on Hopper's tensor cores.
//
//   out[r][o] = Mish(GN(sum_k sum_c x[r + k - 2][c] * w[k][c][o] + b[o]))
//               (+ temb[s][o] | + xres[r][o] | + (xres @ wres)[r][o] + bres[o])
//
// Replaces the TPU kernels cindm_tpu/ops/fused_rtb.py:fused_rtb (:179, two
// stages a block) and cindm_tpu/ops/fused_conv_gn.py:fused_conv1d_gn_mish
// (:112, one stage).
//
// What bounds it on an H100: operations. 3xTF32 issues each multiply-add
// three times on the tensor cores, so the floor is 3 x FLOP (valid taps
// only) at 495 TFLOP/s: 3.26 ms for the denoiser's 16 blocks at batch
// 5,376, 0.030 ms for its head.
//
// GEMM: M = rows of whole samples (r = s*T + t), N = output channels in
// whole GroupNorm groups, K = 5 taps x C. A tile is kTileRows = 192 rows
// (192/T whole samples: 8 at T=24, 64 at T=3) x an N tile of 64 or 128
// channels that holds whole groups, so the GroupNorm of every (sample,
// group) it owns is complete inside it and its epilogue reads nothing of
// another tile: no atomics, no sums across CTAs.
//
// Main loop: the one of stage_ring.cuh, which the backward's dgrads run
// too. A producer warp fills a ring of slots, each with the tile's 192
// input rows of 8-16 channels by one TMA box and their weight blocks
// (stage_weights lays w out once per call as tf32 big/small planes, one
// contiguous block per (N tile, chunk)) by one bulk copy, on full/empty
// mbarriers. Three consumer warpgroups (64 rows each) issue per chunk and
// tap one group of 3 wgmma m64nNk8 passes (small*big, big*small, big*big,
// A split by split_tf32 with round-to-nearest) and keep one group in
// flight while they load and split the next tap's A fragments; at T <= 3
// the tile is position-major and a warpgroup issues only a 3-tap window.
// The 1x1 projection is a second part of K = 1 on the same slots (2-4
// chunks a slot: ProjRing), in the registers the conv accumulator vacated.
// The chunks, taps and passes go in the order the earlier cp.async loop
// took, so z, and with it out, is the same bit for bit.
//
// Persistent CTAs: at most one CTA an SM (the plan's `ctas`), each walking
// tiles t = blockIdx.x, + gridDim.x, .. (row tile t / N tiles, N tile t %
// N tiles). The conv tile [192][NT+4] lies beside 3 slots at NT = 64 and 2
// at NT = 128 with the projection, so while the consumers run one tile's
// GroupNorm statistics, Mish and stores, the producer already fills the
// ring with the next tile's stages. At NT = 128 without the projection it
// lies over a ring of 4 slots instead ("deep"): two slots do not hide a
// stage's load round trip there, and the producer starts a tile once the
// previous tile's epilogue is done. The plan (ops/_build.plan_stage)
// takes the N tile by the waves of tiles over the SMs times a tile's
// width, the wide one on a tie, so that the last wave of the smaller
// grids (168 tiles of 128 at batch 5,376) is not left mostly idle; the
// launch recomputes the plan's shared-memory bytes and CTAs and refuses
// one that differs.
//
// The saving instance (Args = SaveArgs) is the forward of the autograd
// Functions: it also stores z = conv + bias and each (sample, group)'s mean
// and rstd, which conv_backward.cuh reads instead of recomputing the stage.
// The plain instances (Args = StageArgs) compile without it.
//
// L2 traffic: a tile reads its N tile's weight blocks once (5 taps x big
// and small of C x NT, and the projection's) and its 192 input rows once:
// 16.1 GB of staged weights and 3.3 GB of input rows per denoiser forward
// at batch 5,376 (plan_stage's tiles), all from L2 (the staged weights of
// one stage fit it).
#pragma once

#include <type_traits>

#include "stage_ring.cuh"

namespace cindm {

// The stage's threads: the three consumer warpgroups and a producer
// warpgroup, whose first warp fills the ring. A whole warpgroup, so that
// setmaxnreg can move its registers to the consumers: with a producer
// warp alone (416 threads) ptxas gave a thread 128 registers, as for 512,
// and the N-tile-128 instances spilled, or serialized their wgmmas
// (C7512) with two groups in flight.
constexpr int kStageThreads = kThreads + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 152;  // 3 x 128 x 152 + 128 x 40 <= 65,536
static_assert(3 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536, "the SM's register file");

// A launch at NT = 128 without the projection is "deep": its ring has
// kDeepStages slots and the conv tile lies over them, so the producer
// starts a tile's loads once the previous tile's epilogue is done (an
// mbarrier, `epi`). At NT = 128 a tile of its own leaves room for two
// slots only, and two do not hide a stage's load round trip. The
// projection needs the tile beside the ring (the conv output waits there
// while its K = 1 part streams through), and at NT = 64 the tile of its
// own keeps three slots and lets the producer run ahead during the
// epilogue.
constexpr int kDeepStages = 4;
template <int NT, bool kDeep>
using ConvRing = StageRing<NT, kDeep ? kDeepStages : StageRing<NT>::kStages>;
// The projection's part on the same slots: its 1-tap blocks are a fifth of
// a conv's, so a slot takes 4 chunks at NT = 64 (128-byte rows), 2 at
// NT = 128 (64-byte rows), and the part runs a quarter or half the stages.
template <int NT, bool kDeep>
using ProjRing = StageRing<NT, ConvRing<NT, kDeep>::kStages, NT == 64 ? 4 : 2, ConvRing<NT, kDeep>::kStageBytes>;
template <int NT, bool kDeep>
constexpr bool proj_fits() {
  using P = ProjRing<NT, kDeep>;
  return P::kABytes + P::kCh * weight_block_bytes(NT, 1) <= P::kStageBytes;
}
static_assert(proj_fits<64, false>() && proj_fits<128, false>(), "a projection stage fits a slot");

// Shared memory of a stage launch (mirrors ops/_build.plan_stage; the
// launch refuses a plan whose bytes differ): 1,024 bytes to align the ring
// to the swizzle's period, the ring and the conv tile (beside it, or over
// it when deep), mean and rstd of the tile's (sample, group) pairs, each
// ring slot's full and empty barriers and the epilogue's barrier.
__host__ __device__ inline size_t stage_smem_bytes(int nt, int samples, int groups_per_tile, bool deep) {
  const size_t stage = nt == 64 ? StageRing<64>::kStageBytes : StageRing<128>::kStageBytes;
  const int stages = deep ? kDeepStages : (nt == 64 ? StageRing<64>::kStages : StageRing<128>::kStages);
  const size_t ring = stages * stage;
  const size_t region = deep ? (ring > tile_bytes(nt) ? ring : tile_bytes(nt)) : ring + tile_bytes(nt);
  return 1024 + region + 8 * size_t(samples) * groups_per_tile + 16 * stages + 8;
}

struct StageArgs {
  const float* x;     // [B, T, C]  conv input
  const float* w;     // [5, C, O]
  const float* b;     // [O]
  const float* gs;    // [O] GroupNorm scale
  const float* gb;    // [O] GroupNorm bias
  const float* temb;  // [B, O] added after Mish, or null
  const float* xres;  // [B, T, O] identity residual, or [B, T, Cres] projection input, or null
  const float* wres;  // [Cres, O] 1x1 projection, or null
  const float* bres;  // [O]
  float* out;         // [B, T, O]
  uint32_t* ws;       // w laid out by stage_weights (staged_weight_bytes(nt, C, O, 5))
  uint32_t* wress;    // wres laid out likewise (K = 1), or null
  int B, T, C, O, G, Cres;
  float eps;
  int samples;        // whole samples per tile (samples * T <= 192)
};

// The saving instance's arguments: what the backward (conv_backward.cuh)
// reads instead of recomputing the stage, the conv output plus bias before
// the GroupNorm and its per-(sample, group) mean and 1/sqrt(var + eps).
// A type of its own, so that the plain instances keep StageArgs as their
// only parameter and compile as before.
struct SaveArgs : StageArgs {
  float* z;     // [B, T, O]
  float* mean;  // [B, G]
  float* rstd;  // [B, G]
};

// Bytes of w [K][C][O] laid out by stage_weights for N tiles of nt.
inline size_t staged_weight_bytes(int nt, int C, int O, int K) {
  return size_t((O + nt - 1) / nt) * ((C + kChunk - 1) / kChunk) * weight_block_bytes(nt, K);
}

namespace {

// Mish(v) = v * tanh(softplus(v)) = v * n / (n + 2) with n = e^v (e^v + 2):
// one exponential instead of exp, log1p and tanh. Past v = 20, n / (n + 2)
// is 1 in fp32, and clamping there keeps n finite.
__device__ __forceinline__ float mish(float v) {
  const float e = expf(fminf(v, 20.0f));
  const float n = e * (e + 2.0f);
  return v * __fdividef(n, n + 2.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Lays the weights w [K][C][O] out as the stage reads them, in tf32 big and
// small planes: for each N tile and chunk of 8 input channels one block of
// weight_block_bytes(nt, K), contiguous, so that one bulk copy stages it.
// Within a plane, word q of n8 block n8 is channel n8*8 + (q % 32) / 4 of
// input q / 32 * 4 + q % 4 (kSboBytes = 64 words per n8 block, kLboBytes =
// 32 words per K half). Channels past C or O are zero.
__global__ void stage_weights(const float* __restrict__ w, int K, int C, int O, int nt,
                              uint32_t* __restrict__ out, size_t total) {
  static_assert(kSboBytes == 256 && kLboBytes == 128, "the indexing below is for dense blocks");
  const int plane = nt * 8;  // words: nt channels x 8 inputs
  const size_t block = size_t(2 * K) * plane;
  const int nchunks = (C + kChunk - 1) / kChunk;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t b = i / block;
    const int rem = static_cast<int>(i - b * block);
    const int tp = rem / plane, e = rem % plane;  // tp = 2 * tap + (small)
    const int n8 = e / 64, q = e % 64;
    const int ntile = static_cast<int>(b / nchunks), chunk = static_cast<int>(b % nchunks);
    const int o = ntile * nt + n8 * 8 + (q % 32) / 4;
    const int c = chunk * kChunk + (q / 32) * 4 + q % 4;
    uint32_t v = 0u;
    if (o < O && c < C) {
      uint32_t big, small;
      split_tf32(w[(static_cast<size_t>(tp / 2) * C + c) * O + o], big, small);
      v = tp % 2 ? small : big;
    }
    out[i] = v;
  }
}

// Per (sample, group) mean and 1/sqrt(var + eps) of the tile, two-pass in
// fp32 with biased variance; one warp per (sample, group). Element e of a
// group lies at row e / og, column e % og; the quotient comes from a float
// product, exact here (e < 2^15, og <= 128), so the loads do not wait on
// an integer division and unroll.
template <int NT>
__device__ void tile_stats(const float* tile, int ns, int T, int gpt, int og, float eps,
                           float* mean, float* rstd) {
  const int lane = threadIdx.x & 31;
  const int n = T * og;
  const float inv_og = 1.0f / og;
  auto at = [&](const float* base, int e) {
    const int r = static_cast<int>((e + 0.5f) * inv_og);
    return base[r * (NT + 4) + e - r * og];
  };
  for (int p = threadIdx.x >> 5; p < ns * gpt; p += kWarps) {
    const float* base = tile + (p / gpt) * T * (NT + 4) + (p % gpt) * og;
    float s = 0.0f;
#pragma unroll 4
    for (int e = lane; e < n; e += 32) s += at(base, e);
    const float m = warp_sum(s) / n;
    float q = 0.0f;
#pragma unroll 4
    for (int e = lane; e < n; e += 32) {
      const float d = at(base, e) - m;
      q += d * d;
    }
    const float var = warp_sum(q) / n;
    if (lane == 0) {
      mean[p] = m;
      rstd[p] = rsqrtf(var + eps);
    }
  }
}

// One tile of a persistent CTA's walk, on the consumer warpgroups: row
// tile rt (samples [rt S, rt S + ns)) x N tile nti. `it` counts the ring's
// stages as the producer does.
template <int NT, int KW, bool kDeep, class Args>
__device__ __forceinline__ void stage_tile(const Args& a, int rt, int nti, const char* ring, float* tile,
                                           float* mean, float* rstd, uint32_t full, uint32_t empty,
                                           uint32_t epi, int& it) {
  constexpr bool kSave = !std::is_same<Args, StageArgs>::value;
  using CR = ConvRing<NT, kDeep>;
  using PR = ProjRing<NT, kDeep>;
  const int b0 = rt * a.samples;
  const int ns = min(a.samples, a.B - b0);
  const int nrows = ns * a.T;
  const int row0 = b0 * a.T;
  const int n0 = nti * NT;
  const int ncols = min(NT, a.O - n0);
  const int og = a.O / a.G;
  const int gpt = ncols / og;  // whole groups: n0 and ncols are multiples of og
  const bool proj = a.wres != nullptr;
  const int lane = threadIdx.x & 31;

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  {
    const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T);
    ring_consume<CR, kConvK, KW, Split::kRna>(tr, ring_part<CR>(a.ws, a.C, kConvK, 0, 1, nti), ring, full,
                                              empty, it, acc);
    consumer_sync();  // the previous tile's epilogue is done with the tile and the statistics
    // tile[r][c] = acc + b[n0 + c] at the fragment positions, rows in natural order
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float bias0 = c < ncols ? __ldg(a.b + n0 + c) : 0.0f;
      const float bias1 = c + 1 < ncols ? __ldg(a.b + n0 + c + 1) : 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tr.live[i])
          *reinterpret_cast<float2*>(tile + tr.r[i] * (NT + 4) + c) =
              make_float2(acc[4 * j + 2 * i] + bias0, acc[4 * j + 2 * i + 1] + bias1);
    }
  }
  consumer_sync();
  tile_stats<NT>(tile, ns, a.T, gpt, og, a.eps, mean, rstd);
  consumer_sync();
  // Each thread keeps four neighbouring columns (NT / 4 divides kThreads),
  // so their GroupNorm affine and group indices are loaded once; the tile,
  // temb, the residual and the output move 16 bytes at a time (O is a
  // multiple of 4, so 4 columns lie within ncols together).
  const int c = 4 * (threadIdx.x % (NT / 4));
  const int r0 = threadIdx.x / (NT / 4);
  constexpr int kRowStep = kThreads / (NT / 4);
  const int o = n0 + c;
  const int gl[4] = {c / og, (c + 1) / og, (c + 2) / og, (c + 3) / og};
  const float inv_t = 1.0f / a.T;
  if constexpr (kSave) {
    // z and the statistics, before the projection rewrites the tile
    for (int p = threadIdx.x; p < ns * gpt; p += kThreads) {
      const size_t gi = static_cast<size_t>(b0 + p / gpt) * a.G + n0 / og + p % gpt;
      a.mean[gi] = mean[p];
      a.rstd[gi] = rstd[p];
    }
    if (c < ncols)
      for (int r = r0; r < nrows; r += kRowStep)
        *reinterpret_cast<float4*>(a.z + static_cast<size_t>(row0 + r) * a.O + o) =
            *reinterpret_cast<const float4*>(tile + r * (NT + 4) + c);
  }
  // GN(z) of row r's four columns of the tile, Mish's argument
  auto affine = [&](int r, const float4& scale, const float4& shift) {
    float4 v = *reinterpret_cast<const float4*>(tile + r * (NT + 4) + c);
    const int p = static_cast<int>((r + 0.5f) * inv_t) * gpt;  // (r / T) * gpt, r / T exact for r < 192
    v.x = (v.x - mean[p + gl[0]]) * rstd[p + gl[0]] * scale.x + shift.x;
    v.y = (v.y - mean[p + gl[1]]) * rstd[p + gl[1]] * scale.y + shift.y;
    v.z = (v.z - mean[p + gl[2]]) * rstd[p + gl[2]] * scale.z + shift.z;
    v.w = (v.w - mean[p + gl[3]]) * rstd[p + gl[3]] * scale.w + shift.w;
    return v;
  };

  if (!kDeep && proj) {
    // The 1x1 projection: a second part of K = 1 over the same rows in the
    // registers the conv accumulator vacated. The tile is normalised in
    // place first (GN(z), Mish's argument y), Mish meets the product at the
    // fragment positions and bres comes in the final pass: (Mish(y) + xres
    // wres) + bres, Mish's last product fused with the first add as the
    // compiler fuses it in the plain form.
    if constexpr (kSave) consumer_sync();  // z is stored before the tile changes
    if (c < ncols) {
      const float4 scale = __ldg(reinterpret_cast<const float4*>(a.gs + o));
      const float4 shift = __ldg(reinterpret_cast<const float4*>(a.gb + o));
      for (int r = r0; r < nrows; r += kRowStep)
        *reinterpret_cast<float4*>(tile + r * (NT + 4) + c) = affine(r, scale, shift);
    }
    const TileRows tr = tile_rows<1, 1>(a.samples, ns, a.T);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    ring_consume<PR, 1, 1, Split::kRna>(tr, ring_part<PR>(a.wress, a.Cres, 1, 0, 1, nti), ring, full, empty,
                                        it, acc);
    consumer_sync();  // the tile is normalised
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int cj = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tr.live[i] && cj < ncols) {  // ncols is even: cj + 1 < ncols too
          float2* t = reinterpret_cast<float2*>(tile + tr.r[i] * (NT + 4) + cj);
          const float2 v = *t;
          *t = make_float2(mish(v.x) + acc[4 * j + 2 * i], mish(v.y) + acc[4 * j + 2 * i + 1]);
        }
    }
    consumer_sync();
  }

  if (c < ncols) {
    const float4 scale = __ldg(reinterpret_cast<const float4*>(a.gs + o));
    const float4 shift = __ldg(reinterpret_cast<const float4*>(a.gb + o));
    const float4 bres = proj ? __ldg(reinterpret_cast<const float4*>(a.bres + o)) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* ident = (!proj && a.xres != nullptr) ? a.xres : nullptr;
#pragma unroll 2
    for (int r = r0; r < nrows; r += kRowStep) {
      const size_t gi = static_cast<size_t>(row0 + r) * a.O + o;
      float4 v;
      if (!kDeep && proj) {
        v = *reinterpret_cast<const float4*>(tile + r * (NT + 4) + c);
        v.x += bres.x, v.y += bres.y, v.z += bres.z, v.w += bres.w;
      } else {
        v = affine(r, scale, shift);
        v.x = mish(v.x), v.y = mish(v.y), v.z = mish(v.z), v.w = mish(v.w);
        if (a.temb != nullptr) {
          const int sr = static_cast<int>((r + 0.5f) * inv_t);
          const float4 t = __ldg(reinterpret_cast<const float4*>(a.temb + (b0 + sr) * size_t(a.O) + o));
          v.x += t.x, v.y += t.y, v.z += t.z, v.w += t.w;
        }
        if (ident != nullptr) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(ident + gi));
          v.x += t.x, v.y += t.y, v.z += t.z, v.w += t.w;
        }
      }
      *reinterpret_cast<float4*>(a.out + gi) = v;
    }
  }
  __syncwarp();  // the warp converges before the next tile's wgmmas
  if (kDeep && lane == 0) mbar_arrive(epi);  // this warp is done with the tile over the ring
}

// Args = SaveArgs: the saving instance, which also writes z, mean and rstd
// for the backward (conv_backward.cuh); with StageArgs it compiles without.
// mx: x as ring_map views it; mres: xres likewise where the projection
// runs (else unused). kDeep: NT = 128 without the projection (FwdRing).
template <int NT, int KW, bool kDeep, class Args>
__global__ void __launch_bounds__(kStageThreads, 1)
    conv_gn_mish_stage(const Args a, const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mres) {
  using R = ConvRing<NT, kDeep>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;  // the swizzle's period
  const int gmax = (a.O < NT ? a.O : NT) / (a.O / a.G);  // groups of a whole N tile
  float* tile = reinterpret_cast<float*>(kDeep ? smem : smem + R::kRingBytes);
  const size_t region = kDeep ? (R::kRingBytes > tile_bytes(NT) ? R::kRingBytes : tile_bytes(NT))
                              : R::kRingBytes + tile_bytes(NT);
  float* mean = reinterpret_cast<float*>(smem + region);
  float* rstd = mean + a.samples * gmax;
  const uint32_t full = smem_u32(rstd + a.samples * gmax);
  const uint32_t empty = full + 8 * R::kStages;
  const uint32_t epi = empty + 8 * R::kStages;
  if (threadIdx.x == 0) {
    for (int q = 0; q < R::kStages; ++q) {
      mbar_init(full + 8 * q);
      mbar_init(empty + 8 * q, kWarps);  // one arrival a consumer warp
    }
    mbar_init(epi, kWarps);
  }
  __syncthreads();
  // the role, warp-uniform as the compiler can see (a shuffle of lane 0's
  // value): wgmma is issued only in code it knows no warp diverges into
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int ntiles = (a.O + NT - 1) / NT;
  const int tiles = (a.B + a.samples - 1) / a.samples * ntiles;
  int it = 0;
  if (warp >= kWarps) {
    regs_dec<kProducerRegs>();
    if (warp > kWarps) return;
    int local = 0;  // this CTA's tiles so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++local) {
      const int row0 = t / ntiles * a.samples * a.T, nti = t % ntiles;
      if (kDeep && local > 0) mbar_wait(epi, (local - 1) & 1);  // the tile over the ring is free
      ring_produce<R>(&mx, ring_part<R>(a.ws, a.C, kConvK, 0, 1, nti), row0, smem, full, empty, it);
      if (!kDeep && a.wres != nullptr) {
        using P = ProjRing<NT, kDeep>;
        ring_produce<P>(&mres, ring_part<P>(a.wress, a.Cres, 1, 0, 1, nti), row0, smem, full, empty, it);
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    stage_tile<NT, KW, kDeep>(a, t / ntiles, t % ntiles, smem, tile, mean, rstd, full, empty, epi, it);
}

cudaError_t launch_stage_weights(const float* w, int K, int C, int O, int nt, uint32_t* out,
                                 cudaStream_t stream) {
  const size_t total = staged_weight_bytes(nt, C, O, K) / 4;
  const size_t blocks = (total + 255) / 256;
  stage_weights<<<blocks < 4096 ? blocks : 4096, 256, 0, stream>>>(w, K, C, O, nt, out, total);
  return cudaGetLastError();
}

// The CTAs of a stage launch of `tiles` tiles on the current device: one an
// SM at most (mirrors ops/_build.plan_stage).
cudaError_t stage_ctas(int tiles, int* ctas) {
  int dev = 0, sms = 0;
  CINDM_TRY(cudaGetDevice(&dev));
  CINDM_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  *ctas = tiles < sms ? tiles : sms;
  return cudaSuccess;
}

template <int NT, int KW, bool kDeep, class Args>
cudaError_t launch_nt(const Args& a, size_t bytes, int ctas, const CUtensorMap& mx, const CUtensorMap& mres,
                      cudaStream_t stream) {
  static unsigned long long smem_set = 0;  // devices where the attribute is set
  CINDM_TRY(allow_smem_once(conv_gn_mish_stage<NT, KW, kDeep, Args>, smem_set));
  conv_gn_mish_stage<NT, KW, kDeep, Args><<<ctas, kStageThreads, bytes, stream>>>(a, mx, mres);
  return cudaGetLastError();
}

// One stage: lay the weights out (stage_weights into a.ws, a.wress), then
// launch the stage kernel with the planner's tile: `samples` whole samples
// per tile, an N tile of `nt` channels, `smem_bytes` of dynamic shared
// memory, `ctas` persistent CTAs. With SaveArgs it launches the saving
// instance. Refuses (cudaErrorInvalidValue) a plan that breaks the
// tiling's rules or differs from the one recomputed here.
template <class Args>
cudaError_t launch_stage(const Args& a, int K, int nt, int smem_bytes, int ctas, void* stream) {
  const bool proj = a.wres != nullptr;
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.O <= 0 || a.G <= 0 || a.O % a.G != 0 ||
      a.C % 4 != 0 || a.O % 4 != 0 || K != kConvK || (nt != 64 && nt != 128) ||
      a.samples <= 0 || a.samples * a.T > kTileRows || a.ws == nullptr ||
      (proj && (a.Cres <= 0 || a.Cres % 4 != 0 || a.wress == nullptr || a.xres == nullptr)) ||
      (proj != (a.bres != nullptr)))
    return cudaErrorInvalidValue;
  const int og = a.O / a.G;
  if (a.O > nt && nt % og != 0) return cudaErrorInvalidValue;  // an N tile holds whole groups
  const int gpt = (a.O < nt ? a.O : nt) / og;
  const bool deep = nt == 128 && !proj;
  const size_t bytes = stage_smem_bytes(nt, a.samples, gpt, deep);
  if (static_cast<size_t>(smem_bytes) != bytes || bytes > kSmemMax) return cudaErrorInvalidValue;
  int want = 0;
  CINDM_TRY(stage_ctas((a.B + a.samples - 1) / a.samples * ((a.O + nt - 1) / nt), &want));
  if (ctas != want) return cudaErrorInvalidValue;
  CUtensorMap mx, mres;
  CINDM_TRY(ring_map(&mx, a.x, a.B * a.T, a.C, nt == 64 ? StageRing<64>::kPitch : StageRing<128>::kPitch));
  if (proj)
    CINDM_TRY(ring_map(&mres, a.xres, a.B * a.T, a.Cres,
                       nt == 64 ? ProjRing<64, false>::kPitch : ProjRing<128, false>::kPitch));
  else
    mres = mx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CINDM_TRY(launch_stage_weights(a.w, K, a.C, a.O, nt, a.ws, s));
  if (proj) CINDM_TRY(launch_stage_weights(a.wres, 1, a.Cres, a.O, nt, a.wress, s));
  if (a.T <= 3)
    return nt == 64 ? launch_nt<64, 3, false>(a, bytes, ctas, mx, mres, s)
                    : deep ? launch_nt<128, 3, true>(a, bytes, ctas, mx, mres, s)
                           : launch_nt<128, 3, false>(a, bytes, ctas, mx, mres, s);
  return nt == 64 ? launch_nt<64, kConvK, false>(a, bytes, ctas, mx, mres, s)
                  : deep ? launch_nt<128, kConvK, true>(a, bytes, ctas, mx, mres, s)
                         : launch_nt<128, kConvK, false>(a, bytes, ctas, mx, mres, s);
}

}  // namespace
}  // namespace cindm
