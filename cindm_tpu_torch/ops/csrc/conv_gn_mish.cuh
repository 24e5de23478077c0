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
// Main loop: the forward's of stage_ring.cuh (its dgrads' loop beside it).
// A producer warpgroup feeds three consumer warpgroups (64 rows each)
// through a ring of slots of one chunk of 8 input channels: its first warp
// loads the tile's 192 input rows of the chunk by TMA and the chunk's
// weight blocks (stage_weights lays w out once per call as tf32 big/small
// planes, one contiguous block per (N tile, chunk)) by bulk copy; its other
// three warps split each box, once it is in, into tf32 big and small planes
// (split_tf32, round-to-nearest) in the slot. Two CTAs of a cluster take
// row tiles 2q and 2q + 1 of the same N tile, and each copies half of a
// slot's weight blocks into both (multicast), so the weights cross L2 once
// for two tiles; a slot is refilled once both CTAs' consumers released it.
// At T = 3 the tile is position-major (tile row t * 64 + s: a warpgroup per
// position) and a warpgroup issues only the 3 taps that stay inside the
// samples. Its boxes are loaded position-major too, so that the three
// taps read whole 64-row blocks of the planes: each consumer issues a
// slot's 3 taps x 3 passes (small*big, big*small, big*big) of m64nNk8
// wgmmas, A and B from shared memory by descriptor, as one group, and
// keeps one group in flight. At other T the tile is row-major and the
// consumers load each tap's A fragments (shifted by the tap, zero outside
// their sample) from the planes into registers, one tap's 3 passes a
// group. The 1x1
// projection is a second part of K = 1 on the same slots (2 chunks a slot:
// ProjRing), A by descriptor. The chunks, taps and passes go in the order
// the earlier loops took, and the split is theirs, so z, and with it out,
// is the same bit for bit.
//
// Persistent clusters: at most one CTA an SM (the plan's `ctas`, in
// clusters of the plan's `cs`, 2 wherever there are two row tiles), each
// cluster walking items i = cluster, + clusters, .. (row-tile pair i / N
// tiles, N tile i % N tiles); the partner of an odd last row tile runs the
// ring with zeros and stores nothing. At NT = 64 the conv tile [192][NT+4]
// lies beside 5 slots, so while the consumers run one tile's GroupNorm
// statistics, Mish and stores, the producer already fills the ring with the
// next tile's stages. At NT = 128 it lies over a ring of 4 slots instead
// ("deep": two slots beside it do not hide a slot's load round trip), the
// producer starts a tile once the previous tile's epilogue is done in both
// CTAs; with the projection, z goes out to device memory while the
// projection's part runs in the conv's registers, and comes back into the
// tile for the epilogue. The plan (ops/_build.plan_stage) takes the N tile by the
// waves of cluster items over the SMs times a tile's width, the wide one on
// a tie; the launch recomputes the plan's shared-memory bytes, CTAs and
// cluster size and refuses one that differs.
//
// The saving instance (Args = SaveArgs) is the forward of the autograd
// Functions: it also stores z = conv + bias and each (sample, group)'s mean
// and rstd, which conv_backward.cuh reads instead of recomputing the stage.
// The plain instances (Args = StageArgs) compile without it.
//
// L2 traffic: a cluster reads its N tile's weight blocks once for two
// tiles (5 taps x big and small of C x NT, and the projection's) and each
// tile its 192 input rows once: about 8 GB of staged weights and 3.3 GB
// of input rows per denoiser forward at batch 5,376 (plan_stage's tiles),
// all from L2 (the staged weights of one stage fit it).
#pragma once

#include <type_traits>

#include "stage_ring.cuh"

namespace cindm {

// The stage's threads: the three consumer warpgroups and a producer
// warpgroup, whose first warp fills the ring and whose other three split
// each slot's A box (ring_split). A whole warpgroup, so that setmaxnreg can
// move its registers to the consumers: with a producer warp alone (416
// threads) ptxas gave a thread 128 registers, as for 512, and the
// N-tile-128 instances spilled, or serialized their wgmmas (C7512) with two
// groups in flight.
constexpr int kStageThreads = kThreads + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 152;  // 3 x 128 x 152 + 128 x 40 <= 65,536
static_assert(3 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536, "the SM's register file");
static_assert(kThreads + 32 * (1 + kSplitWarps) == kStageThreads, "the producer warpgroup");

// The forward's ring: one chunk of 8 input channels a slot (rows of 32
// bytes), its A box split into two planes beside it (Planes), then the
// chunk's weight blocks: 32,768 bytes a slot at NT = 64, 53,248 at 128.
// NT = 64 keeps 5 slots beside its conv tile, so the producer runs ahead
// during a tile's epilogue. At NT = 128 a tile of its own leaves room for
// two slots only, and two do not hide a slot's load round trip, so the
// conv tile lies over a ring of kDeepStages slots instead ("deep"): the
// producer starts a tile's loads once the previous tile's epilogue is done
// in both CTAs of the cluster (an mbarrier, `epi`), and the projection's
// part runs before the epilogue (the tile can take the conv output only
// once the ring is through), while z waits in device memory (kSpillZ).
constexpr int kDeepStages = 4;
constexpr int kNarrowStages = 5;
template <int NT>
using ConvRing = StageRing<NT, NT == 64 ? kNarrowStages : kDeepStages, 1, 0, true>;
// The projection's part on the same slots: its 1-tap blocks are a fifth of
// a conv's, so a slot takes 2 chunks (rows of 64 bytes) and the part runs
// half as many stages.
constexpr int kProjChunks = 2;
template <int NT>
using ProjRing = StageRing<NT, ConvRing<NT>::kStages, kProjChunks, ConvRing<NT>::kStageBytes, true>;
template <int NT>
constexpr bool proj_fits() {
  using P = ProjRing<NT>;
  return P::kWOff + P::kCh * weight_block_bytes(NT, 1) <= P::kStageBytes;
}
static_assert(proj_fits<64>() && proj_fits<128>(), "a projection stage fits a slot");

// Where a warpgroup's taps read A from shared memory by descriptor: the
// position-major tiles (KW = 3, T = 3). At NT = 64 an m64n64k8 with both
// operands in shared memory reads 4 KB a 32-cycle step, the SM's whole
// shared-memory rate; A's fragments loaded from the split planes into
// registers instead were slower all the same (one 512 -> 256 stage at
// batch 5,376 on an H100: 0.213 against 0.196 ms; PERF.md).
template <int NT, int KW>
constexpr bool kDescA = KW == 3;

// The cluster of a launch of `row_tiles` row tiles: pairs of row tiles of
// the same N tile share its weight blocks (mirrors ops/_build.plan_stage).
__host__ __device__ constexpr int stage_cluster(int row_tiles) { return row_tiles > 1 ? 2 : 1; }

// Shared memory of a stage launch (mirrors ops/_build.plan_stage; the
// launch refuses a plan whose bytes differ): 1,024 bytes to align the ring
// to the swizzle's period, the ring and the conv tile (beside it at NT =
// 64, over it at 128), mean and rstd of the tile's (sample, group) pairs,
// each ring slot's full, empty and abox barriers and the epilogue's
// barrier.
__host__ __device__ inline size_t stage_smem_bytes(int nt, int samples, int groups_per_tile) {
  const bool deep = nt == 128;
  const size_t ring = deep ? ConvRing<128>::kRingBytes : ConvRing<64>::kRingBytes;
  const int stages = deep ? kDeepStages : kNarrowStages;
  const size_t region = deep ? (ring > tile_bytes(nt) ? ring : tile_bytes(nt)) : ring + tile_bytes(nt);
  return 1024 + region + 8 * size_t(samples) * groups_per_tile + 24 * stages + 8;
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
  int cs;             // CTAs of a cluster (1 or 2): row tiles 2q and 2q + 1 share an N tile's weights
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
// tile rt (samples [rt S, rt S + ns); none where rt is past the last row
// tile: a cluster's partner that only keeps the ring going) x N tile nti.
// `it` counts the ring's stages as the producer does. KW = 3: T = 3, the
// tile position-major, A by descriptor (ring_consume_ss); KW = 5: the tile
// row-major, A's fragments from the split planes (ring_consume, kPre).
template <int NT, int KW, bool kSpillZ, class Args>
__device__ __forceinline__ void stage_tile(const Args& a, int rt, int nti, const char* ring, float* tile,
                                           float* mean, float* rstd, const FwdRing& f, uint32_t epi, int& it) {
  constexpr bool kSave = !std::is_same<Args, StageArgs>::value;
  constexpr bool kDeep = NT == 128;
  using CR = ConvRing<NT>;
  using PR = ProjRing<NT>;
  const int b0 = rt * a.samples;
  const int ns = max(0, min(a.samples, a.B - b0));
  const int nrows = ns * a.T;
  const int row0 = b0 * a.T;
  const int n0 = nti * NT;
  const int ncols = min(NT, a.O - n0);
  const int og = a.O / a.G;
  const int gpt = ncols / og;  // whole groups: n0 and ncols are multiples of og
  const bool proj = kDeep ? kSpillZ : a.wres != nullptr;  // deep: an instance of its own with it
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;

  // Deep with the projection: the ring under the tile still has the
  // projection's part to run once the conv's is through, so z = acc + b
  // goes out to device memory (z where the instance saves it, else the rows'
  // own out, which the final pass overwrites), the projection's part takes
  // the accumulator, and the tile is read back from there.
  float* zg;
  if constexpr (kSave)
    zg = a.z;
  else
    zg = a.out;
  constexpr bool spill_z = kSpillZ;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  {
    const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T);
    const RingPart part = ring_part<CR>(a.ws, a.C, kConvK, 0, 1, nti);
    if constexpr (kDescA<NT, KW>)  // position t = wg: taps 2 - t .. 4 - t read positions 0 .. 2
      ring_consume_ss<CR, kConvK>(tr.klo, 0, part, ring, f, it, acc);
    else
      ring_consume<CR, kConvK, KW, Split::kPre, true>(tr, part, ring, f.full, f.empty, it, acc, f.peer);
    if (!spill_z) consumer_sync();  // the previous tile's epilogue is done with the tile and the statistics
    // z[r][c] = acc + b[n0 + c] at the fragment positions, rows in natural
    // order: into the tile, or out to zg
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float bias0 = c < ncols ? __ldg(a.b + n0 + c) : 0.0f;
      const float bias1 = c + 1 < ncols ? __ldg(a.b + n0 + c + 1) : 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v = make_float2(acc[4 * j + 2 * i] + bias0, acc[4 * j + 2 * i + 1] + bias1);
        if (!tr.live[i]) continue;
        if (!spill_z)
          *reinterpret_cast<float2*>(tile + tr.r[i] * (NT + 4) + c) = v;
        else if (c < ncols)  // ncols is even: c + 1 < ncols too
          *reinterpret_cast<float2*>(zg + static_cast<size_t>(row0 + tr.r[i]) * a.O + n0 + c) = v;
      }
    }
  }
  if (spill_z) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    ring_consume_ss<PR, 1>(0, 64 * wg, ring_part<PR>(a.wress, a.Cres, 1, 0, 1, nti), ring, f, it, acc);
    consumer_sync();  // the ring is through; z is out
    for (int i = threadIdx.x; i < nrows * (NT / 4); i += kThreads) {
      const int r = i / (NT / 4), c = 4 * (i % (NT / 4));
      if (c < ncols)
        *reinterpret_cast<float4*>(tile + r * (NT + 4) + c) =
            *reinterpret_cast<const float4*>(zg + static_cast<size_t>(row0 + r) * a.O + n0 + c);
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
    if (c < ncols && !spill_z)
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

  if (proj) {
    // The 1x1 projection: a second part of K = 1 over the same rows in the
    // registers the conv accumulator vacated (deep: run already). The tile
    // is normalised in place first (GN(z), Mish's argument y), Mish meets
    // the product at the fragment positions and bres comes in the final
    // pass: (Mish(y) + xres wres) + bres, Mish's last product fused with the
    // first add as the compiler fuses it in the plain form.
    if constexpr (kSave) consumer_sync();  // z is stored before the tile changes
    if (c < ncols) {
      const float4 scale = __ldg(reinterpret_cast<const float4*>(a.gs + o));
      const float4 shift = __ldg(reinterpret_cast<const float4*>(a.gb + o));
      for (int r = r0; r < nrows; r += kRowStep)
        *reinterpret_cast<float4*>(tile + r * (NT + 4) + c) = affine(r, scale, shift);
    }
    const TileRows tr = tile_rows<1, 1>(a.samples, ns, a.T);
    if constexpr (!kDeep) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
      ring_consume_ss<PR, 1>(0, 64 * wg, ring_part<PR>(a.wress, a.Cres, 1, 0, 1, nti), ring, f, it, acc);
    }
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
      if (proj) {
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
  if (kDeep && lane == 0) {  // this warp is done with the tile over the ring
    mbar_arrive(epi);
    if (f.peer != kNoPeer) mbar_arrive_peer(epi, f.peer);
  }
}

// Args = SaveArgs: the saving instance, which also writes z, mean and rstd
// for the backward (conv_backward.cuh); with StageArgs it compiles without.
// mx: x as position_map views it (kDescA) or ring_map; mres: xres
// as ring_map views it where the projection runs (else unused). Deep: NT =
// 128, the conv tile over the ring; kSpillZ: deep with the projection (z
// goes out to device memory while the projection's part runs), an
// instance of its own so that the deep one without keeps its code.
// Launched in clusters of a.cs CTAs:
// cluster q walks items i = q, q + clusters, .. of (row-tile pair i / N
// tiles, N tile i % N tiles), rank r taking row tile 2 (i / N tiles) + r.
template <int NT, int KW, bool kSpillZ, class Args>
__global__ void __launch_bounds__(kStageThreads, 1)
    conv_gn_mish_stage(const Args a, const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mres) {
  constexpr bool kDeep = NT == 128;
  using R = ConvRing<NT>;
  using P = ProjRing<NT>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;  // the swizzle's period
  const int gmax = (a.O < NT ? a.O : NT) / (a.O / a.G);  // groups of a whole N tile
  float* tile = reinterpret_cast<float*>(kDeep ? smem : smem + R::kRingBytes);
  const size_t region = kDeep ? (R::kRingBytes > tile_bytes(NT) ? R::kRingBytes : tile_bytes(NT))
                              : R::kRingBytes + tile_bytes(NT);
  float* mean = reinterpret_cast<float*>(smem + region);
  float* rstd = mean + a.samples * gmax;
  FwdRing f;
  f.full = smem_u32(rstd + a.samples * gmax);
  f.empty = f.full + 8 * R::kStages;
  f.abox = f.empty + 8 * R::kStages;
  f.cs = a.cs;
  f.rank = cluster_rank();
  f.peer = a.cs == 2 ? f.rank ^ 1u : kNoPeer;
  const uint32_t epi = f.abox + 8 * R::kStages;
  if (threadIdx.x == 0) {
    for (int q = 0; q < R::kStages; ++q) {
      mbar_init(f.full + 8 * q, 1 + kSplitWarps);  // the producer's, one a splitting warp
      mbar_init(f.empty + 8 * q, a.cs * kWarps);   // one arrival a consumer warp of the cluster
      mbar_init(f.abox + 8 * q);
    }
    mbar_init(epi, a.cs * kWarps);
  }
  cluster_sync();  // the barriers of both CTAs are set before either copies or arrives into the other
  // the role, warp-uniform as the compiler can see (a shuffle of lane 0's
  // value): wgmma is issued only in code it knows no warp diverges into
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int ntiles = (a.O + NT - 1) / NT;
  const int row_tiles = (a.B + a.samples - 1) / a.samples;
  const int items = (row_tiles + a.cs - 1) / a.cs * ntiles;
  const int cluster = blockIdx.x / a.cs, clusters = gridDim.x / a.cs;
  const bool proj = kDeep ? kSpillZ : a.wres != nullptr;
  int it = 0;
  if (warp >= kWarps) {
    regs_dec<kProducerRegs>();
    int local = 0;  // this CTA's tiles so far
    for (int i = cluster; i < items; i += clusters, ++local) {
      const int rt = i / ntiles * a.cs + static_cast<int>(f.rank), nti = i % ntiles;
      const int b0 = rt * a.samples, row0 = b0 * a.T;
      const RingPart conv = ring_part<R>(a.ws, a.C, kConvK, 0, 1, nti);
      const RingPart pres = ring_part<P>(a.wress, a.Cres, 1, 0, 1, nti);
      if (warp == kWarps) {
        if (kDeep && local > 0) mbar_wait(epi, (local - 1) & 1);  // the tile over both rings is free
        if constexpr (kDescA<NT, KW>)  // T = 3: positions 0, 1, 2 of 64 samples, one box each
          ring_feed<R>(conv, [&](char* st, int c, uint32_t bar) {
            for (int t = 0; t < 3; ++t) tma_load_3d(st + t * 64 * R::kPitch, &mx, c, t, b0, bar);
          }, smem, f, it);
        else
          ring_feed<R>(conv, [&](char* st, int c, uint32_t bar) { tma_load_2d(st, &mx, c, row0, bar); }, smem, f,
                       it);
        if (proj)
          ring_feed<P>(pres, [&](char* st, int c, uint32_t bar) { tma_load_2d(st, &mres, c, row0, bar); },
                       smem, f, it);
      } else {
        const int t = threadIdx.x - kThreads - 32;
        ring_split<R>(conv, smem, f, t, it);
        if (proj) ring_split<P>(pres, smem, f, t, it);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    for (int i = cluster; i < items; i += clusters)
      stage_tile<NT, KW, kSpillZ>(a, i / ntiles * a.cs + static_cast<int>(f.rank), i % ntiles, smem, tile, mean,
                                rstd, f, epi, it);
  }
  cluster_sync();  // no CTA leaves while its peer may still copy or arrive into it
}

cudaError_t launch_stage_weights(const float* w, int K, int C, int O, int nt, uint32_t* out,
                                 cudaStream_t stream) {
  const size_t total = staged_weight_bytes(nt, C, O, K) / 4;
  const size_t blocks = (total + 255) / 256;
  stage_weights<<<blocks < 4096 ? blocks : 4096, 256, 0, stream>>>(w, K, C, O, nt, out, total);
  return cudaGetLastError();
}

// The CTAs of a stage launch of `items` cluster items (row-tile pairs x N
// tiles) in clusters of cs on the current device: cs CTAs an item, one an
// SM at most (mirrors ops/_build.plan_stage).
cudaError_t stage_ctas(int items, int cs, int* ctas) {
  int dev = 0, sms = 0;
  CINDM_TRY(cudaGetDevice(&dev));
  CINDM_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  *ctas = cs * (items < sms / cs ? items : sms / cs);
  return cudaSuccess;
}

template <int NT, int KW, bool kSpillZ, class Args>
cudaError_t launch_nt(const Args& a, size_t bytes, int ctas, const CUtensorMap& mx, const CUtensorMap& mres,
                      cudaStream_t stream) {
  static unsigned long long smem_set = 0;  // devices where the attribute is set
  const auto k = conv_gn_mish_stage<NT, KW, kSpillZ, Args>;
  CINDM_TRY(allow_smem_once(k, smem_set));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kStageThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = a.cs;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  void* params[] = {const_cast<Args*>(&a), const_cast<CUtensorMap*>(&mx), const_cast<CUtensorMap*>(&mres)};
  CINDM_TRY(cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(k), params));
  return cudaGetLastError();
}

// One stage: lay the weights out (stage_weights into a.ws, a.wress), then
// launch the stage kernel with the planner's tile: `samples` whole samples
// per tile, an N tile of `nt` channels, `smem_bytes` of dynamic shared
// memory, `ctas` persistent CTAs in clusters of `cs`. With SaveArgs it
// launches the saving instance. Refuses (cudaErrorInvalidValue) a plan that
// breaks the tiling's rules or differs from the one recomputed here.
template <class Args>
cudaError_t launch_stage(const Args& a0, int K, int nt, int smem_bytes, int ctas, int cs, void* stream) {
  Args a = a0;
  const bool proj = a.wres != nullptr;
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.O <= 0 || a.G <= 0 || a.O % a.G != 0 ||
      a.C % 4 != 0 || a.O % 4 != 0 || K != kConvK || (nt != 64 && nt != 128) ||
      a.samples <= 0 || a.samples * a.T > kTileRows || (a.T == 3 && a.samples != 64) || a.ws == nullptr ||
      (proj && (a.Cres <= 0 || a.Cres % 4 != 0 || a.wress == nullptr || a.xres == nullptr)) ||
      (proj != (a.bres != nullptr)))
    return cudaErrorInvalidValue;
  const int og = a.O / a.G;
  if (a.O > nt && nt % og != 0) return cudaErrorInvalidValue;  // an N tile holds whole groups
  const int gpt = (a.O < nt ? a.O : nt) / og;
  const size_t bytes = stage_smem_bytes(nt, a.samples, gpt);
  if (static_cast<size_t>(smem_bytes) != bytes || bytes > kSmemMax) return cudaErrorInvalidValue;
  const int row_tiles = (a.B + a.samples - 1) / a.samples;
  a.cs = stage_cluster(row_tiles);
  int want = 0;
  CINDM_TRY(stage_ctas((row_tiles + a.cs - 1) / a.cs * ((a.O + nt - 1) / nt), a.cs, &want));
  if (cs != a.cs || ctas != want) return cudaErrorInvalidValue;
  constexpr int kPitch = ConvRing<64>::kPitch;  // one chunk a slot at either N tile
  static_assert(ConvRing<128>::kPitch == kPitch && ProjRing<128>::kPitch == ProjRing<64>::kPitch, "");
  CUtensorMap mx, mres;
  if (a.T == 3)  // kDescA
    CINDM_TRY(position_map(&mx, a.x, a.B, a.T, a.C, kPitch));
  else
    CINDM_TRY(ring_map(&mx, a.x, a.B * a.T, a.C, kPitch));
  if (proj)
    CINDM_TRY(ring_map(&mres, a.xres, a.B * a.T, a.Cres, ProjRing<64>::kPitch));
  else
    mres = mx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CINDM_TRY(launch_stage_weights(a.w, K, a.C, a.O, nt, a.ws, s));
  if (proj) CINDM_TRY(launch_stage_weights(a.wres, 1, a.Cres, a.O, nt, a.wress, s));
  if (a.T == 3)
    return nt == 64 ? launch_nt<64, 3, false>(a, bytes, ctas, mx, mres, s)
                    : proj ? launch_nt<128, 3, true>(a, bytes, ctas, mx, mres, s)
                           : launch_nt<128, 3, false>(a, bytes, ctas, mx, mres, s);
  return nt == 64 ? launch_nt<64, kConvK, false>(a, bytes, ctas, mx, mres, s)
                  : proj ? launch_nt<128, kConvK, true>(a, bytes, ctas, mx, mres, s)
                         : launch_nt<128, kConvK, false>(a, bytes, ctas, mx, mres, s);
}

}  // namespace
}  // namespace cindm
