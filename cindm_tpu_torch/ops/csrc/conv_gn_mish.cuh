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
// another tile. Only a split tile's K is summed across CTAs (below).
//
// Main loop: the forward's of stage_ring.cuh (its dgrads' loop beside it).
// A producer warpgroup feeds three consumer warpgroups (64 rows each)
// through a ring of slots of one chunk of 8 input channels: its first warp
// loads the tile's 192 input rows of the chunk by TMA and the chunk's
// weight blocks by bulk copy; its other three warps split each box, once
// it is in, into tf32 big and small planes (split_tf32, round-to-nearest)
// in the slot. The weight blocks are the tf32 big/small planes that
// stage_weights lays out, one contiguous block per (N tile, chunk): its own
// launch (cindm_stage_weights, below), one for all of a call's weights
// that changed, which the wrappers keep per weight version and N tile
// (ops/_build.staged), not laid out on every call. Two
// CTAs of a cluster take row tiles 2q and 2q + 1 of the same N tile, and
// each copies half of a slot's weight blocks into both (multicast), so the
// weights cross L2 once for two tiles; a slot is refilled once both CTAs'
// consumers released it. At T = 3 the tile is position-major (tile row t *
// 64 + s: a warpgroup per position) and a warpgroup issues only the 3 taps
// that stay inside the samples. Its boxes are loaded position-major too, so
// that the three taps read whole 64-row blocks of the planes: each consumer
// issues a slot's 3 taps x 3 passes (small*big, big*small, big*big) of
// m64nNk8 wgmmas, A and B from shared memory by descriptor, as one group,
// and keeps one group in flight. At other T the tile is row-major and the
// consumers load each tap's A fragments (shifted by the tap, zero outside
// their sample) from the planes into registers, one tap's 3 passes a
// group. The chunks, taps and passes go in the order the earlier loops
// took, and the split is theirs, so z is the same bit for bit.
//
// Epilogue, from the consumers' registers: no tile of the conv output in
// shared memory. z = acc + b stays in the fragments. The GroupNorm
// statistics are two-pass with biased variance in fixed orders: each
// thread adds its values of a group in column order, the 4 lanes that share
// a row add theirs as (l0 + l1) + (l2 + l3) (__shfl_xor_sync) and write the
// row's sum to a [192][groups] array (row_group_sums); after a barrier of
// the 384 consumer threads one thread per (sample, group) adds its T rows
// in row order (pair_stats) into the mean, and the squared deviations from
// the registers go the same way into rstd. No atomics: two runs give the
// same bits. Then, in registers: the GroupNorm affine, Mish, + temb or +
// the identity residual, and 16-byte stores from the fragments (a shuffle
// between lane pairs makes float4s of two n8 blocks' pairs: a quad writes
// 64 contiguous bytes of its row, 8 rows a warp store; float2 stores of
// 32-byte segments made the pass 30-50% slower than the earlier tile's). The 1x1 projection (ProjRing: a part of K = 1 on the same
// slots, 2 chunks a slot, A by descriptor, its boxes position-major at T =
// 3 as the conv's) runs first, from zero, in the registers the conv takes
// next: its product P goes to the rows' own out while the conv's loop runs,
// and the final pass reads it back (each thread its own) as it reads the
// identity residual: out = (Mish(y) + P) + bres, the plain form's order.
// One accumulator all along. Accumulated onto Mish(y) instead, the
// product's wgmma steps (3 passes x C / 8) each round at Mish(y)'s ulp:
// 1024 -> 512 at T = 3 then ended 1.1e-4 from the plain version (H100).
//
// Persistent clusters: at most one CTA an SM (the plan's `ctas`, in
// clusters of the plan's `cs`, 2 wherever there are two row tiles), each
// cluster walking whole items i = cluster, + clusters, .. (row-tile pair i
// / N tiles, N tile i % N tiles) as long as they fill whole waves; the
// partner of an odd last row tile runs the ring with zeros and stores
// nothing. Nothing lies over the ring, so the producer runs on into the
// next tile's slots while the consumers run this tile's epilogue: 6 slots
// at NT = 64, 4 at NT = 128. The plan (ops/_build.plan_stage) takes the N
// tile by the waves of cluster items over the SMs times a tile's width,
// the wide one on a tie; the launch recomputes the plan's shared-memory
// bytes, CTAs, cluster size and split and refuses one that differs.
//
// The split tail (stage_split): the items past the last full wave (every
// item of a launch of fewer items than clusters) would leave most clusters
// idle, so their K chunks, as one sequence, are cut into one contiguous
// range a cluster, ranges that differ by a chunk at most: at batch 5,376 a
// stage runs 168 items on 66 clusters, 2.55 waves of work in 3 of time, at
// 512 16 or 32. A range's run of each tile it meets is a part of that tile
// (RingPart's chunks [c0, c1), walked by producer and consumers alike);
// the projection runs whole in a tile's first part, which writes P to out
// as a whole tile does. Each part stores its partial sums, fragment-major
// (each thread's own float4s, 512 contiguous bytes a warp store), to its
// slot of the workspace, then one thread counts the part in on the tile's
// counter (atom.acq_rel.gpu: it releases the CTA's stores, P's included,
// and acquires the other parts'). The part that finds itself last sums the
// tile's parts in part order, not arrival order (part 0's partial sums from
// its registers where it is part 0), resets the counter to 0 for the next
// launch and runs the epilogue; the others go on to their next part. No
// CTA waits on another, so nothing depends on which CTAs are resident, and
// two runs give the same bits. Whole tiles keep the path above, bit for bit.
// A cluster walks its range's items in the order that lets it finish only
// the tile of its last part (cluster_part). What a split costs: its fixup,
// 0.006-0.010 ms a launch on an H100 (PERF.md), which 8-chunk tiles' short
// ranges do not win back.
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
// groups in flight. The consumers hold the accumulator through the
// epilogue; at 152 registers the N-tile-128 instances with the projection
// still spilled a few, at 160 (the producer's 32 suffice) none does.
constexpr int kStageThreads = kThreads + 128;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;  // 3 x 128 x 160 + 128 x 32 = 65,536
static_assert(3 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536, "the SM's register file");
static_assert(kThreads + 32 * (1 + kSplitWarps) == kStageThreads, "the producer warpgroup");

// The forward's ring: one chunk of 8 input channels a slot (rows of 32
// bytes), its A box split into two planes beside it (Planes), then the
// chunk's weight blocks: 32,768 bytes a slot at NT = 64, 53,248 at 128.
// No conv tile shares the shared memory with it, so NT = 64 takes 6 slots
// and NT = 128 4 (a fifth would not fit).
constexpr int kWideStages = 4;
constexpr int kNarrowStages = 6;
template <int NT>
using ConvRing = StageRing<NT, NT == 64 ? kNarrowStages : kWideStages, 1, 0, true>;
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
// to the swizzle's period, the ring, the rows' sums of each group of the
// tile [192][groups_per_tile], each (sample, group)'s mean and rstd, each
// ring slot's full, empty and abox barriers, and 16 bytes for the word that
// tells a split tile's consumers whether they finish it.
__host__ __device__ inline size_t stage_smem_bytes(int nt, int samples, int groups_per_tile) {
  const size_t ring = nt == 128 ? ConvRing<128>::kRingBytes : ConvRing<64>::kRingBytes;
  const int stages = nt == 128 ? kWideStages : kNarrowStages;
  return 1024 + ring + 4 * size_t(kTileRows) * groups_per_tile + 8 * size_t(samples) * groups_per_tile +
         24 * stages + 16;
}

// The split tail (stage_split in stage_ring.cuh) runs where kSplitTail.
constexpr bool kSplitTail = true;

// One stage launch's plan as ops/_build.plan_stage makes it (the ctypes
// structure _build.StageLaunch mirrors it field for field): the launch
// recomputes every field but the pointers and byte counts and refuses a
// plan that differs, or a workspace or counters too small for its split.
struct StageLaunch {
  int samples;        // whole samples per tile (samples * T <= 192)
  int n_tile;         // 64 or 128 output channels
  int cluster;        // CTAs of a cluster
  int smem_bytes;     // stage_smem_bytes
  int ctas;           // persistent CTAs
  int tail, tail_clusters, max_parts;  // stage_split
  float* work;        // the split tiles' workspace, work_bytes of it
  int* counters;      // their arrival counters, n_counters of them, all 0
  long long work_bytes;
  int n_counters;
};

struct StageArgs {
  const float* x;     // [B, T, C]  conv input
  const float* b;     // [O]
  const float* gs;    // [O] GroupNorm scale
  const float* gb;    // [O] GroupNorm bias
  const float* temb;  // [B, O] added after Mish (rows temb_ld floats apart), or null
  const float* xres;  // [B, T, O] identity residual, or [B, T, Cres] projection input, or null
  const float* bres;  // [O], with the projection
  float* out;         // [B, T, O]
  const uint32_t* ws;     // w [5, C, O] laid out by stage_weights (staged_weight_bytes(nt, C, O, 5))
  const uint32_t* wress;  // the 1x1 projection wres [Cres, O] laid out likewise (K = 1), or null
  int B, T, C, O, G, Cres;
  int temb_ld;        // floats between temb's rows: O, or more for a view of every block's projections
  float eps;
  int samples;        // whole samples per tile (samples * T <= 192)
  int cs;             // CTAs of a cluster (1 or 2): row tiles 2q and 2q + 1 share an N tile's weights
  int items, chunks;  // cluster items, and K chunks of an item
  StageSplit split;   // the split tail
  float* work;        // its workspace: slot ((tail item * max_parts + part) * cs + rank), 192 x NT floats
  int* counters;      // its arrival counters: tail item * cs + rank, 0 between launches
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

// stage_weights: the weights w [K][C][O] of up to three convs (a block's
// w1, w2 and wres, or the head's w: one LayoutJob each) laid out as the
// stage reads them, in tf32 big and small planes, for N tiles of NT: for
// each N tile and chunk of 8 input channels one block of
// weight_block_bytes(NT, K), contiguous, so that one bulk copy stages it.
// Within a plane, word e is channel (e / 64) * 8 + (e % 32) / 4 of input
// (e % 64) / 32 * 4 + e % 4 (kSboBytes = 64 words per n8 block, kLboBytes =
// 32 words per K half). Channels past C or O are zero.
//
// It replaces no TPU kernel: it is the weight layout of the ports of
// cindm_tpu/ops/fused_rtb.py:179 and cindm_tpu/ops/fused_conv_gn.py:112,
// run once per weight version (ops/_build.staged). What bounds it on an
// H100: bytes. Each weight is read once and two planes of it are written:
// 226 MB for the denoiser's 16 blocks and head at batch 5,376's N tiles,
// 0.067 ms at 3.35 TB/s. So the design moves each byte once, in 16-byte
// pieces, with no more arithmetic a word than the split: a thread block
// per (job, N tile, group of 8 chunks, tap) reads w[tap][c0 .. c0 + 64][o0
// .. o0 + NT] along O, its contiguous axis (a float4 a thread, a warp 256
// or 512 contiguous bytes; O is a multiple of 4 and w 16-byte aligned),
// into a shared tile [64][NT + 4], zero past C or O. After one barrier it
// writes, for each of the 8 chunks, the tap's big and small planes, each a
// contiguous run of NT x 8 words: words e .. e + 3 are four consecutive
// inputs of one channel, a column of the tile, so a thread reads 4 values,
// splits each once (split_tf32, round-to-nearest) and stores a uint4 to
// each plane, a warp 512 contiguous bytes. Tile rows are kLayoutPitch =
// 132 floats apart, 4 banks: each of a warp's four reads takes 16
// consecutive channels (16 banks) of two inputs 4 rows (16 banks) apart,
// 32 distinct banks. One launch for a call's weights (17 for the denoiser,
// not 43), a grid of exactly the jobs' blocks, and 32-bit index arithmetic
// (the launch refuses a job of 2^31 words or more).
constexpr int kLayoutPitch = 128 + 4;

template <int NT>
__global__ void __launch_bounds__(kLayoutThreads) stage_weights(const LayoutJob j0, const LayoutJob j1,
                                                                const LayoutJob j2) {
  static_assert(kSboBytes == 256 && kLboBytes == 128, "the indexing below is for dense blocks");
  static_assert(NT + 4 <= kLayoutPitch && kLayoutPitch % 32 == 4, "conflict-free plane reads");
  __shared__ __align__(16) float s[kLayoutCols][kLayoutPitch];
  const LayoutBlock lb = layout_block(j0, j1, j2);
  const LayoutJob& j = lb.j;
  const int o0 = lb.ntile * NT, c0 = lb.grp * kLayoutCols;
  constexpr int kRow4 = NT / 4;  // float4s of a tile row
  const float* src = j.w + (lb.tap * j.C + c0) * j.O + o0;
#pragma unroll
  for (int k = 0; k < kLayoutCols * kRow4 / kLayoutThreads; ++k) {
    const int i = threadIdx.x + k * kLayoutThreads, c = i / kRow4, o = 4 * (i % kRow4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + c < j.C && o0 + o < j.O) v = __ldg(reinterpret_cast<const float4*>(src + c * j.O + o));
    *reinterpret_cast<float4*>(&s[c][o]) = v;
  }
  __syncthreads();
  constexpr int kPlane = NT * 8;     // words of a plane
  constexpr int kQuads = kPlane / 4;  // its uint4s
  const int block = 2 * j.K * kPlane;
  const int nch = min(8, lb.nchunks - lb.grp * 8);
  uint32_t* out = j.out + (lb.ntile * lb.nchunks + lb.grp * 8) * block + 2 * lb.tap * kPlane;
  for (int i = threadIdx.x; i < nch * kQuads; i += kLayoutThreads) {
    const int ch = i / kQuads, e = 4 * (i % kQuads);
    const int o = (e >> 6) * 8 + ((e & 31) >> 2), c = ch * kChunk + ((e & 63) >> 5) * 4;
    uint4 big, small;
    split_tf32(s[c][o], big.x, small.x);
    split_tf32(s[c + 1][o], big.y, small.y);
    split_tf32(s[c + 2][o], big.z, small.z);
    split_tf32(s[c + 3][o], big.w, small.w);
    uint32_t* dst = out + ch * block + e;
    *reinterpret_cast<uint4*>(dst) = big;
    *reinterpret_cast<uint4*>(dst + kPlane) = small;
  }
}

// The GroupNorm statistics' first step, from the registers: per row of the
// thread's two fragment rows, the sum over each group of the tile of z
// (kSq = false) or of (z - mean)^2 (kSq = true, mean from stats[].x) into
// psum[r * gpt + group]. A thread adds its values of a group in column
// order (8j + 2q + e: j, then e), the squares by fused multiply-add, from 0;
// the 4 lanes that share a row add theirs as (l0 + l1) + (l2 + l3), the
// same bits in each lane; lane group % 4 of them writes. sb[i]: the
// stats index of row i's sample (its first group). Groups of a multiple of 8
// channels take whole n8 blocks (j) of the fragment; others test each
// column.
template <int NT, bool kSq>
__device__ __forceinline__ void row_group_sums(const float (&acc)[NT / 2], const TileRows& tr, const int (&sb)[2],
                                               int og, int gpt, const float2* stats, float* psum) {
  const int q = threadIdx.x & 3;
  auto put = [&](float v0, float v1, int g) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
    v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
    v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
    v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
    if (q == (g & 3)) {
      if (tr.live[0]) psum[tr.r[0] * gpt + g] = v0;
      if (tr.live[1]) psum[tr.r[1] * gpt + g] = v1;
    }
  };
  auto add = [](float s, float v, float m) {
    if constexpr (kSq) {
      const float d = v - m;
      return fmaf(d, d, s);
    } else {
      return s + v;
    }
  };
  if ((og & 7) == 0) {
    const int jpg = og >> 3;  // n8 blocks a group
    float s0 = 0.0f, s1 = 0.0f, m0 = 0.0f, m1 = 0.0f;
    int k = 0, g = 0;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (kSq && k == 0 && g < gpt) {
        m0 = stats[sb[0] + g].x;
        m1 = stats[sb[1] + g].x;
      }
      s0 = add(add(s0, acc[4 * j], m0), acc[4 * j + 1], m0);
      s1 = add(add(s1, acc[4 * j + 2], m1), acc[4 * j + 3], m1);
      if (++k == jpg) {
        if (g < gpt) put(s0, s1, g);
        s0 = s1 = 0.0f;
        k = 0;
        ++g;
      }
    }
  } else {
    for (int g = 0; g < gpt; ++g) {
      const int lo = g * og - 2 * q;  // column 8j + 2q + e lies in group g where lo <= 8j + e < lo + og
      const float m0 = kSq ? stats[sb[0] + g].x : 0.0f, m1 = kSq ? stats[sb[1] + g].x : 0.0f;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e >= lo && 8 * j + e < lo + og) {
            s0 = add(s0, acc[4 * j + e], m0);
            s1 = add(s1, acc[4 * j + 2 + e], m1);
          }
      put(s0, s1, g);
    }
  }
}

// The statistics' second step: per (sample, group) pair of the tile, one
// thread adds its sample's T rows of psum in row order, from 0, and divides
// by the group's n elements: the mean (kSq = false, into stats[].x) or the
// biased variance, of which 1/sqrt(var + eps) (kSq = true, into stats[].y);
// `out` (the saving instance's mean or rstd [B, G], element out0 + s G + g),
// or null.
template <bool kSq>
__device__ __forceinline__ void pair_stats(const float* psum, int ns, int T, int gpt, int G, float n, float eps,
                                           float2* stats, float* out, size_t out0) {
  for (int p = threadIdx.x; p < ns * gpt; p += kThreads) {
    const int s = p / gpt, g = p - s * gpt;
    const float* src = psum + s * T * gpt + g;
    float v = 0.0f;
    for (int t = 0; t < T; ++t) v += src[t * gpt];
    v /= n;
    if constexpr (kSq) {
      v = rsqrtf(v + eps);
      stats[p].y = v;
    } else {
      stats[p].x = v;
    }
    if (out != nullptr) out[out0 + static_cast<size_t>(s) * G + g] = v;
  }
}

// Part n of the walk of this CTA's cluster (walk_part): with the
// projection in range order, else the range's last item first.
__device__ __forceinline__ bool cluster_part(const StageArgs& a, int n, StagePart& p) {
  return walk_part(a.items, a.chunks, a.split, a.cs, a.wress == nullptr, n, p);
}

// Calls f(part) for each part of this CTA's cluster, in order. The
// producer and the consumers walk alike, so their ring stages agree.
template <class F>
__device__ __forceinline__ void walk_parts(const StageArgs& a, const F& f) {
  StagePart p;
  for (int n = 0; cluster_part(a, n, p); ++n) f(p);
}

// One part of a tile of a persistent CTA's walk (all of it for a whole
// tile), on the consumer warpgroups: row tile rt (samples [rt S, rt S +
// ns); none where rt is past the last row tile: a cluster's partner that
// only keeps the ring going) x N tile nti, chunks [p.c0, p.c1). `it` counts
// the ring's stages as the producer does. KW = 3: T = 3, the tile
// position-major, A by descriptor (ring_consume_ss); KW = 5: the tile
// row-major, A's fragments from the split planes (ring_consume, kPre).
// kProj: with the 1x1 projection (a.wress), an instance of its own:
// decided at run time, the accumulator's flow merged at branches and ptxas
// serialized every instance's wgmmas (C7511) and spilled at NT = 128; a
// part past a tile's first runs the projection's loop over no chunks.
// psum [192][gpt] and stats [samples][gpt] (mean, rstd) are the CTA's;
// its split tiles' word (finish_split) lies past the barriers. The
// epilogue runs where the tile is whole, or this part finishes it.
template <int NT, int KW, bool kProj, class Args>
__device__ __forceinline__ void stage_tile(const Args& a, StagePart p, int rt, int nti, const char* ring,
                                           float* psum, float2* stats, const FwdRing& f, int& it) {
  constexpr bool kSave = !std::is_same<Args, StageArgs>::value;
  using CR = ConvRing<NT>;
  using PR = ProjRing<NT>;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  {
    const int ns = max(0, min(a.samples, a.B - rt * a.samples));
    const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T);
    if constexpr (kProj) {
      // the 1x1 projection first, whole, in a tile's first part, from zero,
      // in the registers the conv then takes (its rows in the conv's tile
      // order: at T = 3 its boxes are position-major too); its product P
      // goes to the rows' own out, which the final pass reads back (this
      // thread, or its counterpart in the part that finishes a split
      // tile), then is overwritten
      const bool first = p.c0 == 0;
      const RingPart pres = ring_range<PR>(a.wress, a.Cres, 1, 0, first ? (a.Cres + kChunk - 1) / kChunk : 0, nti);
      ring_consume_ss<PR, 1>(0, 64 * (threadIdx.x >> 7), pres, ring, f, it, acc);
      const int n0 = nti * NT, ncols = min(NT, a.O - n0);
      const int q = threadIdx.x & 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* prow = a.out + static_cast<size_t>(rt * a.samples * a.T + tr.r[i]) * a.O + n0;
#pragma unroll
        for (int j = 0; j < NT / 8; j += 2) {
          const float4 pp = quad_pairs(make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]),
                                       make_float2(acc[4 * j + 4 + 2 * i], acc[4 * j + 5 + 2 * i]), q);
          if (first && tr.live[i] && quad_col(j, q) < ncols) *reinterpret_cast<float4*>(prow + quad_col(j, q)) = pp;
        }
      }
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    }
    const RingPart conv = ring_range<CR>(a.ws, a.C, kConvK, p.c0, p.c1, nti);
    if constexpr (kDescA<NT, KW>)  // position t = wg: taps 2 - t .. 4 - t read positions 0 .. 2
      ring_consume_ss<CR, kConvK>(tr.klo, 0, conv, ring, f, it, acc);
    else
      ring_consume<CR, kConvK, KW, Split::kPre, true>(tr, conv, ring, f.full, f.empty, it, acc, f.peer);
  }
  // The epilogue's indices come after the loop, from the tile's and the
  // thread's indices passed through an empty asm, so that the compiler
  // neither keeps them live across the loop (the NT = 128 instances with the
  // projection spilled them there) nor merges them with the loop's own.
  unsigned tid = threadIdx.x;
  asm volatile("" : "+r"(rt), "+r"(nti), "+r"(tid), "+r"(p.tag));
  const uint32_t flag = f.abox + 8 * CR::kStages;  // the word past the barriers
  if (parts_of(p.tag) > 1 &&
      !finish_split<NT>(a.work, a.counters, a.split.max_parts, a.cs, p.tag, f.rank, a.B > rt * a.samples, flag, acc))
    return;
  const int b0 = rt * a.samples;
  const int ns = max(0, min(a.samples, a.B - b0));
  const int row0 = b0 * a.T;
  const int n0 = nti * NT;
  const int ncols = min(NT, a.O - n0);
  const int og = a.O / a.G;
  const int gpt = ncols / og;  // whole groups: n0 and ncols are multiples of og
  const int q = tid & 3;
  const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T, tid);

  // z = acc + b at the fragment positions (columns 8j + 2q, + 1 of rows
  // tr.r[0], tr.r[1]). The registers are written on every path and the
  // loads are predicated, past ncols (where the weights are zero) to 0:
  // every address is a row's base + 32j bytes, an immediate offset (ncols
  // is even: c + 1 < ncols with c)
  const size_t grow[2] = {static_cast<size_t>(row0 + tr.r[0]) * a.O + n0,
                          static_cast<size_t>(row0 + tr.r[1]) * a.O + n0};
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int c = 8 * j + 2 * q;
    float2 bias = make_float2(0.0f, 0.0f);
    if (c < ncols) bias = __ldg(reinterpret_cast<const float2*>(a.b + n0 + c));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[4 * j + 2 * i] += bias.x;
      acc[4 * j + 2 * i + 1] += bias.y;
    }
  }
  if constexpr (kSave)
#pragma unroll
    for (int j = 0; j < NT / 8; j += 2)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 z = quad_pairs(make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]),
                                    make_float2(acc[4 * j + 4 + 2 * i], acc[4 * j + 5 + 2 * i]), q);
        if (tr.live[i] && quad_col(j, q) < ncols) *reinterpret_cast<float4*>(a.z + grow[i] + quad_col(j, q)) = z;
      }

  // the statistics: rows' sums, then the pairs', for the mean and then rstd
  const int smp[2] = {tr.live[0] ? tr.r[0] / a.T : 0, tr.live[1] ? tr.r[1] / a.T : 0};
  const int sb[2] = {smp[0] * gpt, smp[1] * gpt};
  {
    const float n = static_cast<float>(a.T * og);
    float* mean_out = nullptr;
    float* rstd_out = nullptr;
    if constexpr (kSave) {
      mean_out = a.mean;
      rstd_out = a.rstd;
    }
    const size_t out0 = static_cast<size_t>(b0) * a.G + n0 / og;
    row_group_sums<NT, false>(acc, tr, sb, og, gpt, stats, psum);
    consumer_sync();  // psum is whole (and the previous tile's readers of stats are done)
    pair_stats<false>(psum, ns, a.T, gpt, a.G, n, a.eps, stats, mean_out, out0);
    consumer_sync();  // the means are in
    row_group_sums<NT, true>(acc, tr, sb, og, gpt, stats, psum);
    consumer_sync();
    pair_stats<true>(psum, ns, a.T, gpt, a.G, n, a.eps, stats, rstd_out, out0);
    consumer_sync();  // rstd is in
  }

  // GN(z) -> Mish, + temb and the identity residual, or + P and bres:
  // (Mish(y) + P) + bres, Mish's last product fused with P's add as the
  // compiler fuses it in the plain form; the stores. Each row's (mean,
  // rstd) of a group: where groups span whole n8 blocks, loaded once a
  // group (jpg blocks); else per column, its group from a float product
  // (exact here: c < 128, og <= 128).
  const int jpg = (og & 7) == 0 ? og >> 3 : 0;
  const float inv_og = 1.0f / og;
  float2 st[2][2];  // [row][column of the pair]
  int k = 0, gw = 0;
#pragma unroll
  for (int j = 0; j < NT / 8; j += 2) {
    float2 v[2][2];  // [block j, j + 1][row]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * (j + h) + 2 * q;
      if (jpg != 0) {
        if (k == 0 && gw < gpt)
#pragma unroll
          for (int i = 0; i < 2; ++i) st[i][0] = st[i][1] = stats[sb[i] + gw];
        if (++k == jpg) k = 0, ++gw;
      } else {
        const int g0 = c < ncols ? static_cast<int>((c + 0.5f) * inv_og) : 0;
        const int g1 = c < ncols ? static_cast<int>((c + 1.5f) * inv_og) : 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) st[i][0] = stats[sb[i] + g0], st[i][1] = stats[sb[i] + g1];
      }
      float2 scale = make_float2(0.0f, 0.0f), shift = scale;  // past ncols: Mish(0), never stored
      if (c < ncols) {
        scale = __ldg(reinterpret_cast<const float2*>(a.gs + n0 + c));
        shift = __ldg(reinterpret_cast<const float2*>(a.gb + n0 + c));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[h][i] = make_float2(mish((acc[4 * (j + h) + 2 * i] - st[i][0].x) * st[i][0].y * scale.x + shift.x),
                              mish((acc[4 * (j + h) + 2 * i + 1] - st[i][1].x) * st[i][1].y * scale.y + shift.y));
    }
    const int c4 = quad_col(j, q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float4 o = quad_pairs(v[0][i], v[1][i], q);
      if (!tr.live[i] || c4 >= ncols) continue;
      if constexpr (kProj) {
        // P, which this thread or its counterpart in the tile's first part wrote: from L2
        const float4 pr = __ldcg(reinterpret_cast<const float4*>(a.out + grow[i] + c4));
        const float4 bres = __ldg(reinterpret_cast<const float4*>(a.bres + n0 + c4));
        o = make_float4((o.x + pr.x) + bres.x, (o.y + pr.y) + bres.y, (o.z + pr.z) + bres.z, (o.w + pr.w) + bres.w);
      } else {
        if (a.temb != nullptr) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(a.temb + (b0 + smp[i]) * size_t(a.temb_ld) + n0 + c4));
          o.x += t.x, o.y += t.y, o.z += t.z, o.w += t.w;
        }
        if (a.xres != nullptr) {  // the identity residual
          const float4 t = __ldg(reinterpret_cast<const float4*>(a.xres + grow[i] + c4));
          o.x += t.x, o.y += t.y, o.z += t.z, o.w += t.w;
        }
      }
      *reinterpret_cast<float4*>(a.out + grow[i] + c4) = o;
    }
  }
  __syncwarp();  // the warp converges before the next tile's wgmmas
}

// Args = SaveArgs: the saving instance, which also writes z, mean and rstd
// for the backward (conv_backward.cuh); with StageArgs it compiles without.
// kProj: with the 1x1 projection (a.wress). mx: x as position_map views it
// (kDescA) or ring_map; mres: xres likewise (its own pitch) where the
// projection runs (else unused). Launched in clusters of a.cs CTAs:
// cluster q walks its parts (walk_parts) of items i (row-tile pair i / N
// tiles, N tile i % N tiles), rank r taking row tile 2 (i / N tiles) + r;
// its consumers' word for split tiles lies past the barriers.
template <int NT, int KW, bool kProj, class Args>
__global__ void __launch_bounds__(kStageThreads, 1)
    conv_gn_mish_stage(const Args a, const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mres) {
  using R = ConvRing<NT>;
  using P = ProjRing<NT>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;  // the swizzle's period
  const int gmax = (a.O < NT ? a.O : NT) / (a.O / a.G);  // groups of a whole N tile
  float* psum = reinterpret_cast<float*>(smem + R::kRingBytes);
  float2* stats = reinterpret_cast<float2*>(psum + kTileRows * gmax);
  FwdRing f;
  f.full = smem_u32(stats + a.samples * gmax);
  f.empty = f.full + 8 * R::kStages;
  f.abox = f.empty + 8 * R::kStages;
  f.cs = a.cs;
  f.rank = cluster_rank();
  f.peer = a.cs == 2 ? f.rank ^ 1u : kNoPeer;
  if (threadIdx.x == 0) {
    for (int q = 0; q < R::kStages; ++q) {
      mbar_init(f.full + 8 * q, 1 + kSplitWarps);  // the producer's, one a splitting warp
      mbar_init(f.empty + 8 * q, a.cs * kWarps);   // one arrival a consumer warp of the cluster
      mbar_init(f.abox + 8 * q);
    }
  }
  cluster_sync();  // the barriers of both CTAs are set before either copies or arrives into the other
  // the role, warp-uniform as the compiler can see (a shuffle of lane 0's
  // value): wgmma is issued only in code it knows no warp diverges into
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int ntiles = (a.O + NT - 1) / NT;
  int it = 0;
  if (warp >= kWarps) {
    regs_dec<kProducerRegs>();
    walk_parts(a, [&](const StagePart& p) {
      const int rt = p.item / ntiles * a.cs + static_cast<int>(f.rank), nti = p.item % ntiles;
      const int b0 = rt * a.samples, row0 = b0 * a.T;
      const RingPart conv = ring_range<R>(a.ws, a.C, kConvK, p.c0, p.c1, nti);
      // the projection whole in a tile's first part (stage_tile)
      const int pch = p.c0 == 0 ? (a.Cres + kChunk - 1) / kChunk : 0;
      const RingPart pres = ring_range<P>(a.wress, a.Cres, 1, 0, pch, nti);
      if (warp == kWarps) {
        if constexpr (kDescA<NT, KW>) {  // T = 3: positions 0, 1, 2 of 64 samples, one box each
          if constexpr (kProj)
            ring_feed<P>(pres, [&](char* st, int c, uint32_t bar) {
              for (int t = 0; t < 3; ++t) tma_load_3d(st + t * 64 * P::kPitch, &mres, c, t, b0, bar);
            }, smem, f, it);
          ring_feed<R>(conv, [&](char* st, int c, uint32_t bar) {
            for (int t = 0; t < 3; ++t) tma_load_3d(st + t * 64 * R::kPitch, &mx, c, t, b0, bar);
          }, smem, f, it);
        } else {
          if constexpr (kProj)
            ring_feed<P>(pres, [&](char* st, int c, uint32_t bar) { tma_load_2d(st, &mres, c, row0, bar); },
                         smem, f, it);
          ring_feed<R>(conv, [&](char* st, int c, uint32_t bar) { tma_load_2d(st, &mx, c, row0, bar); }, smem, f,
                       it);
        }
      } else {
        const int t = threadIdx.x - kThreads - 32;
        if constexpr (kProj) ring_split<P>(pres, smem, f, t, it);
        ring_split<R>(conv, smem, f, t, it);
      }
    });
  } else {
    regs_inc<kConsumerRegs>();
    walk_parts(a, [&](const StagePart& p) {
      stage_tile<NT, KW, kProj>(a, p, p.item / ntiles * a.cs + static_cast<int>(f.rank), p.item % ntiles, smem,
                                psum, stats, f, it);
    });
  }
  cluster_sync();  // no CTA leaves while its peer may still copy or arrive into it
}

// stage_weights on n jobs (1 to kLayoutJobs; jobs[n ..] are filled in) of
// one N tile nt, each job's out staged_weight_bytes(nt, C, O, K) bytes, in
// one launch: cindm_stage_weights, which the wrappers run for a call's
// stale weights (ops/_build.staged). Refuses (cudaErrorInvalidValue) a job
// whose w or out is null or not 16-byte aligned, whose O is not a multiple
// of 4, whose N tile differs, or whose weights or layout hold 2^31 words or
// more.
cudaError_t launch_stage_weights(LayoutJob* jobs, int n, int nt, cudaStream_t stream) {
  if (n < 1 || n > kLayoutJobs || (nt != 64 && nt != 128)) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const LayoutJob& j = jobs[i];
    if (j.w == nullptr || j.out == nullptr || reinterpret_cast<uintptr_t>(j.w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(j.out) % 16 != 0 || j.K <= 0 || j.C <= 0 || j.O <= 0 || j.O % 4 != 0 ||
        j.nt != nt || static_cast<long long>(j.K) * j.C * j.O >= (1ll << 31) ||
        staged_weight_bytes(nt, j.C, j.O, j.K) / 4 >= (size_t(1) << 31))
      return cudaErrorInvalidValue;
  }
  const int blocks = layout_grid(jobs, n);
  if (nt == 64)
    stage_weights<64><<<blocks, kLayoutThreads, 0, stream>>>(jobs[0], jobs[1], jobs[2]);
  else
    stage_weights<128><<<blocks, kLayoutThreads, 0, stream>>>(jobs[0], jobs[1], jobs[2]);
  return cudaGetLastError();
}

// The split and CTAs of a stage launch of `items` cluster items (row-tile
// pairs x N tiles) of `chunks` K chunks in clusters of cs on the current
// device: cs CTAs a cluster with work, one an SM at most (mirrors
// ops/_build.plan_stage).
cudaError_t stage_ctas(int items, int chunks, int cs, StageSplit* split, int* ctas) {
  int dev = 0, sms = 0;
  CINDM_TRY(cudaGetDevice(&dev));
  CINDM_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  return walk_plan(items, chunks, cs, sms, kSplitTail, split, ctas);
}

template <int NT, int KW, bool kProj, class Args>
cudaError_t launch_nt(const Args& a, size_t bytes, int ctas, const CUtensorMap& mx, const CUtensorMap& mres,
                      cudaStream_t stream) {
  static unsigned long long smem_set = 0;  // devices where the attribute is set
  const auto k = conv_gn_mish_stage<NT, KW, kProj, Args>;
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

// One stage launch on weights that stage_weights laid out (a.ws, and
// a.wress with the projection), with the planner's plan `s`: `samples`
// whole samples per tile, an N tile of `n_tile` channels, `smem_bytes` of
// dynamic shared memory, `ctas` persistent CTAs in clusters of `cluster`,
// the split tail with its workspace and counters. With SaveArgs it
// launches the saving instance. Refuses (cudaErrorInvalidValue) a plan
// that breaks the tiling's rules or differs from the one recomputed here,
// or a workspace or counters too small for its split.
template <class Args>
cudaError_t launch_stage(const Args& a0, int K, const StageLaunch& s, void* stream) {
  Args a = a0;
  const int nt = s.n_tile, ctas = s.ctas;
  a.samples = s.samples;
  const bool proj = a.wress != nullptr;
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.O <= 0 || a.G <= 0 || a.O % a.G != 0 ||
      a.C % 4 != 0 || a.O % 4 != 0 || K != kConvK || (nt != 64 && nt != 128) ||
      a.samples <= 0 || a.samples * a.T > kTileRows || (a.T == 3 && a.samples != 64) || a.ws == nullptr ||
      (proj && (a.Cres <= 0 || a.Cres % 4 != 0 || a.xres == nullptr)) || (proj != (a.bres != nullptr)))
    return cudaErrorInvalidValue;
  const int og = a.O / a.G;
  if (a.O > nt && nt % og != 0) return cudaErrorInvalidValue;  // an N tile holds whole groups
  const int gpt = (a.O < nt ? a.O : nt) / og;
  const size_t bytes = stage_smem_bytes(nt, a.samples, gpt);
  if (static_cast<size_t>(s.smem_bytes) != bytes || bytes > kSmemMax) return cudaErrorInvalidValue;
  const int row_tiles = (a.B + a.samples - 1) / a.samples;
  a.cs = stage_cluster(row_tiles);
  a.items = (row_tiles + a.cs - 1) / a.cs * ((a.O + nt - 1) / nt);
  a.chunks = (a.C + kChunk - 1) / kChunk;
  int want = 0;
  CINDM_TRY(stage_ctas(a.items, a.chunks, a.cs, &a.split, &want));
  if (s.cluster != a.cs || ctas != want || s.tail != a.split.tail || s.tail_clusters != a.split.tail_clusters ||
      s.max_parts != a.split.max_parts)
    return cudaErrorInvalidValue;
  a.work = s.work;
  a.counters = s.counters;
  if (a.split.tail > 0 &&
      (s.work == nullptr || s.counters == nullptr || reinterpret_cast<uintptr_t>(s.work) % 16 != 0 ||
       s.work_bytes < static_cast<long long>(stage_work_bytes(a.split, a.cs, nt)) ||
       s.n_counters < a.split.tail * a.cs))
    return cudaErrorInvalidValue;
  constexpr int kPitch = ConvRing<64>::kPitch;  // one chunk a slot at either N tile
  constexpr int kProjPitch = ProjRing<64>::kPitch;
  static_assert(ConvRing<128>::kPitch == kPitch && ProjRing<128>::kPitch == kProjPitch, "");
  CUtensorMap mx, mres;
  if (a.T == 3) {  // kDescA: position-major boxes, the projection's too
    CINDM_TRY(position_map(&mx, a.x, a.B, a.T, a.C, kPitch));
    if (proj) CINDM_TRY(position_map(&mres, a.xres, a.B, a.T, a.Cres, kProjPitch));
  } else {
    CINDM_TRY(ring_map(&mx, a.x, a.B * a.T, a.C, kPitch));
    if (proj) CINDM_TRY(ring_map(&mres, a.xres, a.B * a.T, a.Cres, kProjPitch));
  }
  if (!proj) mres = mx;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.T == 3)
    return nt == 64 ? (proj ? launch_nt<64, 3, true>(a, bytes, ctas, mx, mres, st)
                            : launch_nt<64, 3, false>(a, bytes, ctas, mx, mres, st))
                    : (proj ? launch_nt<128, 3, true>(a, bytes, ctas, mx, mres, st)
                            : launch_nt<128, 3, false>(a, bytes, ctas, mx, mres, st));
  return nt == 64 ? (proj ? launch_nt<64, kConvK, true>(a, bytes, ctas, mx, mres, st)
                          : launch_nt<64, kConvK, false>(a, bytes, ctas, mx, mres, st))
                  : (proj ? launch_nt<128, kConvK, true>(a, bytes, ctas, mx, mres, st)
                          : launch_nt<128, kConvK, false>(a, bytes, ctas, mx, mres, st));
}

}  // namespace
}  // namespace cindm
