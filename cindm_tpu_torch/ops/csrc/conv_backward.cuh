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
//   dgrad_gn_stage   dh = conv_T(dz2, w2), 3xTF32 wgmma fed by a producer
//                    warp's ring, K split over a thread block cluster; then
//                    in its epilogue dtemb = sum_t dh and the first GroupNorm
//                    + Mish backward: -> dz1;
//   dgrad_x_stage    dx = conv_T(dz1, w1) + (g @ wres^T | g), the 1x1
//                    product in the same accumulator, on the same main loop;
//                    skipped when x needs no gradient;
//   wgrad            dw1, dw2 and dwres, 3xTF32 wgmma over long runs of rows;
//   grad_reduce      sums the row splits' and row tiles' partials in order,
//                    items of whole columns whose slabs arrive by TMA.
// The head runs gn_mish_bwd (its only GroupNorm), dgrad_x_stage without the
// residual, wgrad and grad_reduce.
//
// What bounds it on an H100: operations. The two dgrads and the wgrads do
// twice the forward's multiply-adds, and 3xTF32 issues each three times on
// the tensor cores: at batch 512 about 0.62 ms for the denoiser's 16 blocks
// at 495 TFLOP/s. gn_mish_bwd is bound by bytes: g and z read, dz written,
// and dz (and g on a projection block) in wgrad's two-plane operand layout,
// about 0.3 GB there (0.089 ms at 3.35 TB/s).
//
// Design. The GroupNorm backward needs two reductions over each (sample,
// group): a warp owns whole pairs, holds a pair's d and z in registers
// (gn_bwd_tile: one streaming pass, shuffle sums, no block barrier between
// phases), and gn_mish_bwd tiles its own rows, a few whole samples x an N
// tile of whole groups a CTA, so that a launch at the training batch runs
// 256 CTAs of 8 warps (two pairs a warp), two an SM. The dgrad of conv2 is
// an implicit GEMM over dz2 with the flipped weights, so its tile holds dh
// for whole samples and whole groups and the first GroupNorm's backward
// runs in its epilogue on the same tile code, with no round trip of dh.
// Every reduction across warps or blocks goes in a fixed order (shuffle
// trees, then partials in shared and device memory summed in order), never
// through atomics, so a gradient repeats bit for bit from run to run.
//
// The dgrads. At the training batch a tile of 192 rows x 64 channels leaves
// most of the 132 SMs idle (8 row tiles at T = 3), while K, the cotangent's
// channels x taps, is longest there. So K is split over a cluster of cs = 1
// to 4 CTAs (ops/_build.plan_backward picks cs so that the grid's clusters
// run in one wave, with cudaOccupancyMaxActiveClusters as the limit): rank q
// of a cluster takes the q-th run of whole ring stages of K, keeps its
// partial 192 x NT accumulator in its own shared memory, and after a cluster
// barrier each rank sums one share of the tile's rows over the cluster's
// partials through distributed shared memory, ranks in order 0, 1, ..: a
// fixed order, no atomics. dgrad_gn_stage's share is whole samples (whole
// (sample, group) pairs), so the first GroupNorm's backward runs on it there
// with no round trip of dh through device memory; its column partials are
// then per (row tile, rank). The main loop is stage_ring.cuh's, which the
// forward stage runs too: a producer warp fills a ring of stages of 16
// input channels (8 at NT = 128), the tile's 192 cotangent rows by one TMA
// box and the stage's weight blocks, contiguous in stage_weights_t's
// layout, by one bulk copy; three consumer warpgroups keep one wgmma group
// in flight while they load and split the next tap's A fragments
// (split_tf32_fast: Split::kFast).
//
// What bounds the dgrads (PERF.md): their 3xTF32 operations take about 0.31
// ms at batch 512; each stage re-reads its N tile's weight blocks (two tf32
// planes, five taps) for only 192 rows, so at T = 3 the ring's L2 traffic
// rivals the wgmmas; dgrad_gn_stage then runs the GroupNorm backward on the
// rank's samples (gn_bwd_tile, shared with gn_mish_bwd).
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

#include "conv_gn_mish.cuh"

namespace cindm {

constexpr int kReduceJobs = 10;
// grad_reduce: a CTA's threads, a thread's float4 columns of an item, the
// ring's stages and their bytes, the fewest items a launch is cut into
// where its bytes allow (one an SM of the H100), the TMA box's limit and an
// item's widest run of columns
constexpr int kReduceThreads = 256;
constexpr int kReduceVec = 2;
constexpr int kReduceStages = 2;
constexpr int kReduceStageBytes = 49152;
constexpr int kReduceItems = 132;
constexpr int kReduceBox = 256;  // a TMA box's most columns, and most slices
constexpr int kReduceBatch = 16;  // slices a thread loads before adding them
constexpr int kReduceMaxWidth = 4 * kReduceVec * kReduceThreads;
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

constexpr int kDgClusterMax = 4;  // cluster sizes 1 to 4

// Mirror ops/_build.plan_backward; the launches refuse a plan that differs.
// gn_mish_bwd's tile: at most kGnPairs (sample, group) pairs, kGnWarpPairs a
// warp; a lane holds kGnLaneFloats of d and of z a pair at a time (a chunk).
// dgrad_gn_stage's epilogue: kGnEpiPairs a warp at a time.
constexpr int kGnPairs = 16;
constexpr int kGnWarpPairs = 2;
constexpr int kGnThreads = 32 * kGnPairs / kGnWarpPairs;
constexpr int kGnEpiPairs = 1;
constexpr int kGnLaneFloats = 8;
constexpr int kGnKinds = 4;  // column partials: dgs, dgb, db, dbres
// The channels V of a group of og that a lane loads at once: 2 where og is
// even and at most 64 (a pair of the training shapes, T og = 192, then
// fills every lane of the warp, 3 loads of 8 bytes each of d and z), else 1
// up to 32 channels, else 4 up to 128 (at most 32 load units a row); 0
// where none fits (the launch refuses).
__host__ __device__ constexpr int gn_lane_floats(int og) {
  return og % 2 == 0 && og <= 64 ? 2 : (og <= 32 ? 1 : (og % 4 == 0 && og <= 128 ? 4 : 0));
}
// Floats between the rows of a staged tile of nt channels: 16 modulo 32, so
// that the operand writer's reads (16 channels of two rows a warp) fall on
// distinct banks.
__host__ __device__ constexpr int gn_stride(int nt) { return (nt + 15) / 32 * 32 + 16; }
// gn_mish_bwd: `planes` staged tiles of samples x T rows (dz, and g where gw
// is written), then the pairs' column sums, kind x sample x channel.
__host__ __device__ inline size_t gn_bwd_smem_bytes(int nt, int samples, int T, int planes) {
  return 4 * (size_t(planes) * samples * T * gn_stride(nt) + size_t(kGnKinds) * samples * nt);
}
// 1,024 bytes to align the ring; region 0 (the ring; after the main loop
// this CTA's partial tile, then, once the cluster is done with it, the
// GroupNorm backward's column sums, 3 x a rank's samples x nt); the rank's
// share of the summed tile; each slot's full and empty barriers.
__host__ __device__ inline size_t dgrad_gn_region0(int nt, int samples, int cs) {
  const size_t ring = nt == 64 ? StageRing<64>::kRingBytes : StageRing<128>::kRingBytes;
  const size_t cols = 3 * 4 * size_t((samples + cs - 1) / cs) * nt;
  const size_t after = tile_bytes(nt) > cols ? tile_bytes(nt) : cols;
  return ring > after ? ring : after;
}
inline size_t dgrad_gn_smem_bytes(int nt, int samples, int cs) {
  return 1024 + dgrad_gn_region0(nt, samples, cs) + tile_bytes(nt) +
         16 * (nt == 64 ? StageRing<64>::kStages : StageRing<128>::kStages);
}
// dgrad_x: the ring (after the main loop the partial tile), the barriers
inline size_t dgrad_x_smem_bytes() {
  const size_t ring = StageRing<64>::kRingBytes;
  return 1024 + (ring > tile_bytes(64) ? ring : tile_bytes(64)) + 16 * StageRing<64>::kStages;
}
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

// grad_reduce's jobs (the kernel and its design: below). dst[i] = sum
// over s of src[s * n + i] for each job.
struct ReduceJob {
  const float* src;  // [slices][n], 16-byte aligned
  float* dst;        // [n], 16-byte aligned
  int n, slices;     // n a multiple of 4
  int width;         // columns of an item, a multiple of 4 (the job's last item may be narrower)
  int item0;         // the job's first item in the launch's list
};
struct ReduceArgs {
  ReduceJob job[kReduceJobs];
  int njobs, nitems;
};

__host__ __device__ constexpr int reduce_items(int n, int width) { return (n + width - 1) / width; }
// Slices of an item of `width` columns that one ring stage holds: at most
// one TMA box's kReduceBox.
__host__ __device__ constexpr int reduce_run(int slices, int width) {
  const int fit = kReduceStageBytes / (4 * width);
  const int run = slices < fit ? slices : fit;
  return run < kReduceBox ? run : kReduceBox;
}
// The plan's width of a job of n columns over `slices`, for a launch whose
// jobs read `total` bytes: at most total / kReduceItems bytes an item (so
// that a launch has at least kReduceItems items, one an SM, wherever its
// bytes allow), in whole float4 columns, at most a thread's kReduceVec
// float4s, a ring stage's slab and n, at least 4 columns; past one TMA
// box, whole boxes. Mirrors ops/_build.reduce_width.
__host__ __device__ constexpr int reduce_width(long long total, int n, int slices) {
  const long long target = total / kReduceItems / (16LL * slices) * 4;
  const long long fit = kReduceStageBytes / (16LL * slices) * 4;
  long long w = target < fit ? target : fit;
  w = w < kReduceMaxWidth ? w : kReduceMaxWidth;
  w = w < n ? w : n;
  w = w > 4 ? w : 4;
  return static_cast<int>(w > kReduceBox ? w / kReduceBox * kReduceBox : w);
}
// Columns of one TMA box of an item of `width` columns.
__host__ __device__ constexpr int reduce_box(int width) { return width < kReduceBox ? width : kReduceBox; }
// 128 bytes to align the ring (TMA's destination), the ring, a barrier a stage
constexpr size_t reduce_smem_bytes() {
  return 128 + kReduceStages * size_t(kReduceStageBytes) + 8 * kReduceStages;
}
// A job's view for TMA: src as [slices][n], boxes of reduce_box(width)
// columns x reduce_run(slices, width) slices (encoded by the launch).
struct ReduceMaps {
  CUtensorMap map[kReduceJobs];
};

// The GroupNorm + Mish backward's arguments (one GroupNorm of the block).
struct GnBwd {
  const float* z;     // [B, T, O] conv output plus bias, saved by the forward
  const float* mean;  // [B, G]
  const float* rstd;  // [B, G]
  const float* gs;    // [O]
  const float* gb;    // [O]
  float* dz;          // [B, T, O]
  float* part;        // [3 or 4][row_tiles][O]: dgs, dgb, db (, sum of d: dbres)
  float* dtemb;       // [B, O] per-sample sums over t of d, or null
  float* dzw;         // dz in wgrad's operand layout, or null
  float* gw;          // gn_mish_bwd: its input d in the operand layout, or null
  int colsum;         // write part[3], the column sums of d
  int B, T, O, G;
  int row_tiles;      // rows of partials a kind: gn_mish_bwd's row tiles, or dgrad_gn_stage's
                      // row tiles x cluster ranks
};

namespace {

// d/dy Mish(y) = tanh(sp) + y sigmoid(y) sech^2(sp), sp = softplus(y). With
// e = e^y and n = e (e + 2) as in mish(): tanh(sp) = n / (n + 2) and
// sech^2(sp) = 4 (n + 1) / (n + 2)^2, which keeps its precision where tanh
// is near 1 (1 - tanh^2 would not). Clamped at y = 20 like mish(). Two
// reciprocals and the hardware exponential (about 1e-6 relative): the
// GroupNorm backward is bound by its instructions where its operands are
// in shared memory.
__device__ __forceinline__ float mish_grad(float y) {
  const float e = __expf(fminf(y, 20.0f));
  const float n = e * (e + 2.0f);
  const float r = __fdividef(1.0f, n + 2.0f);
  return n * r + y * __fdividef(e, 1.0f + e) * (4.0f * (n + 1.0f)) * (r * r);
}

// 16 bytes at shared address `addr` of CTA `rank` of the cluster (distributed shared memory).
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Writes rows [row0, row0 + nrows) x channels [n0, n0 + ncols) of a tile
// (row stride ks) into the operand layout `out` of a [R, O] cotangent, and
// the same rows of a second tile into `out2` where tile2 is not null (both
// with one pass of the indexing); the tile with the last row also writes the
// zero rows of the last group, the one with the last channels the zero
// channels up to the next 64. n0 is a multiple of 8, and ncols is one too
// unless the tile ends at O. Thread tid of nthreads takes, per unit i, the 4
// rows of one channel that make 16 bytes of a block (rows 2 apart):
// conflict-free reads of the tile, and a run of threads writes a run of
// 16-byte words.
__device__ void write_wgrad_operand(const float* tile, int ks, int row0, int nrows, int R, int T, int n0,
                                    int ncols, int O, float* out, const float* tile2, float* out2, int tid,
                                    int nthreads) {
  const bool p3 = T == 3;  // position-major stages of 48 rows, which a run of rows may end inside
  const int Q = wgrad_groups(R, T);
  const int rend = row0 + nrows, rpad = rend == R ? Q / (p3 ? 6 : 1) * (p3 ? kWgRowsT3 : 8) : rend;
  const int cend = n0 + ncols, cpad = cend == O ? (O + kWgTile - 1) / kWgTile * kWgTile : cend;
  const int units = 2 * (cpad - n0);  // per group of 8 K positions: channel x K half
  // the groups that hold rows [row0, rpad): from the first row's to the last one's
  const int q0 = p3 ? row0 / kWgRowsT3 * 6 : row0 / 8;
  const int n = ((p3 ? (rpad + kWgRowsT3 - 1) / kWgRowsT3 * 6 : (rpad + 7) / 8) - q0) * units;
  for (int i = tid; i < n; i += nthreads) {
    const int q = q0 + i / units, u = i % units;
    const int c = (u >> 4) * 8 + (u & 7);  // channel - n0: n8 block u / 16, channel u % 8
    const int kh = (u >> 3) & 1;            // K positions 4 kh .. 4 kh + 3
    // their rows: 2 apart from 8q + kh, or at T = 3 6 apart (samples 2 apart)
    const int g = q % 6;
    const int r = p3 ? q / 6 * kWgRowsT3 + 3 * (8 * (g & 1) + kh) + (g >> 1) : 8 * q + kh;
    const int dr = p3 ? 6 : 2;
    const int o = n0 + c;
    const size_t w = (size_t(o / kWgTile) * Q + q) * 2 * 512 + (o % kWgTile / 8) * 64 + kh * 32 + (u & 7) * 4;
    for (int t = 0; t < (tile2 != nullptr ? 2 : 1); ++t) {
      const float* src = t == 0 ? tile : tile2;
      uint32_t* dst = reinterpret_cast<uint32_t*>(t == 0 ? out : out2) + w;
      uint32_t big[4], small[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = r + dr * k >= row0 && r + dr * k < rend && o < cend
                            ? src[(r + dr * k - row0) * ks + c] : 0.0f;
        split_tf32(v, big[k], small[k]);
      }
      if (r >= row0 && r + 3 * dr < rpad) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
        *reinterpret_cast<uint4*>(dst + 512) = make_uint4(small[0], small[1], small[2], small[3]);
      } else {  // the rows of a group that another tile shares
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (r + dr * k >= row0 && r + dr * k < rpad) {
            dst[k] = big[k];
            dst[512 + k] = small[k];
          }
      }
    }
  }
}

// V floats at p, as one load (V = 1, 2 or 4); __ldg where p is in device
// memory that the kernel does not write.
template <int V, bool kLdg>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = kLdg ? __ldg(reinterpret_cast<const float4*>(p)) : *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = kLdg ? __ldg(reinterpret_cast<const float2*>(p)) : *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = kLdg ? __ldg(p) : *p;
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// One tile of a GroupNorm + Mish backward: samples b0 .. b0 + ns - 1 x
// channels n0 .. n0 + ncols - 1 (whole groups).
struct GnTile {
  const float* d;  // the cotangent at (the tile's first row, n0); rows ds floats apart
  const float* z;  // z at (the tile's first row, n0) in device memory; rows zs floats apart
  float* st;       // where dz is staged for the operand layout (rows ss apart), or null
  float* sg;       // where d is staged for gw (rows ss apart), or null
  float* cols;     // shared memory: the pairs' column sums, kind x sample x channel
  int ds, zs, ss, b0, ns, n0, ncols;
  int pt;          // the row of the column partials this tile writes
};

// A lane's place in the warp's (sample, group) pair: V channels (16 bytes,
// or one channel where a group's channels are not a multiple of 4) at
// position cu of the L lanes of a row (the group's og / V load units
// rounded up to a power of 2; the rest idle), rows slot, slot + RP, ..
// (RP = 32 / L); the pair's rows go in chunks of kR row steps.
struct GnLanes {
  int L, RP, slot, cu, nck;
  bool on;
};

// The lane's rows of chunk ck of pair (s, cl) of a tile: d (in the
// epilogue from shared memory) and z, zero outside the pair.
template <int V, int kR, bool kEpi>
__device__ __forceinline__ void gn_load(const GnBwd& a, const GnTile& t, const GnLanes& ln, int s, int cl, int ck,
                                        float (&dv)[kR][V], float (&zv)[kR][V]) {
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int r = ln.slot + ln.RP * (kR * ck + k);
#pragma unroll
    for (int j = 0; j < V; ++j) dv[k][j] = zv[k][j] = 0.0f;
    if (ln.on && r < a.T) {
      const size_t row = static_cast<size_t>(s * a.T + r);
      load_v<V, !kEpi>(dv[k], t.d + row * t.ds + cl);
      load_v<V, true>(zv[k], t.z + row * t.zs + cl);
    }
  }
}

// The GroupNorm + Mish backward of one tile, in one streaming pass over its
// (sample, group) pairs with each pair in registers: a warp takes kP pairs
// at a time (pairs warp, warp + nwarps, ..) and issues every load of them
// (d, z, the pairs' mean and rstd) before the first use; a lane holds
// kGnLaneFloats of d and of z a pair (GnLanes); a pair beyond that, 32 x
// kGnLaneFloats elements, goes in chunks: the statistics over every chunk,
// then dz chunk by chunk with d and z loaded again. The pair's two means,
// m[dy gs] and m[dy gs yh], are shuffle sums over the warp; the lane's sums
// per channel over its rows (dgs, dgb, db, and d for dbres or dtemb) are
// summed over the lanes of the channel by halving exchanges (a fixed
// order), then over the tile's samples in shared memory, sample after
// sample: one partial row of each kind, no atomics. dtemb (the per-sample sum over t of d) comes from
// the same sums. dz goes to device memory and, staged in shared memory (st;
// in place where st is d) with d where gw is written, to wgrad's operand
// layout in one pass of 16-byte stores. kEpi: run by the 384 consumer
// threads of dgrad_gn_stage on d in shared memory, else by every thread of
// a gn_mish_bwd CTA on d in device memory. Starts with d complete (a barrier before); no barrier until the
// pairs are done.
template <int V, int kP, bool kEpi>
__device__ void gn_bwd_tile(const GnBwd& a, const GnTile& t, int tid, int nthreads) {
  constexpr int kR = kGnLaneFloats / V;  // row steps of a chunk
  const int lane = tid & 31, nw = nthreads >> 5;
  const int og = a.O / a.G, U = og / V;
  GnLanes ln;
  ln.L = 1;
  while (ln.L < U) ln.L <<= 1;
  ln.RP = 32 / ln.L;
  ln.slot = lane / ln.L;
  ln.cu = lane % ln.L;
  ln.on = ln.cu < U;
  ln.nck = ((a.T + ln.RP - 1) / ln.RP + kR - 1) / kR;
  const int gpt = t.ncols / og, npairs = t.ns * gpt;
  const float inv_n = 1.0f / static_cast<float>(a.T * og);
  const size_t kind = static_cast<size_t>(t.ns) * t.ncols;  // between kinds of column sums
  for (int p0 = tid >> 5; p0 < npairs; p0 += kP * nw) {
    float dv[kP][kR][V], yv[kP][kR][V];  // d, then dy; z, then yh
    float mu[kP], rs[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = min(p0 + i * nw, npairs - 1);
      const int s = p / gpt, cl = (p % gpt) * og + ln.cu * V;
      const size_t gi = static_cast<size_t>(t.b0 + s) * a.G + t.n0 / og + p % gpt;
      mu[i] = __ldg(a.mean + gi);
      rs[i] = __ldg(a.rstd + gi);
      if (ln.nck == 1 && p0 + i * nw < npairs) gn_load<V, kR, kEpi>(a, t, ln, s, cl, 0, dv[i], yv[i]);
    }
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = p0 + i * nw;
      if (p >= npairs) break;
      const int s = p / gpt, cl = (p % gpt) * og + ln.cu * V;
      const int b = t.b0 + s;
      float gsv[V], gbv[V];
#pragma unroll
      for (int j = 0; j < V; ++j) gsv[j] = gbv[j] = 0.0f;
      if (ln.on) {
        load_v<V, true>(gsv, a.gs + t.n0 + cl);
        load_v<V, true>(gbv, a.gb + t.n0 + cl);
      }
      // yh and dy = d mish'(y) of chunk ck in place; with `sums`, the lane's
      // sums and d staged for gw
      float c0[V], c1[V], c3[V];  // the lane's sums over its rows: dy yh, dy, d
#pragma unroll
      for (int j = 0; j < V; ++j) c0[j] = c1[j] = c3[j] = 0.0f;
      float s1 = 0.0f, s2 = 0.0f;
      auto forward = [&](int ck, bool sums) {
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const int r = ln.slot + ln.RP * (kR * ck + k);
          if (!ln.on || r >= a.T) continue;
          if (sums && t.sg != nullptr) store_v<V>(t.sg + (s * a.T + r) * t.ss + cl, dv[i][k]);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float yh = (yv[i][k][j] - mu[i]) * rs[i];
            const float dy = dv[i][k][j] * mish_grad(yh * gsv[j] + gbv[j]);
            if (sums) {
              c3[j] += dv[i][k][j];
              c0[j] += dy * yh;
              c1[j] += dy;
              s1 += dy * gsv[j];
              s2 += dy * gsv[j] * yh;
            }
            dv[i][k][j] = dy;
            yv[i][k][j] = yh;
          }
        }
      };
      for (int ck = 0; ck < ln.nck; ++ck) {
        if (ln.nck > 1) gn_load<V, kR, kEpi>(a, t, ln, s, cl, ck, dv[i], yv[i]);
        forward(ck, true);
      }
      const float m1 = warp_sum(s1) * inv_n, m2 = warp_sum(s2) * inv_n;
      // dz = rstd (dy gs - m[dy gs] - yh m[dy gs yh]), chunk by chunk
      float c2[V];  // the lane's sums of dz
#pragma unroll
      for (int j = 0; j < V; ++j) c2[j] = 0.0f;
      for (int ck = 0; ck < ln.nck; ++ck) {
        if (ln.nck > 1) {
          gn_load<V, kR, kEpi>(a, t, ln, s, cl, ck, dv[i], yv[i]);
          forward(ck, false);
        }
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const int r = ln.slot + ln.RP * (kR * ck + k);
          if (!ln.on || r >= a.T) continue;
          float dz[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            dz[j] = rs[i] * (dv[i][k][j] * gsv[j] - m1 - yv[i][k][j] * m2);
            c2[j] += dz[j];
          }
          store_v<V>(a.dz + (static_cast<size_t>(b) * a.T + r) * a.O + t.n0 + cl, dz);
          if (t.st != nullptr) store_v<V>(t.st + (s * a.T + r) * t.ss + cl, dz);
        }
      }
      // The lane's sums per channel (kinds dgs, dgb, db, d x V channels),
      // summed over the lanes of its channels (lane bits L and up) in a
      // fixed order: each exchange with the partner lane keeps half of the
      // values (the upper lane the upper half), so that a lane ends with
      // 4V / 2^exchanges of them, each summed as a butterfly sums it; once a
      // lane holds one, the rest is a butterfly (whose upper lanes hold
      // copies and write nothing).
      constexpr int kVals = 4 * V;
      float v[kVals];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = c0[j], v[V + j] = c1[j], v[2 * V + j] = c2[j], v[3 * V + j] = c3[j];
      int base = 0;  // the first of the lane's values, in the order above
      int held = kVals;
      bool writer = ln.on;
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int off = ln.L << r;
        if (off >= 32) break;
        const bool upper = (lane & off) != 0;
        const int n = kVals >> r;  // values held before this exchange
        if (n >= 2) {
#pragma unroll
          for (int q = 0; q < kVals / 2; ++q) {
            if (q >= n / 2) break;
            const float send = upper ? v[q] : v[q + n / 2];
            const float keep = upper ? v[q + n / 2] : v[q];
            v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
          base += upper ? n / 2 : 0;
          held = n / 2;
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
          writer = writer && !upper;
        }
      }
      if (writer) {
        float* cols = t.cols + static_cast<size_t>(s) * t.ncols + cl;
#pragma unroll
        for (int q = 0; q < kVals; ++q) {
          if (q >= held) break;
          const int kd = (base + q) / V, j = (base + q) % V;
          if (kd < 3 || a.colsum) cols[kd * kind + j] = v[q];
          if (kd == 3 && a.dtemb != nullptr) a.dtemb[static_cast<size_t>(b) * a.O + t.n0 + cl + j] = v[q];
        }
      }
    }
  }
  if constexpr (kEpi)
    consumer_sync();
  else
    __syncthreads();
  // one partial row of each kind: the pairs' sums over the tile's samples, in order
  const int kinds = a.colsum ? 4 : 3;
  float* part = a.part + static_cast<size_t>(t.pt) * a.O + t.n0;
  const size_t pstride = static_cast<size_t>(a.row_tiles) * a.O;  // between partial kinds
  for (int i = tid; i < kinds * t.ncols; i += nthreads) {
    const int k = i / t.ncols, c = i % t.ncols;
    const float* col = t.cols + static_cast<size_t>(k) * kind + c;
    float v = 0.0f;
    for (int s = 0; s < t.ns; ++s) v += col[static_cast<size_t>(s) * t.ncols];
    part[k * pstride + c] = v;
  }
  if (a.dzw != nullptr && t.ns > 0)
    write_wgrad_operand(t.st, t.ss, t.b0 * a.T, t.ns * a.T, a.B * a.T, a.T, t.n0, t.ncols, a.O, a.dzw,
                        t.sg, a.gw, tid, nthreads);
}

// The second GroupNorm + Mish backward (or the head's only one): a CTA
// takes `samples` whole samples x an N tile of nt channels (whole groups, at
// least a 128-byte line where the groups allow), kGnWarpPairs (sample,
// group) pairs a warp, small enough that two CTAs share an SM and a launch
// at the training batch runs at least one CTA an SM
// (ops/_build.plan_backward).
template <int V>
__global__ void __launch_bounds__(kGnThreads, 2)
    gn_mish_bwd(const float* __restrict__ d, const GnBwd a, int samples, int nt) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  GnTile t;
  t.b0 = blockIdx.x * samples;
  t.ns = min(samples, a.B - t.b0);
  t.n0 = blockIdx.y * nt;
  t.ncols = min(nt, a.O - t.n0);
  t.pt = blockIdx.x;
  t.d = d + static_cast<size_t>(t.b0) * a.T * a.O + t.n0;
  t.z = a.z + static_cast<size_t>(t.b0) * a.T * a.O + t.n0;
  t.ds = t.zs = a.O;
  t.ss = gn_stride(nt);
  const int plane = samples * a.T * t.ss;
  const int planes = a.dzw == nullptr ? 0 : (a.gw == nullptr ? 1 : 2);
  t.st = planes > 0 ? sm : nullptr;
  t.sg = planes > 1 ? sm + plane : nullptr;
  t.cols = sm + planes * plane;
  gn_bwd_tile<V, kGnWarpPairs, false>(a, t, threadIdx.x, blockDim.x);
}

struct DgradArgs {
  const float* dz;         // [B, T, Cin] the cotangent of the conv's output
  const uint32_t* ws;      // the conv's weights flipped and transposed (stage_weights_t)
  const float* g;          // dgrad_x: the block's output cotangent [B, T, Cres] for the
                           // residual (projected with wress, else added), or null
  const uint32_t* wress;   // wres^T laid out with K = 1, or null
  float* out;              // dgrad_x: dx [B, T, Cout]
  int B, T, Cin, Cout, Cres, samples;
  int cs;                  // CTAs of a cluster: the split of K
};

// The consumers' accumulators into this CTA's partial tile [192][NT + 4]
// at their natural rows (which alias the ring: the caller has synced).
template <int NT>
__device__ __forceinline__ void dgrad_store_partial(const TileRows& tr, const float (&acc)[NT / 2], float* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tr.live[i])
        *reinterpret_cast<float2*>(tile + tr.r[i] * (NT + 4) + c) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// The dgrads' shared frame: barriers set up, the role (warp-uniform as the
// compiler can see: a shuffle of lane 0's value; wgmma is issued only in
// code it knows no warp diverges into), this CTA's row tile and rank.
struct DgFrame {
  int rank, b0, ns, row0, nrows;
  bool producer;
};

template <int NT>
__device__ __forceinline__ DgFrame dgrad_frame(const DgradArgs& a, uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0)
    for (int q = 0; q < StageRing<NT>::kStages; ++q) {
      mbar_init(full + 8 * q);
      mbar_init(empty + 8 * q, kThreads / 32);  // one arrival a consumer warp
    }
  __syncthreads();
  DgFrame f;
  f.producer = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0) == kThreads / 32;
  f.rank = static_cast<int>(cluster_rank());
  f.b0 = blockIdx.x / a.cs * a.samples;
  f.ns = min(a.samples, a.B - f.b0);
  f.row0 = f.b0 * a.T;
  f.nrows = f.ns * a.T;
  return f;
}

// dh = conv_T(dz2, w2) for 192 rows x NT channels of whole groups, K split
// over the cluster; each rank sums its share of the tile's samples over the
// cluster's partials and runs the first GroupNorm's backward on them.
template <int NT, int KW>
__global__ void __launch_bounds__(kRingThreads, 1)
    dgrad_gn_stage(const DgradArgs a, const GnBwd gn, const __grid_constant__ CUtensorMap mdz) {
  using R = StageRing<NT>;
  constexpr int kS = NT + 4;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;  // the swizzle's period
  const size_t r0 = dgrad_gn_region0(NT, a.samples, a.cs);
  float* part = reinterpret_cast<float*>(smem);       // this CTA's partial dh, over the ring
  float* mine = reinterpret_cast<float*>(smem + r0);  // this rank's samples, summed
  const uint32_t full = smem_u32(smem + r0 + tile_bytes(NT));
  const uint32_t empty = full + 8 * R::kStages;
  const DgFrame f = dgrad_frame<NT>(a, full, empty);
  const RingPart p = ring_part<StageRing<NT>>(a.ws, a.Cin, kConvK, f.rank, a.cs, blockIdx.y);
  int it = 0;
  if (f.producer) {
    ring_produce<StageRing<NT>>(&mdz, p, f.row0, smem, full, empty, it);
  } else {
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    const TileRows tr = tile_rows<kConvK, KW>(a.samples, f.ns, a.T);
    ring_consume<StageRing<NT>, kConvK, KW, Split::kFast>(tr, p, smem, full, empty, it, acc);
    consumer_sync();  // every warpgroup is done with the ring
    dgrad_store_partial<NT>(tr, acc, part);
  }
  cluster_sync();  // every rank's partial is complete
  // this rank's samples s0 .. s1 - 1 of the tile, summed over the ranks in order
  const int s0 = f.ns * f.rank / a.cs, s1 = f.ns * (f.rank + 1) / a.cs;
  const int n0 = blockIdx.y * NT, ncols = min(NT, a.Cout - n0);
  if (!f.producer)
    for (int i = threadIdx.x; i < (s1 - s0) * a.T * (NT / 4); i += kThreads) {
      const int r = i / (NT / 4), c = 4 * (i % (NT / 4));
      if (c >= ncols) continue;
      const uint32_t at = smem_u32(part + (s0 * a.T + r) * kS + c);
      float4 v = ld_cluster4(at, 0);
      for (int q = 1; q < a.cs; ++q) {
        const float4 u = ld_cluster4(at, q);
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(mine + r * kS + c) = v;
    }
  cluster_sync();  // no rank reads another's partial past here: region 0 is free
  if (!f.producer) {
    GnTile t;  // d in `mine`, dz written over it; the column sums in region 0
    t.d = t.st = mine;
    t.z = gn.z + static_cast<size_t>(f.b0 + s0) * a.T * gn.O + n0;
    t.sg = nullptr;
    t.cols = part;
    t.ds = t.ss = kS;
    t.zs = gn.O;
    t.b0 = f.b0 + s0;
    t.ns = s1 - s0;
    t.n0 = n0;
    t.ncols = ncols;
    t.pt = blockIdx.x;
    const int v = gn_lane_floats(gn.O / gn.G);
    if (v == 1)
      gn_bwd_tile<1, kGnEpiPairs, true>(gn, t, threadIdx.x, kThreads);
    else if (v == 2)
      gn_bwd_tile<2, kGnEpiPairs, true>(gn, t, threadIdx.x, kThreads);
    else
      gn_bwd_tile<4, kGnEpiPairs, true>(gn, t, threadIdx.x, kThreads);
  }
}

// dx = conv_T(dz1, w1) (+ g @ wres^T in the same accumulator | + g) for 192
// rows x NT input channels, K (the conv's, then the projection's) split over
// the cluster; each rank sums its share of the tile's rows over the
// cluster's partials and writes them. No GroupNorm, so the N tile needs no
// whole groups (C = 8 runs 8 live columns of 64).
template <int NT, int KW>
__global__ void __launch_bounds__(kRingThreads, 1)
    dgrad_x_stage(const DgradArgs a, const __grid_constant__ CUtensorMap mdz,
                  const __grid_constant__ CUtensorMap mg) {
  using R = StageRing<NT>;
  constexpr int kS = NT + 4;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;
  float* part = reinterpret_cast<float*>(smem);  // this CTA's partial dx, over the ring
  const size_t r0 = R::kRingBytes > tile_bytes(NT) ? R::kRingBytes : tile_bytes(NT);
  const uint32_t full = smem_u32(smem + r0);
  const uint32_t empty = full + 8 * R::kStages;
  const DgFrame f = dgrad_frame<NT>(a, full, empty);
  const bool proj = a.wress != nullptr;
  const RingPart pc = ring_part<StageRing<NT>>(a.ws, a.Cin, kConvK, f.rank, a.cs, blockIdx.y);
  RingPart pr = proj ? ring_part<StageRing<NT>>(a.wress, a.Cres, 1, f.rank, a.cs, blockIdx.y) : pc;
  if (!proj) pr.c1 = pr.c0;  // no projection: an empty part
  int it = 0;
  if (f.producer) {
    ring_produce<StageRing<NT>>(&mdz, pc, f.row0, smem, full, empty, it);
    ring_produce<StageRing<NT>>(&mg, pr, f.row0, smem, full, empty, it);
  } else {
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    const TileRows tr = tile_rows<kConvK, KW>(a.samples, f.ns, a.T);
    ring_consume<StageRing<NT>, kConvK, KW, Split::kFast>(tr, pc, smem, full, empty, it, acc);
    // the same fragment rows (position-major at T <= 3), one tap
    TileRows t1 = tr;
    t1.klo = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) t1.ok[i] = tr.live[i] ? 1u : 0u;
    ring_consume<StageRing<NT>, 1, 1, Split::kFast>(t1, pr, smem, full, empty, it, acc);
    consumer_sync();  // every warpgroup is done with the ring
    dgrad_store_partial<NT>(tr, acc, part);
  }
  // this rank's rows lo .. hi - 1 of the tile: kIt float4 a thread; the
  // identity residual's loads while the cluster syncs
  constexpr int kIt = (kTileRows * (NT / 4) + kThreads - 1) / kThreads;
  const int lo = f.nrows * f.rank / a.cs, hi = f.nrows * (f.rank + 1) / a.cs;
  const int n0 = blockIdx.y * NT, ncols = min(NT, a.Cout - n0);
  const float* ident = proj ? nullptr : a.g;
  float4 id[kIt];
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int i = threadIdx.x + k * kThreads, r = lo + i / (NT / 4), c = 4 * (i % (NT / 4));
    id[k] = ident != nullptr && !f.producer && r < hi && c < ncols
                ? __ldg(reinterpret_cast<const float4*>(ident + static_cast<size_t>(f.row0 + r) * a.Cout + n0 + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cluster_sync();  // every rank's partial is complete
  // the rank's rows, summed over the ranks in order (+ the identity residual)
  if (!f.producer) {
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int i = threadIdx.x + k * kThreads, r = lo + i / (NT / 4), c = 4 * (i % (NT / 4));
      if (r >= hi) break;
      if (c >= ncols) continue;
      const uint32_t at = smem_u32(part + r * kS + c);
      float4 v = ld_cluster4(at, 0);
      for (int q = 1; q < a.cs; ++q) {
        const float4 u = ld_cluster4(at, q);
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      v.x += id[k].x, v.y += id[k].y, v.z += id[k].z, v.w += id[k].w;
      *reinterpret_cast<float4*>(a.out + static_cast<size_t>(f.row0 + r) * a.Cout + n0 + c) = v;
    }
  }
  cluster_sync();  // no rank leaves while another reads its partial
}

// Up to three weight layout jobs (LayoutJob, stage_ring.cuh) in one launch,
// each a w [K][O][C] laid out as the stage reads a conv from C to O
// channels, flipped in time: staged[k][c][o] = w[K - 1 - k][o][c]. (For w
// [K][C'][O'] of a conv C' -> O' that is the conv O' -> C' whose forward is
// the original's dgrad.) A thread block moves one tap of nt rows of w (the
// staged N tile) x 64 of their channels (8 chunks): it reads the rows along
// their contiguous axis, 256 bytes a row in 16-byte pieces, into shared
// memory, and writes the 8 chunks' big and small planes of that tap, each a
// contiguous run of nt x 8 words (stage_weights's layout). Bounded by
// bytes: each weight read once, two planes written.
__global__ void __launch_bounds__(kLayoutThreads) stage_weights_t(const LayoutJob j0, const LayoutJob j1,
                                                                  const LayoutJob j2) {
  __shared__ __align__(16) float s[128][kLayoutCols + 4];  // + 4: conflict-free plane reads
  const LayoutBlock lb = layout_block(j0, j1, j2);
  const LayoutJob& j = lb.j;
  const int nchunks = lb.nchunks, tap = lb.tap, grp = lb.grp, ntile = lb.ntile;
  const int o0 = ntile * j.nt, c0 = grp * kLayoutCols;
  const float* src = j.w + static_cast<size_t>(j.K - 1 - tap) * j.O * j.C;
  for (int i = threadIdx.x; i < j.nt * (kLayoutCols / 4); i += kLayoutThreads) {
    const int ol = i / (kLayoutCols / 4), c4 = 4 * (i % (kLayoutCols / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (o0 + ol < j.O && c0 + c4 < j.C)  // C is a multiple of 4
      v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(o0 + ol) * j.C + c0 + c4));
    *reinterpret_cast<float4*>(&s[ol][c4]) = v;
  }
  __syncthreads();
  // word e of a plane: channel (e / 64) * 8 + (e % 32) / 4 of input (e % 64) / 32 * 4 + e % 4
  const int plane = j.nt * 8;
  const size_t block = size_t(2 * j.K) * plane;
  const int nch = min(8, nchunks - grp * 8);
  uint32_t* out = j.out + (static_cast<size_t>(ntile) * nchunks + grp * 8) * block + 2 * tap * plane;
  for (int ch = 0; ch < nch; ++ch, out += block)
    for (int e = threadIdx.x; e < plane; e += kLayoutThreads) {
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

// grad_reduce: dst[i] = sum over s of src[s * n + i], v = 0 and then s = 0,
// 1, .., S - 1 one fp32 add at a time, over each job of the launch (wgrad's
// row splits, the GroupNorm kernels' per-tile column partials): a fixed
// order, so that every gradient repeats bit for bit.
//
// It has no TPU kernel of its own: it is part of the port of
// _fused_rtb_cv_bwd (cindm_tpu/ops/fused_rtb.py:257), whose sums over rows
// XLA fuses into the VJP's reductions, where Hopper's blocks run in no order
// and a sum across them takes a second pass. What bounds it: bytes, each
// partial read once and each gradient written once (at batch 512 99.7 MB
// and 16.3 MB over 17 launches, 0.035 ms at 3.35 TB/s); at the narrow
// launches (0.3-5 MB) the latency of one round of loads and of each
// column's chain of S adds (S up to 128), on top of a launch's own cost.
//
// Design. The launch's jobs are cut into a flat list of items
// (ops/_build.plan_reduce; ReduceJob::width columns an item over all S
// slices, the last item of a job ragged), at least kReduceItems items (one
// an SM) wherever the launch's bytes allow, none wider than a thread's
// kReduceVec float4 columns or with a slab (S x width x 4 bytes) beyond a
// ring stage. A grid of at most two CTAs an SM walks the items
// round-robin, most launches in one round. Each CTA copies the job table
// into shared memory once, a word a thread. One elected thread fetches an
// item's slab into a ring stage as TMA boxes (cp.async.bulk.tensor, the job
// seen as [S][n]) of up to 256 columns x 256 slices, on the stage's
// mbarrier, two stages deep: the next item's slab is in flight while this
// one is summed. (One cp.async.bulk a slice row made the launches of 32-128
// narrow rows an item chains of copy requests.) Each thread owns 4
// consecutive columns (a float4 a slice, consecutive threads on
// consecutive 16 bytes: no bank conflicts) and adds its slices in order
// from shared memory, kReduceBatch slices loaded ahead of their adds, then
// stores its columns with one 16-byte store: no atomics, no tree. Where a
// slab overflows a stage or a box, it goes through the ring a run of
// slices at a time, still in slice order.

// The run of slices [s0, s0 + ns) of columns [c0, c0 + w) of job `job`:
// what one ring stage holds.
struct ReduceChunk {
  ReduceJob jb;
  int job, c0, w, s0, ns;
};

// (a: the CTA's copy of the launch's ReduceArgs in shared memory)
__device__ __forceinline__ ReduceChunk reduce_chunk(const ReduceArgs& a, int item, int run) {
  ReduceChunk c;
  c.job = 0;
  for (int q = 1; q < a.njobs; ++q)
    if (item >= a.job[q].item0) c.job = q;
  c.jb = a.job[c.job];
  c.c0 = (item - c.jb.item0) * c.jb.width;
  c.w = min(c.jb.width, c.jb.n - c.c0);
  const int per = reduce_run(c.jb.slices, c.jb.width);
  c.s0 = run * per;
  c.ns = min(per, c.jb.slices - c.s0);
  return c;
}

// The next chunk after (item, run) in this CTA's walk: the item's next run
// of slices, else its next item.
__device__ __forceinline__ void reduce_next(const ReduceChunk& c, int& item, int& run) {
  if (c.s0 + c.ns < c.jb.slices) {
    ++run;
  } else {
    item += gridDim.x;
    run = 0;
  }
}

// One elected thread: the chunk into a ring stage, a TMA box of reduce_box
// columns x reduce_run slices at a time, box after box along the columns,
// on the stage's barrier. A box reaching past the job's columns or slices
// lands zeros there, and its bytes count in full.
__device__ __forceinline__ void reduce_fill(const ReduceChunk& c, const ReduceMaps& m, char* stage,
                                            uint32_t bar) {
  const int bw = reduce_box(c.jb.width);
  const uint32_t box = 4u * bw * reduce_run(c.jb.slices, c.jb.width);
  const int nbox = (c.w + bw - 1) / bw;
  mbar_expect_tx(bar, box * nbox);
  for (int b = 0; b < nbox; ++b) tma_load_2d(stage + b * box, &m.map[c.job], c.c0 + b * bw, c.s0, bar);
}

__global__ void __launch_bounds__(kReduceThreads, 2)
    grad_reduce(const __grid_constant__ ReduceArgs args, const __grid_constant__ ReduceMaps m) {
  extern __shared__ float4 smem4[];
  __shared__ ReduceArgs a;  // the job table, copied once a word a thread
  char* ring = reinterpret_cast<char*>(smem4);
  ring += (128 - smem_u32(ring) % 128) % 128;  // TMA's destination alignment
  const uint32_t full = smem_u32(ring + kReduceStages * kReduceStageBytes);
  const int tid = threadIdx.x;
  static_assert(sizeof(ReduceArgs) % 4 == 0 && sizeof(ReduceArgs) / 4 <= kReduceThreads, "one word a thread");
  if (tid < static_cast<int>(sizeof(ReduceArgs) / 4))
    reinterpret_cast<int*>(&a)[tid] = reinterpret_cast<const int*>(&args)[tid];
  if (tid == 0)
    for (int q = 0; q < kReduceStages; ++q) mbar_init(full + 8 * q);
  __syncthreads();
  // thread 0's cursor runs kReduceStages chunks ahead of the consumers'
  int fitem = blockIdx.x, frun = 0;
  if (tid == 0)
    for (int q = 0; q < kReduceStages && fitem < a.nitems; ++q) {
      const ReduceChunk c = reduce_chunk(a, fitem, frun);
      reduce_fill(c, m, ring + q * kReduceStageBytes, full + 8 * q);
      reduce_next(c, fitem, frun);
    }
  float4 v[kReduceVec];
  int item = blockIdx.x, run = 0;
  for (int k = 0; item < a.nitems; ++k) {
    const ReduceChunk c = reduce_chunk(a, item, run);
    const int slot = k % kReduceStages;
    const float4* slab = reinterpret_cast<const float4*>(ring + slot * kReduceStageBytes);
    if (run == 0)
#pragma unroll
      for (int u = 0; u < kReduceVec; ++u) v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // float4 column f of the chunk, slice r: row r of box f / (bw / 4),
    // per rows of bw columns (one box holds a whole item up to 256 columns;
    // wider items are boxes of 256)
    const int bw4 = reduce_box(c.jb.width) / 4, per = reduce_run(c.jb.slices, c.jb.width);
    int at[kReduceVec];
#pragma unroll
    for (int u = 0; u < kReduceVec; ++u) {
      const int f = tid + u * kReduceThreads;
      at[u] = 4 * f >= c.w ? -1 : (f < bw4 ? f : (f / (kReduceBox / 4)) * per * bw4 + f % (kReduceBox / 4));
    }
    mbar_wait(full + 8 * slot, (k / kReduceStages) & 1);
    // the slices in order, a batch of kReduceBatch rows loaded before its
    // adds (a load's latency once a batch, not once a slice: the column
    // jobs' 32-128 slices are each thread's chain of adds)
#pragma unroll
    for (int u = 0; u < kReduceVec; ++u)
      if (at[u] >= 0)
        for (int r0 = 0; r0 < c.ns; r0 += kReduceBatch) {
          float4 x[kReduceBatch];
#pragma unroll
          for (int i = 0; i < kReduceBatch; ++i)
            if (r0 + i < c.ns) x[i] = slab[at[u] + (r0 + i) * bw4];
#pragma unroll
          for (int i = 0; i < kReduceBatch; ++i)
            if (r0 + i < c.ns) {
              v[u].x += x[i].x;
              v[u].y += x[i].y;
              v[u].z += x[i].z;
              v[u].w += x[i].w;
            }
        }
    if (c.s0 + c.ns == c.jb.slices)  // the item's last run: its sums
#pragma unroll
      for (int u = 0; u < kReduceVec; ++u)
        if (at[u] >= 0) reinterpret_cast<float4*>(c.jb.dst + c.c0)[tid + u * kReduceThreads] = v[u];
    reduce_next(c, item, run);
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && fitem < a.nitems) {
      const ReduceChunk f = reduce_chunk(a, fitem, frun);
      reduce_fill(f, m, ring + slot * kReduceStageBytes, full + 8 * slot);
      reduce_next(f, fitem, frun);
    }
  }
}

}  // namespace
}  // namespace cindm
