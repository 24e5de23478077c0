// PreNormResidual(LinearAttentionTemporal) of the 1D denoiser for Hopper
// (sm_90a), one launch a block, 3xTF32 on wgmma.
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
// x, out [B, T, C]; wqkv [C, 384] and wout [128, C] reach the kernel laid
// out by stage_weights (K = 1; N tiles of 128 and 64: tf32 big and small
// planes in wgmma's K-major layout, split_tf32), once per weight version
// (ops/_build.staged); the wrapper keeps the JAX Dense layouts.
//
// What bounds it on an H100: operations. The flagship forward's eight
// blocks ((C, T) = (64, 24) ... (512, 3) at batch 5,376) do 61.0 GFLOP (the
// qkv and out products 55.0, both context contractions 6.1) against 0.43 GB
// of x, out and weights; 3xTF32 issues each product three times, 0.370 ms
// at 495 TFLOP/s, above the bytes' 0.13 ms at 3.35 TB/s (fp32 on the CUDA
// cores: 0.911 ms).
//
// Design. A row tile is 128 rows, two consumer warpgroups of 64, holding
// kRows / T whole samples (5, 10, 21, 42 at T = 24, 12, 6, 3; one of 70,
// three of 35; the rows past the last whole sample are padding), so each
// sample's softmax over T and its context stay on the chip. A persistent
// grid of at most one CTA an SM (384 threads: the two consumer warpgroups
// and a producer warpgroup) walks the tiles (_build.plan_attention
// mirrors the plan: tiles, CTAs, cluster 1, weight bytes).
//  1. Both products on wgmma, 3xTF32 (small*big, big*small, big*big into
//     one fp32 accumulator). A warpgroup holds all 384 q | k | v columns of
//     its 64 rows (three m64n128 accumulators, 192 registers), so K (C)
//     streams in chunks of 8 and each element of xn is normalised and
//     split into its tf32 planes once, by the one thread whose fragment
//     holds it, into the chunk's ring slot beside the weights, where wgmma
//     reads it (ss form), two chunks a group, two groups in flight. The
//     hidden tile is split once into the consumers' registers (16 k8
//     chunks x 8) for the out product (A from registers), whose N tiles of
//     64 run one after another, each tile's residual and bias loaded before
//     its wgmmas and added in the epilogue.
//  2. The weights' planes come by bulk copy into a ring of 6 slots of 32 KB
//     (a k8 chunk of wqkv's three N tiles behind the chunk's xn planes, or
//     6 chunks of one wout N tile), fed by one lane of the producer
//     warpgroup and released by every consumer warp once its wgmmas on a
//     slot are done: a block's weights are read from L2 once a 128-row
//     tile, 2.6x fewer tiles than 48 rows (each weight twice, for its two
//     planes: 1.78 GB a forward against 2.4 GB). A 2-CTA cluster
//     multicasting them would halve that; the L2 reads do not bound the
//     products here, so the cluster is 1.
//  3. The producer warpgroup's other three warps compute the LayerNorm
//     statistics of the CTA's next tile (two buffers) while the consumers
//     work on the current one, reading its x, which brings it to L2 for the
//     consumers' fragment loads; the first tile's, every warp before the
//     roles split. The ring's lane runs ahead into the next tile's weights.
//     The residual is read from L2: an fp32 x tile does not fit beside the
//     ring at C = 512.
//  4. The per-(sample, head) softmax, k^T v and q . context (32 x 32 x T,
//     too small for the tensor cores) run on the CUDA cores in fp32,
//     between the products: the consumers store q (scaled) | k | v of all
//     four heads from their accumulators into the ring's bytes (a [128][436]
//     tile, each head's 32 columns 36 apart), then a warp takes a sample,
//     eight lanes a head, four columns a lane: each float4 of k and q read
//     feeds 16 fused multiply-adds, and the hidden tile takes q's columns.
//     The tensor cores idle there: the next tile's products need the
//     registers and the bytes that the attention holds (a ping-pong of
//     tiles would need twice both).
//  5. Any C that is a multiple of 16 (the out product's column pairs) and
//     1 <= T <= 96: shared memory does not depend on C (225,416 bytes).
#include <cmath>
#include <type_traits>

#include "stage_ring.cuh"

namespace {

using cindm::split_tf32;

constexpr int kHeads = 4;
constexpr int kDimHead = 32;
constexpr int kHidden = kHeads * kDimHead;  // 128
constexpr int kQkvCols = 3 * kHidden;        // wqkv's columns, 384
constexpr int kRows = 128;                   // a row tile: two consumer warpgroups x 64
constexpr int kMaxT = 96;
constexpr int kCMultiple = 16;               // C in multiples of this (the out product's column pairs)
constexpr int kQkvNt = 128;                  // the N tile of wqkv's layout: q, k, v one each
constexpr int kOutNt = 64;                   // the N tile of wout's layout
constexpr int kQkvTiles = kQkvCols / kQkvNt;  // 3
constexpr int kOutChunks = kHidden / 8;      // the out product's k8 chunks
constexpr int kQkvBlock = 2 * (kQkvNt / 8) * cindm::kSboBytes;  // a chunk's big and small planes of an N tile
constexpr int kOutBlock = 2 * (kOutNt / 8) * cindm::kSboBytes;
constexpr int kAPlane = 64 * 8 * 4;          // a warpgroup's xn chunk, one plane: 64 rows x 8 inputs
constexpr int kAOff = 2 * 2 * kAPlane;       // a qkv slot: both warpgroups' xn planes, then the weights
constexpr int kOutSlotChunks = 6;            // wout chunks a slot
constexpr int kOutParts = (kOutChunks + kOutSlotChunks - 1) / kOutSlotChunks;  // slots of an out N tile
constexpr int kSlotBytes = 32768;
static_assert(kAOff + kQkvTiles * kQkvBlock <= kSlotBytes && kOutSlotChunks * kOutBlock <= kSlotBytes, "a slot");
constexpr int kStages = 6;                   // ring slots
constexpr int kGroup = 2;                    // qkv chunks (slots) a wgmma group: C a multiple of 16
constexpr int kHeadCols = 36;                // a head's 32 columns of q, k or v in the tile, and 4 more:
                                             // the four heads' float4s at one column fall on distinct banks
constexpr int kSelCols = kHeads * kHeadCols;  // q, k and v: 144 columns each
constexpr int kQkvStride = 436;              // a row of the q | k | v tile: 3 x 144 + 4 (20 mod 32: fragment banks)
static_assert(kQkvStride == 3 * kSelCols + 4, "q, k and v side by side");
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kAttnThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kStatWarps = 3;                // the producer warpgroup's warps after the first
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;           // 2 x 128 x 232 + 128 x 40 = 64,512
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536, "the SM's register file");
constexpr float kScale = 0.17677669529663687f;  // dim_head^-0.5 as the plain version rounds it
constexpr int kBarriers = 2 * kStages + 5;   // full, empty a slot; sfull, sempty two each; rfree

// The ring and, between the products, the q | k | v tile in the same bytes.
__host__ __device__ constexpr size_t region_bytes() {
  return size_t(kRows) * kQkvStride * 4 > size_t(kStages) * kSlotBytes ? size_t(kRows) * kQkvStride * 4
                                                                       : size_t(kStages) * kSlotBytes;
}
// Mirrors _build.attention_smem_bytes: that region, two buffers of
// LayerNorm statistics, the mbarriers.
__host__ __device__ constexpr size_t attention_smem_bytes() {
  return region_bytes() + size_t(2) * kRows * 8 + 8 * kBarriers;
}

struct AttnArgs {
  const float* x;
  const float* g;
  const char* wq;  // wqkv laid out for N tiles of 128: per N tile and k8 chunk a block of kQkvBlock
  const char* wo;  // wout laid out for N tiles of 64: blocks of kOutBlock
  const float* bout;
  float* out;
  int B, T, C;
  float eps;
  int samples, tiles;  // whole samples a tile, tiles
};

__device__ __forceinline__ float group_sum8(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
  return v;
}

// The 256 consumer threads (not the producer warpgroup).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

// The 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The producer warpgroup's first warp (one lane): the weight blocks of each
// tile's phases in the consumers' order, a slot once every consumer warp
// has released it: per k8 chunk of the qkv product wqkv's three N tiles
// (behind the slot's xn planes, which the consumers write), then, once the
// consumers have taken the hidden tile out of the q | k | v tile that
// shares the ring's bytes (rfree), per wout N tile its 16 chunks in slots
// of 6, 6 and 4.
__device__ __forceinline__ void feed_weights(const AttnArgs& a, char* ring, uint32_t full, uint32_t empty,
                                             uint32_t rfree) {
  const int nch = a.C / 8, ontiles = (a.C + kOutNt - 1) / kOutNt;
  int it = 0, j = 0;
  auto slot_for = [&](uint32_t bytes) {
    const int slot = it % kStages;
    cindm::mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
    cindm::mbar_expect_tx(full + 8 * slot, bytes);
    ++it;
    return slot;
  };
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
    for (int c = 0; c < nch; ++c) {
      const int slot = slot_for(kQkvTiles * kQkvBlock);
      for (int t = 0; t < kQkvTiles; ++t)
        cindm::bulk_load(ring + slot * kSlotBytes + kAOff + t * kQkvBlock,
                         a.wq + (size_t(t) * nch + c) * kQkvBlock, kQkvBlock, full + 8 * slot);
    }
    cindm::mbar_wait(rfree, j & 1);
    for (int n = 0; n < ontiles; ++n)
      for (int c0 = 0; c0 < kOutChunks; c0 += kOutSlotChunks) {
        const uint32_t bytes = min(kOutSlotChunks, kOutChunks - c0) * kOutBlock;
        const int slot = slot_for(bytes);
        cindm::bulk_load(ring + slot * kSlotBytes, a.wo + (size_t(n) * kOutChunks + c0) * kOutBlock, bytes,
                         full + 8 * slot);
      }
  }
}

// The LayerNorm statistics (mean, rstd) of rows first, first + step, ...
// of a tile into st[row], eight lanes a row (first and step multiples of
// 4, a warp's four rows at a time): the mean, then the biased variance from
// a second read; rows past the samples or the batch get (0, 1), so that
// their xn is 0. kUnroll float4 loads of a lane in flight.
template <int kUnroll>
__device__ __forceinline__ void row_stats(const AttnArgs& a, int tile, float2* st, int first, int step) {
  const int lane = threadIdx.x & 31, sub = lane >> 3, l8 = lane & 7;
  const int rows = a.samples * a.T;
  const long long nrows = static_cast<long long>(a.B) * a.T;
  const long long row0 = static_cast<long long>(tile) * rows;
  const float inv_c = 1.0f / static_cast<float>(a.C);
  for (int r = first + sub; r < kRows; r += step) {
    const bool live = r < rows && row0 + r < nrows;
    const float* xr = a.x + (live ? (row0 + r) * a.C : 0);
    float s = 0.f;
    if (live) {
#pragma unroll kUnroll
      for (int c = 4 * l8; c < a.C; c += 32) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
        s += (v.x + v.y) + (v.z + v.w);
      }
    }
    const float mean = group_sum8(s) * inv_c;
    float q = 0.f;
    if (live) {
#pragma unroll kUnroll
      for (int c = 4 * l8; c < a.C; c += 32) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(xr + c));
        const float d0 = w.x - mean, d1 = w.y - mean, d2 = w.z - mean, d3 = w.w - mean;
        q = fmaf(d0, d0, q);
        q = fmaf(d1, d1, q);
        q = fmaf(d2, d2, q);
        q = fmaf(d3, d3, q);
      }
    }
    const float var = group_sum8(q) * inv_c;
    if (l8 == 0) st[r] = live ? make_float2(mean, rsqrtf(var + a.eps)) : make_float2(0.f, 1.f);
  }
}

// The producer warpgroup's other warps (sw = 0 .. kStatWarps - 1): the
// statistics of the CTA's j-th tile into buffer j % 2, once the consumers
// have taken the tile before it; the first tile's all warps of the CTA
// computed before the roles split (the consumers wait for nothing else
// there), so these only mark it in.
__device__ __forceinline__ void tile_stats(const AttnArgs& a, float2* stats, uint32_t sfull, uint32_t sempty,
                                           int sw) {
  int j = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
    const int b = j & 1;
    if (j > 0) {
      cindm::mbar_wait(sempty + 8 * b, ((j >> 1) & 1) ^ 1);
      row_stats<4>(a, tile, stats + b * kRows, 4 * sw, 4 * kStatWarps);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) cindm::mbar_arrive(sfull + 8 * b);
  }
}

// One warp's sample on the CUDA cores, eight lanes a head: lane 8 h + l
// takes columns c = 4 l .. 4 l + 3 of head h. base points at the sample's
// first row; head h's q (scaled), k and v start at columns 36 h, 144 + 36 h
// and 288 + 36 h. First k's columns c over T: their max m, e^(k - m) in
// place and their sums z (k's softmax is e / z). Then the context columns
// ctx[d][c] = sum over t of e[t][d] v[t][c], times 1 / z_d at the end, in
// the lane's registers (k's row a float4 at a time, shared by the head's
// eight lanes), and each row's q . ctx[:, c] replaces q[t][c] (the head's
// lanes have read the row: the hidden tile takes q's columns), up to four
// rows at a time (independent chains of fused multiply-adds).
__device__ __forceinline__ void attend(float* base, int T, int lane) {
  const int c = 4 * (lane & 7), head = (lane >> 3) * kHeadCols;
  float* const q = base + head;
  const float* const k = base + kSelCols + head;
  const float* const v = base + 2 * kSelCols + head;
  float4 mx = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const float4 k4 = *reinterpret_cast<const float4*>(k + t * kQkvStride + c);
    mx = make_float4(fmaxf(mx.x, k4.x), fmaxf(mx.y, k4.y), fmaxf(mx.z, k4.z), fmaxf(mx.w, k4.w));
  }
  float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    float4* kp = reinterpret_cast<float4*>(base + kSelCols + head + t * kQkvStride + c);
    const float4 k4 = *kp;
    const float4 e = make_float4(expf(k4.x - mx.x), expf(k4.y - mx.y), expf(k4.z - mx.z), expf(k4.w - mx.w));
    *kp = e;
    z = make_float4(z.x + e.x, z.y + e.y, z.z + e.z, z.w + e.w);
  }
  const float rz[4] = {1.0f / z.x, 1.0f / z.y, 1.0f / z.z, 1.0f / z.w};
  __syncwarp();
  float ctx[kDimHead][4];
#pragma unroll
  for (int d = 0; d < kDimHead; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) ctx[d][i] = 0.f;
#pragma unroll 2
  for (int t = 0; t < T; ++t) {
    const float* kr = k + t * kQkvStride;
    const float4 v4 = *reinterpret_cast<const float4*>(v + t * kQkvStride + c);
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int d = 0; d < kDimHead; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ctx[d][i] = fmaf(k4.x, vv[i], ctx[d][i]);
        ctx[d + 1][i] = fmaf(k4.y, vv[i], ctx[d + 1][i]);
        ctx[d + 2][i] = fmaf(k4.z, vv[i], ctx[d + 2][i]);
        ctx[d + 3][i] = fmaf(k4.w, vv[i], ctx[d + 3][i]);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < 8; ++l)  // 1 / z_d from the lane of the head that holds d = 4 l + j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = __shfl_sync(0xFFFFFFFFu, rz[j], (lane & 24) | l);
#pragma unroll
      for (int i = 0; i < 4; ++i) ctx[4 * l + j][i] *= r;
    }
  auto rows = [&](auto n, int t) {  // rows t .. t + n - 1
    constexpr int kN = decltype(n)::value;
    float o[kN][4];
#pragma unroll
    for (int r = 0; r < kN; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[r][i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDimHead; d += 4) {
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(q + (t + r) * kQkvStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[r][i] = fmaf(q4.x, ctx[d][i], o[r][i]);
          o[r][i] = fmaf(q4.y, ctx[d + 1][i], o[r][i]);
          o[r][i] = fmaf(q4.z, ctx[d + 2][i], o[r][i]);
          o[r][i] = fmaf(q4.w, ctx[d + 3][i], o[r][i]);
        }
      }
    }
    __syncwarp();  // every lane of the head has read the rows before any overwrites them
#pragma unroll
    for (int r = 0; r < kN; ++r)
      *reinterpret_cast<float4*>(q + (t + r) * kQkvStride + c) = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
  };
  int t = 0;
  for (; t + 4 <= T; t += 4) rows(std::integral_constant<int, 4>{}, t);
  switch (T - t) {
    case 3: rows(std::integral_constant<int, 3>{}, t); break;
    case 2: rows(std::integral_constant<int, 2>{}, t); break;
    case 1: rows(std::integral_constant<int, 1>{}, t); break;
    default: break;
  }
}

// A consumer thread's walk. Its fragment rows r0 = 64 wg + 16 w + g and
// r1 = r0 + 8 of the tile (g = lane / 4, t = lane % 4). xn's chunk goes
// into the slot in wgmma's K-major layout (8-row core matrices of 16
// bytes, 128 bytes between the K halves, 256 between row groups: the
// weights' own), a thread's four elements at words 128 w + 4 g + t + {0,
// 64, 32, 96} of its warpgroup's plane, 32 consecutive words a warp. The
// out product takes A from registers: fragments a0 (r0, t), a1 (r1, t), a2
// (r0, t + 4), a3 (r1, t + 4). Accumulator word 4j + i: row i < 2 ? r0 :
// r1, column 8j + 2t + (i & 1).
__device__ __forceinline__ void consume(const AttnArgs& a, int warp, char* ring, const float2* stats,
                                        uint32_t full, uint32_t empty, uint32_t sfull, uint32_t sempty,
                                        uint32_t rfree) {
  float* qb = reinterpret_cast<float*>(ring);  // the q | k | v tile [kRows][kQkvStride], between the products
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3, wg = warp >> 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + g8, r1 = r0 + 8;
  const int aw = 128 * (warp & 3) + 4 * g8 + t4;
  const int nch = a.C / 8, ontiles = (a.C + kOutNt - 1) / kOutNt;
  const int rows = a.samples * a.T;
  const long long nrows = static_cast<long long>(a.B) * a.T;
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) cindm::mbar_arrive(empty + 8 * slot);
  };
  int it = 0, j = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
    const long long row0 = static_cast<long long>(tile) * rows;
    const bool live0 = r0 < rows && row0 + r0 < nrows, live1 = r1 < rows && row0 + r1 < nrows;
    const float* x0 = a.x + (row0 + r0) * a.C;  // row r1's lies 8 C on; read only where live
    const int b = j & 1;
    cindm::mbar_wait(sfull + 8 * b, (j >> 1) & 1);
    const float2 st0 = stats[b * kRows + r0], st1 = stats[b * kRows + r1];
    __syncwarp();
    if (lane == 0) cindm::mbar_arrive(sempty + 8 * b);

    // q | k | v of the warpgroup's 64 rows: three N tiles of 128, K in chunks of 8
    float acc[kQkvTiles][64];
#pragma unroll
    for (int t = 0; t < kQkvTiles; ++t)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    float xv[kGroup][4];
    auto load_x = [&](int c) {  // chunks c .. c + kGroup - 1
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = 8 * (c + u) + t4;
        xv[u][0] = live0 ? __ldg(x0 + k) : 0.f;
        xv[u][1] = live1 ? __ldg(x0 + 8 * a.C + k) : 0.f;
        xv[u][2] = live0 ? __ldg(x0 + k + 4) : 0.f;
        xv[u][3] = live1 ? __ldg(x0 + 8 * a.C + k + 4) : 0.f;
      }
    };
    load_x(0);
    int held = -1;  // the first slot of the group before, in flight
    for (int c = 0; c < nch; c += kGroup, it += kGroup) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int slot = (it + u) % kStages;
        // the slot's previous use done by both warpgroups (an out part
        // reads the bytes this warpgroup's planes take)
        cindm::mbar_wait(empty + 8 * slot, (((it + u) / kStages) & 1) ^ 1);
        // xn's chunk, split once: (x - mean) * rstd * g
        uint32_t* ap = reinterpret_cast<uint32_t*>(ring + slot * kSlotBytes + wg * 2 * kAPlane) + aw;
        const float g0 = __ldg(a.g + 8 * (c + u) + t4), g1 = __ldg(a.g + 8 * (c + u) + t4 + 4);
        uint32_t big, small;
        split_tf32((xv[u][0] - st0.x) * st0.y * g0, big, small);
        ap[0] = big, ap[kAPlane / 4] = small;
        split_tf32((xv[u][1] - st1.x) * st1.y * g0, big, small);
        ap[64] = big, ap[64 + kAPlane / 4] = small;
        split_tf32((xv[u][2] - st0.x) * st0.y * g1, big, small);
        ap[32] = big, ap[32 + kAPlane / 4] = small;
        split_tf32((xv[u][3] - st1.x) * st1.y * g1, big, small);
        ap[96] = big, ap[96 + kAPlane / 4] = small;
      }
      if (c + kGroup < nch) load_x(c + kGroup);  // in flight under these chunks' wgmmas
      cindm::fence_proxy_async();                // the stores, before wgmma reads them
      warpgroup_sync(wg);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) cindm::mbar_wait(full + 8 * ((it + u) % kStages), ((it + u) / kStages) & 1);
      cindm::wgmma_fence();
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const char* st = ring + ((it + u) % kStages) * kSlotBytes;
        const uint32_t abig = cindm::smem_u32(st + wg * 2 * kAPlane), wq = cindm::smem_u32(st + kAOff);
#pragma unroll
        for (int t = 0; t < kQkvTiles; ++t) {
          const uint32_t big = wq + t * kQkvBlock;
          cindm::wgmma_tf32_ss(acc[t], cindm::weight_desc(abig + kAPlane), cindm::weight_desc(big));
          cindm::wgmma_tf32_ss(acc[t], cindm::weight_desc(abig), cindm::weight_desc(big + kQkvBlock / 2));
          cindm::wgmma_tf32_ss(acc[t], cindm::weight_desc(abig), cindm::weight_desc(big));
        }
      }
      cindm::wgmma_commit();
      cindm::wgmma_wait_1();
      if (held >= 0)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) release((held + u) % kStages);
      held = it;
    }
    cindm::wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < kQkvTiles; ++t) cindm::fence_acc(acc[t]);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) release((held + u) % kStages);
    consumer_sync();  // both warpgroups are done with the ring: the q | k | v tile takes its bytes

#pragma unroll
    for (int t = 0; t < kQkvTiles; ++t) {  // q (scaled), k, v of every head
      const float s = t == 0 ? kScale : 1.0f;
#pragma unroll
      for (int jn = 0; jn < kQkvNt / 8; ++jn) {  // n8 block jn: head jn / 4
        const int col = t * kSelCols + (jn >> 2) * kHeadCols + (jn & 3) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(qb + r0 * kQkvStride + col) =
            make_float2(acc[t][4 * jn] * s, acc[t][4 * jn + 1] * s);
        *reinterpret_cast<float2*>(qb + r1 * kQkvStride + col) =
            make_float2(acc[t][4 * jn + 2] * s, acc[t][4 * jn + 3] * s);
      }
    }
    consumer_sync();
    for (int smp = warp; smp < a.samples; smp += kConsumerWarps)  // a warp a sample
      attend(qb + smp * a.T * kQkvStride, a.T, lane);
    consumer_sync();  // the hidden tile is whole, in q's columns

    // the out product: the hidden fragments split once, then N tiles of 64
    uint32_t hbig[kOutChunks][4], hsmall[kOutChunks][4];
#pragma unroll
    for (int k = 0; k < kOutChunks; ++k) {  // hidden column 8 k + t: head k / 4's q column 8 (k % 4) + t
      const float* p0 = qb + r0 * kQkvStride + (k >> 2) * kHeadCols + (k & 3) * 8 + t4;
      const float* p1 = qb + r1 * kQkvStride + (k >> 2) * kHeadCols + (k & 3) * 8 + t4;
      split_tf32(p0[0], hbig[k][0], hsmall[k][0]);
      split_tf32(p1[0], hbig[k][1], hsmall[k][1]);
      split_tf32(p0[4], hbig[k][2], hsmall[k][2]);
      split_tf32(p1[4], hbig[k][3], hsmall[k][3]);
    }
    cindm::fence_proxy_async();  // the tile's reads and writes, before the ring's copies into its bytes
    __syncwarp();
    if (lane == 0) cindm::mbar_arrive(rfree);
    for (int n = 0; n < ontiles; ++n) {
      // the residual and bias of the N tile's columns, in flight under its wgmmas
      float2 xres[kOutNt / 8][2], bias[kOutNt / 8];
#pragma unroll
      for (int jn = 0; jn < kOutNt / 8; ++jn) {
        const int col = n * kOutNt + 8 * jn + 2 * t4;
        const bool in = col < a.C;
        bias[jn] = in ? __ldg(reinterpret_cast<const float2*>(a.bout + col)) : make_float2(0.f, 0.f);
        xres[jn][0] = in && live0 ? __ldg(reinterpret_cast<const float2*>(x0 + col)) : make_float2(0.f, 0.f);
        xres[jn][1] = in && live1 ? __ldg(reinterpret_cast<const float2*>(x0 + 8 * a.C + col))
                                  : make_float2(0.f, 0.f);
      }
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      int held = -1;
#pragma unroll
      for (int part = 0; part < kOutParts; ++part, ++it) {
        const int slot = it % kStages;
        cindm::mbar_wait(full + 8 * slot, (it / kStages) & 1);
        const uint32_t st = cindm::smem_u32(ring + slot * kSlotBytes);
        cindm::wgmma_fence();
#pragma unroll
        for (int cc = 0; cc < kOutSlotChunks; ++cc) {
          const int k = part * kOutSlotChunks + cc;
          if (k < kOutChunks) {
            const uint32_t big = st + cc * kOutBlock;
            cindm::wgmma_tf32(o, hsmall[k], cindm::weight_desc(big));
            cindm::wgmma_tf32(o, hbig[k], cindm::weight_desc(big + kOutBlock / 2));
            cindm::wgmma_tf32(o, hbig[k], cindm::weight_desc(big));
          }
        }
        cindm::wgmma_commit();
        cindm::wgmma_wait_1();
        if (held >= 0) release(held);
        held = slot;
      }
      cindm::wgmma_wait_all();
      cindm::fence_acc(o);
      release(held);
      // epilogue: + bout + x, pairs of columns by 8 bytes; padding rows and
      // rows past the batch are not stored
#pragma unroll
      for (int jn = 0; jn < kOutNt / 8; ++jn) {
        const int col = n * kOutNt + 8 * jn + 2 * t4;
        if (col >= a.C) continue;
        const float2 bv = bias[jn];
        if (live0)
          *reinterpret_cast<float2*>(a.out + (row0 + r0) * a.C + col) =
              make_float2((o[4 * jn] + bv.x) + xres[jn][0].x, (o[4 * jn + 1] + bv.y) + xres[jn][0].y);
        if (live1)
          *reinterpret_cast<float2*>(a.out + (row0 + r1) * a.C + col) =
              make_float2((o[4 * jn + 2] + bv.x) + xres[jn][1].x, (o[4 * jn + 3] + bv.y) + xres[jn][1].y);
      }
    }
  }
}

__global__ void __launch_bounds__(kAttnThreads, 1) linear_attention(const AttnArgs a) {
  extern __shared__ __align__(16) float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  char* ring = smem;  // the ring's slots; between the products, the q | k | v tile
  float2* stats = reinterpret_cast<float2*>(smem + region_bytes());  // [2][kRows]
  const uint32_t full = cindm::smem_u32(stats + 2 * kRows), empty = full + 8 * kStages;
  const uint32_t sfull = empty + 8 * kStages, sempty = sfull + 16, rfree = sempty + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      cindm::mbar_init(full + 8 * s, 1);                 // the feeding lane's arrival and its bytes
      cindm::mbar_init(empty + 8 * s, kConsumerWarps);   // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      cindm::mbar_init(sfull + 8 * s, kStatWarps);
      cindm::mbar_init(sempty + 8 * s, kConsumerWarps);
    }
    cindm::mbar_init(rfree, kConsumerWarps);
  }
  // the first tile's statistics, all warps at once: nothing runs beside them yet
  row_stats<8>(a, blockIdx.x, stats, 4 * static_cast<int>(threadIdx.x >> 5), kAttnThreads / 8);
  __syncthreads();
  // the role, warp-uniform as the compiler can see (lane 0's value): wgmma
  // is issued only in code no warp diverges into
  const int warp = __shfl_sync(0xFFFFFFFFu, static_cast<int>(threadIdx.x >> 5), 0);
  if (warp >= kConsumerWarps) {
    cindm::regs_dec<kProducerRegs>();
    if (warp == kConsumerWarps) {
      if ((threadIdx.x & 31) == 0) feed_weights(a, ring, full, empty, rfree);
    } else {
      tile_stats(a, stats, sfull, sempty, warp - kConsumerWarps - 1);
    }
  } else {
    cindm::regs_inc<kConsumerRegs>();
    consume(a, warp, ring, stats, full, empty, sfull, sempty, rfree);
  }
}

unsigned long long g_smem_set = 0;  // devices whose limit is set (a bit each)

}  // namespace

// x, g, bout, out fp32; wq: wqkv [C, 384] laid out by stage_weights for N
// tiles of 128, wo: wout [128, C] for N tiles of 64 (K = 1); C a multiple
// of 16, 0 < T <= 96, ctas in 1 .. the tiles (ops/_build.plan_attention);
// the wrapper (ops/linear_attention.py) checks the same.
extern "C" int cindm_linear_attention(const float* x, const float* g, const void* wq, const void* wo,
                                      const float* bout, float* out, int B, int T, int C, int ctas, float eps,
                                      void* stream) {
  if (!x || !g || !wq || !wo || !bout || !out || B <= 0 || C <= 0 || C % kCMultiple || T <= 0 || T > kMaxT ||
      reinterpret_cast<uintptr_t>(wq) % 16 || reinterpret_cast<uintptr_t>(wo) % 16 ||
      attention_smem_bytes() > cindm::kSmemMax)
    return cudaErrorInvalidValue;
  AttnArgs a{x, g, static_cast<const char*>(wq), static_cast<const char*>(wo), bout, out, B, T, C, eps,
             kRows / T, 0};
  a.tiles = (B + a.samples - 1) / a.samples;
  if (ctas < 1 || ctas > a.tiles) return cudaErrorInvalidValue;
  CINDM_TRY(cindm::allow_smem_once(linear_attention, g_smem_set));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  linear_attention<<<ctas, kAttnThreads, attention_smem_bytes(), s>>>(a);
  return cudaGetLastError();
}
