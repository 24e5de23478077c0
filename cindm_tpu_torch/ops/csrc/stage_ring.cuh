// The implicit-GEMM main loop of the Conv1d stages on Hopper (sm_90a), one
// ring for both directions: the forward stage (conv_gn_mish.cuh, the conv of
// x or h and the 1x1 projection) and the backward's two dgrads
// (conv_backward.cuh, the conv of a cotangent with the flipped weights).
//
// GEMM: M = a tile of kTileRows = 192 rows of whole samples (r = s*T + t),
// N = an N tile of NT = 64 or 128 output channels, K = taps x input
// channels. Three consumer warpgroups own 64 rows of the tile each and
// keep a 64 x NT fp32 accumulator in registers; a producer warp (the
// dgrads' 13th, the first of the forward's producer warpgroup) feeds them
// through a ring of slots in shared memory (StageRing). A slot holds kCh
// chunks of 8 input channels: the tile's 192 input rows of those channels,
// by TMA (rows of kPitch bytes under the kPitch-byte swizzle, so a warp's
// fragment reads fall on distinct banks; rows and channels past the tensor
// read zero), and their weight blocks, contiguous in the stage_weights
// (forward) or stage_weights_t (dgrads) layout, by bulk copy; each
// consumer warp releases the slot on its empty mbarrier once its wgmmas on
// it are done.
//
// Arithmetic: 3xTF32. Each fp32 operand v is split into big = tf32(v) and
// small = v - big; each product is small*big + big*small + big*big, three
// wgmma .tf32 passes (m64nNTk8) into one accumulator, which keeps fp32
// accuracy. The weights (B) arrive split by the layout kernels.
//
// The dgrads' loop (ring_produce, ring_consume with Split::kFast): one TMA
// box and one bulk copy a slot on its full mbarrier; A goes to wgmma from
// registers, a thread loading its fragment rows shifted by the tap, zero
// where the tap falls outside the row's sample (the conv's zero padding),
// and splitting them (split_tf32_fast: small unrounded) while the previous
// tap's wgmma group is in flight (wait_group 1).
//
// The forward's loop (ring_feed, ring_split, ring_consume_ss or
// ring_consume with Split::kPre) runs on a cluster of cs = 1 or 2 CTAs that
// share an N tile. Its slots hold A twice (Planes): the box, which the
// producer warpgroup's three other warps split once it has landed (its own
// mbarrier, `abox`) into tf32 big, in place, and small, beside it, with
// round-to-nearest for both halves (split_tf32), and which
// then arrive on the full mbarrier. Each CTA loads its own A box; the
// slot's weight blocks are the same for both CTAs of a cluster, so each
// CTA's producer copies one half of them with .multicast::cluster into
// both CTAs' slots (the full mbarrier of each expects the whole), and a
// slot is refilled once the consumer warps of both CTAs have released it
// (every empty mbarrier counts both CTAs' warps; a warp arrives on its own
// CTA's and, through mapa, on its peer's). At T = 3 the tile is
// position-major, so a warpgroup's taps read whole 64-row blocks of the
// box: the consumers read A from shared memory by descriptor
// (ring_consume_ss) and issue a slot's chunks x taps x passes as one wgmma
// group, one group in flight. At other T the consumers load A's fragments
// from the split planes into registers, one tap a group as the dgrads do
// (ring_consume with Split::kPre). A forward part is any run of a tile's
// chunks (ring_range): all of them, or a split tile's part.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver function is called by name)
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cindm {

constexpr int kTileRows = 192;   // M tile: three warpgroups x 64 rows
constexpr int kThreads = 384;    // the three consumer warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kRingThreads = kThreads + 32;  // and the producer warp
static_assert(kThreads % 128 == 0, "an N tile's columns map onto threads");
constexpr int kConvK = 5;        // conv width of every block of the denoiser
constexpr int kChunk = 8;        // input channels of one k8 wgmma step
// A weight plane (one tap, big or small) in wgmma's K-major, unswizzled
// layout: core matrices of 8 channels (N) x 4 inputs (K), 16 B per row.
// The two K halves of an n8 block lie 128 B apart (LBO); n8 blocks lie
// 256 B apart (SBO).
constexpr int kLboBytes = 128;
constexpr int kSboBytes = 256;
constexpr size_t kSmemMax = 232448;  // the H100's per-block limit

// Bytes of one weight block: the K taps' big and small planes for one chunk
// of 8 input channels and one N tile, laid out as wgmma reads them.
__host__ __device__ constexpr size_t weight_block_bytes(int nt, int k) {
  return size_t(2 * k) * (nt / 8) * kSboBytes;
}
// A conv tile [192][NT + 4] of fp32 (the pad spreads a column's rows over banks).
__host__ __device__ constexpr size_t tile_bytes(int nt) { return size_t(kTileRows) * (nt + 4) * 4; }
__host__ __device__ constexpr size_t align1024(size_t b) { return (b + 1023) / 1024 * 1024; }

// One job of a weight layout kernel: the weights w (K taps) of a conv from
// C to O channels laid out for N tiles of nt into `out` as the ring's bulk
// copies read them, per N tile and chunk of 8 input channels one block of
// weight_block_bytes(nt, K). stage_weights (the forward's,
// conv_gn_mish.cuh) reads w [K][C][O]; stage_weights_t (the dgrads',
// conv_backward.cuh) reads w [K][O][C], flipped in time. A launch takes up
// to kLayoutJobs jobs, one after another in its grid.
struct LayoutJob {
  const float* w;
  uint32_t* out;
  int K, C, O, nt;
  int block0;  // the job's first thread block
};
constexpr int kLayoutJobs = 3;
constexpr int kLayoutThreads = 256;
constexpr int kLayoutCols = 8 * kChunk;  // input channels of one thread block: 8 chunks

// Thread blocks of one job: one per N tile, group of 8 chunks and tap.
__host__ __device__ inline int layout_blocks(int K, int C, int O, int nt) {
  return (O + nt - 1) / nt * (((C + kChunk - 1) / kChunk + 7) / 8) * K;
}

// Gives each of the n jobs its first thread block, and the absent ones
// (n .. kLayoutJobs - 1) the first past the grid; returns the grid.
inline int layout_grid(LayoutJob* jobs, int n) {
  int blocks = 0;
  for (int i = 0; i < kLayoutJobs; ++i) {
    jobs[i].block0 = blocks;
    if (i < n) blocks += layout_blocks(jobs[i].K, jobs[i].C, jobs[i].O, jobs[i].nt);
  }
  return blocks;
}

// The ring for an N tile of NT channels: Stages slots of SlotBytes, each
// holding kCh chunks of 8 input channels of one part of K: the tile's 192
// input rows (kPitch bytes a row, swizzled over kPitch bytes by TMA), with
// Planes a second plane of as many bytes beside them (the small halves of
// the split), then the chunks' weight blocks (at kWOff). By default (the
// dgrads) 2 chunks a slot at NT = 64, 1 at NT = 128, with blocks of five
// taps; 3 slots at NT = 64, 2 at NT = 128, beside a tile of their own. A
// K = 1 part's blocks are a fifth of a conv's, so the forward's projection
// packs more chunks into its conv's slots (SlotBytes given).
template <int NT, int Stages = (NT == 64 ? 3 : 2), int Ch = (NT == 64 ? 2 : 1), size_t SlotBytes = 0,
          bool Planes = false>
struct StageRing {
  static constexpr int kNT = NT;
  static constexpr int kCh = Ch;
  static constexpr int kPitch = 4 * kChunk * kCh;  // bytes of a staged row: the swizzle's span
  static constexpr int kStages = Stages;
  static constexpr size_t kABytes = align1024(size_t(kTileRows) * kPitch);
  static constexpr size_t kWOff = Planes ? 2 * kABytes : kABytes;  // the weight blocks
  static constexpr size_t kStageBytes =
      SlotBytes != 0 ? SlotBytes : align1024(kWOff + kCh * weight_block_bytes(NT, kConvK));
  static constexpr size_t kRingBytes = kStages * kStageBytes;
};

// How A reaches the consumers: split by them (kFast, the dgrads) or already
// split in the slot's two planes by the producer warpgroup (kPre, the
// forward).
enum class Split { kFast, kPre };
constexpr uint32_t kNoPeer = 0xFFFFFFFFu;  // a cluster of one CTA: no peer to release

#define CINDM_TRY(expr)                       \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

// The range of the tail's `total` chunks, cut into `ranges`, that holds
// chunk j; the first chunk of range k (total x ranges < 2^31: the launch
// refuses a plan past it).
__host__ __device__ inline int range_of(int j, int total, int ranges) { return ((j + 1) * ranges - 1) / total; }
__host__ __device__ inline int range_start(int k, int total, int ranges) { return k * total / ranges; }

// The split of a launch's last partial wave, the forward stage's
// (conv_gn_mish.cuh) and the resampling kernel's (resample.cu; mirrors
// ops/_build.stage_split and its SPLIT_MIN_CHUNKS, SPLIT_PARTS): a part is
// one ring stage at least (the ring runs on across a cluster's parts); the
// tail's chunks go into ranges of at least a tile's chunks / kSplitParts,
// so a tile has about kSplitParts parts at most, each of which its
// finisher reads.
constexpr int kSplitMinChunks = 1;
constexpr int kSplitParts = 8;
struct StageSplit {
  int tail;           // the last `tail` cluster items are split; 0: every item runs whole
  int tail_clusters;  // the tail's chunks in this many contiguous ranges, one a cluster
  int max_parts;      // the most parts of a tile
};

// How `items` cluster items of `chunks` K chunks go over `clusters`
// clusters: those of full waves whole, the rest (items % clusters) cut into
// ranges of their chunks, one a cluster, at most as many ranges as
// tail x kSplitParts; no split where `split` is false, a tile has one chunk
// or every wave is full.
inline StageSplit stage_split(int items, int chunks, int clusters, bool split) {
  StageSplit s{0, 0, 1};
  const int tail = items % clusters;
  if (!split || chunks < 2 * kSplitMinChunks || tail == 0) return s;
  const int total = tail * chunks;
  int q = clusters;
  if (q > tail * kSplitParts) q = tail * kSplitParts;
  if (q > total / kSplitMinChunks) q = total / kSplitMinChunks;
  s.tail = tail;
  s.tail_clusters = q;
  for (int i = 0; i < tail; ++i) {
    const int parts = range_of((i + 1) * chunks - 1, total, q) - range_of(i * chunks, total, q) + 1;
    if (parts > s.max_parts) s.max_parts = parts;
  }
  return s;
}

// Bytes of a launch's workspace: a slot of 192 x nt partial sums per tail
// item, part and rank (mirrors StagePlan.work_bytes).
inline size_t stage_work_bytes(const StageSplit& s, int cs, int nt) {
  return size_t(s.tail) * s.max_parts * cs * kTileRows * nt * 4;
}

// The split and CTAs of a launch of `items` cluster items of `chunks` K
// chunks in clusters of cs on a device of `sms` SMs (split where `split`):
// cs CTAs a cluster with work, one an SM at most (mirrors
// ops/_build.plan_stage and plan_resample). Refuses what the walk's int
// arithmetic (range_of: tail x chunks x ranges) and StagePart's tag (parts
// and tail items < 256) do not hold.
inline cudaError_t walk_plan(int items, int chunks, int cs, int sms, bool split, StageSplit* s, int* ctas) {
  const int clusters = sms / cs;
  if (clusters < 1 || clusters > 255 || static_cast<long long>(clusters) * clusters * chunks >= (1ll << 31))
    return cudaErrorInvalidValue;
  *s = stage_split(items, chunks, clusters, split);
  const int used = items - s->tail > s->tail_clusters ? items - s->tail : s->tail_clusters;
  *ctas = cs * (used < clusters ? used : clusters);
  return cudaSuccess;
}

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// tf32 with round-to-nearest, ties away from zero (the low 13 bits zero),
// as cvt.rna.tf32.f32 rounds, in integer operations. Adding half a tf32 ulp
// to the magnitude bits and truncating rounds ties away from zero; a carry
// moves into the exponent as it should, the largest floats round to inf,
// inf stays inf, and a NaN becomes the canonical NaN 0x7FFFFFFF.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  const uint32_t r = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  return v != v ? 0x7FFFFFFFu : r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// The split in 3 operations where split_tf32 takes 9: big = v rounded to
// tf32 (nearest, ties away; NaN and inf are not kept apart, which only a
// NaN or inf input could tell), small = v - big exactly in fp32, handed
// over unrounded: the tensor cores read a tf32 operand's top 19 bits, so
// small is truncated there, 2^-11 of |small| <= 2^-22 of |v|.
__device__ __forceinline__ void split_tf32_fast(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// A layout kernel's thread block: its job, and the N tile, group of 8
// chunks and tap of that job it lays out (blockIdx.x - job.block0 =
// (ntile * groups + grp) * K + tap).
struct LayoutBlock {
  LayoutJob j;
  int nchunks, tap, grp, ntile;
};
__device__ __forceinline__ LayoutBlock layout_block(const LayoutJob& j0, const LayoutJob& j1, const LayoutJob& j2) {
  const int bx = static_cast<int>(blockIdx.x);
  LayoutBlock b;
  b.j = bx < j1.block0 ? j0 : bx < j2.block0 ? j1 : j2;
  const int local = bx - b.j.block0;
  b.nchunks = (b.j.C + kChunk - 1) / kChunk;
  const int ngroups = (b.nchunks + 7) / 8;
  b.tap = local % b.j.K;
  b.grp = local / b.j.K % ngroups;
  b.ntile = local / (b.j.K * ngroups);
  return b;
}

// An mbarrier whose phase completes after `count` arrivals (and the bytes they expect).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
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

// The same copy into the same offset of the shared memory of both CTAs of a
// cluster of 2, counted on the barrier at the same offset in each.
__device__ __forceinline__ void bulk_load_pair(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar), "h"(static_cast<uint16_t>(0x3))
      : "memory");
}

// Every thread of every CTA of the cluster; what each wrote to shared memory
// before is visible to the others after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Arrive on the mbarrier at shared address `bar` of CTA `rank` of the
// cluster, with the arrive's default semantics. What it orders is the
// caller's finished wgmma reads of a slot before the peer's next copy into
// it; a .release.cluster arrive (which also waits for the thread's earlier
// global stores) made the forward stage 15-45% slower.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma's operand reads, TMA's writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of a 3D tensor (coordinates c, y, z; outside the tensor zeros),
// counted like tma_load_2d's.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(y), "r"(z), "r"(bar)
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

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most one of this warpgroup's wgmma groups is in flight.
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The 384 threads of the three consumer warpgroups (not the producer warp).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

// A warpgroup's register budget from here on (multiples of 8 in 24 .. 256):
// the producer gives registers back, the consumers take them.
template <int N>
__device__ __forceinline__ void regs_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void regs_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }

// Keeps the compiler from moving accumulator reads across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: K-major, no swizzle, LBO/SBO as above.
__device__ __forceinline__ uint64_t weight_desc(uint32_t plane) {
  return static_cast<uint64_t>((plane & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLboBytes >> 4) << 16) |
         (static_cast<uint64_t>(kSboBytes >> 4) << 32);
}

// Shared-memory matrix descriptor of 64 rows x 8 inputs of a TMA box of
// kPitch-byte rows under the kPitch-byte swizzle (K-major; 8-row atoms
// 8 * kPitch bytes apart); `addr` is the first row's chunk, 32 bytes a chunk
// into the row.
template <int kPitch>
__device__ __forceinline__ uint64_t box_desc(uint32_t addr) {
  constexpr uint64_t kLayout = kPitch == 128 ? 1 : (kPitch == 64 ? 2 : 3);  // 128-, 64-, 32-byte swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (static_cast<uint64_t>(8 * kPitch >> 4) << 32) | (kLayout << 62);
}

// D[64 x N] += A[64 x 8] * B[8 x N], both operands from shared memory.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x N] += A[64 x 8] * B[8 x N]: A in registers (fragment rows g and
// g+8 of the warp's 16, columns t and t+4), B from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The thread's two fragment rows and the taps its warpgroup issues.
// Row-major tiles (KW = 5) put natural row r = s*T + t at tile row r. At
// T <= 3 the tile is position-major instead (tile row j holds position
// t = j / S of sample s = j % S), so each warpgroup holds a single
// position or two: it issues a window of KW = 3 taps that covers every
// tap landing inside a sample, where row-major tiles would multiply 6 of
// every 15 taps at T = 3 by the zero padding.
struct TileRows {
  int r[2];        // natural rows of the thread's fragment rows g and g+8
  uint32_t ok[2];  // bit k: tap k of that row lands inside its sample
  bool live[2];    // the row exists (its sample is in the batch)
  int klo;         // the warpgroup issues taps klo .. klo + KW - 1
};

// tid: the thread's index (threadIdx.x, or a copy the caller keeps apart).
template <int K, int KW>
__device__ __forceinline__ TileRows tile_rows(int S, int ns, int T, unsigned tid = threadIdx.x) {
  constexpr int kPad = K / 2;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  TileRows tr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * i;
    const int t = KW < K ? j / S : j % T;
    const int s = KW < K ? j - t * S : j / T;
    tr.live[i] = s < ns && (KW == K || t < T);
    tr.r[i] = s * T + t;
    tr.ok[i] = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (tr.live[i] && t + k - kPad >= 0 && t + k - kPad < T) tr.ok[i] |= 1u << k;
  }
  tr.klo = KW < K ? max(0, kPad - min((wg * 64 + 63) / S, T - 1)) : 0;
  return tr;
}

// The epilogues' stores: lane q holds columns 8j + 2q, + 1 of n8 blocks j
// (a) and j + 1 (b) of a row; one shuffle with lane q ^ 1 gives lanes 0, 2
// columns 8j + 2q .. + 3 and lanes 1, 3 columns 8(j + 1) + 2(q - 1) .. + 3
// (quad_col): whole float4s, so that a quad writes 64 contiguous bytes of
// its row with one 16-byte store a lane.
__device__ __forceinline__ float4 quad_pairs(float2 a, float2 b, int q) {
  const bool odd = q & 1;
  const float2 send = odd ? a : b;
  const float rx = __shfl_xor_sync(0xffffffffu, send.x, 1), ry = __shfl_xor_sync(0xffffffffu, send.y, 1);
  return odd ? make_float4(rx, ry, b.x, b.y) : make_float4(a.x, a.y, rx, ry);
}
__device__ __forceinline__ int quad_col(int j, int q) { return q & 1 ? 8 * (j + 1) + 2 * (q - 1) : 8 * j + 2 * q; }

// One part of K: chunks [c0, c1) of 8 input channels, a run of whole ring
// stages, and the weight blocks of one N tile (one a chunk, of `taps` taps).
struct RingPart {
  int c0, c1, taps;
  const char* w;
};

// Chunks [c0, c1) of a K of `cin` channels for N tile `ntile` on ring R
// (c0 on a whole ring stage of R::kCh chunks; both cut to K's last chunk):
// the forward's part of a split tile, or with c1 <= c0 none.
template <class R>
__device__ __forceinline__ RingPart ring_range(const uint32_t* ws, int cin, int taps, int c0, int c1,
                                               int ntile) {
  const int nch = (cin + kChunk - 1) / kChunk;
  RingPart p;
  p.c0 = min(nch, c0);
  p.c1 = min(nch, c1);
  p.taps = taps;
  p.w = reinterpret_cast<const char*>(ws) + size_t(ntile) * nch * weight_block_bytes(R::kNT, taps);
  return p;
}

// Part q of cs of a K of `cin` channels for N tile `ntile` on ring R: the
// q-th of cs runs of whole ring stages (R::kCh chunks a stage); q = 0 of
// cs = 1 is all of K.
template <class R>
__device__ __forceinline__ RingPart ring_part(const uint32_t* ws, int cin, int taps, int q, int cs,
                                              int ntile) {
  constexpr int kCh = R::kCh;
  const int nst = ((cin + kChunk - 1) / kChunk + kCh - 1) / kCh;
  return ring_range<R>(ws, cin, taps, nst * q / cs * kCh, nst * (q + 1) / cs * kCh, ntile);
}

// The producer warp: for each stage of the part, once the slot is free, one
// thread loads the tile's 192 rows of the stage's channels (one TMA box,
// rows past the tensor zero) and the stage's weight blocks (one bulk copy),
// both completing on the slot's full barrier. `it` counts the ring's stages.
template <class R>
__device__ __forceinline__ void ring_produce(const CUtensorMap* map, const RingPart& p, int row0, char* ring,
                                             uint32_t full, uint32_t empty, int& it) {
  const uint32_t block = weight_block_bytes(R::kNT, p.taps);
  for (int c = p.c0; c < p.c1; c += R::kCh, ++it) {
    const int slot = it % R::kStages;
    mbar_wait(empty + 8 * slot, ((it / R::kStages) & 1) ^ 1);
    if ((threadIdx.x & 31) == 0) {
      const uint32_t wbytes = min(R::kCh, p.c1 - c) * block;
      char* st = ring + slot * R::kStageBytes;
      mbar_expect_tx(full + 8 * slot, kTileRows * R::kPitch + wbytes);
      tma_load_2d(st, map, c * kChunk, row0, full + 8 * slot);
      bulk_load(st + R::kABytes, p.w + size_t(c) * block, wbytes, full + 8 * slot);
    }
    __syncwarp();
  }
}

// Float index of (row, 16-byte unit u, word w) in a TMA box of kPitch-byte
// rows under the kPitch-byte swizzle: unit u of row r lies at unit u ^ ((r
// kPitch / 128) mod (kPitch / 16)).
template <int kPitch>
__device__ __forceinline__ int swizzled(int row, int u, int w) {
  return row * (kPitch / 4) + 4 * (u ^ ((row * kPitch >> 7) & (kPitch / 16 - 1))) + w;
}

// The register set of the u-th wgmma group of a unit: consecutive groups,
// the last and the next unit's first included, take distinct sets.
__host__ __device__ constexpr int ring_set(int unit, int u) { return unit == 5 && u == 4 ? 2 : (unit == 3 ? u : u & 1); }

// A consumer warpgroup's share of one part: per chunk of the stage and tap
// of the warpgroup's window (KW from tr.klo) one wgmma group, 3 passes of
// m64nNTk8 (3xTF32: small*big, big*small, big*big) with A, the thread's
// fragment rows shifted by the tap and zero outside their sample, from
// registers and B, the tap's weight planes, from the stage. A group stays
// in flight while the next one's fragments load into another register
// set. The groups go in units, unrolled: a chunk's KW taps (K = 5), or a
// stage's chunks (K = 1); a unit of 5 takes three sets, so that no two
// consecutive groups share one, and ptxas sees one chunk's taps at a time.
// A is split here (kFast) or read from the slot's split planes (kPre,
// where a ring of Planes holds them). A stage's slot is released
// (each warp arrives on its empty barrier, and with kPeer on its peer
// CTA's unless peer is kNoPeer) once its last group is done. Ends with
// every group done. kRel: the stage's weight blocks hold the window's KW
// taps only, tap u of the window at u (the resampling convs', whose N
// tiles take different windows of K = 3 taps); else all K taps, tap k at k.
template <class R, int K, int KW, Split kSplit, bool kPeer = false, bool kRel = false>
__device__ __forceinline__ void ring_consume(const TileRows& tr, const RingPart& p, const char* ring,
                                             uint32_t full, uint32_t empty, int& it,
                                             float (&acc)[R::kNT / 2], uint32_t peer = kNoPeer) {
  constexpr int NT = R::kNT;
  constexpr int kPad = K / 2;
  constexpr int kUnit = K == 1 ? R::kCh : KW;
  static_assert(kUnit == 2 || kUnit == 3 || kUnit == 4 || kUnit == 5,
                "consecutive groups need distinct register sets");
  static_assert(kSplit != Split::kPre || R::kWOff == 2 * R::kABytes, "kPre reads the split planes");
  constexpr uint32_t kPlane = (NT / 8) * kSboBytes;
  constexpr uint32_t kBlock = weight_block_bytes(NT, kRel ? KW : K);
  const int lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  uint32_t abig[3][4], asmall[3][4];
  // A of one group: chunk ch of the stage at st, tap k, into the set (ab, as)
  auto load_a = [&](const char* st, int ch, int k, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    const float* xs = reinterpret_cast<const float*>(st);
#pragma unroll
    for (int v = 0; v < 4; ++v) {  // a0: (g, t), a1: (g + 8, t), a2: (g, t + 4), a3: (g + 8, t + 4)
      const int h = v & 1;
      const bool ok = (tr.ok[h] >> k) & 1u;
      if constexpr (kSplit == Split::kPre) {
        const uint32_t* planes = reinterpret_cast<const uint32_t*>(st);
        const int i = swizzled<R::kPitch>(ok ? tr.r[h] + k - kPad : 0, 2 * ch + (v >> 1), q4);
        const uint32_t b = planes[i], s = planes[i + R::kABytes / 4];
        ab[v] = ok ? b : 0u;
        as[v] = ok ? s : 0u;
      } else {
        const float x = xs[swizzled<R::kPitch>(ok ? tr.r[h] + k - kPad : 0, 2 * ch + (v >> 1), q4)];
        split_tf32_fast(ok ? x : 0.0f, ab[v], as[v]);
      }
    }
  };
  // its 3 passes on the weight planes of tap k of the stage's block, committed as one group
  auto issue = [&](const char* st, int ch, int k, const uint32_t (&ab)[4], const uint32_t (&as)[4]) {
    const uint32_t big = smem_u32(st + R::kWOff) + ch * kBlock + 2 * k * kPlane;
    wgmma_fence();
    wgmma_tf32(acc, as, weight_desc(big));
    wgmma_tf32(acc, ab, weight_desc(big + kPlane));
    wgmma_tf32(acc, ab, weight_desc(big));
    wgmma_commit();
  };
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + 8 * slot);
      if constexpr (kPeer)
        if (peer != kNoPeer) mbar_arrive_peer(empty + 8 * slot, peer);
    }
  };
  int held = -1;  // a slot whose last group may still be in flight
  for (int c = p.c0; c < p.c1; c += R::kCh, ++it) {
    const int slot = it % R::kStages;
    const int nch = min(R::kCh, p.c1 - c);
    const char* st = ring + slot * R::kStageBytes;
    mbar_wait(full + 8 * slot, (it / R::kStages) & 1);
    for (int ch0 = 0; ch0 < (K == 1 ? 1 : nch); ++ch0) {
#pragma unroll
      for (int u = 0; u < kUnit; ++u) {
        const int ch = K == 1 ? u : ch0;
        if (ch < nch) {
          const int set = ring_set(kUnit, u);
          const int k = tr.klo + (K == 1 ? 0 : u);
          load_a(st, ch, k, abig[set], asmall[set]);
          issue(st, ch, kRel ? k - tr.klo : k, abig[set], asmall[set]);
          wgmma_wait_1();
          if (ch0 == 0 && u == 0 && held >= 0) {  // the previous stage's last group is done
            release(held);
            held = -1;
          }
        }
      }
    }
    held = slot;
  }
  wgmma_wait_all();
  fence_acc(acc);
  if (held >= 0) release(held);
}

// The forward's barriers: per ring slot `full` (the split planes and the
// weight blocks are in: the producer's arrival with the weights' bytes and
// one arrival a splitting warp), `empty` (cs x kWarps arrivals: every
// consumer warp of the cluster) and `abox` (the A box is in); the cluster's
// size cs (1 or 2), this CTA's rank in it and its peer (kNoPeer for cs = 1).
struct FwdRing {
  uint32_t full, empty, abox;
  int cs;
  uint32_t rank, peer;
};
constexpr int kSplitWarps = 3;  // the producer warpgroup's warps after the first

// The forward's producer warp: for each stage of the part, once the slot is
// free in both CTAs of the cluster, one thread loads this CTA's A box (box:
// a callable (dst, channel, barrier) that issues the TMA), counted on
// `abox`, and its share of the stage's weight blocks: all of them (cs = 1),
// or half, multicast to both CTAs (cs = 2); the full barrier of each CTA
// expects the whole.
template <class R, class Box>
__device__ __forceinline__ void ring_feed(const RingPart& p, const Box& box, char* ring, const FwdRing& f,
                                          int& it) {
  const uint32_t block = weight_block_bytes(R::kNT, p.taps);
  for (int c = p.c0; c < p.c1; c += R::kCh, ++it) {
    const int slot = it % R::kStages;
    mbar_wait(f.empty + 8 * slot, ((it / R::kStages) & 1) ^ 1);
    if ((threadIdx.x & 31) == 0) {
      char* st = ring + slot * R::kStageBytes;
      mbar_expect_tx(f.abox + 8 * slot, kTileRows * R::kPitch);
      box(st, c * kChunk, f.abox + 8 * slot);
      const uint32_t wbytes = min(R::kCh, p.c1 - c) * block;
      const char* w = p.w + size_t(c) * block;
      mbar_expect_tx(f.full + 8 * slot, wbytes);
      if (f.cs == 1) {
        bulk_load(st + R::kWOff, w, wbytes, f.full + 8 * slot);
      } else {
        const uint32_t half = wbytes / 2, off = f.rank * half;  // wbytes: a multiple of 256
        bulk_load_pair(st + R::kWOff + off, w + off, half, f.full + 8 * slot);
      }
    }
    __syncwarp();
  }
}

// The forward's splitting warps (kSplitWarps, thread t of 32 * kSplitWarps):
// once a stage's A box is in, each 16-byte unit v of it becomes tf32 big
// (in place) and small (at the same offset of the plane beside it),
// split_tf32 with round-to-nearest as the dgrads' consumers would split
// it, in the box's own swizzled order; then each warp arrives on the full
// barrier, its writes fenced for the async proxy that wgmma reads with.
template <class R>
__device__ __forceinline__ void ring_split(const RingPart& p, char* ring, const FwdRing& f, int t, int& it) {
  constexpr int kUnits = kTileRows * R::kPitch / 16;
  for (int c = p.c0; c < p.c1; c += R::kCh, ++it) {
    const int slot = it % R::kStages;
    mbar_wait(f.abox + 8 * slot, (it / R::kStages) & 1);
    uint4* big = reinterpret_cast<uint4*>(ring + slot * R::kStageBytes);
    uint4* small = big + R::kABytes / 16;
#pragma unroll 2
    for (int i = t; i < kUnits; i += 32 * kSplitWarps) {
      const float4 v = *reinterpret_cast<const float4*>(big + i);
      uint4 b, s;
      split_tf32(v.x, b.x, s.x);
      split_tf32(v.y, b.y, s.y);
      split_tf32(v.z, b.z, s.z);
      split_tf32(v.w, b.w, s.w);
      big[i] = b;
      small[i] = s;
    }
    fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(f.full + 8 * slot);
  }
}

// A consumer warpgroup's share of one part with A from the split planes in
// shared memory: per stage one wgmma group of all its chunks x taps x 3
// passes (small*big, big*small, big*big, in the order of ring_consume),
// one group in flight; the slot of the group before is released once it is
// done. Tap u of the warpgroup's window (weights of tap klo + u) reads A's
// 64 rows from box row arow + 64 u: at T = 3 (K = 5, position-major) the
// window's three taps read positions 0, 1 and 2, whole 64-row blocks, the
// weights' taps 2 - t .. 4 - t for the warpgroup's position t; for the 1x1
// projection (K = 1) the warpgroup's own 64 natural rows.
template <class R, int K>
__device__ __forceinline__ void ring_consume_ss(int klo, int arow, const RingPart& p, const char* ring,
                                                const FwdRing& f, int& it, float (&acc)[R::kNT / 2]) {
  constexpr int NT = R::kNT;
  constexpr int KW = K == 1 ? 1 : 3;
  constexpr uint32_t kPlane = (NT / 8) * kSboBytes;
  constexpr uint32_t kBlock = weight_block_bytes(NT, K);
  static_assert(R::kWOff == 2 * R::kABytes, "A comes from the split planes");
  const int lane = threadIdx.x & 31;
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(f.empty + 8 * slot);
      if (f.peer != kNoPeer) mbar_arrive_peer(f.empty + 8 * slot, f.peer);
    }
  };
  int held = -1;  // the slot of the group in flight
  for (int c = p.c0; c < p.c1; c += R::kCh, ++it) {
    const int slot = it % R::kStages;
    const int nch = min(R::kCh, p.c1 - c);
    const uint32_t st = smem_u32(ring + slot * R::kStageBytes);
    mbar_wait(f.full + 8 * slot, (it / R::kStages) & 1);
#pragma unroll
    for (int ch = 0; ch < R::kCh; ++ch) {
      if (ch == 0 || ch < nch) {  // a slot holds one chunk at least
        wgmma_fence();  // in the branch: ptxas would inject one before a chunk it cannot prove runs
#pragma unroll
        for (int u = 0; u < KW; ++u) {
          const uint32_t a = st + (arow + 64 * u) * R::kPitch + 32 * ch;  // big; small kABytes on
          const uint32_t b = st + R::kWOff + ch * kBlock + 2 * (klo + u) * kPlane;
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a + R::kABytes), weight_desc(b));
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a), weight_desc(b + kPlane));
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a), weight_desc(b));
        }
      }
    }
    wgmma_commit();
    wgmma_wait_1();
    if (held >= 0) release(held);
    held = slot;
  }
  wgmma_wait_all();
  fence_acc(acc);
  if (held >= 0) release(held);
}

// One part of a cluster's walk: cluster item `item`, its chunks [c0, c1),
// and `tag`: part | parts << 8 | slot << 16, part `part` of the item's
// `parts` (a whole item: all of K, part 0 of 1), `slot` the item's index in
// the split tail (its workspace slots and counters). One register for the
// three, which the consumers keep across the main loop (parts < 256: at
// most one a cluster).
struct StagePart {
  int item, c0, c1, tag;
};

// Part n of the walk of this CTA's cluster (clusters of cs CTAs) over
// `items` cluster items of `chunks` K chunks split as `s` (stage_split), in
// order: whole items cluster, + clusters, .. below items - s.tail, then its
// range of the tail's chunks, a part of each tail item the range meets;
// false past its last. `reverse`: the range's last item goes first, else
// its first. The forward stage with the projection walks in range order (a
// range ends in the first part of an item, part 0, which runs the
// projection and starts in the end of another): part 0, longer by the
// projection, goes last, and run first it was the last of its tile and
// finished it before the cluster's other part (2-8% slower at T = 3 to 12;
// PERF.md). Without the projection (the stage's other instances, the
// resampling kernel) the reverse: an item's start then arrives early, and
// a cluster finishes at most the tile of its last part; in range order, a
// cluster that finished a tile with its first part (a tie with another
// part of that tile) ran its epilogue before its second part, arrived last
// for that one too and ran two epilogues in a row: the split was 10%
// slower than whole tiles at 16 chunks a tile (128 -> 128, T = 12). From
// the launch's parameters and the CTA's index alone, read anew for each
// part (volatile), so that a walk keeps one counter across the main loop
// and not the cluster's state: with it, the consumers of the stage's
// N-tile-128 instances spilled.
__device__ __forceinline__ bool walk_part(int items, int chunks, const StageSplit& s, int cs, bool reverse, int n,
                                          StagePart& p) {
  unsigned cta, ctas;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(cta));
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(ctas));
  const int shift = cs >> 1;  // clusters of 1 or 2 CTAs
  const int cluster = static_cast<int>(cta) >> shift, clusters = static_cast<int>(ctas) >> shift;
  const int whole = items - s.tail;
  if (cluster + n * clusters < whole) {
    p = StagePart{cluster + n * clusters, 0, chunks, 1 << 8};
    return true;
  }
  if (cluster >= s.tail_clusters) return false;
  const int nw = cluster < whole ? (whole - 1 - cluster) / clusters + 1 : 0;  // its whole items
  const int total = s.tail * chunks;
  const int lo = range_start(cluster, total, s.tail_clusters);
  const int hi = range_start(cluster + 1, total, s.tail_clusters);
  const int i = reverse ? (hi - 1) / chunks - (n - nw) : lo / chunks + (n - nw), b = i * chunks;
  if (reverse ? b + chunks <= lo : b >= hi) return false;
  const int first = range_of(b, total, s.tail_clusters), last = range_of(b + chunks - 1, total, s.tail_clusters);
  p = StagePart{whole + i, max(lo, b) - b, min(hi, b + chunks) - b,
                (cluster - first) | (last - first + 1) << 8 | i << 16};
  return true;
}

// A split tile's part tag: part | parts << 8 | slot << 16.
__device__ __forceinline__ int part_of(int tag) { return tag & 0xFF; }
__device__ __forceinline__ int parts_of(int tag) { return (tag >> 8) & 0xFF; }
__device__ __forceinline__ int slot_of(int tag) { return tag >> 16; }

// The consumers' word that tells them whether they finish a split tile, at
// shared address `flag`.
__device__ __forceinline__ void put_flag(uint32_t flag, int v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(flag), "r"(v) : "memory");
}
__device__ __forceinline__ int get_flag(uint32_t flag) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(flag) : "memory");
  return v;
}

// Adds 1 to a split tile's counter and returns its value before, with
// acquire and release semantics at the device's scope: the CTA's stores
// before it (ordered to this thread by the consumers' barrier) are seen by
// whoever reads the count after, and this thread sees theirs.
__device__ __forceinline__ int count_in(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// A split tile's part (tag: part | parts << 8 | slot << 16, part `part` of
// the tile's `parts`, `slot` the tile's index in its launch's split tail),
// on the consumer warpgroups, after its main loop: stores its partial sums
// `acc` to its workspace slot of `work` ((slot * max_parts + part) * cs +
// rank, 192 x NT floats; each thread its own float4s, fragment-major) and
// counts itself in on the tile's counter (counters[slot * cs + rank]). The
// part that arrives last (flag: the shared address of the CTA's word that
// tells its consumers so) sums every part's partial sums into acc in part
// order, part 0's first (from acc where this is part 0, else from its
// slot), resets the counter to 0 and returns true: it finishes the tile.
// The others return false, as does the partner of an odd last row tile
// (live false), whose parts store and count nothing. The forward stage's
// (conv_gn_mish.cuh) and the resampling kernel's (resample.cu) split tails.
template <int NT>
__device__ __forceinline__ bool finish_split(float* work, int* counters, int max_parts, int cs, int tag,
                                             uint32_t rank, bool live, uint32_t flag, float (&acc)[NT / 2]) {
  if (!live) return false;
  constexpr int kUnits = NT / 8;  // float4s a thread
  const unsigned tid = threadIdx.x;
  const int part = part_of(tag), parts = parts_of(tag), item = slot_of(tag);
  const size_t slot = size_t(kThreads) * kUnits;  // float4s a slot
  float4* part0 = reinterpret_cast<float4*>(work) + (size_t(item) * max_parts * cs + rank) * slot + tid;
  const size_t stride = size_t(cs) * slot;  // from one part's slot to the next's
  float4* mine = part0 + part * stride;
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
    __stcg(mine + u * kThreads, make_float4(acc[4 * u], acc[4 * u + 1], acc[4 * u + 2], acc[4 * u + 3]));
  consumer_sync();  // every consumer's partial sums are stored
  if (tid == 0) {
    int* counter = counters + item * cs + rank;
    const bool last = count_in(counter) == parts - 1;
    if (last) atomicExch(counter, 0);  // every part is in: 0 again for the next launch
    put_flag(flag, last);
  }
  consumer_sync();
  if (get_flag(flag) == 0) return false;
  for (int q = part == 0 ? 1 : 0; q < parts; ++q) {
    const float4* src = part0 + q * stride;
#pragma unroll
    for (int u0 = 0; u0 < kUnits; u0 += 4) {  // four float4 loads in flight, then their adds
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcg(src + (u0 + u) * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * (u0 + u);
        if (q == 0) {
          acc[e] = v[u].x, acc[e + 1] = v[u].y, acc[e + 2] = v[u].z, acc[e + 3] = v[u].w;
        } else {
          acc[e] += v[u].x, acc[e + 1] += v[u].y, acc[e + 2] += v[u].z, acc[e + 3] += v[u].w;
        }
      }
    }
  }
  return true;
}

// cuTensorMapEncodeTiled, looked up through the runtime once: the library
// links no driver library.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// The ring's view of a part's input d [R, C]: boxes of the tile's 192 rows
// x one ring stage's channels (rows of `pitch` = R::kPitch bytes, 32, 64
// or 128, swizzled over as many); what a box reaches past the tensor reads
// zeros. C must be a multiple of 4 (16-byte rows).
cudaError_t ring_map(CUtensorMap* m, const float* d, int R, int C, int pitch) {
  EncodeTiled fn;
  CINDM_TRY(encode_tiled(&fn));
  const cuuint64_t dims[2] = {cuuint64_t(C), cuuint64_t(R)};
  const cuuint64_t strides[1] = {cuuint64_t(C) * 4};
  const cuuint32_t box[2] = {cuuint32_t(pitch / 4), kTileRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = pitch == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : pitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(d), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The forward's position-major view of x [B, T, C] at T = 3: boxes of one
// position t x 64 samples x one ring stage's channels (rows of `pitch`
// bytes, swizzled over as many), so that three boxes, t = 0, 1, 2, lay a
// tile's 192 rows out position-major (tile row t * 64 + s); what a box
// reaches past the tensor reads zeros.
cudaError_t position_map(CUtensorMap* m, const float* d, int B, int T, int C, int pitch) {
  EncodeTiled fn;
  CINDM_TRY(encode_tiled(&fn));
  const cuuint64_t dims[3] = {cuuint64_t(C), cuuint64_t(T), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(C) * 4, cuuint64_t(T) * C * 4};
  const cuuint32_t box[3] = {cuuint32_t(pitch / 4), 1, 64};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = pitch == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : pitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(d), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Sets kernel k's dynamic shared memory limit to the card's kSmemMax once
// per device (the attribute holds for the device's context), so that no
// launch pays for the call; `done` is the caller's record for k, a bit a
// device.
template <class Kernel>
cudaError_t allow_smem_once(Kernel k, unsigned long long& done) {
  int dev = 0;
  CINDM_TRY(cudaGetDevice(&dev));
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit) != 0) return cudaSuccess;
  CINDM_TRY(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemMax)));
  __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return cudaSuccess;
}

}  // namespace
}  // namespace cindm
