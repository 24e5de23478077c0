// Device code shared by fused_rtb.cu and fused_conv_gn.cu: one Conv1d +
// GroupNorm + Mish stage as an implicit GEMM on Hopper's tensor cores.
//
//   out[r][o] = Mish(GN(sum_k sum_c x[r + k - 2][c] * w[k][c][o] + b[o]))
//               (+ temb[s][o] | + xres[r][o] | + (xres @ wres)[r][o] + bres[o])
//
// GEMM: M = rows of whole samples (r = s*T + t), N = output channels in
// whole GroupNorm groups, K = 5 taps x C. A block owns a tile of
// kTileRows = 192 rows (192/T whole samples: 8 at T=24, 64 at T=3) and an N
// tile of 64 or 128 channels that holds whole groups, so the GroupNorm of
// every (sample, group) it owns is complete inside the block. The tile plan
// (samples per tile, N tile, shared-memory bytes) comes from the Python
// planner, ops/_build.plan_stage, and the launch checks it against
// stage_smem_bytes().
//
// Arithmetic: 3xTF32. Each fp32 operand a is split into big = tf32_rna(a)
// and small = tf32_rna(a - big); each product is small*big + big*small +
// big*big, three wgmma .tf32 passes into one fp32 accumulator, which keeps
// fp32 accuracy (the dropped small*small term is ~2^-22 of the product).
// GroupNorm statistics are two-pass fp32 over the fp32 accumulator.
//
// Main loop: the C dimension streams through shared memory in chunks of
// kChunk = 8 input channels (one k8 wgmma step per tap). Before the stage
// kernel, stage_weights lays w out once per call as tf32 big/small planes
// in wgmma's K-major core-matrix layout, one contiguous block per (N tile,
// chunk); one thread moves each block, a chunk ahead, into one of two
// weight stages with the bulk-copy engine, completing on an mbarrier. The
// block's 192 input rows x 8 channels arrive by cp.async in a ring of four
// stages, three chunks ahead. A, the input, goes to wgmma from registers:
// each thread loads its fragment rows for every tap, zeroes a tap that
// falls outside its own sample (the conv's zero padding) and splits it in
// integer arithmetic, for the next chunk while the tensor cores work on
// this one. Three warpgroups each own 64 rows of the tile and issue 5 (3 at
// T <= 3) taps x 3 passes of wgmma m64nNk8 per chunk.
//
// L2 traffic: every block reads its N tile's weights once per 192 rows,
// about 8 GB per denoiser forward at batch 5,376 in fp32 terms (16 GB as
// big/small pairs), where the CUDA-core kernel this replaces read them
// once per 24 rows (about 64 GB).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cindm {

constexpr int kTileRows = 192;   // M tile: three warpgroups x 64 rows
constexpr int kThreads = 384;    // three warpgroups
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 128 == 0, "an N tile's columns map onto threads");
constexpr int kConvK = 5;        // conv width of every block of the denoiser
constexpr int kChunk = 8;        // input channels per stage: one k8 step per tap
constexpr int kXStride = kChunk + 4;   // floats per staged input row; the pad
                                       // makes fragment loads conflict-free
constexpr size_t kXBytes = size_t(kTileRows) * kXStride * 4;  // one input plane
// A weight plane (one tap, big or small) in wgmma's K-major, unswizzled
// layout: core matrices of 8 channels (N) x 4 inputs (K), 16 B per row.
// The two K halves of an n8 block lie 128 B apart (LBO); n8 blocks lie
// 256 B apart (SBO).
constexpr int kLboBytes = 128;
constexpr int kSboBytes = 256;
constexpr size_t kSmemMax = 232448;  // the H100's per-block limit

constexpr int kXStages = 4;  // input ring: cp.async runs three stages ahead
// Bytes of one weight block: the K taps' big and small planes for one chunk
// of 8 input channels and one N tile, laid out as wgmma reads them.
__host__ __device__ constexpr size_t weight_block_bytes(int nt, int k) {
  return size_t(2 * k) * (nt / 8) * kSboBytes;
}
__host__ __device__ constexpr size_t tile_bytes(int nt) { return size_t(kTileRows) * (nt + 4) * 4; }
// region0: the ring (kXStages input stages, two weight stages) during the
// main loops, then the [192][NT+4] conv tile, except with the projection,
// whose GEMM needs the ring again while the conv tile waits in region1;
// then the per-(sample, group) statistics and the weight stages' two
// mbarriers.
__host__ __device__ constexpr size_t ring_bytes(int nt) {
  return kXStages * kXBytes + 2 * weight_block_bytes(nt, kConvK);
}
__host__ __device__ constexpr size_t region0_bytes(int nt) {
  return ring_bytes(nt) > tile_bytes(nt) ? ring_bytes(nt) : tile_bytes(nt);
}
// Mirrors ops/_build.plan_stage; the launch refuses a plan whose bytes differ.
inline size_t stage_smem_bytes(int nt, int samples, int groups_per_tile, bool proj) {
  return region0_bytes(nt) + (proj ? tile_bytes(nt) : 0) +
         2 * size_t(samples) * groups_per_tile * 4 + 16;
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

// Bytes of w [K][C][O] laid out by stage_weights for N tiles of nt.
inline size_t staged_weight_bytes(int nt, int C, int O, int K) {
  return size_t((O + nt - 1) / nt) * ((C + kChunk - 1) / kChunk) * weight_block_bytes(nt, K);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most kXStages - 3 input stages are still in flight: the
// input of the chunk after the next one has landed.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kXStages - 3) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One thread: expect `bytes` on the barrier and copy them, contiguous, from
// global to shared memory with the bulk-copy engine.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

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

template <int K, int KW>
__device__ __forceinline__ TileRows tile_rows(int S, int ns, int T) {
  constexpr int kPad = K / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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

// acc += conv_K(in)[rows of this tile][n0, n0 + NT): the implicit GEMM main
// loop over C in kChunk stages. K = 5 for the conv (taps r-2 .. r+2 of the
// row's own sample), K = 1 for the 1x1 residual projection; each warpgroup
// issues KW taps from tr.klo on. `wblocks` holds this N tile's weight
// blocks, one per chunk (stage_weights). `seq` counts the chunks that
// earlier calls in this block pushed through the two weight stages, whose
// mbarriers sit at `bars`. Rows of absent samples (the ragged end of the
// batch) read zeros and are never stored. Ends with a barrier: the ring is
// free again.
template <int NT, int K, int KW>
__device__ void conv_gemm(const float* __restrict__ in, int Cin, int row0, int nrows,
                          const TileRows& tr, const char* __restrict__ wblocks, int seq,
                          char* smem, uint32_t bars, float (&acc)[NT / 2]) {
  constexpr int kPad = K / 2;
  constexpr int kPlaneBytes = (NT / 8) * kSboBytes;
  constexpr uint32_t kBlock = weight_block_bytes(NT, K);
  const int q4 = threadIdx.x & 3;
  const int nchunks = (Cin + kChunk - 1) / kChunk;
  char* wring = smem + kXStages * kXBytes;
  constexpr size_t kWStage = weight_block_bytes(NT, kConvK);

  auto stage_x = [&](int chunk) {
    float* xs = reinterpret_cast<float*>(smem + (chunk % kXStages) * kXBytes);
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1;  // 384 threads = 192 rows x 2
    const int c = chunk * kChunk + half * 4;
    const bool full = row < nrows && c < Cin;
    const float* src = full ? in + static_cast<size_t>(row0 + row) * Cin + c : in;
    cp_async16(xs + row * kXStride + half * 4, src, full);
  };
  auto stage_w = [&](int chunk) {  // one thread
    const int q = seq + chunk;
    bulk_copy(wring + (q & 1) * kWStage, wblocks + static_cast<size_t>(chunk) * kBlock, kBlock,
              bars + 8 * (q & 1));
  };

  // A fragments of one chunk, tf32 big and small, from the staged input:
  // each thread's fragment rows for every tap its warpgroup issues, zero
  // where the tap falls outside the row's sample.
  auto load_a = [&](int chunk, uint32_t (&abig)[KW][4], uint32_t (&asmall)[KW][4]) {
    const float* xs = reinterpret_cast<const float*>(smem + (chunk % kXStages) * kXBytes);
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const int k = tr.klo + kk;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = v & 1;  // a0: (g, t), a1: (g+8, t), a2: (g, t+4), a3: (g+8, t+4)
        const float a = (tr.ok[i] >> k) & 1u
                            ? xs[(tr.r[i] + k - kPad) * kXStride + q4 + 4 * (v >> 1)]
                            : 0.0f;
        split_tf32(a, abig[kk][v], asmall[kk][v]);
      }
    }
  };
  // One chunk: wgmma on the fragments in (abig, asmall) while the next
  // chunk's fragments load into (nbig, nsmall).
  auto step = [&](int chunk, uint32_t (&abig)[KW][4], uint32_t (&asmall)[KW][4],
                  uint32_t (&nbig)[KW][4], uint32_t (&nsmall)[KW][4]) {
    const int q = seq + chunk;
    // the weight stage of chunk + 1 was last read by chunk - 1's wgmmas, done before the barrier
    if (threadIdx.x == 0 && chunk + 1 < nchunks) stage_w(chunk + 1);
    // the input stage of chunk + 3 was last read for chunk - 1's fragments, before the barrier
    if (chunk + kXStages - 1 < nchunks) stage_x(chunk + kXStages - 1);
    cp_async_commit();
    const uint32_t planes = smem_u32(wring + (q & 1) * kWStage);
    mbar_wait(bars + 8 * (q & 1), (q >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const uint32_t big = planes + 2 * (tr.klo + kk) * kPlaneBytes;
      wgmma_tf32(acc, asmall[kk], weight_desc(big));
      wgmma_tf32(acc, abig[kk], weight_desc(big + kPlaneBytes));
      wgmma_tf32(acc, abig[kk], weight_desc(big));
    }
    wgmma_commit();
    if (chunk + 1 < nchunks) load_a(chunk + 1, nbig, nsmall);  // while the tensor cores work
    wgmma_wait_all();
    fence_acc(acc);
    cp_async_wait_ahead();  // chunk + 2's input has landed: the next step loads its fragments
    __syncthreads();
  };

  if (threadIdx.x == 0) stage_w(0);
#pragma unroll
  for (int c = 0; c < kXStages - 1; ++c) {
    if (c < nchunks) stage_x(c);
    cp_async_commit();
  }
  cp_async_wait_ahead();  // chunks 0 and 1
  __syncthreads();
  uint32_t big0[KW][4], small0[KW][4], big1[KW][4], small1[KW][4];
  load_a(0, big0, small0);
  for (int chunk = 0; chunk < nchunks; chunk += 2) {
    step(chunk, big0, small0, big1, small1);
    if (chunk + 1 < nchunks) step(chunk + 1, big1, small1, big0, small0);
  }
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

template <int NT, int KW>
__global__ void __launch_bounds__(kThreads, 1) conv_gn_mish_stage(const StageArgs a) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int b0 = blockIdx.x * a.samples;
  const int ns = min(a.samples, a.B - b0);
  const int nrows = ns * a.T;
  const int row0 = b0 * a.T;
  const int n0 = blockIdx.y * NT;
  const int ncols = min(NT, a.O - n0);
  const int og = a.O / a.G;
  const int gpt = ncols / og;  // whole groups: n0 and ncols are multiples of og
  const bool proj = a.wres != nullptr;
  const int lane = threadIdx.x & 31;

  float* tile = reinterpret_cast<float*>(smem + (proj ? region0_bytes(NT) : 0));
  float* mean =
      reinterpret_cast<float*>(smem + region0_bytes(NT) + (proj ? tile_bytes(NT) : 0));
  float* rstd = mean + a.samples * gpt;
  const uint32_t bars = smem_u32(mean + 2 * a.samples * gpt);
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
  }
  __syncthreads();
  const int nchunks = (a.C + kChunk - 1) / kChunk;

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  {
    const TileRows tr = tile_rows<kConvK, KW>(a.samples, ns, a.T);
    const char* wblocks = reinterpret_cast<const char*>(a.ws) +
                          blockIdx.y * nchunks * weight_block_bytes(NT, kConvK);
    conv_gemm<NT, kConvK, KW>(a.x, a.C, row0, nrows, tr, wblocks, 0, smem, bars, acc);
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
  __syncthreads();
  tile_stats<NT>(tile, ns, a.T, gpt, og, a.eps, mean, rstd);

  if (proj) {
    // The 1x1 projection: a second GEMM over the same rows in the registers
    // the conv accumulator vacated; its result meets the normalised conv
    // output at the fragment positions, and the sum goes back to the tile.
    const TileRows tr = tile_rows<1, 1>(a.samples, ns, a.T);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    const char* wblocks = reinterpret_cast<const char*>(a.wress) +
                          blockIdx.y * ((a.Cres + kChunk - 1) / kChunk) * weight_block_bytes(NT, 1);
    conv_gemm<NT, 1, 1>(a.xres, a.Cres, row0, nrows, tr, wblocks, nchunks, smem, bars, acc);
    const int p0 = (tr.r[0] / a.T) * gpt, p1 = (tr.r[1] / a.T) * gpt;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int grp = (2 * (lane & 3) + e) / og, rem = (2 * (lane & 3) + e) % og;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        if (c < ncols) {
          const int o = n0 + c;
          const float scale = __ldg(a.gs + o), shift = __ldg(a.gb + o), bias = __ldg(a.bres + o);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!tr.live[i]) continue;
            float* t = tile + tr.r[i] * (NT + 4) + c;
            const int p = (i ? p1 : p0) + grp;
            *t = mish((*t - mean[p]) * rstd[p] * scale + shift) + acc[4 * j + 2 * i + e] + bias;
          }
        }
        for (rem += 8; rem >= og; rem -= og) ++grp;  // the group of column c + 8
      }
    }
  }
  __syncthreads();

  // Each thread keeps four neighbouring columns (NT / 4 divides kThreads),
  // so their GroupNorm affine and group indices are loaded once; the tile,
  // temb, the residual and the output move 16 bytes at a time (O is a
  // multiple of 4, so 4 columns lie within ncols together).
  const int c = 4 * (threadIdx.x % (NT / 4));
  if (c >= ncols) return;
  const int o = n0 + c;
  const float4 scale = __ldg(reinterpret_cast<const float4*>(a.gs + o));
  const float4 shift = __ldg(reinterpret_cast<const float4*>(a.gb + o));
  const int gl[4] = {c / og, (c + 1) / og, (c + 2) / og, (c + 3) / og};
  const float* ident = (!proj && a.xres != nullptr) ? a.xres : nullptr;
  const float inv_t = 1.0f / a.T;
#pragma unroll 2
  for (int r = threadIdx.x / (NT / 4); r < nrows; r += kThreads / (NT / 4)) {
    const size_t gi = static_cast<size_t>(row0 + r) * a.O + o;
    float4 v = *reinterpret_cast<const float4*>(tile + r * (NT + 4) + c);
    if (!proj) {
      const int s = static_cast<int>((r + 0.5f) * inv_t);  // r / T, exact for r < 192
      const int p = s * gpt;
      v.x = mish((v.x - mean[p + gl[0]]) * rstd[p + gl[0]] * scale.x + shift.x);
      v.y = mish((v.y - mean[p + gl[1]]) * rstd[p + gl[1]] * scale.y + shift.y);
      v.z = mish((v.z - mean[p + gl[2]]) * rstd[p + gl[2]] * scale.z + shift.z);
      v.w = mish((v.w - mean[p + gl[3]]) * rstd[p + gl[3]] * scale.w + shift.w);
      if (a.temb != nullptr) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(a.temb + (b0 + s) * size_t(a.O) + o));
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

cudaError_t launch_stage_weights(const float* w, int K, int C, int O, int nt, uint32_t* out,
                                 cudaStream_t stream) {
  const size_t total = staged_weight_bytes(nt, C, O, K) / 4;
  const size_t blocks = (total + 255) / 256;
  stage_weights<<<blocks < 4096 ? blocks : 4096, 256, 0, stream>>>(w, K, C, O, nt, out, total);
  return cudaGetLastError();
}

template <int NT, int KW>
cudaError_t launch_nt(const StageArgs& a, size_t bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_gn_mish_stage<NT, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + a.samples - 1) / a.samples, (a.O + NT - 1) / NT);
  conv_gn_mish_stage<NT, KW><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// One stage: lay the weights out (stage_weights into a.ws, a.wress), then
// launch the stage kernel with the planner's tile: `samples` whole samples
// per block, an N tile of `nt` channels, `smem_bytes` of dynamic shared
// memory. Refuses (cudaErrorInvalidValue) a plan that breaks the tiling's
// rules.
inline cudaError_t launch_stage(const StageArgs& a, int K, int nt, int smem_bytes, void* stream) {
  const bool proj = a.wres != nullptr;
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.O <= 0 || a.G <= 0 || a.O % a.G != 0 ||
      a.C % 4 != 0 || a.O % 4 != 0 || K != kConvK || (nt != 64 && nt != 128) ||
      a.samples <= 0 || a.samples * a.T > kTileRows || a.ws == nullptr ||
      (proj && (a.Cres <= 0 || a.Cres % 4 != 0 || a.wress == nullptr)) ||
      (proj != (a.bres != nullptr)))
    return cudaErrorInvalidValue;
  const int og = a.O / a.G;
  if (a.O > nt && nt % og != 0) return cudaErrorInvalidValue;  // an N tile holds whole groups
  const int gpt = (a.O < nt ? a.O : nt) / og;
  const size_t bytes = stage_smem_bytes(nt, a.samples, gpt, proj);
  if (static_cast<size_t>(smem_bytes) != bytes || bytes > kSmemMax) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_stage_weights(a.w, K, a.C, a.O, nt, a.ws, s);
  if (err == cudaSuccess && proj) err = launch_stage_weights(a.wres, 1, a.Cres, a.O, nt, a.wress, s);
  if (err != cudaSuccess) return err;
  if (a.T <= 3)
    return nt == 64 ? launch_nt<64, 3>(a, bytes, s) : launch_nt<128, 3>(a, bytes, s);
  return nt == 64 ? launch_nt<64, kConvK>(a, bytes, s) : launch_nt<128, kConvK>(a, bytes, s);
}

}  // namespace
}  // namespace cindm
