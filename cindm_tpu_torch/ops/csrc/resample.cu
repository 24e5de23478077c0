// The 1D denoiser's resampling convolutions for Hopper (sm_90a), 3xTF32 on
// the tensor cores: Upsample1d (a transposed conv, k4 s2 p1) and
// Downsample1d (a conv, k3 s2 p1) on channel-last [B, T, C], in and out.
//
// It replaces no TPU kernel: the JAX package leaves both to XLA
// (cindm_tpu/models/blocks.py:262 Downsample1d, a Conv of stride 2, and
// :272 Upsample1d, nn.ConvTranspose); no Pallas kernel computes them. The
// port ran them as cuDNN fp32 convolutions on transposed copies (NCT) of
// the activations: 4.54 ms of a 12.88 ms flagship forward at batch 5,376
// on an H100 (PERF.md).
//
// Both become stride-1 implicit GEMMs over contiguous reshapes of the
// tensors, with no zeros inserted:
//
//   up:   y [B, 2T, C] is y2 [B, T, 2C], y2[j] = [y[2j], y[2j + 1]], with
//           y2[j, :C] = x[j - 1] W3 + x[j] W1 + b
//           y2[j, C:] = x[j] W2 + x[j + 1] W0 + b
//         (W = the port's ConvTranspose1d weight [C_in, C_out, 4], already
//         flipped; W3 = W[:, :, 3]): a conv of x with taps -1, 0, +1 and 2C
//         outputs, of which an N tile of the first C (even) takes taps -1
//         and 0 and an N tile of the last C (odd) taps 0 and +1: each runs
//         the two taps that reach it, with its own weight blocks (w0: W3,
//         W1; w1: W2, W0, each [2, C, C]).
//   down: x [B, T, C] read as x2 [B, T/2, 2C], x2[j] = [x[2j], x[2j + 1]],
//           y[j] = x2[j, :C] W1 + x2[j - 1, C:] W0 + x2[j, C:] W2 + b
//         (W the port's Conv1d weight [3, C_in, C_out]): a 1-tap part over
//         x2's first C channels (w1: W1, [1, C, C]) and a 2-tap part, taps
//         -1 and 0, over its last C (w0: W0, W2, [2, C, C]). T is even.
//
// The weights reach the kernel laid out by stage_weights (conv_gn_mish.cuh)
// in the blocks its ring reads, once per weight version (ops/_build.staged,
// the rearrangement by ops/resample.py's *_phase_weights, also kept).
//
// What bounds it on an H100: at the flagship's widths, operations (3 x the
// valid taps' FLOP at 495 TFLOP/s) except at 64 channels, where the bytes
// of x and y are the larger (about 49.5 MB a launch at batch 5,376: 0.015
// ms at 3.35 TB/s); the six launches of a forward together 0.148 ms.
//
// Design: the forward's main loop of stage_ring.cuh, as the Conv1d stage
// runs it, with an epilogue of its own. A tile is 192 rows of whole samples
// (the GEMM's rows: x's for up, x2's for down) by an N tile of 64 or 128
// output channels (ops/_build.plan_resample chooses it, the launch takes
// it); persistent CTAs of three consumer warpgroups and a producer
// warpgroup walk parts of cluster items of two row tiles by an N tile, the
// two CTAs sharing the N tile's weight blocks by multicast. A ring slot
// holds one chunk of 8 input channels: the tile's rows by TMA (zero past
// the tensor), which the producer warpgroup's other three warps split into
// tf32 planes, and the chunk's weight blocks of two taps (ring_consume with
// kRel: the blocks hold a window of the three taps, so no zero weights are
// copied or multiplied), or of one tap for down's first part (A by
// descriptor, ring_consume_ss). The shifted rows, zero outside their
// sample, come from the planes by the taps' masks (tile_rows<3, 3>).
//
// The last partial wave is split by K where an item has kResSplitMinChunks
// chunks or more: the forward stage's split tail (stage_split, walk_part
// and finish_split of stage_ring.cuh, on the same rules): the items of full
// waves run whole, the rest as one sequence of chunks cut into one
// contiguous range a cluster; each part of a split tile stores its partial
// sums to a workspace slot and counts itself in on the tile's counter; the
// last to arrive sums the parts in part order and runs the epilogue, so two
// runs give the same bits.
//
// Epilogue: no GroupNorm (a tile need not hold whole groups); the bias in
// the consumers' registers and float4 stores (quad_pairs) straight to y,
// with the streaming hint (st.global.cs): y is read by the next layer, not
// by this launch, and up writes twice x's bytes (PERF.md: what the hint
// gains here and what the next layer's reads of y give back).
//
// What was tried and dropped (PERF.md section 6, tools/resample_ablation):
// two chunks a ring slot, position-major tiles with A by descriptor, a
// tile's stores under the next tile's first wgmma group; each moved the
// six flagship launches by less than 2%.
#include "stage_ring.cuh"

namespace cindm {

constexpr int kResThreads = kThreads + 128;  // three consumer warpgroups, a producer warpgroup
constexpr int kResProducerRegs = 32;
constexpr int kResConsumerRegs = 160;
static_assert(3 * 128 * kResConsumerRegs + 128 * kResProducerRegs <= 65536, "the SM's register file");
static_assert(kThreads + 32 * (1 + kSplitWarps) == kResThreads, "the producer warpgroup");
constexpr int kResTaps = 2;  // taps of a weight block: a window of the three
// The last partial wave is split by K where an item has this many chunks
// or more: at 16 a split part's fixup cost more than the wave it evened
// out (PERF.md).
constexpr int kResSplitMinChunks = 32;

// A slot: the box's two tf32 planes and its chunk's weight blocks of two
// taps: 20,480 bytes at NT = 64 (11 slots), 28,672 at 128 (8); as many
// slots as the shared memory holds beside the barriers and the split's word.
__host__ __device__ constexpr size_t resample_slot_bytes(int nt) {
  return align1024(2 * align1024(size_t(kTileRows) * 4 * kChunk) + weight_block_bytes(nt, kResTaps));
}
__host__ __device__ constexpr int resample_stages(int nt) {
  return static_cast<int>((kSmemMax - 1024 - 16) / (resample_slot_bytes(nt) + 24));
}
template <int NT>
using ResRing = StageRing<NT, resample_stages(NT), 1, resample_slot_bytes(NT), true>;

// Shared memory of a launch (mirrors ops/_build.resample_smem_bytes): 1,024
// bytes to align the ring to the swizzle's period, the ring, each slot's
// full, empty and abox barriers, and 16 bytes for the word that tells a
// split tile's consumers whether they finish it.
__host__ __device__ constexpr size_t resample_smem_bytes(int nt) {
  return 1024 + size_t(resample_stages(nt)) * (resample_slot_bytes(nt) + 24) + 16;
}
static_assert(resample_smem_bytes(64) <= kSmemMax && resample_smem_bytes(128) <= kSmemMax, "the ring fits");

// One launch's plan as ops/_build.plan_resample makes it (the ctypes
// structure _build.ResampleLaunch mirrors it field for field): the launch
// recomputes every field but the pointers and byte counts from the first
// six and refuses a plan that differs, or a workspace or counters too
// small for its split.
struct ResampleLaunch {
  int B, T, C, up;     // x [B, T, C]; Upsample1d (1) or Downsample1d (0)
  int n_tile;          // 64 or 128 output channels
  int num_sms;         // the device's SMs
  int samples;         // whole samples a tile
  int cluster;         // CTAs of a cluster
  int items, stages;   // cluster items, and ring stages of an item's K
  int ctas;            // persistent CTAs
  int smem_bytes;      // resample_smem_bytes
  int tail, tail_clusters, max_parts;  // the split tail
  float* work;         // the split tiles' workspace, work_bytes of it
  int* counters;       // their arrival counters, n_counters of them, all 0
  long long work_bytes;
  int n_counters;
};

struct ResampleArgs {
  const float* x;      // [B, T_in, C]
  const uint32_t* w0;  // up: the even N tiles' (W3, W1); down: (W0, W2) on x2's last C; laid out, 2 taps
  const uint32_t* w1;  // up: the odd N tiles' (W2, W0), 2 taps; down: W1 on x2's first C, 1 tap
  const float* b;      // [C]
  float* out;          // up: [B, 2 T_in, C]; down: [B, T_in / 2, C]
  int B, T, C;         // T: the GEMM's rows a sample (up: T_in; down: T_in / 2)
  int samples;         // whole samples a tile (samples * T <= 192)
  int cs;              // CTAs of a cluster (1 or 2): row tiles 2q and 2q + 1 share an N tile's weights
  int nh;              // N tiles of C channels; up has 2 nh (even, then odd)
  int items;           // cluster items: row-tile pairs x N tiles
  int nst;             // ring stages of one part of K: C's chunks, one a stage
  int stages;          // ring stages of an item: up nst; down 2 nst (x2's first C, then its last)
  StageSplit split;    // the split tail (stage_split)
  float* work;         // its workspace: slot ((tail item * max_parts + part) * cs + rank), 192 x NT floats
  int* counters;       // its arrival counters: tail item * cs + rank, 0 between launches
};

namespace {

// The chunks of one part of K that an item's stages [k0, k1) cover, for N
// tile nti: up, the even or odd tile's 2 taps; down, with `lo`, the 1-tap
// part on x2's first C (the item's first nst stages), else the 2-tap part
// on its last C.
template <class R, bool kUp>
__device__ __forceinline__ RingPart res_range(const ResampleArgs& a, int nti, bool lo, int k0, int k1) {
  if constexpr (kUp) {
    const bool odd = nti >= a.nh;
    return ring_range<R>(odd ? a.w1 : a.w0, a.C, kResTaps, k0, k1, odd ? nti - a.nh : nti);
  } else {
    const int o = lo ? 0 : a.nst;
    return ring_range<R>(lo ? a.w1 : a.w0, a.C, lo ? 1 : kResTaps, max(k0 - o, 0), lo ? min(k1, a.nst) : k1 - o,
                         nti);
  }
}

// A finished tile's epilogue, on the consumer warpgroups: row tile rt x N
// tile nti of the sums acc, + the bias, 16-byte stores straight to y (a
// quad writes 64 contiguous bytes of a row), with the streaming hint.
template <int NT, bool kUp>
__device__ __forceinline__ void res_store(const ResampleArgs& a, const float (&acc)[NT / 2], int rt, int nti,
                                          unsigned tid) {
  const int b0 = rt * a.samples;
  const int ns = max(0, min(a.samples, a.B - b0));
  const size_t row0 = static_cast<size_t>(b0) * a.T;
  const int half = kUp && nti >= a.nh ? 1 : 0;  // up: y2's last C (odd outputs)
  const int n0 = (nti - half * a.nh) * NT;      // the tile's first channel of its half
  const int ncols = min(NT, a.C - n0);
  const size_t ld = kUp ? 2 * static_cast<size_t>(a.C) : a.C;
  float* out = a.out + half * a.C + n0;
  const int q = tid & 3;
  const TileRows tr = tile_rows<3, 3>(a.samples, ns, a.T, tid);
#pragma unroll
  for (int j = 0; j < NT / 8; j += 2) {
    const int c4 = quad_col(j, q);
    float4 bias = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c4 < ncols) bias = __ldg(reinterpret_cast<const float4*>(a.b + n0 + c4));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float4 o = quad_pairs(make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]),
                            make_float2(acc[4 * j + 4 + 2 * i], acc[4 * j + 5 + 2 * i]), q);
      if (!tr.live[i] || c4 >= ncols) continue;
      o.x += bias.x, o.y += bias.y, o.z += bias.z, o.w += bias.w;
      __stcs(reinterpret_cast<float4*>(out + (row0 + tr.r[i]) * ld + c4), o);
    }
  }
  __syncwarp();  // the warp converges before the next tile's wgmmas
}

// One part of a tile on the consumer warpgroups (all of it for a whole
// tile): row tile rt (samples [rt S, rt S + ns); none where rt is past the
// last: a cluster's partner that only keeps the ring going) x N tile nti,
// the item's ring stages [p.c0, p.c1). `it` counts the ring's stages as the
// producer does; `flag`: the split tiles' word past the barriers. The
// epilogue runs where the tile is whole, or this part finishes it.
template <int NT, bool kUp>
__device__ __forceinline__ void resample_tile(const ResampleArgs& a, StagePart p, int rt, int nti, const char* ring,
                                              const FwdRing& f, int& it, uint32_t flag) {
  using R = ResRing<NT>;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  {
    const int ns = max(0, min(a.samples, a.B - rt * a.samples));
    TileRows tr = tile_rows<3, 3>(a.samples, ns, a.T);  // bit k: shift k - 1 stays inside the sample
    if constexpr (kUp) {
      tr.klo = nti >= a.nh ? 1 : 0;  // odd tiles: shifts 0, +1; even: -1, 0
    } else {  // x2's first C at shift 0, A's 64 rows by descriptor; then its last C at shifts -1, 0
      ring_consume_ss<R, 1>(0, 64 * static_cast<int>(threadIdx.x >> 7), res_range<R, kUp>(a, nti, true, p.c0, p.c1),
                            ring, f, it, acc);
    }
    ring_consume<R, 3, kResTaps, Split::kPre, true, true>(tr, res_range<R, kUp>(a, nti, false, p.c0, p.c1), ring,
                                                           f.full, f.empty, it, acc, f.peer);
  }
  // the epilogue's indices from the tile's and the thread's, passed through
  // an empty asm: not kept live across the main loop
  unsigned tid = threadIdx.x;
  asm volatile("" : "+r"(rt), "+r"(nti), "+r"(tid), "+r"(p.tag));
  if (parts_of(p.tag) > 1 &&
      !finish_split<NT>(a.work, a.counters, a.split.max_parts, a.cs, p.tag, f.rank, a.B > rt * a.samples, flag, acc))
    return;
  res_store<NT, kUp>(a, acc, rt, nti, tid);
}

// Launched in clusters of a.cs CTAs: cluster q walks its parts (walk_part,
// its range of the split tail's last item first) of items i (row-tile pair
// i / N tiles, N tile i % N tiles), rank r taking row tile cs (i / N
// tiles) + r. mx: the GEMM's rows (x, or x2 for
// down) as ring_map views them, boxes of 192 rows x a slot's channels.
template <int NT, bool kUp>
__global__ void __launch_bounds__(kResThreads, 1)
    resample(const ResampleArgs a, const __grid_constant__ CUtensorMap mx) {
  using R = ResRing<NT>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_u32(smem) % 1024) % 1024;  // the swizzle's period
  FwdRing f;
  f.full = smem_u32(smem + R::kRingBytes);
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
  // the role, warp-uniform as the compiler can see
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int ntiles = kUp ? 2 * a.nh : a.nh;
  int it = 0;
  StagePart p;
  if (warp >= kWarps) {
    regs_dec<kResProducerRegs>();
    for (int n = 0; walk_part(a.items, a.stages, a.split, a.cs, true, n, p); ++n) {
      const int rt = p.item / ntiles * a.cs + static_cast<int>(f.rank), nti = p.item % ntiles;
      const int row0 = rt * a.samples * a.T;
      if (warp == kWarps) {
        if constexpr (!kUp)
          ring_feed<R>(res_range<R, kUp>(a, nti, true, p.c0, p.c1), [&](char* st, int c, uint32_t bar) {
            tma_load_2d(st, &mx, c, row0, bar);
          }, smem, f, it);
        const int c0 = kUp ? 0 : a.C;  // down's 2-tap part reads x2's last C
        ring_feed<R>(res_range<R, kUp>(a, nti, false, p.c0, p.c1), [&](char* st, int c, uint32_t bar) {
          tma_load_2d(st, &mx, c0 + c, row0, bar);
        }, smem, f, it);
      } else {
        const int t = threadIdx.x - kThreads - 32;
        if constexpr (!kUp) ring_split<R>(res_range<R, kUp>(a, nti, true, p.c0, p.c1), smem, f, t, it);
        ring_split<R>(res_range<R, kUp>(a, nti, false, p.c0, p.c1), smem, f, t, it);
      }
    }
  } else {
    regs_inc<kResConsumerRegs>();
    for (int n = 0; walk_part(a.items, a.stages, a.split, a.cs, true, n, p); ++n)
      resample_tile<NT, kUp>(a, p, p.item / ntiles * a.cs + static_cast<int>(f.rank), p.item % ntiles, smem, f, it,
                             f.abox + 8 * R::kStages);
  }
  cluster_sync();  // no CTA leaves while its peer may still copy or arrive into it
}

template <int NT, bool kUp>
cudaError_t launch_resample(const ResampleArgs& a, int ctas, const CUtensorMap& mx, cudaStream_t stream) {
  static unsigned long long smem_set = 0;  // devices where the attribute is set
  const auto k = resample<NT, kUp>;
  CINDM_TRY(allow_smem_once(k, smem_set));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = resample_smem_bytes(NT);
  cfg.stream = stream;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = a.cs;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  void* params[] = {const_cast<ResampleArgs*>(&a), const_cast<CUtensorMap*>(&mx)};
  CINDM_TRY(cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(k), params));
  return cudaGetLastError();
}

}  // namespace
}  // namespace cindm

// Upsample1d (s.up = 1) or Downsample1d (s.up = 0) of x [B, T, C] into out
// ([B, 2T, C], or [B, T/2, C]), on the weights that stage_weights laid out
// for N tiles of s.n_tile (w0, w1: see ResampleArgs) and bias b [C], with
// the plan `s` (ops/_build.plan_resample). Refuses (cudaErrorInvalidValue)
// what the tiling does not take (C not a multiple of 4, an odd T for down,
// a sample longer than a tile, a pointer off a 16-byte boundary), a plan
// whose samples, cluster, items, stages, CTAs, shared memory or split
// differ from the count made here, and a workspace or counters too small.
extern "C" int cindm_resample(const float* x, const void* w0, const void* w1, const float* b, float* out,
                              const cindm::ResampleLaunch* plan, void* stream) {
  using namespace cindm;
  const auto aligned = [](const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (plan == nullptr) return cudaErrorInvalidValue;
  const ResampleLaunch& s = *plan;
  const int B = s.B, T = s.T, C = s.C, up = s.up, nt = s.n_tile;
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || (!up && T % 2 != 0) || (nt != 64 && nt != 128) ||
      !aligned(x) || !aligned(w0) || !aligned(w1) || !aligned(b) || !aligned(out))
    return cudaErrorInvalidValue;
  ResampleArgs a{};
  a.x = x;
  a.w0 = static_cast<const uint32_t*>(w0);
  a.w1 = static_cast<const uint32_t*>(w1);
  a.b = b;
  a.out = out;
  a.B = B;
  a.T = up ? T : T / 2;
  a.C = C;
  if (a.T > kTileRows || static_cast<long long>(B) * a.T * 2 * C >= (1ll << 31)) return cudaErrorInvalidValue;
  a.samples = kTileRows / a.T;
  const int row_tiles = (B + a.samples - 1) / a.samples;
  a.cs = row_tiles > 1 ? 2 : 1;
  a.nh = (C + nt - 1) / nt;
  a.items = (row_tiles + a.cs - 1) / a.cs * (up ? 2 * a.nh : a.nh);
  a.nst = (C + kChunk - 1) / kChunk;
  a.stages = up ? a.nst : 2 * a.nst;
  int ctas = 0;
  CINDM_TRY(walk_plan(a.items, a.stages, a.cs, s.num_sms, a.stages >= kResSplitMinChunks, &a.split, &ctas));
  if (s.samples != a.samples || s.cluster != a.cs || s.items != a.items || s.stages != a.stages || s.ctas != ctas ||
      static_cast<size_t>(s.smem_bytes) != resample_smem_bytes(nt) || s.tail != a.split.tail ||
      s.tail_clusters != a.split.tail_clusters || s.max_parts != a.split.max_parts)
    return cudaErrorInvalidValue;
  if (a.split.tail > 0 &&
      (s.work == nullptr || s.counters == nullptr || reinterpret_cast<uintptr_t>(s.work) % 16 != 0 ||
       s.work_bytes < static_cast<long long>(stage_work_bytes(a.split, a.cs, nt)) ||
       s.n_counters < a.split.tail * a.cs))
    return cudaErrorInvalidValue;
  a.work = s.work;
  a.counters = s.counters;
  CUtensorMap mx;  // the GEMM's rows: x [B T, C], or x2 [B T / 2, 2 C]
  CINDM_TRY(ring_map(&mx, x, B * a.T, up ? C : 2 * C, ResRing<64>::kPitch));
  static_assert(ResRing<128>::kPitch == ResRing<64>::kPitch, "one pitch at either N tile");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up) return nt == 64 ? launch_resample<64, true>(a, ctas, mx, st) : launch_resample<128, true>(a, ctas, mx, st);
  return nt == 64 ? launch_resample<64, false>(a, ctas, mx, st) : launch_resample<128, false>(a, ctas, mx, st);
}

extern "C" int cindm_resample_launch_size() { return static_cast<int>(sizeof(cindm::ResampleLaunch)); }
