// Backward of the fused ResidualTemporalBlock and of the head Conv1d +
// GroupNorm + Mish for Hopper (sm_90a), from what their forwards saved.
//
// Replaces the TPU package's cindm_tpu/ops/fused_rtb.py:_fused_rtb_cv_bwd
// (the custom VJP's backward, which recomputes the block under jax.vjp) and
// returns the same cotangents. The kernels, what bounds them (operations:
// twice the forward's multiply-adds, 3xTF32 on the tensor cores) and their
// design are in conv_backward.cuh. One call launches, in order:
// stage_weights_t, gn_mish_bwd, dgrad_gn_stage (the block only),
// dgrad_x_stage (when dx is wanted), wgrad and grad_reduce (when the weight
// gradients are wanted: dw1 not null; grad_reduce's items as
// ops/_build.plan_reduce cut them; with dw1 null every weight, bias and
// GroupNorm gradient pointer is null and only dx and dtemb are computed;
// the GroupNorm kernels then write no operand layouts).
#include "conv_backward.cuh"

// Mirrors ops/_build.BackwardArgs field for field: pointers, then 64-bit
// sizes, then ints. (Outside the anonymous namespace: the extern "C"
// entries take it, and must keep external linkage.)
struct BlockBwdArgs {
  // saved by the forward, and the cotangent g of its output
  const float* x;      // [B, T, C]
  const float* w1;     // [K, C, O]
  const float* gs1;
  const float* gb1;
  const float* w2;     // [K, O, O]; null for the head (one stage)
  const float* gs2;
  const float* gb2;
  const float* wres;   // [C, O], or null (identity residual)
  const float* g;      // [B, T, O]
  const float* h;      // [B, T, O], the second conv's input
  const float* z1;     // [B, T, O]
  const float* mean1;  // [B, G]
  const float* rstd1;
  const float* z2;
  const float* mean2;
  const float* rstd2;
  // gradients; dx and dtemb may be null (not wanted)
  float* dx;
  float* dtemb;
  float* dw1;
  float* db1;
  float* dgs1;
  float* dgb1;
  float* dw2;
  float* db2;
  float* dgs2;
  float* dgb2;
  float* dwres;
  float* dbres;
  // scratch
  float* dz1;
  float* dz2;
  float* dz1w;       // dz1, dz2 and g in wgrad's operand layout (wop_bytes each)
  float* dz2w;
  float* gw;
  uint32_t* wstage;  // weights laid out by stage_weights_t
  float* wpart;      // the partials of the gradients whose rows wgrad splits, job after job
  float* colpart;    // column partials: 4 (3 for the head) x gn_tiles x O, then 3 x row tiles x cs_d2 x O
  long long wstage_bytes, wpart_bytes, colpart_bytes, wop_bytes;
  int B, T, C, O, G, samples;
  int gn_samples, gn_tiles;  // gn_mish_bwd's row tiles: gn_samples whole samples each
  int nt_gn, smem_gn, nt_d2, smem_d2, nt_d1, smem_d1;
  int cs_d2, cs_d1;  // the dgrads' cluster sizes: the split of K
  int wg_grid;  // wgrad's persistent grid: at most one block an SM
  int splits[cindm::kWgJobs], sps[cindm::kWgJobs];  // per job: row splits, ring stages a split
  // grad_reduce's plan (ops/_build.plan_reduce): per reduce job, in launch
  // order, the columns of an item; the items; the CTAs that walk them
  int rd_width[cindm::kReduceJobs];
  int rd_items, rd_grid;
};

namespace {

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// gn_mish_bwd: a grid of row tiles x N tiles, a warp kGnWarpPairs (sample,
// group) pairs of its tile
template <int V>
cudaError_t launch_gn(const float* d, const cindm::GnBwd& a, int tiles, int samples, int nt, size_t bytes,
                      cudaStream_t s) {
  CINDM_TRY(allow_smem(cindm::gn_mish_bwd<V>, bytes));
  const int pairs = samples * (nt / (a.O / a.G));
  const int threads = 32 * ((pairs + cindm::kGnWarpPairs - 1) / cindm::kGnWarpPairs);
  cindm::gn_mish_bwd<V><<<dim3(tiles, (a.O + nt - 1) / nt), threads, bytes, s>>>(d, a, samples, nt);
  return cudaGetLastError();
}

// A dgrad launch: a grid of clusters of cs CTAs along x (`at` holds the attribute).
cudaLaunchConfig_t cluster_config(dim3 grid, int cs, size_t bytes, cudaStream_t s, cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(cindm::kRingThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = cs;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel k, dim3 grid, int cs, size_t bytes, cudaStream_t s, const Args&... args) {
  CINDM_TRY(allow_smem(k, bytes));
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = cluster_config(grid, cs, bytes, s, &at);
  void* params[] = {const_cast<void*>(static_cast<const void*>(&args))...};
  CINDM_TRY(cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(k), params));
  return cudaGetLastError();
}

// wgrad's view of an activation act [R, C]: boxes of kWgARows rows x
// kWgABox channels (128 bytes) in the 128-byte swizzle; what a box reaches
// past the tensor reads zeros.
cudaError_t act_map(CUtensorMap* m, const float* act, int R, int C) {
  cindm::EncodeTiled fn;
  CINDM_TRY(cindm::encode_tiled(&fn));
  const cuuint64_t dims[2] = {cuuint64_t(C), cuuint64_t(R)};
  const cuuint64_t strides[1] = {cuuint64_t(C) * 4};
  const cuuint32_t box[2] = {cindm::kWgABox, cindm::kWgARows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(act), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// grad_reduce's view of a job for TMA: src as [slices][n], boxes of
// reduce_box(width) columns x reduce_run(slices, width) slices; what a box
// reaches past the tensor reads zeros.
cudaError_t reduce_map(CUtensorMap* m, const cindm::ReduceJob& jb) {
  cindm::EncodeTiled fn;
  CINDM_TRY(cindm::encode_tiled(&fn));
  const cuuint64_t dims[2] = {cuuint64_t(jb.n), cuuint64_t(jb.slices)};
  const cuuint64_t strides[1] = {cuuint64_t(jb.n) * 4};
  const cuuint32_t box[2] = {cuuint32_t(cindm::reduce_box(jb.width)),
                             cuuint32_t(cindm::reduce_run(jb.slices, jb.width))};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(jb.src), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// grad_reduce on a plan's items. Refuses the plan unless each job's width
// is what reduce_width gives for the launch's jobs, the jobs' items follow
// one another from 0 to nitems, the grid has 1 to nitems CTAs, and every
// source and destination starts on 16 bytes and every slice row is whole
// 16-byte units (n a multiple of 4): TMA and the float4 stores need them.
// The jobs' tensor maps are encoded here (after the caller's first launch
// on this thread: the encoder needs the context current).
cudaError_t launch_reduce(const cindm::ReduceArgs& a, int grid, cudaStream_t s) {
  using namespace cindm;
  if (a.njobs < 1 || a.njobs > kReduceJobs) return cudaErrorInvalidValue;
  long long total = 0;
  for (int j = 0; j < a.njobs; ++j) total += 4LL * a.job[j].n * a.job[j].slices;
  int items = 0;
  ReduceMaps maps{};
  for (int j = 0; j < a.njobs; ++j) {
    const ReduceJob& jb = a.job[j];
    if (jb.n <= 0 || jb.n % 4 != 0 || jb.slices <= 0 || jb.src == nullptr || jb.dst == nullptr ||
        reinterpret_cast<uintptr_t>(jb.src) % 16 != 0 || reinterpret_cast<uintptr_t>(jb.dst) % 16 != 0 ||
        jb.width != reduce_width(total, jb.n, jb.slices) || jb.item0 != items)
      return cudaErrorInvalidValue;
    items += reduce_items(jb.n, jb.width);
    CINDM_TRY(reduce_map(&maps.map[j], jb));
  }
  if (items != a.nitems || grid < 1 || grid > items) return cudaErrorInvalidValue;
  CINDM_TRY(allow_smem(grad_reduce, reduce_smem_bytes()));
  grad_reduce<<<grid, kReduceThreads, reduce_smem_bytes(), s>>>(a, maps);
  return cudaGetLastError();
}

bool cluster_size_ok(int cs) { return cs >= 1 && cs <= cindm::kDgClusterMax; }

size_t staged_t(int nt, int Cs, int Os, int K) { return cindm::staged_weight_bytes(nt, Cs, Os, K); }

// An N tile of nt channels holds whole groups of O / G.
bool whole_groups(int O, int G, int nt) { return O <= nt || nt % (O / G) == 0; }

// gn_mish_bwd's tile: nt channels of whole groups, a multiple of 8 (whole
// n8 blocks of the operand layout) unless one tile spans O; at most
// kGnPairs pairs; a group's load units fit one warp's row (gn_lane_floats).
bool gn_tile_ok(const BlockBwdArgs& a) {
  const int og = a.O / a.G;
  if (a.nt_gn <= 0 || a.nt_gn > a.O || a.nt_gn % og != 0 || (a.nt_gn % 8 != 0 && a.nt_gn != a.O))
    return false;
  const int pairs = a.gn_samples * (a.nt_gn / og);
  return a.gn_samples >= 1 && pairs <= cindm::kGnPairs && cindm::gn_lane_floats(og) > 0 &&
         a.gn_tiles == (a.B + a.gn_samples - 1) / a.gn_samples;
}

int block_backward(const BlockBwdArgs& a, bool rtb, void* stream) {
  using namespace cindm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_dx = a.dx != nullptr;
  const bool want_w = a.dw1 != nullptr;
  const bool proj = rtb && a.wres != nullptr;
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.O <= 0 || a.G <= 0 || a.O % a.G != 0 ||
      a.C % 4 != 0 || a.O % 4 != 0 || a.samples != kTileRows / a.T || a.samples <= 0 ||
      !gn_tile_ok(a) || a.nt_d1 != 64 || !cluster_size_ok(a.cs_d1) || rtb != (a.w2 != nullptr) ||
      (rtb && ((a.nt_d2 != 64 && a.nt_d2 != 128) || !whole_groups(a.O, a.G, a.nt_d2) ||
               !cluster_size_ok(a.cs_d2) || (!proj && a.C != a.O))))
    return cudaErrorInvalidValue;
  if (!want_w && (a.db1 || a.dgs1 || a.dgb1 || a.dw2 || a.db2 || a.dgs2 || a.dgb2 || a.dwres ||
                  a.dbres || !(want_dx || a.dtemb)))
    return cudaErrorInvalidValue;  // all weight gradients or none, and something to compute
  const int row_tiles = (a.B + a.samples - 1) / a.samples;
  const int K = kConvK;

  // the plan's shared memory and scratch, as the launches count them;
  // gn_mish_bwd stages dz (and g on a projection block) for wgrad's operand
  const size_t smem_gn = gn_bwd_smem_bytes(a.nt_gn, a.gn_samples, a.T, want_w ? (proj ? 2 : 1) : 0);
  const size_t smem_d2 = rtb ? dgrad_gn_smem_bytes(a.nt_d2, a.samples, a.cs_d2) : 0;
  const size_t smem_d1 = dgrad_x_smem_bytes();
  if (smem_gn != static_cast<size_t>(a.smem_gn) || smem_gn > kSmemMax ||
      (rtb && (smem_d2 != static_cast<size_t>(a.smem_d2) || smem_d2 > kSmemMax)) ||
      smem_d1 != static_cast<size_t>(a.smem_d1) || smem_d1 > kSmemMax)
    return cudaErrorInvalidValue;
  // column partials: 4 kinds (dgs, dgb, db, dbres) of the last GroupNorm by
  // gn_mish_bwd's row tile, then 3 of the first (dgrad_gn_stage's) by row
  // tile and rank
  const size_t pk = size_t(a.gn_tiles) * a.O;
  const size_t pk1 = size_t(row_tiles) * a.O * (rtb ? a.cs_d2 : 0);
  const size_t n_w2 = rtb ? staged_t(a.nt_d2, a.O, a.O, K) : 0;
  const size_t n_w1 = want_dx ? staged_t(a.nt_d1, a.O, a.C, K) : 0;
  const size_t n_wr = want_dx && proj ? staged_t(a.nt_d1, a.O, a.C, 1) : 0;
  if (static_cast<long long>(n_w2 + n_w1 + n_wr) > a.wstage_bytes ||
      static_cast<long long>(((rtb ? 4 : 3) * pk + 3 * pk1) * 4) > a.colpart_bytes)
    return cudaErrorInvalidValue;

  // wgrad's jobs, in the order of the plan's splits: dw1, dw2, dwres; an
  // unsplit job writes its gradient, a split one its partials
  WgradArgs wa{};
  wa.R = a.B * a.T; wa.T = a.T; wa.Od = a.O; wa.rows = wgrad_stage_rows(a.T);
  struct { const float* act; const float* op; int Ca, taps; float* dst; } jobs[kWgJobs] = {
      {a.x, a.dz1w, a.C, K, a.dw1},
      {rtb ? a.h : nullptr, a.dz2w, a.O, K, a.dw2},
      {proj ? a.x : nullptr, a.gw, a.C, 1, a.dwres},
  };
  const int njobs = want_w ? (rtb ? (proj ? 3 : 2) : 1) : 0;
  const int stages = (wa.R + wa.rows - 1) / wa.rows;
  if (want_w && static_cast<long long>(wgrad_operand_words(wa.R, a.O, a.T) * 4) > a.wop_bytes)
    return cudaErrorInvalidValue;
  size_t wpart_off = 0;
  int items = 0;
  ReduceArgs ra{};
  for (int j = 0; j < njobs; ++j) {
    WgradJob& jb = wa.job[j];
    jb.act = jobs[j].act; jb.op = jobs[j].op; jb.Ca = jobs[j].Ca;
    jb.taps = jobs[j].taps; jb.splits = a.splits[j]; jb.sps = a.sps[j];
    if (jb.splits <= 0 || jb.sps <= 0 || jb.splits * jb.sps < stages ||
        (jb.splits - 1) * jb.sps >= stages || jobs[j].dst == nullptr || jb.op == nullptr)
      return cudaErrorInvalidValue;
    jb.ctiles = (jb.Ca + kWgTile - 1) / kWgTile;
    jb.otiles = (a.O + kWgTile - 1) / kWgTile;
    jb.item0 = items;
    const int n = jb.taps * jb.Ca * a.O;
    if (jb.splits == 1) {
      jb.out = jobs[j].dst;
    } else {
      jb.out = a.wpart + wpart_off;
      ra.job[ra.njobs++] = ReduceJob{jb.out, jobs[j].dst, n, jb.splits, 0, 0};
      wpart_off += size_t(jb.splits) * n;
    }
    items += jb.ctiles * jb.otiles * jb.splits;
  }
  wa.njobs = njobs;
  wa.nitems = items;
  if (static_cast<long long>(wpart_off * 4) > a.wpart_bytes || (want_w && a.wg_grid <= 0))
    return cudaErrorInvalidValue;
  // the column sums: [dgs, dgb, db, dbres] of the last GroupNorm over
  // gn_mish_bwd's row tiles, then [dgs, dgb, db] of the first over row tiles
  // x ranks
  float* gs_last = rtb ? a.dgs2 : a.dgs1;
  float* gb_last = rtb ? a.dgb2 : a.dgb1;
  float* b_last = rtb ? a.db2 : a.db1;
  float* dsts[kColParts] = {gs_last, gb_last, b_last, proj ? a.dbres : nullptr,
                            a.dgs1, a.dgb1, a.db1};
  for (int q = 0; q < (want_w ? (rtb ? kColParts : 3) : 0); ++q)
    if (dsts[q] != nullptr)
      ra.job[ra.njobs++] = q < 4 ? ReduceJob{a.colpart + q * pk, dsts[q], a.O, a.gn_tiles, 0, 0}
                                 : ReduceJob{a.colpart + 4 * pk + (q - 4) * pk1, dsts[q], a.O,
                                             row_tiles * a.cs_d2, 0, 0};
  // the plan's items: its widths, each job's items after the last one's
  for (int j = 0; j < ra.njobs; ++j) {
    ra.job[j].width = a.rd_width[j];
    ra.job[j].item0 = ra.nitems;
    if (ra.job[j].width <= 0) return cudaErrorInvalidValue;
    ra.nitems += reduce_items(ra.job[j].n, ra.job[j].width);
  }
  if (ra.nitems != a.rd_items) return cudaErrorInvalidValue;

  // 1. the weights of the dgrad stages, flipped and transposed
  char* ws = reinterpret_cast<char*>(a.wstage);
  LayoutJob sj[kLayoutJobs] = {};
  int nsj = 0;
  auto add_t = [&](const float* w, size_t off, int k, int cs, int os, int nt) {
    sj[nsj++] = LayoutJob{w, reinterpret_cast<uint32_t*>(ws + off), k, cs, os, nt, 0};
  };
  if (rtb) add_t(a.w2, 0, K, a.O, a.O, a.nt_d2);
  if (want_dx) add_t(a.w1, n_w2, K, a.O, a.C, a.nt_d1);
  if (n_wr) add_t(a.wres, n_w2 + n_w1, 1, a.O, a.C, a.nt_d1);
  const int sblocks = layout_grid(sj, nsj);  // absent jobs start past the grid
  if (nsj > 0) {
    stage_weights_t<<<sblocks, kLayoutThreads, 0, s>>>(sj[0], sj[1], sj[2]);
    CINDM_TRY(cudaGetLastError());
  }

  // 2. the last GroupNorm + Mish backward: g -> dz2 (the head: -> dz1)
  GnBwd gn{};
  gn.z = rtb ? a.z2 : a.z1; gn.mean = rtb ? a.mean2 : a.mean1; gn.rstd = rtb ? a.rstd2 : a.rstd1;
  gn.gs = rtb ? a.gs2 : a.gs1; gn.gb = rtb ? a.gb2 : a.gb1;
  gn.dz = rtb ? a.dz2 : a.dz1;
  gn.part = a.colpart; gn.dtemb = nullptr; gn.colsum = proj ? 1 : 0;
  gn.dzw = want_w ? (rtb ? a.dz2w : a.dz1w) : nullptr;
  gn.gw = want_w && proj ? a.gw : nullptr;
  gn.B = a.B; gn.T = a.T; gn.O = a.O; gn.G = a.G; gn.row_tiles = a.gn_tiles;
  const int v = gn_lane_floats(a.O / a.G);
  CINDM_TRY(v == 1   ? launch_gn<1>(a.g, gn, a.gn_tiles, a.gn_samples, a.nt_gn, smem_gn, s)
            : v == 2 ? launch_gn<2>(a.g, gn, a.gn_tiles, a.gn_samples, a.nt_gn, smem_gn, s)
                     : launch_gn<4>(a.g, gn, a.gn_tiles, a.gn_samples, a.nt_gn, smem_gn, s));

  // 3. the block: dh = conv_T(dz2, w2), dtemb, the first GroupNorm's backward -> dz1.
  // The dgrads' tensor maps are encoded here, after this thread's first
  // launches: the encoder needs the context current, which a thread that has
  // launched nothing yet (autograd's worker, say) may not have.
  const bool t3 = a.T <= 3;
  if (rtb) {
    DgradArgs d{};
    d.dz = a.dz2; d.ws = reinterpret_cast<const uint32_t*>(ws);
    d.B = a.B; d.T = a.T; d.Cin = a.O; d.Cout = a.O; d.samples = a.samples; d.cs = a.cs_d2;
    GnBwd g1 = gn;
    g1.z = a.z1; g1.mean = a.mean1; g1.rstd = a.rstd1; g1.gs = a.gs1; g1.gb = a.gb1;
    g1.dz = a.dz1; g1.part = a.colpart + 4 * pk; g1.dtemb = a.dtemb; g1.colsum = 0;
    g1.dzw = want_w ? a.dz1w : nullptr; g1.gw = nullptr; g1.row_tiles = row_tiles * a.cs_d2;
    CUtensorMap m{};
    CINDM_TRY(cindm::ring_map(&m, a.dz2, a.B * a.T, a.O,
                              a.nt_d2 == 64 ? cindm::StageRing<64>::kPitch : cindm::StageRing<128>::kPitch));
    const dim3 grid(row_tiles * a.cs_d2, (a.O + a.nt_d2 - 1) / a.nt_d2);
    CINDM_TRY(a.nt_d2 == 64
                  ? (t3 ? launch_cluster(dgrad_gn_stage<64, 3>, grid, a.cs_d2, smem_d2, s, d, g1, m)
                        : launch_cluster(dgrad_gn_stage<64, kConvK>, grid, a.cs_d2, smem_d2, s, d, g1, m))
                  : (t3 ? launch_cluster(dgrad_gn_stage<128, 3>, grid, a.cs_d2, smem_d2, s, d, g1, m)
                        : launch_cluster(dgrad_gn_stage<128, kConvK>, grid, a.cs_d2, smem_d2, s, d, g1, m)));
  }

  // 4. dx = conv_T(dz1, w1) + the residual's cotangent
  if (want_dx) {
    DgradArgs d{};
    d.dz = a.dz1; d.ws = reinterpret_cast<const uint32_t*>(ws + n_w2);
    d.g = rtb ? a.g : nullptr;
    d.wress = n_wr ? reinterpret_cast<const uint32_t*>(ws + n_w2 + n_w1) : nullptr;
    d.out = a.dx;
    d.B = a.B; d.T = a.T; d.Cin = a.O; d.Cout = a.C; d.Cres = a.O; d.samples = a.samples;
    d.cs = a.cs_d1;
    CUtensorMap mdz{}, mg{};
    CINDM_TRY(cindm::ring_map(&mdz, a.dz1, a.B * a.T, a.O, cindm::StageRing<64>::kPitch));
    if (d.wress != nullptr) CINDM_TRY(cindm::ring_map(&mg, a.g, a.B * a.T, a.O, cindm::StageRing<64>::kPitch));
    const dim3 grid(row_tiles * a.cs_d1, (a.C + 63) / 64);
    CINDM_TRY(t3 ? launch_cluster(dgrad_x_stage<64, 3>, grid, a.cs_d1, smem_d1, s, d, mdz, mg)
                 : launch_cluster(dgrad_x_stage<64, kConvK>, grid, a.cs_d1, smem_d1, s, d, mdz, mg));
  }

  if (!want_w) return cudaSuccess;

  // 5. the weight gradients, or the partials of the split ones.
  const auto kernel = a.T == 3 ? wgrad<true> : wgrad<false>;
  CINDM_TRY(allow_smem(kernel, wgrad_smem_bytes()));
  CUtensorMap maps[kWgJobs] = {};
  for (int j = 0; j < njobs; ++j) CINDM_TRY(act_map(&maps[j], wa.job[j].act, wa.R, wa.job[j].Ca));
  kernel<<<items < a.wg_grid ? items : a.wg_grid, kWgThreads, wgrad_smem_bytes(), s>>>(
      wa, maps[0], maps[1], maps[2]);
  CINDM_TRY(cudaGetLastError());

  // 6. the split gradients and the column sums from their partials
  return launch_reduce(ra, a.rd_grid, s);
}

}  // namespace

extern "C" int cindm_block_backward_args_size() { return static_cast<int>(sizeof(BlockBwdArgs)); }

// How many clusters of cs CTAs of a dgrad kernel (one CTA an SM: its shared
// memory) the current device runs at once, into *n: the planner's limit.
extern "C" int cindm_dgrad_cluster_limit(int cs, int* n) {
  const auto k = cindm::dgrad_gn_stage<64, cindm::kConvK>;
  const size_t bytes = cindm::dgrad_x_smem_bytes();
  CINDM_TRY(allow_smem(k, bytes));
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cs), cs, bytes, nullptr, &at);
  return cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(k), &cfg);
}

extern "C" int cindm_reduce_args_size() { return static_cast<int>(sizeof(cindm::ReduceArgs)); }

// grad_reduce alone: the jobs, widths and items of ops/_build.plan_reduce
// on `grid` CTAs (the same kernel and checks as the backward's launch).
extern "C" int cindm_grad_reduce(const cindm::ReduceArgs* a, int grid, void* stream) {
  return launch_reduce(*a, grid, static_cast<cudaStream_t>(stream));
}

// stage_weights_t alone (the same kernel as the backward's first launch):
// njobs (1 to 3) weight tensors w[i] [K][O][C] (dims[4 i .. 4 i + 3] = K,
// C, O, nt) laid out into out[i] (staged_weight_bytes(nt, C, O, K) bytes
// each) as the dgrads read a conv from C to O, flipped in time.
extern "C" int cindm_stage_weights_t(const float* const* w, void* const* out, const int* dims, int njobs,
                                     void* stream) {
  if (w == nullptr || out == nullptr || dims == nullptr || njobs < 1 || njobs > cindm::kLayoutJobs)
    return cudaErrorInvalidValue;
  cindm::LayoutJob jobs[cindm::kLayoutJobs] = {};
  for (int i = 0; i < njobs; ++i) {
    const cindm::LayoutJob j{w[i], static_cast<uint32_t*>(out[i]), dims[4 * i], dims[4 * i + 1],
                             dims[4 * i + 2], dims[4 * i + 3], 0};
    if (j.w == nullptr || j.out == nullptr || reinterpret_cast<uintptr_t>(j.w) % 16 != 0 || j.K <= 0 ||
        j.C <= 0 || j.C % 4 != 0 || j.O <= 0 || (j.nt != 64 && j.nt != 128))
      return cudaErrorInvalidValue;
    jobs[i] = j;
  }
  const int blocks = cindm::layout_grid(jobs, njobs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cindm::stage_weights_t<<<blocks, cindm::kLayoutThreads, 0, s>>>(jobs[0], jobs[1], jobs[2]);
  return cudaGetLastError();
}

extern "C" int cindm_fused_rtb_backward(const BlockBwdArgs* a, void* stream) {
  return block_backward(*a, true, stream);
}

extern "C" int cindm_fused_conv1d_gn_mish_backward(const BlockBwdArgs* a, void* stream) {
  return block_backward(*a, false, stream);
}
