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
// gradients are wanted: dw1 not null; with dw1 null every weight, bias and
// GroupNorm gradient pointer is null and only dx and dtemb are computed).
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
  uint32_t* wstage;  // weights laid out by stage_weights_t
  float* wpart;      // wgrad's split partials, job after job
  float* colpart;    // kColParts x row tiles x O column partials
  long long wstage_bytes, wpart_bytes, colpart_bytes;
  int B, T, C, O, G, samples;
  int nt_gn, smem_gn, nt_d2, smem_d2, nt_d1, smem_d1;
  int splits[cindm::kWgJobs], cps[cindm::kWgJobs];
};

namespace {

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define CINDM_TRY(expr)                       \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

template <int NT>
cudaError_t launch_gn(const float* d, const cindm::GnBwd& a, int row_tiles, size_t bytes,
                      cudaStream_t s) {
  CINDM_TRY(allow_smem(cindm::gn_mish_bwd<NT>, bytes));
  cindm::gn_mish_bwd<NT><<<dim3(row_tiles, (a.O + NT - 1) / NT), cindm::kThreads, bytes, s>>>(d, a);
  return cudaGetLastError();
}

template <int NT, int KW>
cudaError_t launch_dgrad_gn(const cindm::DgradArgs& a, const cindm::GnBwd& gn, int row_tiles,
                            size_t bytes, cudaStream_t s) {
  CINDM_TRY(allow_smem(cindm::dgrad_gn_stage<NT, KW>, bytes));
  cindm::dgrad_gn_stage<NT, KW>
      <<<dim3(row_tiles, (a.Cout + NT - 1) / NT), cindm::kThreads, bytes, s>>>(a, gn);
  return cudaGetLastError();
}

template <int NT, int KW>
cudaError_t launch_dgrad_x(const cindm::DgradArgs& a, int row_tiles, size_t bytes, cudaStream_t s) {
  CINDM_TRY(allow_smem(cindm::dgrad_x_stage<NT, KW>, bytes));
  cindm::dgrad_x_stage<NT, KW>
      <<<dim3(row_tiles, (a.Cout + NT - 1) / NT), cindm::kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

size_t staged_t(int nt, int Cs, int Os, int K) { return cindm::staged_weight_bytes(nt, Cs, Os, K); }

int gpt_of(int O, int G, int nt) { return (O < nt ? O : nt) / (O / G); }

// An N tile of nt channels holds whole groups of O / G.
bool whole_groups(int O, int G, int nt) { return O <= nt || nt % (O / G) == 0; }

int block_backward(const BlockBwdArgs& a, bool rtb, void* stream) {
  using namespace cindm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_dx = a.dx != nullptr;
  const bool want_w = a.dw1 != nullptr;
  const bool proj = rtb && a.wres != nullptr;
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.O <= 0 || a.G <= 0 || a.O % a.G != 0 ||
      a.C % 4 != 0 || a.O % 4 != 0 || a.samples != kTileRows / a.T || a.samples <= 0 ||
      (a.nt_gn != 64 && a.nt_gn != 128) || (a.nt_d1 != 64 && a.nt_d1 != 128) ||
      !whole_groups(a.O, a.G, a.nt_gn) || rtb != (a.w2 != nullptr) ||
      (rtb && ((a.nt_d2 != 64 && a.nt_d2 != 128) || !whole_groups(a.O, a.G, a.nt_d2) ||
               (!proj && a.C != a.O))))
    return cudaErrorInvalidValue;
  if (!want_w && (a.db1 || a.dgs1 || a.dgb1 || a.dw2 || a.db2 || a.dgs2 || a.dgb2 || a.dwres ||
                  a.dbres || !(want_dx || a.dtemb)))
    return cudaErrorInvalidValue;  // all weight gradients or none, and something to compute
  const int row_tiles = (a.B + a.samples - 1) / a.samples;
  const int K = kConvK;

  // the plan's shared memory and scratch, as the launches count them
  const size_t smem_gn = gn_bwd_smem_bytes(a.nt_gn, a.samples, gpt_of(a.O, a.G, a.nt_gn), false);
  const size_t smem_d2 = rtb ? gn_bwd_smem_bytes(a.nt_d2, a.samples, gpt_of(a.O, a.G, a.nt_d2), true) : 0;
  const size_t smem_d1 = dgrad_x_smem_bytes(a.nt_d1);
  if (smem_gn != static_cast<size_t>(a.smem_gn) || smem_gn > kSmemMax ||
      (rtb && (smem_d2 != static_cast<size_t>(a.smem_d2) || smem_d2 > kSmemMax)) ||
      smem_d1 != static_cast<size_t>(a.smem_d1))
    return cudaErrorInvalidValue;
  const size_t n_w2 = rtb ? staged_t(a.nt_d2, a.O, a.O, K) : 0;
  const size_t n_w1 = want_dx ? staged_t(a.nt_d1, a.O, a.C, K) : 0;
  const size_t n_wr = want_dx && proj ? staged_t(a.nt_d1, a.O, a.C, 1) : 0;
  if (static_cast<long long>(n_w2 + n_w1 + n_wr) > a.wstage_bytes ||
      static_cast<long long>((rtb ? kColParts : 3) * size_t(row_tiles) * a.O * 4) > a.colpart_bytes)
    return cudaErrorInvalidValue;

  // wgrad's jobs, in the order of the plan's splits: dw1, dw2, dwres
  WgradArgs wa{};
  wa.B = a.B; wa.T = a.T; wa.samples = a.samples;
  struct { const float* act; const float* dz; int Ca, taps; float* dst; } jobs[kWgJobs] = {
      {a.x, a.dz1, a.C, K, a.dw1},
      {rtb ? a.h : nullptr, a.dz2, a.O, K, a.dw2},
      {proj ? a.x : nullptr, a.g, a.C, 1, a.dwres},
  };
  const int njobs = want_w ? (rtb ? (proj ? 3 : 2) : 1) : 0;
  size_t wpart_off = 0;
  int blocks = 0;
  ReduceArgs ra{};
  for (int j = 0; j < njobs; ++j) {
    WgradJob& jb = wa.job[j];
    jb.act = jobs[j].act; jb.dz = jobs[j].dz; jb.Ca = jobs[j].Ca; jb.Od = a.O;
    jb.taps = jobs[j].taps; jb.splits = a.splits[j]; jb.cps = a.cps[j];
    if (jb.splits <= 0 || jb.cps <= 0 || jb.splits * jb.cps < row_tiles ||
        (jb.splits - 1) * jb.cps >= row_tiles || jobs[j].dst == nullptr)
      return cudaErrorInvalidValue;
    jb.ctiles = (jb.Ca + kWgTile - 1) / kWgTile;
    jb.otiles = (a.O + kWgTile - 1) / kWgTile;
    jb.block0 = blocks;
    jb.part = a.wpart + wpart_off;
    const int n = jb.taps * jb.Ca * a.O;
    ra.job[ra.njobs++] = ReduceJob{jb.part, jobs[j].dst, n, jb.splits};
    wpart_off += size_t(jb.splits) * n;
    blocks += jb.ctiles * jb.otiles * jb.splits;
  }
  wa.njobs = njobs;
  if (static_cast<long long>(wpart_off * 4) > a.wpart_bytes) return cudaErrorInvalidValue;
  // column partials: [dgs, dgb, db, dbres] of the last GroupNorm, then [dgs, dgb, db] of the first
  const size_t pk = size_t(row_tiles) * a.O;
  float* gs_last = rtb ? a.dgs2 : a.dgs1;
  float* gb_last = rtb ? a.dgb2 : a.dgb1;
  float* b_last = rtb ? a.db2 : a.db1;
  float* dsts[kColParts] = {gs_last, gb_last, b_last, proj ? a.dbres : nullptr,
                            a.dgs1, a.dgb1, a.db1};
  for (int q = 0; q < (want_w ? (rtb ? kColParts : 3) : 0); ++q)
    if (dsts[q] != nullptr) ra.job[ra.njobs++] = ReduceJob{a.colpart + q * pk, dsts[q], a.O, row_tiles};

  // 1. the weights of the dgrad stages, flipped and transposed
  char* ws = reinterpret_cast<char*>(a.wstage);
  StageJobT sj[3] = {};
  int nsj = 0;
  if (rtb) sj[nsj++] = StageJobT{a.w2, reinterpret_cast<uint32_t*>(ws), K, a.O, a.O, a.nt_d2, n_w2 / 4};
  if (want_dx) sj[nsj++] = StageJobT{a.w1, reinterpret_cast<uint32_t*>(ws + n_w2), K, a.O, a.C, a.nt_d1, n_w1 / 4};
  if (n_wr) sj[nsj++] = StageJobT{a.wres, reinterpret_cast<uint32_t*>(ws + n_w2 + n_w1), 1, a.O, a.C, a.nt_d1, n_wr / 4};
  if (nsj > 0) {
    const size_t total = (n_w2 + n_w1 + n_wr) / 4;
    const size_t nb = (total + 255) / 256;
    stage_weights_t<<<nb < 4096 ? nb : 4096, 256, 0, s>>>(sj[0], sj[1], sj[2]);
    CINDM_TRY(cudaGetLastError());
  }

  // 2. the last GroupNorm + Mish backward: g -> dz2 (the head: -> dz1)
  GnBwd gn{};
  gn.z = rtb ? a.z2 : a.z1; gn.mean = rtb ? a.mean2 : a.mean1; gn.rstd = rtb ? a.rstd2 : a.rstd1;
  gn.gs = rtb ? a.gs2 : a.gs1; gn.gb = rtb ? a.gb2 : a.gb1;
  gn.dz = rtb ? a.dz2 : a.dz1;
  gn.part = a.colpart; gn.dtemb = nullptr; gn.colsum = proj ? 1 : 0;
  gn.B = a.B; gn.T = a.T; gn.O = a.O; gn.G = a.G; gn.samples = a.samples; gn.row_tiles = row_tiles;
  CINDM_TRY(a.nt_gn == 64 ? launch_gn<64>(a.g, gn, row_tiles, smem_gn, s)
                          : launch_gn<128>(a.g, gn, row_tiles, smem_gn, s));

  // 3. the block: dh = conv_T(dz2, w2), dtemb, the first GroupNorm's backward -> dz1
  if (rtb) {
    DgradArgs d{};
    d.dz = a.dz2; d.ws = reinterpret_cast<const uint32_t*>(ws);
    d.B = a.B; d.T = a.T; d.Cin = a.O; d.Cout = a.O; d.samples = a.samples;
    GnBwd g1 = gn;
    g1.z = a.z1; g1.mean = a.mean1; g1.rstd = a.rstd1; g1.gs = a.gs1; g1.gb = a.gb1;
    g1.dz = a.dz1; g1.part = a.colpart + 4 * pk; g1.dtemb = a.dtemb; g1.colsum = 0;
    const bool t3 = a.T <= 3;
    CINDM_TRY(a.nt_d2 == 64
                  ? (t3 ? launch_dgrad_gn<64, 3>(d, g1, row_tiles, smem_d2, s)
                        : launch_dgrad_gn<64, kConvK>(d, g1, row_tiles, smem_d2, s))
                  : (t3 ? launch_dgrad_gn<128, 3>(d, g1, row_tiles, smem_d2, s)
                        : launch_dgrad_gn<128, kConvK>(d, g1, row_tiles, smem_d2, s)));
  }

  // 4. dx = conv_T(dz1, w1) + the residual's cotangent
  if (want_dx) {
    DgradArgs d{};
    d.dz = a.dz1; d.ws = reinterpret_cast<const uint32_t*>(ws + n_w2);
    d.g = rtb ? a.g : nullptr;
    d.wress = n_wr ? reinterpret_cast<const uint32_t*>(ws + n_w2 + n_w1) : nullptr;
    d.out = a.dx;
    d.B = a.B; d.T = a.T; d.Cin = a.O; d.Cout = a.C; d.Cres = a.O; d.samples = a.samples;
    const bool t3 = a.T <= 3;
    CINDM_TRY(a.nt_d1 == 64
                  ? (t3 ? launch_dgrad_x<64, 3>(d, row_tiles, smem_d1, s)
                        : launch_dgrad_x<64, kConvK>(d, row_tiles, smem_d1, s))
                  : (t3 ? launch_dgrad_x<128, 3>(d, row_tiles, smem_d1, s)
                        : launch_dgrad_x<128, kConvK>(d, row_tiles, smem_d1, s)));
  }

  if (!want_w) return cudaSuccess;

  // 5. the weight gradients' split partials
  CINDM_TRY(allow_smem(wgrad, wgrad_smem_bytes()));
  wgrad<<<blocks, kWgThreads, wgrad_smem_bytes(), s>>>(wa);
  CINDM_TRY(cudaGetLastError());

  // 6. every gradient from its partials
  int nmax = 0;
  for (int j = 0; j < ra.njobs; ++j) nmax = ra.job[j].n > nmax ? ra.job[j].n : nmax;
  const int nb = (nmax + 255) / 256;
  grad_reduce<<<dim3(nb < 264 ? nb : 264, ra.njobs), 256, 0, s>>>(ra);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cindm_block_backward_args_size() { return static_cast<int>(sizeof(BlockBwdArgs)); }

extern "C" int cindm_fused_rtb_backward(const BlockBwdArgs* a, void* stream) {
  return block_backward(*a, true, stream);
}

extern "C" int cindm_fused_conv1d_gn_mish_backward(const BlockBwdArgs* a, void* stream) {
  return block_backward(*a, false, stream);
}
