// Fused Conv1d + GroupNorm + Mish forward for Hopper (sm_90a), 3xTF32 on
// the tensor cores.
//
// Replaces the TPU kernel cindm_tpu/ops/fused_conv_gn.py:fused_conv1d_gn_mish
// (Pallas body _kernel): out = Mish(GN(conv_5(x) + b)), GroupNorm with G
// groups, eps, biased variance, statistics in fp32. On the denoiser's path
// it serves the head Conv1dBlock ([B, 24, 64] -> [B, 24, 64]).
//
// What bounds it on an H100: operations. At the head shape a sample does
// 2 * 114 valid taps * 64 * 64 = 934k FLOP against 12 KB of x and out, and
// 3xTF32 issues each of them three times on the tensor cores: 3 x FLOP at
// 495 TFLOP/s is 0.030 ms at batch 5,376, above the 0.020 ms that its 66 MB
// of x and out need at 3.35 TB/s.
//
// Design: one launch of the stage in conv_gn_mish.cuh, on w as
// stage_weights laid it out beforehand (cindm_stage_weights below, which
// the wrapper runs once per weight version and N tile and keeps). A tile
// is 192 rows (8 whole samples at T=24) and all 64 channels (8 whole
// groups), so each weight staged from L2 serves 192 rows; the conv output
// stays in the consumers' registers for the GroupNorm statistics and goes
// to device memory once, normalised and Mish'd. The launch is a persistent
// grid of at most one CTA an SM on stage_ring.cuh's main loop (a producer
// warpgroup's TMA and bulk-copy ring, three wgmma consumer warpgroups), so
// that one tile's epilogue overlaps the next tile's loads (672 tiles at
// batch 5,376), the last, partial wave's tiles split by K chunks over
// every cluster.
//
// cindm_fused_conv1d_gn_mish_saving is the forward of the autograd
// Function: the stage's saving instance, which also writes z [B, T, O] (the
// conv output plus bias) and the GroupNorm's mean and rstd [B, G] for the
// backward in block_backward.cu.
#include "conv_gn_mish.cuh"

namespace {

// ws: w [K, C, O] laid out by stage_weights for N tiles of the plan's
// n_tile; s: the launch's plan.
int conv_gn_mish(const float* x, const void* ws, const float* b, const float* gs, const float* gb,
                 float* out, float* z, float* mean, float* rstd, int B, int T, int C, int O, int K,
                 int G, float eps, const cindm::StageLaunch* s, void* stream) {
  if (ws == nullptr || s == nullptr) return cudaErrorInvalidValue;
  cindm::SaveArgs a{};
  a.x = x; a.b = b; a.gs = gs; a.gb = gb; a.out = out;
  a.ws = static_cast<const uint32_t*>(ws);
  a.B = B; a.T = T; a.C = C; a.O = O; a.G = G; a.eps = eps;
  a.z = z; a.mean = mean; a.rstd = rstd;
  return z != nullptr ? cindm::launch_stage(a, K, *s, stream)
                      : cindm::launch_stage(static_cast<const cindm::StageArgs&>(a), K, *s, stream);
}

}  // namespace

extern "C" int cindm_fused_conv1d_gn_mish(const float* x, const void* ws, const float* b,
                                          const float* gs, const float* gb, float* out, int B,
                                          int T, int C, int O, int K, int G, float eps,
                                          const cindm::StageLaunch* s, void* stream) {
  return conv_gn_mish(x, ws, b, gs, gb, out, nullptr, nullptr, nullptr, B, T, C, O, K, G, eps, s,
                      stream);
}

extern "C" int cindm_fused_conv1d_gn_mish_saving(const float* x, const void* ws, const float* b,
                                                 const float* gs, const float* gb, float* out,
                                                 float* z, float* mean, float* rstd, int B, int T,
                                                 int C, int O, int K, int G, float eps,
                                                 const cindm::StageLaunch* s, void* stream) {
  if (z == nullptr || mean == nullptr || rstd == nullptr) return cudaErrorInvalidValue;
  return conv_gn_mish(x, ws, b, gs, gb, out, z, mean, rstd, B, T, C, O, K, G, eps, s, stream);
}

// stage_weights: njobs (1 to 3) weight tensors w[i] [K][C][O] (dims[4 i ..
// 4 i + 3] = K, C, O, nt, nt the same for all) laid out for N tiles of nt
// into out[i] (staged_weight_bytes(nt, C, O, K) bytes each), as the
// stage's launches read them, in one launch: per N tile and chunk of 8
// input channels one block of the K taps' tf32 big and small planes. What
// bounds it: bytes (w read once, twice as many written). The wrappers of
// both stage kernels call it once for a call's weights that changed
// (ops/_build.staged) and keep the planes.
extern "C" int cindm_stage_weights(const float* const* w, void* const* out, const int* dims, int njobs,
                                   void* stream) {
  if (w == nullptr || out == nullptr || dims == nullptr || njobs < 1 || njobs > cindm::kLayoutJobs)
    return cudaErrorInvalidValue;
  cindm::LayoutJob jobs[cindm::kLayoutJobs] = {};
  for (int i = 0; i < njobs; ++i)
    jobs[i] = cindm::LayoutJob{w[i], static_cast<uint32_t*>(out[i]), dims[4 * i], dims[4 * i + 1],
                               dims[4 * i + 2], dims[4 * i + 3], 0};
  return cindm::launch_stage_weights(jobs, njobs, dims[3], static_cast<cudaStream_t>(stream));
}
