// Fused ResidualTemporalBlock forward for Hopper (sm_90a), 3xTF32 on the
// tensor cores.
//
// Replaces the TPU kernel cindm_tpu/ops/fused_rtb.py:fused_rtb (Pallas
// bodies _kernel_proj / _kernel_id with the tile helper
// _conv_gn_mish_tile). Computes, per sample:
//   h   = Mish(GN(conv5(x) + b1)) + temb      (GN: G groups, eps, biased var)
//   out = Mish(GN(conv5(h) + b2)) + (x @ wres + bres | x)
//
// What bounds it on an H100: operations. 3xTF32 issues every multiply-add
// three times on the tensor cores, so the floor is 3 x FLOP (valid taps
// only) at 495 TFLOP/s: 3.26 ms for the denoiser's 16 blocks at batch 5,376,
// against the 8.02 ms that fp32 on the CUDA cores would need.
//
// Design: two launches of the stage in conv_gn_mish.cuh per call, on
// weights that stage_weights laid out beforehand (tf32 big/small blocks
// that one bulk copy moves into shared memory; cindm_stage_weights, which
// the wrapper runs once per weight version and N tile and keeps). The
// first launch writes h [B, T, O] to device memory once, the second reads
// it (with x for the residual). The TPU kernel fused the whole block to
// keep h out of HBM; here h costs about 33 MB each way at batch 5,376 (0.02
// ms at 3.35 TB/s), while a tile of whole samples x whole groups of 192
// rows lets each weight the ring stages from L2 feed 192 rows. Each launch
// is a persistent grid of at most one CTA an SM on stage_ring.cuh's main
// loop: a producer warpgroup stages the tile's input rows by TMA and its
// weight blocks by bulk copy into a ring, three consumer warpgroups run the
// taps on wgmma with one group in flight and a tile's GroupNorm, Mish and
// stores from their registers while the producer fills the next tile's
// slots. The 1x1 residual projection is a second part of K = 1 on the same
// ring inside the second launch, run first in the conv's registers. Each
// launch is planned on its own (its K is its own): the items of its last,
// partial wave are split by K chunks over every cluster, the last part of
// a tile to arrive finishing it (conv_gn_mish.cuh).
//
// cindm_fused_rtb_saving is the forward of the autograd Function: the same
// two launches through the stage's saving instance, which also writes what
// the backward (block_backward.cu) reads instead of recomputing the block:
// z1 and z2 [B, T, O], the conv outputs plus bias before each GroupNorm,
// and both GroupNorms' mean and rstd [B, G]. h is kept too.
#include "conv_gn_mish.cuh"

namespace {

// w1s, w2s: w1 [K, C, O] and w2 [K, O, O] laid out by stage_weights for N
// tiles of the plans' n_tile; wress: wres [C, O] likewise (K = 1), or null
// (identity). temb: [B, O] rows temb_ld floats apart (a multiple of 4, O or
// more: a view of every block's projections in one [B, sum O] product),
// on a 16-byte boundary. s1, s2: the plans of the two stage launches (a block's second
// stage is C = O: its K, and so its split, is its own); they may share one
// workspace and counters, since each launch leaves its counters at 0.
int fused_rtb(const float* x, const float* temb, const void* w1s, const float* b1, const float* gs1,
              const float* gb1, const void* w2s, const float* b2, const float* gs2, const float* gb2,
              const void* wress, const float* bres, float* h, float* out, float* z1, float* z2,
              float* mean1, float* rstd1, float* mean2, float* rstd2, int B, int T, int C, int O, int K,
              int G, int temb_ld, float eps, const cindm::StageLaunch* s1, const cindm::StageLaunch* s2,
              void* stream) {
  if ((wress == nullptr) != (bres == nullptr) || (wress == nullptr && C != O) || w1s == nullptr ||
      w2s == nullptr || s1 == nullptr || s2 == nullptr || s1->n_tile != s2->n_tile || temb == nullptr ||
      temb_ld < O || temb_ld % 4 != 0 || reinterpret_cast<uintptr_t>(temb) % 16 != 0)
    return cudaErrorInvalidValue;
  cindm::SaveArgs a{};
  a.x = x; a.b = b1; a.gs = gs1; a.gb = gb1; a.temb = temb; a.temb_ld = temb_ld; a.out = h;
  a.ws = static_cast<const uint32_t*>(w1s);
  a.B = B; a.T = T; a.C = C; a.O = O; a.G = G; a.eps = eps;
  a.z = z1; a.mean = mean1; a.rstd = rstd1;
  cindm::SaveArgs b = a;
  b.x = h; b.b = b2; b.gs = gs2; b.gb = gb2; b.temb = nullptr; b.out = out;
  b.ws = static_cast<const uint32_t*>(w2s);
  b.C = O; b.xres = x; b.bres = bres; b.Cres = C;
  b.wress = static_cast<const uint32_t*>(wress);
  b.z = z2; b.mean = mean2; b.rstd = rstd2;
  const bool save = z1 != nullptr;
  cudaError_t err = save ? cindm::launch_stage(a, K, *s1, stream)
                         : cindm::launch_stage(static_cast<const cindm::StageArgs&>(a), K, *s1, stream);
  if (err != cudaSuccess) return err;
  return save ? cindm::launch_stage(b, K, *s2, stream)
              : cindm::launch_stage(static_cast<const cindm::StageArgs&>(b), K, *s2, stream);
}

}  // namespace

extern "C" int cindm_fused_rtb(const float* x, const float* temb, const void* w1s,
                               const float* b1, const float* gs1, const float* gb1,
                               const void* w2s, const float* b2, const float* gs2,
                               const float* gb2, const void* wress, const float* bres, float* h,
                               float* out, int B, int T, int C, int O, int K, int G, int temb_ld,
                               float eps, const cindm::StageLaunch* s1, const cindm::StageLaunch* s2,
                               void* stream) {
  return fused_rtb(x, temb, w1s, b1, gs1, gb1, w2s, b2, gs2, gb2, wress, bres, h, out, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, B, T, C, O, K, G, temb_ld, eps, s1, s2,
                   stream);
}

extern "C" int cindm_fused_rtb_saving(const float* x, const float* temb, const void* w1s,
                                      const float* b1, const float* gs1, const float* gb1,
                                      const void* w2s, const float* b2, const float* gs2,
                                      const float* gb2, const void* wress, const float* bres,
                                      float* h, float* out, float* z1, float* z2, float* mean1,
                                      float* rstd1, float* mean2, float* rstd2, int B, int T,
                                      int C, int O, int K, int G, int temb_ld, float eps,
                                      const cindm::StageLaunch* s1, const cindm::StageLaunch* s2,
                                      void* stream) {
  if (z1 == nullptr || z2 == nullptr || mean1 == nullptr || rstd1 == nullptr ||
      mean2 == nullptr || rstd2 == nullptr)
    return cudaErrorInvalidValue;
  return fused_rtb(x, temb, w1s, b1, gs1, gb1, w2s, b2, gs2, gb2, wress, bres, h, out, z1, z2,
                   mean1, rstd1, mean2, rstd2, B, T, C, O, K, G, temb_ld, eps, s1, s2, stream);
}

// sizeof(StageLaunch), which load() holds the ctypes structure to.
extern "C" int cindm_stage_launch_size() { return static_cast<int>(sizeof(cindm::StageLaunch)); }
