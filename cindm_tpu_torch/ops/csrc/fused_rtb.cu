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
// Design: two launches of the implicit-GEMM stage in conv_gn_mish.cuh per
// call, each after stage_weights has laid its weights out in `scratch`
// (tf32 big/small blocks that one bulk copy moves into shared memory).
// The first launch writes h [B, T, O] to device memory once, the second
// reads it (with x for the residual). The TPU kernel fused the whole block
// to keep h out of HBM; here h costs about 33 MB each way at batch 5,376
// (0.02 ms at 3.35 TB/s), while keeping it on chip pinned a block to one
// CTA's 24 rows and made every weight come from L2 once per 24 rows (about
// 64 GB of L2 reads per forward). A stage block owns 192 rows of whole
// samples and an N tile of whole GroupNorm groups, so each weight it
// stages from L2 feeds 192 rows: about 8 GB of weights per forward (16 GB
// as big/small pairs). The 1x1 residual projection is a second GEMM over
// the same rows inside the second launch, in the registers its conv
// accumulator vacated.
//
// cindm_fused_rtb_saving is the forward of the autograd Function: the same
// two launches through the stage's saving instance, which also writes what
// the backward (block_backward.cu) reads instead of recomputing the block:
// z1 and z2 [B, T, O], the conv outputs plus bias before each GroupNorm,
// and both GroupNorms' mean and rstd [B, G]. h is kept too.
#include "conv_gn_mish.cuh"

namespace {

int fused_rtb(const float* x, const float* temb, const float* w1, const float* b1,
              const float* gs1, const float* gb1, const float* w2, const float* b2,
              const float* gs2, const float* gb2, const float* wres, const float* bres, float* h,
              float* out, float* z1, float* z2, float* mean1, float* rstd1, float* mean2,
              float* rstd2, void* scratch, long long scratch_bytes, int B, int T, int C, int O,
              int K, int G, float eps, int samples, int nt, int smem1, int smem2, void* stream) {
  if ((wres == nullptr) != (bres == nullptr) || (wres == nullptr && C != O) || nt <= 0)
    return cudaErrorInvalidValue;
  // scratch: w1, w2 and wres laid out by stage_weights, one after another
  const size_t n1 = cindm::staged_weight_bytes(nt, C, O, K);
  const size_t n2 = cindm::staged_weight_bytes(nt, O, O, K);
  const size_t n3 = wres != nullptr ? cindm::staged_weight_bytes(nt, C, O, 1) : 0;
  if (static_cast<long long>(n1 + n2 + n3) > scratch_bytes) return cudaErrorInvalidValue;
  char* ws = static_cast<char*>(scratch);
  cindm::SaveArgs a{};
  a.x = x; a.w = w1; a.b = b1; a.gs = gs1; a.gb = gb1; a.temb = temb; a.out = h;
  a.ws = reinterpret_cast<uint32_t*>(ws);
  a.B = B; a.T = T; a.C = C; a.O = O; a.G = G; a.eps = eps; a.samples = samples;
  a.z = z1; a.mean = mean1; a.rstd = rstd1;
  cindm::SaveArgs b = a;
  b.x = h; b.w = w2; b.b = b2; b.gs = gs2; b.gb = gb2; b.temb = nullptr; b.out = out;
  b.ws = reinterpret_cast<uint32_t*>(ws + n1);
  b.C = O; b.xres = x; b.wres = wres; b.bres = bres; b.Cres = C;
  b.wress = wres != nullptr ? reinterpret_cast<uint32_t*>(ws + n1 + n2) : nullptr;
  b.z = z2; b.mean = mean2; b.rstd = rstd2;
  const bool save = z1 != nullptr;
  cudaError_t err = save ? cindm::launch_stage(a, K, nt, smem1, stream)
                         : cindm::launch_stage(static_cast<const cindm::StageArgs&>(a), K, nt,
                                               smem1, stream);
  if (err != cudaSuccess) return err;
  return save ? cindm::launch_stage(b, K, nt, smem2, stream)
              : cindm::launch_stage(static_cast<const cindm::StageArgs&>(b), K, nt, smem2, stream);
}

}  // namespace

extern "C" int cindm_fused_rtb(const float* x, const float* temb, const float* w1,
                               const float* b1, const float* gs1, const float* gb1,
                               const float* w2, const float* b2, const float* gs2,
                               const float* gb2, const float* wres, const float* bres, float* h,
                               float* out, void* scratch, long long scratch_bytes, int B, int T,
                               int C, int O, int K, int G, float eps, int samples, int nt,
                               int smem1, int smem2, void* stream) {
  return fused_rtb(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, h, out, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, scratch, scratch_bytes, B, T, C, O,
                   K, G, eps, samples, nt, smem1, smem2, stream);
}

extern "C" int cindm_fused_rtb_saving(const float* x, const float* temb, const float* w1,
                                      const float* b1, const float* gs1, const float* gb1,
                                      const float* w2, const float* b2, const float* gs2,
                                      const float* gb2, const float* wres, const float* bres,
                                      float* h, float* out, float* z1, float* z2, float* mean1,
                                      float* rstd1, float* mean2, float* rstd2, void* scratch,
                                      long long scratch_bytes, int B, int T, int C, int O, int K,
                                      int G, float eps, int samples, int nt, int smem1, int smem2,
                                      void* stream) {
  if (z1 == nullptr || z2 == nullptr || mean1 == nullptr || rstd1 == nullptr ||
      mean2 == nullptr || rstd2 == nullptr)
    return cudaErrorInvalidValue;
  return fused_rtb(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, h, out, z1, z2, mean1,
                   rstd1, mean2, rstd2, scratch, scratch_bytes, B, T, C, O, K, G, eps, samples, nt,
                   smem1, smem2, stream);
}
