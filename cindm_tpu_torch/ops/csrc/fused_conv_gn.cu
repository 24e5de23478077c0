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
// Design: one launch of the implicit-GEMM stage in conv_gn_mish.cuh, after
// stage_weights has laid w out for it in `scratch`. A block owns 192 rows
// (8 whole samples at T=24) and all 64 channels (8 whole groups), so each
// weight staged from L2 serves 192 rows; the conv output stays in shared
// memory for the GroupNorm statistics and goes to device memory once,
// normalised and Mish'd.
#include "conv_gn_mish.cuh"

extern "C" int cindm_fused_conv1d_gn_mish(const float* x, const float* w, const float* b,
                                          const float* gs, const float* gb, float* out,
                                          void* scratch, long long scratch_bytes, int B, int T,
                                          int C, int O, int K, int G, float eps, int samples,
                                          int nt, int smem_bytes, void* stream) {
  if (nt <= 0 || static_cast<long long>(cindm::staged_weight_bytes(nt, C, O, K)) > scratch_bytes)
    return cudaErrorInvalidValue;
  cindm::StageArgs a{};
  a.x = x; a.w = w; a.b = b; a.gs = gs; a.gb = gb; a.out = out;
  a.ws = static_cast<uint32_t*>(scratch);
  a.B = B; a.T = T; a.C = C; a.O = O; a.G = G; a.eps = eps; a.samples = samples;
  return cindm::launch_stage(a, K, nt, smem_bytes, stream);
}
