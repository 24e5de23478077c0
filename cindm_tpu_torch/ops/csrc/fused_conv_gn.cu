// Fused Conv1d + GroupNorm + Mish forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel cindm_tpu/ops/fused_conv_gn.py:fused_conv1d_gn_mish
// (Pallas body _kernel): out = Mish(GN(conv_K(x) + b)), GroupNorm with G
// groups, eps, biased variance, statistics in fp32. On the denoiser's path
// it serves the head Conv1dBlock ([B, 24, 64] -> [B, 24, 64], K=5).
//
// What bounds it on an H100: operations. At the head shape a sample does
// 2*24*5*64*64 = 983k FLOP against 12 KB of x and out, about 80 FLOP per
// byte, above the fp32 ridge of 20 FLOP/B, so the floor is the fp32 FMA
// rate.
//
// Design: the same tile code as fused_rtb.cu (conv_gn_mish.cuh). A block
// owns S whole samples, stages x in shared memory, keeps the conv output
// there for the GroupNorm statistics, and writes the normalised, Mish'd
// result to device memory once.
#include "conv_gn_mish.cuh"

namespace cindm {
namespace {

size_t cgm_smem_floats(int S, int T, int C, int O, int G) {
  const size_t rows = static_cast<size_t>(S) * T;
  return align4((rows + 1) * C) + align4(rows * O) + 2 * S * G;
}

template <int kT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_conv_gn_mish_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, const float* __restrict__ gs,
                          const float* __restrict__ gb, float* __restrict__ out,
                          int B, int T, int C, int O, int K, int G, float eps, int S) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t cap = static_cast<size_t>(S) * T;
  float* xs = smem;                       // [cap + 1][C]  input tile + zero row
  float* a = xs + align4((cap + 1) * C);  // [cap][O]      conv output
  float* mean = a + align4(cap * O);      // [S*G]
  float* rstd = mean + S * G;             // [S*G]

  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);
  const int rows = ns * T;

  stage_input(x + static_cast<size_t>(b0) * T * C, rows, C, xs);
  __syncthreads();
  conv_rows<kT>(xs, C, w, b, K, O, T, rows, a);
  __syncthreads();
  group_stats(a, ns, T, O, G, eps, mean, rstd);
  __syncthreads();
  gn_mish_apply(a, rows, T, O, G, mean, rstd, gs, gb, nullptr, nullptr,
                out + static_cast<size_t>(b0) * T * O);
}

}  // namespace
}  // namespace cindm

extern "C" int cindm_fused_conv1d_gn_mish(const float* x, const float* w, const float* b,
                                          const float* gs, const float* gb, float* out,
                                          int B, int T, int C, int O, int K, int G,
                                          float eps, void* stream) {
  using namespace cindm;
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || K <= 0 || G <= 0 || O % G != 0 ||
      C % 4 != 0)
    return cudaErrorInvalidValue;
  const int S = pick_samples(B, T, [&](int s) { return cgm_smem_floats(s, T, C, O, G); });
  const size_t bytes = cgm_smem_floats(S, T, C, O, G) * sizeof(float);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  const int grid = (B + S - 1) / S;
  return dispatch_length(T, K, S, [&](auto length) {
    constexpr int kT = decltype(length)::value;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_conv_gn_mish_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    fused_conv_gn_mish_kernel<kT><<<grid, threads_for(O), bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
        x, w, b, gs, gb, out, B, T, C, O, K, G, eps, S);
    return cudaGetLastError();
  });
}
