// Fused ResidualTemporalBlock forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel cindm_tpu/ops/fused_rtb.py:fused_rtb (Pallas
// bodies _kernel_proj / _kernel_id with the tile helper
// _conv_gn_mish_tile). Computes, per sample:
//   h   = Mish(GN(conv5(x) + b1)) + temb      (GN: 8 groups, eps, biased var)
//   h   = Mish(GN(conv5(h) + b2))
//   out = h + (x @ wres + bres | x)
//
// What bounds it on an H100: operations. At the flagship shapes (T <= 24,
// C <= 1024, O <= 512) every block does 100-1000 FLOP per byte of x, temb
// and out it must move, far above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s
// = 20 FLOP/B, so the floor is the fp32 FMA rate. The TPU kernel's one-hot
// GroupNorm matmuls (a Mosaic reshape workaround) are not carried over.
//
// Design: one thread block owns S whole samples (S*T = 24 rows where T
// divides 24; fewer samples only if the tile would pass the 227 KB
// per-block shared-memory limit, which no flagship shape does). x, the
// intermediate h, the second conv's output and the residual stay in shared
// memory, so the block reads x and temb once and writes out once. Up to 512
// threads each own one output channel and keep 24 rows of accumulators in
// registers, so each weight read from L2 feeds 24 FMAs; GroupNorm statistics
// are per (sample, group) warp reductions in fp32. Taps that fall in a
// sample's zero padding are still computed against a zero row: at T=3 that
// is 6 of every 15 conv taps, the largest waste left. Tensor cores
// (TF32/bf16), TMA staging of the weights and skipping the padding taps are
// left for a later, faster version.
#include "conv_gn_mish.cuh"

namespace cindm {
namespace {

size_t rtb_smem_floats(int S, int T, int C, int O, int G) {
  const size_t rows = static_cast<size_t>(S) * T;
  return align4((rows + 1) * C) + align4((rows + 1) * O) + align4(rows * O) + 2 * S * G;
}

template <int kT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_rtb_kernel(const float* __restrict__ x, const float* __restrict__ temb,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ gs1, const float* __restrict__ gb1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ gs2, const float* __restrict__ gb2,
                 const float* __restrict__ wres, const float* __restrict__ bres,
                 float* __restrict__ out, int B, int T, int C, int O, int K,
                 int G, float eps, int S) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t cap = static_cast<size_t>(S) * T;
  float* xs = smem;                          // [cap + 1][C]  input tile + zero row
  float* a = xs + align4((cap + 1) * C);     // [cap + 1][O]  h after block 1, then residual
  float* h = a + align4((cap + 1) * O);      // [cap][O]      conv2 output
  float* mean = h + align4(cap * O);         // [S*G]
  float* rstd = mean + S * G;                // [S*G]

  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);
  const int rows = ns * T;

  stage_input(x + static_cast<size_t>(b0) * T * C, rows, C, xs);
  for (int i = threadIdx.x; i < O; i += blockDim.x) a[rows * O + i] = 0.0f;
  __syncthreads();

  conv_rows<kT>(xs, C, w1, b1, K, O, T, rows, a);
  __syncthreads();
  group_stats(a, ns, T, O, G, eps, mean, rstd);
  __syncthreads();
  gn_mish_apply(a, rows, T, O, G, mean, rstd, gs1, gb1,
                temb + static_cast<size_t>(b0) * O, nullptr, a);
  __syncthreads();

  conv_rows<kT>(a, O, w2, b2, K, O, T, rows, h);
  __syncthreads();
  group_stats(h, ns, T, O, G, eps, mean, rstd);
  if (wres != nullptr) conv_rows<0>(xs, C, wres, bres, 1, O, T, rows, a);  // a is free now
  __syncthreads();
  gn_mish_apply(h, rows, T, O, G, mean, rstd, gs2, gb2, nullptr,
                wres != nullptr ? a : xs, out + static_cast<size_t>(b0) * T * O);
}

}  // namespace
}  // namespace cindm

extern "C" int cindm_fused_rtb(const float* x, const float* temb, const float* w1,
                               const float* b1, const float* gs1, const float* gb1,
                               const float* w2, const float* b2, const float* gs2,
                               const float* gb2, const float* wres, const float* bres,
                               float* out, int B, int T, int C, int O, int K, int G,
                               float eps, void* stream) {
  using namespace cindm;
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || K <= 0 || G <= 0 || O % G != 0 ||
      C % 4 != 0 || O % 4 != 0 ||
      ((wres == nullptr) != (bres == nullptr)) || (wres == nullptr && C != O))
    return cudaErrorInvalidValue;
  const int S = pick_samples(B, T, [&](int s) { return rtb_smem_floats(s, T, C, O, G); });
  const size_t bytes = rtb_smem_floats(S, T, C, O, G) * sizeof(float);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  const int grid = (B + S - 1) / S;
  return dispatch_length(T, K, S, [&](auto length) {
    constexpr int kT = decltype(length)::value;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_rtb_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    fused_rtb_kernel<kT><<<grid, threads_for(O), bytes, static_cast<cudaStream_t>(stream)>>>(
        x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, out, B, T, C, O, K, G, eps, S);
    return cudaGetLastError();
  });
}
