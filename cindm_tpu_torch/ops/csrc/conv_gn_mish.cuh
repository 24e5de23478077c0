// Device code shared by fused_rtb.cu and fused_conv_gn.cu: one Conv1d +
// GroupNorm + Mish stage over a block's tile of samples, held in shared
// memory, all arithmetic in fp32 on the CUDA cores (no TF32 anywhere).
//
// Tile layout (channel-last, as the JAX package and the wrappers use it):
// a block owns S consecutive samples, i.e. rows = S*T consecutive rows of
// [B*T, C]. A buffer holding conv input has one extra all-zero row at index
// `rows`; a tap that falls outside its own sample's [0, T) reads that row,
// which is the conv's zero padding.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace cindm {

// Conv rows each thread accumulates in registers per pass; 24 rows cover one
// sample at T=24 or several samples at the deeper, shorter stages.
constexpr int kRows = 24;
// Conv width of every block of the denoiser; the fixed-length path needs it.
constexpr int kK = 5;
// One thread per output channel up to O=512: at the deep stages (O=512, T=3)
// a block then holds 16 warps, where 256 threads with two channels each left
// the SM short of warps to hide shared-memory and L2 latency.
constexpr int kMaxThreads = 512;
// Dynamic shared memory a block may take (the H100's per-block limit).
constexpr size_t kSmemMax = 232448;

__host__ __device__ inline size_t align4(size_t n) { return (n + 3) & ~size_t(3); }

__device__ __forceinline__ float mish(float v) {
  // softplus without overflow, as jax.nn.softplus computes it
  const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
  return v * tanhf(sp);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float fma4(float4 v, float w0, float w1, float w2, float w3,
                                      float acc) {
  return fmaf(v.w, w3, fmaf(v.z, w2, fmaf(v.y, w1, fmaf(v.x, w0, acc))));
}

// out[r][o] = bias[o] + sum_k sum_c in[r + k - K/2][c] * w[k][c][o]
// for r in [0, rows). Threads own output channels (neighbouring threads read
// neighbouring o of w, so weight loads coalesce); every weight load feeds up
// to kRows FMAs, and the input is read as float4 broadcasts from shared
// memory, so C must be a multiple of 4 (the wrappers check it).
//
// kT > 0 is the sample length T, known at compile time, with K == kK and
// kRows a multiple of kT: every register row's position in its sample is
// then a constant, and the taps that fall in the conv's zero padding are
// dropped when the kernel is compiled (at T=3, 6 of every 15 taps). Rows at
// or past `rows` are computed from whatever the tile holds and not stored;
// the caller allocates the tile for whole register passes.
// kT == 0 takes any T and K: a tap outside the row's own sample reads the
// zero row in[rows][:].
template <int kT>
__device__ inline void conv_rows(const float* __restrict__ in, int C,
                                 const float* __restrict__ w,
                                 const float* __restrict__ bias, int K, int O,
                                 int T, int rows, float* __restrict__ out) {
  static_assert(kT == 0 || kRows % kT == 0, "kT must divide kRows");
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    const float b = bias != nullptr ? __ldg(bias + o) : 0.0f;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = b;
      if constexpr (kT > 0) {
        constexpr int pad = kK / 2;
        const float* tile = in + static_cast<size_t>(r0) * C;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          const float* wk = w + static_cast<size_t>(k) * C * O + o;
          for (int c = 0; c < C; c += 4) {
            const float w0 = __ldg(wk + static_cast<size_t>(c + 0) * O);
            const float w1 = __ldg(wk + static_cast<size_t>(c + 1) * O);
            const float w2 = __ldg(wk + static_cast<size_t>(c + 2) * O);
            const float w3 = __ldg(wk + static_cast<size_t>(c + 3) * O);
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              const int ts = j % kT + k - pad;  // a constant once unrolled
              if (ts >= 0 && ts < kT) {
                const float4 v = *reinterpret_cast<const float4*>(tile + (j + k - pad) * C + c);
                acc[j] = fma4(v, w0, w1, w2, w3, acc[j]);
              }
            }
          }
        }
      } else {
        const int pad = K / 2;
        for (int k = 0; k < K; ++k) {
          int off[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int r = min(r0 + j, rows - 1);  // rows past the end: computed, never stored
            const int ts = r % T + k - pad;
            off[j] = (ts >= 0 && ts < T) ? (r + k - pad) * C : rows * C;
          }
          const float* wk = w + static_cast<size_t>(k) * C * O + o;
          for (int c = 0; c < C; c += 4) {
            const float w0 = __ldg(wk + static_cast<size_t>(c + 0) * O);
            const float w1 = __ldg(wk + static_cast<size_t>(c + 1) * O);
            const float w2 = __ldg(wk + static_cast<size_t>(c + 2) * O);
            const float w3 = __ldg(wk + static_cast<size_t>(c + 3) * O);
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(in + off[j] + c);
              acc[j] = fma4(v, w0, w1, w2, w3, acc[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < rows) out[(r0 + j) * O + o] = acc[j];
    }
  }
}

// Per (sample, group) mean and 1/sqrt(var + eps) of buf [S*T][O], two-pass
// in fp32 with biased variance; one warp per (sample, group).
__device__ inline void group_stats(const float* __restrict__ buf, int S, int T,
                                   int O, int G, float eps,
                                   float* __restrict__ mean,
                                   float* __restrict__ rstd) {
  const int og = O / G;
  const int n = T * og;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < S * G; p += nwarps) {
    const float* base = buf + static_cast<size_t>(p / G) * T * O + (p % G) * og;
    float s = 0.0f;
    for (int e = lane; e < n; e += 32) s += base[(e / og) * O + e % og];
    const float m = warp_sum(s) / n;
    float q = 0.0f;
    for (int e = lane; e < n; e += 32) {
      const float d = base[(e / og) * O + e % og] - m;
      q += d * d;
    }
    const float var = warp_sum(q) / n;
    if (lane == 0) {
      mean[p] = m;
      rstd[p] = rsqrtf(var + eps);
    }
  }
}

// dst[r][o] = Mish((buf[r][o] - mean) * rstd * gs[o] + gb[o])
//             (+ per_sample[s][o]) (+ per_elem[r][o]),  r = s*T + t.
// dst may alias buf (in place) or point to global memory.
__device__ inline void gn_mish_apply(const float* buf, int rows, int T, int O,
                                     int G, const float* __restrict__ mean,
                                     const float* __restrict__ rstd,
                                     const float* __restrict__ gs,
                                     const float* __restrict__ gb,
                                     const float* __restrict__ per_sample,
                                     const float* per_elem, float* dst) {
  const int og = O / G;
  for (int i = threadIdx.x; i < rows * O; i += blockDim.x) {
    const int r = i / O;
    const int o = i - r * O;
    const int s = r / T;
    const int p = s * G + o / og;
    float v = (buf[i] - mean[p]) * rstd[p] * __ldg(gs + o) + __ldg(gb + o);
    v = mish(v);
    if (per_sample != nullptr) v += __ldg(per_sample + s * O + o);
    if (per_elem != nullptr) v += per_elem[i];
    dst[i] = v;
  }
}

// Copy this block's rows*C input floats to shared memory and zero the pad row.
__device__ inline void stage_input(const float* __restrict__ src, int rows, int C,
                                   float* __restrict__ dst) {
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) dst[rows * C + i] = 0.0f;
}

// Samples per block: enough rows for one register pass (kRows), so no
// register row is computed for nothing; fewer only when the tile would pass
// the per-block shared-memory limit. Never fewer than one.
template <typename SmemFloats>
inline int pick_samples(int B, int T, SmemFloats smem_floats) {
  int S = kRows / T > 1 ? kRows / T : 1;
  if (S > B) S = B;
  while (S > 1 && smem_floats(S) * sizeof(float) > kSmemMax) --S;
  return S;
}

// Calls launch(std::integral_constant<int, kT>{}) with kT = T where the
// fixed-length conv path applies (T in {3, 6, 12, 24}, K == kK, and the
// block's tile is exactly kRows rows), else with kT = 0.
template <typename Launch>
inline cudaError_t dispatch_length(int T, int K, int S, Launch launch) {
  if (K == kK && S * T == kRows) {
    switch (T) {
      case 3: return launch(std::integral_constant<int, 3>{});
      case 6: return launch(std::integral_constant<int, 6>{});
      case 12: return launch(std::integral_constant<int, 12>{});
      case 24: return launch(std::integral_constant<int, 24>{});
      default: break;
    }
  }
  return launch(std::integral_constant<int, 0>{});
}

inline int threads_for(int O) {
  const int t = ((O + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace cindm
