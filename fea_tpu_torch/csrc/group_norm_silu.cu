// Fused GroupNorm + affine + SiLU, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels fea_tpu/ops/fused_norm.py:_fwd_kernel (launched
// by _gn_fwd) and :_bwd_kernel (launched by _gn_bwd). For x (B, C, HW) in
// one of two dense layouts, channels-last (memory (B, HW, C), what the
// port's convolutions return) or NCHW (memory (B, C, HW)), and G groups of
// C/G channels:
//     forward   z = (x - mean_g) * rstd_g * gamma + beta,  y = z * sigmoid(z)
//     backward  dz = dy * s * (1 + z (1 - s)),  s = sigmoid(z)
//               dbeta_b[c] = sum_p dz,  dgamma_b[c] = sum_p dz * xh
//               dx = rstd_g * (dz gamma - mean_g(dz gamma) - xh mean_g(dz gamma xh))
// with xh = (x - mean_g) * rstd_g, f32 statistics whatever the input type,
// var = max(E[x^2] - mean^2, 0) as flax computes it, and y, dx in x's type.
// dgamma_b and dbeta_b are per-batch-element partials (B, C) in f32, summed
// over B by the caller, as the TPU kernel's are. dy may have any strides
// for which its spatial dims flatten (stride_h == W * stride_w): a channel
// slice of a concatenation's gradient is such a view.
//
// Design. The TPU kernel holds one batch element's (HW, C) block in VMEM and
// walks it in order. Here the HW reduction is split over blocks so that even
// batch 2 fills the 132 SMs, and nothing is carried between blocks:
//   1. partials: grid (channel tile, HW chunk, b); each block sums one chunk
//      of rows for its channels into an f32 buffer (B, chunks, C), with a
//      fixed reduction order and no atomics, so results are deterministic.
//      Channels-last blocks are 32 channels x 8 row lanes (a warp reads 32
//      neighbouring channels); NCHW blocks are one channel x 256 positions.
//   2. finalize: one block per (group, b) reduces the chunk partials of its
//      channels and writes per-channel coefficients (a, b, mean, rstd),
//      z = x a + b; the backward's finalize writes dgamma_b, dbeta_b and the
//      two group means of the dx formula.
//   3. apply: an elementwise pass in x's memory order.
// The forward is partials + finalize + apply; the backward recomputes the
// statistics the same way and adds its own partials + finalize + apply, so
// only x, gamma and beta are kept between the two, as on the TPU.
//
// What bounds it on this card: memory. It does a few FLOPs per element; the
// forward reads x twice and writes y once (the bound counts one read), the
// backward reads x three times and dy twice and writes dx. At the decoder's
// stage shapes x does not fit the 50 MB L2, so the re-reads come from HBM.
// Keeping a chunk on chip between the passes (one cooperative launch, or a
// cluster per (b, group)) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTileC = 32;  // channels-last partials: channels per block
constexpr int kLanesP = 8;  // channels-last partials: row lanes per block
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// Sum of (a, b) over the block (blockDim a multiple of 32, at most 1024),
// in a fixed order; the result is valid in every thread.
__device__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[32];
  __shared__ float2 total;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int lane = tid & 31, warp = tid >> 5;
  const int warps = (blockDim.x * blockDim.y * blockDim.z) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < warps ? warp_sums[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// The two sums one element adds to its channel's partials: (x, x^2) for the
// statistics, (dz, dz * xh) for the backward.
template <bool kBwd>
__device__ __forceinline__ float2 terms(float v, float g, float4 k) {
  if (!kBwd) return make_float2(v, v * v);
  const float z = v * k.x + k.y;
  const float s = sigmoid(z);
  const float dz = g * s * (1.f + z * (1.f - s));
  return make_float2(dz, dz * ((v - k.z) * k.w));
}

struct Strides {  // of dy, in elements: batch, channel, flattened position
  long long b, c, p;
};

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kTileC * kLanesP)
    partials_channels_last(const T* __restrict__ x, const T* __restrict__ dy,
                           const float4* __restrict__ coef, float2* __restrict__ partial,
                           int channels, int hw, int rows, Strides ds) {
  const int c = blockIdx.x * kTileC + threadIdx.x;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int p_end = min(hw, (chunk + 1) * rows);
  float a0 = 0.f, a1 = 0.f;
  if (c < channels) {
    const float4 k = kBwd ? coef[static_cast<size_t>(b) * channels + c] : make_float4(0, 0, 0, 0);
    const T* xb = x + static_cast<size_t>(b) * hw * channels + c;
    for (int p = chunk * rows + threadIdx.y; p < p_end; p += kLanesP) {
      const float v = to_f32(xb[static_cast<size_t>(p) * channels]);
      const float g = kBwd ? to_f32(dy[b * ds.b + c * ds.c + p * ds.p]) : 0.f;
      const float2 t = terms<kBwd>(v, g, k);
      a0 += t.x;
      a1 += t.y;
    }
  }
  __shared__ float2 lanes[kLanesP][kTileC];
  lanes[threadIdx.y][threadIdx.x] = make_float2(a0, a1);
  __syncthreads();
  if (threadIdx.y == 0 && c < channels) {
    float2 s = lanes[0][threadIdx.x];
#pragma unroll
    for (int l = 1; l < kLanesP; ++l) {
      s.x += lanes[l][threadIdx.x].x;
      s.y += lanes[l][threadIdx.x].y;
    }
    partial[(static_cast<size_t>(b) * gridDim.y + chunk) * channels + c] = s;
  }
}

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    partials_nchw(const T* __restrict__ x, const T* __restrict__ dy,
                  const float4* __restrict__ coef, float2* __restrict__ partial,
                  int channels, int hw, int rows, Strides ds) {
  const int c = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int p_end = min(hw, (chunk + 1) * rows);
  const float4 k = kBwd ? coef[static_cast<size_t>(b) * channels + c] : make_float4(0, 0, 0, 0);
  const T* xc = x + (static_cast<size_t>(b) * channels + c) * hw;
  float a0 = 0.f, a1 = 0.f;
  for (int p = chunk * rows + threadIdx.x; p < p_end; p += kThreads) {
    const float v = to_f32(xc[p]);
    const float g = kBwd ? to_f32(dy[b * ds.b + c * ds.c + p * ds.p]) : 0.f;
    const float2 t = terms<kBwd>(v, g, k);
    a0 += t.x;
    a1 += t.y;
  }
  const float2 s = block_sum2(a0, a1);
  if (threadIdx.x == 0) partial[(static_cast<size_t>(b) * gridDim.y + chunk) * channels + c] = s;
}

// One block per (group, b): the group's mean and rstd from the partials,
// then coef[b, c] = (rstd gamma, beta - mean rstd gamma, mean, rstd).
__global__ void __launch_bounds__(kThreads)
    stats_finalize(const float2* __restrict__ partial, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float4* __restrict__ coef, int channels,
                   int hw, int groups, int chunks, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = channels / groups;
  float s0 = 0.f, s1 = 0.f;
  for (int i = threadIdx.x; i < cg * chunks; i += kThreads) {
    const int c = g * cg + i / chunks, chunk = i % chunks;
    const float2 v = partial[(static_cast<size_t>(b) * chunks + chunk) * channels + c];
    s0 += v.x;
    s1 += v.y;
  }
  const float2 s = block_sum2(s0, s1);
  const float n = static_cast<float>(cg) * static_cast<float>(hw);
  const float mean = s.x / n;
  const float var = fmaxf(s.y / n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = g * cg + threadIdx.x; c < (g + 1) * cg; c += kThreads) {
    const float a = rstd * gamma[c];
    coef[static_cast<size_t>(b) * channels + c] = make_float4(a, beta[c] - mean * a, mean, rstd);
  }
}

// One block per (group, b): dbeta_b, dgamma_b of the group's channels, and
// the group means of dz gamma and dz gamma xh.
__global__ void __launch_bounds__(kThreads)
    bwd_finalize(const float2* __restrict__ partial, const float* __restrict__ gamma,
                 float* __restrict__ dgamma_b, float* __restrict__ dbeta_b,
                 float2* __restrict__ group_means, int channels, int hw, int groups, int chunks) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = channels / groups;
  float l0 = 0.f, l1 = 0.f;
  for (int c = g * cg + threadIdx.x; c < (g + 1) * cg; c += kThreads) {
    float s_dz = 0.f, s_dzxh = 0.f;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const float2 v = partial[(static_cast<size_t>(b) * chunks + chunk) * channels + c];
      s_dz += v.x;
      s_dzxh += v.y;
    }
    dbeta_b[static_cast<size_t>(b) * channels + c] = s_dz;
    dgamma_b[static_cast<size_t>(b) * channels + c] = s_dzxh;
    l0 += gamma[c] * s_dz;
    l1 += gamma[c] * s_dzxh;
  }
  const float2 s = block_sum2(l0, l1);
  if (threadIdx.x == 0) {
    const float n = static_cast<float>(cg) * static_cast<float>(hw);
    group_means[static_cast<size_t>(b) * groups + g] = make_float2(s.x / n, s.y / n);
  }
}

// (b, c, p) of the element at memory index i of a dense x.
__device__ __forceinline__ void decode(size_t i, int channels, int hw, bool channels_last, int& b,
                                       int& c, int& p) {
  const size_t per_b = static_cast<size_t>(channels) * hw;
  b = static_cast<int>(i / per_b);
  const int r = static_cast<int>(i - static_cast<size_t>(b) * per_b);
  if (channels_last) {
    p = r / channels;
    c = r - p * channels;
  } else {
    c = r / hw;
    p = r - c * hw;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_fwd(const T* __restrict__ x, const float4* __restrict__ coef, T* __restrict__ y,
              int channels, int hw, size_t total, bool channels_last) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    int b, c, p;
    decode(i, channels, hw, channels_last, b, c, p);
    const float4 k = coef[static_cast<size_t>(b) * channels + c];
    const float z = to_f32(x[i]) * k.x + k.y;
    y[i] = from_f32<T>(z * sigmoid(z));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_bwd(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ gamma,
              const float4* __restrict__ coef, const float2* __restrict__ group_means,
              T* __restrict__ dx, int channels, int hw, int groups, size_t total,
              bool channels_last, Strides ds) {
  const int cg = channels / groups;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    int b, c, p;
    decode(i, channels, hw, channels_last, b, c, p);
    const float4 k = coef[static_cast<size_t>(b) * channels + c];
    const float2 m = group_means[static_cast<size_t>(b) * groups + c / cg];
    const float v = to_f32(x[i]);
    const float z = v * k.x + k.y;
    const float s = sigmoid(z);
    const float dz = to_f32(dy[b * ds.b + c * ds.c + p * ds.p]) * s * (1.f + z * (1.f - s));
    const float xh = (v - k.z) * k.w;
    dx[i] = from_f32<T>(k.w * (dz * gamma[c] - m.x - xh * m.y));
  }
}

int apply_blocks(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T, bool kBwd>
void launch_partials(const void* x, const void* dy, const float4* coef, float2* partial,
                     int batch, int channels, int hw, int chunks, int rows, bool channels_last,
                     Strides ds, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (channels_last) {
    const dim3 grid((channels + kTileC - 1) / kTileC, chunks, batch);
    partials_channels_last<T, kBwd><<<grid, dim3(kTileC, kLanesP), 0, stream>>>(
        xt, dyt, coef, partial, channels, hw, rows, ds);
  } else {
    const dim3 grid(channels, chunks, batch);
    partials_nchw<T, kBwd><<<grid, kThreads, 0, stream>>>(xt, dyt, coef, partial, channels, hw,
                                                          rows, ds);
  }
}

template <typename T>
int forward(const void* x, const float* gamma, const float* beta, void* y, float2* partial,
            float4* coef, int batch, int channels, int hw, int groups, int chunks, int rows,
            bool channels_last, float eps, cudaStream_t stream) {
  launch_partials<T, false>(x, nullptr, nullptr, partial, batch, channels, hw, chunks, rows,
                            channels_last, Strides{0, 0, 0}, stream);
  stats_finalize<<<dim3(groups, batch), kThreads, 0, stream>>>(partial, gamma, beta, coef,
                                                               channels, hw, groups, chunks, eps);
  const size_t total = static_cast<size_t>(batch) * channels * hw;
  apply_fwd<T><<<apply_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(x), coef, static_cast<T*>(y), channels, hw, total, channels_last);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const float* gamma, const float* beta, const void* dy, void* dx,
             float* dgamma_b, float* dbeta_b, float2* partial, float4* coef,
             float2* group_means, int batch, int channels, int hw, int groups, int chunks,
             int rows, bool channels_last, Strides ds, float eps, cudaStream_t stream) {
  launch_partials<T, false>(x, nullptr, nullptr, partial, batch, channels, hw, chunks, rows,
                            channels_last, Strides{0, 0, 0}, stream);
  stats_finalize<<<dim3(groups, batch), kThreads, 0, stream>>>(partial, gamma, beta, coef,
                                                               channels, hw, groups, chunks, eps);
  launch_partials<T, true>(x, dy, coef, partial, batch, channels, hw, chunks, rows,
                           channels_last, ds, stream);
  bwd_finalize<<<dim3(groups, batch), kThreads, 0, stream>>>(
      partial, gamma, dgamma_b, dbeta_b, group_means, channels, hw, groups, chunks);
  const size_t total = static_cast<size_t>(batch) * channels * hw;
  apply_bwd<T><<<apply_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, coef, group_means,
      static_cast<T*>(dx), channels, hw, groups, total, channels_last, ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// partial: (batch, chunks, channels) float2 scratch; coef: (batch, channels)
// float4 scratch; chunks * rows >= hw > (chunks - 1) * rows. Returns the
// launches' cudaError_t.
int fea_group_norm_silu_fwd(const void* x, const float* gamma, const float* beta, void* y,
                            void* partial, void* coef, int batch, int channels, int hw,
                            int groups, int chunks, int rows, int channels_last, int bf16,
                            float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(partial);
  auto k = static_cast<float4*>(coef);
  if (bf16) {
    return forward<__nv_bfloat16>(x, gamma, beta, y, p, k, batch, channels, hw, groups, chunks,
                                  rows, channels_last != 0, eps, s);
  }
  return forward<float>(x, gamma, beta, y, p, k, batch, channels, hw, groups, chunks, rows,
                        channels_last != 0, eps, s);
}

// As the forward, plus dy's strides (batch, channel, flattened position) in
// elements, dgamma_b / dbeta_b (batch, channels) f32 outputs and
// group_means (batch, groups) float2 scratch.
int fea_group_norm_silu_bwd(const void* x, const float* gamma, const float* beta,
                            const void* dy, void* dx, float* dgamma_b, float* dbeta_b,
                            void* partial, void* coef, void* group_means, int batch,
                            int channels, int hw, int groups, int chunks, int rows,
                            int channels_last, long long dy_sb, long long dy_sc,
                            long long dy_sp, int bf16, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(partial);
  auto k = static_cast<float4*>(coef);
  auto m = static_cast<float2*>(group_means);
  const Strides ds{dy_sb, dy_sc, dy_sp};
  if (bf16) {
    return backward<__nv_bfloat16>(x, gamma, beta, dy, dx, dgamma_b, dbeta_b, p, k, m, batch,
                                   channels, hw, groups, chunks, rows, channels_last != 0, ds,
                                   eps, s);
  }
  return backward<float>(x, gamma, beta, dy, dx, dgamma_b, dbeta_b, p, k, m, batch, channels,
                         hw, groups, chunks, rows, channels_last != 0, ds, eps, s);
}

const char* fea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
