// Fused GroupNorm + affine + SiLU, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels fea_tpu/ops/fused_norm.py:_fwd_kernel (launched
// by _gn_fwd) and :_bwd_kernel (launched by _gn_bwd). For x (B, C, HW) in
// contiguous NCHW memory, the layout every model path of the port gives it
// (its attention and space-to-depth steps return contiguous NCHW, and the
// convolutions keep their input's layout), and G groups of C/G channels:
//     forward   z = (x - mean_g) * rstd_g * gamma + beta,  y = z * sigmoid(z)
//     backward  dz = dy * s * (1 + z (1 - s)),  s = sigmoid(z)
//               dbeta[c] = sum_b,p dz,  dgamma[c] = sum_b,p dz * xh
//               dx = rstd_g * (dz gamma - mean_g(dz gamma) - xh mean_g(dz gamma xh))
// with xh = (x - mean_g) * rstd_g, f32 statistics whatever the input type,
// var = max(E[x^2] - mean^2, 0) as flax computes it, and y, dx in x's type.
// dgamma and dbeta are f32, summed over each batch element's positions and
// then over B in order, as the TPU kernel's per-batch partials are summed
// by its caller. dy may have any strides
// for which its spatial dims flatten (stride_h == W * stride_w): a channel
// slice of a concatenation's gradient is such a view.
//
// What bounds it on this card: memory. It does a few tens of FLOPs per
// element against 4-12 bytes of it. At the decoder's stage shapes x does
// not fit the 50 MB L2, so every pass over it comes from HBM.
//
// Forward: three launches.
//   1. stats partials: grid (channel, HW chunk, b); each block sums one
//      chunk of one channel's positions over 256 threads into an f32 buffer
//      (B, chunks, C), in a fixed order and without atomics.
//   2. finalize: one block per (group, b) writes per-channel coefficients
//      coef[b, c] = (a, b, mean, rstd) with z = x a + b.
//   3. apply: an elementwise pass in memory order.
// It reads x twice and writes y once. coef (B * C * 16 bytes) is kept for
// the backward.
//
// Backward: two launches over the forward's coef; the statistics are not
// recomputed (fea_tpu's backward recomputes them: here the forward's are
// saved, the same numbers from the same kernel).
//   1. dz partials: grid (channel, HW chunk, b). A block owns one channel,
//      whose coefficients it keeps in registers, and its threads walk the
//      chunk's positions V at a time: vectors of V neighbouring elements
//      (16 bytes, 4 f32 or 8 bf16, where HW, dy's strides and the pointers
//      allow; else 2 or 1), neighbouring threads on neighbouring vectors.
//      Sums of dz and dz xh go from registers to shared memory to one
//      partial per (b, chunk, channel). The last block of each b to finish (a
//      __threadfence and an atomic ticket per b, which that block resets to
//      0) reduces the partials in chunk order and writes dbeta_b, dgamma_b
//      and the two group means; the last of those B blocks (one more
//      ticket) sums dbeta_b and dgamma_b over b in order into dbeta and
//      dgamma. Deterministic, whichever block is last, and no launch of
//      its own.
//   2. dx apply: the same thread layout, coefficients, gamma and the group
//      means in registers (no per-element index division or gather), walked
//      in the reverse block order of launch 1 and each chunk backwards, so
//      that it first reads the part of x and dy that launch 1 read last,
//      which is still in L2. It is a programmatic dependent
//      launch: its blocks start as launch 1's retire and load their
//      coefficients, then wait (griddepcontrol.wait) for launch 1's results.
// The sigmoid takes __expf and an approximate divide (2 ulp each): dx moves
// by under 1e-6 of its largest element against expf and a true divide.
// It reads x and dy twice and writes dx once: 5/3 of the bytes the bound
// counts. Fewer passes need x and dy kept on chip across a cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ float sigmoid_fast(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

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

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_partials(const T* __restrict__ x, float2* __restrict__ partial, int channels,
                        int hw, int rows) {
  const int c = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int p_end = min(hw, (chunk + 1) * rows);
  const T* xc = x + (static_cast<size_t>(b) * channels + c) * hw;
  float a0 = 0.f, a1 = 0.f;
  for (int p = chunk * rows + threadIdx.x; p < p_end; p += kThreads) {
    const float v = to_f32(xc[p]);
    a0 += v;
    a1 += v * v;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_fwd(const T* __restrict__ x, const float4* __restrict__ coef, T* __restrict__ y,
              int channels, int hw, size_t total) {
  const size_t per_b = static_cast<size_t>(channels) * hw;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t b = i / per_b;
    const int r = static_cast<int>(i - b * per_b);  // 32-bit from here on
    const int c = r / hw;
    const float4 k = coef[b * channels + c];
    const float z = to_f32(x[i]) * k.x + k.y;
    y[i] = from_f32<T>(z * sigmoid(z));
  }
}

int apply_blocks(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
int forward(const void* x, const float* gamma, const float* beta, void* y, float2* partial,
            float4* coef, int batch, int channels, int hw, int groups, int chunks, int rows,
            float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  stats_partials<T><<<dim3(channels, chunks, batch), kThreads, 0, stream>>>(xt, partial, channels,
                                                                          hw, rows);
  stats_finalize<<<dim3(groups, batch), kThreads, 0, stream>>>(partial, gamma, beta, coef,
                                                               channels, hw, groups, chunks, eps);
  const size_t total = static_cast<size_t>(batch) * channels * hw;
  apply_fwd<T><<<apply_blocks(total), kThreads, 0, stream>>>(xt, coef, static_cast<T*>(y),
                                                             channels, hw, total);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- backward

// V elements of x's type at p (aligned to V elements) as f32, and back.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x, out[1] = r.y, out[2] = r.z, out[3] = r.w;
  } else if constexpr (V == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    out[0] = r.x, out[1] = r.y;
  } else {
    out[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}
// bf16 pairs travel as 32-bit words, the first element in the low half
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = __bfloat162float(*p);
  } else {
    uint32_t w[V / 2];
    if constexpr (V == 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (V == 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x, w[1] = r.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(in[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

struct BwdArgs {
  const void* x;
  const void* dy;
  void* dx;
  const float* gamma;
  const float4* coef;        // (B, C): a, b, mean, rstd from the forward
  float2* partial;           // (B, chunks, C): sums of dz and dz xh
  float* dgamma_b;           // (B, C)
  float* dbeta_b;            // (B, C)
  float* dgamma;             // (C,): dgamma_b summed over b
  float* dbeta;              // (C,)
  float2* group_means;       // (B, G): mean_g(dz gamma), mean_g(dz gamma xh)
  unsigned int* tickets;     // (B + 1,): 0 between launches
  int channels, hw, groups, rows;
  long long dy_sb, dy_sc, dy_sp;
};

// The block that reaches a ticket's last count: every block bumps
// tickets[i] once after its writes; the one that makes it `count` sees all
// their writes (read them with __ldcg) and resets the ticket to 0.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket, unsigned int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == count - 1;
    if (last) *ticket = 0;  // no other block touches it again in this launch
  }
  __syncthreads();
  return last;
}

// dz = dy s (1 + z (1 - s)) of one element, and its xh
__device__ __forceinline__ float2 dz_xh(float x, float g, float4 k) {
  const float z = x * k.x + k.y;
  const float s = sigmoid_fast(z);
  return make_float2(g * s * (1.f + z * (1.f - s)), (x - k.z) * k.w);
}

// Once every block of batch element b has written its partials: the last
// one sums them in chunk order into dbeta_b, dgamma_b and the group means;
// the last of the B such blocks sums those over b into dbeta, dgamma.
__device__ void finalize(const BwdArgs& a, int b) {
  if (!last_to_arrive(a.tickets + b, gridDim.x * gridDim.y)) return;
  __shared__ float2 lanes[kThreads];
  const int channels = a.channels, chunks = gridDim.y, tid = threadIdx.x;
  const int fl = max(1, kThreads / channels);  // chunk lanes per channel
  for (int base = 0; base < channels; base += kThreads / fl) {
    const int c = base + tid / fl, j = tid % fl;
    const bool mine = c < channels && tid / fl < kThreads / fl;
    float2 s = make_float2(0.f, 0.f);
    if (mine) {
#pragma unroll 8
      for (int q = j; q < chunks; q += fl) {
        const float2 v = __ldcg(a.partial + (static_cast<size_t>(b) * chunks + q) * channels + c);
        s.x += v.x;
        s.y += v.y;
      }
    }
    lanes[tid] = s;
    __syncthreads();
    if (mine && j == 0) {
      for (int i = 1; i < fl; ++i) {
        s.x += lanes[tid + i].x;
        s.y += lanes[tid + i].y;
      }
      __stcg(a.dbeta_b + static_cast<size_t>(b) * channels + c, s.x);
      __stcg(a.dgamma_b + static_cast<size_t>(b) * channels + c, s.y);
    }
    __syncthreads();
  }
  const int cg = channels / a.groups;
  const float n = static_cast<float>(cg) * static_cast<float>(a.hw);
  const int warp = tid >> 5, wl = tid & 31;
  for (int g = warp; g < a.groups; g += kThreads / 32) {
    float l0 = 0.f, l1 = 0.f;
    for (int c = g * cg + wl; c < (g + 1) * cg; c += 32) {
      const size_t i = static_cast<size_t>(b) * channels + c;
      l0 += a.gamma[c] * __ldcg(a.dbeta_b + i);
      l1 += a.gamma[c] * __ldcg(a.dgamma_b + i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (wl == 0) a.group_means[static_cast<size_t>(b) * a.groups + g] = make_float2(l0 / n, l1 / n);
  }

  if (!last_to_arrive(a.tickets + gridDim.z, gridDim.z)) return;
  for (int c = tid; c < channels; c += kThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int i = 0; i < static_cast<int>(gridDim.z); ++i) {
      s0 += __ldcg(a.dbeta_b + static_cast<size_t>(i) * channels + c);
      s1 += __ldcg(a.dgamma_b + static_cast<size_t>(i) * channels + c);
    }
    a.dbeta[c] = s0;
    a.dgamma[c] = s1;
  }
}

// One block per (channel, chunk, b): its coefficients are the block's, and
// its threads walk the chunk's positions V at a time (rows is a multiple of
// V, and so is HW where V > 1).

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bwd_partials(BwdArgs a) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const float4 k = a.coef[static_cast<size_t>(b) * a.channels + c];
  const T* xc = static_cast<const T*>(a.x) + (static_cast<size_t>(b) * a.channels + c) * a.hw;
  const T* dyc = static_cast<const T*>(a.dy) + b * a.dy_sb + c * a.dy_sc;
  const int p_end = min(a.hw, (chunk + 1) * a.rows);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int p = chunk * a.rows + threadIdx.x * V; p < p_end; p += kThreads * V) {
    float xv[V], gv[V];
    load_vec<V>(xc + p, xv);
    load_vec<V>(dyc + p * a.dy_sp, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 d = dz_xh(xv[j], gv[j], k);
      s0 += d.x;
      s1 += d.x * d.y;
    }
  }
  const float2 s = block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    a.partial[(static_cast<size_t>(b) * gridDim.y + chunk) * a.channels + c] = s;
  }
  finalize(a, b);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bwd_apply(BwdArgs a) {
  const int c = gridDim.x - 1 - blockIdx.x;
  const int chunk = gridDim.y - 1 - blockIdx.y, b = gridDim.z - 1 - blockIdx.z;
  const float4 k = a.coef[static_cast<size_t>(b) * a.channels + c];
  const float gam = a.gamma[c];
  asm volatile("griddepcontrol.wait;" ::: "memory");  // launch 1 has finished
  const float2 m = a.group_means[static_cast<size_t>(b) * a.groups + c / (a.channels / a.groups)];
  const size_t x_off = (static_cast<size_t>(b) * a.channels + c) * a.hw;
  const T* xc = static_cast<const T*>(a.x) + x_off;
  T* dxc = static_cast<T*>(a.dx) + x_off;
  const T* dyc = static_cast<const T*>(a.dy) + b * a.dy_sb + c * a.dy_sc;
  constexpr int kStep = kThreads * V;
  const int p0 = chunk * a.rows + threadIdx.x * V, p_end = min(a.hw, (chunk + 1) * a.rows);
  if (p0 >= p_end) return;
#pragma unroll 4
  for (int p = p0 + (p_end - 1 - p0) / kStep * kStep; p >= p0; p -= kStep) {
    float xv[V], gv[V], out[V];
    load_vec<V>(xc + p, xv);
    load_vec<V>(dyc + p * a.dy_sp, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 d = dz_xh(xv[j], gv[j], k);
      out[j] = k.w * (d.x * gam - m.x - d.y * m.y);
    }
    store_vec<V>(dxc + p, out);
  }
}

template <typename T, int V>
int backward_v(const BwdArgs& a, int batch, int chunks, cudaStream_t stream) {
  const dim3 grid(a.channels, chunks, batch);
  bwd_partials<T, V><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, bwd_apply<T, V>, a));
}

template <typename T>
int backward(const BwdArgs& a, int batch, int chunks, int vec, cudaStream_t stream) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) return backward_v<T, 8>(a, batch, chunks, stream);
      break;
    case 4:
      return backward_v<T, 4>(a, batch, chunks, stream);
    case 2:
      return backward_v<T, 2>(a, batch, chunks, stream);
    case 1:
      return backward_v<T, 1>(a, batch, chunks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// partial: (batch, chunks, channels) float2 scratch; coef: (batch,
// channels) float4 output, kept for the backward; chunks * rows >= hw >
// (chunks - 1) * rows. Returns the launches' cudaError_t.
int fea_group_norm_silu_fwd(const void* x, const float* gamma, const float* beta, void* y,
                            void* partial, void* coef, int batch, int channels, int hw,
                            int groups, int chunks, int rows, int bf16, float eps,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(partial);
  auto k = static_cast<float4*>(coef);
  if (bf16) {
    return forward<__nv_bfloat16>(x, gamma, beta, y, p, k, batch, channels, hw, groups, chunks,
                                  rows, eps, s);
  }
  return forward<float>(x, gamma, beta, y, p, k, batch, channels, hw, groups, chunks, rows, eps,
                        s);
}

// x and coef as the forward's; dy's strides (batch, channel, flattened
// position) in elements; dx contiguous NCHW; dgamma / dbeta (channels,) f32
// outputs; dgamma_b / dbeta_b (batch, channels) f32, partial (batch,
// chunks, channels) float2 and group_means (batch, groups) float2 scratch;
// tickets (batch + 1,) zeroed words, this call's own, left zeroed. vec is 8
// (bf16 only), 4, 2 or 1 positions, and where above 1 it divides hw and
// rows, dy's position stride is 1, its other strides are multiples of vec
// and x, dy, dx are aligned to vec elements.
int fea_group_norm_silu_bwd(const void* x, const float* gamma, const void* coef, const void* dy,
                            void* dx, float* dgamma, float* dbeta, float* dgamma_b,
                            float* dbeta_b, void* partial, void* group_means, void* tickets,
                            int batch, int channels, int hw, int groups, int chunks, int rows,
                            int vec, long long dy_sb, long long dy_sc, long long dy_sp,
                            int bf16, void* stream) {
  const BwdArgs a{x,
                  dy,
                  dx,
                  gamma,
                  static_cast<const float4*>(coef),
                  static_cast<float2*>(partial),
                  dgamma_b,
                  dbeta_b,
                  dgamma,
                  dbeta,
                  static_cast<float2*>(group_means),
                  static_cast<unsigned int*>(tickets),
                  channels,
                  hw,
                  groups,
                  rows,
                  dy_sb,
                  dy_sc,
                  dy_sp};
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? backward<__nv_bfloat16>(a, batch, chunks, vec, s)
              : backward<float>(a, batch, chunks, vec, s);
}

const char* fea_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
