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
// Forward: two routes, chosen on the host from the shape, the type and the
// device's limits (fused_norm.py:forward_route). Both write coef[b, c] =
// (a, b, mean, rstd) with z = x a + b (B * C * 16 bytes), kept for the
// backward, and both sum in a fixed order without floating-point atomics.
//   cluster: x is read from HBM once. In NCHW the C/G channels of one
//      (b, group) are one contiguous slab, and a slab is all that one mean
//      and rstd depend on. A thread-block cluster of K blocks (K up to 16)
//      takes one slab; each block copies its 1/K share into shared memory
//      with 16-byte cp.async in four commit groups and sums x and x^2 in
//      f32 as each group lands (a thread reads back only what it copied, so
//      no block barrier stands between copy and sum). The blocks leave
//      their sums in shared memory, meet at the cluster barrier, and each
//      adds the K partial sums from the others' shared memory in rank
//      order, so all hold the same mean and rstd. Each block then
//      normalises its share out of shared memory and writes y with 16-byte
//      stores; rank 0 writes the group's coef. One launch, and exactly the
//      bytes the bound counts. With 64 KiB a block, three blocks share an
//      SM and one's copy overlaps another's store. Where 1/16 of a slab is
//      more than that (the 2 MiB f32 slabs of the first stage: 128 KiB), a
//      block keeps 96 KiB, so that two still share an SM, and reads the
//      rest twice, the second time soon after the first and mostly from L2.
//   two-pass: for slabs of which a cluster's shared memory keeps too
//      little and for HW or pointers that forbid 16-byte vectors. Launch 1, grid (channel,
//      HW chunk, b): a block sums one chunk of one channel V positions at a
//      time (V elements of 16 bytes where HW and x's alignment allow, else
//      2 or 1) into one partial per (b, chunk, channel); the last block of
//      each b to finish (an atomic ticket per b, this call's own, which
//      that block resets to 0) reduces the partials in a fixed order and
//      writes coef[b]. Launch 2 is a programmatic dependent launch with
//      the same thread layout, the block's two coefficients in registers,
//      walking the blocks and each chunk in reverse, so that it first
//      reads what launch 1 read last and the L2 still holds. It reads x
//      twice: 3/2 of the bytes the bound counts.
// Both use __expf and an approximate divide in the sigmoid, as the backward
// does when it recomputes z's sigmoid.
//
// Modulated forward (no backward: it serves the calls that need no
// gradient): y = silu(z (1 + scale) + shift), each kernel above
// instantiated once more per mode (Mod). Per channel, scale and shift are
// (B, C), at a batch stride of their own, and fold into the coefficients
// where they are written, a' = a (1 + s), b' = b (1 + s) + t: the passes
// over x do not change. Per pixel, scale and shift are contiguous (B, C,
// H, W) like x and the pass that writes y reads them beside x, in the same
// vectors and order (on the cluster route x from shared memory, scale and
// shift from device memory). gamma and beta may be null there: the norm
// without an affine (1 and 0).
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

#include <type_traits>

namespace {

constexpr int kThreads = 256;         // a block of the two-pass kernels
constexpr int kClusterThreads = 512;  // a block of the cluster kernel

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

// A dependent of the launch before it in the stream: its blocks may start
// as that launch's blocks retire, and wait for its results at
// griddepcontrol.wait.
template <typename Args>
int launch_dependent(void (*kernel)(Args), dim3 grid, const Args& a, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

// f(std::integral_constant<int, vec>) for vec 8 (2-byte T only), 4, 2 or 1
template <typename T, typename F>
int with_vector(int vec, F&& f) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) return f(std::integral_constant<int, 8>{});
      break;
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 1:
      return f(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- forward

// z's modulation before the SiLU: none, per (b, c), or per element
enum class Mod { none, channel, pixel };

struct FwdArgs {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  float4* coef;           // (B, C): a, b, mean, rstd, kept for the backward
  float2* partial;        // two-pass: (B, chunks, C) sums of x and x^2
  unsigned int* tickets;  // two-pass: (B,), 0 between launches
  int channels, hw, groups;
  int rows;   // two-pass: positions in a chunk
  int share;  // cluster: elements of the slab that each block takes,
  int held;   // and how many of them it keeps in shared memory
  float eps;
  const void* scale;  // Mod::channel: (B, C) in x's type at batch strides
  const void* shift;  // scale_sb, shift_sb; Mod::pixel: as x
  long long scale_sb, shift_sb;
};

// mean and rstd of n elements from their sum and sum of squares
__device__ __forceinline__ float2 mean_rstd(float s0, float s1, float n, float eps) {
  const float mean = s0 / n;
  const float var = fmaxf(s1 / n - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// (rstd gamma, beta - mean rstd gamma, mean, rstd)
__device__ __forceinline__ float4 coefficients(float2 m, float gamma, float beta) {
  const float a = m.y * gamma;
  return make_float4(a, beta - m.x * a, m.x, m.y);
}

// The coefficients of channel c of batch element b from the group's mean
// and rstd; under Mod::channel with the modulation folded in, so that
// x a + b = (x a0 + b0) (1 + s) + t
template <typename T, Mod M>
__device__ __forceinline__ float4 channel_coef(const FwdArgs& a, float2 m, int b, int c) {
  if constexpr (M == Mod::none) {
    return coefficients(m, a.gamma[c], a.beta[c]);
  } else {
    float4 k = coefficients(m, a.gamma ? a.gamma[c] : 1.f, a.beta ? a.beta[c] : 0.f);
    if constexpr (M == Mod::channel) {
      float s[1], t[1];
      load_vec<1>(static_cast<const T*>(a.scale) + b * a.scale_sb + c, s);
      load_vec<1>(static_cast<const T*>(a.shift) + b * a.shift_sb + c, t);
      const float f = s[0] + 1.f;
      k.x *= f;
      k.y = k.y * f + t[0];
    }
    return k;
  }
}

// y = silu(x a + b) of V elements
template <int V>
__device__ __forceinline__ void silu_affine(const float (&x)[V], float a, float b,
                                            float (&y)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float z = x[j] * a + b;
    y[j] = z * sigmoid_fast(z);
  }
}

// y = silu(x a + b) of the V elements at x, under Mod::pixel silu((x a +
// b) (1 + s) + t) with s and t the V elements at scale + i and shift + i
template <typename T, int V, Mod M>
__device__ __forceinline__ void emit_vec(const T* x, const FwdArgs& a, size_t i, float2 k,
                                         T* y) {
  float xv[V], out[V];
  load_vec<V>(x, xv);
  if constexpr (M == Mod::pixel) {
    float s[V], t[V];
    load_vec<V>(static_cast<const T*>(a.scale) + i, s);
    load_vec<V>(static_cast<const T*>(a.shift) + i, t);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = (xv[j] * k.x + k.y) * (s[j] + 1.f) + t[j];
      out[j] = z * sigmoid_fast(z);
    }
  } else {
    silu_affine<V>(xv, k.x, k.y, out);
  }
  store_vec<V>(y, out);
}

template <int V>
__device__ __forceinline__ void add_sums(const float (&x)[V], float& s0, float& s1) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s0 += x[j];
    s1 += x[j] * x[j];
  }
}

// ------------------------------------------------- forward, cluster route

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster's barrier, in its two halves: every thread of every block
// arrives once and waits once per phase.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// *local as the block of rank `rank` in this cluster holds it
__device__ __forceinline__ float2 cluster_load(const float2* local, unsigned rank) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// bytes of the per-channel (a, b) table ahead of the data in dynamic
// shared memory (fused_norm.py:cluster_plans counts the same)
__host__ __device__ constexpr int table_bytes(int cg) { return (cg * 8 + 15) & ~15; }

constexpr int kCopyGroups = 4;

// Grid (K, groups, B) in clusters of (K, 1, 1): cluster (g, b) takes the
// slab of group g of batch element b, and the block of rank r its elements
// [r share, (r + 1) share). share is a multiple of V = 16 bytes of T and so
// are held and hw; x is aligned to 16 bytes. The block keeps the first
// `held` elements of its share in shared memory; what is beyond them it
// reads twice, for the sums and again, soon after and so mostly from L2,
// for y. Thread t owns the vectors t, t + 512, ... of the share in every
// pass.
template <typename T, Mod M>
__global__ void __launch_bounds__(kClusterThreads) fwd_cluster(FwdArgs a) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 sums;   // this block's, read by the whole cluster
  __shared__ float2 group;  // mean, rstd
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, ranks = gridDim.x, g = blockIdx.y, b = blockIdx.z;
  const int cg = a.channels / a.groups;
  float2* table = reinterpret_cast<float2*>(smem);
  T* data = reinterpret_cast<T*>(smem + table_bytes(cg));
  const int e0 = rank * a.share;  // within the slab
  const size_t off = (static_cast<size_t>(b) * a.channels + g * cg) * a.hw + e0;
  const T* src = static_cast<const T*>(a.x) + off;
  T* dst = static_cast<T*>(a.y) + off;
  const int nvec = a.share / V, nheld = a.held / V;
  // vectors in a commit group: a multiple of the block, so that a thread's
  // vectors are t, t + 512, ... across the groups
  const int per_group = (nheld + kCopyGroups * kClusterThreads - 1) /
                        (kCopyGroups * kClusterThreads) * kClusterThreads;
#pragma unroll
  for (int s = 0; s < kCopyGroups; ++s) {
    const int end = min(nheld, (s + 1) * per_group);
    for (int v = s * per_group + tid; v < end; v += kClusterThreads) {
      cp_async16(data + v * V, src + v * V);
    }
    cp_async_commit();
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int v = nheld + tid; v < nvec; v += kClusterThreads) {  // while the copies land
    float xv[V];
    load_vec<V>(src + v * V, xv);
    add_sums<V>(xv, s0, s1);
  }
  auto add_group = [&](int s) {
    const int end = min(nheld, (s + 1) * per_group);
    for (int v = s * per_group + tid; v < end; v += kClusterThreads) {
      float xv[V];
      load_vec<V>(data + v * V, xv);
      add_sums<V>(xv, s0, s1);
    }
  };
  cp_async_wait<3>();
  add_group(0);
  cp_async_wait<2>();
  add_group(1);
  cp_async_wait<1>();
  add_group(2);
  cp_async_wait<0>();
  add_group(3);
  const float2 mine = block_sum2(s0, s1);
  if (tid == 0) sums = mine;
  cluster_arrive();
  cluster_wait();  // every block's sums are written
  if (tid < 32) {
    const float2 v = tid < ranks ? cluster_load(&sums, tid) : make_float2(0.f, 0.f);
    float t0 = 0.f, t1 = 0.f;
    for (int r = 0; r < ranks; ++r) {  // in rank order, the same in every block
      t0 += __shfl_sync(0xffffffffu, v.x, r);
      t1 += __shfl_sync(0xffffffffu, v.y, r);
    }
    if (tid == 0) {
      group = mean_rstd(t0, t1, static_cast<float>(cg) * static_cast<float>(a.hw), a.eps);
    }
  }
  cluster_arrive();  // this block has read the others' sums; waited for at the end
  __syncthreads();
  const float2 m = group;
  for (int c = tid; c < cg; c += kClusterThreads) {
    const float4 k = channel_coef<T, M>(a, m, b, g * cg + c);
    table[c] = make_float2(k.x, k.y);
    if (rank == 0) a.coef[static_cast<size_t>(b) * a.channels + g * cg + c] = k;
  }
  __syncthreads();
  // y of the vector v of the share, whose x is at p
  auto emit = [&](const T* p, int v) {
    emit_vec<T, V, M>(p, a, off + v * V, table[(e0 + v * V) / a.hw], dst + v * V);
  };
#pragma unroll 4
  for (int v = nheld + tid; v < nvec; v += kClusterThreads) emit(src + v * V, v);
#pragma unroll 4
  for (int v = tid; v < nheld; v += kClusterThreads) emit(data + v * V, v);
  cluster_wait();  // no block leaves while another may still read its sums
}

struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int cluster, int groups, int batch, int smem, cudaStream_t stream) : cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster, groups, batch);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// The kernel allowed `smem` bytes of dynamic shared memory and, above the
// portable 8, this cluster size.
template <typename T, Mod M>
cudaError_t allow_cluster(int cluster, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(fwd_cluster<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(fwd_cluster<T, M>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  return err;
}

template <typename T, Mod M>
int forward_cluster(const FwdArgs& a, int batch, int cluster, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_cluster<T, M>(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch(cluster, a.groups, batch, smem, stream);
  return static_cast<int>(cudaLaunchKernelEx(&launch.cfg, fwd_cluster<T, M>, a));
}

// Clusters of this size and shared memory that the card holds at once
template <typename T>
int resident_clusters(int cluster, int smem, int* count) {
  const cudaError_t err = allow_cluster<T, Mod::none>(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch(cluster, 1, 1, smem, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, fwd_cluster<T, Mod::none>, &launch.cfg));
}

// ------------------------------------------------ forward, two-pass route

// One block per (channel, chunk, b), its threads on the chunk's positions V
// at a time (rows is a multiple of V, and so is HW where V > 1). The last
// block of batch element b to finish sums b's partials, a warp per group
// and in a fixed order, and writes coef[b].
template <typename T, int V, Mod M>
__global__ void __launch_bounds__(kThreads) fwd_stats(FwdArgs a) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const T* xc = static_cast<const T*>(a.x) + (static_cast<size_t>(b) * a.channels + c) * a.hw;
  const int p_end = min(a.hw, (chunk + 1) * a.rows);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int p = chunk * a.rows + threadIdx.x * V; p < p_end; p += kThreads * V) {
    float xv[V];
    load_vec<V>(xc + p, xv);
    add_sums<V>(xv, s0, s1);
  }
  const float2 s = block_sum2(s0, s1);
  const int chunks = gridDim.y;
  if (threadIdx.x == 0) {
    a.partial[(static_cast<size_t>(b) * chunks + chunk) * a.channels + c] = s;
  }
  if (!last_to_arrive(a.tickets + b, gridDim.x * gridDim.y)) return;
  const int cg = a.channels / a.groups;
  const float n = static_cast<float>(cg) * static_cast<float>(a.hw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < a.groups; g += kThreads / 32) {
    float t0 = 0.f, t1 = 0.f;
    for (int i = lane; i < cg * chunks; i += 32) {
      const size_t at = (static_cast<size_t>(b) * chunks + i / cg) * a.channels + g * cg + i % cg;
      const float2 v = __ldcg(a.partial + at);
      t0 += v.x;
      t1 += v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t0 += __shfl_xor_sync(0xffffffffu, t0, off);
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
    }
    const float2 m = mean_rstd(t0, t1, n, a.eps);
    for (int ch = g * cg + lane; ch < (g + 1) * cg; ch += 32) {
      a.coef[static_cast<size_t>(b) * a.channels + ch] = channel_coef<T, M>(a, m, b, ch);
    }
  }
}

// The same grid walked backwards, and each chunk from its end.
template <typename T, int V, Mod M>
__global__ void __launch_bounds__(kThreads) fwd_apply(FwdArgs a) {
  const int c = gridDim.x - 1 - blockIdx.x;
  const int chunk = gridDim.y - 1 - blockIdx.y, b = gridDim.z - 1 - blockIdx.z;
  const size_t off = (static_cast<size_t>(b) * a.channels + c) * a.hw;
  const T* xc = static_cast<const T*>(a.x) + off;
  T* yc = static_cast<T*>(a.y) + off;
  constexpr int kStep = kThreads * V;
  const int p0 = chunk * a.rows + threadIdx.x * V, p_end = min(a.hw, (chunk + 1) * a.rows);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // fwd_stats has finished
  const float4 k = __ldcg(a.coef + static_cast<size_t>(b) * a.channels + c);
  if (p0 >= p_end) return;
#pragma unroll 4
  for (int p = p0 + (p_end - 1 - p0) / kStep * kStep; p >= p0; p -= kStep) {
    emit_vec<T, V, M>(xc + p, a, off + p, make_float2(k.x, k.y), yc + p);
  }
}

template <typename T, int V, Mod M>
int forward_two_pass_v(const FwdArgs& a, int batch, int chunks, cudaStream_t stream) {
  const dim3 grid(a.channels, chunks, batch);
  fwd_stats<T, V, M><<<grid, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_dependent(fwd_apply<T, V, M>, grid, a, stream);
}

template <typename T, Mod M>
int forward_two_pass(const FwdArgs& a, int batch, int chunks, int vec, cudaStream_t stream) {
  return with_vector<T>(vec, [&](auto v) {
    return forward_two_pass_v<T, decltype(v)::value, M>(a, batch, chunks, stream);
  });
}

template <Mod M>
int forward(const FwdArgs& a, int batch, int cluster, int smem, int chunks, int vec, int bf16,
            cudaStream_t stream) {
  if (bf16) {
    return cluster > 0 ? forward_cluster<__nv_bfloat16, M>(a, batch, cluster, smem, stream)
                       : forward_two_pass<__nv_bfloat16, M>(a, batch, chunks, vec, stream);
  }
  return cluster > 0 ? forward_cluster<float, M>(a, batch, cluster, smem, stream)
                     : forward_two_pass<float, M>(a, batch, chunks, vec, stream);
}

// The forward's arguments; scale and shift as FwdArgs has them
FwdArgs forward_args(const void* x, const float* gamma, const float* beta, void* y, void* coef,
                     void* partial, void* tickets, int channels, int hw, int groups,
                     int cluster, int smem, int rows, int bf16, float eps, const void* scale,
                     const void* shift, long long scale_sb, long long shift_sb) {
  const int cg = channels / groups;
  const int share = cluster > 0 ? cg * hw / cluster : 0;
  const int held = cluster > 0 ? (smem - table_bytes(cg)) / (bf16 ? 2 : 4) : 0;
  return FwdArgs{x,
                 y,
                 gamma,
                 beta,
                 static_cast<float4*>(coef),
                 static_cast<float2*>(partial),
                 static_cast<unsigned int*>(tickets),
                 channels,
                 hw,
                 groups,
                 rows,
                 share,
                 held < share ? held : share,
                 eps,
                 scale,
                 shift,
                 scale_sb,
                 shift_sb};
}

// --------------------------------------------------------------- backward

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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_dependent(bwd_apply<T, V>, grid, a, stream);
}

template <typename T>
int backward(const BwdArgs& a, int batch, int chunks, int vec, cudaStream_t stream) {
  return with_vector<T>(vec, [&](auto v) {
    return backward_v<T, decltype(v)::value>(a, batch, chunks, stream);
  });
}

}  // namespace

extern "C" {

// y and coef (batch, channels) float4 are the outputs. cluster > 0 takes
// the cluster route: (channels / groups) * hw elements, a multiple of
// cluster * 16 bytes, split over clusters of that many blocks, each with
// `smem` bytes of dynamic shared memory (the (a, b) table of channels /
// groups float2, rounded up to 16 bytes, then a multiple of 16 bytes: as
// much of its share of the slab as it keeps there, all of it or less); hw
// is a multiple of 16 bytes of elements and x is aligned to 16 bytes. cluster
// == 0 takes the two-pass route: partial is (batch, chunks, channels)
// float2 scratch, tickets (batch,) zeroed words, this call's own, left
// zeroed; chunks * rows >= hw > (chunks - 1) * rows; vec as the backward's,
// for x and y. Returns the launches' cudaError_t.
int fea_group_norm_silu_fwd(const void* x, const float* gamma, const float* beta, void* y,
                            void* coef, void* partial, void* tickets, int batch, int channels,
                            int hw, int groups, int cluster, int smem, int chunks, int rows,
                            int vec, int bf16, float eps, void* stream) {
  const FwdArgs a = forward_args(x, gamma, beta, y, coef, partial, tickets, channels, hw, groups,
                                 cluster, smem, rows, bf16, eps, nullptr, nullptr, 0, 0);
  return forward<Mod::none>(a, batch, cluster, smem, chunks, vec, bf16,
                            static_cast<cudaStream_t>(stream));
}

// y = silu((GroupNorm(x) gamma + beta) (1 + scale) + shift), by the routes
// and with the arguments of fea_group_norm_silu_fwd; gamma and beta may
// both be null (no affine). mode 1: scale and shift (batch, channels) in
// x's type, element (b, c) at b * scale_sb + c (shift_sb); mode 2: scale
// and shift contiguous like x and, where vec is above 1 or the cluster
// route is taken, aligned to vec elements as x is. coef is written as the
// forward writes it, with the per-channel modulation folded into (a, b).
int fea_group_norm_silu_fwd_modulated(const void* x, const float* gamma, const float* beta,
                                      const void* scale, const void* shift, long long scale_sb,
                                      long long shift_sb, int mode, void* y, void* coef,
                                      void* partial, void* tickets, int batch, int channels,
                                      int hw, int groups, int cluster, int smem, int chunks,
                                      int rows, int vec, int bf16, float eps, void* stream) {
  const FwdArgs a = forward_args(x, gamma, beta, y, coef, partial, tickets, channels, hw, groups,
                                 cluster, smem, rows, bf16, eps, scale, shift, scale_sb,
                                 shift_sb);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 1:
      return forward<Mod::channel>(a, batch, cluster, smem, chunks, vec, bf16, s);
    case 2:
      return forward<Mod::pixel>(a, batch, cluster, smem, chunks, vec, bf16, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// *count: the clusters of `cluster` blocks with `smem` bytes of dynamic
// shared memory each that the current device holds at once.
int fea_group_norm_silu_fwd_resident_clusters(int cluster, int smem, int bf16, int* count) {
  return bf16 ? resident_clusters<__nv_bfloat16>(cluster, smem, count)
              : resident_clusters<float>(cluster, smem, count);
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
