// The segmented PCG loop body of the flat chunk solve and the chunk's
// default preconditioner, for Hopper (sm_90a), with a plain C interface for
// ctypes (fea_tpu_torch/ops/cg.py binds it).
//
// Replaces what XLA fused into the chunk's one program on the TPU:
//   - the body of pcg_solve_segmented's lax.while_loop,
//     fea_tpu/fem/solver.py:270-302: the per-segment dot products pAp,
//     rz and r2, the masked alpha and beta, the x, r and p updates, the
//     best_r2 / stall counters; and the lane mask the port adds (a lane runs
//     while one of its segments runs and its own k < max_iters; a lane that
//     stops keeps every leaf, so results and counts are the while_loop's for
//     any number of bodies queued between two host reads);
//   - the default branch of precondition, fea_tpu/fem/flatgroup.py:329-343:
//     z = free * (Dblk^-1 r + P Kc^-1 P^T r), the 2x2 block-Jacobi einsum
//     and coarse_apply_flat's restriction (:146; here over the member table
//     of each aggregate's real nodes) and prolongation by aggregate id. The
//     dense (3nc, 3nc) matvec by Kc^-1 between them stays a batched product
//     in torch, as fea_tpu left it to XLA's dot.
//
// Layout: vectors are (L, 2 * P * Ns): L lanes, planar (component-major),
// P segments (plates) of Ns nodes contiguous within each component block.
// Per-segment scalars are (L, P), per-lane k and the lane flag (L,); flags
// are bytes (torch.bool), counters int32, values float or double.
//
// What bounds it on this card: bytes. Every launch streams two to five
// vectors of L * 2 * P * Ns values with one or two operations per value
// read (the chunk at the production shape: 1.05 MB a vector in f32), far
// under the card's operations per byte; the restriction gathers each node
// once through the member table.
//
// Design:
//   - alpha's reduction per (lane, segment): G blocks per segment each sum a slice
//     of the segment's nodes (both components) and write one partial, by a
//     fixed tree in shared memory; the last block of the segment to finish
//     (an atomic ticket per segment, reset to 0 by that block, so nothing is
//     zeroed between launches or CUDA graph replays) sums the G partials in
//     index order and runs the scalar epilogue (alpha). No floating-point
//     atomics: a chunk repeats bit for bit;
//   - prolong_dots (the costliest launch of a body) reduces each segment
//     inside one thread-block cluster instead: a block per contiguous range
//     of the segment's nodes (ops/cg.py prolong_plan), 16-byte loads of a
//     thread's consecutive nodes, a fixed shuffle tree per warp, then the
//     warps in order; each block stores its sums into rank 0's shared
//     memory (distributed shared memory) and arrives on rank 0's mbarrier,
//     and rank 0 alone waits, sums them in rank order and runs the epilogue
//     (beta, rz, r2, best_r2, stall and k, its scalars read at the start of
//     the launch). No block reads another's memory, so the others leave at
//     once; rank 0 leaves after every store into it has landed. No partial,
//     ticket, fence or atomic goes through device memory;
//   - products and sums are rounded one at a time (__fmul_rn / __fadd_rn,
//     no FMA contraction), as the torch ops they replace round them, so the
//     elementwise updates and the preconditioner's terms equal the plain
//     versions bit for bit; only the order of the dot products' sums differs;
//   - launches per loop body: alpha (pAp dots and the epilogue), update_xr,
//     jacobi_restrict (the 2x2 apply and the restriction in one grid: a
//     thread per node, then a warp per (lane, aggregate)), prolong_dots (the
//     prolongation, the sum, the free mask and the rz / r2 dots with their
//     epilogue), update_p.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// Sums v[i] over the block by a fixed tree; every thread gets the sums.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV]) {
  __shared__ T sh[NV][THREADS];
#pragma unroll
  for (int i = 0; i < NV; ++i) sh[i][threadIdx.x] = v[i];
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int i = 0; i < NV; ++i) sh[i][threadIdx.x] = add(sh[i][threadIdx.x], sh[i][threadIdx.x + s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = sh[i][0];
}

// Called by every thread after thread 0 wrote the block's partial: true in
// the last of the segment's `groups` blocks to arrive (all its threads).
__device__ __forceinline__ bool last_of_segment(int* ticket, int groups) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    __threadfence();  // the partial, before the ticket
    last = atomicAdd(ticket, 1) == groups - 1;
  }
  __syncthreads();
  return last;
}

template <typename T>
__device__ __forceinline__ bool running(int s, const T* r2, const T* atol2, const int* stall,
                                        const uint8_t* active, int stall_limit) {
  const T v = r2[s];
  return v > atol2[s] && isfinite(v) && stall[s] < stall_limit && active[s];
}

// Launch 1: pAp per segment; the last block of each segment sets alpha,
// the segment's run flag and (segment 0) the lane flag from the state at
// the start of the body.
template <typename T>
__global__ void __launch_bounds__(THREADS) alpha_kernel(
    const T* __restrict__ p, const T* __restrict__ Ap, const T* __restrict__ rz,
    const T* __restrict__ r2, const T* __restrict__ atol2, const int* __restrict__ stall,
    const uint8_t* __restrict__ active, const int* __restrict__ k, T* __restrict__ alpha,
    uint8_t* __restrict__ run, uint8_t* __restrict__ lane, T* partials, int* tickets, int P,
    int Ns, int G, int max_iters, int stall_limit) {
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  const int l = s / P, q = s - l * P;
  const long long PN = (long long)P * Ns;
  const long long base = (long long)l * 2 * PN + (long long)q * Ns;
  const int chunk = (Ns + G - 1) / G;
  const int n0 = g * chunk, n1 = min(Ns, n0 + chunk);
  T acc[1] = {T(0)};
  for (int n = n0 + threadIdx.x; n < n1; n += THREADS) {
    const long long i = base + n;
    acc[0] = add(acc[0], mul(p[i], Ap[i]));
    acc[0] = add(acc[0], mul(p[i + PN], Ap[i + PN]));
  }
  block_sum<T, 1>(acc);
  if (threadIdx.x == 0) partials[(long long)s * G + g] = acc[0];
  if (!last_of_segment(tickets + s, G) || threadIdx.x != 0) return;
  __threadfence();
  T pAp = T(0);
  for (int j = 0; j < G; ++j) pAp = add(pAp, __ldcg(partials + (long long)s * G + j));
  tickets[s] = 0;
  const bool run_s = running(s, r2, atol2, stall, active, stall_limit);
  alpha[s] = run_s ? rz[s] / (pAp != T(0) ? pAp : T(1)) : T(0);
  run[s] = run_s;
  if (q == 0) {
    bool any = false;
    for (int j = 0; j < P; ++j) any = any || running(l * P + j, r2, atol2, stall, active, stall_limit);
    lane[l] = any && k[l] < max_iters;
  }
}

// Launch 2: x += alpha p, r -= alpha Ap on the lanes that run.
template <typename T>
__global__ void __launch_bounds__(THREADS) update_xr_kernel(
    T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ Ap,
    const T* __restrict__ alpha, const uint8_t* __restrict__ lane, long long total, int P, int Ns) {
  const long long PN = (long long)P * Ns, ndof = 2 * PN;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long l = i / ndof;
    if (!lane[l]) continue;
    const long long j = i - l * ndof;
    const T a = alpha[l * P + (int)((j % PN) / Ns)];
    x[i] = add(x[i], mul(a, p[i]));
    r[i] = sub(r[i], mul(a, Ap[i]));
  }
}

// Launch 3: the first `jac_blocks` blocks apply the 2x2 block inverse
// (L, 2, 2, PN) node by node (zj); the rest restrict r to the coarse space,
// one warp per (lane, aggregate) over its row of the member table (W
// entries, PN marks padding): rc[l, a] = sum over members m of (rx, ry,
// -arm_y rx + arm_x ry), by a fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(THREADS) jacobi_restrict_kernel(
    const T* __restrict__ r, const T* __restrict__ block_inv, const T* __restrict__ arms,
    const int* __restrict__ members, T* __restrict__ zj, T* __restrict__ rc, int L, long long PN,
    int NA, int W, int jac_blocks) {
  if ((int)blockIdx.x < jac_blocks) {
    const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (i >= L * PN) return;
    const long long l = i / PN, n = i - l * PN;
    const long long v0 = l * 2 * PN + n;
    const T r0 = r[v0], r1 = r[v0 + PN];
    const T* b = block_inv + l * 4 * PN + n;
    zj[v0] = add(mul(b[0], r0), mul(b[PN], r1));
    zj[v0 + PN] = add(mul(b[2 * PN], r0), mul(b[3 * PN], r1));
    return;
  }
  const long long wid = (long long)(blockIdx.x - jac_blocks) * WARPS + threadIdx.x / 32;
  if (wid >= (long long)L * NA) return;  // uniform over the warp
  const int lid = threadIdx.x % 32;
  const long long l = wid / NA, a = wid - l * NA;
  const T* rl = r + l * 2 * PN;
  T s0 = T(0), s1 = T(0), s2 = T(0);
  for (int w = lid; w < W; w += 32) {
    const int m = members[a * W + w];
    if (m < PN) {
      const T rx = rl[m], ry = rl[PN + m];
      s0 = add(s0, rx);
      s1 = add(s1, ry);
      s2 = add(s2, add(mul(-arms[2 * m + 1], rx), mul(arms[2 * m], ry)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 = add(s0, __shfl_down_sync(0xffffffffu, s0, off));
    s1 = add(s1, __shfl_down_sync(0xffffffffu, s1, off));
    s2 = add(s2, __shfl_down_sync(0xffffffffu, s2, off));
  }
  if (lid == 0) {
    T* out = rc + wid * 3;
    out[0] = s0;
    out[1] = s1;
    out[2] = s2;
  }
}

// values of T in a 16-byte load
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// V consecutive values at p (16 bytes, or one value for V = 1) in one access
template <typename T, int V>
struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<int, 4> { using type = int4; };
template <> struct Vec<int, 2> { using type = int2; };
template <typename T> struct Vec<T, 1> { using type = T; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, T* out) {
  union {
    typename Vec<T, V>::type v;
    T s[V];
  } u;
  u.v = *reinterpret_cast<const typename Vec<T, V>::type*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = u.s[j];
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T* in) {
  union {
    typename Vec<T, V>::type v;
    T s[V];
  } u;
#pragma unroll
  for (int j = 0; j < V; ++j) u.s[j] = in[j];
  *reinterpret_cast<typename Vec<T, V>::type*>(p) = u.v;
}

constexpr int kMaxCluster = 16;  // blocks of prolong_dots' cluster at most (non-portable over 8)

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of `local` (this block's shared memory) in the block of rank
// `rank` of this cluster
__device__ __forceinline__ unsigned cluster_address(const void* local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(shared_address(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void cluster_store(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void cluster_store(unsigned addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(v) : "memory");
}

template <typename T>
struct ProlongArgs {
  const T* zj;          // may be null: 0
  const T* zc;          // may be null: no coarse term
  const int* agg;
  const T* arms;
  const T* free_mask;   // may be null: no mask
  T* z;
  const T* r;           // the rest: with the state only
  T *rz, *r2, *best, *beta;
  int *stall, *k;
  const uint8_t *run, *lane;
  int with_state, P, Ns, span, NA;
};

// Launch 4: z = (zj + P zc) * free node by node (zj may be absent: 0; zc
// absent: no coarse term; free absent: no mask); with the state
// (`with_state`), also rz = r.z and r2 = r.r per segment, and rank 0 of
// the segment's cluster runs the epilogue: beta, and on a lane that runs
// rz, r2, best_r2, stall and (segment 0) k.
//
// Grid (cluster, L P) in clusters of (cluster, 1, 1): the cluster of
// segment s = l P + q, and its block of rank b the nodes [b span, min(Ns,
// (b + 1) span)). A thread takes V consecutive nodes at a time (V > 1:
// span and Ns are multiples of V and the pointers 16-byte aligned), every
// input loaded before the coarse term's gather by aggregate id.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) prolong_dots_kernel(ProlongArgs<T> a) {
  __shared__ T warp_sums[WARPS][2];
  __shared__ T rank_sums[kMaxCluster][2];  // rank 0's: every rank's sums, by rank
  __shared__ __align__(8) unsigned long long sums_in;  // rank 0's: completes with the last
  const int rank = blockIdx.x, ranks = gridDim.x, s = blockIdx.y;
  const int l = s / a.P, q = s - l * a.P;
  const long long PN = (long long)a.P * a.Ns;
  const long long base = (long long)l * 2 * PN + (long long)q * a.Ns;
  const int n0 = rank * a.span, n1 = min(a.Ns, n0 + a.span);
  const bool epilogue = a.with_state && rank == 0 && threadIdx.x == 0;
  // the epilogue's scalars, read now so that the launch's tail waits on none
  bool run_s = false, lane_l = false;
  T rz_old = T(0), best_s = T(0);
  int stall_s = 0, k_l = 0;
  if (epilogue) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(&sums_in)),
                 "r"(ranks)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    run_s = a.run[s];
    lane_l = a.lane[l];
    rz_old = a.rz[s];
    best_s = a.best[s];
    stall_s = a.stall[s];
    if (q == 0) k_l = a.k[l];
  }
  // waited for before any block arrives on rank 0's barrier: it is set up
  if (a.with_state) asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  T acc0 = T(0), acc1 = T(0);
  for (int n = n0 + threadIdx.x * V; n < n1; n += THREADS * V) {
    const long long gn = (long long)q * a.Ns + n;  // node in the lane's PN
    const long long i0 = base + n, i1 = i0 + PN;
    T z0[V], z1[V], f0[V], f1[V], r0[V], r1[V], arm[2 * V];
    int ag[V];
    if (a.zj != nullptr) {
      load_vec<T, V>(a.zj + i0, z0);
      load_vec<T, V>(a.zj + i1, z1);
    }
    if (a.free_mask != nullptr) {
      load_vec<T, V>(a.free_mask + i0, f0);
      load_vec<T, V>(a.free_mask + i1, f1);
    }
    if (a.with_state) {
      load_vec<T, V>(a.r + i0, r0);
      load_vec<T, V>(a.r + i1, r1);
    }
    if (a.zc != nullptr) {
      load_vec<int, V>(a.agg + gn, ag);
      load_vec<T, V>(a.arms + 2 * gn, arm);  // (x, y) of node gn, gn + 1, ...
      load_vec<T, V>(a.arms + 2 * gn + V, arm + V);
      T c[V][3];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T* cj = a.zc + ((long long)l * a.NA + ag[j]) * 3;
        c[j][0] = cj[0];
        c[j][1] = cj[1];
        c[j][2] = cj[2];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T zx = sub(c[j][0], mul(arm[2 * j + 1], c[j][2]));
        const T zy = add(c[j][1], mul(arm[2 * j], c[j][2]));
        z0[j] = a.zj != nullptr ? add(z0[j], zx) : zx;
        z1[j] = a.zj != nullptr ? add(z1[j], zy) : zy;
      }
    } else if (a.zj == nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j) z0[j] = z1[j] = T(0);
    }
    if (a.free_mask != nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        z0[j] = mul(z0[j], f0[j]);
        z1[j] = mul(z1[j], f1[j]);
      }
    }
    store_vec<T, V>(a.z + i0, z0);
    store_vec<T, V>(a.z + i1, z1);
    if (a.with_state) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc0 = add(add(acc0, mul(r0[j], z0[j])), mul(r1[j], z1[j]));
        acc1 = add(add(acc1, mul(r0[j], r0[j])), mul(r1[j], r1[j]));
      }
    }
  }
  if (!a.with_state) return;
  // the block's sums: a fixed shuffle tree per warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc0 = add(acc0, __shfl_down_sync(0xffffffffu, acc0, off));
    acc1 = add(acc1, __shfl_down_sync(0xffffffffu, acc1, off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_sums[warp][0] = acc0;
    warp_sums[warp][1] = acc1;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (threadIdx.x == 0) {  // this block's sums into rank 0's table, then its arrival there
    T t0 = warp_sums[0][0], t1 = warp_sums[0][1];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      t0 = add(t0, warp_sums[w][0]);
      t1 = add(t1, warp_sums[w][1]);
    }
    const unsigned to = cluster_address(&rank_sums[rank][0], 0);
    cluster_store(to, t0);
    cluster_store(to + sizeof(T), t1);
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                 ::"r"(cluster_address(&sums_in, 0))
                 : "memory");
  }
  if (!epilogue) return;  // no block reads another's memory: the others may leave
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_address(&sums_in))
        : "memory");
  }
  T rz_new = T(0), r2_new = T(0);
  for (int b = 0; b < ranks; ++b) {  // in rank order
    rz_new = add(rz_new, rank_sums[b][0]);
    r2_new = add(r2_new, rank_sums[b][1]);
  }
  a.beta[s] = run_s ? rz_new / (rz_old != T(0) ? rz_old : T(1)) : T(0);
  if (lane_l) {
    const bool improved = run_s && r2_new < mul(T(0.9), best_s);
    a.rz[s] = run_s ? rz_new : rz_old;
    a.r2[s] = r2_new;
    if (improved) a.best[s] = r2_new;
    a.stall[s] = improved ? 0 : (run_s ? stall_s + 1 : stall_s);
    if (q == 0) a.k[l] = k_l + 1;
  }
}

// Launch 5: p = z + beta p on the segments that run, in the lanes that run.
template <typename T>
__global__ void __launch_bounds__(THREADS) update_p_kernel(
    T* __restrict__ p, const T* __restrict__ z, const T* __restrict__ beta,
    const uint8_t* __restrict__ run, const uint8_t* __restrict__ lane, long long total, int P,
    int Ns) {
  const long long PN = (long long)P * Ns, ndof = 2 * PN;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long l = i / ndof;
    if (!lane[l]) continue;
    const long long j = i - l * ndof;
    const long long s = l * P + (int)((j % PN) / Ns);
    if (!run[s]) continue;
    p[i] = add(z[i], mul(beta[s], p[i]));
  }
}

int elementwise_blocks(long long total) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

template <typename T>
int launch_alpha(void* p, void* Ap, void* rz, void* r2, void* atol2, void* stall, void* active,
                 void* k, void* alpha, void* run, void* lane, void* partials, void* tickets, int L,
                 int P, int Ns, int G, int max_iters, int stall_limit, cudaStream_t stream) {
  alpha_kernel<T><<<L * P * G, THREADS, 0, stream>>>(
      (const T*)p, (const T*)Ap, (const T*)rz, (const T*)r2, (const T*)atol2, (const int*)stall,
      (const uint8_t*)active, (const int*)k, (T*)alpha, (uint8_t*)run, (uint8_t*)lane,
      (T*)partials, (int*)tickets, P, Ns, G, max_iters, stall_limit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update_xr(void* x, void* r, void* p, void* Ap, void* alpha, void* lane, int L, int P,
                     int Ns, cudaStream_t stream) {
  const long long total = (long long)L * 2 * P * Ns;
  update_xr_kernel<T><<<elementwise_blocks(total), THREADS, 0, stream>>>(
      (T*)x, (T*)r, (const T*)p, (const T*)Ap, (const T*)alpha, (const uint8_t*)lane, total, P, Ns);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_jacobi_restrict(void* r, void* block_inv, void* arms, void* members, void* zj, void* rc,
                           int L, long long PN, int NA, int W, cudaStream_t stream) {
  const int jac_blocks = block_inv != nullptr ? (int)((L * PN + THREADS - 1) / THREADS) : 0;
  const int res_blocks = members != nullptr ? (int)(((long long)L * NA + WARPS - 1) / WARPS) : 0;
  if (jac_blocks + res_blocks == 0) return 0;
  jacobi_restrict_kernel<T><<<jac_blocks + res_blocks, THREADS, 0, stream>>>(
      (const T*)r, (const T*)block_inv, (const T*)arms, (const int*)members, (T*)zj, (T*)rc, L, PN,
      NA, W, jac_blocks);
  return (int)cudaGetLastError();
}

// A cluster of `cluster` blocks (1 to 16; over 8 needs the non-portable
// attribute that load_kernels sets) per segment, `vec` values a load:
// kVec<T> or 1.
template <typename T>
int launch_prolong_dots(const ProlongArgs<T>& a, int L, int cluster, int vec,
                        cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || (vec != 1 && vec != kVec<T>) ||
      (long long)cluster * a.span < a.Ns || a.span % vec != 0 || a.Ns % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, L * a.P);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = vec == 1 ? cudaLaunchKernelEx(&cfg, prolong_dots_kernel<T, 1>, a)
                                   : cudaLaunchKernelEx(&cfg, prolong_dots_kernel<T, kVec<T>>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch_update_p(void* p, void* z, void* beta, void* run, void* lane, int L, int P, int Ns,
                    cudaStream_t stream) {
  const long long total = (long long)L * 2 * P * Ns;
  update_p_kernel<T><<<elementwise_blocks(total), THREADS, 0, stream>>>(
      (T*)p, (const T*)z, (const T*)beta, (const uint8_t*)run, (const uint8_t*)lane, total, P, Ns);
  return (int)cudaGetLastError();
}

template <typename T>
int load_kernels() {
  cudaFuncAttributes attr;
  const void* kernels[] = {
      (const void*)alpha_kernel<T>, (const void*)update_xr_kernel<T>,
      (const void*)jacobi_restrict_kernel<T>, (const void*)prolong_dots_kernel<T, 1>,
      (const void*)prolong_dots_kernel<T, kVec<T>>, (const void*)update_p_kernel<T>,
  };
  for (const void* kernel : kernels) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
  }
  // clusters of prolong_dots over the portable 8 blocks
  const void* clustered[] = {(const void*)prolong_dots_kernel<T, 1>,
                             (const void*)prolong_dots_kernel<T, kVec<T>>};
  for (const void* kernel : clustered) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// `dbl` selects the type: 0 float, 1 double. Each function returns
// cudaGetLastError() after its launch (0 when it was accepted).
extern "C" {

int fea_cg_alpha(int dbl, void* p, void* Ap, void* rz, void* r2, void* atol2, void* stall,
                 void* active, void* k, void* alpha, void* run, void* lane, void* partials,
                 void* tickets, int L, int P, int Ns, int G, int max_iters, int stall_limit,
                 void* stream) {
  auto launch = dbl ? launch_alpha<double> : launch_alpha<float>;
  return launch(p, Ap, rz, r2, atol2, stall, active, k, alpha, run, lane, partials, tickets, L, P,
                Ns, G, max_iters, stall_limit, (cudaStream_t)stream);
}

int fea_cg_update_xr(int dbl, void* x, void* r, void* p, void* Ap, void* alpha, void* lane, int L,
                     int P, int Ns, void* stream) {
  auto launch = dbl ? launch_update_xr<double> : launch_update_xr<float>;
  return launch(x, r, p, Ap, alpha, lane, L, P, Ns, (cudaStream_t)stream);
}

int fea_cg_jacobi_restrict(int dbl, void* r, void* block_inv, void* arms, void* members, void* zj,
                           void* rc, int L, long long PN, int NA, int W, void* stream) {
  auto launch = dbl ? launch_jacobi_restrict<double> : launch_jacobi_restrict<float>;
  return launch(r, block_inv, arms, members, zj, rc, L, PN, NA, W, (cudaStream_t)stream);
}

int fea_cg_prolong_dots(int dbl, void* zj, void* zc, void* agg, void* arms, void* free_mask,
                        void* z, void* r, int with_state, void* rz, void* r2, void* best,
                        void* stall, void* k, void* beta, void* run, void* lane, int L, int P,
                        int Ns, int cluster, int span, int vec, int NA, void* stream) {
  auto launch = [&](auto zero) {
    using T = decltype(zero);
    ProlongArgs<T> a;
    a.zj = (const T*)zj;
    a.zc = (const T*)zc;
    a.agg = (const int*)agg;
    a.arms = (const T*)arms;
    a.free_mask = (const T*)free_mask;
    a.z = (T*)z;
    a.r = (const T*)r;
    a.rz = (T*)rz;
    a.r2 = (T*)r2;
    a.best = (T*)best;
    a.beta = (T*)beta;
    a.stall = (int*)stall;
    a.k = (int*)k;
    a.run = (const uint8_t*)run;
    a.lane = (const uint8_t*)lane;
    a.with_state = with_state;
    a.P = P;
    a.Ns = Ns;
    a.span = span;
    a.NA = NA;
    return launch_prolong_dots<T>(a, L, cluster, vec, (cudaStream_t)stream);
  };
  return dbl ? launch(0.0) : launch(0.0f);
}

int fea_cg_update_p(int dbl, void* p, void* z, void* beta, void* run, void* lane, int L, int P,
                    int Ns, void* stream) {
  auto launch = dbl ? launch_update_p<double> : launch_update_p<float>;
  return launch(p, z, beta, run, lane, L, P, Ns, (cudaStream_t)stream);
}

// Loads every kernel into the current context, so that none loads lazily
// at its first launch, which may come while a CUDA graph is captured.
int fea_cg_load() {
  const int err = load_kernels<float>();
  return err != 0 ? err : load_kernels<double>();
}

const char* fea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
