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
//   - the three per-segment reductions (pAp in alpha; rz and r2 in
//     prolong_dots) each run inside one thread-block cluster per (lane,
//     segment): a block per contiguous range of the segment's nodes
//     (ops/cg.py alpha_plan, prolong_plan), 16-byte loads of a thread's
//     consecutive nodes, a fixed shuffle tree per warp, then the warps in
//     order; each block stores its sums into rank 0's shared memory
//     (distributed shared memory) and arrives on rank 0's mbarrier, and
//     rank 0 alone waits, sums them in rank order and runs the launch's
//     scalar epilogue (its scalars read at the start of the launch, so the
//     tail waits on no load). No block reads another's memory, so the
//     others leave at once; rank 0 leaves after every store into it has
//     landed. No partial, ticket, fence or atomic goes through device
//     memory, and the order of a sum depends on the segment's node count
//     alone: a chunk repeats bit for bit;
//   - the elementwise updates of x, r and p run on a grid of (blocks,
//     segments) (ops/cg.py update_xr_plan, update_p_plan): a block reads
//     its flags and its segment's scalar once and leaves before it loads a
//     vector where its lane (p: or segment) has stopped; 16-byte loads, no
//     64-bit division per element; the Jacobi term the same over a grid of
//     (blocks, lanes);
//   - the restriction takes a warp per aggregate for all the lanes of a
//     pass (ops/cg.py restrict_plan): the member index and arms loaded once,
//     then every lane's gathers of r at once; a row of padding leaves
//     after its first load;
//   - products and sums are rounded one at a time (__fmul_rn / __fadd_rn,
//     no FMA contraction), as the torch ops they replace round them, so the
//     elementwise updates and the preconditioner's terms equal the plain
//     versions bit for bit; only the order of the dot products' sums differs;
//   - launches per loop body: alpha (pAp dots and the epilogue), update_xr,
//     jacobi_restrict (the 2x2 apply and the restriction in one grid: blocks
//     of nodes per lane and warps per aggregate), prolong_dots (the
//     prolongation, the sum, the free mask and the rz / r2 dots with their
//     epilogue), update_p.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int kMaxCluster = 16;  // blocks of a reduction's cluster at most (non-portable over 8)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

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

// A segment's NV sums over its cluster (a block per range of its nodes,
// rank = blockIdx.x): each block's warps' sums, and in rank 0 every rank's
// sums and the mbarrier they arrive on.
template <typename T, int NV>
struct ClusterSums {
  T warp_sums[WARPS][NV];
  T rank_sums[kMaxCluster][NV];  // rank 0's: every rank's sums, by rank
  unsigned long long arrived;    // rank 0's: completes with the last rank's store
};

// Every thread of the cluster, before its loads: rank 0 sets up its
// barrier, on which no block arrives before the cluster barrier that
// cluster_sum waits for.
template <typename T, int NV>
__device__ __forceinline__ void cluster_sum_begin(ClusterSums<T, NV>& sh, int rank, int ranks) {
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(&sh.arrived)),
                 "r"(ranks)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// Every thread of the cluster, after its loads, with its own sums `acc`:
// true in rank 0's thread 0 alone, whose `acc` then holds the segment's
// sums (a fixed shuffle tree per warp, the warps in order, the ranks in
// order). The other blocks leave at once: none reads another's memory, and
// rank 0 returns after every store into it has landed.
template <typename T, int NV>
__device__ __forceinline__ bool cluster_sum(ClusterSums<T, NV>& sh, T (&acc)[NV], int rank,
                                            int ranks) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = add(acc[i], __shfl_down_sync(0xffffffffu, acc[i], off));
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) sh.warp_sums[threadIdx.x / 32][i] = acc[i];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (threadIdx.x == 0) {  // this block's sums into rank 0's table, then its arrival there
    T t[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = sh.warp_sums[0][i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) t[i] = add(t[i], sh.warp_sums[w][i]);
    }
    const unsigned to = cluster_address(&sh.rank_sums[rank][0], 0);
#pragma unroll
    for (int i = 0; i < NV; ++i) cluster_store(to + i * sizeof(T), t[i]);
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                 ::"r"(cluster_address(&sh.arrived, 0))
                 : "memory");
  }
  if (rank != 0 || threadIdx.x != 0) return false;
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_address(&sh.arrived))
        : "memory");
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T(0);
  for (int b = 0; b < ranks; ++b) {  // in rank order
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = add(acc[i], sh.rank_sums[b][i]);
  }
  return true;
}

template <typename T>
__device__ __forceinline__ bool running(int s, const T* r2, const T* atol2, const int* stall,
                                        const uint8_t* active, int stall_limit) {
  const T v = r2[s];
  const bool finite = isfinite(v);
  return (v > atol2[s]) & finite & (stall[s] < stall_limit) & (active[s] != 0);
}

template <typename T>
struct AlphaArgs {
  const T *p, *Ap, *rz, *r2, *atol2;
  const int *stall, *k;
  const uint8_t* active;
  T* alpha;
  uint8_t *run, *lane;
  int P, Ns, span, max_iters, stall_limit;
};

// Launch 1: pAp per segment; rank 0 of the segment's cluster sets alpha,
// the segment's run flag and (segment 0) the lane flag from the state at
// the start of the body.
//
// Grid (cluster, L P) in clusters of (cluster, 1, 1): the cluster of
// segment s = l P + q, and its block of rank b the nodes [b span, min(Ns,
// (b + 1) span)). A thread takes V consecutive nodes of both components
// of p and Ap at a time (V > 1: span and Ns are multiples of V and the
// pointers 16-byte aligned).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) alpha_kernel(AlphaArgs<T> a) {
  __shared__ ClusterSums<T, 1> sums;
  const int rank = blockIdx.x, ranks = gridDim.x, s = blockIdx.y;
  const int l = s / a.P, q = s - l * a.P;
  const long long PN = (long long)a.P * a.Ns;
  const long long base = (long long)l * 2 * PN + (long long)q * a.Ns;
  const int n0 = rank * a.span, n1 = min(a.Ns, n0 + a.span);
  cluster_sum_begin(sums, rank, ranks);
  // the epilogue's scalars, read now so that the launch's tail waits on none
  bool run_s = false, lane_l = false;
  T rz_s = T(0);
  if (rank == 0 && threadIdx.x == 0) {
    run_s = running(s, a.r2, a.atol2, a.stall, a.active, a.stall_limit);
    rz_s = a.rz[s];
    if (q == 0) {
      bool any = false;
      for (int j = 0; j < a.P; ++j) {
        any |= running(l * a.P + j, a.r2, a.atol2, a.stall, a.active, a.stall_limit);
      }
      lane_l = any & (a.k[l] < a.max_iters);
    }
  }
  T acc[1] = {T(0)};
  for (int n = n0 + threadIdx.x * V; n < n1; n += THREADS * V) {
    const long long i0 = base + n, i1 = i0 + PN;
    T p0[V], p1[V], ap0[V], ap1[V];
    load_vec<T, V>(a.p + i0, p0);
    load_vec<T, V>(a.p + i1, p1);
    load_vec<T, V>(a.Ap + i0, ap0);
    load_vec<T, V>(a.Ap + i1, ap1);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[0] = add(add(acc[0], mul(p0[j], ap0[j])), mul(p1[j], ap1[j]));
  }
  if (!cluster_sum(sums, acc, rank, ranks)) return;
  const T pAp = acc[0];
  a.alpha[s] = run_s ? rz_s / (pAp != T(0) ? pAp : T(1)) : T(0);
  a.run[s] = run_s;
  if (q == 0) a.lane[l] = lane_l;
}

// Launch 2: x += alpha p, r -= alpha Ap on the lanes that run.
//
// Grid (blocks, L P), laid out as update_p's: block b of segment s = l P +
// q takes the nodes [b span, min(Ns, (b + 1) span)), a thread V
// consecutive nodes of both components of x, r, p and Ap at a time (V > 1:
// span and Ns multiples of V, the pointers 16-byte aligned). A block reads
// its lane flag and its segment's alpha once and leaves before any load
// where its lane has stopped. A stopped segment of a running lane (alpha
// 0) is not skipped: fea_tpu takes x + 0 p there, which is not x where p
// is not finite or x is -0.0.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) update_xr_kernel(
    T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ Ap,
    const T* __restrict__ alpha, const uint8_t* __restrict__ lane, int P, int Ns, int span) {
  const int s = blockIdx.y, l = s / P, q = s - l * P;
  if (!lane[l]) return;  // the whole block: a stopped lane moves no vector
  const T a = alpha[s];
  const long long PN = (long long)P * Ns;
  const long long base = (long long)l * 2 * PN + (long long)q * Ns;
  const int n1 = min(Ns, ((int)blockIdx.x + 1) * span);
  for (int n = blockIdx.x * span + threadIdx.x * V; n < n1; n += THREADS * V) {
    const long long i0 = base + n, i1 = i0 + PN;
    T x0[V], x1[V], r0[V], r1[V], p0[V], p1[V], ap0[V], ap1[V];
    load_vec<T, V>(x + i0, x0);
    load_vec<T, V>(x + i1, x1);
    load_vec<T, V>(r + i0, r0);
    load_vec<T, V>(r + i1, r1);
    load_vec<T, V>(p + i0, p0);
    load_vec<T, V>(p + i1, p1);
    load_vec<T, V>(Ap + i0, ap0);
    load_vec<T, V>(Ap + i1, ap1);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      x0[j] = add(x0[j], mul(a, p0[j]));
      x1[j] = add(x1[j], mul(a, p1[j]));
      r0[j] = sub(r0[j], mul(a, ap0[j]));
      r1[j] = sub(r1[j], mul(a, ap1[j]));
    }
    store_vec<T, V>(x + i0, x0);
    store_vec<T, V>(x + i1, x1);
    store_vec<T, V>(r + i0, r0);
    store_vec<T, V>(r + i1, r1);
  }
}

// values a restriction lane sums for a pass of LP lanes: 3 LP, padded to a
// power of two
template <int LP>
constexpr int kTreeValues = LP == 1 ? 4 : LP == 2 ? 8 : LP == 4 ? 16 : 32;

// The warp's sums over its 32 lanes of each of a lane's N values (N a power
// of two up to 32) by the pairs of a shuffle-down tree: at offset OFF the
// partial of lane i and that of lane i + OFF = i ^ OFF, for i under OFF.
// While a lane holds more than one value it keeps half of them (a lane with
// the bit OFF set the upper half) and sends its partner the other half, so
// a step shuffles N / 2 values and not N. Value k ends on the lanes lid with
// lid / (32 / N) == k, with the bits of lane 0 of a shuffle-down tree
// (each sum is the same two partials in the same or the other order).
template <int N, int OFF, typename T, int M>
__device__ __forceinline__ void tree_sums(T (&v)[M], int lid) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      const bool upper = (lid & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const T send = upper ? v[i] : v[i + N / 2];
        const T keep = upper ? v[i + N / 2] : v[i];
        v[i] = add(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
      }
      tree_sums<N / 2, OFF / 2>(v, lid);
    } else {
      v[0] = add(v[0], __shfl_xor_sync(0xffffffffu, v[0], OFF));
      tree_sums<1, OFF / 2>(v, lid);
    }
  }
}

struct RestrictPlan {
  int jac_blocks;  // Jacobi blocks a lane (0: no Jacobi term), each of `span` nodes
  int span;
  int res_blocks;  // restriction blocks (0: no restriction), each of blockDim / 32 warps
  int passes;      // passes of lanes: warp w takes pass w / NA of aggregate w % NA
  int jacobi_first;
};

// Launch 3: the 2x2 block inverse (L, 2, 2, PN) applied node by node (zj)
// and the restriction of r to the coarse space (rc), in one grid of
// blockDim threads: the Jacobi blocks first or last (plan.jacobi_first).
//
// Jacobi: a grid of (plan.jac_blocks, L) blocks, block b of lane l over
// the lane's nodes [b span, min(PN, (b + 1) span)), a thread V consecutive
// nodes of r's two components and block_inv's four planes at a time (V >
// 1: span and PN multiples of V, the pointers 16-byte aligned).
//
// Restriction: a warp per (pass, aggregate) over the aggregate's row of the
// member table (W entries, PN marks padding): for each of the pass's up to
// LP lanes, rc[l, a] = the sum over members m of (rx, ry, -arm_y rx +
// arm_x ry). Member w goes to warp lane w mod 32, which loads its index
// and arms once and then its 2 LP gathers of r at once, keeping 3 LP sums;
// the warp's sums by tree_sums, in the order of a shuffle-down tree (the
// bits do not depend on LP or the pass). A row whose entries are all
// padding writes its zeros after its first load.
template <typename T, int V, int LP>
__global__ void __launch_bounds__(THREADS) jacobi_restrict_kernel(
    const T* __restrict__ r, const T* __restrict__ block_inv, const T* __restrict__ arms,
    const int* __restrict__ members, T* __restrict__ zj, T* __restrict__ rc, int L, int PN,
    int NA, int W, RestrictPlan plan) {
  const int jac_total = plan.jac_blocks * L;
  const int jac_start = plan.jacobi_first ? 0 : plan.res_blocks;
  const int b = blockIdx.x;
  if (b >= jac_start && b < jac_start + jac_total) {
    const int l = (b - jac_start) / plan.jac_blocks;
    const int n0 = (b - jac_start - l * plan.jac_blocks) * plan.span;
    const int n1 = min(PN, n0 + plan.span);
    const T* rl = r + (long long)l * 2 * PN;
    const T* bl = block_inv + (long long)l * 4 * PN;
    T* zl = zj + (long long)l * 2 * PN;
    for (int n = n0 + threadIdx.x * V; n < n1; n += blockDim.x * V) {
      T r0[V], r1[V], b00[V], b01[V], b10[V], b11[V];
      load_vec<T, V>(rl + n, r0);
      load_vec<T, V>(rl + PN + n, r1);
      load_vec<T, V>(bl + n, b00);
      load_vec<T, V>(bl + PN + n, b01);
      load_vec<T, V>(bl + 2LL * PN + n, b10);
      load_vec<T, V>(bl + 3LL * PN + n, b11);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        b00[j] = add(mul(b00[j], r0[j]), mul(b01[j], r1[j]));
        b10[j] = add(mul(b10[j], r0[j]), mul(b11[j], r1[j]));
      }
      store_vec<T, V>(zl + n, b00);
      store_vec<T, V>(zl + PN + n, b10);
    }
    return;
  }
  const int res_block = plan.jacobi_first ? b - jac_total : b;
  const int wid = res_block * (int)(blockDim.x / 32) + (int)threadIdx.x / 32;
  if (wid >= plan.passes * NA) return;  // uniform over the warp
  const int lid = threadIdx.x % 32;
  const int pass = wid / NA, a = wid - pass * NA;
  const int l0 = pass * LP, nl = min(LP, L - l0);
  const T* rl = r + (long long)l0 * 2 * PN;
  constexpr int N = kTreeValues<LP>;
  T v[N];  // lane j's sums c at 3 j + c, then padding
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = T(0);
  bool any_real = false;
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lid;
    const int m = w < W ? members[(long long)a * W + w] : PN;
    const bool real = m < PN;
    if (!__any_sync(0xffffffffu, real)) continue;  // padding only: no gather
    any_real = true;
    if (real) {
      const T ax = arms[2LL * m], ay = arms[2LL * m + 1];
      T rx[LP], ry[LP];
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        if (j < nl) {
          rx[j] = rl[(long long)j * 2 * PN + m];
          ry[j] = rl[(long long)j * 2 * PN + PN + m];
        }
      }
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        if (j < nl) {
          v[3 * j] = add(v[3 * j], rx[j]);
          v[3 * j + 1] = add(v[3 * j + 1], ry[j]);
          v[3 * j + 2] = add(v[3 * j + 2], add(mul(-ay, rx[j]), mul(ax, ry[j])));
        }
      }
    }
  }
  T* out = rc + ((long long)l0 * NA + a) * 3;
  if (!any_real) {  // a row of padding: its sums are 0
    if (lid < 3 * nl) out[(long long)(lid / 3) * NA * 3 + lid % 3] = T(0);
    return;
  }
  tree_sums<N, 16>(v, lid);
  const int k = lid / (32 / N);  // the value this lane holds
  if (lid % (32 / N) == 0 && k < 3 * nl) out[(long long)(k / 3) * NA * 3 + k % 3] = v[0];
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
// Grid (cluster, L P) in clusters of (cluster, 1, 1), laid out as alpha's;
// every input loaded before the coarse term's gather by aggregate id.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) prolong_dots_kernel(ProlongArgs<T> a) {
  __shared__ ClusterSums<T, 2> sums;
  const int rank = blockIdx.x, ranks = gridDim.x, s = blockIdx.y;
  const int l = s / a.P, q = s - l * a.P;
  const long long PN = (long long)a.P * a.Ns;
  const long long base = (long long)l * 2 * PN + (long long)q * a.Ns;
  const int n0 = rank * a.span, n1 = min(a.Ns, n0 + a.span);
  // the epilogue's scalars, read now so that the launch's tail waits on none
  bool run_s = false, lane_l = false;
  T rz_old = T(0), best_s = T(0);
  int stall_s = 0, k_l = 0;
  if (a.with_state) {
    cluster_sum_begin(sums, rank, ranks);
    if (rank == 0 && threadIdx.x == 0) {
      run_s = a.run[s];
      lane_l = a.lane[l];
      rz_old = a.rz[s];
      best_s = a.best[s];
      stall_s = a.stall[s];
      if (q == 0) k_l = a.k[l];
    }
  }
  T acc[2] = {T(0), T(0)};
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
        acc[0] = add(add(acc[0], mul(r0[j], z0[j])), mul(r1[j], z1[j]));
        acc[1] = add(add(acc[1], mul(r0[j], r0[j])), mul(r1[j], r1[j]));
      }
    }
  }
  if (!a.with_state || !cluster_sum(sums, acc, rank, ranks)) return;
  const T rz_new = acc[0], r2_new = acc[1];
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
//
// Grid (blocks, L P): block b of segment s = l P + q takes the nodes [b
// span, min(Ns, (b + 1) span)), a thread V consecutive nodes of both
// components at a time (V > 1: span and Ns multiples of V, the pointers
// 16-byte aligned).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) update_p_kernel(
    T* __restrict__ p, const T* __restrict__ z, const T* __restrict__ beta,
    const uint8_t* __restrict__ run, const uint8_t* __restrict__ lane, int P, int Ns, int span) {
  const int s = blockIdx.y, l = s / P, q = s - l * P;
  if (!lane[l] || !run[s]) return;  // the whole block: a stopped segment moves no vector
  const T b = beta[s];
  const long long PN = (long long)P * Ns;
  const long long base = (long long)l * 2 * PN + (long long)q * Ns;
  const int n1 = min(Ns, ((int)blockIdx.x + 1) * span);
  for (int n = blockIdx.x * span + threadIdx.x * V; n < n1; n += THREADS * V) {
    const long long i0 = base + n, i1 = i0 + PN;
    T z0[V], z1[V], p0[V], p1[V];
    load_vec<T, V>(z + i0, z0);
    load_vec<T, V>(z + i1, z1);
    load_vec<T, V>(p + i0, p0);
    load_vec<T, V>(p + i1, p1);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p0[j] = add(z0[j], mul(b, p0[j]));
      p1[j] = add(z1[j], mul(b, p1[j]));
    }
    store_vec<T, V>(p + i0, p0);
    store_vec<T, V>(p + i1, p1);
  }
}

// Launches `kernel` on a grid of (cluster, segments) blocks of THREADS in
// clusters of (cluster, 1, 1) (over 8 needs the non-portable attribute
// that load_kernels sets).
template <typename Args>
int launch_clusters(void (*kernel)(Args), int cluster, int segments, cudaStream_t stream,
                    const Args& args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, segments);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// true where `count` ranges of `span` nodes tile Ns nodes as the kernels
// take them: each range with nodes, V values a load (kVec<T> or 1)
template <typename T>
bool valid_plan(int Ns, int count, int span, int vec) {
  return count >= 1 && (vec == 1 || vec == kVec<T>) && span > 0 &&
         (long long)count * span >= Ns && (long long)(count - 1) * span < Ns &&
         span % vec == 0 && Ns % vec == 0;
}

template <typename T>
int launch_alpha(const AlphaArgs<T>& a, int L, int cluster, int vec, cudaStream_t stream) {
  if (!valid_plan<T>(a.Ns, cluster, a.span, vec) || cluster > kMaxCluster || L * a.P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_clusters(vec == 1 ? alpha_kernel<T, 1> : alpha_kernel<T, kVec<T>>, cluster,
                         L * a.P, stream, a);
}

// `blocks` blocks of `span` nodes per segment, `vec` values a load
template <typename T>
int launch_update_xr(void* x, void* r, void* p, void* Ap, void* alpha, void* lane, int L, int P,
                     int Ns, int blocks, int span, int vec, cudaStream_t stream) {
  if (!valid_plan<T>(Ns, blocks, span, vec) || L * P > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = vec == 1 ? update_xr_kernel<T, 1> : update_xr_kernel<T, kVec<T>>;
  kernel<<<dim3(blocks, L * P), THREADS, 0, stream>>>(
      (T*)x, (T*)r, (const T*)p, (const T*)Ap, (const T*)alpha, (const uint8_t*)lane, P, Ns, span);
  return (int)cudaGetLastError();
}

constexpr int kMaxPassLanes = 8;  // lanes a restriction pass keeps in registers at most

template <typename T, int V>
auto restrict_kernel(int lanes) {
  return lanes == 1   ? jacobi_restrict_kernel<T, V, 1>
         : lanes == 2 ? jacobi_restrict_kernel<T, V, 2>
         : lanes == 4 ? jacobi_restrict_kernel<T, V, 4>
                      : jacobi_restrict_kernel<T, V, kMaxPassLanes>;
}

// the plan: Jacobi blocks of `span` nodes a lane, restriction blocks of
// `warps` warps, passes of `lanes` lanes (1, 2, 4 or 8), the Jacobi blocks
// first or last; `vec` values a Jacobi load
template <typename T>
int launch_jacobi_restrict(void* r, void* block_inv, void* arms, void* members, void* zj, void* rc,
                           int L, long long PN, int NA, int W, int span, int vec, int warps,
                           int lanes, int jacobi_first, cudaStream_t stream) {
  RestrictPlan plan;
  plan.jacobi_first = jacobi_first;
  plan.span = span;
  plan.jac_blocks = block_inv != nullptr ? (int)((PN + span - 1) / span) : 0;
  plan.passes = (L + lanes - 1) / lanes;
  const long long res_warps = members != nullptr ? (long long)plan.passes * NA : 0;
  plan.res_blocks = (int)((res_warps + warps - 1) / warps);
  const long long blocks = (long long)plan.jac_blocks * L + plan.res_blocks;
  if (PN >= (1LL << 30) || warps < 1 || warps > WARPS || span < 1 ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != kMaxPassLanes) ||
      (block_inv != nullptr && !valid_plan<T>((int)PN, plan.jac_blocks, span, vec)) ||
      blocks >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  auto kernel = vec == 1 ? restrict_kernel<T, 1>(lanes) : restrict_kernel<T, kVec<T>>(lanes);
  kernel<<<(unsigned)blocks, warps * 32, 0, stream>>>(
      (const T*)r, (const T*)block_inv, (const T*)arms, (const int*)members, (T*)zj, (T*)rc, L,
      (int)PN, NA, W, plan);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prolong_dots(const ProlongArgs<T>& a, int L, int cluster, int vec,
                        cudaStream_t stream) {
  if (!valid_plan<T>(a.Ns, cluster, a.span, vec) || cluster > kMaxCluster || L * a.P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_clusters(vec == 1 ? prolong_dots_kernel<T, 1> : prolong_dots_kernel<T, kVec<T>>,
                         cluster, L * a.P, stream, a);
}

// `blocks` blocks of `span` nodes per segment, `vec` values a load
template <typename T>
int launch_update_p(void* p, void* z, void* beta, void* run, void* lane, int L, int P, int Ns,
                    int blocks, int span, int vec, cudaStream_t stream) {
  if (!valid_plan<T>(Ns, blocks, span, vec) || L * P > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = vec == 1 ? update_p_kernel<T, 1> : update_p_kernel<T, kVec<T>>;
  kernel<<<dim3(blocks, L * P), THREADS, 0, stream>>>(
      (T*)p, (const T*)z, (const T*)beta, (const uint8_t*)run, (const uint8_t*)lane, P, Ns, span);
  return (int)cudaGetLastError();
}

template <typename T>
int load_kernels() {
  cudaFuncAttributes attr;
  const void* kernels[] = {
      (const void*)alpha_kernel<T, 1>, (const void*)alpha_kernel<T, kVec<T>>,
      (const void*)update_xr_kernel<T, 1>, (const void*)update_xr_kernel<T, kVec<T>>,
      (const void*)jacobi_restrict_kernel<T, 1, 1>, (const void*)jacobi_restrict_kernel<T, 1, 2>,
      (const void*)jacobi_restrict_kernel<T, 1, 4>, (const void*)jacobi_restrict_kernel<T, 1, 8>,
      (const void*)jacobi_restrict_kernel<T, kVec<T>, 1>,
      (const void*)jacobi_restrict_kernel<T, kVec<T>, 2>,
      (const void*)jacobi_restrict_kernel<T, kVec<T>, 4>,
      (const void*)jacobi_restrict_kernel<T, kVec<T>, 8>, (const void*)prolong_dots_kernel<T, 1>, (const void*)prolong_dots_kernel<T, kVec<T>>,
      (const void*)update_p_kernel<T, 1>, (const void*)update_p_kernel<T, kVec<T>>,
  };
  for (const void* kernel : kernels) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
  }
  // clusters over the portable 8 blocks
  const void* clustered[] = {(const void*)alpha_kernel<T, 1>, (const void*)alpha_kernel<T, kVec<T>>,
                             (const void*)prolong_dots_kernel<T, 1>,
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
                 void* active, void* k, void* alpha, void* run, void* lane, int L, int P, int Ns,
                 int cluster, int span, int vec, int max_iters, int stall_limit, void* stream) {
  auto launch = [&](auto zero) {
    using T = decltype(zero);
    AlphaArgs<T> a;
    a.p = (const T*)p;
    a.Ap = (const T*)Ap;
    a.rz = (const T*)rz;
    a.r2 = (const T*)r2;
    a.atol2 = (const T*)atol2;
    a.stall = (const int*)stall;
    a.k = (const int*)k;
    a.active = (const uint8_t*)active;
    a.alpha = (T*)alpha;
    a.run = (uint8_t*)run;
    a.lane = (uint8_t*)lane;
    a.P = P;
    a.Ns = Ns;
    a.span = span;
    a.max_iters = max_iters;
    a.stall_limit = stall_limit;
    return launch_alpha<T>(a, L, cluster, vec, (cudaStream_t)stream);
  };
  return dbl ? launch(0.0) : launch(0.0f);
}

int fea_cg_update_xr(int dbl, void* x, void* r, void* p, void* Ap, void* alpha, void* lane, int L,
                     int P, int Ns, int blocks, int span, int vec, void* stream) {
  auto launch = dbl ? launch_update_xr<double> : launch_update_xr<float>;
  return launch(x, r, p, Ap, alpha, lane, L, P, Ns, blocks, span, vec, (cudaStream_t)stream);
}

int fea_cg_jacobi_restrict(int dbl, void* r, void* block_inv, void* arms, void* members, void* zj,
                           void* rc, int L, long long PN, int NA, int W, int span, int vec,
                           int warps, int lanes, int jacobi_first, void* stream) {
  auto launch = dbl ? launch_jacobi_restrict<double> : launch_jacobi_restrict<float>;
  return launch(r, block_inv, arms, members, zj, rc, L, PN, NA, W, span, vec, warps, lanes,
                jacobi_first, (cudaStream_t)stream);
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
                    int Ns, int blocks, int span, int vec, void* stream) {
  auto launch = dbl ? launch_update_p<double> : launch_update_p<float>;
  return launch(p, z, beta, run, lane, L, P, Ns, blocks, span, vec, (cudaStream_t)stream);
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
