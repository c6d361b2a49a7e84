// LinearAttention's attention, from Conv_0's output to Conv_1's input, for
// Hopper (sm_90a), with a plain C interface for ctypes
// (fea_tpu_torch/ops/linear_attention.py binds it).
//
// Replaces no TPU kernel: fea_tpu/models/attention.py:65-66 leaves the two
// einsums to XLA, and the port ran them as a chain of PyTorch operations
// (two concatenations of the memory slots, a softmax of q over d, a scale,
// a softmax of k over n, two strict-f32 cuBLAS products), which cuBLAS runs
// in 32x32 tiles: 8 output tiles for 65,540 pixels at the sampler's b2,
// nearly every SM idle. For qkv (B, 3 H D, N) in contiguous NCHW memory
// (q, k, v at channel offsets 0, H D, 2 H D; head h's channel h D + d) and
// memory_kv (2, H, D, M), D = 32, it computes for each (b, h)
//     K = [mem_k, k], V = [mem_v, v]               (D, M + N) each
//     ctx[d, e] = sum_n softmax_n(K)[d, n] V[e, n]
//     out[e, n] = sum_d ctx[d, e] softmax_d(q)[d, n] * D^-1/2
// into out (B, H D, N), the input of Conv_1.
//
// What bounds it on this card: bytes. It must read k, v and q once and
// write out once, 16 B a pixel and channel of a head: 268 MB at stage 0
// (b2, 4 heads, 65,536 pixels), 0.080 ms at 3.35 TB/s; the 2,048 f32 FMAs
// a pixel and head (both products) take about a quarter of that at the
// card's non-tensor f32 rate, if the operands come from registers.
//
// Design: three launches, none with float atomics, so that a launch repeats
// its bits (and a CUDA graph's replay the eager run).
//  1. context_partial, grid (chunks, B H), 256 threads: the pixel reduction
//     split over blocks, so that the grid fills the card. A block walks its
//     chunk of k and v 64 pixels at a time, each tile's 32 rows of k and of
//     v staged in shared memory by 16-byte cp.async (zero-filled past N;
//     the wrapper takes N a multiple of 4 and qkv 16-byte aligned, as every
//     stage of the FDN-UNet gives), the next tile in flight while this one
//     is used. Per tile: each row's running max m (online: where it rises, the row's
//     running sum and accumulators are rescaled by exp(m_old - m_new)),
//     p = exp(k - m) written over k, the row sums. Then each warp takes 8 of
//     the tile's pixels and each thread an 8 (d) x 4 (e) block of
//     C[d, e] += p[d, n] v[e, n] in registers, the operands as float4s
//     from shared memory (d rows a quarter-warp reads alike are
//     broadcast, e rows fall in distinct banks). At the chunk's end the 8
//     warps' blocks are summed in warp order and the partial (m, s, C)
//     written to scratch the wrapper allocates.
//  2. context_combine, grid (D, B H), a warp: row d of ctx. The memory slots
//     are one more partial: M = max over the slots and the chunks' m;
//     ctx[d, e] = (sum_slots e^(k-M) v + sum_c e^(m_c - M) C_c) /
//     (sum_slots e^(k-M) + sum_c e^(m_c - M) s_c), each sum in a fixed
//     order.
//  3. apply, grid (pixel tiles of 256, B H), 256 threads: the tile's q
//     staged as in 1, each thread the softmax over d of one pixel in
//     registers (times D^-1/2 / sum), then out = ctx^T q as a register-
//     blocked product (a thread 4 e x 8 pixels, ctx's row a uniform float4,
//     q's two float4s from neighbouring threads' addresses), the tile
//     written back through shared memory as coalesced 16-byte stores.
// Strict f32 throughout: FMAs, IEEE division, the accurate expf (no
// fast-math), max-subtracted softmaxes; no tensor cores. The bytes moved
// beyond the bound's: the partials (B H chunks (D D + 2 D) floats, 1.1 MB
// at stage 0) written once and read once.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int D = 32;                // head dim
constexpr int THREADS = 256;         // partial and apply blocks
constexpr int TILE = 64;             // pixels of a partial block's tile (ops TILE)
constexpr int LDT = TILE + 4;        // its row pitch: rows 8 apart in distinct banks
// tiles of k and v in flight or in use: deeper rings (3, 4, 6) measured no
// faster on the H100 at the sampler's shapes
constexpr int STAGES = 2;
constexpr int PARTIAL_BLOCKS = 2;    // partial blocks an SM holds: 123 registers, no spills
static_assert(STAGES * 2 * LDT >= (THREADS / 32) * D,
              "the warps' accumulators fit the staging buffers");
constexpr int APPLY_PIXELS = 256;    // pixels of an apply block
constexpr int LDA = APPLY_PIXELS + 4;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages columns [c0, c0 + COLS) of D rows `pitch` floats apart from `base`
// into dst (D rows of LD floats), 16 bytes a thread (n a multiple of 4,
// base 16-byte aligned); columns at or past n read as zeros.
template <int COLS, int LD>
__device__ __forceinline__ void stage(float* dst, const float* base, long long pitch, int c0,
                                      int n) {
  constexpr int PER_ROW = COLS / 4;
#pragma unroll
  for (int i = threadIdx.x; i < D * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    const bool valid = c0 + c < n;
    cp_async16(dst + r * LD + c, base + r * pitch + (valid ? c0 + c : 0), valid);
  }
}

// Partials of block (chunk c, bh): part_c (BH, chunks, D, D), then part_m
// and part_s (BH, chunks, D).
__global__ void __launch_bounds__(THREADS, PARTIAL_BLOCKS)
    linear_attention_context_partial(const float* __restrict__ qkv, float* __restrict__ part_c,
                                     float* __restrict__ part_m, float* __restrict__ part_s,
                                     int heads, int n, int chunk, int chunks) {
  // STAGES buffers, each a tile of k then one of v; at the end the warps'
  // accumulators
  __shared__ __align__(16) float smem[STAGES * 2 * D * LDT];
  __shared__ float alpha_sh[D];
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long hd = static_cast<long long>(heads) * D;
  const float* kbase = qkv + (b * 3 * hd + hd + static_cast<long long>(h) * D) * n;
  const float* vbase = kbase + hd * n;
  const int n0 = c * chunk, n1 = min(n0 + chunk, n);
  const int tiles = (n1 - n0 + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  // the softmax step: row srow, columns spart * 4 and 32 + spart * 4
  const int srow = tid >> 3, spart = tid & 7;
  float m_run = -INFINITY, s_run = 0.f;
  // the product: warp w takes the tile's columns 8 w to 8 w + 7; a lane
  // rows td + 4 i of p (d) and te + 8 j of v (e)
  const int warp = tid >> 5, lane = tid & 31, td = lane >> 3, te = lane & 7;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // tiles 0 .. STAGES - 2 in flight; one commit group a tile, empty past
  // the chunk, so that tile t's group is always the (t + 1)-th
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) {
      float* buf = smem + t * 2 * D * LDT;
      stage<TILE, LDT>(buf, kbase, n, n0 + t * TILE, n1);
      stage<TILE, LDT>(buf + D * LDT, vbase, n, n0 + t * TILE, n1);
    }
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    float* ks = smem + (t % STAGES) * 2 * D * LDT;
    const float* vs = ks + D * LDT;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t have landed
    __syncthreads();              // everyone's; and tile t - 1 is consumed
    const int ahead = t + STAGES - 1;
    if (ahead < tiles) {          // into tile t - 1's buffer
      float* buf = smem + (ahead % STAGES) * 2 * D * LDT;
      stage<TILE, LDT>(buf, kbase, n, n0 + ahead * TILE, n1);
      stage<TILE, LDT>(buf + D * LDT, vbase, n, n0 + ahead * TILE, n1);
    }
    cp_async_commit();

    // 1. the tile's row max, p = exp(k - m) over k, the row sums
    const int valid = min(TILE, n1 - (n0 + t * TILE));
    float* row = ks + srow * LDT;
    float x[8];
    *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(row + spart * 4);
    *reinterpret_cast<float4*>(x + 4) = *reinterpret_cast<const float4*>(row + 32 + spart * 4);
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 0 : 32) + spart * 4 + (j & 3);
      if (col < valid) tmax = fmaxf(tmax, x[j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, o));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);  // 0 at the first tile
    float tsum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 0 : 32) + spart * 4 + (j & 3);
      x[j] = col < valid ? expf(x[j] - m_new) : 0.f;
      tsum += x[j];
    }
    // a tree every lane of the row walks alike: the same sum in all 8
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) tsum += __shfl_xor_sync(FULL, tsum, o);
    *reinterpret_cast<float4*>(row + spart * 4) = *reinterpret_cast<const float4*>(x);
    *reinterpret_cast<float4*>(row + 32 + spart * 4) = *reinterpret_cast<const float4*>(x + 4);
    s_run = fmaf(s_run, alpha, tsum);
    m_run = m_new;
    if (spart == 0) alpha_sh[srow] = alpha;
    __syncthreads();

    // 2. C = C * alpha + p v^T over the warp's 8 columns
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_sh[td + 4 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a;
    }
#pragma unroll
    for (int cc = 0; cc < 8; cc += 4) {
      const int col = warp * 8 + cc;
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = *reinterpret_cast<const float4*>(vs + (te + 8 * j) * LDT + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(ks + (td + 4 * i) * LDT + col);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(p.x, v[j].x, acc[i][j]);
          acc[i][j] = fmaf(p.y, v[j].y, acc[i][j]);
          acc[i][j] = fmaf(p.z, v[j].z, acc[i][j]);
          acc[i][j] = fmaf(p.w, v[j].w, acc[i][j]);
        }
      }
    }
  }

  // the warps' blocks, summed in warp order
  cp_async_wait<0>();  // no copy is left in flight (the empty groups)
  __syncthreads();     // every warp is done with the tiles
  float* red = smem;   // WARPS x D x D floats, within the staging buffers
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * D * D + (td + 4 * i) * D + te + 8 * j] = acc[i][j];
  __syncthreads();
  const long long slot = static_cast<long long>(bh) * chunks + c;
#pragma unroll
  for (int r = 0; r < D * D / THREADS; ++r) {
    const int idx = tid + r * THREADS;
    float sum = red[idx];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += red[w * D * D + idx];
    part_c[slot * D * D + idx] = sum;
  }
  if (spart == 0) {
    part_m[slot * D + srow] = m_run;
    part_s[slot * D + srow] = s_run;
  }
}

// ctx (BH, D, D) from the partials and the memory slots; block (d, bh), a
// lane per e. The max and the denominator take the chunks 32 at a time
// across the lanes and a butterfly, whose sum every lane forms alike; the
// numerator walks the chunks in order, each chunk's factor from its lane.
__global__ void __launch_bounds__(32)
    linear_attention_context_combine(const float* __restrict__ part_c,
                                     const float* __restrict__ part_m,
                                     const float* __restrict__ part_s,
                                     const float* __restrict__ memory_kv,
                                     float* __restrict__ ctx, int heads, int chunks, int slots) {
  const int d = blockIdx.x, bh = blockIdx.y, h = bh % heads, lane = threadIdx.x;
  const long long first = static_cast<long long>(bh) * chunks;
  const float* pm = part_m + first * D + d;
  const float* ps = part_s + first * D + d;
  const float* pc = part_c + first * D * D + d * D + lane;
  const float* mk = memory_kv + (static_cast<long long>(h) * D + d) * slots;
  const float* mv = memory_kv + ((static_cast<long long>(heads) + h) * D + lane) * slots;
  float m = -INFINITY;
  for (int j = lane; j < slots; j += 32) m = fmaxf(m, mk[j]);
  for (int c = lane; c < chunks; c += 32) m = fmaxf(m, pm[c * D]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float den = 0.f;
  for (int j = lane; j < slots; j += 32) den += expf(mk[j] - m);
  for (int c = lane; c < chunks; c += 32) den = fmaf(expf(pm[c * D] - m), ps[c * D], den);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) den += __shfl_xor_sync(FULL, den, o);
  float num = 0.f;
  for (int j = 0; j < slots; ++j) num = fmaf(expf(mk[j] - m), mv[j], num);
  for (int base = 0; base < chunks; base += 32) {
    const float f = base + lane < chunks ? expf(pm[(base + lane) * D] - m) : 0.f;
    const int count = min(32, chunks - base);
#pragma unroll 8
    for (int i = 0; i < count; ++i)
      num = fmaf(__shfl_sync(FULL, f, i), pc[static_cast<long long>(base + i) * D * D], num);
  }
  ctx[(static_cast<long long>(bh) * D + d) * D + lane] = num / den;
}

// out (B, H D, N) from q and ctx; block (pixel tile, bh).
__global__ void __launch_bounds__(THREADS, 3)
    linear_attention_apply(const float* __restrict__ qkv, const float* __restrict__ ctx,
                           float* __restrict__ out, int heads, int n, float scale) {
  __shared__ __align__(16) float qs[D * LDA];
  __shared__ __align__(16) float cs[D * D];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, tid = threadIdx.x;
  const long long hd = static_cast<long long>(heads) * D;
  const float* qbase = qkv + (b * 3 * hd + static_cast<long long>(h) * D) * n;
  float* obase = out + (b * hd + static_cast<long long>(h) * D) * n;
  const int n0 = blockIdx.x * APPLY_PIXELS;
  stage<APPLY_PIXELS, LDA>(qs, qbase, n, n0, n);
  cp_async_commit();
#pragma unroll
  for (int r = 0; r < D * D / THREADS; ++r)
    cs[tid + r * THREADS] = ctx[static_cast<long long>(bh) * D * D + tid + r * THREADS];
  cp_async_wait<0>();
  __syncthreads();

  // softmax over d of pixel tid, times scale
  {
    float x[D];
    float m = -INFINITY;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = qs[d * LDA + tid];
      m = fmaxf(m, x[d]);
    }
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = expf(x[d] - m);
      sum += x[d];
    }
    const float r = scale / sum;
#pragma unroll
    for (int d = 0; d < D; ++d) qs[d * LDA + tid] = x[d] * r;
  }
  __syncthreads();

  // out[e, p] = sum_d ctx[d, e] q[d, p]: warp w rows e = 4 w .. 4 w + 3, a
  // lane pixels 4 lane .. + 3 and 128 + 4 lane .. + 3
  const int warp = tid >> 5, lane = tid & 31;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 c = *reinterpret_cast<const float4*>(cs + d * D + warp * 4);
    const float4 qa = *reinterpret_cast<const float4*>(qs + d * LDA + lane * 4);
    const float4 qb = *reinterpret_cast<const float4*>(qs + d * LDA + 128 + lane * 4);
    const float cv[4] = {c.x, c.y, c.z, c.w};
    const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], qv[j], acc[i][j]);
  }
  __syncthreads();  // every thread has read q: the tile's buffer takes out
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = qs + (warp * 4 + i) * LDA;
    *reinterpret_cast<float4*>(row + lane * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 128 + lane * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  constexpr int PER_ROW = APPLY_PIXELS / 4;
#pragma unroll
  for (int i = tid; i < D * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    if (n0 + c < n)
      *reinterpret_cast<float4*>(obase + r * static_cast<long long>(n) + n0 + c) =
          *reinterpret_cast<const float4*>(qs + r * LDA + c);
  }
}

cudaError_t launch(const float* qkv, const float* memory_kv, float* out, float* scratch,
                   int batch, int heads, int n, int slots, int chunks, int chunk, float scale,
                   cudaStream_t stream) {
  const unsigned bh = static_cast<unsigned>(batch * heads);
  float* part_c = scratch;
  const long long partials = static_cast<long long>(bh) * chunks;
  float* part_m = part_c + partials * D * D;
  float* part_s = part_m + partials * D;
  float* ctx = part_s + partials * D;
  linear_attention_context_partial<<<dim3(chunks, bh), THREADS, 0, stream>>>(
      qkv, part_c, part_m, part_s, heads, n, chunk, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linear_attention_context_combine<<<dim3(D, bh), 32, 0, stream>>>(
      part_c, part_m, part_s, memory_kv, ctx, heads, chunks, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linear_attention_apply<<<dim3((n + APPLY_PIXELS - 1) / APPLY_PIXELS, bh), THREADS, 0,
                           stream>>>(qkv, ctx, out, heads, n, scale);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t load(Kernel kernel) {
  cudaFuncAttributes attributes;
  return cudaFuncGetAttributes(&attributes, (const void*)kernel);
}

}  // namespace

extern "C" {

// qkv (batch, 3 heads 32, n), memory_kv (2, heads, 32, slots), out (batch,
// heads 32, n), all contiguous f32, n a multiple of 4 and qkv and out 16-byte
// aligned; scratch of fea_linear_attention_scratch_floats floats. Returns
// cudaGetLastError() after the launches (0 when all three were accepted).
int fea_linear_attention_fwd(const void* qkv, const void* memory_kv, void* out, void* scratch,
                             int batch, int heads, int n, int slots, int chunks, int chunk,
                             float scale, void* stream) {
  return launch(static_cast<const float*>(qkv), static_cast<const float*>(memory_kv),
                static_cast<float*>(out), static_cast<float*>(scratch), batch, heads, n, slots,
                chunks, chunk, scale, static_cast<cudaStream_t>(stream));
}

// Floats of scratch a call of `batch * heads` heads in `chunks` chunks takes:
// the partials (C, m, s) and ctx.
long long fea_linear_attention_scratch_floats(int bh, int chunks) {
  return static_cast<long long>(bh) * (static_cast<long long>(chunks) * (D * D + 2 * D) + D * D);
}

// Blocks of the partial kernel that one SM holds at once.
int fea_linear_attention_resident_blocks(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, linear_attention_context_partial, THREADS, 0));
}

// Loads every kernel into the current context, so that none loads lazily at
// its first launch, which may come while a CUDA graph is captured.
int fea_linear_attention_load() {
  cudaError_t err = load(linear_attention_context_partial);
  if (err == cudaSuccess) err = load(linear_attention_context_combine);
  if (err == cudaSuccess) err = load(linear_attention_apply);
  return static_cast<int>(err);
}

const char* fea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
