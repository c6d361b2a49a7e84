// Flash-attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel fea_tpu/ops/flash_attention.py:_flash_kernel
// (launched by _flash_attention). It computes
//     out = softmax((q * scale) k^T) v
// for q (BH, Nq, D) and k, v (BH, Nk, D), with Nk free to differ from Nq
// (FullAttention prepends learned memory-KV slots), D in {32, 64, 128}.
// Inputs are f32 or bf16 and the output has q's type. As in the TPU kernel,
// q is scaled in its own type before the f32 cast, the softmax state is
// f32, and its denominator is clamped at 1e-30.
//
// What bounds it on this card: at the serving shape (BH 8, Nq 1024, Nk 1028,
// D 32) the two products are 4 BH Nq Nk D = 1.078 GFLOP against 4.2 MB of
// q/k/v/out, so operations, not bytes; but at 1 GFLOP what limits it in
// practice is latency and how many warps each SM keeps in flight.
//
// Design:
//   - Both products run on the tensor cores with mma.sync. For f32 inputs
//     each operand x is split into hi = tf32(x) and lo = tf32(x - hi) and
//     the product accumulates hi*lo + lo*hi + hi*hi in f32 ("3xTF32"): one
//     TF32 pass keeps ~3 decimal digits, three passes land within ~1e-6 of
//     the plain f32 chain. For bf16 inputs S = (q scale) k^T takes one bf16
//     m16n8k16 product (its products are exact), and P.V splits P into bf16
//     hi and lo (two products against the exact bf16 V), so P is not
//     rounded to 8 bits; only the output is.
//   - A warp owns 16 query rows and keeps their q fragments (split once),
//     its f32 accumulator and its running max and sum in registers. A block
//     is 4 warps over 32 query rows: two warps per 16-row tile walk the KV
//     tiles in turn (even tiles / odd tiles) and merge their (max, sum, acc)
//     through shared memory at the end. At the serving shape that is 256
//     blocks, 8 warps on each of the 132 SMs.
//   - K/V tiles (64 keys; 32 and 16 for f32 at D 64 and 128, 32 for bf16 at
//     D 128) are copied with cp.async into two
//     shared-memory stages, so the next pair of tiles loads while the
//     current one is multiplied. Rows are padded by 16 bytes, which puts
//     the 32 lanes of every fragment load on 32 different banks.
//   - P stays in registers between the products. For TF32 the key order of
//     the P.V product is permuted (A column t is key 2t, column t + 4 is key
//     2t + 1) so that the S accumulator is P's A fragment without shuffles;
//     V's B fragment reads the same permuted keys.
//   - The ragged last KV tile (4 of 64 keys at Nk 1028) is zero-filled by
//     cp.async and masked to -inf before the row max; query rows past Nq
//     compute on zeros and are not stored. A warp whose turn has no keys
//     skips the tile, and the merge gives it weight exp(-inf) = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplits = 2;                        // warps that share a row tile's KV walk
constexpr int kRowTiles = kWarps / kSplits;       // 16-row tiles per block
constexpr int kBlockQ = 16 * kRowTiles;           // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  // keys per tile: 64 while a q row is at most 128 bytes, then fewer, so
  // that q, the scores and the accumulator stay in registers
  static constexpr int kBlockK = D * sizeof(T) <= 128 ? 64 : D * sizeof(T) <= 256 ? 32 : 16;
  static constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte copy
  static constexpr int kStride = D + kVec;            // padded shared-memory row
  static constexpr int kTileElems = kBlockK * kStride;
  static constexpr int kStageElems = kSplits * 2 * kTileElems;  // (K, V) per split
  static constexpr size_t kSmemBytes = 2 * kStageElems * sizeof(T);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, ah, bl);
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// two floats as bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// bf16 hi and lo parts of (a, b): lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4: the f32 accumulator c[0..3] holds rows
// (g, g, g + 8, g + 8), columns (2t, 2t + 1, 2t, 2t + 1).
template <typename T, int D>
struct Mma;

template <int D>
struct Mma<float, D> {
  // q (scaled) as A fragments: rows (g, g + 8, g, g + 8), columns
  // 8 ks + (t, t, t + 4, t + 4), split into TF32 hi and lo once
  uint32_t qh[D / 8][4], ql[D / 8][4];

  __device__ __forceinline__ void load_q(const float* q0, int rows, float scale, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), c = 8 * ks + t + 4 * (i >> 1);
        const float x = r < rows ? q0[r * D + c] * scale : 0.f;
        split_tf32(x, qh[ks][i], ql[ks][i]);
      }
    }
  }

  // s[n] = q k^T for keys 8n .. 8n + 7 of the tile
  template <int BK>
  __device__ __forceinline__ void scores(float (&s)[BK / 8][4], const float* ks_, int stride,
                                         int g, int t) const {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const float* kr = ks_ + (8 * n + g) * stride + 8 * ks + t;  // B: (k = d, n = key)
        uint32_t bh[2], bl[2];
        split_tf32(kr[0], bh[0], bl[0]);
        split_tf32(kr[4], bh[1], bl[1]);
        mma_3xtf32(s[n], qh[ks], ql[ks], bh, bl);
      }
    }
  }

  // o += p v over the tile, in the permuted key order (A column t is key
  // 2t, column t + 4 is key 2t + 1), so p's accumulator is its A fragment
  template <int BK>
  __device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[BK / 8][4],
                                     const float* vs, int stride, int g, int t) const {
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* vr = vs + (8 * kk + 2 * t) * stride + 8 * n + g;
        uint32_t bh[2], bl[2];
        split_tf32(vr[0], bh[0], bl[0]);
        split_tf32(vr[stride], bh[1], bl[1]);
        mma_3xtf32(o[n], ah, al, bh, bl);
      }
    }
  }

  static __device__ __forceinline__ void store2(float* out, float a, float b) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  }
};

template <int D>
struct Mma<__nv_bfloat16, D> {
  // q (scaled in bf16) as A fragments: rows (g, g + 8, g, g + 8), column
  // pairs 16 ks + (2t, 2t, 2t + 8, 2t + 8)
  uint32_t qf[D / 16][4];

  __device__ __forceinline__ void load_q(const __nv_bfloat16* q0, int rows, float scale, int g,
                                         int t) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), c = 16 * ks + 2 * t + 8 * (i >> 1);
        float a = 0.f, b = 0.f;
        if (r < rows) {
          a = __bfloat162float(q0[r * D + c]) * scale;
          b = __bfloat162float(q0[r * D + c + 1]) * scale;
        }
        qf[ks][i] = pack_bf16(a, b);
      }
    }
  }

  template <int BK>
  __device__ __forceinline__ void scores(float (&s)[BK / 8][4], const __nv_bfloat16* ks_,
                                         int stride, int g, int t) const {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* kr = ks_ + (8 * n + g) * stride + 16 * ks + 2 * t;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                               *reinterpret_cast<const uint32_t*>(kr + 8)};
        mma_bf16(s[n], qf[ks], b);
      }
    }
  }

  // o += (p_hi + p_lo) v; keys 16i .. 16i + 15 are s tiles 2i and 2i + 1,
  // whose accumulators are already the A fragment's column pairs
  template <int BK>
  __device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[BK / 8][4],
                                     const __nv_bfloat16* vs, int stride, int g, int t) const {
    const unsigned short* vb = reinterpret_cast<const unsigned short*>(vs);
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      uint32_t ah[4], al[4];
      split_bf16(p[2 * i][0], p[2 * i][1], ah[0], al[0]);
      split_bf16(p[2 * i][2], p[2 * i][3], ah[1], al[1]);
      split_bf16(p[2 * i + 1][0], p[2 * i + 1][1], ah[2], al[2]);
      split_bf16(p[2 * i + 1][2], p[2 * i + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const unsigned short* vr = vb + (16 * i + 2 * t) * stride + 8 * n + g;
        const uint32_t b[2] = {vr[0] | (static_cast<uint32_t>(vr[stride]) << 16),
                               vr[8 * stride] | (static_cast<uint32_t>(vr[9 * stride]) << 16)};
        mma_bf16(o[n], al, b);
        mma_bf16(o[n], ah, b);
      }
    }
  }

  static __device__ __forceinline__ void store2(__nv_bfloat16* out, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  }
};

// Copy the K and V tiles of iteration `it` (tile it * kSplits + split for
// each split) into one shared-memory stage; keys past nk are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_stage(T* stage, const T* k, const T* v, int nk, int it,
                                           int tid) {
  using C = Cfg<T, D>;
  constexpr int kPerRow = D / C::kVec;
  constexpr int kPerTile = C::kBlockK * kPerRow;
  constexpr int kTotal = kSplits * 2 * kPerTile;
  static_assert(kTotal % kThreads == 0, "copies split evenly over the block");
#pragma unroll
  for (int j = 0; j < kTotal / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int slot = i / kPerTile;  // split * 2 + (0 for K, 1 for V)
    const int r = (i % kPerTile) / kPerRow, col = (i % kPerRow) * C::kVec;
    const int key = (it * kSplits + (slot >> 1)) * C::kBlockK + r;
    const bool valid = key < nk;
    const T* src = (slot & 1) ? v : k;
    cp_async16(stage + slot * C::kTileElems + r * C::kStride + col,
               src + (valid ? static_cast<size_t>(key) * D + col : 0), valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int nq, int nk, float scale) {
  using C = Cfg<T, D>;
  constexpr int BK = C::kBlockK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = warp / kRowTiles, rt = warp % kRowTiles;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ + rt * 16;
  const T* kb = k + static_cast<size_t>(bh) * nk * D;
  const T* vb = v + static_cast<size_t>(bh) * nk * D;

  const int tiles = (nk + BK - 1) / BK;
  const int iters = (tiles + kSplits - 1) / kSplits;
  load_stage<T, D>(smem, kb, vb, nk, 0, tid);
  cp_async_commit();

  Mma<T, D> mma;
  mma.load_q(q + (static_cast<size_t>(bh) * nq + row0) * D, nq - row0, scale, g, t);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows g and g + 8: running max, and this thread's share of the sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) {
      load_stage<T, D>(smem + ((it + 1) & 1) * C::kStageElems, kb, vb, nk, it + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage has landed for every thread
    const int valid = min(BK, nk - (it * kSplits + split) * BK);
    if (valid > 0) {
      const T* ks = smem + (it & 1) * C::kStageElems + split * 2 * C::kTileElems;
      float s[BK / 8][4];
      mma.template scores<BK>(s, ks, C::kStride, g, t);
      if (valid < BK) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (8 * n + 2 * t + (i & 1) >= valid) s[n][i] = -INFINITY;
          }
        }
      }
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        tile_max[0] = fmaxf(tile_max[0], fmaxf(s[n][0], s[n][1]));
        tile_max[1] = fmaxf(tile_max[1], fmaxf(s[n][2], s[n][3]));
      }
      float m_scaled[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the quad of 4 lanes holds the row
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
        const float m_new = fmaxf(m[h], tile_max[h]);  // finite: the tile has a key
        corr[h] = exp2f((m[h] - m_new) * kLog2e);       // 0 on the first tile
        m[h] = m_new;
        m_scaled[h] = m_new * kLog2e;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = exp2f(fmaf(s[n][i], kLog2e, -m_scaled[i >> 1]));  // -inf -> 0
          l[i >> 1] += s[n][i];
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];
      }
      mma.template pv<BK>(acc, s, ks + C::kTileElems, C::kStride, g, t);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the two walks of each row tile: split 1 hands its state over
  float* state = reinterpret_cast<float*>(smem_raw);
  constexpr int kState = 4 + D / 2;  // m[2], l[2], acc
  auto at = [&](int j) -> float& { return state[(j * kRowTiles + rt) * 32 + lane]; };
  if (split == 1) {
    at(0) = m[0], at(1) = m[1], at(2) = l[0], at(3) = l[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) at(4 + 4 * n + i) = acc[n][i];
    }
  }
  __syncthreads();
  if (split != 0) return;
  static_assert(kSplits == 2, "the merge takes one partner walk");
  float w_self[2], w_other[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_other = at(h);
    const float m_new = fmaxf(m[h], m_other);  // m[h] is finite: tile 0 has a key
    w_self[h] = exp2f((m[h] - m_new) * kLog2e);
    w_other[h] = exp2f((m_other - m_new) * kLog2e);  // 0 if the partner saw no key
    float sum = l[h] * w_self[h] + at(2 + h) * w_other[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[h] = 1.f / fmaxf(sum, 1e-30f);
  }
  static_assert(kState <= C::kStageElems * sizeof(T) / sizeof(float) / (kRowTiles * 32),
                "the merge state fits in the stages");
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      const float a = (acc[n][2 * h] * w_self[h] + at(4 + 4 * n + 2 * h) * w_other[h]) * l[h];
      const float b =
          (acc[n][2 * h + 1] * w_self[h] + at(5 + 4 * n + 2 * h) * w_other[h]) * l[h];
      if (row < nq) {
        Mma<T, D>::store2(o + (static_cast<size_t>(bh) * nq + row) * D + 8 * n + 2 * t, a, b);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int nq,
                   int nk, float scale, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), nq, nk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int bh, int nq,
                     int nk, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, nq, nk, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, nq, nk, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, nq, nk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: device pointers to contiguous (bh, nq|nk, d) arrays of one
// type, 16-byte aligned: f32 when is_bf16 is 0, bf16 otherwise. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int fea_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int bh, int nq, int nk, int d, int is_bf16, float scale,
                                       void* stream) {
  if (bh < 1 || bh > 65535 || nq < 1 || nk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
                              ? launch_d<__nv_bfloat16>(q, k, v, o, bh, nq, nk, d, scale, s)
                              : launch_d<float>(q, k, v, o, bh, nq, nk, d, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* fea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
