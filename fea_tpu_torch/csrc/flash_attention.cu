// Flash-attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel fea_tpu/ops/flash_attention.py:_flash_kernel
// (launched by _flash_attention). It computes
//     out = softmax((q * scale) k^T) v
// for q (BH, Nq, D) and k, v (BH, Nk, D), with Nk free to differ from Nq
// (FullAttention prepends learned memory-KV slots), D in {32, 64, 128}, and
// for f32 also 72 (DiT-XL's heads). Inputs are f32 or bf16 and the output
// has q's type. As in the TPU kernel, q is scaled in its own type before the
// f32 cast, the softmax state is f32, and its denominator is clamped at
// 1e-30.
//
// Two kernels; the wrapper (ops/flash_attention.py route) picks one per call
// from its dtype and head dim: for f32 at D 32 flash_fwd_kernel_wgmma after
// the pre-pass flash_fwd_kernel_split_kv, and flash_fwd_kernel (mma.sync)
// for bf16 and for D 64, 72 (f32 only: bf16's m16n8k16 product takes D in
// steps of 16) and 128.
//
// What bounds them on this card: at the serving shape (BH 8, Nq 1024, Nk
// 1028, D 32) the two products are 4 BH Nq Nk D = 1.078 GFLOP against 4.2 MB
// of q/k/v/out, so operations, not bytes; but at 1 GFLOP what limits it in
// practice is latency and how many warps each SM keeps in flight. At stage
// 0 of full attention at 256 px (8, 65536, 65540, 32), 4.4 TFLOP: 8.9 ms at
// the TF32 peak, 26.7 ms for 3xTF32's three products. There the mma.sync
// kernel took 115 ms: each warp re-split every K and V value it read into
// TF32 hi and lo (four of its five splits a score were repeats, 10
// conversions a score on the pipes the softmax needs), and mma.sync does
// not reach Hopper's tensor-core rate. The wgmma kernel splits K, V and q
// once and runs both products with wgmma; what is left a score is the
// softmax and P's split, about 510 instructions a 64-key tile per warp (36
// of them wgmma; 750 with P split by cvt.rna and the exponent by exp2f,
// cuobjdump of the sm_90a build). At full load it is power-bound: 42-45 ms
// a stage-0 call at about 1.8 GHz and 650-690 W of the card's 700 W.
//
// Design of flash_fwd_kernel (mma.sync):
//   - Both products run on the tensor cores with mma.sync. For f32 inputs
//     each operand x is split into hi = tf32(x) and lo = tf32(x - hi) and
//     the product accumulates hi*lo + lo*hi + hi*hi in f32 ("3xTF32"): one
//     TF32 pass keeps ~3 decimal digits, three passes land within ~1e-6 of
//     the plain f32 chain. For bf16 inputs S = (q scale) k^T takes one bf16
//     m16n8k16 product (its products are exact), and P.V splits P into bf16
//     hi and lo (two products against the exact bf16 V), so P is not
//     rounded to 8 bits; only the output is.
//   - A warp owns 16 query rows and keeps their q fragments (split once),
//     its f32 accumulator and its running max and sum in registers; each KV
//     tile's P.V goes into a zeroed tile accumulator and then into the
//     running one by a rounded FMA (the error stays flat in Nk). A block
//     is 4 warps over 32 query rows: two warps per 16-row tile walk the KV
//     tiles in turn (even tiles / odd tiles) and merge their (max, sum, acc)
//     through shared memory at the end. At the serving shape that is 256
//     blocks, 8 warps on each of the 132 SMs.
//   - K/V tiles (64 keys; 32 and 16 for f32 at D 64 and at D 72 and 128, 32
//     for bf16 at D 128; at D 72 tiles of 32 and 64 keys spill registers and
//     ran slower on the card) are copied with cp.async into two
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
//
// Design of the wgmma route (f32, D 32), the same 3xTF32 arithmetic:
//   - flash_fwd_kernel_split_kv writes K and V, split into TF32 hi and lo,
//     into scratch memory once a call, tile by tile in the layout wgmma
//     reads from shared memory (K-major, 128-byte swizzle), V transposed and
//     its keys in the order of P's A fragment, the last tile zero-padded.
//   - A block is two consumer warpgroups of 64 query rows and a producer
//     warp whose one thread copies each 64-key tile (32 KB: K hi, K lo, V^T
//     hi, V^T lo) by a TMA bulk copy into a ring of 4 stages, on mbarriers
//     (full when a tile lands, empty when both consumers are done with it).
//   - A consumer keeps q split into TF32 A fragments in registers, and per
//     tile issues S = q k^T (12 wgmma m64n64k8, A from registers), takes the
//     softmax on the accumulator, splits P into hi and lo A fragments, and
//     issues P.V (24 wgmma m64n32k8) in two halves, the first on the tensor
//     cores while the second's exponents are taken; the two consumers take
//     turns on the tensor cores. The tile's P.V is accumulated apart and
//     added by a rounded FMA, the ragged last tile masked, rows past Nq
//     computed on zeros and not stored, as in the mma.sync kernel.

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
      // the tile's P.V in an accumulator of its own, then one rounded FMA
      // into the running one: the tensor cores' adds into their C operand
      // lose low bits with a bias (about 3e-8 of the output per mma), which
      // over the 12,288 mma of a 65,540-key walk would come to 3e-4
      float pv_tile[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        pv_tile[n][0] = pv_tile[n][1] = pv_tile[n][2] = pv_tile[n][3] = 0.f;
      }
      mma.template pv<BK>(pv_tile, s, ks + C::kTileElems, C::kStride, g, t);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = fmaf(acc[n][i], corr[i >> 1], pv_tile[n][i]);
      }
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
    case 72:  // f32 only: 72 is not a whole number of bf16 k-steps of 16
      if constexpr (sizeof(T) == sizeof(float)) {
        return launch<T, 72>(q, k, v, o, bh, nq, nk, scale, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    case 128:
      return launch<T, 128>(q, k, v, o, bh, nq, nk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The f32 route at D 32: wgmma, K and V split to TF32 once.

constexpr int kWgD = 32;                          // head dim of this route
constexpr int kWgConsumers = 2;                   // consumer warpgroups, 64 query rows each
constexpr int kWgBlockQ = 64 * kWgConsumers;      // query rows per block
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // and one producer warp
constexpr int kWgBlockK = 64;                     // keys per tile
constexpr int kWgStages = 4;                      // tiles in flight in shared memory
constexpr int kWgPartFloats = kWgBlockK * kWgD;   // one of K hi, K lo, V^T hi, V^T lo
constexpr int kWgPartBytes = kWgPartFloats * 4;
constexpr int kWgTileFloats = 4 * kWgPartFloats;  // a tile's image: the four parts in turn
constexpr int kWgTileBytes = kWgTileFloats * 4;
constexpr size_t kWgSmemBytes = size_t(kWgStages) * kWgTileBytes + 1024;  // + alignment
static_assert(kWgBlockK % 32 == 0, "V^T tiles are whole 128-byte swizzle atoms");

// x = hi + lo for the wgmma route: hi = tf32(x) rounded to nearest (as
// cvt.rna rounds finite x), lo = x - hi in f32, whose low 13 bits the tensor
// cores drop when they read it: three instructions, where cvt.rna for both
// parts and the subtraction take seven
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// 2^x, flushing results below 2^-126 to zero: one MUFU.EX2 where exp2f adds
// three instructions for subnormal results
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The image of K and V that the split kernel writes and the attention
// kernel copies tile by tile: per (bh, tile of 64 keys), 4 parts of 64 x 32
// floats, each as shared memory holds it for wgmma (K-major, 128-byte
// swizzle: the 16-byte chunk c of 128-byte row r sits at chunk c ^ (r % 8)).
//   K hi, K lo: row r = key r of the tile, its 32 d contiguous (the B
//     operand of S = q k^T, N = keys, K = d).
//   V^T hi, V^T lo: per 32-key atom a, row dd = d, its 32 keys contiguous
//     (the B operand of o = P v, N = d, K = keys), the keys of each group of
//     8 in the order 0 2 4 6 1 3 5 7: the S accumulator's row of a thread,
//     keys (2t, 2t + 1) of each 8, is then P's A fragment, columns (t, t + 4).
// Keys past nk are zeros. Each value split by split_tf32_fast, once a call
// (the mma.sync kernel splits every K and V value in every warp).
__global__ void __launch_bounds__(256)
    flash_fwd_kernel_split_kv(const float* __restrict__ k, const float* __restrict__ v,
                              float* __restrict__ image, int nk, int tiles) {
  const int tile = blockIdx.x, bh = blockIdx.y;
  const float* kb = k + static_cast<size_t>(bh) * nk * kWgD;
  const float* vb = v + static_cast<size_t>(bh) * nk * kWgD;
  float* out = image + (static_cast<size_t>(bh) * tiles + tile) * kWgTileFloats;
  const int key0 = tile * kWgBlockK;
  auto split4 = [](const float (&x)[4], float* hi, float* lo) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32_fast(x[e], h[e], l[e]);
    *reinterpret_cast<float4*>(hi) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                                 __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo) = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                                 __uint_as_float(l[2]), __uint_as_float(l[3]));
  };
  // K: 8 chunks of 4 d a row
  for (int i = threadIdx.x; i < kWgBlockK * 8; i += blockDim.x) {
    const int r = i / 8, chunk = i % 8, c = chunk ^ (r & 7);  // logical chunk c
    const int key = key0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (key < nk) {
      const float4 f =
          *reinterpret_cast<const float4*>(kb + static_cast<size_t>(key) * kWgD + 4 * c);
      x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    }
    const int at = r * 32 + chunk * 4;
    split4(x, out + at, out + kWgPartFloats + at);
  }
  // V^T: per atom, 32 rows (d) of 8 chunks; logical chunk c holds the keys
  // 8 (c / 2) + 2 e + c % 2 of the atom, e = 0..3
  for (int i = threadIdx.x; i < kWgBlockK * 8; i += blockDim.x) {
    const int atom = i / 256, dd = (i / 8) % 32, chunk = i % 8, c = chunk ^ (dd & 7);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 32 * atom + 8 * (c / 2) + 2 * e + (c & 1);
      x[e] = key < nk ? vb[static_cast<size_t>(key) * kWgD + dd] : 0.f;
    }
    const int at = 2 * kWgPartFloats + atom * 32 * 32 + dd * 32 + chunk * 4;
    split4(x, out + at, out + kWgPartFloats + at);
  }
}

// a wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset, unused in this layout, is 1), at
// the shared-memory address `addr`
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d = a b (scale_d 0) or d += a b, one wgmma of 64 x 8 TF32 by 8 x N (N = 2
// size(d)): the A fragment in registers (rows g, g + 8, g, g + 8 of the
// warp's 16, columns t, t, t + 4, t + 4), B K-major in shared memory at the
// descriptor `desc`
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keeps the compiler from moving reads of wgmma's registers across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// waits until the mbarrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();  // a phase that never completes: fail, not hang
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  __syncwarp();  // the warp's next wgmma is .aligned
}
// a tile's image from global `src` to shared `dst` by the TMA, completing
// on the mbarrier `bar`
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kWgTileBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(kWgTileBytes), "r"(bar)
      : "memory");
}

// A consumer warpgroup's 64 query rows and its walk over the key tiles. Per
// thread: q's TF32 hi and lo A fragments (rows g and g + 8 of its warp's 16,
// columns 8 ks + (t, t + 4)), split once; the running max and this thread's
// share of the sum of those rows; the output accumulator (element 4 n + i at
// row g + 8 ((i >> 1) & 1), column 8 n + 2 t + (i & 1), as every wgmma
// accumulator); a tile's scores s, P's hi and lo A fragments and its P.V.
struct WgWalk {
  uint32_t qh[kWgD / 8][4], ql[kWgD / 8][4];
  float acc[kWgD / 2];
  float m[2], l[2], corr[2], m_scaled[2];
  float s[kWgBlockK / 2], pv[kWgD / 2];
  uint32_t ph[kWgBlockK / 8][4], pl[kWgBlockK / 8][4];
  int nk, t;

  // q0: the warp's first row, `rows` of them before nq
  __device__ __forceinline__ void load_q(const float* q0, int rows, float scale, int g) {
#pragma unroll
    for (int ks = 0; ks < kWgD / 8; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), c = 8 * ks + t + 4 * (i >> 1);
        const float x = r < rows ? q0[r * kWgD + c] * scale : 0.f;
        split_tf32_fast(x, qh[ks][i], ql[ks][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kWgD / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // s = (q scale) k^T over the tile at `tile` (3xTF32, the small terms
  // first); a descriptor plus n addresses 16 n bytes further on
  __device__ __forceinline__ void issue_scores(uint32_t tile) {
    const uint64_t kd = smem_desc(tile);
#pragma unroll
    for (int ks = 0; ks < kWgD / 8; ++ks) {
      const uint64_t kh = kd + 2 * ks, kl = kd + kWgPartBytes / 16 + 2 * ks;
      wgmma_tf32(s, qh[ks], kl, ks);
      wgmma_tf32(s, ql[ks], kh, 1);
      wgmma_tf32(s, qh[ks], kh, 1);
    }
  }

  // pv (+)= P v over the 8-key steps [K0, K1) of the tile at `tile` (3xTF32)
  template <int K0, int K1>
  __device__ __forceinline__ void issue_pv(uint32_t tile) {
    const uint64_t vd = smem_desc(tile + 2 * kWgPartBytes);
#pragma unroll
    for (int kk = K0; kk < K1; ++kk) {
      const uint64_t vh = vd + (kk / 4) * 32 * 128 / 16 + (kk % 4) * 2;  // atom, 8 keys
      const uint64_t vl = vh + kWgPartBytes / 16;
      wgmma_tf32(pv, ph[kk], vl, kk);
      wgmma_tf32(pv, pl[kk], vh, 1);
      wgmma_tf32(pv, ph[kk], vh, 1);
    }
  }

  // the scores of a tile whose keys from `valid` on are padding: masked,
  // the running max, the factor corr that rescales what came before, the
  // sum rescaled
  __device__ __forceinline__ void softmax_max(int valid) {
    if (valid < kWgBlockK) {
#pragma unroll
      for (int i = 0; i < kWgBlockK / 2; ++i) {
        if (8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
      }
    }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kWgBlockK / 2; ++i) {
      tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the quad of 4 lanes holds the row
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      const float m_new = fmaxf(m[h], tile_max[h]);  // finite: the tile has a key
      corr[h] = ex2_ftz((m[h] - m_new) * kLog2e);     // 0 on the first tile
      m[h] = m_new;
      m_scaled[h] = m_new * kLog2e;
      l[h] *= corr[h];
    }
  }

  // P of the 8-key steps [K0, K1): exponents, the sum, P split into TF32 hi
  // and lo A fragments (A column t is key 2t of each 8, column t + 4 key
  // 2t + 1: the order of the V^T image)
  template <int K0, int K1>
  __device__ __forceinline__ void softmax_exp() {
#pragma unroll
    for (int i = 4 * K0; i < 4 * K1; ++i) {
      s[i] = ex2_ftz(fmaf(s[i], kLog2e, -m_scaled[(i >> 1) & 1]));  // -inf -> 0
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int kk = K0; kk < K1; ++kk) {
      split_tf32_fast(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
      split_tf32_fast(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split_tf32_fast(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split_tf32_fast(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
  }

  // tile j (at `tile`, behind the barrier `full` in its phase of parity
  // `parity`; its stage's barrier `empty` released once its products are
  // done): the scores, then P.V in two halves, the first half's product on
  // the tensor cores while the second half's exponents are taken; the
  // tile's P.V, accumulated apart, into the running output by one rounded
  // FMA (the tensor cores' adds into their accumulator lose low bits with a
  // bias, which over a 65,540-key walk would come to 3e-4)
  __device__ __forceinline__ void step(int j, uint32_t tile, uint32_t full, uint32_t parity,
                                       uint32_t empty) {
    constexpr int kHalf = kWgBlockK / 16;
    mbar_wait(full, parity);
    wgmma_fence();
    issue_scores(tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_max(nk - j * kWgBlockK);
    softmax_exp<0, kHalf>();
    wgmma_fence();
    issue_pv<0, kHalf>(tile);
    wgmma_commit();
    softmax_exp<kHalf, 2 * kHalf>();
    wgmma_fence();
    issue_pv<kHalf, 2 * kHalf>(tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    mbar_arrive(empty);
#pragma unroll
    for (int i = 0; i < kWgD / 2; ++i) acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
  }

  // out = acc / sum for the rows below nq; o0 the warp's first row
  __device__ __forceinline__ void store(float* o0, int rows, int g) const {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[h] = 1.f / fmaxf(sum, 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < kWgD / 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r < rows) {
          *reinterpret_cast<float2*>(o0 + r * kWgD + 8 * n + 2 * t) =
              make_float2(acc[4 * n + 2 * h] * inv[h], acc[4 * n + 2 * h + 1] * inv[h]);
        }
      }
    }
  }
};

// Grid (ceil(nq / 128), bh). Warps 0-7 are two consumer warpgroups of 64
// query rows; lane 0 of warp 8 copies the tiles of `image`
// (flash_fwd_kernel_split_kv) into a ring of kWgStages stages, each stage's
// `full` barrier completing when its tile has landed and its `empty` barrier
// when both consumers are done with it. The two consumers take their turns
// on the tensor cores as their softmaxes allow.
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_kernel_wgmma(const float* __restrict__ q, const float* __restrict__ image,
                           float* __restrict__ o, int nq, int nk, int tiles, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kWgStages];  // full, then empty
  // the swizzle is on address bits 4-9: each tile starts on 1024 bytes
  const uint32_t smem0 =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto full = [&](int j) { return bar0 + 8 * (j % kWgStages); };
  auto empty = [&](int j) { return bar0 + 8 * (kWgStages + j % kWgStages); };
  auto tile_at = [&](int j) { return smem0 + (j % kWgStages) * kWgTileBytes; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  if (tid == 0) {
    for (int j = 0; j < kWgStages; ++j) {
      mbar_init(full(j), 1);
      mbar_init(empty(j), 128 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWgConsumers) {  // the producer
    if (lane == 0) {
      const float* src = image + static_cast<size_t>(bh) * tiles * kWgTileFloats;
      for (int j = 0; j < tiles; ++j) {
        if (j >= kWgStages) mbar_wait(empty(j), (j / kWgStages - 1) & 1);
        load_tile(tile_at(j), src + static_cast<size_t>(j) * kWgTileFloats, full(j));
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int row0 = blockIdx.x * kWgBlockQ + warp * 16;  // the warp's first row
  WgWalk walk;
  walk.nk = nk;
  walk.t = lane & 3;
  walk.load_q(q + (static_cast<size_t>(bh) * nq + row0) * kWgD, nq - row0, scale, g);
  for (int j = 0; j < tiles; ++j) {
    walk.step(j, tile_at(j), full(j), (j / kWgStages) & 1, empty(j));
  }
  walk.store(o + (static_cast<size_t>(bh) * nq + row0) * kWgD, nq - row0, g);
}

size_t wgmma_image_floats(int bh, int nk) {
  return static_cast<size_t>(bh) * ((nk + kWgBlockK - 1) / kWgBlockK) * kWgTileFloats;
}

cudaError_t launch_wgmma(const float* q, const float* k, const float* v, float* o, float* image,
                         int bh, int nq, int nk, float scale, cudaStream_t stream) {
  const int tiles = (nk + kWgBlockK - 1) / kWgBlockK;
  flash_fwd_kernel_split_kv<<<dim3(tiles, bh), 256, 0, stream>>>(k, v, image, nk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWgSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kWgBlockQ - 1) / kWgBlockQ, bh);
  flash_fwd_kernel_wgmma<<<grid, kWgThreads, kWgSmemBytes, stream>>>(q, image, o, nq, nk, tiles,
                                                                     scale);
  return cudaGetLastError();
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

// The route for f32 at D 32 (ops/flash_attention.py route):
// q, k, v, o as above (f32), and `image` device scratch of
// fea_flash_attention_wgmma_image_floats(bh, nk) floats, 16-byte aligned,
// that the split kernel fills before the attention kernel reads it.
// Launches both on `stream`; returns the cudaError_t (0 on success).
extern "C" int fea_flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                             void* o, void* image, int bh, int nq, int nk,
                                             float scale, void* stream) {
  if (bh < 1 || bh > 65535 || nq < 1 || nk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_wgmma(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(image), bh, nq, nk, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" long long fea_flash_attention_wgmma_image_floats(int bh, int nk) {
  return static_cast<long long>(wgmma_image_floats(bh, nk));
}

extern "C" const char* fea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
