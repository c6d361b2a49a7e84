// The flat chunk's stiffness operator K u over the band's non-zeros, for
// Hopper (sm_90a), with a plain C interface for ctypes
// (fea_tpu_torch/ops/band.py binds it).
//
// Replaces fea_tpu/fem/banded.py:161 banded_matvec as the chunk's CG loop
// runs it (fea_tpu/fem/flatgroup.py:296-299, and the loop's two free masks,
// fea_tpu/fem/solver.py: operator(u * free) * free): y = free * K (free * u)
// on planar vectors, where the TPU read a dense block-shifted band S (every
// row W = 2 hb + 128 slots wide, some 98% of them exact zeros at hb 256) in
// one batched product, and the port then queued eight torch kernels a body
// around it (the masks, the planar / interleaved transposes, the window
// gather).
//
// Layout (fem/banded.py band_tables): rows and columns are planar dofs
// (comp * n + node). cols (n_slices, slots, 32) int32 holds each row's
// columns in ascending interleaved order, padded with -1; vals (C, n_slices,
// slots, 32) each lane's values, the free masks folded in at set-up (exact
// for masks of 0 and 1); widths (n_slices,) int32 the widest row of each
// slice (fem/banded.py slice_widths); u and y (C, n_dofs). A slice is 32
// rows, slot-major, so a slice's first w slots are one contiguous range of
// each table.
//
// What bounds it on this card: bytes. Each value is read once and used in
// one FMA, far under the card's operations per byte. The least it must move
// is the lanes' non-zero values, their column indices once, u and y: about
// 14 MB a body at the production chunk, against the 0.67 GB of the dense
// band. u of a chunk (1 MB) stays in L2, so its gathers cost little.
//
// Design: a block takes SLICES slices for up to LANES lanes. One thread
// stages them into shared memory with TMA bulk copies (cp.async.bulk, no
// registers or instructions spent per byte): for each slice, its first
// `width` slots of cols and of each lane's values, three to five
// contiguous ranges completing on the slice's own mbarrier, so that all of
// the block's table bytes are in flight together and no slice's padding
// past its widest row is read. A warp per (slice, lane), a thread per row,
// waits for its slice alone, then runs the slice's width with predicated,
// not breaking, loads: the row's columns come from shared memory, so the
// gathers of u for UNROLL slots go out together. It sums the row's slots in
// their order (ascending column) by FMA in the working type, exactly as one
// thread per row did before, and writes y in planar order. No atomics and
// no tensor cores (FEM math stays out of TF32); the same inputs give the
// same bits.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;   // rows of a slice (fem/banded.py ELL_ROWS)
constexpr int SLICES = 4;  // slices of a block
constexpr int LANES = 4;   // lanes of a block
constexpr int THREADS = ROWS * SLICES * LANES;
constexpr int UNROLL = 8;  // slots whose gathers of u go out together
// dynamic shared memory a block may take (ops/band.py MAX_SHARED): under
// the 227 KiB of sm_90, beside the static barriers
constexpr int MAX_SHARED = 200 * 1024;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the TMA; completes on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(shared_address(dst)), "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// Waits until the mbarrier `bar` completes its first phase
__device__ __forceinline__ void wait_first_phase(unsigned long long* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_address(bar))
        : "memory");
  }
}

// bytes of shared memory a block takes at `slots` slots a row (ops/band.py
// shared_bytes)
template <typename T>
constexpr long long shared_bytes(int slots) {
  return (long long)SLICES * slots * ROWS * ((long long)LANES * sizeof(T) + sizeof(int));
}

// Grid (ceil(n_slices / SLICES), ceil(C / LANES)): the block (b, g) takes
// the slices [b SLICES, ...) for the lanes [g LANES, ...). Shared memory:
// the values (LANES, SLICES, slots, ROWS), then the columns (SLICES, slots,
// ROWS); of each slice only its first `width` slots are copied and read.
template <typename T>
__global__ void __launch_bounds__(THREADS, 16 / sizeof(T)) band_matvec_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, const int* __restrict__ widths,
    const T* __restrict__ u, T* __restrict__ y, int C, int n_dofs, int n_slices, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long landed[SLICES];  // a slice's tables are in
  T* sv = reinterpret_cast<T*>(smem);
  int* sc = reinterpret_cast<int*>(smem + (size_t)LANES * SLICES * slots * ROWS * sizeof(T));
  const int slice0 = blockIdx.x * SLICES, l0 = blockIdx.y * LANES;
  const int ns = min(SLICES, n_slices - slice0), nl = min(LANES, C - l0);
  if (threadIdx.x == 0) {
    for (int j = 0; j < SLICES; ++j) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(&landed[j]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const long long lane_stride = (long long)n_slices * slots * ROWS;
    for (int j = 0; j < ns; ++j) {
      const long long at = (long long)(slice0 + j) * slots * ROWS;
      const int w = max(0, min(slots, widths[slice0 + j]));
      const unsigned col_bytes = w * ROWS * sizeof(int), val_bytes = w * ROWS * sizeof(T);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(shared_address(&landed[j])), "r"(col_bytes + nl * val_bytes)
                   : "memory");
      if (w == 0) continue;
      bulk_copy(sc + j * slots * ROWS, cols + at, col_bytes, &landed[j]);
      for (int a = 0; a < nl; ++a) {
        bulk_copy(sv + (a * SLICES + j) * slots * ROWS, vals + (l0 + a) * lane_stride + at,
                  val_bytes, &landed[j]);
      }
    }
  }
  __syncthreads();  // the barriers are set up

  const int warp = threadIdx.x / ROWS, lid = threadIdx.x % ROWS;
  const int j = warp % SLICES, a = warp / SLICES;
  if (j >= ns || a >= nl) return;
  const int w = max(0, min(slots, widths[slice0 + j]));
  wait_first_phase(&landed[j]);
  const int* c_row = sc + j * slots * ROWS + lid;
  const T* v_row = sv + (a * SLICES + j) * slots * ROWS + lid;
  const T* x = u + (long long)(l0 + a) * n_dofs;
  T acc = T(0);
  for (int s0 = 0; s0 < w; s0 += UNROLL) {
    int c[UNROLL];
    T xu[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      c[k] = s0 + k < w ? c_row[(s0 + k) * ROWS] : -1;  // -1: the row's pads, after its columns
      xu[k] = c[k] >= 0 ? __ldg(x + c[k]) : T(0);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (c[k] >= 0) acc = fma_rn(v_row[(s0 + k) * ROWS], xu[k], acc);
    }
  }
  const int row = (slice0 + j) * ROWS + lid;
  if (row < n_dofs) y[(long long)(l0 + a) * n_dofs + row] = acc;
}

template <typename T>
int launch(const void* vals, const void* cols, const void* widths, const void* u, void* y, int C,
           int n_dofs, int slots, cudaStream_t stream) {
  const long long smem = shared_bytes<T>(slots);
  if (smem > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const int n_slices = (n_dofs + ROWS - 1) / ROWS;
  const dim3 grid((n_slices + SLICES - 1) / SLICES, (C + LANES - 1) / LANES);
  band_matvec_kernel<T><<<grid, THREADS, (size_t)smem, stream>>>(
      (const T*)vals, (const int*)cols, (const int*)widths, (const T*)u, (T*)y, C, n_dofs,
      n_slices, slots);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t load_kernel() {
  // the dynamic shared memory a launch may ask for, set here and not at a
  // launch, which may come while a CUDA graph is captured
  return cudaFuncSetAttribute((const void*)band_matvec_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
}

}  // namespace

extern "C" {

// `dbl` selects the type: 0 float, 1 double. Returns cudaGetLastError()
// after the launch (0 when it was accepted).
int fea_band_matvec(int dbl, const void* vals, const void* cols, const void* widths,
                    const void* u, void* y, int C, int n_dofs, int slots, void* stream) {
  auto fn = dbl ? launch<double> : launch<float>;
  return fn(vals, cols, widths, u, y, C, n_dofs, slots, (cudaStream_t)stream);
}

// Loads both instances into the current context with their shared memory
// allowed, so that neither loads lazily at its first launch, which may come
// while a CUDA graph is captured.
int fea_band_load() {
  cudaError_t err = load_kernel<float>();
  if (err == cudaSuccess) err = load_kernel<double>();
  return (int)err;
}

const char* fea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
