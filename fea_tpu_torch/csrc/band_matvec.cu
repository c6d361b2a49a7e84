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
// for masks of 0 and 1); u and y (C, n_dofs). A slice is 32 rows, slot-major,
// so a warp's 32 rows read 32 neighbouring words of each table per slot.
//
// What bounds it on this card: bytes. Each value is read once and used in
// one FMA, far under the card's operations per byte. The least it must move
// is the lanes' non-zero values, their column indices once, u and y: about
// 15-20 MB a body at the production chunk, against the 0.67 GB of the dense
// band. u of a chunk (1 MB) stays in L2, so its gathers cost little.
//
// Design (a simple kernel that is right first): one thread per row serves
// every lane: it reads the row's columns once and, for up to LANES lanes at a
// time, each lane's values, and gathers u. It sums the row's slots in their
// order (ascending column) by FMA in the working type and writes y in planar
// order. No atomics and no tensor cores (FEM math stays out of TF32); the
// same inputs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 32;  // rows of a slice (fem/banded.py ELL_ROWS)
constexpr int LANES = 4;  // lanes summed per pass over a row's columns

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(THREADS) band_matvec_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, const T* __restrict__ u,
    T* __restrict__ y, int C, int n_dofs, int slots, long long lane_stride) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_dofs) return;
  const long long base = (long long)(r / ROWS) * slots * ROWS + (r % ROWS);
  for (int l0 = 0; l0 < C; l0 += LANES) {
    const int nl = min(LANES, C - l0);
    const T* v = vals + l0 * lane_stride + base;
    const T* x = u + (long long)l0 * n_dofs;
    T acc[LANES];
#pragma unroll
    for (int j = 0; j < LANES; ++j) acc[j] = T(0);
    for (int s = 0; s < slots; ++s) {
      const int c = __ldg(cols + base + (long long)s * ROWS);
      if (c < 0) break;  // the row's pads, after its columns
#pragma unroll
      for (int j = 0; j < LANES; ++j) {
        if (j < nl) {
          acc[j] = fma_rn(__ldg(v + j * lane_stride + (long long)s * ROWS),
                          __ldg(x + (long long)j * n_dofs + c), acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      if (j < nl) y[(long long)(l0 + j) * n_dofs + r] = acc[j];
    }
  }
}

template <typename T>
int launch(const void* vals, const void* cols, const void* u, void* y, int C, int n_dofs,
           int slots, cudaStream_t stream) {
  const int n_slices = (n_dofs + ROWS - 1) / ROWS;
  const long long lane_stride = (long long)n_slices * slots * ROWS;
  band_matvec_kernel<T><<<(n_dofs + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const T*)vals, (const int*)cols, (const T*)u, (T*)y, C, n_dofs, slots, lane_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `dbl` selects the type: 0 float, 1 double. Returns cudaGetLastError()
// after the launch (0 when it was accepted).
int fea_band_matvec(int dbl, const void* vals, const void* cols, const void* u, void* y, int C,
                    int n_dofs, int slots, void* stream) {
  auto fn = dbl ? launch<double> : launch<float>;
  return fn(vals, cols, u, y, C, n_dofs, slots, (cudaStream_t)stream);
}

// Loads both instances into the current context, so that neither loads
// lazily at its first launch, which may come while a CUDA graph is captured.
int fea_band_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)band_matvec_kernel<float>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, (const void*)band_matvec_kernel<double>);
  return (int)err;
}

const char* fea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
