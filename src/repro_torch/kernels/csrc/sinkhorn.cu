// Sinkhorn projection for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel `sinkhorn_pallas` of
// src/repro/kernels/sinkhorn/sinkhorn.py (`_kernel`, and `_sinkhorn_paneled`
// with `_row_norm_kernel` / `_col_scale_kernel`): clamp the (n, n) matrix at
// `eps`, then `iters` rounds of row normalization followed by column
// normalization.  The f32 instance is held against the Pallas kernel's
// semantics; the f64 instance serves `saturate` (200 iterations, eps = 0),
// the projection Vermilion's `normalize="saturate"` schedule runs first.
//
// Design.  The TPU kernel keeps the whole matrix in VMEM.  A Hopper block has
// at most 227 KB of shared memory, and the main path's matrix (256 x 256 f64)
// is 512 KB, so every iteration is two launches over device memory (which the
// 50 MB L2 holds at these sizes):
//   * row_norm: one block per row; each thread sums a fixed strided subset,
//     a fixed-shape shared-memory tree combines the partials, and the row is
//     divided in place.  The clamp is fused into the first pass.
//   * col_norm: a block owns 32 neighbouring columns (one warp reads 32
//     neighbouring addresses of a row) and 8 row groups; each thread sums its
//     rows in row order, the 8 partials are combined in a fixed order, and
//     the columns are divided in place.
// Both reductions have a fixed order, so the result does not change from run
// to run: the saturated matrix feeds an integer rounding, and a schedule built
// on the card must be the same every time.  Any n is accepted (the Pallas
// kernel's multiple-of-256 rule comes from the TPU's tiling).
//
// Bound.  For (n, iters, T): bytes = 2 n^2 sizeof(T) (input read once, output
// written once); operations ~ 4 iters n^2 (a sum and a divide per entry for
// rows and for columns).  At 67 TFLOP/s f32 / 34 TFLOP/s f64 and 3.35 TB/s,
// the main path's instance (n = 256, iters = 200, f64: ~52 MFLOP, 1 MiB) is
// bound by operations at ~1.5 us.  This first version is far from that: it
// issues 2 * iters = 400 launches, each a few microseconds of launch and
// synchronisation cost, and the column pass of n = 256 fills only 8 blocks.
// A persistent kernel with a grid-wide column reduction (or a cluster with
// distributed shared memory holding the matrix) is the later version.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns the first cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_W = 32;  // columns per block (one warp wide)
constexpr int COL_G = 8;   // row groups per block

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T eps) {
  // NaN passes through, as jnp.maximum / torch.clamp_min propagate it
  return x < eps ? eps : x;
}

// in may alias out (every iteration after the first normalizes in place):
// each thread writes exactly the entries it read, after the block's sum.
template <typename T>
__global__ void row_norm(const T* in, T* out, int n, T eps, int clamp) {
  __shared__ T part[ROW_THREADS];
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const T* src = in + base;
  T* dst = out + base;
  T s = T(0);
  for (int j = threadIdx.x; j < n; j += ROW_THREADS) {
    T x = src[j];
    if (clamp) x = clamp_min(x, eps);
    s += x;
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = ROW_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  const T total = part[0];
  for (int j = threadIdx.x; j < n; j += ROW_THREADS) {
    T x = src[j];
    if (clamp) x = clamp_min(x, eps);
    dst[j] = x / total;
  }
}

template <typename T>
__global__ void col_norm(T* x, int n) {
  __shared__ T part[COL_G][COL_W];
  __shared__ T total[COL_W];
  const int c = blockIdx.x * COL_W + threadIdx.x;
  const int g = threadIdx.y;
  T s = T(0);
  if (c < n) {
    for (int i = g; i < n; i += COL_G) s += x[static_cast<size_t>(i) * n + c];
  }
  part[g][threadIdx.x] = s;
  __syncthreads();
  if (g == 0) {
    T t = part[0][threadIdx.x];
    for (int k = 1; k < COL_G; ++k) t += part[k][threadIdx.x];
    total[threadIdx.x] = t;
  }
  __syncthreads();
  if (c < n) {
    const T t = total[threadIdx.x];
    for (int i = g; i < n; i += COL_G) {
      const size_t k = static_cast<size_t>(i) * n + c;
      x[k] = x[k] / t;
    }
  }
}

template <typename T>
__global__ void clamp_copy(const T* in, T* out, size_t total, T eps) {
  const size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k < total) out[k] = clamp_min(in[k], eps);
}

template <typename T>
int sinkhorn_launch(const T* in, T* out, int n, int iters, T eps,
                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 row_grid(n), row_block(ROW_THREADS);
  const dim3 col_grid((n + COL_W - 1) / COL_W), col_block(COL_W, COL_G);
  if (iters <= 0) {  // no normalization: the clamped copy alone
    const size_t total = static_cast<size_t>(n) * n;
    clamp_copy<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                    stream>>>(in, out, total, eps);
    return static_cast<int>(cudaGetLastError());
  }
  for (int it = 0; it < iters; ++it) {
    row_norm<T><<<row_grid, row_block, 0, stream>>>(
        it == 0 ? in : out, out, n, eps, it == 0 ? 1 : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    col_norm<T><<<col_grid, col_block, 0, stream>>>(out, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

int sinkhorn_f32(const void* in, void* out, int n, int iters, float eps,
                 void* stream) {
  return sinkhorn_launch<float>(static_cast<const float*>(in),
                                static_cast<float*>(out), n, iters, eps,
                                static_cast<cudaStream_t>(stream));
}

int sinkhorn_f64(const void* in, void* out, int n, int iters, double eps,
                 void* stream) {
  return sinkhorn_launch<double>(static_cast<const double*>(in),
                                 static_cast<double*>(out), n, iters, eps,
                                 static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
