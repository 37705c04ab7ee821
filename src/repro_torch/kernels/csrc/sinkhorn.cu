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
// Design: one launch a call.  The TPU kernel keeps the whole matrix in VMEM.
// Here one thread-block cluster of C blocks keeps it in its blocks'
// registers for all `iters` rounds: the input is read from device memory
// once and the output written once.  C is 16 (a non-portable size) where the
// card can schedule such a cluster for every instance below, else the
// portable 8; it is chosen once per device at first use, from
// cudaOccupancyMaxActiveClusters, never after a failed launch.
//   * Rows form groups of 16 (row r is in group r / 16).  Block `rank` holds
//     groups [rank * GPB, rank * GPB + GPB), GPB = ceil(ceil(n / 16) / C); a
//     block may hold none (n = 17: blocks 2..15) and still runs to the last
//     cluster barrier.
//   * A block has NT = n rounded up to 32 threads; thread c holds column c of
//     the block's 16 * GPB rows in registers (zeros past n).  Block `rank`
//     also totals columns [rank * cpb, rank * cpb + cpb), cpb = NT / C
//     rounded up (16 at n = 256).
//   * Round i (mbarrier parity i & 1):
//     (a) row sums inside the block (a warp's butterfly, then the warps in a
//         fixed order through shared memory), and each row divided by its sum;
//     (b) each thread sums its column over each held group's 16 rows and
//         stores the partial into the shared memory of the block that totals
//         the column (`st.async`, counted in bytes on that block's mbarrier);
//     (c) a block waits for every group's partial of its columns, adds them
//         in group order and stores each total into every block that holds
//         rows (`st.async` again, one a thread);
//     (d) each block waits for all n totals and divides its columns.
//   * That is a reduce-scatter and an all-gather of the column sums, 2 KiB a
//     block each at n = 256, f64, with no cluster barrier in the rounds.  On
//     an H100 SXM (700 W; benchmarks/torch_sinkhorn_ab.py) a call of the
//     main path's instance takes 0.47 ms; reading every group's partial
//     from every block after one cluster barrier a round (32 KiB a block)
//     takes 0.86 ms, and this exchange with a cluster barrier before (c)
//     and (d) 0.70 ms.  Staging the values and moving them by bulk copies
//     (cp.async.bulk, one a destination) was slower than one st.async a
//     value.
//   * Single buffers suffice, each round's data being a cause of the next
//     round's writes: a block stores round i + 1's partials only after it
//     has round i's totals, which their owner sent after it had read round
//     i's partials; an owner stores round i + 1's totals only after every
//     holder's round i + 1 partials arrived, which each holder sent after
//     it had read round i's totals.  For the same reason no transaction of
//     round i + 1 reaches an mbarrier before its phase i completes.  Thread
//     0 arrives (with the expected bytes) on each mbarrier once a round,
//     after its own wait on the previous phase.  A cluster barrier after the
//     mbarriers' initialisation, and one at the end, frame the rounds.
//
// Order of summation (fixed, and independent of C: which block holds or
// totals a group changes, the order does not, so C = 8 and C = 16 give the
// same bits).  repro_torch.kernels.sinkhorn.ref.sinkhorn_kernel_order is a
// plain model of it, held to this kernel bit for bit on the card:
//   * row sum: in each warp of NT / 32, the 32 lanes' values fold in halves
//     (lane l + lane l + 16, then + 8, + 4, + 2, + 1); the warps' sums then
//     add in warp order;
//   * column total: each group's partial sums its 16 rows in row order (rows
//     past n add as zeros); the total adds the partials in group order;
//   * every quotient is the correctly rounded `x / s`: two Markstein
//     correction steps from y = RN(1 / s) (`quotient`) where `exact_range`
//     proves them exact, IEEE division elsewhere (no fast math).
// The fixed order makes the result the same from run to run: the saturated
// matrix feeds an integer rounding, and a schedule built on the card must be
// the same every time.  The clamp is `x < eps ? eps : x`, so NaN passes as
// it passes torch.clamp_min; iters = 0 returns the clamped copy.
//
// Capacity.  The slab lives in registers: GPB * 16 values a thread, at most
// NT_MAX(T, GPB) = min(256 * GPB, 32 * floor(65536 / (16 * GPB * w + 40) /
// 32)) threads (w = 32-bit words a value, 40 registers beside the slab;
// __launch_bounds__ holds the compiler to that), GPB <= 3.  Shared memory
// holds the partials of the owned columns, the totals, the row sums'
// scratch and two mbarriers: at most ~22 KB, under the 48 KB a block has
// without an opt-in.  So the cluster path takes n with GPB <= 3 and
// round_up(n, 32) <= NT_MAX:
//   C = 16: f64 n <= 512 (GPB 2, 512 threads), f32 n <= 736 (GPB 3, 736);
//   C = 8:  f64 n <= 384, f32 n <= 384 (GPB 3).
// Larger matrices (f32 n = 1024 holds 4 MiB, more than 16 register files)
// take the two-pass path: a row kernel and a column kernel each round
// (`sinkhorn_rows` / `sinkhorn_cols`, reductions in their own fixed order),
// 2 * iters launches.  The choice depends on n, the type and the card's C
// alone (`sinkhorn_plan`).
//
// Bound.  For (n, iters, T): bytes = 2 n^2 sizeof(T) (input read once,
// output written once); operations ~ 4 iters n^2 (a sum and a divide per
// entry for rows and for columns).  At 67 TFLOP/s f32 / 34 TFLOP/s f64 and
// 3.35 TB/s, the main path's instance (n = 256, iters = 200, f64: ~52 MFLOP,
// 1 MiB) is bound by operations at ~1.5 us, on all 132 SMs.  The cluster
// uses C of them, and each round waits on a chain: a block's row reduction
// (two __syncthreads), 16 quotients a thread, two one-way trips through
// the cluster, 16 more.  On the H100 above: 0.47 ms a call, ~4,700 cycles
// a round; 0.34 ms without the two trips (timing only), 0.40 without the
// quotients' arithmetic, 0.88 with IEEE division for every quotient.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns the first error of the launch
// (cudaLaunchKernelEx, then cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 16;         // rows of one column partial
constexpr int MAX_GPB = 3;        // groups a block holds, at most
constexpr int LARGE_CLUSTER = 16;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_DEVICES = 64;

constexpr int imin(int a, int b) { return a < b ? a : b; }

template <typename T, int GPB>
struct Slab {
  static constexpr int ROWS = GROUP * GPB;
  static constexpr int WORDS = ROWS * static_cast<int>(sizeof(T) / 4);
  // most threads (columns) a block of this instance takes
  static constexpr int MAX_THREADS =
      imin(256 * GPB, 65536 / (WORDS + 40) / 32 * 32);
};

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T eps) {
  // NaN passes through, as jnp.maximum / torch.clamp_min propagate it
  return x < eps ? eps : x;
}

// One butterfly level over half H: each lane keeps H of its 2H row values
// (the lower half if its lane bit 2H is 0) and adds its partner's copy of
// them.  src may equal dst.
template <int H, typename T>
__device__ __forceinline__ void fold(const T* src, T* dst, int lane) {
  const bool hi = (lane & (2 * H)) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T send = hi ? src[j] : src[j + H];
    const T keep = hi ? src[j + H] : src[j];
    dst[j] = keep + __shfl_xor_sync(FULL, send, 2 * H);
  }
}

// The warp's sums of 16 rows (v[0..15], one column a lane): lane l returns
// the sum of row l >> 1 over the warp's 32 columns, folded lane l + lane
// l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1.
template <typename T>
__device__ __forceinline__ T warp_row_sums(const T* v, int lane) {
  T a[8];
  fold<8>(v, a, lane);
  fold<4>(a, a, lane);
  fold<2>(a, a, lane);
  fold<1>(a, a, lane);
  return a[0] + __shfl_xor_sync(FULL, a[0], 1);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// x / s, correctly rounded, from y = RN(1 / s) without a division: q =
// RN(x y) lies within 1.5 ulp of x / s; one correction (r = x - s q exactly
// by an FMA, q + r y) makes it faithful; by Markstein's theorem (y within
// half an ulp of 1 / s, q within an ulp of x / s, no overflow or underflow)
// the second gives RN(x / s), the bits of `x / s`.  IEEE `x / s` on sm_90
// is ~10 instructions with a branch to a slow path, which keeps a thread's
// divisions from overlapping; this is 5 without a branch.
template <typename T>
__device__ __forceinline__ T quotient(T x, T s, T y) {
  T q = mul_rn(x, y);
  T r = fma_rn(-q, s, x);
  q = fma_rn(r, y, q);
  r = fma_rn(-q, s, x);
  return fma_rn(r, y, q);
}

// Whether x is positive with a binary exponent in [-500, 500] (double) or
// [-60, 60] (float): for such x and s every step of `quotient` stays in the
// normal range, and r is exact.  Zero, negatives, NaN, infinities and
// extreme exponents take IEEE `x / s` (two integer instructions a value).
__device__ __forceinline__ bool exact_range(double x) {
  return static_cast<unsigned>(__double2hiint(x) - (523 << 20)) <=
         static_cast<unsigned>((1000 << 20) | 0xfffff);
}
__device__ __forceinline__ bool exact_range(float x) {
  return static_cast<unsigned>(__float_as_int(x) - (67 << 23)) <=
         static_cast<unsigned>((120 << 23) | 0x7fffff);
}

// p[0] + p[step] + ... + p[(count - 1) step], added in that order, the
// loads issued eight at a time ahead of the adds (count >= 1)
template <typename T>
__device__ __forceinline__ T sum_in_order(const T* p, int count, int step) {
  T s = p[0];
  for (int i = 1; i < count; i += 8) {
    T x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = i + j < count ? p[(i + j) * step] : T(0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + j < count) s += x[j];
  }
  return s;
}

__device__ __forceinline__ float rcp_rn(float s) { return __frcp_rn(s); }
__device__ __forceinline__ double rcp_rn(double s) { return __drcp_rn(s); }

// v[r] /= s[r * step] for the first `rows` of a thread's ROWS values (step
// 0: one divisor for all): through `quotient`, without a branch, when every
// value and `fast` (the divisors' range) allow it, else by IEEE division.
template <int ROWS, typename T>
__device__ __forceinline__ void divide(T* v, int rows, const T* s, const T* y,
                                       int step, bool fast) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) fast &= (r >= rows) | exact_range(v[r]);
  if (fast) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const T q = quotient(v[r], s[r * step], y[r * step]);
      v[r] = r < rows ? q : v[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) v[r] = v[r] / s[r * step];
  }
}

template <typename T, int GPB>
__global__ void __launch_bounds__(Slab<T, GPB>::MAX_THREADS, 1)
sinkhorn_cluster(const T* __restrict__ in, T* __restrict__ out, int n,
                 int iters, T eps) {
  constexpr int ROWS = Slab<T, GPB>::ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = blockDim.x;
  const int warps = nt / 32;
  const int c = threadIdx.x;                // this thread's column
  const int lane = c & 31, warp = c >> 5;
  const int groups = (n + GROUP - 1) / GROUP;
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int holders = (groups + GPB - 1) / GPB;  // blocks 0.. hold rows
  const int g0 = rank * GPB;
  const int row0 = g0 * GROUP;
  const bool holds = rank < holders;        // the same for the whole block
  const bool col_ok = c < n;
  const int cpb = (nt + blocks - 1) / blocks;   // columns a block totals
  const int owned = max(0, min(cpb, n - rank * cpb));
  const uint32_t owner = static_cast<uint32_t>(c / cpb);
  const int slot = c - static_cast<int>(owner) * cpb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* bar_gather = bars;              // partials of the owned columns
  uint64_t* bar_totals = bars + 1;          // every column's total
  T* gather = reinterpret_cast<T*>(bars + 2);    // [blocks * GPB][cpb]
  T* totals = gather + blocks * GPB * cpb;       // [nt]
  T* mine = totals + nt;                         // [cpb]: owned totals
  T* red = mine + cpb;                           // [ROWS][warps]
  T* rowtot = red + ROWS * warps;                // [ROWS]
  T* rowrcp = rowtot + ROWS;                     // [ROWS]: 1 / rowtot
  // this thread's rows inside the matrix
  const int rows = col_ok ? max(0, min(ROWS, n - row0)) : 0;

  T v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    v[r] = T(0);
    if (col_ok && row0 + r < n)
      v[r] = clamp_min(in[static_cast<size_t>(row0 + r) * n + c], eps);
  }
  if (c == 0) {
    hopper::mbar_init(bar_gather, 1);
    hopper::mbar_init(bar_totals, 1);
    hopper::fence_barrier_init();
  }
  // every block's mbarriers are ready before any block stores to them
  if (iters > 0) cluster.sync();
  const uint32_t gather_bar =
      hopper::cluster_addr(bar_gather, owner);  // where column c's go
  const uint32_t gather_at = hopper::cluster_addr(gather + slot, owner);

  for (int it = 0; it < iters; ++it) {
    const uint32_t parity = it & 1;
    if (c == 0) {  // this round's one arrival on each; data counts in bytes
      if (owned > 0)
        hopper::mbar_expect_tx(bar_gather, groups * owned * sizeof(T));
      if (holds) hopper::mbar_expect_tx(bar_totals, n * sizeof(T));
    }
    if (holds) {
      // (a) row sums: a butterfly in each warp, then the warps in order
#pragma unroll
      for (int k = 0; k < GPB; ++k) {
        const T s = warp_row_sums(v + k * GROUP, lane);
        if ((lane & 1) == 0) red[(k * GROUP + (lane >> 1)) * warps + warp] = s;
      }
      __syncthreads();
      bool fast = true;
      for (int r = c; r < ROWS; r += nt) {
        const T s = sum_in_order(red + r * warps, warps, 1);
        rowtot[r] = s;
        rowrcp[r] = rcp_rn(s);
        if (row0 + r < n) fast = fast && exact_range(s);
      }
      fast = __syncthreads_and(fast);
      divide<ROWS>(v, rows, rowtot, rowrcp, 1, fast);
      // (b) this column's partial of each group, rows in order, to the
      // block that totals the column
#pragma unroll
      for (int k = 0; k < GPB; ++k) {
        T s = v[k * GROUP];
#pragma unroll
        for (int i = 1; i < GROUP; ++i) s += v[k * GROUP + i];
        if (col_ok && g0 + k < groups)
          hopper::st_async(gather_at + (g0 + k) * cpb * sizeof(T), s,
                           gather_bar);
      }
    }
    // (c) the owned columns' totals, partials in group order, to every
    // block that holds rows
    if (owned > 0) {
      if (c < owned) {
        hopper::mbar_wait(bar_gather, parity);
        mine[c] = sum_in_order(gather + c, groups, cpb);
      }
      __syncthreads();
      for (int j = c; j < owned * holders; j += nt) {
        const int h = j / owned, k = j - h * owned;
        hopper::st_async(hopper::cluster_addr(totals + rank * cpb + k, h),
                         mine[k], hopper::cluster_addr(bar_totals, h));
      }
    }
    // (d) each column divided by its total
    if (holds) {
      hopper::mbar_wait(bar_totals, parity);
      if (rows > 0) {
        const T tot = totals[c];
        const T y = rcp_rn(tot);
        divide<ROWS>(v, rows, &tot, &y, 0, exact_range(tot));
      }
    }
  }

  if (col_ok) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (row0 + r < n) out[static_cast<size_t>(row0 + r) * n + c] = v[r];
  }
  // no block leaves while a store to it may be in flight
  cluster.sync();
}

// ---- the two-pass path: matrices the cluster cannot hold -----------------

constexpr int ROW_THREADS = 256;
constexpr int COL_W = 32;  // columns per block (one warp wide)
constexpr int COL_G = 8;   // row groups per block

// in may alias out (every iteration after the first normalizes in place):
// each thread writes exactly the entries it read, after the block's sum.
// One block per row; each thread sums a fixed strided subset and a
// fixed-shape shared-memory tree combines the partials.
template <typename T>
__global__ void sinkhorn_rows(const T* in, T* out, int n, T eps, int clamp) {
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

// A block owns 32 neighbouring columns (one warp reads 32 neighbouring
// addresses of a row) and 8 row groups; each thread sums its rows in row
// order, and the 8 partials are combined in a fixed order.
template <typename T>
__global__ void sinkhorn_cols(T* x, int n) {
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
__global__ void sinkhorn_clamp(const T* in, T* out, size_t total, T eps) {
  const size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k < total) out[k] = clamp_min(in[k], eps);
}

template <typename T>
int two_pass(const T* in, T* out, int n, int iters, T eps,
             cudaStream_t stream) {
  if (iters <= 0) {  // no normalization: the clamped copy alone
    const size_t total = static_cast<size_t>(n) * n;
    sinkhorn_clamp<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        stream>>>(in, out, total, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 row_grid(n), row_block(ROW_THREADS);
  const dim3 col_grid((n + COL_W - 1) / COL_W), col_block(COL_W, COL_G);
  for (int it = 0; it < iters; ++it) {
    sinkhorn_rows<T><<<row_grid, row_block, 0, stream>>>(
        it == 0 ? in : out, out, n, eps, it == 0 ? 1 : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sinkhorn_cols<T><<<col_grid, col_block, 0, stream>>>(out, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// ---- the cluster path's plan and launch ----------------------------------

struct Plan {
  int gpb;        // groups a block holds
  int threads;    // NT
  size_t smem;    // dynamic shared memory, bytes
};

template <typename T>
int max_threads(int gpb) {
  return gpb == 1 ? Slab<T, 1>::MAX_THREADS
       : gpb == 2 ? Slab<T, 2>::MAX_THREADS
                  : Slab<T, 3>::MAX_THREADS;
}

template <typename T>
const void* cluster_kernel(int gpb) {
  return gpb == 1 ? reinterpret_cast<const void*>(sinkhorn_cluster<T, 1>)
       : gpb == 2 ? reinterpret_cast<const void*>(sinkhorn_cluster<T, 2>)
                  : reinterpret_cast<const void*>(sinkhorn_cluster<T, 3>);
}

size_t smem_bytes(int gpb, int threads, int cluster, size_t elem) {
  const size_t rows = static_cast<size_t>(GROUP) * gpb;
  const size_t cpb = (threads + cluster - 1) / cluster;
  return 2 * sizeof(uint64_t) + (cluster * gpb * cpb + cpb + threads +
                                 rows * (threads / 32) + 2 * rows) * elem;
}

// Whether the cluster path takes (n, T) with clusters of `cluster` blocks.
template <typename T>
bool plan_cluster(int n, int cluster, Plan* p) {
  const int groups = (n + GROUP - 1) / GROUP;
  const int gpb = (groups + cluster - 1) / cluster;
  const int threads = (n + 31) / 32 * 32;
  if (gpb > MAX_GPB || threads > max_threads<T>(gpb)) return false;
  p->gpb = gpb;
  p->threads = threads;
  p->smem = smem_bytes(gpb, threads, cluster, sizeof(T));
  return true;
}

cudaLaunchConfig_t cluster_config(int cluster, int threads, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allows the non-portable size on each instance of T and asks whether the
// card can schedule a cluster of 16 blocks of it at its largest block.
template <typename T>
cudaError_t schedules_large(bool* ok) {
  for (int gpb = 1; gpb <= MAX_GPB; ++gpb) {
    const void* fn = cluster_kernel<T>(gpb);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int threads = max_threads<T>(gpb);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(
        LARGE_CLUSTER, threads,
        smem_bytes(gpb, threads, LARGE_CLUSTER, sizeof(T)), 0, &attr);
    int count = 0;
    if (cudaOccupancyMaxActiveClusters(&count, fn, &cfg) != cudaSuccess ||
        count < 1) {
      cudaGetLastError();  // a refused query is an answer, not an error
      *ok = false;
    }
  }
  return cudaSuccess;
}

int g_cluster[MAX_DEVICES];  // the current device's C; 0 until chosen

int cluster_size(int* cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_cluster[dev] == 0) {
    bool large = true;
    err = schedules_large<float>(&large);
    if (err == cudaSuccess) err = schedules_large<double>(&large);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_cluster[dev] = large ? LARGE_CLUSTER : PORTABLE_CLUSTER;
  }
  *cluster = g_cluster[dev];
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int launch_cluster(const Plan& p, int cluster, const T* in, T* out, int n,
                   int iters, T eps, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, p.threads, p.smem, stream, &attr);
  cudaError_t err =
      p.gpb == 1 ? cudaLaunchKernelEx(&cfg, sinkhorn_cluster<T, 1>, in, out,
                                      n, iters, eps)
    : p.gpb == 2 ? cudaLaunchKernelEx(&cfg, sinkhorn_cluster<T, 2>, in, out,
                                      n, iters, eps)
                 : cudaLaunchKernelEx(&cfg, sinkhorn_cluster<T, 3>, in, out,
                                      n, iters, eps);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T>
int sinkhorn_launch(const T* in, T* out, int n, int iters, T eps,
                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int cluster = 0;
  const int err = cluster_size(&cluster);
  if (err != 0) return err;
  Plan p;
  if (plan_cluster<T>(n, cluster, &p))
    return launch_cluster<T>(p, cluster, in, out, n, iters, eps, stream);
  return two_pass<T>(in, out, n, iters, eps, stream);
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

// The path a call of (n, elem_bytes: 4 or 8) takes on the current device:
// *variant 1 for the cluster, 0 for two passes; *cluster the device's C;
// *threads the cluster path's block size (0 for two passes).  Returns a
// CUDA error code.
int sinkhorn_plan(int n, int elem_bytes, int* variant, int* cluster,
                  int* threads) {
  const int err = cluster_size(cluster);
  if (err != 0) return err;
  Plan p;
  const bool fits = n > 0 && (elem_bytes == 8
                                  ? plan_cluster<double>(n, *cluster, &p)
                                  : plan_cluster<float>(n, *cluster, &p));
  *variant = fits ? 1 : 0;
  *threads = fits ? p.threads : 0;
  return static_cast<int>(cudaSuccess);
}

// The largest n the cluster path takes with clusters of `cluster` blocks.
int sinkhorn_cluster_max_n(int elem_bytes, int cluster) {
  Plan p;
  int n = 0;
  while (elem_bytes == 8 ? plan_cluster<double>(n + 1, cluster, &p)
                         : plan_cluster<float>(n + 1, cluster, &p))
    ++n;
  return n;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
