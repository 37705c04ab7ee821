// Selective scan (Mamba S6) backward pass for Hopper (sm_90a), float32:
// the gradients of the forward kernel's y (mamba_scan.cu) in dt, a, B, C
// and u, from a zero state in, the final state unused (the training path's
// case).
//
// Replaces no Pallas kernel: the reference model trains through its jnp
// `_chunked_selective_scan` and the `bsdn,bsn->bsd` contraction
// (src/repro/models/mamba.py), which JAX differentiates.  It computes what
// `selective_scan_bwd_ref` (kernels/mamba_scan/ref.py) writes out: with
// a_bar_t = exp(dt_t a), b_bar_t = (dt_t B_t) u_t and h_t = a_bar_t h_{t-1} +
// b_bar_t,
//   dh_t  = a_bar_{t+1} dh_{t+1} + C_t (x) dy_t
//   dC_t  = sum_d h_t dy_t            du_t = sum_n dh_t (dt_t B_t)
//   dB_t  = dt_t sum_d dh_t u_t
//   ddt_t = sum_{d,n} dh_t (a a_bar_t h_{t-1} + B_t u_t)
//   da    = sum_{b,t} dh_t dt_t a_bar_t h_{t-1}
// for dt (B, S), a (D, N), B, C (B, S, N) f32, u (B, S, D) f32 or bf16 and
// dy (B, S, D) f32; du comes out in u's type.
//
// Bound.  Per (position, channel, state) one exponential (a_bar again) and
// ~16 f32 operations (h again, the reverse step, the five gradient terms);
// per position u and dy are read and du written.  At Jamba's training shape
// (B 2 x 2048, D 16384, N 16) that is ~1.07e9 exponentials: ~0.25 ms on the
// special-function units (16 a clock on an SM, 132 SMs at ~1.98 GHz), above
// the ~0.26 GB of u, dy and du (~0.08 ms at 3.35 TB/s in f32) and the
// ~1.7e10 operations (~0.26 ms at 67 TFLOP/s).
//
// Design: the forward's layout.  A block of 8 warps takes 64 channels of one
// batch row; a group of 4 lanes takes a channel, a lane 16 consecutive
// positions of each 64-position tile.  First a forward sweep over the tiles
// (each lane composes its positions' (a_bar, b_bar) into one pair, the group
// scans its 4 pairs with two shuffles, the carried h enters) writes the state
// entering each tile, (B, S/64, D, N) f32.  Then the tiles in reverse: for
// each state n a lane re-forms its positions' h from the tile's entering
// state as the forward does, composes its positions' reverse steps
// E_t = a_bar_t (E_{t+1} + C_t dy_t) (E_t = a_bar_t dh_t, what position t
// hands back) into one pair, the group scans them from the last lane with
// two shuffles, the carry from the tile after enters at the last lane, and
// the lane re-walks its positions backwards: dh_t, then du, ddt and da in
// registers and the terms of dB and dC.  dB, dC and ddt sum over channels:
// over a warp's 8 channels by shuffles, over the block's 8 warps in shared
// memory in warp order, and over the blocks by a second launch that sums the
// (B, D/64, S, N) partials in block order; da sums over a lane's positions,
// the group's lanes and the tiles in registers, and over batch rows in the
// second launch.  No atomics: two calls give the same bits.  One block an SM
// (~120 KB of shared memory: a tile's dt, dt B, B and C rows, u and dy, the
// reduction rows).
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mamba_scan.cuh"

namespace {

using namespace scan;

constexpr int SUM_THREADS = 256;

// shared memory, in floats: dt [TS], dt B, B, C [N][BS], u and dy [CH][UP],
// a log2 e and a [N][CH], the warps' rows of dB and dC terms [2][WARPS][N][TS]
// and of ddt [WARPS][TS]
template <int N>
constexpr size_t smem_floats() {
  return TS + 3 * N * BS + 2 * CH * UP + 2 * N * CH + 2 * WARPS * N * TS +
         WARPS * TS;
}

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the sum over a warp's 8 groups (lanes j, j + 4, ..., j + 28)
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 4);
  x += __shfl_xor_sync(FULL, x, 8);
  x += __shfl_xor_sync(FULL, x, 16);
  return x;
}

template <int N, typename U>
__global__ void __launch_bounds__(THREADS, 1)
mamba_scan_bwd(const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const U* __restrict__ u, const float* __restrict__ dy,
               U* __restrict__ du, float* __restrict__ hs,
               float* __restrict__ part_b, float* __restrict__ part_c,
               float* __restrict__ part_t, float* __restrict__ part_a, int s,
               int dim) {
  extern __shared__ __align__(16) float smem[];
  float* dts = smem;                   // [TS]
  float* dtbs = dts + TS;              // [N][BS]: dt B, swizzled
  float* bss = dtbs + N * BS;          // [N][BS]: B
  float* css = bss + N * BS;           // [N][BS]: C
  float* us = css + N * BS;            // [CH][UP]: u, then du
  float* dys = us + CH * UP;           // [CH][UP]: dy
  float* a2s = dys + CH * UP;          // [N][CH]: a log2 e
  float* as = a2s + N * CH;            // [N][CH]: a
  float* red_b = as + N * CH;          // [WARPS][N][TS]: terms of dB / dt
  float* red_c = red_b + WARPS * N * TS;  // [WARPS][N][TS]: terms of dC
  float* red_t = red_c + WARPS * N * TS;  // [WARPS][TS]: terms of ddt
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / L, j = lane % L;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH;
  const int c = warp * G + g, d = d0 + c;
  const bool live = d < dim;
  const long long row = static_cast<long long>(b) * s;
  const int ntiles = (s + TS - 1) / TS;

  for (int e = tid; e < N * CH; e += THREADS) {
    const int dd = d0 + e % CH;
    const float av = dd < dim ? a[static_cast<long long>(dd) * N + e / CH] : 0.f;
    a2s[e] = av * LOG2E;
    as[e] = av;
  }
  // one tile into shared memory; zeros past S and past D
  auto load = [&](int t0, bool bwd) {
    for (int t = tid; t < TS; t += THREADS)
      dts[t] = t0 + t < s ? dt[row + t0 + t] : 0.f;
    for (int e = tid; e < TS * N; e += THREADS) {
      const int t = e / N, n = e % N;
      const bool ok = t0 + t < s;
      const long long p = (row + t0 + (ok ? t : 0)) * N + n;
      const float bv = ok ? bm[p] : 0.f;
      const float dtv = ok ? dt[row + t0 + t] : 0.f;
      dtbs[n * BS + swz(t)] = dtv * bv;
      if (bwd) {
        bss[n * BS + swz(t)] = bv;
        css[n * BS + swz(t)] = ok ? cm[p] : 0.f;
      }
    }
    for (int e = tid; e < TS * CH; e += THREADS) {
      const int t = e / CH, cc = e % CH, dd = d0 + cc;
      const bool ok = t0 + t < s && dd < dim;
      const long long p = (row + t0 + t) * dim + dd;
      us[cc * UP + pad(t)] = ok ? to_f32(u[p]) : 0.f;
      if (bwd) dys[cc * UP + pad(t)] = ok ? dy[p] : 0.f;
    }
  };
  auto lane_regs = [&](float (&dk)[K], float (&uk)[K]) {
#pragma unroll
    for (int x = 0; x < K; ++x) {
      dk[x] = dts[K * j + x];
      uk[x] = us[c * UP + pad(K * j + x)];
    }
  };

  // 1. forward: the state entering each tile
  float hc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) hc[n] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TS;
    __syncthreads();   // the tile before is used
    load(t0, false);
    __syncthreads();
    if (live) {
      float* hrow = hs + ((static_cast<long long>(b) * ntiles + it) * dim + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (n % L == j) hrow[n] = hc[n];
    }
    float dk[K], uk[K];
    lane_regs(dk, uk);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float a2 = a2s[n * CH + c];
      float bv[K];
      load_row(bv, dtbs + n * BS, j);
      float pa = 1.f, pb = 0.f;
#pragma unroll
      for (int x = 0; x < K; ++x) {
        const float ak = ex2(dk[x] * a2);
        pb = fmaf(ak, pb, bv[x] * uk[x]);
        pa *= ak;
      }
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float oa = __shfl_up_sync(FULL, pa, off, L);
        const float ob = __shfl_up_sync(FULL, pb, off, L);
        if (j >= off) {
          pb = fmaf(pa, ob, pb);
          pa *= oa;
        }
      }
      hc[n] = __shfl_sync(FULL, fmaf(pa, hc[n], pb), L - 1, L);
    }
  }
  __syncthreads();   // every tile's entering state is written

  // 2. the tiles in reverse
  float ec[N], da_acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) ec[n] = da_acc[n] = 0.f;
  for (int it = ntiles - 1; it >= 0; --it) {
    const int t0 = it * TS;
    load(t0, true);
    __syncthreads();
    float dk[K], uk[K], dyk[K], duk[K], dtk[K];
    lane_regs(dk, uk);
#pragma unroll
    for (int x = 0; x < K; ++x) {
      dyk[x] = dys[c * UP + pad(K * j + x)];
      duk[x] = dtk[x] = 0.f;
    }
    const float* hrow =
        hs + ((static_cast<long long>(b) * ntiles + it) * dim + (live ? d : 0)) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float a2 = a2s[n * CH + c];
      const float av = as[n * CH + c];
      float ak[K], hp[K];
      float hh;
      {
        // h before each of the lane's positions, as the forward forms it
        float bv[K];
        load_row(bv, dtbs + n * BS, j);
        float pa = 1.f, pb = 0.f;
#pragma unroll
        for (int x = 0; x < K; ++x) {
          ak[x] = ex2(dk[x] * a2);
          pb = fmaf(ak[x], pb, bv[x] * uk[x]);
          pa *= ak[x];
        }
#pragma unroll
        for (int off = 1; off < L; off <<= 1) {
          const float oa = __shfl_up_sync(FULL, pa, off, L);
          const float ob = __shfl_up_sync(FULL, pb, off, L);
          if (j >= off) {
            pb = fmaf(pa, ob, pb);
            pa *= oa;
          }
        }
        const float h0 = live ? hrow[n] : 0.f;
        hh = __shfl_up_sync(FULL, fmaf(pa, h0, pb), 1, L);
        if (j == 0) hh = h0;
#pragma unroll
        for (int x = 0; x < K; ++x) {
          hp[x] = hh;
          hh = fmaf(ak[x], hh, bv[x] * uk[x]);
        }
      }
      // the lane's reverse steps as one pair: E_first = qa E_after + qb
      float cv[K];
      load_row(cv, css + n * BS, j);
      float qa = 1.f, qb = 0.f;
#pragma unroll
      for (int x = K - 1; x >= 0; --x) {
        qb = ak[x] * (qb + cv[x] * dyk[x]);
        qa *= ak[x];
      }
      // inclusive scan from the group's last lane, the later pair first
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float oa = __shfl_down_sync(FULL, qa, off, L);
        const float ob = __shfl_down_sync(FULL, qb, off, L);
        if (j + off < L) {
          qb = fmaf(qa, ob, qb);
          qa *= oa;
        }
      }
      float e = __shfl_down_sync(FULL, fmaf(qa, ec[n], qb), 1, L);
      if (j == L - 1) e = ec[n];
      ec[n] = __shfl_sync(FULL, fmaf(qa, ec[n], qb), 0, L);   // to the tile before
      float bv[K], dtb[K];
      load_row(bv, bss + n * BS, j);
      load_row(dtb, dtbs + n * BS, j);
      float* rb = red_b + (warp * N + n) * TS + K * j;
      float* rc = red_c + (warp * N + n) * TS + K * j;
#pragma unroll
      for (int x = K - 1; x >= 0; --x) {
        const float dh = e + cv[x] * dyk[x];
        e = ak[x] * dh;
        const float ht = x + 1 < K ? hp[x + 1] : hh;       // h_t
        const float dab = dh * hp[x] * ak[x];              // d(dt a)
        duk[x] = fmaf(dh, dtb[x], duk[x]);
        dtk[x] += dab * av + dh * bv[x] * uk[x];
        da_acc[n] = fmaf(dab, dk[x], da_acc[n]);
        const float tb = group_sum(dh * uk[x]);
        const float tc = group_sum(ht * dyk[x]);
        if (g == 0) {
          rb[x] = tb;
          rc[x] = tc;
        }
      }
    }
#pragma unroll
    for (int x = 0; x < K; ++x) {
      const float tt = group_sum(dtk[x]);
      if (g == 0) red_t[warp * TS + K * j + x] = tt;
      us[c * UP + pad(K * j + x)] = duk[x];   // du over the group's u row
    }
    __syncthreads();
    // du back as coalesced rows; the block's dB, dC and ddt partials
    for (int e2 = tid; e2 < TS * CH; e2 += THREADS) {
      const int t = e2 / CH, cc = e2 % CH, dd = d0 + cc;
      if (t0 + t < s && dd < dim)
        from_f32(du + (row + t0 + t) * dim + dd, us[cc * UP + pad(t)]);
    }
    for (int e2 = tid; e2 < TS * N; e2 += THREADS) {
      const int t = e2 / N, n = e2 % N;
      if (t0 + t >= s) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sb += red_b[(w * N + n) * TS + t];
        sc += red_c[(w * N + n) * TS + t];
      }
      const long long p = ((static_cast<long long>(b) * nblk + blk) * s + t0 + t) * N + n;
      part_b[p] = sb;
      part_c[p] = sc;
    }
    for (int t = tid; t < TS; t += THREADS) {
      if (t0 + t >= s) continue;
      float st = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) st += red_t[w * TS + t];
      part_t[(static_cast<long long>(b) * nblk + blk) * s + t0 + t] = st;
    }
    __syncthreads();   // the tile's shared memory is free
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float x = da_acc[n];
    x += __shfl_xor_sync(FULL, x, 1);
    x += __shfl_xor_sync(FULL, x, 2);
    if (live && j == 0)
      part_a[(static_cast<long long>(b) * dim + d) * N + n] = x;
  }
}

// the second launch: the partials summed in block (or batch row) order
__global__ void __launch_bounds__(SUM_THREADS)
mamba_scan_bwd_sums(const float* __restrict__ dt,
                    const float* __restrict__ part_b,
                    const float* __restrict__ part_c,
                    const float* __restrict__ part_t,
                    const float* __restrict__ part_a, float* __restrict__ dbm,
                    float* __restrict__ dcm, float* __restrict__ ddt,
                    float* __restrict__ da, int batch, int s, int dim, int n,
                    int nblk) {
  const long long i = static_cast<long long>(blockIdx.x) * SUM_THREADS +
                      threadIdx.x;
  const long long bsn = static_cast<long long>(batch) * s * n;
  const long long bs = static_cast<long long>(batch) * s;
  const long long dn = static_cast<long long>(dim) * n;
  if (i < bsn) {
    const long long b = i / (static_cast<long long>(s) * n);
    const long long tn = i % (static_cast<long long>(s) * n);
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      const long long p = (b * nblk + k) * s * n + tn;
      sb += part_b[p];
      sc += part_c[p];
    }
    dbm[i] = sb * dt[i / n];
    dcm[i] = sc;
  } else if (i < bsn + bs) {
    const long long bt = i - bsn;
    const long long b = bt / s, t = bt % s;
    float st = 0.f;
    for (int k = 0; k < nblk; ++k) st += part_t[(b * nblk + k) * s + t];
    ddt[bt] = st;
  } else if (i < bsn + bs + dn) {
    const long long e = i - bsn - bs;
    float sa = 0.f;
    for (int b = 0; b < batch; ++b) sa += part_a[b * dn + e];
    da[e] = sa;
  }
}

template <int N, typename U>
int launch(const float* dt, const float* a, const float* bm, const float* cm,
           const void* u, const float* dy, void* du, float* ddt, float* da,
           float* dbm, float* dcm, float* work, int batch, int s, int dim,
           cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd<N, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (dim + CH - 1) / CH, ntiles = (s + TS - 1) / TS;
  float* hs = work;
  float* part_b = hs + static_cast<long long>(batch) * ntiles * dim * N;
  float* part_c = part_b + static_cast<long long>(batch) * nblk * s * N;
  float* part_t = part_c + static_cast<long long>(batch) * nblk * s * N;
  float* part_a = part_t + static_cast<long long>(batch) * nblk * s;
  mamba_scan_bwd<N, U><<<dim3(nblk, batch), THREADS, smem, stream>>>(
      dt, a, bm, cm, static_cast<const U*>(u), dy, static_cast<U*>(du), hs,
      part_b, part_c, part_t, part_a, s, dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * s * N +
                          static_cast<long long>(batch) * s +
                          static_cast<long long>(dim) * N;
  mamba_scan_bwd_sums<<<static_cast<unsigned>((total + SUM_THREADS - 1) /
                                              SUM_THREADS),
                        SUM_THREADS, 0, stream>>>(dt, part_b, part_c, part_t,
                                                  part_a, dbm, dcm, ddt, da,
                                                  batch, s, dim, N, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The workspace, in floats, that mamba_scan_bwd_f32 takes: the state
// entering each tile (B, S/64, D, N) and the partial sums.
long long mamba_scan_bwd_workspace_floats(int batch, int s, int dim, int n) {
  const long long nblk = (dim + CH - 1) / CH, ntiles = (s + TS - 1) / TS;
  return static_cast<long long>(batch) *
         (ntiles * dim * n + 2 * nblk * s * n + nblk * s + dim * n);
}

// dt (B, S), a (D, N), bm, cm, dbm, dcm (B, S, N), dy (B, S, D), ddt
// (B, S), da (D, N): contiguous float32; u and du (B, S, D) contiguous
// float32, or bfloat16 when u_bf16 is nonzero.  N is 8 or 16, S >= 1.
// `work`: mamba_scan_bwd_workspace_floats(...) floats, not used by another
// call in flight.  The outputs do not alias the inputs.
int mamba_scan_bwd_f32(const void* dt, const void* a, const void* bm,
                       const void* cm, const void* u, const void* dy,
                       void* du, void* ddt, void* da, void* dbm, void* dcm,
                       void* work, int batch, int s, int dim, int n,
                       int u_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (batch < 0 || s < 1 || dim < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || dim == 0) return static_cast<int>(cudaSuccess);
#define SCAN_BWD_ARGS                                                      \
  static_cast<const float*>(dt), static_cast<const float*>(a),             \
      static_cast<const float*>(bm), static_cast<const float*>(cm), u,     \
      static_cast<const float*>(dy), du, static_cast<float*>(ddt),         \
      static_cast<float*>(da), static_cast<float*>(dbm),                   \
      static_cast<float*>(dcm), static_cast<float*>(work), batch, s, dim, st
  switch (n * 2 + (u_bf16 != 0)) {
    case 16: return launch<8, float>(SCAN_BWD_ARGS);
    case 17: return launch<8, __nv_bfloat16>(SCAN_BWD_ARGS);
    case 32: return launch<16, float>(SCAN_BWD_ARGS);
    case 33: return launch<16, __nv_bfloat16>(SCAN_BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_BWD_ARGS
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
