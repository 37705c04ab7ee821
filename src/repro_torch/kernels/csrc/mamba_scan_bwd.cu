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
// dy (B, S, D) f32; du comes out in u's type.  ddt's second term is
// sum_n B_t[n] (sum_d dh_t u_t)[n]: the second launch forms it from dB's
// sums.
//
// Bound.  Per (position, channel, state) one exponential (a_bar again) and
// ~16 f32 operations (h again, the reverse step, the gradient terms); per
// position u and dy are read and du written.  At Jamba's training shape
// (B 2 x 2048, D 16384, N 16) that is ~1.07e9 exponentials: ~0.25 ms on the
// special-function units (16 a clock on an SM, 132 SMs at ~1.98 GHz), above
// the ~0.26 GB of u, dy and du (~0.08 ms at 3.35 TB/s in f32) and the
// ~1.7e10 operations (~0.26 ms at 67 TFLOP/s).
//
// Design.  The forward pass under a gradient keeps the state entering each
// 64-position tile, (B, S/64, D, N) f32 (mamba_scan.cu); this pass takes
// it.  A block of 8 warps takes 32 channels of one batch row; a group of 8
// lanes takes a channel, a lane 8 consecutive positions of each tile (the
// forward's tiles, mamba_scan.cuh's TS), so a lane holds 8 positions' dt,
// u, dy and du and the state loop stays within 128 registers: two blocks an
// SM.  The tiles go in
// reverse, the states in two halves: for each state n a lane re-forms its
// positions' h from the tile's entering state as the forward does,
// composes its positions' reverse steps E_t = a_bar_t (E_{t+1} + C_t dy_t)
// (E_t = a_bar_t dh_t, what position t hands back) into one pair, the group
// scans them from the last lane, the carry from the tile after (kept in
// shared memory) enters at the last lane, and the lane re-walks its
// positions backwards: dh_t, then du and da's and ddt's terms in registers
// and dB's and dC's terms.  Those two sum over the warp's 4 channels by a
// reduce-scatter (12 shuffles a state for the lane's 16 terms, each lane
// left with 4 sums: one store of 16 bytes), over the block's 8 warps in
// shared memory in warp order after each half, and over the blocks by a
// second launch that sums the (B, D/32, S, N) partials in block order; da
// sums over a lane's positions and the tiles in shared memory, over the
// group's lanes at the end, and over batch rows in the second launch.  No
// atomics: two calls give the same bits.  ~84 KB of shared memory a block
// (a tile's dt, dt B and C rows, u and dy, half the states' reduction rows,
// the carries).
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mamba_scan.cuh"

namespace {

using scan::BS;
using scan::FULL;
using scan::LOG2E;
using scan::TS;
using scan::UP;
using scan::ex2;
using scan::pad;
using scan::swz;
using scan::to_f32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int L = 8;                   // lanes a channel (a group)
constexpr int G = 32 / L;              // channels a warp
constexpr int CH = WARPS * G;          // channels a block
constexpr int K = TS / L;              // consecutive positions a lane
constexpr int SUM_THREADS = 256;
static_assert(K == 8, "a lane's positions are two float4s of a row");

// shared memory, in floats: dt [TS], dt B and C [N][BS], u and dy [CH][UP],
// a log2 e and a [N][CH], the warps' rows of dB and dC terms for half the
// states [2][WARPS][N / 2][TS] and of ddt's [WARPS][TS], the reverse carry
// [N][CH] and da's lane partials [N][CH][L]
template <int N>
constexpr size_t smem_floats() {
  return TS + 2 * N * BS + 2 * CH * UP + 2 * N * CH + WARPS * N * TS +
         WARPS * TS + N * CH + N * CH * L;
}

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// lane j's K positions of a swizzled row (scan::swz: the lanes of a group
// read distinct bank quads)
__device__ __forceinline__ void load_row(float (&r)[K], const float* row,
                                         int j) {
  const int h = ((K * j) >> 5) & 1;
#pragma unroll
  for (int m = 0; m < K / 4; ++m) {
    const float4 v =
        *reinterpret_cast<const float4*>(row + K * j + 4 * (m ^ h));
    r[4 * m] = v.x;
    r[4 * m + 1] = v.y;
    r[4 * m + 2] = v.z;
    r[4 * m + 3] = v.w;
  }
}

// one step of a reduce-scatter across lanes `off` apart: the lane with the
// bit clear keeps v[0 .. n/2) and sends the rest, the other the reverse
__device__ __forceinline__ float scatter_add(float keep_lo, float keep_hi,
                                             bool hi, int off) {
  const float send = hi ? keep_lo : keep_hi;
  const float keep = hi ? keep_hi : keep_lo;
  return keep + __shfl_xor_sync(FULL, send, off);
}

template <int N, typename U>
__global__ void __launch_bounds__(THREADS, 2)
mamba_scan_bwd(const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const U* __restrict__ u, const float* __restrict__ dy,
               U* __restrict__ du, const float* __restrict__ hs,
               float* __restrict__ part_b, float* __restrict__ part_c,
               float* __restrict__ part_t, float* __restrict__ part_a, int s,
               int dim) {
  constexpr int NH = N / 2;            // states a half
  extern __shared__ __align__(16) float smem[];
  float* dts = smem;                   // [TS]
  float* dtbs = dts + TS;              // [N][BS]: dt B, swizzled
  float* css = dtbs + N * BS;          // [N][BS]: C, swizzled
  float* us = css + N * BS;            // [CH][UP]: u, then du
  float* dys = us + CH * UP;           // [CH][UP]: dy
  float* a2s = dys + CH * UP;          // [N][CH]: a log2 e
  float* as = a2s + N * CH;            // [N][CH]: a
  float* red_b = as + N * CH;          // [WARPS][NH][TS]: terms of dB / dt
  float* red_c = red_b + WARPS * NH * TS;  // [WARPS][NH][TS]: terms of dC
  float* red_t = red_c + WARPS * NH * TS;  // [WARPS][TS]: terms of ddt
  float* ecs = red_t + WARPS * TS;     // [N][CH]: the reverse carry
  float* das = ecs + N * CH;           // [N][CH][L]: da by lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / L, j = lane % L;
  const bool b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;
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
    ecs[e] = 0.f;
  }
  for (int e = tid; e < N * CH * L; e += THREADS) das[e] = 0.f;
  // one tile into shared memory; zeros past S and past D
  auto load = [&](int t0) {
    for (int t = tid; t < TS; t += THREADS)
      dts[t] = t0 + t < s ? dt[row + t0 + t] : 0.f;
    for (int e = tid; e < TS * N; e += THREADS) {
      const int t = e / N, n = e % N;
      const bool ok = t0 + t < s;
      const long long p = (row + t0 + (ok ? t : 0)) * N + n;
      const float dtv = ok ? dt[row + t0 + t] : 0.f;
      dtbs[n * BS + swz(t)] = ok ? dtv * bm[p] : 0.f;
      css[n * BS + swz(t)] = ok ? cm[p] : 0.f;
    }
    for (int e = tid; e < TS * CH; e += THREADS) {
      const int t = e / CH, cc = e % CH, dd = d0 + cc;
      const bool ok = t0 + t < s && dd < dim;
      const long long p = (row + t0 + t) * dim + dd;
      us[cc * UP + pad(t)] = ok ? to_f32(u[p]) : 0.f;
      dys[cc * UP + pad(t)] = ok ? dy[p] : 0.f;
    }
  };

  // the tiles in reverse
  for (int it = ntiles - 1; it >= 0; --it) {
    const int t0 = it * TS;
    load(t0);
    __syncthreads();   // the tile is in
    float dk[K], uk[K], dyk[K], duk[K], dtk[K];
#pragma unroll
    for (int x = 0; x < K; ++x) {
      dk[x] = dts[K * j + x];
      uk[x] = us[c * UP + pad(K * j + x)];
      dyk[x] = dys[c * UP + pad(K * j + x)];
      duk[x] = dtk[x] = 0.f;
    }
    const float* hrow =
        hs + ((static_cast<long long>(b) * ntiles + it) * dim + (live ? d : 0)) * N;
    for (int half = 0; half < 2; ++half) {
#pragma unroll 1
      for (int nn = 0; nn < NH; ++nn) {
        const int n = half * NH + nn;
        const float a2 = a2s[n * CH + c];
        const float av = as[n * CH + c];
        float ak[K], hp[K], bv[K];
        float hh;
        load_row(bv, dtbs + n * BS, j);
        {
          // h before each of the lane's positions, as the forward forms it
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
          qb = ak[x] * fmaf(cv[x], dyk[x], qb);
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
        const float ec = ecs[n * CH + c];
        float e = __shfl_down_sync(FULL, fmaf(qa, ec, qb), 1, L);
        if (j == L - 1) e = ec;
        const float enext = __shfl_sync(FULL, fmaf(qa, ec, qb), 0, L);
        // terms of dB (v[0 .. K)) and dC (v[K .. 2K)) at the lane's positions
        float v[2 * K];
        float dan = 0.f;
#pragma unroll
        for (int x = K - 1; x >= 0; --x) {
          const float dh = fmaf(cv[x], dyk[x], e);
          e = ak[x] * dh;
          const float ht = x + 1 < K ? hp[x + 1] : hh;       // h_t
          const float dab = dh * hp[x] * ak[x];              // d(dt a)
          duk[x] = fmaf(dh, bv[x], duk[x]);
          dtk[x] = fmaf(dab, av, dtk[x]);
          dan = fmaf(dab, dk[x], dan);
          v[x] = dh * uk[x];
          v[K + x] = ht * dyk[x];
        }
        // sums over the warp's G channels (lane bits 3 and 4): after the two
        // steps this lane holds kind b4 (dB, dC) at positions 4 b3 .. + 3
        float w[K];
#pragma unroll
        for (int x = 0; x < K; ++x) w[x] = scatter_add(v[x], v[K + x], b4, 16);
        float r[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) r[x] = scatter_add(w[x], w[4 + x], b3, 8);
        float* red = (b4 ? red_c : red_b) + (warp * NH + nn) * TS + K * j + 4 * b3;
        *reinterpret_cast<float4*>(red) = make_float4(r[0], r[1], r[2], r[3]);
        das[(n * CH + c) * L + j] += dan;
        if (j == 0) ecs[n * CH + c] = enext;   // to the tile before
      }
      if (half == 1) {
        // ddt's terms over the warp's channels (4 positions, then 2 a lane)
        float w[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) w[x] = scatter_add(dtk[x], dtk[4 + x], b4, 16);
        const float r0 = scatter_add(w[0], w[2], b3, 8);
        const float r1 = scatter_add(w[1], w[3], b3, 8);
        *reinterpret_cast<float2*>(red_t + warp * TS + K * j + 4 * b4 + 2 * b3) =
            make_float2(r0, r1);
#pragma unroll
        for (int x = 0; x < K; ++x)
          us[c * UP + pad(K * j + x)] = duk[x];   // du over the group's u row
      }
      __syncthreads();   // the warps' rows are in
      // the block's dB and dC partials of the half's states
      for (int e2 = tid; e2 < TS * NH; e2 += THREADS) {
        const int t = e2 / NH, nn = e2 % NH;
        if (t0 + t >= s) continue;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w2 = 0; w2 < WARPS; ++w2) {
          sb += red_b[(w2 * NH + nn) * TS + t];
          sc += red_c[(w2 * NH + nn) * TS + t];
        }
        const long long p =
            ((static_cast<long long>(b) * nblk + blk) * s + t0 + t) * N +
            half * NH + nn;
        part_b[p] = sb;
        part_c[p] = sc;
      }
      if (half == 1) {
        // du back as coalesced rows; the block's ddt partials
        for (int e2 = tid; e2 < TS * CH; e2 += THREADS) {
          const int t = e2 / CH, cc = e2 % CH, dd = d0 + cc;
          if (t0 + t < s && dd < dim)
            from_f32(du + (row + t0 + t) * dim + dd, us[cc * UP + pad(t)]);
        }
        for (int t = tid; t < TS; t += THREADS) {
          if (t0 + t >= s) continue;
          float st = 0.f;
#pragma unroll
          for (int w2 = 0; w2 < WARPS; ++w2) st += red_t[w2 * TS + t];
          part_t[(static_cast<long long>(b) * nblk + blk) * s + t0 + t] = st;
        }
      }
      __syncthreads();   // the rows are read
    }
  }
  // da: the lanes' partials of each (channel, state) in lane order
  for (int e = tid; e < N * CH; e += THREADS) {
    const int n = e / CH, cc = e % CH, dd = d0 + cc;
    if (dd >= dim) continue;
    float x = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) x += das[e * L + l];
    part_a[(static_cast<long long>(b) * dim + dd) * N + n] = x;
  }
}

// the second launch: the partials summed in block (or batch row) order;
// ddt adds sum_n B_t[n] (sum_d dh_t u_t)[n], summed over the N lanes of
// (b, t) by a butterfly
__global__ void __launch_bounds__(SUM_THREADS)
mamba_scan_bwd_sums(const float* __restrict__ dt,
                    const float* __restrict__ bm,
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
  const long long bsn_pad = (bsn + 31) / 32 * 32;   // whole warps
  const long long dn = static_cast<long long>(dim) * n;
  if (i < bsn_pad) {
    const bool valid = i < bsn;
    const long long ii = valid ? i : 0;
    const long long b = ii / (static_cast<long long>(s) * n);
    const long long tn = ii % (static_cast<long long>(s) * n);
    float sb = 0.f, sc = 0.f;
    if (valid) {
      for (int k = 0; k < nblk; ++k) {
        const long long p = (b * nblk + k) * s * n + tn;
        sb += part_b[p];
        sc += part_c[p];
      }
      dbm[i] = sb * dt[i / n];
      dcm[i] = sc;
    }
    float x = valid ? bm[i] * sb : 0.f;
    for (int off = 1; off < n; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
    if (valid && tn % n == 0) {
      const long long t = tn / n;
      float st = 0.f;
      for (int k = 0; k < nblk; ++k) st += part_t[(b * nblk + k) * s + t];
      ddt[b * s + t] = st + x;
    }
  } else if (i < bsn_pad + dn) {
    const long long e = i - bsn_pad;
    float sa = 0.f;
    for (int b = 0; b < batch; ++b) sa += part_a[b * dn + e];
    da[e] = sa;
  }
}

template <int N, typename U>
int launch(const float* dt, const float* a, const float* bm, const float* cm,
           const void* u, const float* dy, void* du, float* ddt, float* da,
           float* dbm, float* dcm, float* work, const float* hs, int batch,
           int s, int dim, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd<N, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (dim + CH - 1) / CH;
  float* part_b = work;
  float* part_c = part_b + static_cast<long long>(batch) * nblk * s * N;
  float* part_t = part_c + static_cast<long long>(batch) * nblk * s * N;
  float* part_a = part_t + static_cast<long long>(batch) * nblk * s;
  mamba_scan_bwd<N, U><<<dim3(nblk, batch), THREADS, smem, stream>>>(
      dt, a, bm, cm, static_cast<const U*>(u), dy, static_cast<U*>(du), hs,
      part_b, part_c, part_t, part_a, s, dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long bsn = static_cast<long long>(batch) * s * N;
  const long long total = (bsn + 31) / 32 * 32 +
                          static_cast<long long>(dim) * N;
  mamba_scan_bwd_sums<<<static_cast<unsigned>((total + SUM_THREADS - 1) /
                                              SUM_THREADS),
                        SUM_THREADS, 0, stream>>>(dt, bm, part_b, part_c,
                                                  part_t, part_a, dbm, dcm,
                                                  ddt, da, batch, s, dim, N,
                                                  nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The workspace, in floats, that mamba_scan_bwd_f32 takes: the blocks'
// partial sums.
long long mamba_scan_bwd_workspace_floats(int batch, int s, int dim, int n) {
  const long long nblk = (dim + CH - 1) / CH;
  return static_cast<long long>(batch) *
         (2 * nblk * s * n + nblk * s + dim * n);
}

// dt (B, S), a (D, N), bm, cm, dbm, dcm (B, S, N), dy (B, S, D), ddt
// (B, S), da (D, N): contiguous float32; u and du (B, S, D) contiguous
// float32, or bfloat16 when u_bf16 is nonzero; hs (B, ceil(S / 64), D, N)
// float32, the state entering each 64-position tile as the forward pass
// (mamba_scan.cu) keeps it.  N is 8 or 16, S >= 1.  `work`:
// mamba_scan_bwd_workspace_floats(...) floats, not used by another call in
// flight.  The outputs do not alias the inputs.
int mamba_scan_bwd_f32(const void* dt, const void* a, const void* bm,
                       const void* cm, const void* u, const void* dy,
                       void* du, void* ddt, void* da, void* dbm, void* dcm,
                       void* work, const void* hs, int batch, int s, int dim,
                       int n, int u_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (batch < 0 || s < 1 || dim < 0 || hs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || dim == 0) return static_cast<int>(cudaSuccess);
#define SCAN_BWD_ARGS                                                      \
  static_cast<const float*>(dt), static_cast<const float*>(a),             \
      static_cast<const float*>(bm), static_cast<const float*>(cm), u,     \
      static_cast<const float*>(dy), du, static_cast<float*>(ddt),         \
      static_cast<float*>(da), static_cast<float*>(dbm),                   \
      static_cast<float*>(dcm), static_cast<float*>(work),                 \
      static_cast<const float*>(hs), batch, s, dim, st
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
