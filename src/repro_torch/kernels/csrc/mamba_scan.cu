// Selective scan (Mamba S6) for Hopper (sm_90a), float32, with the
// discretisation fused in and a state in and a state out.
//
// Replaces the Pallas TPU kernel `mamba_scan` of
// src/repro/kernels/mamba_scan/mamba_scan.py (`_kernel`), and computes what
// the reference model runs in src/repro/models/mamba.py: the discretisation
// (`a_bar = exp(dt a)`, `b_bar = (dt B_n) u_d`, in that order of
// operations), `_chunked_selective_scan`, and the `bsdn,bsn->bsd`
// contraction:
//   h_t[d, n] = exp(dt_t a[d, n]) h_{t-1}[d, n] + (dt_t B_t[n]) u_t[d]
//   y_t[d]    = sum_n h_t[d, n] C_t[n]
// for dt (B, S) f32 after the softplus, a (D, N) = -exp(a_log) f32,
// B, C (B, S, N) f32, u (B, S, D) f32 or bf16 (the activation after the conv
// and SiLU), and h_0 (B, D, N) f32 or zero.  Outputs y (B, S, D) f32 and
// h_S (B, D, N) f32.  On the port's serving path it runs every prefill of
// every Mamba layer, from the lane's fresh state, and hands h_S to decode.
//
// Differences from the Pallas kernel, all to follow the model that serving
// runs: it takes the undiscretised inputs, so the (S, D, N) tensors a_bar and
// b_bar never reach device memory (the Pallas kernel reads them from HBM,
// formed by its caller); a state comes in and goes out (the Pallas kernel
// starts from zero and keeps its state); any S >= 0 and D >= 1 (the Pallas
// kernel wants block multiples).
//
// Bound.  Per (position, channel, state): one exponential and six f32
// operations (dt a, the input product, the state's multiply-add, the
// output's multiply-add); per position the S x D inputs u are read once and
// the S x D outputs y written once in f32.  At the main path's B = 1,
// S = 980, D = 16384, N = 16 that is ~2.6e8 exponentials, ~1.8e9 f32
// operations in all (~0.027 ms at 67 TFLOP/s), against ~0.1 GB of bytes
// (~0.029 ms at 3.35 TB/s): the two nearly meet.  The exponentials have a
// floor of their own: the special-function units compute 16 a clock on an
// SM, ~0.062 ms for 2.6e8 of them on 132 SMs at ~1.98 GHz.
//
// Design: the time axis supplies the parallelism, as in the Mamba authors'
// kernel.  A block of 8 warps takes 64 channels and walks S in tiles of 64
// positions.  A group of 4 lanes takes one channel, a lane 16 consecutive
// positions of the tile (a warp: 8 channels).  For each state n the lane
// forms its positions' (a, b) = (exp(dt a[d, n]), (dt B[n]) u), composes
// them into one pair, the group scans its 4 pairs with
// (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2) (two shuffle steps), the h
// carried from the tile before enters through the exclusive prefix, and the
// lane re-walks its positions, h = a h + b, y += C[n] h; the group's last
// lane hands h to the next tile.  So each y_t takes one multiply-add per
// state, the 16 positions of a lane independent: no position waits on a
// 16-long chain.  One exponential per (position, channel, state), on the
// special-function unit (ex2 of dt a log2 e).  dt B and C are shared by the
// block's 64 channels: the group's 4 lanes read them as float4s from a
// swizzled row (one wavefront, broadcast to the warp's 8 groups).  The next
// tile (dt, the B and C rows, the u rows of the block's channels, bf16 or
// f32 as they lie in device memory) arrives by cp.async while this tile is
// computed, and is then transposed into the other of two stages, dt B formed
// once and u widened to f32 there.  y goes back through shared memory as
// coalesced rows.  Padded positions of the last tile have dt = 0, the
// identity pair.  Every sum runs in a fixed order: repeated runs give the
// same bits.  128 registers a thread, 2 blocks an SM.  Under a gradient
// it also writes the state entering each tile (hs), for the backward pass:
// a separate instance (KEEP), so that the serving path's is unchanged.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mamba_scan.cuh"

namespace {

using namespace scan;

using hopper::cp_async_16_or_zero;
using hopper::cp_async_4_or_zero;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// one stage: dt [TS], dt B and C [N][BS] (positions swizzled), u [CH][UP]
template <int N>
__host__ __device__ constexpr int stage_floats() {
  return TS + 2 * N * BS + CH * UP;
}

// the next tile as it lies in device memory: dt [TS], B and C [TS][N],
// u [TS][CH] (f32, or bf16 in the first half)
template <int N>
__host__ __device__ constexpr int raw_floats() {
  return TS + 2 * TS * N + TS * CH;
}

template <int N>
constexpr size_t smem_bytes() {
  return (2 * stage_floats<N>() + raw_floats<N>() + N * CH) * sizeof(float);
}

template <int N, typename U, bool KEEP>
__global__ void __launch_bounds__(THREADS, 2)
mamba_scan_fwd(const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const U* __restrict__ u, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last,
               float* __restrict__ hs, int s, int dim) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem + 2 * stage_floats<N>();
  U* raw_u = reinterpret_cast<U*>(raw + TS + 2 * TS * N);
  float* a2s = raw + raw_floats<N>();          // [N][CH]: a log2 e
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / L, j = lane % L;    // group (channel), lane in it
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = warp * G + g, d = d0 + c;
  const bool live = d < dim;
  const long long row = static_cast<long long>(b) * s;

  for (int e = tid; e < N * CH; e += THREADS) {
    const int dd = d0 + e % CH;
    a2s[e] = dd < dim ? a[static_cast<long long>(dd) * N + e / CH] * LOG2E
                      : 0.f;
  }
  // h of the lane's channel, carried from tile to tile (every lane of the
  // group holds it)
  float hc[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    hc[n] = (live && h0 != nullptr)
                ? h0[(static_cast<long long>(b) * dim + d) * N + n]
                : 0.f;

  // The next tile arrives by cp.async as it lies in device memory (dt, the
  // B and C rows, the u rows of the block's channels), in flight while this
  // tile is computed; then it is transposed into the other stage, dt B
  // formed there once for every channel of the block, u widened to f32.
  constexpr int Q4 = N / 4;                          // 16-byte pieces of a row
  constexpr int UW = CH * sizeof(U) / 4;             // 4-byte pieces of a u row
  constexpr int UPW = 4 / sizeof(U);                 // channels a piece
  auto issue = [&](int t0) {
    if (tid < TS) {
      const bool ok = t0 + tid < s;
      cp_async_4_or_zero(raw + tid, dt + row + t0 + (ok ? tid : 0), ok);
    }
    for (int e = tid; e < TS * Q4; e += THREADS) {
      const int t = e / Q4;
      const bool ok = t0 + t < s;
      const long long p = (row + t0 + (ok ? t : 0)) * N + 4 * (e % Q4);
      cp_async_16_or_zero(raw + TS + 4 * e, bm + p, ok);
      cp_async_16_or_zero(raw + TS + TS * N + 4 * e, cm + p, ok);
    }
    for (int e = tid; e < TS * UW; e += THREADS) {
      const int t = e / UW, dd = d0 + UPW * (e % UW);
      const bool ok = t0 + t < s && dd < dim;
      const U* src = u + (row + t0 + (ok ? t : 0)) * dim + (ok ? dd : 0);
      cp_async_4_or_zero(raw_u + UPW * e, src, ok);
    }
    cp_async_commit();
  };
  auto transpose = [&](int stg) {
    float* base = smem + stg * stage_floats<N>();
    if (tid < TS) base[tid] = raw[tid];
    for (int e = tid; e < TS * Q4; e += THREADS) {
      const int t = e / Q4, n = 4 * (e % Q4);
      const float dtv = raw[t];
      const float4 bv = *reinterpret_cast<const float4*>(raw + TS + 4 * e);
      const float4 cv =
          *reinterpret_cast<const float4*>(raw + TS + TS * N + 4 * e);
      float* bs = base + TS + n * BS + swz(t);
      float* cs = bs + N * BS;
      bs[0] = dtv * bv.x; bs[BS] = dtv * bv.y;
      bs[2 * BS] = dtv * bv.z; bs[3 * BS] = dtv * bv.w;
      cs[0] = cv.x; cs[BS] = cv.y; cs[2 * BS] = cv.z; cs[3 * BS] = cv.w;
    }
    float* su = base + TS + 2 * N * BS;
    for (int e = tid; e < TS * CH; e += THREADS)
      su[(e % CH) * UP + pad(e / CH)] = to_f32(raw_u[e]);
  };

  if (s > 0) {
    issue(0);
    cp_async_wait<0>();
    __syncthreads();
    transpose(0);
    __syncthreads();
  }
  for (int t0 = 0, it = 0; t0 < s; t0 += TS, ++it) {
    if (KEEP && live) {   // the state entering the tile
      float* hp = hs + ((static_cast<long long>(b) * ((s + TS - 1) / TS) + it)
                        * dim + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (n % L == j) hp[n] = hc[n];
    }
    const int stg = it & 1;
    const bool more = t0 + TS < s;
    if (more) issue(t0 + TS);
    const float* base = smem + stg * stage_floats<N>();
    const float* bs = base + TS;
    const float* cs = bs + N * BS;
    float* urow = smem + stg * stage_floats<N>() + TS + 2 * N * BS + c * UP;
    float dk[K], uk[K], yk[K];
#pragma unroll
    for (int m = 0; m < K / 4; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(base + K * j + 4 * m);
      dk[4 * m] = v.x;
      dk[4 * m + 1] = v.y;
      dk[4 * m + 2] = v.z;
      dk[4 * m + 3] = v.w;
    }
#pragma unroll
    for (int x = 0; x < K; ++x) {
      uk[x] = urow[pad(K * j + x)];
      yk[x] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float a2 = a2s[n * CH + c];
      float ak[K], bk[K];
      {
        float bv[K];
        load_row(bv, bs + n * BS, j);
#pragma unroll
        for (int x = 0; x < K; ++x) {
          ak[x] = ex2(dk[x] * a2);
          bk[x] = bv[x] * uk[x];
        }
      }
      // the lane's K positions as one pair
      float pa = ak[0], pb = bk[0];
#pragma unroll
      for (int x = 1; x < K; ++x) {
        pb = fmaf(ak[x], pb, bk[x]);
        pa *= ak[x];
      }
      // inclusive scan over the group's L lanes, the earlier pair first
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float oa = __shfl_up_sync(FULL, pa, off, L);
        const float ob = __shfl_up_sync(FULL, pb, off, L);
        if (j >= off) {
          pb = fmaf(pa, ob, pb);
          pa *= oa;
        }
      }
      // h before the lane's first position: the lane before's end state
      float hh = __shfl_up_sync(FULL, fmaf(pa, hc[n], pb), 1, L);
      if (j == 0) hh = hc[n];
      float cv[K];
      load_row(cv, cs + n * BS, j);
#pragma unroll
      for (int x = 0; x < K; ++x) {
        hh = fmaf(ak[x], hh, bk[x]);
        yk[x] = fmaf(cv[x], hh, yk[x]);
      }
      hc[n] = __shfl_sync(FULL, hh, L - 1, L);   // h after the tile
    }
    // y over u in the group's own row
#pragma unroll
    for (int x = 0; x < K; ++x) urow[pad(K * j + x)] = yk[x];
    if (more) cp_async_wait<0>();
    __syncthreads();  // y is in place, the next tile has landed
    if (more) transpose(stg ^ 1);
    const float* sy = smem + stg * stage_floats<N>() + TS + 2 * N * BS;
    for (int e = tid; e < TS * CH; e += THREADS) {
      const int t = e / CH, dd = d0 + e % CH;
      if (t0 + t < s && dd < dim)
        y[(row + t0 + t) * dim + dd] = sy[(e % CH) * UP + pad(t)];
    }
    __syncthreads();  // the next stage is complete; the raw tile is free
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (n % L == j)
        h_last[(static_cast<long long>(b) * dim + d) * N + n] = hc[n];
  }
}

template <int N, typename U>
int launch(const float* dt, const float* a, const float* bm,
           const float* cm, const void* u, const float* h0, float* y,
           float* h_last, float* hs, int batch, int s, int dim,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  const auto kernel = hs != nullptr ? mamba_scan_fwd<N, U, true>
                                    : mamba_scan_fwd<N, U, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dim + CH - 1) / CH, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      dt, a, bm, cm, static_cast<const U*>(u), h0, y, h_last, hs, s, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dt (B, S), a (D, N), bm, cm (B, S, N), h0 and h_last (B, D, N), y
// (B, S, D): contiguous float32; u (B, S, D) contiguous float32, or bfloat16
// when u_bf16 is nonzero; h0 may be null (zero state).  hs, when not null,
// (B, ceil(S / 64), D, N) float32: the state entering each 64-position
// tile, which the backward pass (mamba_scan_bwd.cu) takes instead of its own
// forward sweep.  N is 8 or 16.  The outputs do not alias the inputs.
int mamba_scan(const void* dt, const void* a, const void* bm, const void* cm,
               const void* u, const void* h0, void* y, void* h_last,
               void* hs, int batch, int s, int dim, int n, int u_bf16,
               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (batch < 0 || s < 0 || dim < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || dim == 0) return static_cast<int>(cudaSuccess);
#define SCAN_ARGS                                                        \
  static_cast<const float*>(dt), static_cast<const float*>(a),           \
      static_cast<const float*>(bm), static_cast<const float*>(cm), u,   \
      static_cast<const float*>(h0), static_cast<float*>(y),             \
      static_cast<float*>(h_last), static_cast<float*>(hs), batch, s, dim, \
      st
  switch (n * 2 + (u_bf16 != 0)) {
    case 16: return launch<8, float>(SCAN_ARGS);
    case 17: return launch<8, __nv_bfloat16>(SCAN_ARGS);
    case 32: return launch<16, float>(SCAN_ARGS);
    case 33: return launch<16, __nv_bfloat16>(SCAN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_ARGS
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
