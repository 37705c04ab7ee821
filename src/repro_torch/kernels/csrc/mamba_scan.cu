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
// (~0.029 ms at 3.35 TB/s): the two nearly meet.
//
// Design.  One thread per (batch row, channel d), its N states and its N
// decay rates a[d, :] in registers, walking the positions in order: the
// recurrence is sequential in t, and 16 independent chains per thread give
// the instruction-level parallelism a lone warp per scheduler needs.  dt,
// B and C of a tile of TS positions are shared by every channel of a row,
// so a block of 128 channels stages them in shared memory, and each thread
// stages its own u for the tile beside them; both are double-buffered
// through registers: the next tile's loads are issued before this tile's
// positions are walked, so the block waits on device memory once per
// tile, not once per position.  The y stores of a warp are 32 consecutive
// floats.  At D = 16384 and B = 1 that is 128 blocks of 128 threads on 132
// SMs.  Every sum runs in a fixed order: repeated runs give the same bits.
// A chunked parallel scan over S, or exp(dt a) built from fewer
// exponentials, are for the fast version.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int TS = 32;         // positions per staged tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, typename U>
__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd(const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const U* __restrict__ u, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last, int s,
               int dim) {
  constexpr int ROW = 2 * N + 1;                 // dt, B[0:N], C[0:N]
  constexpr int PER = (TS * ROW + THREADS - 1) / THREADS;
  __shared__ float st[2][TS * ROW];
  __shared__ float su[2][TS][THREADS];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + tid;
  const bool live = d < dim;
  const long long row = static_cast<long long>(b) * s;
  const float* dtb = dt + row;
  const float* bmb = bm + row * N;
  const float* cmb = cm + row * N;
  const U* ub = u + row * dim + d;
  float* yb = y + row * dim + d;

  float ad[N], h[N];
  const long long sd = (static_cast<long long>(b) * dim + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ad[n] = live ? a[static_cast<long long>(d) * N + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[sd + n] : 0.f;
  }

  // the next tile's staged values and u, loaded into registers while this
  // tile's positions are walked
  float nst[PER], nu[TS];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int t = e / ROW, c = e % ROW;
      float v = 0.f;
      if (e < TS * ROW && t0 + t < s) {
        const long long p = t0 + t;
        v = c == 0 ? dtb[p] : c <= N ? bmb[p * N + c - 1]
                                     : cmb[p * N + c - 1 - N];
      }
      nst[i] = v;
    }
#pragma unroll
    for (int t = 0; t < TS; ++t)
      nu[t] = (live && t0 + t < s)
                  ? to_f32(ub[static_cast<long long>(t0 + t) * dim])
                  : 0.f;
  };

  if (s > 0) fetch(0);
  int buf = 0;
  for (int t0 = 0; t0 < s; t0 += TS) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      if (e < TS * ROW) st[buf][e] = nst[i];
    }
#pragma unroll
    for (int t = 0; t < TS; ++t) su[buf][t][tid] = nu[t];
    __syncthreads();
    if (t0 + TS < s) fetch(t0 + TS);
    const int len = min(TS, s - t0);
    if (live) {
      const float* sp = st[buf];
      for (int t = 0; t < len; ++t) {
        const float* r = sp + t * ROW;
        const float dtv = r[0];
        const float uv = su[buf][t][tid];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float abar = expf(dtv * ad[n]);
          const float bbar = (dtv * r[1 + n]) * uv;
          h[n] = abar * h[n] + bbar;
          acc += h[n] * r[1 + N + n];
        }
        yb[static_cast<long long>(t0 + t) * dim] = acc;
      }
    }
    buf ^= 1;
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[sd + n] = h[n];
  }
}

template <int N, typename U>
int launch(const float* dt, const float* a, const float* bm,
           const float* cm, const void* u, const float* h0, float* y,
           float* h_last, int batch, int s, int dim, cudaStream_t stream) {
  const dim3 grid((dim + THREADS - 1) / THREADS, batch);
  mamba_scan_fwd<N, U><<<grid, THREADS, 0, stream>>>(
      dt, a, bm, cm, static_cast<const U*>(u), h0, y, h_last, s, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dt (B, S), a (D, N), bm, cm (B, S, N), h0 and h_last (B, D, N), y
// (B, S, D): contiguous float32; u (B, S, D) contiguous float32, or bfloat16
// when u_bf16 is nonzero; h0 may be null (zero state).  N is 8 or 16.  The
// outputs do not alias the inputs.
int mamba_scan(const void* dt, const void* a, const void* bm, const void* cm,
               const void* u, const void* h0, void* y, void* h_last,
               int batch, int s, int dim, int n, int u_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (batch < 0 || s < 0 || dim < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || dim == 0) return static_cast<int>(cudaSuccess);
#define SCAN_ARGS                                                        \
  static_cast<const float*>(dt), static_cast<const float*>(a),           \
      static_cast<const float*>(bm), static_cast<const float*>(cm), u,   \
      static_cast<const float*>(h0), static_cast<float*>(y),             \
      static_cast<float*>(h_last), batch, s, dim, st
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
