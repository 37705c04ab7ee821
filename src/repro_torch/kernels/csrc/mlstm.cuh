// Pieces of the chunkwise mLSTM kernels: the chunk and window sizes, the
// gates pass (A) that the forward pass (mlstm.cu) and the backward pass
// (mlstm_bwd.cu) share, the forward's 64 x C tile product on the CUDA cores,
// its staging of 64-position slabs of q or k and its partial scores pass
// (S), and the backward's f32 products on the tensor cores (three TF32
// passes).  mlstm.cu says what each pass computes.  The passes are device
// functions: each file wraps them in kernels of its own names, so that a
// trace tells the forward's launches from the backward's.

#pragma once

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace mlstm {

using hopper::cp_async_16_or_zero;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int Q = 64;             // positions per chunk
constexpr int SLOTS = 16;         // chunk states a window holds
constexpr int NGATE = 5;          // per position: src, g, m_t, inter, coeff
constexpr int GATE_THREADS = 256;
constexpr int GATE_WINDOW = 64;    // chunks the gates pass holds at once
constexpr int DK = 32;            // slab of dh staged per step (S and C)
constexpr unsigned FULL = 0xffffffffu;

inline int n_chunks(int s) { return (s + Q - 1) / Q; }
inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}
// splits of dh in the scores pass: enough blocks to fill the card at dh 512
template <int DH>
__host__ __device__ constexpr int score_splits() {
  return DH >= 256 ? DH / 128 : 1;
}
// per (batch row x head): NGATE x (padded positions), the chunks' decays,
// the final rescale
__host__ __device__ inline long long gate_stride(int nc) {
  return static_cast<long long>(NGATE) * nc * Q + nc + 1;
}

// ---- a 64 x C tile product in (C / 8) x 16 threads --------------------------
// Thread (ty, tx) holds rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 and
// C/2 + 4 tx .. C/2 + 4 tx + 3 of the tile: its reads of A (k-major, [k][rows])
// and B ([k][columns]) are float4s, the A reads of a warp broadcast, the B
// reads of 8 lanes one 128-byte row.
template <int C>
__device__ __forceinline__ int col(int tx, int j) {
  return (j < 4 ? 0 : C / 2) + 4 * tx + (j & 3);
}

template <int C>
__device__ __forceinline__ void fma_step(float (&acc)[4][8], const float* a,
                                         const float* b, int ty, int tx) {
  const float4 av = *reinterpret_cast<const float4*>(a + 4 * ty);
  const float4 b0 = *reinterpret_cast<const float4*>(b + 4 * tx);
  const float4 b1 = *reinterpret_cast<const float4*>(b + C / 2 + 4 * tx);
  const float ar[4] = {av.x, av.y, av.z, av.w};
  const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// ---- f32 products on the tensor cores: three TF32 passes ----------------------
// x = hi + lo with hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna) and lo = (x - hi) rounded likewise; a product's
// hi hi + hi lo + lo hi keeps ~2^-21 of f32's 2^-24 (lo lo, ~2^-22 of the
// product, is dropped), where one pass keeps ~2^-11.  Fragments of
// mma.m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g);
// C c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1).  The
// sum runs over k in any order, so a product whose A and B both take k
// columns 2 t, 2 t + 1 for t, t + 4 (a float2 each) is the same product.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) B (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the two small passes: lo hi and hi lo
__device__ __forceinline__ void mma_small(float (&d)[4], const FragA& a,
                                          const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
}

// d += a b, the small passes first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_small(d, a, b);
  mma_tf32(d, a.hi, b.hi);
}

// ---- A. gates ----------------------------------------------------------------
// the body of a kernel of GATE_THREADS threads, one block per (batch row,
// head); each includer names its own kernel around it
__device__ __forceinline__ void
gates_pass(const float* __restrict__ gate_i, const float* __restrict__ gate_f,
           const float* __restrict__ m0, float* __restrict__ m1,
           float* __restrict__ gates, int s, int h, int nc, int pad_floor) {
  // a window of GATE_WINDOW chunks at a time, so that S has no limit of
  // shared memory
  __shared__ float f_last[GATE_WINDOW];  // F at each chunk's last position
  __shared__ float r_last[GATE_WINDOW];  // the running max there
  __shared__ float m_prev[GATE_WINDOW];  // m entering each chunk
  __shared__ float g_last[GATE_WINDOW];  // g at each chunk's last position
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s_pad = nc * Q;
  float* gw = gates + bh * gate_stride(nc);
  float* g_src = gw;              // logi_t - F_t
  float* g_g = gw + s_pad;        // g_t (the running max until step 3)
  float* g_mt = gw + 2 * s_pad;   // m_t = F_t + g_t (F_t until step 3)
  float* g_inter = gw + 3 * s_pad;  // e^{m_prev - g_t}
  float* g_coeff = gw + 4 * s_pad;  // e^{src_t - g_last}
  float* g_decay = gw + 5 * s_pad;  // per chunk e^{m_prev - g_last}; rescale
  const long long base = static_cast<long long>(b) * s * h + head;
  const float* li = gate_i + base;
  const float* lf = gate_f + base;
  float mp = m0[bh];              // m entering the window (thread 0's)

  for (int w0 = 0; w0 < nc; w0 += GATE_WINDOW) {
    const int wn = min(nc - w0, GATE_WINDOW);
    // 1. per chunk, one warp, two positions a lane: F by a warp scan of the
    // lanes' pair sums, src = logi - F, and src's running max
    for (int jw = warp; jw < wn; jw += GATE_THREADS / 32) {
      const int j = w0 + jw;
      const int t = j * Q + 2 * lane;
      const bool ok0 = t < s, ok1 = t + 1 < s;
      const float f0 = ok0 ? lf[static_cast<long long>(t) * h] : 0.f;
      const float f1 = ok1 ? lf[static_cast<long long>(t + 1) * h] : 0.f;
      const float i0 = ok0 ? li[static_cast<long long>(t) * h] : 0.f;
      const float i1 = ok1 ? li[static_cast<long long>(t + 1) * h] : 0.f;
      float sum = f0 + f1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, sum, off);
        if (lane >= off) sum = o + sum;
      }
      float before = __shfl_up_sync(FULL, sum, 1);
      if (lane == 0) before = 0.f;
      const float F0 = before + f0;
      const float F1 = F0 + f1;
      const float s0 = i0 - F0, s1 = i1 - F1;
      float run = fmaxf(s0, s1);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, run, off);
        if (lane >= off) run = fmaxf(o, run);
      }
      float rb = __shfl_up_sync(FULL, run, 1);
      if (lane == 0) rb = -INFINITY;
      const float R0 = fmaxf(rb, s0), R1 = fmaxf(R0, s1);
      g_src[t] = s0;
      g_src[t + 1] = s1;
      g_mt[t] = F0;
      g_mt[t + 1] = F1;
      g_g[t] = R0;
      g_g[t + 1] = R1;
      const int last = min(s, (j + 1) * Q) - 1;
      if (t == last) {
        f_last[jw] = F0;
        r_last[jw] = R0;
      } else if (t + 1 == last) {
        f_last[jw] = F1;
        r_last[jw] = R1;
      }
    }
    __syncthreads();
    // 2. m from chunk to chunk: one scalar a chunk
    if (threadIdx.x == 0) {
      for (int jw = 0; jw < wn; ++jw) {
        const float gl = fmaxf(mp, r_last[jw]);
        m_prev[jw] = mp;
        g_last[jw] = gl;
        g_decay[w0 + jw] = expf(mp - gl);
        mp = f_last[jw] + gl;
      }
      if (w0 + wn == nc) {
        // the reference's padding: m floored at 0, C and n rescaled to it
        const float mo = pad_floor ? fmaxf(mp, 0.f) : mp;
        g_decay[nc] = expf(mp - mo);
        m1[bh] = mo;
      }
    }
    __syncthreads();
    // 3. per position (the next window's step 1 writes only f_last and
    // r_last, which this step does not read)
    for (int t = w0 * Q + threadIdx.x; t < (w0 + wn) * Q;
         t += GATE_THREADS) {
      const int jw = t / Q - w0;
      if (t < s) {
        const float mpj = m_prev[jw];
        const float g = fmaxf(mpj, g_g[t]);
        g_mt[t] = g_mt[t] + g;
        g_g[t] = g;
        g_inter[t] = expf(mpj - g);
        g_coeff[t] = expf(g_src[t] - g_last[jw]);
      } else {
        g_src[t] = g_g[t] = g_mt[t] = g_inter[t] = g_coeff[t] = 0.f;
      }
    }
  }
}

// ---- staging a 64-position slab of q or k, transposed: [d][position] --------
// Each thread loads float4s along d (LOADS of them) into registers, and
// stores them as columns of the slab once the slab before is used.
template <int NT>
struct Slab {
  static constexpr int LOADS = Q * (DK / 4) / NT;
  float4 r[LOADS];
  __device__ __forceinline__ void fetch(const float* x, int b, int t0, int s,
                                        int h, int head, int dh, int d0,
                                        int tid) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int e = tid + l * NT;
      const int t = e % Q, d4 = e / Q;
      r[l] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + t < s)
        r[l] = *reinterpret_cast<const float4*>(
            x + ((static_cast<long long>(b) * s + t0 + t) * h + head) * dh +
            d0 + 4 * d4);
    }
  }
  __device__ __forceinline__ void store(float* dst, float mul, int tid) const {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int e = tid + l * NT;
      const int t = e % Q, d4 = e / Q;
      dst[(4 * d4 + 0) * Q + t] = r[l].x * mul;
      dst[(4 * d4 + 1) * Q + t] = r[l].y * mul;
      dst[(4 * d4 + 2) * Q + t] = r[l].z * mul;
      dst[(4 * d4 + 3) * Q + t] = r[l].w * mul;
    }
  }
};

// ---- S. partial scores q k^T ------------------------------------------------
constexpr int SCORE_THREADS = 128;

template <int DH>
// the body of a kernel of SCORE_THREADS threads, grid (chunks of the window,
// B H, splits); each includer names its own kernel around it
__device__ __forceinline__ void
scores_pass(const float* __restrict__ q, const float* __restrict__ k,
            float* __restrict__ scores, int s, int h, int j0) {
  constexpr int KS = score_splits<DH>();
  constexpr int DS = DH / KS;        // dh per block
  constexpr int NT = SCORE_THREADS;
  __shared__ __align__(16) float qt[DK * Q];
  __shared__ __align__(16) float kt[DK * Q];
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int jl = blockIdx.x, bh = blockIdx.y, nbh = gridDim.y;
  const int split = blockIdx.z, b = bh / h, head = bh % h;
  const int t0 = (j0 + jl) * Q;
  Slab<NT> pq, pk;
  float acc[4][8];
  zero(acc);
  pq.fetch(q, b, t0, s, h, head, DH, split * DS, tid);
  pk.fetch(k, b, t0, s, h, head, DH, split * DS, tid);
  for (int d0 = 0; d0 < DS; d0 += DK) {
    __syncthreads();   // the slab before is used
    pq.store(qt, 1.f, tid);
    pk.store(kt, 1.f, tid);
    __syncthreads();
    if (d0 + DK < DS) {
      pq.fetch(q, b, t0, s, h, head, DH, split * DS + d0 + DK, tid);
      pk.fetch(k, b, t0, s, h, head, DH, split * DS + d0 + DK, tid);
    }
#pragma unroll 8
    for (int d = 0; d < DK; ++d) fma_step<Q>(acc, qt + d * Q, kt + d * Q, ty, tx);
  }
  float* out = scores +
               ((static_cast<long long>(jl) * nbh + bh) * KS + split) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = out + (4 * ty + i) * Q;
    *reinterpret_cast<float4*>(row + col<Q>(tx, 0)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + col<Q>(tx, 4)) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace mlstm
