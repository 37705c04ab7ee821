// Flash-attention backward pass for Hopper (sm_90a), float and bfloat16.
//
// Replaces no Pallas kernel: the reference trains through its jnp
// `chunked_attention` (src/repro/models/layers.py) and lets JAX
// differentiate it.  The port's training path runs attention through the
// forward kernel of flash_attention.cu, whose output a ctypes launch leaves
// without a gradient; this kernel gives it one.  It computes dQ, dK and dV
// of that kernel's function, softmax(Q K^T scale) V under the same
// end-aligned causal / sliding-window mask (query row i sits at
// Sk - Sq + i), with GQA (query head h reads kv head h / rep), with f32
// sums, on f32 or bf16 inputs, at head dims 64 and 128.
//
// The forward kernel writes each row's log-sum-exp L (natural log, f32,
// (B, H, Sq); -inf for a row that sees no key) when it is given a pointer
// for it.  With P = exp(S scale - L) recomputed from Q and K:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dO o O),
//   dQ = dS K scale,  dK = dS^T Q scale.
// A row that sees no key has P = 0 and so no gradient.
//
// Bound.  Five products of the visible (query, key) pairs by dh (S, dP, dV,
// dK, dQ): 10 dh FLOP a pair, 2.5 times the forward's 4.  At the training
// shape (B 8, S 2048, H 16, dh 64, causal) that is 1.7e11 FLOP a call
// against ~67 MB of bf16 inputs and outputs: the operations bound it, at
// the tensor cores' rate in bf16 and the CUDA cores' in f32.
//
// Three launches, FA2's split, so that no sum needs atomics and two calls
// give the same bits (restarts reproduce):
//   1. `bwd_dsum`: D = rowsum(dO o O) in f32, one warp a row.
//   2. `bwd_dkdv`: one block per (key tile of 64, kv head, batch row).  K
//      and V stay in shared memory; the block walks the group's rep query
//      heads and, for each, the query tiles of 64 rows that see some key of
//      the tile (the causal and window band; tiles outside it are never
//      read), recomputes S and dP, and accumulates dV and dK in registers.
//      The GQA sum over the group is this loop, in a fixed order.
//   3. `bwd_dq`: one block per (query tile of 64, head, batch row), walking
//      the key tiles the forward walks, dQ accumulated in registers.
// Both kernels recompute S and dP, so a pair costs 7 products instead of 5.
//
// bf16 (`bwd_dkdv_mma`, `bwd_dq_mma`): the products on the tensor cores by
// warp-level mma.sync m16n8k16 (bf16 in, f32 sums), 4 warps a block, each
// owning 16 of the block's 64 rows (keys, or queries) and holding its
// accumulators as mma fragments; S^T = K Q^T and dP^T = V dO^T come out in
// the layout of the A operand of dV += P^T dO and dK += dS^T Q, so P and dS
// go from registers to the next product as bf16 without shared memory.
// Tiles are bf16 in shared memory, filled by cp.async and read by ldmatrix
// (.trans for the operands whose contraction runs down the rows).  The only
// roundings beyond the plain version's are P and dS to bf16 before their
// products.  `wgmma` and TMA wait for a later version.
//
// f32 (`bwd_dkdv`, `bwd_dq`): the CUDA cores, as the f32 forward kernel
// (TF32 would not hold the f32 checks): tiles of 64 x 64 scores, each
// thread 4 x 4 of them and 4 rows x dh/16 columns of its accumulators, rows
// padded by one float in shared memory so that neighbouring threads hit
// neighbouring banks.
//
// Inputs are contiguous (B, S, heads, dh) tensors (the wrapper makes them
// so); dQ, dK, dV are written in the input type.
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, do not synchronise, and return the first cudaGetLastError() that
// is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;  // score rows per thread
constexpr int CPT = BK / TX;  // score columns per thread
constexpr int PP = BK + 1;    // padded row of P and dS

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

template <int DH>
struct Smem {
  static constexpr int KP = DH + 1;  // padded row of Q, dO, K, V
  // four [64][KP] tiles, two [64][PP] tiles, two [64] row vectors
  static constexpr size_t bytes =
      (4 * size_t(64) * KP + 2 * size_t(64) * PP + 2 * 64) * sizeof(float);
};

// `rows` rows of a (.., heads, DH) tensor starting at row r0 (row stride
// `rs` elements), zero past `n`, into a [64][KP] f32 tile
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, long long rs) {
  constexpr int KP = DH + 1;
  for (int e = threadIdx.x; e < 64 * DH; e += THREADS) {
    const int r = e / DH, c = e % DH;
    dst[r * KP + c] = r0 + r < n ? ld(src + (r0 + r) * rs + c) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  bool ok = true;
  if (causal) ok = kpos <= qpos;
  if (window) ok = ok && kpos > qpos - window;
  return ok;
}

// s[i][j] = A[ty + TY i] . B[tx + TX j] over DH, A and B [64][KP] tiles
template <int DH>
__device__ __forceinline__ void tile_dot(float (&s)[RPT][CPT],
                                         const float* A, const float* B) {
  constexpr int KP = DH + 1;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float av[RPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = A[(ty + TY * i) * KP + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bv[j] = B[(tx + TX * j) * KP + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]; one warp a row
template <typename T, int DH>
__global__ void __launch_bounds__(256)
bwd_dsum(const T* __restrict__ o, const T* __restrict__ dout,
         float* __restrict__ dsum, long long rows, int sq, int h) {
  const long long r = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < DH; c += 32)
    acc = fmaf(ld(o + r * DH + c), ld(dout + r * DH + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bi = r / h;  // b * sq + i
    const int head = static_cast<int>(r % h);
    const long long b = bi / sq, i = bi % sq;
    dsum[(b * h + head) * sq + i] = acc;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
         int kvh, int causal, int window, float scale) {
  constexpr int KP = DH + 1;
  constexpr int DPT = DH / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][KP]
  float* Vs = Ks + BK * KP;      // [BK][KP]
  float* Qs = Vs + BK * KP;      // [BQ][KP]
  float* dOs = Qs + BQ * KP;     // [BQ][KP]
  float* Ps = dOs + BQ * KP;     // [BQ][PP]
  float* dSs = Ps + BQ * PP;     // [BQ][PP]
  float* Ls = dSs + BQ * PP;     // [BQ]
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int k0 = blockIdx.x * BK, g = blockIdx.y, b = blockIdx.z;
  const int rep = h / kvh, q_off = sk - sq;
  const long long q_rs = static_cast<long long>(h) * DH;
  const long long kv_rs = static_cast<long long>(kvh) * DH;
  const T* kb = k + (static_cast<long long>(b) * sk) * kv_rs + g * DH;
  const T* vb = v + (static_cast<long long>(b) * sk) * kv_rs + g * DH;
  load_tile<T, DH>(Ks, kb, k0, sk, kv_rs);
  load_tile<T, DH>(Vs, vb, k0, sk, kv_rs);

  // query rows [i_lo, i_hi) that see some key of [k0, min(k0 + BK, sk))
  const int k_last = min(k0 + BK, sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_off) : 0;
  const int i_hi = window ? min(sq, k_last + window - q_off) : sq;

  float acc_v[RPT][DPT], acc_k[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_v[i][j] = acc_k[i][j] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int head = g * rep + hh;
    const long long qh = (static_cast<long long>(b) * sq) * q_rs + head * DH;
    const float* lrow = lse + (static_cast<long long>(b) * h + head) * sq;
    const float* drow = dsum + (static_cast<long long>(b) * h + head) * sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P, dS are used
      load_tile<T, DH>(Qs, q + qh, q0, sq, q_rs);
      load_tile<T, DH>(dOs, dout + qh, q0, sq, q_rs);
      if (tid < BQ) {
        const bool in = q0 + tid < sq;
        Ls[tid] = in ? lrow[q0 + tid] : 0.f;
        Ds[tid] = in ? drow[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[RPT][CPT], dp[RPT][CPT];
      tile_dot<DH>(s, Qs, Ks);
      tile_dot<DH>(dp, dOs, Vs);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
        const int qpos = q_off + q0 + r;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + TX * j;
          const int kpos = k0 + c;
          const bool ok = q0 + r < sq && kpos < sk &&
                          visible(qpos, kpos, causal, window);
          const float p = ok ? expf(fmaf(s[i][j], scale, -Ls[r])) : 0.f;
          Ps[r * PP + c] = p;
          dSs[r * PP + c] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();
      // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RPT], sv[RPT], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[r * PP + ty + TY * i];
          sv[i] = dSs[r * PP + ty + TY * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          ov[j] = dOs[r * KP + tx + TX * j];
          qv[j] = Qs[r * KP + tx + TX * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= sk) continue;
    const long long off =
        (static_cast<long long>(b) * sk + key) * kv_rs + g * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      st(dv + off + tx + TX * j, acc_v[i][j]);
      st(dk + off + tx + TX * j, acc_k[i][j] * scale);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dsum,
       T* __restrict__ dq, int sq, int sk, int h, int kvh, int causal,
       int window, float scale) {
  constexpr int KP = DH + 1;
  constexpr int DPT = DH / TX;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][KP]
  float* dOs = Qs + BQ * KP;     // [BQ][KP]
  float* Ks = dOs + BQ * KP;     // [BK][KP]
  float* Vs = Ks + BK * KP;      // [BK][KP]
  float* dSs = Vs + BK * KP;     // [BQ][PP]
  float* Ls = dSs + 2 * BQ * PP; // [BQ] (the layout of bwd_dkdv)
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int rep = h / kvh, g = head / rep, q_off = sk - sq;
  const long long q_rs = static_cast<long long>(h) * DH;
  const long long kv_rs = static_cast<long long>(kvh) * DH;
  const long long qh = (static_cast<long long>(b) * sq) * q_rs + head * DH;
  const T* kb = k + (static_cast<long long>(b) * sk) * kv_rs + g * DH;
  const T* vb = v + (static_cast<long long>(b) * sk) * kv_rs + g * DH;
  load_tile<T, DH>(Qs, q + qh, q0, sq, q_rs);
  load_tile<T, DH>(dOs, dout + qh, q0, sq, q_rs);
  if (tid < BQ) {
    const bool in = q0 + tid < sq;
    const long long row = (static_cast<long long>(b) * h + head) * sq;
    Ls[tid] = in ? lse[row + q0 + tid] : 0.f;
    Ds[tid] = in ? dsum[row + q0 + tid] : 0.f;
  }

  // keys that some row of this tile can see: [k_begin, k_end)
  const int pos_lo = q_off + q0;
  const int pos_hi = q_off + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window ? (max(0, pos_lo - window + 1) / BK) * BK : 0;

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q, dO staged; the previous tile's K, V, dS used
    load_tile<T, DH>(Ks, kb, k0, sk, kv_rs);
    load_tile<T, DH>(Vs, vb, k0, sk, kv_rs);
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<DH>(s, Qs, Ks);
    tile_dot<DH>(dp, dOs, Vs);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
      const int qpos = pos_lo + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + TX * j;
        const int kpos = k0 + c;
        const bool ok = q0 + r < sq && kpos < k_end &&
                        visible(qpos, kpos, causal, window);
        const float p = ok ? expf(fmaf(s[i][j], scale, -Ls[r])) : 0.f;
        dSs[r * PP + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = dSs[(ty + TY * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = Ks[c * KP + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= sq) continue;
    T* out = dq + (static_cast<long long>(b) * sq + row) * q_rs + head * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) st(out + tx + TX * j, acc[i][j] * scale);
  }
}

// ---- bf16: the products on the tensor cores (mma.sync m16n8k16) -----------
// Same split and loops as the CUDA-core kernels above, 128 threads a block:
// each of the 4 warps owns 16 rows of the block's 64 (keys in bwd_dkdv_mma,
// queries in bwd_dq_mma) and holds its accumulators as mma fragments.  Tiles
// are bf16 in shared memory, rows padded by 16 bytes so that ldmatrix's 8
// rows fall in distinct banks, and filled by cp.async (rows past the end
// zero).  S and dP stay f32 in registers; P and dS are rounded to bf16 as
// the A operands of the next products, whose sums stay f32.
template <int DH>
struct MmaSmem {
  static constexpr int DP = DH + 8;  // padded row, bf16 elements
  static constexpr size_t bytes =
      4 * size_t(64) * DP * sizeof(bf16) + 2 * 64 * sizeof(float);
};

// rows [r0, r0 + 64) of a (.., heads, DH) bf16 tensor (row stride rs
// elements) into a [64][DH + 8] tile, zero past n; one cp.async group
template <int DH>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int r0, int n, long long rs) {
  constexpr int DP = DH + 8, CH = DH / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < 64 * CH; e += 128) {
    const int r = e / CH, c = e % CH;
    const bool in = r0 + r < n;
    hopper::cp_async_16_or_zero(dst + r * DP + c * 8,
                                in ? src + (r0 + r) * rs + c * 8 : src, in);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (16 rows x 64 columns, 8 n-tiles) += A rows [r0, r0 + 16) of a
// [64][DP] tile times the transpose of all 64 rows of B, over DH
template <int DH>
__device__ __forceinline__ void mma_rows_by_rows_t(float (&acc)[8][4],
                                                   const bf16* A, int r0,
                                                   const bf16* B) {
  constexpr int DP = DH + 8;
  const int lane = threadIdx.x % 32, i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    hopper::ldmatrix_x4(a, A + (r0 + lane % 16) * DP + kk * 16 +
                               (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      hopper::ldmatrix_x4(bb, B + (np * 16 + r + (i / 2) * 8) * DP +
                                  kk * 16 + (i % 2) * 8);
      hopper::mma_16816(acc[2 * np], a, bb[0], bb[1]);
      hopper::mma_16816(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 rows x DH) += A (16 x 64, four k-steps of bf16 fragments) times
// the [64][DP] tile B (64 rows by DH columns)
template <int DH>
__device__ __forceinline__ void mma_frags_by_tile(float (&acc)[DH / 8][4],
                                                  const uint32_t (&a)[4][4],
                                                  const bf16* B) {
  constexpr int DP = DH + 8;
  const int lane = threadIdx.x % 32, i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bb[4];
      hopper::ldmatrix_x4_trans(bb, B + (kq * 16 + r + (i % 2) * 8) * DP +
                                        np * 16 + (i / 2) * 8);
      hopper::mma_16816(acc[2 * np], a[kq], bb[0], bb[1]);
      hopper::mma_16816(acc[2 * np + 1], a[kq], bb[2], bb[3]);
    }
}

// the 16 x 64 f32 fragments of acc as four k-steps of bf16 A fragments
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&acc)[8][4]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    a[kq][0] = pack_bf16(acc[2 * kq][0], acc[2 * kq][1]);
    a[kq][1] = pack_bf16(acc[2 * kq][2], acc[2 * kq][3]);
    a[kq][2] = pack_bf16(acc[2 * kq + 1][0], acc[2 * kq + 1][1]);
    a[kq][3] = pack_bf16(acc[2 * kq + 1][2], acc[2 * kq + 1][3]);
  }
}

// this warp's 16 rows of a (16 x DH) accumulator, times `mul`, as bf16 into
// rows row0 + [0, 16) of a (.., heads, DH) tensor (row stride rs), rows past
// n left out
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, int row0, int n,
                                           long long rs,
                                           const float (&acc)[DH / 8][4],
                                           float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + row * rs + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(128)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
             int h, int kvh, int causal, int window, float scale) {
  constexpr int DP = DH + 8, NT = DH / 8;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + 64 * DP;
  bf16* Qs = Vs + 64 * DP;
  bf16* dOs = Qs + 64 * DP;
  float* Ls = reinterpret_cast<float*>(dOs + 64 * DP);  // lse, log2 units
  float* Ds = Ls + 64;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, kr = 16 * warp;
  const int k0 = blockIdx.x * BK, grp = blockIdx.y, b = blockIdx.z;
  const int rep = h / kvh, q_off = sk - sq;
  const float scale_log2 = scale * LOG2E;
  const long long q_rs = static_cast<long long>(h) * DH;
  const long long kv_rs = static_cast<long long>(kvh) * DH;
  const long long kvb = static_cast<long long>(b) * sk * kv_rs + grp * DH;
  load_tile_async<DH>(Ks, k + kvb, k0, sk, kv_rs);
  load_tile_async<DH>(Vs, v + kvb, k0, sk, kv_rs);
  hopper::cp_async_commit();

  const int k_last = min(k0 + BK, sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_off) : 0;
  const int i_hi = window ? min(sq, k_last + window - q_off) : sq;

  float acc_v[NT][4], acc_k[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = acc_k[n][e] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int head = grp * rep + hh;
    const long long qh = static_cast<long long>(b) * sq * q_rs + head * DH;
    const float* lrow = lse + (static_cast<long long>(b) * h + head) * sq;
    const float* drow = dsum + (static_cast<long long>(b) * h + head) * sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's Q and dO are read
      load_tile_async<DH>(Qs, q + qh, q0, sq, q_rs);
      load_tile_async<DH>(dOs, dout + qh, q0, sq, q_rs);
      hopper::cp_async_commit();
      if (tid < BQ) {
        const bool in = q0 + tid < sq;
        Ls[tid] = in ? lrow[q0 + tid] * LOG2E : 0.f;
        Ds[tid] = in ? drow[q0 + tid] : 0.f;
      }
      hopper::cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys, 64 queries
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_rows_by_rows_t<DH>(st, Ks, kr, Qs);
      mma_rows_by_rows_t<DH>(dpt, Vs, kr, dOs);
      // fragment element (n, e): key kr + g + 8 (e / 2), query 8 n + 2 t + e % 2
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + e % 2;
          const int kpos = k0 + kr + g + 8 * (e / 2);
          const bool ok = q0 + qi < sq && kpos < sk &&
                          visible(q_off + q0 + qi, kpos, causal, window);
          const float p =
              ok ? exp2f(fmaf(st[n][e], scale_log2, -Ls[qi])) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - Ds[qi]);
        }
      uint32_t ap[4][4], as[4][4];
      to_a_frags(ap, st);
      to_a_frags(as, dpt);
      // dV += P^T dO, dK += dS^T Q
      mma_frags_by_tile<DH>(acc_v, ap, dOs);
      mma_frags_by_tile<DH>(acc_k, as, Qs);
    }
  }
  hopper::cp_async_wait<0>();
  store_rows<DH>(dv + kvb, k0 + kr, sk, kv_rs, acc_v, 1.f);
  store_rows<DH>(dk + kvb, k0 + kr, sk, kv_rs, acc_k, scale);
}

template <int DH>
__global__ void __launch_bounds__(128)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dsum,
           bf16* __restrict__ dq, int sq, int sk, int h, int kvh,
           int causal, int window, float scale) {
  constexpr int DP = DH + 8, NT = DH / 8;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + 64 * DP;
  bf16* Ks = dOs + 64 * DP;
  bf16* Vs = Ks + 64 * DP;
  float* Ls = reinterpret_cast<float*>(Vs + 64 * DP);  // lse, log2 units
  float* Ds = Ls + 64;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, qr = 16 * warp;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int rep = h / kvh, grp = head / rep, q_off = sk - sq;
  const float scale_log2 = scale * LOG2E;
  const long long q_rs = static_cast<long long>(h) * DH;
  const long long kv_rs = static_cast<long long>(kvh) * DH;
  const long long qh = static_cast<long long>(b) * sq * q_rs + head * DH;
  const long long kvb = static_cast<long long>(b) * sk * kv_rs + grp * DH;
  load_tile_async<DH>(Qs, q + qh, q0, sq, q_rs);
  load_tile_async<DH>(dOs, dout + qh, q0, sq, q_rs);
  hopper::cp_async_commit();
  if (tid < BQ) {
    const bool in = q0 + tid < sq;
    const long long row = (static_cast<long long>(b) * h + head) * sq;
    Ls[tid] = in ? lse[row + q0 + tid] * LOG2E : 0.f;
    Ds[tid] = in ? dsum[row + q0 + tid] : 0.f;
  }

  const int pos_lo = q_off + q0;
  const int pos_hi = q_off + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window ? (max(0, pos_lo - window + 1) / BK) * BK : 0;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K and V are read
    load_tile_async<DH>(Ks, k + kvb, k0, sk, kv_rs);
    load_tile_async<DH>(Vs, v + kvb, k0, sk, kv_rs);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows_by_rows_t<DH>(s, Qs, qr, Ks);
    mma_rows_by_rows_t<DH>(dp, dOs, qr, Vs);
    // fragment element (n, e): query qr + g + 8 (e / 2), key 8 n + 2 t + e % 2
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qr + g + 8 * (e / 2);
        const int kpos = k0 + 8 * n + 2 * t + e % 2;
        const bool ok = q0 + qi < sq && kpos < k_end &&
                        visible(pos_lo + qi, kpos, causal, window);
        const float p = ok ? exp2f(fmaf(s[n][e], scale_log2, -Ls[qi])) : 0.f;
        dp[n][e] = p * (dp[n][e] - Ds[qi]);
      }
    uint32_t as[4][4];
    to_a_frags(as, dp);
    mma_frags_by_tile<DH>(acc, as, Ks);  // dQ += dS K
  }
  hopper::cp_async_wait<0>();
  store_rows<DH>(dq + qh, q0 + qr, sq, q_rs, acc, scale);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dsum, void* dq,
               void* dk, void* dv, int batch, int sq, int sk, int h, int kvh,
               int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = MmaSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        bwd_dq_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dst = static_cast<float*>(dsum);
  const long long rows = static_cast<long long>(batch) * sq * h;
  if (rows > 0) {
    bwd_dsum<bf16, DH><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                         stream>>>(static_cast<const bf16*>(o), dot, dst,
                                   rows, sq, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sk > 0) {
    const dim3 grid((sk + BK - 1) / BK, kvh, batch);
    bwd_dkdv_mma<DH><<<grid, 128, smem, stream>>>(
        qt, kt, vt, dot, lt, dst, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sq, sk, h, kvh, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sq > 0) {
    const dim3 grid((sq + BQ - 1) / BQ, h, batch);
    bwd_dq_mma<DH><<<grid, 128, smem, stream>>>(
        qt, kt, vt, dot, lt, dst, static_cast<bf16*>(dq), sq, sk, h, kvh,
        causal, window, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int batch, int sq, int sk, int h, int kvh, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        bwd_dq<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dst = static_cast<float*>(dsum);
  const long long rows = static_cast<long long>(batch) * sq * h;
  if (rows > 0) {
    bwd_dsum<T, DH><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                      stream>>>(static_cast<const T*>(o), dot, dst, rows, sq,
                                h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sk > 0) {
    const dim3 grid((sk + BK - 1) / BK, kvh, batch);
    bwd_dkdv<T, DH><<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, dot, lt, dst, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, sk, h, kvh, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sq > 0) {
    const dim3 grid((sq + BQ - 1) / BQ, h, batch);
    bwd_dq<T, DH><<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, dot, lt, dst, static_cast<T*>(dq), sq, sk, h, kvh,
        causal, window, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dsum, void* dq,
             void* dk, void* dv, int batch, int sq, int sk, int h, int kvh,
             int dh, int causal, int window, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || h % kvh != 0 || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if constexpr (sizeof(T) == 2) {  // bf16: the tensor-core kernels
    if (dh == 64)
      return launch_mma<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                            sq, sk, h, kvh, causal, window, scale, st);
    return launch_mma<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                           sq, sk, h, kvh, causal, window, scale, st);
  } else {
    if (dh == 64)
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                           sq, sk, h, kvh, causal, window, scale, st);
    return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch, sq,
                          sk, h, kvh, causal, window, scale, st);
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, dh) and k, v, dk, dv (B, Sk, KV, dh):
// contiguous; lse and dsum (B, H, Sq) f32, dsum scratch the kernel fills.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dsum, void* dq, void* dk, void* dv,
                            int batch, int sq, int sk, int h, int kvh, int dh,
                            int causal, int window, float scale,
                            void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch, sq,
                         sk, h, kvh, dh, causal, window, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dsum, void* dq, void* dk, void* dv,
                             int batch, int sq, int sk, int h, int kvh,
                             int dh, int causal, int window, float scale,
                             void* stream) {
  return dispatch<bf16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch, sq,
                        sk, h, kvh, dh, causal, window, scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
