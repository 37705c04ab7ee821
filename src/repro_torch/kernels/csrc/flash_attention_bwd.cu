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
// sums, on f32 or bf16 inputs, at (q/k width, v width) = (dqk, dv) of
// (64, 64), (128, 128) and (96, 64): the last is MLA's cacheless branch
// (MiniCPM3's training; scale dqk^-0.5).  dQ and dK are dqk wide, dV, O
// and dO dv wide.
//
// The forward kernel writes each row's log-sum-exp L (natural log, f32,
// (B, H, Sq); -inf for a row that sees no key) when it is given a pointer
// for it.  With P = exp(S scale - L) recomputed from Q and K:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dO o O),
//   dQ = dS K scale,  dK = dS^T Q scale.
// A row that sees no key has P = 0 and so no gradient.
//
// Bound.  Five products of the visible (query, key) pairs (S, dK, dQ by
// dqk; dP, dV by dv): 2 (3 dqk + 2 dv) FLOP a pair, 10 dh at dqk = dv = dh,
// 2.5 times the forward's 4 dh (832 against 320 at (96, 64)).  At the training
// shape (B 8, S 2048, H 16, dh 64, causal: 2.686e8 visible pairs over the
// batch and heads) that is 1.72e11 FLOP, 0.174 ms at the tensor cores'
// 989 TFLOP/s, against ~67 MB of bf16 inputs and outputs (0.02 ms at
// 3.35 TB/s): the operations bound it, at the tensor cores' rate in bf16
// and the CUDA cores' in f32.  The split below recomputes S and dP in its
// second pass: 7 products a pair, whose floor there is 0.243 ms, and two
// exponentials a pair, whose floor on the special-function units (16 ex2
// a clock on each of 132 SMs) is 0.128 ms (0.064 for one a pair).
//
// Three launches, FA2's split, so that no sum needs atomics and two calls
// give the same bits (restarts reproduce):
//   1. D = rowsum(dO o O) in f32 (`bwd_dsum_bf16`: 16-byte loads, dh / 8
//      lanes a row; `bwd_dsum`: one warp a row).
//   2. dK, dV: one block per (key tile of 64, kv head, batch row).  K and V
//      stay in shared memory; the block walks the group's rep query heads
//      and, for each, the query tiles of 64 rows that see some key of the
//      tile (the causal and window band; tiles outside it are never read),
//      recomputes S and dP, and accumulates dV and dK in registers.  The
//      GQA sum over the group is this loop, in a fixed order.
//   3. dQ: one block per (query tile of 64, head, batch row), walking the
//      key tiles the forward walks, dQ accumulated in registers.
// Under the causal mask the tiles with the most work start first: the
// bf16 grids put the tile index slowest (key tiles ascending, query tiles
// descending), so every head's heavy tiles are in the first wave.
//
// bf16 (`bwd_dkdv_wgmma`, `bwd_dq_wgmma`): `wgmma` on TMA-fed tiles, the
// forward's shape (flash_attention.cu, `flash_fwd_wgmma`).  A block is one
// consumer warpgroup, which owns the block's 64 keys (dK/dV) or 64 queries
// (dQ) as the `wgmma` M, and one producer warp; two blocks share an SM at
// dh 64, so that one's exponentials run under the other's products (two
// consumer warpgroups in one block, sharing the ring, measured slower:
// they reach their exponentials together).  The producer's first lane
// issues TMA loads of 128-byte swizzled panels of 64 columns: in the dK/dV
// kernel K and V once, then Q and dO of each step through a ring of
// stages (3 at dh 64 and at (96, 64), 2 at 128, where 3 would leave one
// block an SM); in
// the dQ kernel Q and dO once, then K and V of each key tile through the
// ring.  Each stage has a full and an empty mbarrier.  Every lane of the
// producer also copies the step's rows of L (times log2 e) and D into the
// stage (a TMA box of them would start off 16 bytes wherever Sq is not a
// multiple of 4), and arrives on the full barrier after.
//   dK/dV, per step of 64 queries: S^T = K Q^T and dP^T = V dO^T by
// `wgmma_ss` (A the K or V tile, B the Q or dO tile, both K-major), so
// that in the accumulator fragment rows are keys and columns queries: L
// and D are a column's.  P^T = 2^(S^T scale log2 e - L) runs while dP^T
// is in the tensor cores; then dS^T = P^T o (dP^T - D), and both go to
// bf16 A fragments in registers, P^T and dS^T never touching shared
// memory; dV += P^T dO and dK += dS^T Q by `wgmma_rs`, dO and Q read
// N-major (the transpose bit) from the same swizzled panels, as the
// forward reads V for P V.  Forming dS before either rs product issues
// keeps the kernel within the 168 registers of two blocks an SM at dh 64
// with no spill (issuing dV's product first, to overlap dS, spills there
// and serialises the wgmma, C7512).  232 registers at dh 128: one block.
// At (96, 64) dK's 64 x 96 and dV's 64 x 64 accumulators sit between: its
// launch bounds ask for one block an SM, and at the 184 registers ptxas
// gives it two still fit (58,880 registers and 2 x 100 KB of shared
// memory).  A 96-wide Q or K tile is two
// panels, the second holding columns 64-95 and 32 columns of TMA's zeros:
// the products that contract over dqk run 6 slices of 16, and dK += dS^T Q
// and dQ += dS K are `wgmma m64n96k16`, reading Q or K N-major over one
// and a half panels.
//   dQ, per key tile of 64: S = Q K^T and dP = dO V^T by `wgmma_ss`, P
// while dP runs, dS = P o (dP - D) to bf16 A fragments, dQ += dS K by
// `wgmma_rs` with K read N-major.  128 registers at dh 64, 160 at 128:
// two blocks an SM.
//   Only the steps and tiles that cross the diagonal, a window edge or the
// end of Sq or Sk take the mask.  Rows past Sq or Sk arrive as TMA's
// zeros; the dK/dV kernel masks them (they would add to every key's sum),
// the dQ kernel leaves its rows past Sq unmasked and unstored.
// Exponentials are `ex2.approx.ftz` (within 2 ulps; a result below
// 2^-126 flushes to 0).  The roundings beyond the plain version's are P
// and dS to bf16 before their products.  `attention_bwd_tiles`
// (kernels/flash_attention/ref.py) models this arithmetic on the CPU.
// TMA needs 16-byte aligned bases; the wrapper copies any input that is
// not.  The tensor maps are encoded per call (`hopper::encode_rows_map`).
//
// f32 (`bwd_dkdv`, `bwd_dq`): the CUDA cores, as the f32 forward kernel:
// the tensor cores' f32 route is TF32 (about 3 decimal digits), which the
// f32 checks (1e-4 of each output's largest magnitude against the plain
// version, and the training gradient check) could not hold; f32 runs
// only in those checks.  Tiles of 64 x 64 scores, each thread 4 x 4 of
// them and 4 rows x dh/16 columns of its accumulators, rows padded by one
// float in shared memory so that neighbouring threads hit neighbouring
// banks.
//
// Inputs are contiguous (B, S, heads, width) tensors (the wrapper makes
// them so); dQ, dK, dV are written in the input type.
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, do not synchronise, and return the first cudaGetLastError() that
// is not cudaSuccess (or TMAP_ERROR + the CUresult if a tensor map cannot
// be encoded).

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

// q, k rows DQK wide; v, o, dO rows DV wide
template <int DQK, int DV>
struct Smem {
  static constexpr int KPQ = DQK + 1;  // padded row of Q, K
  static constexpr int KPV = DV + 1;   // padded row of dO, V
  // two [64][KPQ] and two [64][KPV] tiles, two [64][PP] tiles, two [64] row
  // vectors
  static constexpr size_t bytes =
      (2 * size_t(64) * (KPQ + KPV) + 2 * size_t(64) * PP + 2 * 64) *
      sizeof(float);
};

// `rows` rows of a (.., heads, D) tensor starting at row r0 (row stride
// `rs` elements), zero past `n`, into a [64][D + 1] f32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, long long rs) {
  constexpr int KP = D + 1;
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
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

// s[i][j] = A[ty + TY i] . B[tx + TX j] over D, A and B [64][D + 1] tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[RPT][CPT],
                                         const float* A, const float* B) {
  constexpr int KP = D + 1;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
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

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d] over the DV-wide rows;
// one warp a row
template <typename T, int DV>
__global__ void __launch_bounds__(256)
bwd_dsum(const T* __restrict__ o, const T* __restrict__ dout,
         float* __restrict__ dsum, long long rows, int sq, int h) {
  const long long r = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < DV; c += 32)
    acc = fmaf(ld(o + r * DV + c), ld(dout + r * DV + c), acc);
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

// the same for bf16 rows, 16-byte loads: DV / 8 lanes a row
template <int DV>
__global__ void __launch_bounds__(256)
bwd_dsum_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dout,
              float* __restrict__ dsum, long long rows, int sq, int h) {
  constexpr int LANES = DV / 8;
  const long long r = (blockIdx.x * 256LL + threadIdx.x) / LANES;
  const int j = threadIdx.x % LANES;
  float acc = 0.f;
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + r * DV + 8 * j);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + r * DV + 8 * j);
    const bf16* x = reinterpret_cast<const bf16*>(&a);
    const bf16* y = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc = fmaf(__bfloat162float(x[e]), __bfloat162float(y[e]), acc);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && j == 0) {
    const long long bi = r / h;  // b * sq + i
    const int head = static_cast<int>(r % h);
    const long long b = bi / sq, i = bi % sq;
    dsum[(b * h + head) * sq + i] = acc;
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
         int kvh, int causal, int window, float scale) {
  constexpr int KPQ = DQK + 1, KPV = DV + 1;
  constexpr int DPQ = DQK / TX;  // dK columns per thread
  constexpr int DPV = DV / TX;   // dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][KPQ]
  float* Vs = Ks + BK * KPQ;     // [BK][KPV]
  float* Qs = Vs + BK * KPV;     // [BQ][KPQ]
  float* dOs = Qs + BQ * KPQ;    // [BQ][KPV]
  float* Ps = dOs + BQ * KPV;    // [BQ][PP]
  float* dSs = Ps + BQ * PP;     // [BQ][PP]
  float* Ls = dSs + BQ * PP;     // [BQ]
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int k0 = blockIdx.x * BK, g = blockIdx.y, b = blockIdx.z;
  const int rep = h / kvh, q_off = sk - sq;
  const long long q_rs = static_cast<long long>(h) * DQK;
  const long long o_rs = static_cast<long long>(h) * DV;
  const long long k_rs = static_cast<long long>(kvh) * DQK;
  const long long v_rs = static_cast<long long>(kvh) * DV;
  const T* kb = k + (static_cast<long long>(b) * sk) * k_rs + g * DQK;
  const T* vb = v + (static_cast<long long>(b) * sk) * v_rs + g * DV;
  load_tile<T, DQK>(Ks, kb, k0, sk, k_rs);
  load_tile<T, DV>(Vs, vb, k0, sk, v_rs);

  // query rows [i_lo, i_hi) that see some key of [k0, min(k0 + BK, sk))
  const int k_last = min(k0 + BK, sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_off) : 0;
  const int i_hi = window ? min(sq, k_last + window - q_off) : sq;

  float acc_v[RPT][DPV], acc_k[RPT][DPQ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < DPV; ++j) acc_v[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DPQ; ++j) acc_k[i][j] = 0.f;
  }

  for (int hh = 0; hh < rep; ++hh) {
    const int head = g * rep + hh;
    const long long qh = (static_cast<long long>(b) * sq) * q_rs + head * DQK;
    const long long oh = (static_cast<long long>(b) * sq) * o_rs + head * DV;
    const float* lrow = lse + (static_cast<long long>(b) * h + head) * sq;
    const float* drow = dsum + (static_cast<long long>(b) * h + head) * sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P, dS are used
      load_tile<T, DQK>(Qs, q + qh, q0, sq, q_rs);
      load_tile<T, DV>(dOs, dout + oh, q0, sq, o_rs);
      if (tid < BQ) {
        const bool in = q0 + tid < sq;
        Ls[tid] = in ? lrow[q0 + tid] : 0.f;
        Ds[tid] = in ? drow[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[RPT][CPT], dp[RPT][CPT];
      tile_dot<DQK>(s, Qs, Ks);
      tile_dot<DV>(dp, dOs, Vs);
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
        float pv[RPT], sv[RPT], ov[DPV], qv[DPQ];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[r * PP + ty + TY * i];
          sv[i] = dSs[r * PP + ty + TY * i];
        }
#pragma unroll
        for (int j = 0; j < DPV; ++j) ov[j] = dOs[r * KPV + tx + TX * j];
#pragma unroll
        for (int j = 0; j < DPQ; ++j) qv[j] = Qs[r * KPQ + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int j = 0; j < DPV; ++j)
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
#pragma unroll
          for (int j = 0; j < DPQ; ++j)
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= sk) continue;
    const long long row = static_cast<long long>(b) * sk + key;
#pragma unroll
    for (int j = 0; j < DPV; ++j)
      st(dv + row * v_rs + g * DV + tx + TX * j, acc_v[i][j]);
#pragma unroll
    for (int j = 0; j < DPQ; ++j)
      st(dk + row * k_rs + g * DQK + tx + TX * j, acc_k[i][j] * scale);
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dsum,
       T* __restrict__ dq, int sq, int sk, int h, int kvh, int causal,
       int window, float scale) {
  constexpr int KPQ = DQK + 1, KPV = DV + 1;
  constexpr int DPT = DQK / TX;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][KPQ]
  float* dOs = Qs + BQ * KPQ;    // [BQ][KPV]
  float* Ks = dOs + BQ * KPV;    // [BK][KPQ]
  float* Vs = Ks + BK * KPQ;     // [BK][KPV]
  float* dSs = Vs + BK * KPV;    // [BQ][PP]
  float* Ls = dSs + 2 * BQ * PP; // [BQ] (the layout of bwd_dkdv)
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int rep = h / kvh, g = head / rep, q_off = sk - sq;
  const long long q_rs = static_cast<long long>(h) * DQK;
  const long long o_rs = static_cast<long long>(h) * DV;
  const long long k_rs = static_cast<long long>(kvh) * DQK;
  const long long v_rs = static_cast<long long>(kvh) * DV;
  const long long qh = (static_cast<long long>(b) * sq) * q_rs + head * DQK;
  const long long oh = (static_cast<long long>(b) * sq) * o_rs + head * DV;
  const T* kb = k + (static_cast<long long>(b) * sk) * k_rs + g * DQK;
  const T* vb = v + (static_cast<long long>(b) * sk) * v_rs + g * DV;
  load_tile<T, DQK>(Qs, q + qh, q0, sq, q_rs);
  load_tile<T, DV>(dOs, dout + oh, q0, sq, o_rs);
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
    load_tile<T, DQK>(Ks, kb, k0, sk, k_rs);
    load_tile<T, DV>(Vs, vb, k0, sk, v_rs);
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<DQK>(s, Qs, Ks);
    tile_dot<DV>(dp, dOs, Vs);
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
      for (int j = 0; j < DPT; ++j) kv[j] = Ks[c * KPQ + tx + TX * j];
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
    T* out = dq + (static_cast<long long>(b) * sq + row) * q_rs + head * DQK;
#pragma unroll
    for (int j = 0; j < DPT; ++j) st(out + tx + TX * j, acc[i][j] * scale);
  }
}

// ---- bf16: wgmma on TMA-fed tiles -------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) hopper::wgmma_ss_n64(d, a, b, scale_d);
  else hopper::wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) hopper::wgmma_rs_n64(d, a, b);
  else if constexpr (N == 96) hopper::wgmma_rs_n96(d, a, b);
  else hopper::wgmma_rs_n128(d, a, b);
}

// acc = A B^T over DH, A's 64 rows and B's N rows both (rows, DH) tiles of
// 128-byte swizzled panels (`a_panel`, `b_panel` bytes apart): 16 columns
// of DH a step, 32 bytes into a panel
template <int N, int DH>
__device__ __forceinline__ void issue_rows_by_rows(float (&acc)[N / 2],
                                                   const uint8_t* a,
                                                   int a_panel,
                                                   const uint8_t* b,
                                                   int b_panel) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<N>(acc,
                hopper::desc_sw128(a + (kk / 4) * a_panel + (kk % 4) * 32, 0),
                hopper::desc_sw128(b + (kk / 4) * b_panel + (kk % 4) * 32, 0),
                kk > 0);
  hopper::wgmma_commit();
}

// acc += F B, F the (64, K) bf16 A fragments in registers, B a (K, DH)
// tile of panels `b_panel` bytes apart, read N-major: 16 rows (2048 bytes)
// a step
template <int K, int DH>
__device__ __forceinline__ void issue_frags_by_tile(float (&acc)[DH / 2],
                                                    uint32_t (&f)[K / 16][4],
                                                    const uint8_t* b,
                                                    int b_panel) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<DH>(acc, f[kk], hopper::desc_sw128(b + kk * 16 * 128, b_panel));
  hopper::wgmma_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// this thread's two rows (r, r + 8) of a (64, N) f32 accumulator, times
// `mul`, as bf16 into rows of a tensor with row stride `rs`; rows past n
// left out
template <int N>
__device__ __forceinline__ void store_acc(bf16* dst, int r, int n,
                                          long long rs,
                                          const float (&acc)[N / 2],
                                          float mul) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    if (r + 8 * hi >= n) continue;
    bf16* row = dst + (r + 8 * hi) * rs;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[4 * j + 2 * hi] * mul, acc[4 * j + 2 * hi + 1] * mul);
  }
}

// dK/dV: a block per (64 keys, kv head, batch row), one consumer warpgroup
// and one producer warp; q and k rows DQK wide, v and dO rows DV wide
template <int DQK, int DV>
struct KvCfg {
  static constexpr int BQ = 64;  // queries a step
  static constexpr int STAGES = DQK == 128 ? 2 : 3;  // steps in the ring
  static constexpr int MIN_BLOCKS = DQK == 64 ? 2 : 1;  // blocks an SM
  // 64-column panels of a Q or K row (a 96-wide row: two, the second
  // half zeros) and of a V or dO row
  static constexpr int NPQK = (DQK + 63) / 64;
  static constexpr int NPV = DV / 64;
  static constexpr int KV_PANEL = 64 * 128;      // bytes: 64 keys x 128 B
  static constexpr int K_BYTES = NPQK * KV_PANEL;
  static constexpr int V_BYTES = NPV * KV_PANEL;
  static constexpr int Q_PANEL = BQ * 128;
  static constexpr int Q_BYTES = NPQK * Q_PANEL;  // Q of one step
  static constexpr int DO_BYTES = NPV * Q_PANEL;  // dO of one step
  // Q, dO, then L and D (f32, BQ each), padded so that the next stage's
  // panels stay 1024-byte aligned
  static constexpr int STAGE_BYTES = Q_BYTES + DO_BYTES + 1024;
  static constexpr int THREADS = 128 + 32;
  static constexpr size_t SMEM = 1024 + size_t(K_BYTES) + V_BYTES +
                                 size_t(STAGES) * STAGE_BYTES +
                                 8 * (1 + 2 * STAGES);
};

template <int DQK, int DV>
__global__ void __launch_bounds__(KvCfg<DQK, DV>::THREADS,
                                  KvCfg<DQK, DV>::MIN_BLOCKS)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
               int h, int kvh, int causal, int window, float scale) {
  using C = KvCfg<DQK, DV>;
  constexpr int BQ = C::BQ, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_k = smem;                       // [NPQK] panels of 64 keys
  uint8_t* s_v = s_k + C::K_BYTES;           // [NPV] panels
  uint8_t* s_ring = s_v + C::V_BYTES;        // [ST] {Q, dO, L, D}
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(s_ring + ST * C::STAGE_BYTES);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  // key tiles slowest in the grid: under the causal mask the first tiles,
  // which the most query rows see, start first on every head
  const int k0 = blockIdx.z * 64, grp = blockIdx.x, b = blockIdx.y;
  const int rep = h / kvh, q_off = sk - sq;
  // query rows [i_lo, i_hi) that see some key of [k0, min(k0 + 64, sk)):
  // the steps walk the group's rep heads and, for each, these rows' tiles
  const int k_last = min(k0 + 64, sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_off) : 0;
  const int i_hi = window ? min(sq, k_last + window - q_off) : sq;
  const int q_first = (i_lo / BQ) * BQ;
  const int nq = i_hi > q_first ? (i_hi - q_first + BQ - 1) / BQ : 0;
  const int n_steps = rep * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      // the TMA's expect_tx and the 32 producer lanes' copies of L and D
      hopper::mbar_init(&full[s], 1 + 32);
      hopper::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: its first lane issues the loads
    if (n_steps == 0) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, C::K_BYTES + C::V_BYTES);
      for (int p = 0; p < C::NPQK; ++p)
        hopper::tma_load_4d(s_k + p * C::KV_PANEL, &kmap, kv_full, p * 64,
                            grp, k0, b);
      for (int p = 0; p < C::NPV; ++p)
        hopper::tma_load_4d(s_v + p * C::KV_PANEL, &vmap, kv_full, p * 64,
                            grp, k0, b);
    }
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % ST;
      const int head = grp * rep + t / nq, q0 = q_first + (t % nq) * BQ;
      uint8_t* st = s_ring + s * C::STAGE_BYTES;
      hopper::mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], C::Q_BYTES + C::DO_BYTES);
        for (int p = 0; p < C::NPQK; ++p)
          hopper::tma_load_4d(st + p * C::Q_PANEL, &qmap, &full[s], p * 64,
                              head, q0, b);
        for (int p = 0; p < C::NPV; ++p)
          hopper::tma_load_4d(st + C::Q_BYTES + p * C::Q_PANEL, &domap,
                              &full[s], p * 64, head, q0, b);
      }
      // every lane copies rows of L (in log2 units) and D, 0 past Sq (a
      // TMA box of them would start off 16 bytes wherever Sq is not a
      // multiple of 4)
      float* ls = reinterpret_cast<float*>(st + C::Q_BYTES + C::DO_BYTES);
      const long long row = (static_cast<long long>(b) * h + head) * sq + q0;
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < sq;
        ls[i] = in ? lse[row + i] * LOG2E : 0.f;
        ls[BQ + i] = in ? dsum[row + i] : 0.f;
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroup: 64 keys; this thread holds keys kr, kr + 8.
  // In S^T and dP^T (keys x queries) its element i sits at key
  // kr + 8 ((i / 2) % 2) and query 8 (i / 4) + 2 t4 + i % 2 of the step
  const int t4 = lane % 4, kr = 16 * warp + lane / 4;
  const float sl2 = scale * LOG2E;
  float dva[DV / 2], dka[DQK / 2], sa[BQ / 2], dpa[BQ / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sa[i] = dpa[i] = 0.f;

  if (n_steps > 0) hopper::mbar_wait(kv_full, 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = t % ST, q0 = q_first + (t % nq) * BQ;
    hopper::mbar_wait(&full[s], (t / ST) & 1);
    const uint8_t* qs = s_ring + s * C::STAGE_BYTES;
    const uint8_t* dos = qs + C::Q_BYTES;
    const float* ls =
        reinterpret_cast<const float*>(dos + C::DO_BYTES);
    const float* ds = ls + BQ;
    // S^T = K Q^T, then dP^T = V dO^T
    hopper::wgmma_fence();
    issue_rows_by_rows<BQ, DQK>(sa, s_k, C::KV_PANEL, qs, C::Q_PANEL);
    issue_rows_by_rows<BQ, DV>(dpa, s_v, C::KV_PANEL, dos, C::Q_PANEL);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sa);

    // P^T = 2^(S^T scale log2 e - L), L a column's, while dP^T runs; the
    // mask only on steps that cross the diagonal, a window edge, Sk or Sq
    // (rows past Sq arrive as zeros, L and D as zeros: masked here)
    const bool edge = k0 + 64 > sk || q0 + BQ > sq ||
                      (causal && k0 + 63 > q_off + q0) ||
                      (window && k0 <= q_off + q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const int c = 8 * (i / 4) + 2 * t4;
      const float2 l = *reinterpret_cast<const float2*>(ls + c);
      float p0 = ex2(fmaf(sa[i], sl2, -l.x));
      float p1 = ex2(fmaf(sa[i + 1], sl2, -l.y));
      if (edge) {
        const int key = k0 + kr + 8 * ((i / 2) % 2);
        const int qp = q_off + q0 + c;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = key < sk && q0 + c + e < sq;
          if (causal) ok = ok && key <= qp + e;
          if (window) ok = ok && key > qp + e - window;
          if (!ok) (e ? p1 : p0) = 0.f;
        }
      }
      sa[i] = p0;
      sa[i + 1] = p1;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpa);
    // dS^T = P^T o (dP^T - D), D a column's; P^T and dS^T to bf16 A
    // fragments, S^T's and dP^T's registers freed as they go
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const float2 d =
          *reinterpret_cast<const float2*>(ds + 8 * (i / 4) + 2 * t4);
      pa[i / 8][(i % 8) / 2] = pack_bf16(sa[i], sa[i + 1]);
      da[i / 8][(i % 8) / 2] =
          pack_bf16(sa[i] * (dpa[i] - d.x), sa[i + 1] * (dpa[i + 1] - d.y));
    }
    // dV += P^T dO and dK += dS^T Q, dO and Q read N-major
    hopper::wgmma_fence();
    issue_frags_by_tile<BQ, DV>(dva, pa, dos, C::Q_PANEL);
    issue_frags_by_tile<BQ, DQK>(dka, da, qs, C::Q_PANEL);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done
  }

  const long long row0 = static_cast<long long>(b) * sk + k0;
  const long long k_rs = static_cast<long long>(kvh) * DQK;
  const long long v_rs = static_cast<long long>(kvh) * DV;
  store_acc<DV>(dv + row0 * v_rs + grp * DV, kr, sk - k0, v_rs, dva, 1.f);
  store_acc<DQK>(dk + row0 * k_rs + grp * DQK, kr, sk - k0, k_rs, dka,
                 scale);
}

// dQ: a block per (64 queries, head, batch row), the forward's shape
template <int DQK, int DV>
struct QCfg {
  static constexpr int BK = 64;  // keys a step
  static constexpr int STAGES = DQK == 128 ? 2 : 3;  // key tiles in the ring
  static constexpr int MIN_BLOCKS = 2;  // blocks an SM
  static constexpr int NPQK = (DQK + 63) / 64;
  static constexpr int NPV = DV / 64;
  static constexpr int Q_PANEL = 64 * 128;
  static constexpr int Q_BYTES = NPQK * Q_PANEL;   // Q
  static constexpr int DO_BYTES = NPV * Q_PANEL;   // dO
  static constexpr int KV_PANEL = BK * 128;
  static constexpr int K_BYTES = NPQK * KV_PANEL;  // K of one step
  static constexpr int V_BYTES = NPV * KV_PANEL;   // V of one step
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int THREADS = 128 + 32;
  static constexpr size_t SMEM = 1024 + size_t(Q_BYTES) + DO_BYTES +
                                 size_t(STAGES) * STAGE_BYTES +
                                 8 * (1 + 2 * STAGES);
};

template <int DQK, int DV>
__global__ void __launch_bounds__(QCfg<DQK, DV>::THREADS,
                                  QCfg<DQK, DV>::MIN_BLOCKS)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dq, int sq, int sk, int h, int kvh,
             int causal, int window, float scale) {
  using C = QCfg<DQK, DV>;
  constexpr int BK = C::BK, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_q = smem;                       // [NPQK] panels of 64 rows
  uint8_t* s_do = s_q + C::Q_BYTES;          // [NPV] panels
  uint8_t* s_kv = s_do + C::DO_BYTES;        // [ST] {K, V} panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_kv + ST * C::STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  // query tiles slowest in the grid, the most keys first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = qt * 64, grp = head / (h / kvh), q_off = sk - sq;
  // keys that some row of this tile can see: [k_begin, k_end)
  const int pos_lo = q_off + q0;
  const int pos_hi = q_off + min(q0 + 64, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window ? (max(0, pos_lo - window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0 && n_tiles > 0) {
      hopper::mbar_expect_tx(q_full, C::Q_BYTES + C::DO_BYTES);
      for (int p = 0; p < C::NPQK; ++p)
        hopper::tma_load_4d(s_q + p * C::Q_PANEL, &qmap, q_full, p * 64,
                            head, q0, b);
      for (int p = 0; p < C::NPV; ++p)
        hopper::tma_load_4d(s_do + p * C::Q_PANEL, &domap, q_full, p * 64,
                            head, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        hopper::mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], C::STAGE_BYTES);
        uint8_t* ks = s_kv + s * C::STAGE_BYTES;
        const int k0 = k_begin + t * BK;
        for (int p = 0; p < C::NPQK; ++p)
          hopper::tma_load_4d(ks + p * C::KV_PANEL, &kmap, &full[s], p * 64,
                              grp, k0, b);
        for (int p = 0; p < C::NPV; ++p)
          hopper::tma_load_4d(ks + C::K_BYTES + p * C::KV_PANEL, &vmap,
                              &full[s], p * 64, grp, k0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: 64 queries; this thread holds rows r0, r0 + 8.
  // Rows past Sq arrive as zeros, take L = D = 0, and are not stored: they
  // touch no other row, so no mask needs them
  const int t4 = lane % 4, r0 = 16 * warp + lane / 4;
  const int qpos0 = pos_lo + r0, qpos1 = qpos0 + 8;
  const float sl2 = scale * LOG2E;
  const long long rows = (static_cast<long long>(b) * h + head) * sq + q0;
  float l2[2], dd[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const bool in = q0 + r0 + 8 * hi < sq;
    l2[hi] = in ? lse[rows + r0 + 8 * hi] * LOG2E : 0.f;
    dd[hi] = in ? dsum[rows + r0 + 8 * hi] : 0.f;
  }
  float acc[DQK / 2], sa[BK / 2], dpa[BK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sa[i] = dpa[i] = 0.f;

  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST, k0 = k_begin + t * BK;
    hopper::mbar_wait(&full[s], (t / ST) & 1);
    const uint8_t* ks = s_kv + s * C::STAGE_BYTES;
    const uint8_t* vs = ks + C::K_BYTES;
    // S = Q K^T, then dP = dO V^T
    hopper::wgmma_fence();
    issue_rows_by_rows<BK, DQK>(sa, s_q, C::Q_PANEL, ks, C::KV_PANEL);
    issue_rows_by_rows<BK, DV>(dpa, s_do, C::Q_PANEL, vs, C::KV_PANEL);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sa);
    // element i: key k0 + 8 (i / 4) + 2 t4 + i % 2, row r0 + 8 ((i / 2) % 2)
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > pos_lo) ||
                      (window && k0 <= pos_hi - window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hi = (i / 2) % 2;
      float p = ex2(fmaf(sa[i], sl2, -l2[hi]));
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i % 2);
        const int qpos = hi ? qpos1 : qpos0;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) p = 0.f;
      }
      sa[i] = p;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpa);
    // dS = P o (dP - D) as bf16 A fragments; dQ += dS K, K read N-major
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float d = dd[(i / 2) % 2];
      da[i / 8][(i % 8) / 2] =
          pack_bf16(sa[i] * (dpa[i] - d), sa[i + 1] * (dpa[i + 1] - d));
    }
    hopper::wgmma_fence();
    issue_frags_by_tile<BK, DQK>(acc, da, ks, C::KV_PANEL);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  const long long q_rs = static_cast<long long>(h) * DQK;
  store_acc<DQK>(dq + (static_cast<long long>(b) * sq + q0) * q_rs +
                     head * DQK,
                 r0, sq - q0, q_rs, acc, scale);
}

// a (dh, heads, seq, batch) map of a contiguous (batch, seq, heads, dh)
// tensor, boxes of `rows` rows
int rows_map(CUtensorMap* map, const void* base, int dh, int heads, int seq,
             int batch, int rows) {
  const long long ss = static_cast<long long>(heads) * dh;
  return hopper::encode_rows_map(map, base, dh, heads, seq, batch, ss,
                                 ss * seq, rows);
}

template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* dsum, void* dq,
                 void* dk, void* dv, int batch, int sq, int sk, int h,
                 int kvh, int causal, int window, float scale,
                 cudaStream_t stream) {
  using KC = KvCfg<DQK, DV>;
  using QC = QCfg<DQK, DV>;
  if (sq == 0 || sk == 0) {  // no (query, key) pair: every gradient is 0
    const size_t qb = size_t(batch) * sq * h * DQK * sizeof(bf16);
    const size_t kb = size_t(batch) * sk * kvh * DQK * sizeof(bf16);
    const size_t vb = size_t(batch) * sk * kvh * DV * sizeof(bf16);
    cudaError_t err = cudaMemsetAsync(dq, 0, qb, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, kb, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, vb, stream);
    return static_cast<int>(err);
  }
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(KC::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        bwd_dq_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(QC::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // each kernel's maps: q and dO in boxes of its query rows, k and v of
  // its keys
  CUtensorMap qkv, dokv, kkv, vkv, qq, doq, kq, vq;
  const long long rows = static_cast<long long>(batch) * h * sq;
  int e = rows_map(&qkv, q, DQK, h, sq, batch, KC::BQ);
  if (e == 0) e = rows_map(&dokv, dout, DV, h, sq, batch, KC::BQ);
  if (e == 0) e = rows_map(&kkv, k, DQK, kvh, sk, batch, 64);
  if (e == 0) e = rows_map(&vkv, v, DV, kvh, sk, batch, 64);
  if (e == 0) e = rows_map(&qq, q, DQK, h, sq, batch, 64);
  if (e == 0) e = rows_map(&doq, dout, DV, h, sq, batch, 64);
  if (e == 0) e = rows_map(&kq, k, DQK, kvh, sk, batch, QC::BK);
  if (e == 0) e = rows_map(&vq, v, DV, kvh, sk, batch, QC::BK);
  if (e != 0) return e;
  const bf16* dot = static_cast<const bf16*>(dout);
  float* dst = static_cast<float*>(dsum);
  bwd_dsum_bf16<DV><<<static_cast<unsigned>((rows * (DV / 8) + 255) / 256),
                      256, 0, stream>>>(static_cast<const bf16*>(o), dot,
                                        dst, rows, sq, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(kvh, batch, (sk + 63) / 64);
  bwd_dkdv_wgmma<DQK, DV><<<kv_grid, KC::THREADS, KC::SMEM, stream>>>(
      qkv, kkv, vkv, dokv, static_cast<const float*>(lse), dst,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, h, kvh, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(h, batch, (sq + 63) / 64);
  bwd_dq_wgmma<DQK, DV><<<q_grid, QC::THREADS, QC::SMEM, stream>>>(
      qq, kq, vq, doq, static_cast<const float*>(lse), dst,
      static_cast<bf16*>(dq), sq, sk, h, kvh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int batch, int sq, int sk, int h, int kvh, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<DQK, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        bwd_dq<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    bwd_dsum<T, DV><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                      stream>>>(static_cast<const T*>(o), dot, dst, rows, sq,
                                h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sk > 0) {
    const dim3 grid((sk + BK - 1) / BK, kvh, batch);
    bwd_dkdv<T, DQK, DV><<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, dot, lt, dst, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, sk, h, kvh, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sq > 0) {
    const dim3 grid((sq + BQ - 1) / BQ, h, batch);
    bwd_dq<T, DQK, DV><<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, dot, lt, dst, static_cast<T*>(dq), sq, sk, h, kvh,
        causal, window, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// the instance for (dqk, dv): bf16 the wgmma kernels, f32 the CUDA-core
// ones; a pair with no instance is cudaErrorInvalidValue
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dsum, void* dq,
             void* dk, void* dv, int batch, int sq, int sk, int h, int kvh,
             int dqk, int dvw, int causal, int window, float scale,
             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const bool pair = (dqk == 64 && dvw == 64) || (dqk == 128 && dvw == 128) ||
                    (dqk == 96 && dvw == 64);
  if (kvh <= 0 || h % kvh != 0 || !pair)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if constexpr (sizeof(T) == 2) {  // bf16: wgmma on TMA-fed tiles
    if (dqk == 64)
      return launch_wgmma<64, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                  batch, sq, sk, h, kvh, causal, window,
                                  scale, st);
    if (dqk == 128)
      return launch_wgmma<128, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                    batch, sq, sk, h, kvh, causal, window,
                                    scale, st);
    return launch_wgmma<96, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                batch, sq, sk, h, kvh, causal, window, scale,
                                st);
  } else {
    if (dqk == 64)
      return launch<T, 64, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                               batch, sq, sk, h, kvh, causal, window, scale,
                               st);
    if (dqk == 128)
      return launch<T, 128, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                 batch, sq, sk, h, kvh, causal, window, scale,
                                 st);
    return launch<T, 96, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                             sq, sk, h, kvh, causal, window, scale, st);
  }
}

}  // namespace

extern "C" {

// q, dq (B, Sq, H, dqk), o, dout (B, Sq, H, dv), k, dk (B, Sk, KV, dqk)
// and v, dv (B, Sk, KV, dv): contiguous; (dqk, dv) is (64, 64), (128, 128)
// or (96, 64); lse and dsum (B, H, Sq) f32, dsum scratch the kernel fills.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dsum, void* dq, void* dk, void* dv,
                            int batch, int sq, int sk, int h, int kvh,
                            int dqk, int dvw, int causal, int window,
                            float scale, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch, sq,
                         sk, h, kvh, dqk, dvw, causal, window, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dsum, void* dq, void* dk, void* dv,
                             int batch, int sq, int sk, int h, int kvh,
                             int dqk, int dvw, int causal, int window,
                             float scale, void* stream) {
  return dispatch<bf16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch, sq,
                        sk, h, kvh, dqk, dvw, causal, window, scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
