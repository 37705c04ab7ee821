// Flash-attention forward pass for Hopper (sm_90a), float and bfloat16.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/flash_attention.py (`_kernel`): causal
// or sliding-window GQA attention with an online softmax, q (B, Sq, H, dqk),
// k (B, Sk, KV, dqk), v (B, Sk, KV, dv), query head h reading kv head
// h / rep, query positions end-aligned (row i sits at Sk - Sq + i), f32
// accumulation, scale dqk^-0.5.  Instantiated at (dqk, dv) = (64, 64),
// (128, 128) and (96, 64): the last is MLA's cacheless branch (MiniCPM3's
// training forward: q and k a 64-wide nope part and a 32-wide RoPE part,
// v 64 wide).  On the port's serving path it runs every prefill, with
// Sq = Sk = the prompt length, over the prompt's own keys.
//
// Two deliberate differences from the Pallas kernel:
//   * any Sq and Sk: the kernel computes its offsets from strides and masks
//     ragged tails (the TPU kernel refuses lengths that its 128-row blocks
//     do not divide, and prompts have any length);
//   * a query row that sees no key returns 0, as the oracle `attention_ref`
//     and the reference model's `chunked_attention` do (the TPU kernel's
//     -1e30 sentinel returns the mean of V there).  No row of the serving
//     path is fully masked.
//
// Bound.  Causal attention at Sq = Sk = S does ~S^2 H dh multiply-adds
// (QK^T and PV over the visible half), 2 S^2 H dh FLOP; Q, K, V and O are
// 8 S H dh bytes in bf16 (Sk = Sq, KV = H).  That is S / 4 FLOP per byte,
// at most 256 at the main path's prompts (S <= 1024, H 16, dh 64): below
// the ~295 the card needs to be bound by its tensor cores, so the bytes
// set the least time there; with GQA (Jamba's 64 / 8 heads of 128) the
// bytes shrink and the operations set it.  Both bounds are a few to a few
// tens of microseconds.
//
// Two kernels, one per type.
//
// bf16: `flash_fwd_wgmma`, the products on the tensor cores.  One block per
// (query tile, q head, batch row); the query tiles are walked longest-first
// (blockIdx.x reversed), so the causal tail's heavy tiles do not run last.
// One consumer warpgroup owns the tile's 64 query rows (the wgmma M): two
// warpgroups on a 128-row tile, sharing its K/V loads, measured slower at
// the main path's long prompts (PERF.md), and two 160-thread blocks fit an
// SM.  One producer warp issues TMA loads: the Q tile once, then K and V
// tiles of BK keys (128 at dh 64, 64 at dh 128 and at (96, 64)) through a
// ring of STAGES shared-memory stages, each with a full and an empty
// mbarrier.  Tiles are 128-byte swizzled panels of 64 columns, as wgmma
// reads them; a 96-wide Q or K tile is two panels, the second holding
// columns 64-95 and 32 columns of TMA's zeros, which no product reads.
// Per tile a consumer warpgroup computes S = Q K^T by `wgmma m64nBKk16`
// from shared memory, dqk / 16 slices deep (6 at dqk 96), runs the online
// softmax on the accumulator fragment in registers (each thread holds 2
// rows; row max and sum across the 4 threads of a quad by shuffles; exp2
// with the scale folded in), converts P to bf16 in registers and adds P V
// by `wgmma m64nDVk16` with P as the register A operand and V read from
// shared memory as stored (the transpose bit).  The
// only rounding beyond the f32 version's is P to bf16 before P V (the sum l
// takes P in f32).  Only tiles that cross the causal diagonal, a window edge
// or Sk take the mask path; tiles no row sees are never loaded.
// Rows past Sk arrive as zeros (TMA's out-of-bounds fill) and are masked.
// TMA needs 16-byte aligned bases and 16-byte multiple strides; the wrapper
// checks them (a 96-wide bf16 row is 192 bytes).  k and v each have their
// own batch and sequence strides and their own map.  The tensor maps are
// encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.
//
// f32: `flash_fwd`, the CUDA-core kernel of the first version, kept for the
// f32 path on purpose: the tensor-core route for f32 is TF32 (about 3
// decimal digits), which the f32 checks (2e-5 against the plain version)
// could not hold.  One block of 256 threads per (query tile of 64 rows, q
// head, batch row).  The scaled Q tile is kept in shared memory; 64-key K
// and V tiles stream through shared memory (66 KB at dh 64, 113 KB at dh
// 128, 83 KB at (96, 64)); rows are padded by one float so that
// neighbouring threads hit neighbouring banks.  Each thread owns 4 query
// rows x 4 key columns of the score tile and 4 rows x dv/16 columns of the
// accumulator, so the online
// softmax's running max and sum stay in registers, reduced across the 16
// threads of a row with warp shuffles.  Key tiles that no row of the block
// can see (causal future, behind the window) are skipped; skipping them is
// exact.
//
// K/V are never repeated in memory, and no sum uses atomics: two calls give
// the same bits.
//
// Given a pointer for it, either kernel also writes each query row's
// log-sum-exp of the scaled scores (f32, (B, H, Sq)), which the training
// path's backward kernel (flash_attention_bwd.cu) reads to recompute P.
// Serving passes none, and its launches are unchanged.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (or
// TMAP_ERROR + the CUresult if a tensor map cannot be encoded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int TX = 16;        // threads per row of the score tile
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;  // query rows per thread
constexpr int CPT = BK / TX;  // score columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// q and k rows DQK wide, v and o rows DV wide
template <int DQK, int DV>
struct Layout {
  static constexpr int KP = DQK + 1;  // padded row of Q and K
  static constexpr int PP = BK + 1;   // padded row of P
  static constexpr size_t bytes =
      (size_t(BQ) * KP + size_t(BK) * KP + size_t(BK) * DV +
       size_t(BQ) * PP) * sizeof(float);
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int h,
          int rep, long long q_sb, long long q_ss, long long k_sb,
          long long k_ss, long long v_sb, long long v_ss, int causal,
          int window, float scale, float* __restrict__ lse) {
  constexpr int KP = Layout<DQK, DV>::KP;
  constexpr int PP = Layout<DQK, DV>::PP;
  constexpr int DPT = DV / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][KP], scaled
  float* Ks = Qs + BQ * KP;     // [BK][KP]
  float* Vs = Ks + BK * KP;     // [BK][DV]
  float* Ps = Vs + BK * DV;     // [BQ][PP]

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int q_off = sk - sq;  // end-aligned query positions

  const T* qb = q + b * q_sb + static_cast<long long>(head) * DQK;
  const T* kb = k + b * k_sb + static_cast<long long>(head / rep) * DQK;
  const T* vb = v + b * v_sb + static_cast<long long>(head / rep) * DV;

  for (int e = tid; e < BQ * DQK; e += THREADS) {
    const int r = e / DQK, c = e % DQK;
    float x = 0.f;
    if (q0 + r < sq) x = to_f(qb[(q0 + r) * q_ss + c]) * scale;
    Qs[r * KP + c] = x;
  }

  // keys that some row of this tile can see: [k_begin, k_end)
  const int pos_lo = q_off + q0;
  const int pos_hi = q_off + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window ? (max(0, pos_lo - window + 1) / BK) * BK : 0;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q is staged; the previous tile's K, V, P are used
    for (int e = tid; e < BK * DQK; e += THREADS) {
      const int r = e / DQK, c = e % DQK;
      Ks[r * KP + c] = k0 + r < k_end ? to_f(kb[(k0 + r) * k_ss + c]) : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int r = e / DV, c = e % DV;
      Vs[r * DV + c] = k0 + r < k_end ? to_f(vb[(k0 + r) * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + TY * i) * KP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * KP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
      const int qpos = q_off + q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        bool ok = kpos < k_end;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[r * PP + tx + TX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + TY * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * DV + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= sq) continue;
    T* ob = o + ((static_cast<long long>(b) * sq + row) * h + head) * DV;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      ob[tx + TX * j] = from_f<T>(l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
    // the row's log-sum-exp of the scaled scores (Q was scaled on load)
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * h + head) * sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// ---- bf16: wgmma on TMA-fed tiles ------------------------------------------
using bf16 = __nv_bfloat16;

template <int DQK, int DV>
struct Wg {
  // keys per tile: at (96, 64) 128 would leave one block an SM
  static constexpr int BK = DQK == 64 ? 128 : 64;
  static constexpr int STAGES = 2;
  // 64-column panels of a Q or K row (a 96-wide row: two, the second
  // half zeros) and of a V row
  static constexpr int NPQK = (DQK + 63) / 64;
  static constexpr int NPV = DV / 64;
  static constexpr int Q_PANEL = 64 * 128;       // bytes: 64 rows x 128 B
  static constexpr int KV_PANEL = BK * 128;
  static constexpr int Q_BYTES = NPQK * Q_PANEL;
  static constexpr int K_BYTES = NPQK * KV_PANEL;  // K of one stage
  static constexpr int V_BYTES = NPV * KV_PANEL;   // V of one stage
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int THREADS = 128 + 32;  // + the producer warp
  // 1024 B of slack to align the panels, then the barriers
  static constexpr size_t SMEM = 1024 + Q_BYTES +
                                 size_t(STAGES) * STAGE_BYTES +
                                 8 * (1 + 2 * STAGES);
};

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
  else hopper::wgmma_rs_n128(d, a, b);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Wg<DQK, DV>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                bf16* __restrict__ o, int sq, int sk, int h, int rep,
                int causal, int window, float scale_log2,
                float* __restrict__ lse) {
  using C = Wg<DQK, DV>;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_q = smem;                      // [NPQK] panels of 64 rows
  uint8_t* s_kv = smem + C::Q_BYTES;        // [STAGES] {K, V} panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      s_kv + STAGES * C::STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * 64;
  const int q_off = sk - sq;  // end-aligned query positions
  // keys that some row of this tile can see: [k_begin, k_end); every key
  // tile in it is seen by some row
  const int pos_lo = q_off + q0;
  const int pos_hi = q_off + min(q0 + 64, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window ? (max(0, pos_lo - window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      hopper::mbar_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < C::NPQK; ++p)
        hopper::tma_load_4d(s_q + p * C::Q_PANEL, &qmap, q_full, p * 64,
                            head, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        hopper::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], C::STAGE_BYTES);
        uint8_t* ks = s_kv + s * C::STAGE_BYTES;
        const int k0 = k_begin + t * BK;
        for (int p = 0; p < C::NPQK; ++p)
          hopper::tma_load_4d(ks + p * C::KV_PANEL, &kmap, &full[s], p * 64,
                              head / rep, k0, b);
        for (int p = 0; p < C::NPV; ++p)
          hopper::tma_load_4d(ks + C::K_BYTES + p * C::KV_PANEL, &vmap,
                              &full[s], p * 64, head / rep, k0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: 64 query rows; this thread holds rows r0, r0 + 8
  const int r0 = 16 * warp + lane / 4;
  const int qpos0 = pos_lo + r0, qpos1 = qpos0 + 8;

  float acc[DV / 2], sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = k_begin + t * BK;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* ks = s_kv + s * C::STAGE_BYTES;
    const uint8_t* vs = ks + C::K_BYTES;
    // S = Q K^T: 16 columns of dqk per step, 32 bytes into a panel
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<BK>(sacc,
                   hopper::desc_sw128(s_q + (kk / 4) * C::Q_PANEL +
                                      (kk % 4) * 32, 0),
                   hopper::desc_sw128(ks + (kk / 4) * C::KV_PANEL +
                                      (kk % 4) * 32, 0),
                   kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);

    // fragment element i: key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2,
    // row r0 + 8 ((i / 2) % 2)
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > pos_lo) ||
                      (window && k0 <= pos_hi - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int qpos = (i / 2) % 2 ? qpos1 : qpos0;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) sacc[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2) mx1 = fmaxf(mx1, sacc[i]);
      else mx0 = fmaxf(mx0, sacc[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // running max in scaled log2 units; a row with nothing seen yet keeps
    // -inf and subtracts 0
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    // P in bf16 registers as wgmma's A fragments: keys 16 kk .. 16 kk + 15
    // are accumulator elements 8 kk .. 8 kk + 7, in the A operand's order
    uint32_t pa[BK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const bool hi = (i / 2) % 2;
      const float mu = hi ? mu1 : mu0;
      const float p0 = exp2f(fmaf(sacc[i], scale_log2, -mu));
      const float p1 = exp2f(fmaf(sacc[i + 1], scale_log2, -mu));
      if (hi) rs1 += p0 + p1;
      else rs0 += p0 + p1;
      __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
      pa[i / 8][(i % 8) / 2] = *reinterpret_cast<uint32_t*>(&pp);
    }
    l0 = l0 * al0 + rs0;  // this thread's columns; the quad sums at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= (i / 2) % 2 ? al1 : al0;
    // O += P V: 16 keys per step, 16 rows (2048 B) into V's panels
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DV>(acc, pa[kk],
                   hopper::desc_sw128(vs + kk * 16 * 128, C::KV_PANEL));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = q0 + r0, row1 = row0 + 8;
  bf16* o0 = o + ((static_cast<long long>(b) * sq + row0) * h + head) * DV;
  bf16* o1 = o0 + 8LL * h * DV;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  // the rows' log-sum-exp, natural log: m is in scaled log2 units
  if (lse != nullptr && lane % 4 == 0) {
    float* lrow = lse + (static_cast<long long>(b) * h + head) * sq;
    constexpr float LN2 = 0.6931471805599453f;
    if (row0 < sq) lrow[row0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -INFINITY;
    if (row1 < sq) lrow[row1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -INFINITY;
  }
}

// ---- host --------------------------------------------------------------------
template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int batch, int sq, int sk, int h, int kvh,
                 const long long* st, int causal, int window, float scale,
                 float* lse, cudaStream_t stream) {
  using C = Wg<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  int e = hopper::encode_rows_map(&qm, q, DQK, h, sq, batch, st[1], st[0],
                                  64);
  if (e == 0)
    e = hopper::encode_rows_map(&km, k, DQK, kvh, sk, batch, st[3], st[2],
                                C::BK);
  if (e == 0)
    e = hopper::encode_rows_map(&vm, v, DV, kvh, sk, batch, st[5], st[4],
                                C::BK);
  if (e != 0) return e;
  const dim3 grid((sq + 63) / 64, h, batch);
  flash_fwd_wgmma<DQK, DV><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), sq, sk, h, h / kvh, causal, window,
      scale * 1.4426950408889634f, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the CUDA-core kernel -----------------------------------------------
template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int h, int kvh, const long long* st, int causal,
           int window, float scale, float* lse, cudaStream_t stream) {
  const size_t smem = Layout<DQK, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || sq == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((sq + BQ - 1) / BQ, h, batch);
  flash_fwd<T, DQK, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, h / kvh, st[0],
      st[1], st[2], st[3], st[4], st[5], causal, window, scale, lse);
  return static_cast<int>(cudaGetLastError());
}

// the instance for (dqk, dv): bf16 the wgmma kernel, f32 the CUDA-core one;
// a pair with no instance is cudaErrorInvalidValue
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int sq, int sk, int h, int kvh, int dqk, int dv,
             const long long* st, int causal, int window, float scale,
             float* lse, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool pair = (dqk == 64 && dv == 64) || (dqk == 128 && dv == 128) ||
                    (dqk == 96 && dv == 64);
  if (kvh <= 0 || h % kvh != 0 || !pair)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {  // bf16: wgmma on TMA-fed tiles
    if (batch == 0 || sq == 0 || h == 0)
      return static_cast<int>(cudaSuccess);
    if (sk == 0)  // no key anywhere: every row is 0 (a map needs seq >= 1)
      return static_cast<int>(cudaMemsetAsync(
          o, 0, size_t(batch) * sq * h * dv * sizeof(bf16), s));
    if (dqk == 64)
      return launch_wgmma<64, 64>(q, k, v, o, batch, sq, sk, h, kvh, st,
                                  causal, window, scale, lse, s);
    if (dqk == 128)
      return launch_wgmma<128, 128>(q, k, v, o, batch, sq, sk, h, kvh, st,
                                    causal, window, scale, lse, s);
    return launch_wgmma<96, 64>(q, k, v, o, batch, sq, sk, h, kvh, st,
                                causal, window, scale, lse, s);
  } else {
    if (dqk == 64)
      return launch<T, 64, 64>(q, k, v, o, batch, sq, sk, h, kvh, st, causal,
                               window, scale, lse, s);
    if (dqk == 128)
      return launch<T, 128, 128>(q, k, v, o, batch, sq, sk, h, kvh, st,
                                 causal, window, scale, lse, s);
    return launch<T, 96, 64>(q, k, v, o, batch, sq, sk, h, kvh, st, causal,
                             window, scale, lse, s);
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, dqk), k (B, Sk, KV, dqk) and v (B, Sk, KV, dv): heads packed
// (stride the row width) and the last dim contiguous; batch and sequence
// strides in elements, each tensor its own.  (dqk, dv) is (64, 64),
// (128, 128) or (96, 64).  o is a contiguous (B, Sq, H, dv) tensor.  bf16
// takes the TMA route: base pointers 16-byte aligned, strides multiples of
// 8 elements.  lse, when not null, is a contiguous (B, H, Sq) f32 tensor
// that receives each row's log-sum-exp of the scaled scores (-inf for a
// row that sees no key), which the backward kernel
// (flash_attention_bwd.cu) reads; serving passes null.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int batch, int sq, int sk, int h, int kvh, int dqk,
                        int dv, long long q_sb, long long q_ss, long long k_sb,
                        long long k_ss, long long v_sb, long long v_ss,
                        int causal, int window, float scale, float* lse,
                        void* stream) {
  const long long st[6] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  return dispatch<float>(q, k, v, o, batch, sq, sk, h, kvh, dqk, dv, st,
                         causal, window, scale, lse, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int batch, int sq, int sk, int h, int kvh,
                         int dqk, int dv, long long q_sb, long long q_ss,
                         long long k_sb, long long k_ss, long long v_sb,
                         long long v_ss, int causal, int window, float scale,
                         float* lse, void* stream) {
  const long long st[6] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  return dispatch<bf16>(q, k, v, o, batch, sq, sk, h, kvh, dqk, dv, st,
                        causal, window, scale, lse, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
