// Chunkwise mLSTM forward pass for Hopper (sm_90a), float32, with a state
// in and a state out.
//
// Replaces the Pallas TPU kernel `mlstm_chunkwise_pallas` of
// src/repro/kernels/mlstm/mlstm.py (`_kernel`), and computes what the
// reference model's `mlstm_chunkwise` (src/repro/models/xlstm.py) computes:
// q, k, v (B, S, H, dh) and log-space gates logi, logf (B, S, H); per head a
// matrix memory C (dh x dh), a normaliser n (dh) and a stabiliser m carried
// across chunks; within a chunk, with F the running sum of logf and
// g_t = max(m_prev, max_{u<=t} (logi_u - F_u)) and s_tu = q_t . k_u / sqrt(dh),
//   out_t = (sum_{u<=t} s_tu e^{logi_u - F_u - g_t} v_u
//            + e^{m_prev - g_t} q_t C / sqrt(dh))
//           / (max(|den_t|, e^{-(F_t + g_t)}) + 1e-6),
// den_t the same sums with v and C replaced by 1 and n, and at the chunk's
// end C, n rescaled to m = F_last + g_last.  On the
// port's serving path it runs every prefill of every mLSTM layer, from the
// lane's fresh state, and hands its final state to decode.
//
// Differences from the Pallas kernel, all to follow the model that serving
// runs: a state comes in and goes out (the Pallas kernel starts from zero
// and keeps its state); no clamp on the floor e^{-m} (the Pallas kernel
// clamps -m at 80); any S >= 2 with a ragged last chunk.  The internal chunk
// is 64 positions; the stabiliser m_t is the running maximum of the
// recurrence, which does not depend on where chunks start, so the outputs
// equal the 256-position chunks of the reference up to rounding.  The final
// state does depend on one detail of the reference: for S > 256 that 256
// does not divide, it pads with zero inputs and gates, which leaves the
// outputs alone but moves the final m to max(m_S, 0) and rescales C and n
// by e^{m_S - m}.  `pad_floor` asks for that, and the wrapper sets it
// exactly when the reference pads.
//
// Bound.  The least work is the recurrent form's: per position and head,
// C's update (k^T v) and q C, dh^2 multiply-adds each, and n's, dh each;
// the chunkwise form adds the causal q k^T and W v inside each chunk, work
// its chunk size chooses.  At the main path's B = 1, H = 4, dh = 512 and
// S = 980 that is ~4.1 GFLOP per call against ~41 MB of inputs and outputs,
// so the f32 operations bound it (~0.061 ms at 67 TFLOP/s on the CUDA
// cores), not the bytes (~0.012 ms).
//
// Design: four passes, each of which fills the card (the layout of the
// xLSTM authors' chunkwise kernels: a recurrent pass writes the state at
// every chunk boundary, a parallel pass computes every chunk's outputs).
// At B = 1, H = 4, dh = 512, S = 980 (16 chunks of 64):
//   A. gates, one block per (batch row, head): one warp per chunk takes the
//      running sum of logf and the running max of logi - F as warp scans
//      (two positions a lane), one thread carries m from chunk to chunk
//      (a scalar a chunk), then every position gets g_t, m_t, e^{m_prev -
//      g_t} and e^{src_t - g_last}, every chunk its decay, the state its
//      final m and the pad floor's rescale;
//   B. states, one block per 64 x 64 tile of C (256 blocks): it walks the
//      chunks, C = decay C + (coeff k)^T v on the tile (k and v of the next
//      chunk in flight by cp.async), and writes the state entering each
//      chunk to a workspace slot; the blocks of the first column tile carry
//      n; the final state, rescaled, goes out;
//   S. scores, one block per (chunk, head, quarter of dh) (256 blocks):
//      partial q k^T over its share of dh;
//   C. outputs, one block per (chunk, head, 64 value columns) (512 blocks):
//      W from the summed partial scores and the gates, its row sums,
//      q C_{j-1} and q . n_{j-1} from the slot over slabs of dh, W v, and
//      out = (W v + e^{m_prev - g_t} q C) / den.
// Every product is a 64 x 64 tile in 128 threads, 4 x 8 outputs a thread
// from float4 reads of shared memory, on the CUDA cores (f32: the kernel's
// gate is 1e-4 of the plain version).  The workspace (per call: the gates,
// the partial scores and up to SLOTS chunk states; ~68 MB at the main
// path's shape) is the wrapper's; more than SLOTS chunks run as windows of
// SLOTS, passes B, S and C once a window.  Every sum runs in a fixed order:
// repeated runs give the same bits.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mlstm.cuh"

namespace {

using namespace mlstm;

__global__ void __launch_bounds__(GATE_THREADS)
mlstm_gates(const float* __restrict__ gate_i, const float* __restrict__ gate_f,
            const float* __restrict__ m0, float* __restrict__ m1,
            float* __restrict__ gates, int s, int h, int nc, int pad_floor) {
  gates_pass(gate_i, gate_f, m0, m1, gates, s, h, nc, pad_floor);
}

template <int DH>
__global__ void __launch_bounds__(SCORE_THREADS)
mlstm_scores(const float* __restrict__ q, const float* __restrict__ k,
             float* __restrict__ scores, int s, int h, int j0) {
  scores_pass<DH>(q, k, scores, s, h, j0);
}

struct Work {
  float* gates;    // [B H][gate_stride]
  float* scores;   // [window chunk][B H][split][Q][Q]
  float* cs;       // [window chunk][B H][dh][dh]: C entering the chunk
  float* ns;       // [window chunk][B H][dh]: n entering the chunk
};

// the workspace's floats, and its parts when `base` is given
long long workspace_floats(int batch, int s, int h, int dh, int splits,
                           float* base, Work* w) {
  const int nc = n_chunks(s);
  const int win = nc < SLOTS ? nc : SLOTS;
  const long long bh = static_cast<long long>(batch) * h;
  const long long g = round_up(bh * gate_stride(nc), 64);
  const long long sc = static_cast<long long>(win) * bh * splits * Q * Q;
  const long long cs = static_cast<long long>(win) * bh * dh * dh;
  const long long ns = static_cast<long long>(win) * bh * dh;
  if (w != nullptr) {
    w->gates = base;
    w->scores = base + g;
    w->cs = w->scores + sc;
    w->ns = w->cs + cs;
  }
  return g + sc + cs + ns;
}

// ---- B. states ---------------------------------------------------------------
template <int DH>
struct StateTile {
  static constexpr int T = DH < 64 ? DH : 64;   // tile of C, rows and columns
  static constexpr int TX = T / 8;
  static constexpr int THREADS = TX * (T / 4);
  static constexpr size_t bytes = 2 * 2 * Q * T * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(StateTile<DH>::THREADS)
mlstm_states(const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ gates, const float* cin,
             const float* nin, float* __restrict__ cs,
             float* __restrict__ ns, float* c1, float* n1, int s, int h,
             int nc, int j0, int jn, int last_window) {
  constexpr int T = StateTile<DH>::T;
  constexpr int TX = StateTile<DH>::TX;
  constexpr int NT = StateTile<DH>::THREADS;
  constexpr int T4 = T / 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [2][Q][T]: coeff k, rows of C
  float* vs = smem + 2 * Q * T;    // [2][Q][T]: v, columns of C
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int tiles = DH / T;
  const int r0 = (blockIdx.x / tiles) * T, e0 = (blockIdx.x % tiles) * T;
  const bool carries_n = e0 == 0;
  const int bh = blockIdx.y, nbh = gridDim.y, b = bh / h, head = bh % h;
  const float* gw = gates + bh * gate_stride(nc);
  const float* coeff = gw + 4 * nc * Q;
  const float* decay = gw + 5 * nc * Q;
  const long long cbase = static_cast<long long>(bh) * DH * DH;

  float cst[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cst[i][j] = cin[cbase + static_cast<long long>(r0 + 4 * ty + i) * DH +
                      e0 + col<T>(tx, j)];
  float nst = (carries_n && tid < T) ? nin[bh * DH + r0 + tid] : 0.f;

  auto load = [&](int j, int st) {
    const int t0 = j * Q, len = min(Q, s - t0);
    for (int e = tid; e < Q * T4; e += NT) {
      const int u = e / T4, c = 4 * (e % T4);
      const bool ok = u < len;
      const long long row =
          ((static_cast<long long>(b) * s + t0 + (ok ? u : 0)) * h + head) *
          DH;
      cp_async_16_or_zero(ks + (st * Q + u) * T + c, k + row + r0 + c, ok);
      cp_async_16_or_zero(vs + (st * Q + u) * T + c, v + row + e0 + c, ok);
    }
    cp_async_commit();
  };

  load(j0, 0);
  for (int j = j0; j < jn; ++j) {
    const int jl = j - j0, st = jl & 1;
    // the state entering chunk j, for the output pass
    float* cslot = cs + (static_cast<long long>(jl) * nbh + bh) * DH * DH;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = cslot + static_cast<long long>(r0 + 4 * ty + i) * DH + e0;
      *reinterpret_cast<float4*>(row + col<T>(tx, 0)) =
          make_float4(cst[i][0], cst[i][1], cst[i][2], cst[i][3]);
      *reinterpret_cast<float4*>(row + col<T>(tx, 4)) =
          make_float4(cst[i][4], cst[i][5], cst[i][6], cst[i][7]);
    }
    if (carries_n && tid < T)
      ns[(static_cast<long long>(jl) * nbh + bh) * DH + r0 + tid] = nst;
    if (j + 1 < jn) {
      load(j + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* kc = ks + st * Q * T;
    const float* vc = vs + st * Q * T;
    for (int e = tid; e < Q * T; e += NT) kc[e] *= coeff[j * Q + e / T];
    __syncthreads();
    float acc[4][8];
    zero(acc);
#pragma unroll 4
    for (int u = 0; u < Q; ++u) fma_step<T>(acc, kc + u * T, vc + u * T, ty, tx);
    const float dc = decay[j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) cst[i][jj] = dc * cst[i][jj] + acc[i][jj];
    if (carries_n && tid < T) {
      float a = 0.f;
      for (int u = 0; u < Q; ++u) a += kc[u * T + tid];
      nst = dc * nst + a;
    }
    __syncthreads();   // stage st is refilled by the next iteration's load
  }
  float rescale = 1.f;
  if (last_window) rescale = decay[nc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = c1 + cbase + static_cast<long long>(r0 + 4 * ty + i) * DH + e0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) row[col<T>(tx, jj)] = cst[i][jj] * rescale;
  }
  if (carries_n && tid < T) n1[bh * DH + r0 + tid] = nst * rescale;
}

// ---- C. outputs --------------------------------------------------------------
template <int DH>
struct OutTile {
  static constexpr int T = DH < 64 ? DH : 64;   // value columns a block
  static constexpr int TX = T / 8;
  static constexpr int THREADS = TX * (Q / 4);
  // q slab [DK][Q], C slab [DK][T], W [Q][Q] (u-major), v [Q][T], n slab,
  // per row: src, g, inter, m_t, the W row sums, q . n
  static constexpr size_t floats =
      DK * Q + DK * T + Q * Q + Q * T + DK + 6 * Q;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(OutTile<DH>::THREADS)
mlstm_outputs(const float* __restrict__ q, const float* __restrict__ v,
              const float* __restrict__ gates,
              const float* __restrict__ scores, const float* __restrict__ cs,
              const float* __restrict__ ns, float* __restrict__ out, int s,
              int h, int nc, int j0, float scale) {
  constexpr int T = OutTile<DH>::T;
  constexpr int TX = OutTile<DH>::TX;
  constexpr int NT = OutTile<DH>::THREADS;
  constexpr int KS = score_splits<DH>();
  constexpr int T4 = T / 4;
  constexpr int CLOADS = DK * T4 / NT;   // float4s of the C slab a thread
  constexpr int PAIRS = 2 * Q / NT;      // (row, half) items a thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [DK][Q]: scaled q
  float* csl = qt + DK * Q;         // [DK][T]: C_{j-1}[d0 .., e0 ..]
  float* wt = csl + DK * T;         // [Q u][Q t]
  float* vs = wt + Q * Q;           // [Q][T]
  float* nsl = vs + Q * T;          // [DK]
  float* src_s = nsl + DK;
  float* g_s = src_s + Q;
  float* inter_s = g_s + Q;
  float* mt_s = inter_s + Q;
  float* rs_s = mt_s + Q;           // sum_u W[t][u]
  float* qn_s = rs_s + Q;           // scaled q_t . n_{j-1}
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int jl = blockIdx.x, j = j0 + jl;
  const int bh = blockIdx.y, nbh = gridDim.y, b = bh / h, head = bh % h;
  const int e0 = blockIdx.z * T;
  const int t0 = j * Q, len = min(Q, s - t0);
  const float* gw = gates + bh * gate_stride(nc);
  const long long slot = static_cast<long long>(jl) * nbh + bh;
  const float* cslot = cs + slot * DH * DH;
  const float* nslot = ns + slot * DH;

  // v of the chunk, in flight during everything up to W v
  for (int e = tid; e < Q * T4; e += NT) {
    const int u = e / T4, c = 4 * (e % T4);
    const bool ok = u < len;
    cp_async_16_or_zero(
        vs + u * T + c,
        v + ((static_cast<long long>(b) * s + t0 + (ok ? u : 0)) * h + head) *
                DH + e0 + c,
        ok);
  }
  cp_async_commit();
  for (int t = tid; t < Q; t += NT) {
    src_s[t] = gw[t0 + t];
    g_s[t] = gw[nc * Q + t0 + t];
    mt_s[t] = gw[2 * nc * Q + t0 + t];
    inter_s[t] = gw[3 * nc * Q + t0 + t];
  }
  __syncthreads();

  // W: the summed partial scores x scale, weighted and masked; two threads a
  // row, 32 key positions each
  const float* sc = scores + slot * KS * Q * Q;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int e = tid + p * NT;
    const int t = e / 2, u0 = 32 * (e % 2);
    const float g = g_s[t];
    float rsum = 0.f;
#pragma unroll 4
    for (int u4 = 0; u4 < 32; u4 += 4) {
      float4 acc = *reinterpret_cast<const float4*>(sc + t * Q + u0 + u4);
#pragma unroll
      for (int x = 1; x < KS; ++x) {
        const float4 o = *reinterpret_cast<const float4*>(
            sc + (x * Q + t) * Q + u0 + u4);
        acc.x += o.x;
        acc.y += o.y;
        acc.z += o.z;
        acc.w += o.w;
      }
      const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int u = u0 + u4 + c;
        const float w = (u <= t && t < len)
                            ? a4[c] * scale * expf(src_s[u] - g)
                            : 0.f;
        wt[u * Q + t] = w;
        rsum += w;
      }
    }
    rsum += __shfl_xor_sync(FULL, rsum, 1);
    if ((e & 1) == 0) rs_s[t] = rsum;
  }

  // q C_{j-1} over slabs of dh, and q . n_{j-1}
  float acc[4][8];
  zero(acc);
  float qn[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) qn[p] = 0.f;
  Slab<NT> pq;
  float4 pc[CLOADS];
  auto fetch_c = [&](int d0) {
#pragma unroll
    for (int l = 0; l < CLOADS; ++l) {
      const int e = tid + l * NT;
      const int d = e / T4, c = 4 * (e % T4);
      pc[l] = *reinterpret_cast<const float4*>(
          cslot + static_cast<long long>(d0 + d) * DH + e0 + c);
    }
  };
  pq.fetch(q, b, t0, s, h, head, DH, 0, tid);
  fetch_c(0);
  float pn = tid < DK ? nslot[tid] : 0.f;
  for (int d0 = 0; d0 < DH; d0 += DK) {
    __syncthreads();   // the slab before is used
    pq.store(qt, scale, tid);
#pragma unroll
    for (int l = 0; l < CLOADS; ++l) {
      const int e = tid + l * NT;
      *reinterpret_cast<float4*>(csl + (e / T4) * T + 4 * (e % T4)) = pc[l];
    }
    if (tid < DK) nsl[tid] = pn;
    __syncthreads();
    if (d0 + DK < DH) {
      pq.fetch(q, b, t0, s, h, head, DH, d0 + DK, tid);
      fetch_c(d0 + DK);
      if (tid < DK) pn = nslot[d0 + DK + tid];
    }
#pragma unroll 8
    for (int d = 0; d < DK; ++d) fma_step<T>(acc, qt + d * Q, csl + d * T, ty, tx);
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int e = tid + p * NT;
      const int t = e / 2, dd = (DK / 2) * (e % 2);
#pragma unroll
      for (int d = 0; d < DK / 2; ++d)
        qn[p] = fmaf(qt[(dd + d) * Q + t], nsl[dd + d], qn[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int e = tid + p * NT;
    const float x = qn[p] + __shfl_xor_sync(FULL, qn[p], 1);
    if ((e & 1) == 0) qn_s[e / 2] = x;
  }
  cp_async_wait<0>();
  __syncthreads();   // v, W, the row sums and q . n are in place

  float wv[4][8];
  zero(wv);
#pragma unroll 4
  for (int u = 0; u < Q; ++u) fma_step<T>(wv, wt + u * Q, vs + u * T, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    if (t >= len) continue;
    const float inter = inter_s[t];
    const float den =
        fmaxf(fabsf(rs_s[t] + inter * qn_s[t]), expf(-mt_s[t])) + 1e-6f;
    float* row = out +
                 ((static_cast<long long>(b) * s + t0 + t) * h + head) * DH +
                 e0;
    float o[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) o[jj] = (wv[i][jj] + inter * acc[i][jj]) / den;
    *reinterpret_cast<float4*>(row + col<T>(tx, 0)) =
        make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(row + col<T>(tx, 4)) =
        make_float4(o[4], o[5], o[6], o[7]);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* li,
           const float* lf, const float* c0, const float* n0,
           const float* m0, float* out, float* c1, float* n1, float* m1,
           float* work, int batch, int s, int h, int pad_floor, float scale,
           cudaStream_t stream) {
  constexpr int KS = score_splits<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_states<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(StateTile<DH>::bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_outputs<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(OutTile<DH>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const int nc = n_chunks(s), bh = batch * h;
  Work w;
  workspace_floats(batch, s, h, DH, KS, work, &w);
  mlstm_gates<<<bh, GATE_THREADS, 0, stream>>>(
      li, lf, m0, m1, w.gates, s, h, nc, pad_floor);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  constexpr int tiles = DH / StateTile<DH>::T;
  for (int j0 = 0; j0 < nc; j0 += SLOTS) {
    const int jn = nc < j0 + SLOTS ? nc : j0 + SLOTS;
    const bool first = j0 == 0;
    mlstm_states<DH><<<dim3(tiles * tiles, bh), StateTile<DH>::THREADS,
                       StateTile<DH>::bytes, stream>>>(
        k, v, w.gates, first ? c0 : c1, first ? n0 : n1, w.cs, w.ns, c1, n1,
        s, h, nc, j0, jn, jn == nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    mlstm_scores<DH><<<dim3(jn - j0, bh, KS), SCORE_THREADS, 0, stream>>>(
        q, k, w.scores, s, h, j0);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    mlstm_outputs<DH><<<dim3(jn - j0, bh, tiles), OutTile<DH>::THREADS,
                        OutTile<DH>::bytes, stream>>>(
        q, v, w.gates, w.scores, w.cs, w.ns, out, s, h, nc, j0, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// The workspace, in floats, that mlstm_chunkwise_f32 takes for this shape
// (-1 for a head dim it does not take).
long long mlstm_workspace_floats(int batch, int s, int h, int dh) {
  switch (dh) {
    case 32: return workspace_floats(batch, s, h, 32, score_splits<32>(),
                                     nullptr, nullptr);
    case 64: return workspace_floats(batch, s, h, 64, score_splits<64>(),
                                     nullptr, nullptr);
    case 128: return workspace_floats(batch, s, h, 128, score_splits<128>(),
                                      nullptr, nullptr);
    case 512: return workspace_floats(batch, s, h, 512, score_splits<512>(),
                                      nullptr, nullptr);
    default: return -1;
  }
}

// q, k, v, out (B, S, H, dh), the gates logi, logf (B, S, H),
// C (B, H, dh, dh), n (B, H, dh), m (B, H): contiguous float32, q, k, v
// 16-byte aligned.  S >= 2.  `work`: mlstm_workspace_floats(...) floats,
// 16-byte aligned, not used by another call in flight.  The outputs do not
// alias the inputs.
int mlstm_chunkwise_f32(const void* q, const void* k, const void* v,
                        const void* gate_i, const void* gate_f,
                        const void* c0, const void* n0, const void* m0,
                        void* out, void* c1, void* n1, void* m1, void* work,
                        int batch, int s, int h, int dh, int pad_floor,
                        float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (s < 2) return static_cast<int>(cudaErrorInvalidValue);
#define MLSTM_ARGS                                                     \
  static_cast<const float*>(q), static_cast<const float*>(k),          \
      static_cast<const float*>(v), static_cast<const float*>(gate_i), \
      static_cast<const float*>(gate_f), static_cast<const float*>(c0), \
      static_cast<const float*>(n0), static_cast<const float*>(m0),    \
      static_cast<float*>(out), static_cast<float*>(c1),               \
      static_cast<float*>(n1), static_cast<float*>(m1),                \
      static_cast<float*>(work), batch, s, h, pad_floor, scale, st
  switch (dh) {
    case 32: return launch<32>(MLSTM_ARGS);
    case 64: return launch<64>(MLSTM_ARGS);
    case 128: return launch<128>(MLSTM_ARGS);
    case 512: return launch<512>(MLSTM_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLSTM_ARGS
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
