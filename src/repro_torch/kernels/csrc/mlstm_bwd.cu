// Chunkwise mLSTM backward pass for Hopper (sm_90a), float32: dq, dk, dv,
// dlogi and dlogf of the forward kernel's output (mlstm.cu), from a zero
// state in, the final state unused (the training path's case).
//
// Replaces no Pallas kernel: the reference model trains through the jnp
// `mlstm_chunkwise` (src/repro/models/xlstm.py), which JAX differentiates.
// It computes what `mlstm_chunkwise_bwd_ref` (kernels/mlstm/ref.py) writes
// out.  In the forward's notation (per batch row and head, F the running sum
// of logf, a_u = logi_u - F_u, G_t the running max of a, m_t = F_t + G_t,
// Z_t = max(|den_t|, e^{-m_t}) + 1e-6, out_t = num_t / Z_t):
//   dnum_t = dout_t / Z_t;  dZ_t = -dout_t . out_t / Z_t, which goes to den
//   (dden_t, with its sign) or to the floor (dm_t = -e^{-m_t} dZ_t),
//   half each at a tie;
//   dW_tu = dnum_t . v_u + dden_t,  dS_tu = dW_tu e^{a_u - G_t}  (u <= t);
//   dq_t = sum_u dS_tu k_u / sqrt(dh),  dk_u = sum_t dS_tu q_t / sqrt(dh),
//   dv_u = sum_t W_tu dnum_t;
//   dlogi_u = k_u . dk_u + (the G_t's whose running max a_u is)
//   with dG_t = dm_t - q_t . dq_t = dm_t - (dout_t . out_t + dden_t den_t),
//   and dlogf the reverse running sum of dm - dlogi.
// The sums over earlier and later chunks go through states: the forward's
// (C, n) entering each chunk for dq, and their reverse, dC (dh x dh) and dn
// (dh) leaving each chunk,
//   dC_j = e^{G_{j-1} - G_{end of j}} dC_{j+1}
//          + sum_{t in j} e^{G_{j-1} - G_t} (q_t / sqrt(dh)) (x) dnum_t,
// for dk_u += e^{a_u - G_{end of j}} (dC_{j+1} v_u + dn_{j+1}) and
// dv_u += e^{a_u - G_{end of j}} dC_{j+1}^T k_u.  Every exponential is of a
// difference that is <= 0, as in the forward.
//
// Bound.  The least work is the recurrent form's gradient: per position
// and head, ~4 dh^2 multiply-adds (twice the forward's 2 dh^2: the reverse
// state's update and its products with v and k, and q's with the forward
// state).  At xLSTM-350M's training shape (B 8 x 2048, H 4, dh 512) that is
// ~137 GFLOP, ~2.05 ms at 67 TFLOP/s on the CUDA cores; the bytes (q, k, v,
// out, dout and the gradients, ~0.6 GB) take ~0.18 ms.
//
// Design: the forward's passes run again and the backward's follow, each
// pass filling the card, in windows of SLOTS chunks of 64 positions (the
// workspace holds one window's states: ~1.2 GB at the training shape),
// windows from the last to the first:
//   A. gates, one block per (batch row, head): the forward's pass;
//   K. the forward's states, one block per 64 x 64 tile of C, walking every
//      chunk once and keeping the state at each window's start (the last
//      window's states stay in the slots);
//   then per window:
//   B. the forward's states again from the window's start (not for the
//      last window), one block per 64 x 64 tile;
//   S. partial q k^T and dout v^T over quarters of dh, one block per
//      (chunk, head, quarter): the forward's scores pass, twice;
//   R. per position (a warp a position, a block a chunk): W and its row sum,
//      q . n, dout . out, den, Z, dden, dm, and dS;
//   V. the reverse states: one block per 64 x 64 tile of dC, walking the
//      window's chunks backwards from the carry of the window after it,
//      keeping dC leaving each chunk;
//   G. dq, dk, dv: one block per (chunk, head, 64 columns, which of the
//      three), each a 64 x 64 product with the chunk's dS or W and a 64 x dh
//      by dh x 64 product with a state; dk's blocks also write their share
//      of k . dk;
//   and after the last window
//   D. the gates' gradients, one block per (batch row, head): k . dk summed
//      over the column blocks in order, G's gradient run-summed to each new
//      running max, and the reverse running sum for dlogf (one thread walks
//      the positions, staged through shared memory).
// Every product is a 64 x 64 tile in 128 threads on the CUDA cores (f32: the
// gate is 1e-4 of the plain version), every sum in a fixed order, and no
// atomics: two calls give the same bits.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mlstm.cuh"

namespace {

using namespace mlstm;

constexpr int NPOS = 4;          // per position: 1/Z, dden, dm, q . dq
constexpr float EPS = 1e-6f;
constexpr float M_INIT = -1e30f;
constexpr int ROW_THREADS = 256;
constexpr int GB_THREADS = 256;
constexpr int GB_WIN = 2048;      // positions the gates' pass stages at once

template <int DH>
struct Tile {
  static constexpr int T = DH < 64 ? DH : 64;   // columns (and rows) a block
  static constexpr int TX = T / 8;
  static constexpr int TILES = DH / T;
  static constexpr int THREADS = TX * (Q / 4);       // 64 rows x T columns
  static constexpr int WALK_THREADS = TX * (T / 4);  // T x T (the states)
};

struct Work {
  float* gates;   // [B H][gate_stride]
  float* pos;     // [B H][NPOS][padded S]
  float* kdk;     // [B H][padded S][column blocks]: k . dk by block
  float* m01;     // [2][B H]: the gates pass's m in (M_INIT) and out
  float* scores;  // [window chunk][B H][split][Q][Q]: q k^T
  float* dvs;     // [window chunk][B H][split][Q][Q]: dout v^T
  float* wds;     // [window chunk][B H][2][Q][Q]: W and dS
  float* ckc;     // [window + 1][B H][dh][dh]: C at each window's start
  float* ckn;     // [window + 1][B H][dh]
  float* cs;      // [window chunk][B H][dh][dh]: C entering each chunk
  float* ns;      // [window chunk][B H][dh]
  float* dcs;     // [window chunk][B H][dh][dh]: dC leaving each chunk
  float* dns;     // [window chunk][B H][dh]
  float* dc;      // [B H][dh][dh]: dC carried between windows
  float* dn;      // [B H][dh]
};

long long workspace_floats(int batch, int s, int h, int dh, int splits,
                           int tiles, float* base, Work* w) {
  const int nc = n_chunks(s);
  const int win = nc < SLOTS ? nc : SLOTS;
  const int nw = (nc + SLOTS - 1) / SLOTS;
  const long long bh = static_cast<long long>(batch) * h;
  const long long sp = static_cast<long long>(nc) * Q;
  const long long dd = static_cast<long long>(dh) * dh;
  const long long sizes[] = {
      bh * gate_stride(nc), bh * NPOS * sp, bh * sp * tiles, 2 * bh,
      win * bh * splits * Q * Q, win * bh * splits * Q * Q,
      win * bh * 2 * Q * Q, (nw + 1) * bh * dd, (nw + 1) * bh * dh,
      win * bh * dd, win * bh * dh, win * bh * dd, win * bh * dh, bh * dd,
      bh * dh};
  float** parts[] = {&w->gates, &w->pos, &w->kdk, &w->m01, &w->scores,
                     &w->dvs, &w->wds, &w->ckc, &w->ckn, &w->cs, &w->ns,
                     &w->dcs, &w->dns, &w->dc, &w->dn};
  long long off = 0;
  for (int i = 0; i < 15; ++i) {
    if (base != nullptr) *parts[i] = base + off;
    off += round_up(sizes[i], 64);
  }
  return off;
}

__global__ void mlstm_bwd_fill(float* x, int n, float value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = value;
}

// A and S: the forward's passes (mlstm.cuh), under names of this file's
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_bwd_fgates(const float* __restrict__ gate_i,
                 const float* __restrict__ gate_f, const float* __restrict__ m0,
                 float* __restrict__ m1, float* __restrict__ gates, int s,
                 int h, int nc) {
  gates_pass(gate_i, gate_f, m0, m1, gates, s, h, nc, 0);
}

template <int DH>
__global__ void __launch_bounds__(SCORE_THREADS)
mlstm_bwd_scores(const float* __restrict__ q, const float* __restrict__ k,
                 float* __restrict__ scores, int s, int h, int j0) {
  scores_pass<DH>(q, k, scores, s, h, j0);
}

// ---- K, B, V. a walk of the states over a window's chunks ------------------
// Per chunk j in the walk's order, the state before the chunk goes to slot
// j - j0 (when `write_slots`), then
//   X = decay_j X + sum_p (rc_p rscale x_p) (x) (cc_p y_p)
//   x = decay_j x + sum_p (rc_p rscale x_p) nw_p
// over the chunk's positions p, rc the gates' array at `rc_off` (cc and nw
// per position arrays of `pos`, or null for 1).  Forward: x = k, rc = the
// coefficients e^{a_p - G_end}, y = v.  Reverse: x = q, rc = e^{G_{j-1} -
// G_p}, rscale = 1/sqrt(dh), y = dout, cc = 1/Z, nw = dden.
template <int DH>
__global__ void __launch_bounds__(Tile<DH>::WALK_THREADS)
mlstm_bwd_walk(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ gates, int rc_off, float rscale,
            const float* __restrict__ cc, const float* __restrict__ nwt,
            const float* cin, const float* nin, float* cout, float* nout,
            float* __restrict__ cs, float* __restrict__ ns, int write_slots,
            int s, int h, int nc, int j0, int jn, int reverse) {
  constexpr int T = Tile<DH>::T;
  constexpr int TX = Tile<DH>::TX;
  constexpr int NT = Tile<DH>::WALK_THREADS;
  constexpr int T4 = T / 4;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [2][Q][T]: rows of the state
  float* ys = smem + 2 * Q * T;    // [2][Q][T]: columns of the state
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int tiles = DH / T;
  const int r0 = (blockIdx.x / tiles) * T, e0 = (blockIdx.x % tiles) * T;
  const bool carries_n = e0 == 0;
  const int bh = blockIdx.y, nbh = gridDim.y, b = bh / h, head = bh % h;
  const long long sp = static_cast<long long>(nc) * Q;
  const float* gw = gates + bh * gate_stride(nc);
  const float* rc = gw + rc_off;
  const float* decay = gw + NGATE * sp;
  const float* pcc = cc == nullptr ? nullptr : cc + bh * NPOS * sp;
  const float* pnw = nwt == nullptr ? nullptr : nwt + bh * NPOS * sp;
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
      cp_async_16_or_zero(xs + (st * Q + u) * T + c, x + row + r0 + c, ok);
      cp_async_16_or_zero(ys + (st * Q + u) * T + c, y + row + e0 + c, ok);
    }
    cp_async_commit();
  };

  const int count = jn - j0;
  load(reverse ? jn - 1 : j0, 0);
  for (int i = 0; i < count; ++i) {
    const int j = reverse ? jn - 1 - i : j0 + i;
    const int jl = j - j0, st = i & 1;
    if (write_slots) {
      float* cslot = cs + (static_cast<long long>(jl) * nbh + bh) * DH * DH;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float* row =
            cslot + static_cast<long long>(r0 + 4 * ty + ii) * DH + e0;
        *reinterpret_cast<float4*>(row + col<T>(tx, 0)) =
            make_float4(cst[ii][0], cst[ii][1], cst[ii][2], cst[ii][3]);
        *reinterpret_cast<float4*>(row + col<T>(tx, 4)) =
            make_float4(cst[ii][4], cst[ii][5], cst[ii][6], cst[ii][7]);
      }
      if (carries_n && tid < T)
        ns[(static_cast<long long>(jl) * nbh + bh) * DH + r0 + tid] = nst;
    }
    if (i + 1 < count) {
      load(reverse ? j - 1 : j + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* xc = xs + st * Q * T;
    float* yc = ys + st * Q * T;
    for (int e = tid; e < Q * T; e += NT) {
      const int u = j * Q + e / T;
      xc[e] *= rc[u] * rscale;
      if (pcc != nullptr) yc[e] *= pcc[u];
    }
    __syncthreads();
    float acc[4][8];
    zero(acc);
#pragma unroll 4
    for (int u = 0; u < Q; ++u)
      fma_step<T>(acc, xc + u * T, yc + u * T, ty, tx);
    const float dc = decay[j];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        cst[ii][jj] = dc * cst[ii][jj] + acc[ii][jj];
    if (carries_n && tid < T) {
      float a = 0.f;
      for (int u = 0; u < Q; ++u)
        a += xc[u * T + tid] * (pnw != nullptr ? pnw[j * Q + u] : 1.f);
      nst = dc * nst + a;
    }
    __syncthreads();   // stage st is refilled by the next iteration's load
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    float* row = cout + cbase + static_cast<long long>(r0 + 4 * ty + ii) * DH +
                 e0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) row[col<T>(tx, jj)] = cst[ii][jj];
  }
  if (carries_n && tid < T) nout[bh * DH + r0 + tid] = nst;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// ---- R. per position: den, Z, the two branches' gradients, W and dS --------
template <int DH>
__global__ void __launch_bounds__(ROW_THREADS)
mlstm_bwd_rows(const float* __restrict__ q, const float* __restrict__ out,
               const float* __restrict__ dout,
               const float* __restrict__ gates,
               const float* __restrict__ scores,
               const float* __restrict__ dvs, const float* __restrict__ ns,
               float* __restrict__ pos, float* __restrict__ wds, int s, int h,
               int nc, int j0, float scale) {
  constexpr int KS = score_splits<DH>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jl = blockIdx.x, j = j0 + jl;
  const int bh = blockIdx.y, nbh = gridDim.y, b = bh / h, head = bh % h;
  const int t0 = j * Q;
  const long long sp = static_cast<long long>(nc) * Q;
  const float* gw = gates + bh * gate_stride(nc);
  const float* src = gw;
  const float* gg = gw + sp;
  const float* mt = gw + 2 * sp;
  const float* inter = gw + 3 * sp;
  const long long slot = static_cast<long long>(jl) * nbh + bh;
  const float* sc = scores + slot * KS * Q * Q;
  const float* dv = dvs + slot * KS * Q * Q;
  const float* nslot = ns + slot * DH;
  float* pw = pos + bh * NPOS * sp;
  float* wslot = wds + slot * 2 * Q * Q;
  for (int t = warp; t < Q; t += ROW_THREADS / 32) {
    const int p = t0 + t;
    const bool valid = p < s;
    const float g = gg[p];
    float w[2], dnv[2], dd[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int u = lane + 32 * x;
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        a += sc[(k * Q + t) * Q + u];
        c += dv[(k * Q + t) * Q + u];
      }
      dd[x] = (valid && u <= t) ? expf(src[t0 + u] - g) : 0.f;
      w[x] = a * scale * dd[x];
      dnv[x] = c;
    }
    float qn = 0.f, doo = 0.f;
    if (valid) {
      const long long row =
          ((static_cast<long long>(b) * s + p) * h + head) * DH;
      for (int d = lane; d < DH; d += 32) {
        qn = fmaf(q[row + d], nslot[d], qn);
        doo = fmaf(dout[row + d], out[row + d], doo);
      }
    }
    const float rs = warp_sum(w[0] + w[1]);
    qn = warp_sum(qn);
    doo = warp_sum(doo);
    const float den = rs + inter[p] * (qn * scale);
    const float floor_ = expf(-mt[p]);
    const float ad = fabsf(den);
    const float z = fmaxf(ad, floor_) + EPS;
    const float dz = -doo / z;
    const float share = ad == floor_ ? 0.5f : 1.f;
    const float sgn = den > 0.f ? 1.f : (den < 0.f ? -1.f : 0.f);
    float dden = ad >= floor_ ? dz * share * sgn : 0.f;
    float dm = ad <= floor_ ? -dz * share * floor_ : 0.f;
    float invz = 1.f / z;
    float rowv = doo + dden * den;
    if (!valid) dden = dm = invz = rowv = 0.f;
    if (lane == 0) {
      pw[p] = invz;
      pw[sp + p] = dden;
      pw[2 * sp + p] = dm;
      pw[3 * sp + p] = rowv;
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int u = lane + 32 * x;
      wslot[t * Q + u] = w[x];
      wslot[Q * Q + t * Q + u] = (dnv[x] * invz + dden) * dd[x];
    }
  }
}

// ---- G. dq, dk, dv ----------------------------------------------------------
// mode 0 (dq): rows t, A = dS / sqrt(dh), X = k; Y = dout e^{G_{j-1} - G_t}
//   / (Z_t sqrt(dh)), M = C_j^T; + e^{G_{j-1} - G_t} dden_t / sqrt(dh) n_j.
// mode 1 (dk): rows u, A = dS^T / sqrt(dh), X = q; Y = v coeff_u, M =
//   dC_{j+1}^T; + coeff_u dn_{j+1}; and each row's share of k . dk.
// mode 2 (dv): rows u, A = (W / Z)^T, X = dout; Y = k coeff_u, M = dC_{j+1}.
// out[r][c] = sum_p A[r][p] X[p][c] + sum_e Y[r][e] M[e][c] (+ the n term),
// for the block's T columns c.
template <int DH>
struct GradTile {
  static constexpr int T = Tile<DH>::T;
  static constexpr int THREADS = Tile<DH>::THREADS;
  // A [Q p][Q r], X [Q][T], k [Q][T] (mode 1), Y slab [DK][Q], M slab
  // [DK][T], two row scales
  static constexpr size_t floats = Q * Q + 2 * Q * T + DK * Q + DK * T + 2 * Q;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(GradTile<DH>::THREADS)
mlstm_bwd_grads(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ gates,
                const float* __restrict__ pos, const float* __restrict__ wds,
                const float* __restrict__ cs, const float* __restrict__ ns,
                const float* __restrict__ dcs, const float* __restrict__ dns,
                float* __restrict__ dq, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ kdk, int s, int h,
                int nc, int j0, float scale) {
  constexpr int T = Tile<DH>::T;
  constexpr int TX = Tile<DH>::TX;
  constexpr int TILES = Tile<DH>::TILES;
  constexpr int NT = GradTile<DH>::THREADS;
  constexpr int T4 = T / 4;
  constexpr int MLOADS = DK * T4 / NT;   // float4s of an M slab a thread
  extern __shared__ __align__(16) float smem[];
  float* aq = smem;                 // [Q p][Q r]
  float* xs = aq + Q * Q;           // [Q p][T]
  float* xk = xs + Q * T;           // [Q r][T]: k (mode 1)
  float* ys = xk + Q * T;           // [DK][Q r]
  float* ms = ys + DK * Q;          // [DK][T]
  float* row_b = ms + DK * T;       // [Q]: Y's row scale
  float* row_c = row_b + Q;         // [Q]: the n term's row scale
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int mode = blockIdx.z / TILES, c0 = (blockIdx.z % TILES) * T;
  const int jl = blockIdx.x, j = j0 + jl;
  const int bh = blockIdx.y, nbh = gridDim.y, b = bh / h, head = bh % h;
  const int t0 = j * Q, len = min(Q, s - t0);
  const long long sp = static_cast<long long>(nc) * Q;
  const float* gw = gates + bh * gate_stride(nc);
  const float* inter = gw + 3 * sp;
  const float* coeff = gw + 4 * sp;
  const float* pw = pos + bh * NPOS * sp;
  const float* invz = pw;
  const float* dden = pw + sp;
  const long long slot = static_cast<long long>(jl) * nbh + bh;
  const float* wslot = wds + slot * 2 * Q * Q;

  // X (and k for mode 1) by cp.async, in flight while A is formed
  const float* xsrc = mode == 0 ? k : (mode == 1 ? q : dout);
  for (int e = tid; e < Q * T4; e += NT) {
    const int u = e / T4, c = 4 * (e % T4);
    const bool ok = u < len;
    const long long row =
        ((static_cast<long long>(b) * s + t0 + (ok ? u : 0)) * h + head) * DH +
        c0 + c;
    cp_async_16_or_zero(xs + u * T + c, xsrc + row, ok);
    if (mode == 1) cp_async_16_or_zero(xk + u * T + c, k + row, ok);
  }
  cp_async_commit();
  for (int r = tid; r < Q; r += NT) {
    const int p = t0 + r;
    if (mode == 0) {
      row_b[r] = scale * inter[p] * invz[p];
      row_c[r] = scale * inter[p] * dden[p];
    } else {
      row_b[r] = coeff[p];
      row_c[r] = mode == 1 ? coeff[p] : 0.f;
    }
  }
  for (int e = tid; e < Q * Q; e += NT) {
    const int t = e / Q, u = e % Q;
    if (mode == 0)
      aq[u * Q + t] = scale * wslot[Q * Q + e];
    else if (mode == 1)
      aq[e] = scale * wslot[Q * Q + e];
    else
      aq[e] = wslot[e] * invz[t0 + t];
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[4][8];
  zero(acc);
#pragma unroll 4
  for (int p = 0; p < Q; ++p) fma_step<T>(acc, aq + p * Q, xs + p * T, ty, tx);

  // sum_e Y[r][e] M[e][c] over slabs of DK
  const float* ysrc = mode == 0 ? dout : (mode == 1 ? v : k);
  const float* mst = (mode == 0 ? cs : dcs) + slot * DH * DH;
  Slab<NT> py;
  float4 pm[MLOADS];
  auto fetch_m = [&](int e0) {
#pragma unroll
    for (int l = 0; l < MLOADS; ++l) {
      const int e = tid + l * NT;
      if (mode == 2) {           // M[d][c] = dC[d][c0 + c]
        const int d = e / T4, c = 4 * (e % T4);
        pm[l] = *reinterpret_cast<const float4*>(
            mst + static_cast<long long>(e0 + d) * DH + c0 + c);
      } else {                   // M[e][c] = St[c0 + c][e]
        const int c = e / (DK / 4), d4 = e % (DK / 4);
        pm[l] = *reinterpret_cast<const float4*>(
            mst + static_cast<long long>(c0 + c) * DH + e0 + 4 * d4);
      }
    }
  };
  auto store_m = [&]() {
#pragma unroll
    for (int l = 0; l < MLOADS; ++l) {
      const int e = tid + l * NT;
      if (mode == 2) {
        *reinterpret_cast<float4*>(ms + (e / T4) * T + 4 * (e % T4)) = pm[l];
      } else {
        const int c = e / (DK / 4), d4 = e % (DK / 4);
        ms[(4 * d4 + 0) * T + c] = pm[l].x;
        ms[(4 * d4 + 1) * T + c] = pm[l].y;
        ms[(4 * d4 + 2) * T + c] = pm[l].z;
        ms[(4 * d4 + 3) * T + c] = pm[l].w;
      }
    }
  };
  py.fetch(ysrc, b, t0, s, h, head, DH, 0, tid);
  fetch_m(0);
  for (int e0 = 0; e0 < DH; e0 += DK) {
    __syncthreads();   // the slab before is used
    py.store_rows(ys, row_b, tid);
    store_m();
    __syncthreads();
    if (e0 + DK < DH) {
      py.fetch(ysrc, b, t0, s, h, head, DH, e0 + DK, tid);
      fetch_m(e0 + DK);
    }
#pragma unroll 8
    for (int d = 0; d < DK; ++d) fma_step<T>(acc, ys + d * Q, ms + d * T, ty, tx);
  }

  const float* nvec =
      mode == 0 ? ns + slot * DH : (mode == 1 ? dns + slot * DH : nullptr);
  float* dst = mode == 0 ? dq : (mode == 1 ? dk : dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float o[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      o[jj] = acc[i][jj];
      if (nvec != nullptr) o[jj] += row_c[r] * nvec[c0 + col<T>(tx, jj)];
    }
    if (r < len) {
      float* row = dst +
                   ((static_cast<long long>(b) * s + t0 + r) * h + head) * DH +
                   c0;
      *reinterpret_cast<float4*>(row + col<T>(tx, 0)) =
          make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(row + col<T>(tx, 4)) =
          make_float4(o[4], o[5], o[6], o[7]);
    }
    if (mode == 1) {
      float kd = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        kd = fmaf(o[jj], xk[r * T + col<T>(tx, jj)], kd);
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        kd += __shfl_xor_sync(FULL, kd, off);
      if (tx == 0)
        kdk[(bh * sp + t0 + r) * TILES + c0 / T] = r < len ? kd : 0.f;
    }
  }
}

// ---- D. the gates' gradients -------------------------------------------------
__global__ void __launch_bounds__(GB_THREADS)
mlstm_bwd_gates(const float* __restrict__ gates, const float* __restrict__ pos,
                const float* __restrict__ kdk, float* dli, float* dlf, int s,
                int h, int nc, int tiles) {
  __shared__ float sg[GB_WIN];
  __shared__ unsigned char srec[GB_WIN];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / h, head = bh % h;
  const long long sp = static_cast<long long>(nc) * Q;
  const float* gw = gates + bh * gate_stride(nc);
  const float* src = gw;
  const float* gg = gw + sp;
  const float* mt = gw + 2 * sp;
  const float* pw = pos + bh * NPOS * sp;
  const float* dm = pw + 2 * sp;
  const float* rowv = pw + 3 * sp;
  const long long base = static_cast<long long>(b) * s * h + head;
  // da = k . dk, and G's gradient summed over each run of one running max
  // into the run's first position (a new max: the later at a tie, as
  // torch.cummax)
  float acc = 0.f;
  int r = -1;
  for (int w0 = 0; w0 < s; w0 += GB_WIN) {
    const int wn = min(GB_WIN, s - w0);
    for (int i = tid; i < wn; i += GB_THREADS) {
      const int t = w0 + i;
      float da = 0.f;
      for (int x = 0; x < tiles; ++x) da += kdk[(bh * sp + t) * tiles + x];
      const float prev = (t % Q) != 0 ? gg[t - 1] : (t ? mt[t - 1] : M_INIT);
      dli[base + static_cast<long long>(t) * h] = da;
      sg[i] = dm[t] - rowv[t];
      srec[i] = src[t] >= prev;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < wn; ++i) {
        if (srec[i]) {
          if (r >= 0) dli[base + static_cast<long long>(r) * h] += acc;
          r = w0 + i;
          acc = 0.f;
        }
        acc += sg[i];
      }
      if (w0 + wn == s && r >= 0)
        dli[base + static_cast<long long>(r) * h] += acc;
    }
    __syncthreads();
  }
  // dlogf: the reverse running sum of dm - dlogi
  float run = 0.f;
  for (int w1 = s; w1 > 0; w1 -= GB_WIN) {
    const int w0 = max(0, w1 - GB_WIN), wn = w1 - w0;
    for (int i = tid; i < wn; i += GB_THREADS)
      sg[i] = dm[w0 + i] - dli[base + static_cast<long long>(w0 + i) * h];
    __syncthreads();
    if (tid == 0) {
      for (int i = wn - 1; i >= 0; --i) {
        run += sg[i];
        sg[i] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < wn; i += GB_THREADS)
      dlf[base + static_cast<long long>(w0 + i) * h] = sg[i];
    __syncthreads();
  }
}

#define CHECK_LAUNCH()                                         \
  do {                                                         \
    const cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_);        \
  } while (0)

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* li,
           const float* lf, const float* out, const float* dout, float* dq,
           float* dk, float* dv, float* dli, float* dlf, float* work,
           int batch, int s, int h, float scale, cudaStream_t stream) {
  constexpr int KS = score_splits<DH>();
  constexpr int T = Tile<DH>::T;
  constexpr int TILES = Tile<DH>::TILES;
  constexpr int WT = Tile<DH>::WALK_THREADS;
  constexpr size_t walk_bytes = 2 * 2 * Q * T * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_walk<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(walk_bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_grads<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(GradTile<DH>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const int nc = n_chunks(s), bh = batch * h;
  const int nw = (nc + SLOTS - 1) / SLOTS;
  const long long sp = static_cast<long long>(nc) * Q;
  const long long dd = static_cast<long long>(DH) * DH;
  Work w;
  workspace_floats(batch, s, h, DH, KS, TILES, work, &w);
  float* m0 = w.m01;
  float* m1 = w.m01 + bh;
  mlstm_bwd_fill<<<(bh + 255) / 256, 256, 0, stream>>>(m0, bh, M_INIT);
  CHECK_LAUNCH();
  if ((err = cudaMemsetAsync(w.ckc, 0, bh * dd * sizeof(float), stream)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(w.ckn, 0, bh * DH * sizeof(float), stream)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(w.dc, 0, bh * dd * sizeof(float), stream)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(w.dn, 0, bh * DH * sizeof(float), stream)) !=
          cudaSuccess)
    return static_cast<int>(err);
  // A. gates
  mlstm_bwd_fgates<<<bh, GATE_THREADS, 0, stream>>>(li, lf, m0, m1, w.gates,
                                                    s, h, nc);
  CHECK_LAUNCH();
  const dim3 wgrid(TILES * TILES, bh);
  const int coeff_off = static_cast<int>(4 * sp);
  const int inter_off = static_cast<int>(3 * sp);
  // K. the forward's states, a checkpoint at each window's start; the last
  // window's states stay in the slots
  for (int wi = 0; wi < nw; ++wi) {
    const int j0 = wi * SLOTS, jn = min(nc, j0 + SLOTS);
    mlstm_bwd_walk<DH><<<wgrid, WT, walk_bytes, stream>>>(
        k, v, w.gates, coeff_off, 1.f, nullptr, nullptr, w.ckc + wi * bh * dd,
        w.ckn + wi * bh * DH, w.ckc + (wi + 1) * bh * dd,
        w.ckn + (wi + 1) * bh * DH, w.cs, w.ns, wi == nw - 1, s, h, nc, j0,
        jn, 0);
    CHECK_LAUNCH();
  }
  for (int wi = nw - 1; wi >= 0; --wi) {
    const int j0 = wi * SLOTS, jn = min(nc, j0 + SLOTS), cn = jn - j0;
    if (wi != nw - 1) {
      // B. the window's states again from its checkpoint
      mlstm_bwd_walk<DH><<<wgrid, WT, walk_bytes, stream>>>(
          k, v, w.gates, coeff_off, 1.f, nullptr, nullptr,
          w.ckc + wi * bh * dd, w.ckn + wi * bh * DH,
          w.ckc + (wi + 1) * bh * dd, w.ckn + (wi + 1) * bh * DH, w.cs, w.ns,
          1, s, h, nc, j0, jn, 0);
      CHECK_LAUNCH();
    }
    // S. partial q k^T and dout v^T
    mlstm_bwd_scores<DH><<<dim3(cn, bh, KS), SCORE_THREADS, 0, stream>>>(
        q, k, w.scores, s, h, j0);
    CHECK_LAUNCH();
    mlstm_bwd_scores<DH><<<dim3(cn, bh, KS), SCORE_THREADS, 0, stream>>>(
        dout, v, w.dvs, s, h, j0);
    CHECK_LAUNCH();
    // R. per position
    mlstm_bwd_rows<DH><<<dim3(cn, bh), ROW_THREADS, 0, stream>>>(
        q, out, dout, w.gates, w.scores, w.dvs, w.ns, w.pos, w.wds, s, h, nc,
        j0, scale);
    CHECK_LAUNCH();
    // V. the reverse states, from the carry of the window after
    mlstm_bwd_walk<DH><<<wgrid, WT, walk_bytes, stream>>>(
        q, dout, w.gates, inter_off, scale, w.pos, w.pos + sp, w.dc, w.dn,
        w.dc, w.dn, w.dcs, w.dns, 1, s, h, nc, j0, jn, 1);
    CHECK_LAUNCH();
    // G. dq, dk, dv
    mlstm_bwd_grads<DH><<<dim3(cn, bh, 3 * TILES), GradTile<DH>::THREADS,
                          GradTile<DH>::bytes, stream>>>(
        q, k, v, dout, w.gates, w.pos, w.wds, w.cs, w.ns, w.dcs, w.dns, dq, dk,
        dv, w.kdk, s, h, nc, j0, scale);
    CHECK_LAUNCH();
  }
  // D. the gates' gradients
  mlstm_bwd_gates<<<bh, GB_THREADS, 0, stream>>>(w.gates, w.pos, w.kdk, dli,
                                                 dlf, s, h, nc, TILES);
  CHECK_LAUNCH();
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// The workspace, in floats, that mlstm_bwd_f32 takes for this shape (-1 for
// a head dim it does not take).
long long mlstm_bwd_workspace_floats(int batch, int s, int h, int dh) {
  Work w;
  switch (dh) {
    case 32: return workspace_floats(batch, s, h, 32, score_splits<32>(),
                                     Tile<32>::TILES, nullptr, &w);
    case 64: return workspace_floats(batch, s, h, 64, score_splits<64>(),
                                     Tile<64>::TILES, nullptr, &w);
    case 128: return workspace_floats(batch, s, h, 128, score_splits<128>(),
                                      Tile<128>::TILES, nullptr, &w);
    case 512: return workspace_floats(batch, s, h, 512, score_splits<512>(),
                                      Tile<512>::TILES, nullptr, &w);
    default: return -1;
  }
}

// q, k, v, out, dout, dq, dk, dv (B, S, H, dh), logi, logf, dlogi, dlogf
// (B, S, H): contiguous float32, q, k, v, out, dout 16-byte aligned.
// S >= 2.  `work`: mlstm_bwd_workspace_floats(...) floats, 16-byte aligned,
// not used by another call in flight.  The outputs do not alias the inputs.
int mlstm_bwd_f32(const void* q, const void* k, const void* v,
                  const void* gate_i, const void* gate_f, const void* out,
                  const void* dout, void* dq, void* dk, void* dv, void* dli,
                  void* dlf, void* work, int batch, int s, int h, int dh,
                  float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (s < 2) return static_cast<int>(cudaErrorInvalidValue);
#define MLSTM_BWD_ARGS                                                      \
  static_cast<const float*>(q), static_cast<const float*>(k),               \
      static_cast<const float*>(v), static_cast<const float*>(gate_i),      \
      static_cast<const float*>(gate_f), static_cast<const float*>(out),    \
      static_cast<const float*>(dout), static_cast<float*>(dq),             \
      static_cast<float*>(dk), static_cast<float*>(dv),                     \
      static_cast<float*>(dli), static_cast<float*>(dlf),                   \
      static_cast<float*>(work), batch, s, h, scale, st
  switch (dh) {
    case 32: return launch<32>(MLSTM_BWD_ARGS);
    case 64: return launch<64>(MLSTM_BWD_ARGS);
    case 128: return launch<128>(MLSTM_BWD_ARGS);
    case 512: return launch<512>(MLSTM_BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLSTM_BWD_ARGS
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
