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
// ~137 GFLOP, ~2.05 ms at 67 TFLOP/s on the CUDA cores, ~0.83 ms as three
// TF32 passes at the tensor cores' 495 TFLOP/s; the bytes (q, k, v, out,
// dout and the gradients, ~0.6 GB) take ~0.18 ms.
//
// Design: every dh^2 product on the tensor cores at f32 accuracy (three
// TF32 passes, mlstm.cuh), each state walked once, in seven launches:
//   A. gates, one block per (batch row, head): the forward's pass;
//   N. each chunk's own share of n, sum_p e^{a_p - G_end} k_p, one block per
//      (chunk, head);
//   R. per chunk (a block per (chunk, head)): q k^T and dout v^T on the
//      tensor cores; n entering the chunk from N's shares; per position
//      (a warp a position) W and its row sum, q . n, dout . out, den, Z,
//      dden, dm and dS; out to device memory go the per-position scalars
//      and each consumer's 64 x 64 A operand: dS / sqrt(dh) for dq, its
//      transpose for dk, (W / Z)^T for dv;
//   W. the two walks, one launch, a block per (64 rows of the state, head,
//      direction), the block's 64 x dh rows of the state in shared memory:
//      forward, C from the first chunk to the last, each chunk's dq columns
//      from C entering it (dout C^T) and the chunk's dS k; reverse, dC from
//      the last chunk to the first, each chunk's dk columns from dC leaving
//      it (v dC^T), dS^T q and dn, their share of k . dk, and dC leaving the
//      chunk written once for dv;
//   V. dv, a block per (chunk, head, 64 columns): k dC leaving the chunk and
//      (W / Z)^T dout;
//   D. the gates' gradients, one block per (batch row, head): k . dk summed
//      over the column blocks in order, G's gradient run-summed to each new
//      running max, and the reverse running sum for dlogf, both as scans of
//      (a, b) pairs in a fixed tree order.
// A walk streams the chunk's 64 positions of the two wide operands in
// pieces of 32 columns (double-buffered cp.async); each warp owns 16 rows x
// 16 columns of each piece, so the dq (dk) product reads the state tile the
// warp is about to update, from its registers, and no warp waits on
// another within a chunk; the two halves of the product meet in shared
// memory once a chunk, in a fixed order.  A product over more than one
// piece (the walks', dv's, the scores) is summed a piece at a time in a fresh
// accumulator and added in f32 arithmetic: the tensor cores' own
// accumulation drifts toward zero over many products (summed whole, dlogf
// came to 8.2e-5 of its largest at the training shape against the plain
// version, 5.1e-5 this way, the CUDA-core kernel's 5.0e-5).  Every sum runs
// in a fixed order, with no atomics: two calls give the same bits.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mlstm.cuh"

namespace {

using namespace mlstm;
using hopper::cp_async_16;

constexpr int NPOS = 4;          // per position: 1/Z, dden, dm, q . dq
constexpr float EPS = 1e-6f;
constexpr float M_INIT = -1e30f;
constexpr int GB_THREADS = 256;
constexpr int GB_PER = 8;        // positions a thread of the gates' pass
constexpr int GB_WIN = GB_THREADS * GB_PER;   // positions a window of it
constexpr int NMAT = 3;          // A operands a chunk: dq's, dk's, dv's
constexpr int LA = Q + 4;        // row stride of a staged A operand
constexpr int PE = 32;           // columns of a piece
constexpr int LP = PE + 8;       // row stride of a staged piece
constexpr int KSUM_THREADS = 128;

template <int DH>
struct Walk {
  static constexpr int RT = DH < 64 ? DH : 64;   // state rows a block
  static constexpr int TILES = DH / RT;
  static constexpr int RW = RT / 16;             // warps along the rows
  static constexpr int THREADS = 64 * RW;        // and two along the columns
  static constexpr int NP = DH / PE;             // pieces a chunk
  static constexpr int LX = DH + 8;              // state row stride
  static constexpr int LXK = RT + 8;             // chunk tile row stride
  static constexpr int STAGE = 2 * Q * LP;       // a piece of each operand
  static constexpr size_t floats =
      RT * LX + 2 * STAGE + Q * LXK + Q * LA + 4 * Q + RT + RW * Q;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int DH>
struct Rows {
  static constexpr int THREADS = 256;
  static constexpr int LD = PE + 4;              // staged operand row stride
  static constexpr int STAGE = 4 * Q * LD;       // q, k, dout, v pieces
  static constexpr int LS = Q + 1;               // S and P tiles' stride
  static constexpr size_t bytes = (2 * STAGE + DH) * sizeof(float);
};

template <int DH>
struct Dv {
  static constexpr int ET = DH < 64 ? DH : 64;   // dv columns a block
  static constexpr int THREADS = 128;            // 2 warps along u x 2 along e
  static constexpr int NTW = ET / 16;            // n-tiles a warp
  static constexpr int LK = PE + 4;              // k piece [Q][LK]
  static constexpr int LC = ET + 8;              // dC piece, dout tile
  static constexpr int STAGE = Q * LK + PE * LC;
  static constexpr size_t bytes =
      (2 * STAGE + Q * LA + Q * LC + Q) * sizeof(float);
};

struct Work {
  float* gates;   // [B H][gate_stride]
  float* pos;     // [B H][NPOS][padded S]
  float* kdk;     // [B H][padded S][row tiles]: k . dk by tile
  float* m01;     // [2][B H]: the gates pass's m in (M_INIT) and out
  float* ksum;    // [chunk][B H][dh]: each chunk's share of n
  float* amat;    // [chunk][B H][NMAT][Q][Q]: the A operands
  float* dcs;     // [chunk][B H][dh][dh]: dC leaving each chunk
};

long long workspace_floats(int batch, int s, int h, int dh, int tiles,
                           float* base, Work* w) {
  const int nc = n_chunks(s);
  const long long bh = static_cast<long long>(batch) * h;
  const long long sp = static_cast<long long>(nc) * Q;
  const long long sizes[] = {bh * gate_stride(nc), bh * NPOS * sp,
                             bh * sp * tiles,      2 * bh,
                             nc * bh * dh,         nc * bh * NMAT * Q * Q,
                             nc * bh * dh * dh};
  float** parts[] = {&w->gates, &w->pos,  &w->kdk, &w->m01,
                     &w->ksum,  &w->amat, &w->dcs};
  long long off = 0;
  for (int i = 0; i < 7; ++i) {
    if (base != nullptr) *parts[i] = base + off;
    off += round_up(sizes[i], 64);
  }
  return off;
}

__device__ __forceinline__ long long row_of(int b, int t, int s, int h,
                                            int head, int dh) {
  return ((static_cast<long long>(b) * s + t) * h + head) * dh;
}

__global__ void mlstm_bwd_fill(float* x, int n, float value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = value;
}

// A: the forward's pass (mlstm.cuh), under a name of this file's
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_bwd_fgates(const float* __restrict__ gate_i,
                 const float* __restrict__ gate_f, const float* __restrict__ m0,
                 float* __restrict__ m1, float* __restrict__ gates, int s,
                 int h, int nc) {
  gates_pass(gate_i, gate_f, m0, m1, gates, s, h, nc, 0);
}

// ---- N. each chunk's share of n ---------------------------------------------
__global__ void __launch_bounds__(KSUM_THREADS)
mlstm_bwd_ksum(const float* __restrict__ k, const float* __restrict__ gates,
               float* __restrict__ ksum, int s, int h, int nc, int dh) {
  const int j = blockIdx.x, bh = blockIdx.y, nbh = gridDim.y;
  const int b = bh / h, head = bh % h;
  const int t0 = j * Q, len = min(Q, s - t0);
  const float* coeff = gates + bh * gate_stride(nc) + 4LL * nc * Q + t0;
  float* dst = ksum + (static_cast<long long>(j) * nbh + bh) * dh;
  for (int d = threadIdx.x; d < dh; d += KSUM_THREADS) {
    float acc = 0.f;
    for (int p = 0; p < len; ++p)
      acc = fmaf(coeff[p], k[row_of(b, t0 + p, s, h, head, dh) + d], acc);
    dst[d] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// ---- R. per chunk: the scores, the per-position scalars, the A operands ----
template <int DH>
__global__ void __launch_bounds__(Rows<DH>::THREADS)
mlstm_bwd_rows(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ out,
               const float* __restrict__ dout,
               const float* __restrict__ gates,
               const float* __restrict__ ksum, float* __restrict__ pos,
               float* __restrict__ amat, int s, int h, int nc, float scale) {
  using R = Rows<DH>;
  constexpr int NT = R::THREADS, LD = R::LD, LS = R::LS;
  extern __shared__ __align__(16) float smem[];
  float* nj = smem + 2 * R::STAGE;   // [DH]: n entering the chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int j = blockIdx.x, bh = blockIdx.y, nbh = gridDim.y;
  const int b = bh / h, head = bh % h;
  const int t0 = j * Q, len = min(Q, s - t0);
  const long long sp = static_cast<long long>(nc) * Q;
  const float* gw = gates + bh * gate_stride(nc);
  const float* src = gw;
  const float* gg = gw + sp;
  const float* mt = gw + 2 * sp;
  const float* inter = gw + 3 * sp;
  const float* decay = gw + NGATE * sp;

  // four pieces of PE columns: q, k, dout, v rows of the chunk
  auto load = [&](int d0, int st) {
    float* base = smem + st * R::STAGE;
    const float* srcs[4] = {q, k, dout, v};
    for (int e = tid; e < 4 * Q * (PE / 4); e += NT) {
      const int m = e / (Q * (PE / 4)), r = e % (Q * (PE / 4));
      const int u = r / (PE / 4), c = 4 * (r % (PE / 4));
      const bool ok = u < len;
      cp_async_16_or_zero(
          base + (m * Q + u) * LD + c,
          srcs[m] + row_of(b, t0 + (ok ? u : 0), s, h, head, DH) + d0 + c,
          ok);
    }
    cp_async_commit();
  };
  load(0, 0);
  // n entering the chunk: the chunks' shares before it, decayed in order
  for (int d = tid; d < DH; d += NT) {
    float n = 0.f;
    for (int i = 0; i < j; ++i)
      n = fmaf(decay[i], n, ksum[(static_cast<long long>(i) * nbh + bh) * DH +
                                 d]);
    nj[d] = n;
  }

  // warps 0-3: S = q k^T, warps 4-7: P = dout v^T; a 32 x 32 quarter each
  const int which = warp >> 2, mh = warp & 1, nh = (warp >> 1) & 1;
  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][c][x] = 0.f;
  constexpr int NPC = DH / PE;
  for (int i = 0; i < NPC; ++i) {
    if (i + 1 < NPC) {
      load(PE * (i + 1), (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = smem + (i & 1) * R::STAGE + (2 * which) * Q * LD;
    const float* bs = as + Q * LD;
    float part[2][4][4] = {};   // the piece's share, added in f32
#pragma unroll
    for (int ks = 0; ks < PE / 8; ++ks) {
      FragA fa[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* r0 = as + (32 * mh + 16 * m + g) * LD + 8 * ks + t4;
        fa[m] = frag_a(r0[0], r0[8 * LD], r0[4], r0[8 * LD + 4]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* c0 = bs + (32 * nh + 8 * n + g) * LD + 8 * ks + t4;
        const FragB fb = frag_b(c0[0], c0[4]);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(part[m][n], fa[m], fb);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] += part[m][n][c];
    __syncthreads();   // the stage is refilled by the next load
  }
  // S and P into shared memory (the stages are free)
  float* sm = smem;              // [Q][LS]: S, then W / Z
  float* pm = smem + Q * LS;     // [Q][LS]: P, then dS / sqrt(dh)
  {
    float* dst = which ? pm : sm;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int r = 32 * mh + 16 * m + g, c = 32 * nh + 8 * n + 2 * t4;
        dst[r * LS + c] = acc[m][n][0];
        dst[r * LS + c + 1] = acc[m][n][1];
        dst[(r + 8) * LS + c] = acc[m][n][2];
        dst[(r + 8) * LS + c + 1] = acc[m][n][3];
      }
  }
  __syncthreads();

  float* pw = pos + bh * NPOS * sp;
  for (int t = warp; t < Q; t += NT / 32) {
    const int p = t0 + t;
    const bool valid = t < len;
    const float gt = gg[p];
    float w[2], dnv[2], dd[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int u = lane + 32 * x;
      dd[x] = (valid && u <= t) ? expf(src[t0 + u] - gt) : 0.f;
      w[x] = sm[t * LS + u] * scale * dd[x];
      dnv[x] = pm[t * LS + u];
    }
    float qn = 0.f, doo = 0.f;
    if (valid) {
      const long long row = row_of(b, p, s, h, head, DH);
      for (int d = lane; d < DH; d += 32) {
        qn = fmaf(q[row + d], nj[d], qn);
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
      sm[t * LS + u] = w[x] * invz;
      pm[t * LS + u] = scale * (dnv[x] * invz + dden) * dd[x];
    }
  }
  __syncthreads();
  // the A operands: dq's dS / sqrt(dh) [t][u], dk's its transpose [u][t],
  // dv's (W / Z)^T [u][t]
  float* am = amat + (static_cast<long long>(j) * nbh + bh) * NMAT * Q * Q;
  for (int e = tid; e < Q * Q; e += NT) {
    const int r = e / Q, c = e % Q;
    am[e] = pm[r * LS + c];
    am[Q * Q + e] = pm[c * LS + r];
    am[2 * Q * Q + e] = sm[c * LS + r];
  }
}

// ---- W. the walks -------------------------------------------------------------
// Direction 0 (forward): X = C, rows r of the block's column slice of k;
//   X = decay_j X + sum_p (e^{a_p - G_end} k_p)[r] v_p, and before it
//   dq_t[r] = e^{G_{j-1} - G_t} / (Z_t sqrt(dh)) sum_e dout_t[e] X[r][e]
//             + (dS k / sqrt(dh))_t[r] + e^{G_{j-1} - G_t} dden_t / sqrt(dh)
//               n_j[r].
// Direction 1 (reverse): X = dC, rows d of the slice of q;
//   X = decay_j X + sum_t (e^{G_{j-1} - G_t} q_t / (Z_t sqrt(dh)))[d] dout_t,
//   and before it dk_u[d] = e^{a_u - G_end} (sum_e v_u[e] X[d][e] + dn[d])
//             + (dS^T q / sqrt(dh))_u[d]; X goes to dcs for dv.
// Both: the chunk's own term's A operand (R's) against the chunk's x rows.
template <int DH>
__global__ void __launch_bounds__(Walk<DH>::THREADS, 1)
mlstm_bwd_walk(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ gates, const float* __restrict__ pos,
               const float* __restrict__ ksum, const float* __restrict__ amat,
               float* __restrict__ dq, float* __restrict__ dk,
               float* __restrict__ kdk, float* __restrict__ dcs, int s,
               int h, int nc, float scale) {
  using W = Walk<DH>;
  constexpr int RT = W::RT, RW = W::RW, NT = W::THREADS, NP = W::NP;
  constexpr int LX = W::LX, LXK = W::LXK;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // [RT][LX]: the state's rows
  float* stage = xs + RT * LX;         // [2][z piece [Q][LP], y piece]
  float* xt = stage + 2 * W::STAGE;    // [Q][LXK]: the chunk's x columns
  float* at = xt + Q * LXK;            // [Q][LA]: the chunk's A operand
  float* ca = at + Q * LA;             // [Q]: the update's coefficients
  float* rsv = ca + Q;                 // [Q]: the product's row scales
  float* rcn = rsv + Q;                // [Q]: the n term's row scales
  float* wdn = rcn + Q;                // [Q]: dn's weights (reverse)
  float* nin = wdn + Q;                // [RT]: n (dn) before the chunk
  float* kd = nin + RT;                // [RW][Q]: k . dk by warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = warp % RW, hw = warp / RW;
  const int rt = blockIdx.x, r0 = rt * RT;
  const int bh = blockIdx.y, nbh = gridDim.y, b = bh / h, head = bh % h;
  const bool rev = blockIdx.z != 0;
  const float* x = rev ? q : k;        // the update's rows
  const float* y = rev ? dout : v;     // the update's columns
  const float* z = rev ? v : dout;     // the product's rows
  float* dst = rev ? dk : dq;
  const int mat = rev ? 1 : 0;
  const long long sp = static_cast<long long>(nc) * Q;
  const float* gw = gates + bh * gate_stride(nc);
  const float* inter = gw + 3 * sp;
  const float* coeff = gw + 4 * sp;
  const float* decay = gw + NGATE * sp;
  const float* pw = pos + bh * NPOS * sp;
  const float* invz = pw;
  const float* ddn = pw + sp;

  auto load_tiles = [&](int j) {
    const int t0 = j * Q, len = min(Q, s - t0);
    for (int e = tid; e < Q * (RT / 4); e += NT) {
      const int u = e / (RT / 4), c = 4 * (e % (RT / 4));
      const bool ok = u < len;
      cp_async_16_or_zero(
          xt + u * LXK + c,
          x + row_of(b, t0 + (ok ? u : 0), s, h, head, DH) + r0 + c, ok);
    }
    const float* am =
        amat + ((static_cast<long long>(j) * nbh + bh) * NMAT + mat) * Q * Q;
    for (int e = tid; e < Q * (Q / 4); e += NT) {
      const int u = e / (Q / 4), c = 4 * (e % (Q / 4));
      cp_async_16(at + u * LA + c, am + u * Q + c);
    }
  };
  auto load_piece = [&](int j, int i, int st) {
    const int t0 = j * Q, len = min(Q, s - t0);
    float* zs = stage + st * W::STAGE;
    float* ys = zs + Q * LP;
    for (int e = tid; e < Q * (PE / 4); e += NT) {
      const int u = e / (PE / 4), c = 4 * (e % (PE / 4));
      const bool ok = u < len;
      const long long row =
          row_of(b, t0 + (ok ? u : 0), s, h, head, DH) + PE * i + c;
      cp_async_16_or_zero(zs + u * LP + c, z + row, ok);
      cp_async_16_or_zero(ys + u * LP + c, y + row, ok);
    }
  };

  for (int e = tid; e < RT * LX; e += NT) xs[e] = 0.f;
  float nrun = 0.f;   // thread r < RT: n (dn) entering the next chunk
  const int jfirst = rev ? nc - 1 : 0;
  load_tiles(jfirst);
  load_piece(jfirst, 0, 0);
  cp_async_commit();
  int item = 0;       // pieces walked, over all chunks: the stage's parity
  for (int ci = 0; ci < nc; ++ci) {
    const int j = rev ? nc - 1 - ci : ci;
    const int jn = rev ? j - 1 : j + 1;
    const bool more = ci + 1 < nc;
    const int t0 = j * Q, len = min(Q, s - t0);
    for (int p = tid; p < Q; p += NT) {
      const int t = t0 + p;   // padded positions carry zeros
      const float co = coeff[t];
      const float qz = scale * inter[t] * invz[t];
      const float qd = scale * inter[t] * ddn[t];
      ca[p] = rev ? qz : co;
      rsv[p] = rev ? co : qz;
      rcn[p] = rev ? co : qd;
      wdn[p] = qd;
    }
    cp_async_wait<0>();
    __syncthreads();
    const float dc = decay[j];
    if (tid < RT) {
      nin[tid] = nrun;
      float add = 0.f;
      if (rev) {
        for (int p = 0; p < Q; ++p) add = fmaf(wdn[p], xt[p * LXK + tid], add);
      } else {
        add = ksum[(static_cast<long long>(j) * nbh + bh) * DH + r0 + tid];
      }
      nrun = fmaf(dc, nrun, add);
    }
    // the update's A operand, x^T scaled by position, held for the chunk
    FragA ka[Q / 8];
#pragma unroll
    for (int ks = 0; ks < Q / 8; ++ks) {
      const int p0 = 8 * ks + t4, r = 16 * rw + g;
      const float c0 = ca[p0], c1 = ca[p0 + 4];
      ka[ks] = frag_a(c0 * xt[p0 * LXK + r], c0 * xt[p0 * LXK + r + 8],
                      c1 * xt[(p0 + 4) * LXK + r],
                      c1 * xt[(p0 + 4) * LXK + r + 8]);
    }
    // the chunk's own term, this warp's half of its 64 positions
    float ai[4][2][4], acc[4][2][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) ai[m][n][c] = acc[m][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int u0 = 32 * hw + 8 * kk + t4;
      FragB fb[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r = 16 * rw + 8 * n + g;
        fb[n] = frag_b(xt[u0 * LXK + r], xt[(u0 + 4) * LXK + r]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* a0 = at + (16 * m + g) * LA + u0;
        const FragA fa = frag_a(a0[0], a0[8 * LA], a0[4], a0[8 * LA + 4]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma3(ai[m][n], fa, fb[n]);
      }
    }
    for (int i = 0; i < NP; ++i, ++item) {
      __syncthreads();   // the stage refilled below is used; at i = 0 the
                         // chunk's tiles are too
      if (i + 1 < NP)
        load_piece(j, i + 1, (item + 1) & 1);
      else if (more)
        load_piece(jn, 0, (item + 1) & 1);
      if (i == 0 && more) load_tiles(jn);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* zs = stage + (item & 1) * W::STAGE;
      const float* ys = zs + Q * LP;
      const int cl = 16 * hw;           // this warp's columns in the piece
      const int e0 = PE * i + cl;       // and in the state
      float xa[2][4];
      float* xr0 = xs + (16 * rw + g) * LX + e0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 lo = *reinterpret_cast<const float2*>(xr0 + 8 * n);
        const float2 hi = *reinterpret_cast<const float2*>(xr0 + 8 * LX + 8 * n);
        xa[n][0] = lo.x;
        xa[n][1] = lo.y;
        xa[n][2] = hi.x;
        xa[n][3] = hi.y;
      }
      if (rev) {   // dC leaving chunk j, for dv
        float* dr = dcs +
                    ((static_cast<long long>(j) * nbh + bh) * DH + r0 +
                     16 * rw + g) * DH + e0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          *reinterpret_cast<float2*>(dr + 8 * n) = make_float2(xa[n][0], xa[n][1]);
          *reinterpret_cast<float2*>(dr + 8 * DH + 8 * n) =
              make_float2(xa[n][2], xa[n][3]);
        }
      }
      // the product over this warp's 16 columns, the state from registers
      // (k columns 2 t, 2 t + 1 of each 8)
      FragB xb[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        xb[n][0] = frag_b(xa[n][0], xa[n][1]);
        xb[n][1] = frag_b(xa[n][2], xa[n][3]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float part[2][4] = {};   // the piece's share, added in f32
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* zr = zs + (16 * m + g) * LP + cl + 8 * kk + 2 * t4;
          const float2 z0 = *reinterpret_cast<const float2*>(zr);
          const float2 z1 = *reinterpret_cast<const float2*>(zr + 8 * LP);
          const FragA fa = frag_a(z0.x, z1.x, z0.y, z1.y);
#pragma unroll
          for (int n = 0; n < 2; ++n) mma3(part[n], fa, xb[kk][n]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][n][c] += part[n][c];
      }
      // the update: X = decay X + x^T y over the chunk's 64 positions, the
      // chunk's sum in fresh accumulators (the big and the small passes
      // apart), the state's own update in f32 arithmetic
      float big[2][4], small[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) big[n][c] = small[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < Q / 8; ++ks) {
        const int p0 = 8 * ks + t4;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int c = cl + 8 * n + g;
          const FragB fb = frag_b(ys[p0 * LP + c], ys[(p0 + 4) * LP + c]);
          mma_small(small[n], ka[ks], fb);
          mma_tf32(big[n], ka[ks].hi, fb.hi);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float2* lo = reinterpret_cast<float2*>(xr0 + 8 * n);
        float2* hi = reinterpret_cast<float2*>(xr0 + 8 * LX + 8 * n);
        const float2 x0 = *lo, x1 = *hi;
        *lo = make_float2(fmaf(dc, x0.x, big[n][0] + small[n][0]),
                          fmaf(dc, x0.y, big[n][1] + small[n][1]));
        *hi = make_float2(fmaf(dc, x1.x, big[n][2] + small[n][2]),
                          fmaf(dc, x1.y, big[n][3] + small[n][3]));
      }
    }
    // the chunk's rows: each warp's product scaled by position plus its half
    // of the chunk's own term; the column halves meet in the last stage
    __syncthreads();
    constexpr int LE = RT + 8;
    float* ex = stage + ((item - 1) & 1) * W::STAGE;   // [Q][LE]
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int tr = 16 * m + g + 8 * hr;
        const float sc = rsv[tr];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[m][n][2 * hr] = fmaf(sc, acc[m][n][2 * hr], ai[m][n][2 * hr]);
          acc[m][n][2 * hr + 1] =
              fmaf(sc, acc[m][n][2 * hr + 1], ai[m][n][2 * hr + 1]);
          if (hw == 1)
            *reinterpret_cast<float2*>(ex + tr * LE + 16 * rw + 8 * n +
                                       2 * t4) =
                make_float2(acc[m][n][2 * hr], acc[m][n][2 * hr + 1]);
        }
      }
    __syncthreads();
    if (hw == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int tr = 16 * m + g + 8 * hr;
          const bool ok = tr < len;
          const long long row = row_of(b, t0 + (ok ? tr : 0), s, h, head, DH);
          float kdot = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = 16 * rw + 8 * n + 2 * t4;
            const float2 o =
                *reinterpret_cast<const float2*>(ex + tr * LE + c);
            const float v0 = acc[m][n][2 * hr] + o.x + rcn[tr] * nin[c];
            const float v1 =
                acc[m][n][2 * hr + 1] + o.y + rcn[tr] * nin[c + 1];
            if (ok) {
              *reinterpret_cast<float2*>(dst + row + r0 + c) =
                  make_float2(v0, v1);
              if (rev) {
                const float2 kv =
                    *reinterpret_cast<const float2*>(k + row + r0 + c);
                kdot = fmaf(v0, kv.x, kdot);
                kdot = fmaf(v1, kv.y, kdot);
              }
            }
          }
          if (rev) {
            kdot += __shfl_xor_sync(FULL, kdot, 1);
            kdot += __shfl_xor_sync(FULL, kdot, 2);
            if (t4 == 0) kd[rw * Q + tr] = kdot;
          }
        }
    }
    __syncthreads();
    if (rev && tid < Q) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < RW; ++w) sum += kd[w * Q + tid];
      kdk[(bh * sp + t0 + tid) * W::TILES + rt] = tid < len ? sum : 0.f;
    }
    __syncthreads();   // the chunk's scalars are read
  }
}

// ---- V. dv -------------------------------------------------------------------
// dv_u[e] = e^{a_u - G_end} sum_d k_u[d] dC_{j+1}[d][e] + ((W / Z)^T dout)_u[e]
template <int DH>
__global__ void __launch_bounds__(Dv<DH>::THREADS)
mlstm_bwd_dv(const float* __restrict__ k, const float* __restrict__ dout,
             const float* __restrict__ gates, const float* __restrict__ amat,
             const float* __restrict__ dcs, float* __restrict__ dv, int s,
             int h, int nc) {
  using V = Dv<DH>;
  constexpr int ET = V::ET, NT = V::THREADS, NTW = V::NTW, LK = V::LK;
  constexpr int LC = V::LC, NPC = DH / PE;
  extern __shared__ __align__(16) float smem[];
  float* at = smem + 2 * V::STAGE;   // [Q][LA]: (W / Z)^T
  float* dt = at + Q * LA;           // [Q][LC]: the chunk's dout columns
  float* cf = dt + Q * LC;           // [Q]: e^{a_u - G_end}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mh = warp & 1, nh = warp >> 1;
  const int j = blockIdx.x, bh = blockIdx.y, nbh = gridDim.y;
  const int e0 = blockIdx.z * ET;
  const int b = bh / h, head = bh % h;
  const int t0 = j * Q, len = min(Q, s - t0);
  const long long sp = static_cast<long long>(nc) * Q;
  const float* coeff = gates + bh * gate_stride(nc) + 4 * sp + t0;
  const float* dc =
      dcs + (static_cast<long long>(j) * nbh + bh) * DH * DH + e0;

  {   // the chunk's own term's operands
    const float* am =
        amat + ((static_cast<long long>(j) * nbh + bh) * NMAT + 2) * Q * Q;
    for (int e = tid; e < Q * (Q / 4); e += NT) {
      const int u = e / (Q / 4), c = 4 * (e % (Q / 4));
      cp_async_16(at + u * LA + c, am + u * Q + c);
    }
    for (int e = tid; e < Q * (ET / 4); e += NT) {
      const int u = e / (ET / 4), c = 4 * (e % (ET / 4));
      const bool ok = u < len;
      cp_async_16_or_zero(
          dt + u * LC + c,
          dout + row_of(b, t0 + (ok ? u : 0), s, h, head, DH) + e0 + c, ok);
    }
    for (int u = tid; u < Q; u += NT) cf[u] = coeff[u];
  }
  auto load = [&](int i, int st) {
    float* ks = smem + st * V::STAGE;
    float* cs = ks + Q * LK;
    const int d0 = PE * i;
    for (int e = tid; e < Q * (PE / 4); e += NT) {
      const int u = e / (PE / 4), c = 4 * (e % (PE / 4));
      const bool ok = u < len;
      cp_async_16_or_zero(
          ks + u * LK + c,
          k + row_of(b, t0 + (ok ? u : 0), s, h, head, DH) + d0 + c, ok);
    }
    for (int e = tid; e < PE * (ET / 4); e += NT) {
      const int d = e / (ET / 4), c = 4 * (e % (ET / 4));
      cp_async_16(cs + d * LC + c,
                  dc + static_cast<long long>(d0 + d) * DH + c);
    }
    cp_async_commit();
  };
  load(0, 0);

  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;
  for (int i = 0; i < NPC; ++i) {
    if (i + 1 < NPC) {
      load(i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smem + (i & 1) * V::STAGE;
    const float* cs = ks + Q * LK;
    float part[2][NTW][4] = {};   // the piece's share, added in f32
#pragma unroll
    for (int kk = 0; kk < PE / 8; ++kk) {
      FragA fa[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* a0 = ks + (32 * mh + 16 * m + g) * LK + 8 * kk + t4;
        fa[m] = frag_a(a0[0], a0[8 * LK], a0[4], a0[8 * LK + 4]);
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* b0 = cs + (8 * kk + t4) * LC + (ET / 2) * nh + 8 * n + g;
        const FragB fb = frag_b(b0[0], b0[4 * LC]);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(part[m][n], fa[m], fb);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] += part[m][n][c];
    __syncthreads();   // the stage is refilled by the next load
  }
  // scaled by position, then the chunk's own term
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int u = 32 * mh + 16 * m + g;
    const float c0 = cf[u], c1 = cf[u + 8];
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      acc[m][n][0] *= c0;
      acc[m][n][1] *= c0;
      acc[m][n][2] *= c1;
      acc[m][n][3] *= c1;
    }
  }
  float part[2][NTW][4] = {};
#pragma unroll
  for (int kk = 0; kk < Q / 8; ++kk) {
    FragA fa[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* a0 = at + (32 * mh + 16 * m + g) * LA + 8 * kk + t4;
      fa[m] = frag_a(a0[0], a0[8 * LA], a0[4], a0[8 * LA + 4]);
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const float* b0 = dt + (8 * kk + t4) * LC + (ET / 2) * nh + 8 * n + g;
      const FragB fb = frag_b(b0[0], b0[4 * LC]);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma3(part[m][n], fa[m], fb);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] += part[m][n][c];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int u = 32 * mh + 16 * m + g + 8 * hr;
      if (u >= len) continue;
      float* row = dv + row_of(b, t0 + u, s, h, head, DH) + e0 + (ET / 2) * nh;
#pragma unroll
      for (int n = 0; n < NTW; ++n)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * t4) =
            make_float2(acc[m][n][2 * hr], acc[m][n][2 * hr + 1]);
    }
}

// ---- D. the gates' gradients -------------------------------------------------
// Two reverse recurrences x_t = b_t + a_t x_{t+1} over the positions: G's
// gradient summed over each run of one running max into its first position,
// R_t = (dm_t - rowv_t) + [t + 1 is no new max] R_{t+1}, dlogi_t = k . dk
// + [t is a new max] R_t (a new max: the later at a tie, as torch.cummax);
// and dlogf_t = (dm_t - dlogi_t) + dlogf_{t+1}.  Each is a scan of the pairs
// (a, b), composed (a1, b1) o (a2, b2) = (a1 a2, b1 + a1 b2): a thread's 8
// positions in turn, a warp's threads by shuffles, the warps' totals from
// the last warp back, a window of 2048 positions at a time from the last,
// the carry from the window after entering at its end.  A fixed order.

// the composition of the threads after this one in the block (identity for
// the last), given this thread's pair
__device__ __forceinline__ void after_scan(float a, float b, float& ea,
                                           float& eb, float* sa, float* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float oa = __shfl_down_sync(FULL, a, off);
    const float ob = __shfl_down_sync(FULL, b, off);
    if (lane + off < 32) {
      b = fmaf(a, ob, b);
      a *= oa;
    }
  }
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  float ta = 1.f, tb = 0.f;   // the warps after this one
  for (int w = GB_THREADS / 32 - 1; w > warp; --w) {
    tb = fmaf(sa[w], tb, sb[w]);
    ta *= sa[w];
  }
  const float ia = a * ta, ib = fmaf(a, tb, b);
  ea = __shfl_down_sync(FULL, ia, 1);
  eb = __shfl_down_sync(FULL, ib, 1);
  if (lane == 31) {
    ea = ta;
    eb = tb;
  }
  __syncthreads();   // sa, sb are read
}

__global__ void __launch_bounds__(GB_THREADS)
mlstm_bwd_gates(const float* __restrict__ gates, const float* __restrict__ pos,
                const float* __restrict__ kdk, float* dli, float* dlf, int s,
                int h, int nc, int tiles) {
  __shared__ float sa[GB_THREADS / 32], sb[GB_THREADS / 32];
  __shared__ float carry[2];
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
  auto is_max = [&](int t) {
    const float prev = (t % Q) != 0 ? gg[t - 1] : (t ? mt[t - 1] : M_INIT);
    return src[t] >= prev;
  };
  float cr = 0.f, cf = 0.f;   // R and dlogf after the window
  for (int w1 = s; w1 > 0; w1 -= GB_WIN) {
    const int w0 = max(0, w1 - GB_WIN);
    const int t0 = w0 + GB_PER * tid;
    float dg[GB_PER], ra[GB_PER], da[GB_PER];
    bool rec[GB_PER];
    float a = 1.f, bb = 0.f;
#pragma unroll
    for (int x = GB_PER - 1; x >= 0; --x) {
      const int t = t0 + x;
      rec[x] = false;
      dg[x] = da[x] = 0.f;
      ra[x] = 1.f;
      if (t < w1) {
        rec[x] = is_max(t);
        dg[x] = dm[t] - rowv[t];
        ra[x] = (t + 1 < s && !is_max(t + 1)) ? 1.f : 0.f;
        float sum = 0.f;
        for (int i = 0; i < tiles; ++i) sum += kdk[(bh * sp + t) * tiles + i];
        da[x] = sum;
      }
      bb = fmaf(ra[x], bb, dg[x]);
      a *= ra[x];
    }
    float ea, eb;
    after_scan(a, bb, ea, eb, sa, sb);
    float r = fmaf(ea, cr, eb);   // R after this thread's positions
    float dfc[GB_PER];
#pragma unroll
    for (int x = GB_PER - 1; x >= 0; --x) {
      const int t = t0 + x;
      dfc[x] = 0.f;
      if (t < w1) {
        r = fmaf(ra[x], r, dg[x]);
        const float d = rec[x] ? da[x] + r : da[x];
        dli[base + static_cast<long long>(t) * h] = d;
        dfc[x] = dm[t] - d;
      }
    }
    if (tid == 0) carry[0] = r;
    // dlogf: the reverse running sum of dm - dlogi
    float f = 0.f;
#pragma unroll
    for (int x = GB_PER - 1; x >= 0; --x) f += dfc[x];
    after_scan(1.f, f, ea, eb, sa, sb);
    float y = eb + cf;
#pragma unroll
    for (int x = GB_PER - 1; x >= 0; --x) {
      const int t = t0 + x;
      y += dfc[x];
      if (t < w1) dlf[base + static_cast<long long>(t) * h] = y;
    }
    if (tid == 0) carry[1] = y;
    __syncthreads();
    cr = carry[0];
    cf = carry[1];
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
  using Wk = Walk<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_walk<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Wk::bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_rows<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Rows<DH>::bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_dv<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Dv<DH>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const int nc = n_chunks(s), bh = batch * h;
  Work w;
  workspace_floats(batch, s, h, DH, Wk::TILES, work, &w);
  float* m0 = w.m01;
  float* m1 = w.m01 + bh;
  mlstm_bwd_fill<<<(bh + 255) / 256, 256, 0, stream>>>(m0, bh, M_INIT);
  CHECK_LAUNCH();
  // A. gates
  mlstm_bwd_fgates<<<bh, GATE_THREADS, 0, stream>>>(li, lf, m0, m1, w.gates,
                                                    s, h, nc);
  CHECK_LAUNCH();
  // N. each chunk's share of n
  mlstm_bwd_ksum<<<dim3(nc, bh), KSUM_THREADS, 0, stream>>>(k, w.gates,
                                                            w.ksum, s, h, nc,
                                                            DH);
  CHECK_LAUNCH();
  // R. the scores and the per-position scalars
  mlstm_bwd_rows<DH><<<dim3(nc, bh), Rows<DH>::THREADS, Rows<DH>::bytes,
                       stream>>>(q, k, v, out, dout, w.gates, w.ksum, w.pos,
                                 w.amat, s, h, nc, scale);
  CHECK_LAUNCH();
  // W. the forward walk (dq) and the reverse walk (dk, dC for dv)
  mlstm_bwd_walk<DH><<<dim3(Wk::TILES, bh, 2), Wk::THREADS, Wk::bytes,
                       stream>>>(q, k, v, dout, w.gates, w.pos, w.ksum,
                                 w.amat, dq, dk, w.kdk, w.dcs, s, h, nc,
                                 scale);
  CHECK_LAUNCH();
  // V. dv
  mlstm_bwd_dv<DH><<<dim3(nc, bh, DH / Dv<DH>::ET), Dv<DH>::THREADS,
                     Dv<DH>::bytes, stream>>>(k, dout, w.gates, w.amat, w.dcs,
                                              dv, s, h, nc);
  CHECK_LAUNCH();
  // D. the gates' gradients
  mlstm_bwd_gates<<<bh, GB_THREADS, 0, stream>>>(w.gates, w.pos, w.kdk, dli,
                                                 dlf, s, h, nc, Wk::TILES);
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
    case 32: return workspace_floats(batch, s, h, 32, Walk<32>::TILES,
                                     nullptr, &w);
    case 64: return workspace_floats(batch, s, h, 64, Walk<64>::TILES,
                                     nullptr, &w);
    case 128: return workspace_floats(batch, s, h, 128, Walk<128>::TILES,
                                      nullptr, &w);
    case 512: return workspace_floats(batch, s, h, 512, Walk<512>::TILES,
                                      nullptr, &w);
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
