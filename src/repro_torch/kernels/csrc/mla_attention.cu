// MLA latent attention for Hopper (sm_90a), float and bfloat16: the
// weight-absorbed attention of multi-head latent attention (MiniCPM3,
// DeepSeek-V2) over the latent cache, prefill and decode.
//
// Replaces no Pallas kernel: the reference computes this attention in jnp
// inside `mla_attention` (src/repro/models/layers.py, the `kv_cache` branch,
// :228-238), and serves every MLA prompt and decode step through it.  Per
// query row (a position and a head) and cache position k:
//   s_k   = (q_lat . c_k + q_rope . kr_k) * scale     (f32)
//   ctx   = sum_k softmax(s)_k c_k                     (f32, out in T)
// with q_lat (B, Sq, H, R), q_rope (B, Sq, H, Dr), the cache c (B, S, R)
// and k_rope (B, S, Dr): one key/value head shared by all H query heads,
// keys R + Dr = 288 wide, values the first R = 256 columns of the keys.
// `scale` is an argument (the reference's (head_dim + rope_head_dim)^-0.5,
// not the key width's).  Query row i of a prefill sits at Sk - Sq + i and
// sees keys [0, Sk - Sq + i] (the reference's causal mask from q_pos =
// length + i over the cache prefix); a decode lane's single query sees
// [0, min(len, S - 1)] (len >= S: the whole cache; len < 0: nothing).  A
// row that sees no key returns 0.
//
// Bound.  Prefill does ~2 (288 + 256) FLOP per visible (row, key) pair on
// ~576 B of cache a key shared by every row: far above the ~295 FLOP a byte
// where the tensor cores bound it, so operations bound it.  Decode reads
// each visible cache row (576 B in bf16) once for H rows of 2 (288 + 256)
// FLOP: bytes bound it.
//
// Design.  One block of 4 warps owns 64 query rows of one batch row, the
// flattened (position, head) rows r = i H + h, so that every head of a
// position reads the same key tiles and a decode block holds all of a
// lane's heads (rows past the last are zero and cost no memory traffic).
// The block stages its rows' q_lat | q_rope (64 x 288) in shared memory
// once, then streams 32-key tiles of c | k_rope (32 x 288) through a ring
// of 16-byte cp.async copies (rows past the block's keys zero-filled).  The
// latent is both K and V: each tile is loaded once and read for the scores
// (all 288 columns) and for P V (its first 256).  Rows are padded in shared
// memory (bf16 296, f32 292 elements) so that ldmatrix and float4 reads hit
// distinct banks.  Each row keeps its own causal limit; the online softmax
// is in f32 and in log2 units.
//   bf16, `mma.sync` m16n8k16: warp w owns rows 16 w .. 16 w + 15 and all
//   256 output columns (128 f32 accumulators a thread, as FlashAttention-2
//   at head dim 256); per tile S (16 x 32) = Q K^T over 18 depth steps (Q
//   and K through ldmatrix), the softmax on the accumulator fragment, P in
//   registers as the A operand of O += P V with V through ldmatrix.trans.
//   f32, the CUDA cores (TF32 would not keep the f32 path's precision):
//   thread (ty, tx) of a 16 x 8 grid owns rows ty + 16 i (i < 4) and keys
//   tx + 8 j (j < 4) of the scores, and the same rows' columns 4 tx + 32 jj
//   (jj < 8) of O; P reaches the row's column owners by shuffles.
// Prefill: one launch, blocks ordered from the last rows (the most keys)
// first, each writing its normalised rows.  Decode: split-K, as
// decode_attention.cu: `nsplit` splits (chosen by the wrapper) each take an
// equal share of a lane's visible keys, rounded up to the tile, and write
// partial (m, l, acc); a second launch combines them in split order.  No
// atomics anywhere, so two calls give the same bits.
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, do not synchronise, and return the first cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int R = 256;         // latent width: c, q_lat, ctx
constexpr int DR = 32;         // rope width
constexpr int DK = R + DR;     // key width, 288
constexpr int THREADS = 128;
constexpr int ROWS = 64;       // query rows a block, 16 a warp
constexpr int KT = 32;         // keys a tile
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int EPC = 8;       // elements a 16-byte chunk
  static constexpr int LD = DK + 8;   // shared row stride: 592 B
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = 2;
};
template <>
struct Cfg<float> {
  static constexpr int EPC = 4;
  static constexpr int LD = DK + 4;   // 1168 B
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = 1;
};

template <typename T>
constexpr size_t smem_bytes() {
  return size_t(ROWS + Cfg<T>::STAGES * KT) * Cfg<T>::LD * sizeof(T);
}

struct Args {
  const void* q_lat;
  const void* q_rope;
  const void* c;
  const void* kr;
  const int* lengths;     // decode: (B,) int32; prefill: nullptr
  void* out;              // prefill: (B, Sq, H, R) contiguous
  float* part_ml;         // decode: (B, H, nsplit, 2)
  float* part_acc;        // decode: (B, H, nsplit, R)
  int sq, sk, h, nsplit;
  long long ql_sb, ql_ss, ql_sh;
  long long qr_sb, qr_ss, qr_sh;
  long long c_sb, c_ss, kr_sb, kr_ss;
  float scale_log2;
};

// keys [0, hi) that query row r sees (0 for rows past the last)
__device__ __forceinline__ int row_hi(const Args& a, int b, int r,
                                      int rows_total) {
  if (r >= rows_total) return 0;
  const long long base = a.lengths ? a.lengths[b] : a.sk - a.sq;
  long long e = base + r / a.h + 1;
  if (e < 0) e = 0;
  if (e > a.sk) e = a.sk;
  return static_cast<int>(e);
}

struct Block {
  int b, m0, rows_total, k_first, k_stop, n_tiles;
};

// this block's rows and its share [k_first, k_stop) of the keys its last
// row sees: shares of equal length, a multiple of KT, in split order
__device__ __forceinline__ Block block_setup(const Args& a) {
  Block bl;
  bl.b = blockIdx.z;
  bl.m0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  bl.rows_total = a.sq * a.h;
  const int last = min(bl.m0 + ROWS, bl.rows_total) - 1;
  const int n = row_hi(a, bl.b, last, bl.rows_total);
  const int share = ((n + a.nsplit - 1) / a.nsplit + KT - 1) / KT * KT;
  bl.k_first = blockIdx.y * share;
  bl.k_stop = min(n, bl.k_first + share);
  bl.n_tiles = bl.k_stop > bl.k_first ? (bl.k_stop - bl.k_first + KT - 1) / KT
                                      : 0;
  return bl;
}

// the block's 64 rows of q_lat | q_rope into qs, rows past the last zero;
// one cp.async group
template <typename T>
__device__ __forceinline__ void load_q(const Args& a, const Block& bl,
                                       T* qs) {
  constexpr int EPC = Cfg<T>::EPC, LD = Cfg<T>::LD;
  constexpr int CH = DK / EPC, CR = R / EPC;
  const T* ql = static_cast<const T*>(a.q_lat) + bl.b * a.ql_sb;
  const T* qr = static_cast<const T*>(a.q_rope) + bl.b * a.qr_sb;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int row = idx / CH, ch = idx % CH, r = bl.m0 + row;
    const bool in = r < bl.rows_total;
    const T* src = ql;
    if (in) {
      const int i = r / a.h, hh = r % a.h;
      src = ch < CR ? ql + i * a.ql_ss + hh * a.ql_sh + ch * EPC
                    : qr + i * a.qr_ss + hh * a.qr_sh + (ch - CR) * EPC;
    }
    hopper::cp_async_16_or_zero(qs + row * LD + ch * EPC, src, in);
  }
  hopper::cp_async_commit();
}

// key tile t of the share (c | k_rope rows) into its stage of the ring,
// rows past the share zero-filled (P = 0 never meets stale bits); one
// cp.async group, empty past the last tile (the wait counts stay right)
template <typename T>
__device__ __forceinline__ void load_tile(const Args& a, const Block& bl,
                                          T* ring, int t) {
  constexpr int EPC = Cfg<T>::EPC, LD = Cfg<T>::LD;
  constexpr int CH = DK / EPC, CR = R / EPC;
  if (t < bl.n_tiles) {
    const T* cb = static_cast<const T*>(a.c) + bl.b * a.c_sb;
    const T* kb = static_cast<const T*>(a.kr) + bl.b * a.kr_sb;
    const int k0 = bl.k_first + t * KT;
    const int rows = min(KT, bl.k_stop - k0);
    T* ks = ring + (t % Cfg<T>::STAGES) * KT * LD;
    for (int idx = threadIdx.x; idx < KT * CH; idx += THREADS) {
      const int row = idx / CH, ch = idx % CH;
      const bool in = row < rows;
      const T* src = cb;
      if (in) {
        const long long k = k0 + row;
        src = ch < CR ? cb + k * a.c_ss + ch * EPC
                      : kb + k * a.kr_ss + (ch - CR) * EPC;
      }
      hopper::cp_async_16_or_zero(ks + row * LD + ch * EPC, src, in);
    }
  }
  hopper::cp_async_commit();
}

// where row r's partial (m, l, acc) of this block's split sits in the
// decode scratch
__device__ __forceinline__ long long partial_at(const Args& a, int b, int r,
                                                int rows_total) {
  return (static_cast<long long>(b) * rows_total + r) * a.nsplit + blockIdx.y;
}

// ---- bf16: the scores and P V on the tensor cores ---------------------------
template <bool SPLIT>
__device__ __forceinline__ void block_mma(const Args& a, unsigned char* smem) {
  using Cf = Cfg<bf16>;
  constexpr int LD = Cf::LD, STAGES = Cf::STAGES;
  const Block bl = block_setup(a);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + ROWS * LD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, mi = lane / 8, rr = lane % 8;
  const int wr0 = bl.m0 + warp * 16;                 // this warp's rows
  const int r0 = wr0 + g, r1 = wr0 + g + 8;          // this thread's rows
  const int hi0 = row_hi(a, bl.b, r0, bl.rows_total);
  const int hi1 = row_hi(a, bl.b, r1, bl.rows_total);
  // the warp's last row sees the most keys (warp-uniform)
  const int hi_w = row_hi(a, bl.b, min(wr0 + 15, bl.rows_total - 1),
                          bl.rows_total);
  const bool active = wr0 < bl.rows_total;

  load_q<bf16>(a, bl, qs);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile<bf16>(a, bl, ring, t);

  float o[R / 8][4];
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale_log2;

  for (int t = 0; t < bl.n_tiles; ++t) {
    load_tile<bf16>(a, bl, ring, t + STAGES - 1);
    hopper::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const bf16* ks = ring + (t % STAGES) * KT * LD;
    const int k0 = bl.k_first + t * KT;
    if (active && k0 < hi_w) {
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t qa[4];   // rows (mi % 2) 8 + rr, depth 16 kk + (mi / 2) 8
        hopper::ldmatrix_x4(
            qa, qs + (warp * 16 + (mi % 2) * 8 + rr) * LD + 16 * kk +
                    (mi / 2) * 8);
#pragma unroll
        for (int kg = 0; kg < KT / 16; ++kg) {
          uint32_t kf[4];  // keys 16 kg + (mi / 2) 8 + rr, depth (mi % 2) 8
          hopper::ldmatrix_x4(
              kf, ks + (16 * kg + (mi / 2) * 8 + rr) * LD + 16 * kk +
                      (mi % 2) * 8);
          hopper::mma_16816(s[2 * kg], qa, kf[0], kf[1]);
          hopper::mma_16816(s[2 * kg + 1], qa, kf[2], kf[3]);
        }
      }
      // s[n][i]: row g + 8 (i / 2), key k0 + 8 n + 2 t4 + i % 2
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * n + 2 * t4 + i % 2;
          if (key >= (i < 2 ? hi0 : hi1) || key >= bl.k_stop)
            s[n][i] = -INFINITY;
          if (i < 2) mx0 = fmaxf(mx0, s[n][i]);
          else mx1 = fmaxf(mx1, s[n][i]);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[KT / 16][4];  // P as A fragments, keys 16 kg .. 16 kg + 15
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float mu = hi ? mu1 : mu0;
          const float pl = exp2f(fmaf(s[n][2 * hi], sl2, -mu));
          const float ph = exp2f(fmaf(s[n][2 * hi + 1], sl2, -mu));
          if (hi) rs1 += pl + ph;
          else rs0 += pl + ph;
          __nv_bfloat162 pp = __floats2bfloat162_rn(pl, ph);
          pa[n / 2][2 * (n % 2) + hi] = *reinterpret_cast<uint32_t*>(&pp);
        }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
#pragma unroll
      for (int kg = 0; kg < KT / 16; ++kg)
#pragma unroll
        for (int jj = 0; jj < R / 16; ++jj) {
          uint32_t vf[4];  // keys 16 kg + (mi % 2) 8 + rr, cols (mi / 2) 8
          hopper::ldmatrix_x4_trans(
              vf, ks + (16 * kg + (mi % 2) * 8 + rr) * LD + 16 * jj +
                      (mi / 2) * 8);
          hopper::mma_16816(o[2 * jj], pa[kg], vf[0], vf[1]);
          hopper::mma_16816(o[2 * jj + 1], pa[kg], vf[2], vf[3]);
        }
    }
    __syncthreads();  // stage t % STAGES is free for tile t + STAGES
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = hi ? r1 : r0;
    if (r >= bl.rows_total) continue;
    const float l = hi ? l1 : l0;
    if constexpr (SPLIT) {
      const long long p = partial_at(a, bl.b, r, bl.rows_total);
      float* acc = a.part_acc + p * R;
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
        *reinterpret_cast<float2*>(acc + 8 * j + 2 * t4) =
            make_float2(o[j][2 * hi], o[j][2 * hi + 1]);
      if (t4 == 0) {
        a.part_ml[2 * p] = hi ? m1 : m0;
        a.part_ml[2 * p + 1] = l;
      }
    } else {
      bf16* out = static_cast<bf16*>(a.out) +
                  (static_cast<long long>(bl.b) * bl.rows_total + r) * R;
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const float x0 = l > 0.f ? o[j][2 * hi] / l : 0.f;
        const float x1 = l > 0.f ? o[j][2 * hi + 1] / l : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ---- f32: the CUDA cores ---------------------------------------------------
template <bool SPLIT>
__device__ __forceinline__ void block_simt(const Args& a,
                                           unsigned char* smem) {
  using Cf = Cfg<float>;
  constexpr int LD = Cf::LD, STAGES = Cf::STAGES;
  const Block bl = block_setup(a);
  float* qs = reinterpret_cast<float*>(smem);
  float* ring = qs + ROWS * LD;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = tid % 8, ty = tid / 8;   // keys tx + 8 j, rows ty + 16 i
  int hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    hi[i] = row_hi(a, bl.b, bl.m0 + ty + 16 * i, bl.rows_total);

  load_q<float>(a, bl, qs);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile<float>(a, bl, ring, t);

  float o[4][R / 32][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < R / 32; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][jj][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const float sl2 = a.scale_log2;

  for (int t = 0; t < bl.n_tiles; ++t) {
    load_tile<float>(a, bl, ring, t + STAGES - 1);
    hopper::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* ks = ring + (t % STAGES) * KT * LD;
    const int k0 = bl.k_first + t * KT;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv.x, kv[j].x, x);
          x = fmaf(qv.y, kv[j].y, x);
          x = fmaf(qv.z, kv[j].z, x);
          x = fmaf(qv.w, kv[j].w, x);
          s[i][j] = x;
        }
      }
    }
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 8 * j;
        if (key >= hi[i] || key >= bl.k_stop) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off <= 4; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx * sl2);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float al = exp2f(m[i] - mu);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = exp2f(fmaf(s[i][j], sl2, -mu));
        rs += p[i][j];
      }
      l[i] = l[i] * al + rs;
#pragma unroll
      for (int jj = 0; jj < R / 32; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][jj][e] *= al;
    }
    // O += P V: key k's p lives in lane (lane & ~7) | (k & 7), slot k / 8
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      float pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pk[i] = __shfl_sync(0xffffffffu, p[i][k / 8], (lane & ~7) | (k & 7));
#pragma unroll
      for (int jj = 0; jj < R / 32; ++jj) {
        const float4 v =
            *reinterpret_cast<const float4*>(ks + k * LD + 4 * tx + 32 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][jj][0] = fmaf(pk[i], v.x, o[i][jj][0]);
          o[i][jj][1] = fmaf(pk[i], v.y, o[i][jj][1]);
          o[i][jj][2] = fmaf(pk[i], v.z, o[i][jj][2]);
          o[i][jj][3] = fmaf(pk[i], v.w, o[i][jj][3]);
        }
      }
    }
    __syncthreads();
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = bl.m0 + ty + 16 * i;
    if (r >= bl.rows_total) continue;
    if constexpr (SPLIT) {
      const long long pidx = partial_at(a, bl.b, r, bl.rows_total);
      float* acc = a.part_acc + pidx * R;
#pragma unroll
      for (int jj = 0; jj < R / 32; ++jj)
        *reinterpret_cast<float4*>(acc + 4 * tx + 32 * jj) =
            make_float4(o[i][jj][0], o[i][jj][1], o[i][jj][2], o[i][jj][3]);
      if (tx == 0) {
        a.part_ml[2 * pidx] = m[i];
        a.part_ml[2 * pidx + 1] = li;
      }
    } else {
      float* out = static_cast<float*>(a.out) +
                   (static_cast<long long>(bl.b) * bl.rows_total + r) * R;
#pragma unroll
      for (int jj = 0; jj < R / 32; ++jj)
        *reinterpret_cast<float4*>(out + 4 * tx + 32 * jj) = make_float4(
            li > 0.f ? o[i][jj][0] / li : 0.f,
            li > 0.f ? o[i][jj][1] / li : 0.f,
            li > 0.f ? o[i][jj][2] / li : 0.f,
            li > 0.f ? o[i][jj][3] / li : 0.f);
    }
  }
}

template <typename T, bool SPLIT>
__device__ __forceinline__ void mla_block(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same_v<T, float>)
    block_simt<SPLIT>(a, smem);
  else
    block_mma<SPLIT>(a, smem);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Cfg<T>::MIN_BLOCKS)
mla_prefill_fwd(const Args a) {
  mla_block<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Cfg<T>::MIN_BLOCKS)
mla_decode_partial(const Args a) {
  mla_block<T, true>(a);
}

// one block per (row, batch row): the splits' partials merged in split
// order.  Every split wrote its partial (an empty one m = -inf, l = 0, acc =
// 0), so the accumulator loads carry no branch and issue ahead of the sum;
// the splits' weights are reckoned once, in shared memory
template <typename T>
__global__ void __launch_bounds__(R)
mla_decode_combine(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int rows, int nsplit) {
  extern __shared__ float wl[];   // [nsplit] m, then weights; [nsplit] l
  const int r = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * rows + r) * nsplit;
  float* ws = wl;
  float* ls = wl + nsplit;
  for (int s = d; s < nsplit; s += R) {
    ws[s] = part_ml[2 * (base + s)];
    ls[s] = part_ml[2 * (base + s) + 1];
  }
  __syncthreads();
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ws[s]);
  __syncthreads();                  // every thread has read the maxima
  for (int s = d; s < nsplit; s += R)
    ws[s] = ws[s] == -INFINITY ? 0.f : exp2f(ws[s] - m);
  __syncthreads();
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) l = fmaf(ls[s], ws[s], l);
  const float* pa = part_acc + base * R + d;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) acc = fmaf(pa[s * R], ws[s], acc);
  const float x = l > 0.f ? acc / l : 0.f;
  if constexpr (std::is_same_v<T, float>)
    out[(static_cast<long long>(b) * rows + r) * R + d] = x;
  else
    out[(static_cast<long long>(b) * rows + r) * R + d] = __float2bfloat16(x);
}

Args make_args(const void* q_lat, const void* q_rope, const void* c,
               const void* kr, const void* lengths, void* out, void* part_ml,
               void* part_acc, int sq, int sk, int h, int nsplit,
               const long long* st, float scale) {
  Args a;
  a.q_lat = q_lat;
  a.q_rope = q_rope;
  a.c = c;
  a.kr = kr;
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.nsplit = nsplit;
  a.ql_sb = st[0];
  a.ql_ss = st[1];
  a.ql_sh = st[2];
  a.qr_sb = st[3];
  a.qr_ss = st[4];
  a.qr_sh = st[5];
  a.c_sb = st[6];
  a.c_ss = st[7];
  a.kr_sb = st[8];
  a.kr_ss = st[9];
  a.scale_log2 = scale * LOG2E;
  return a;
}

bool bad_shape(int batch, int sq, int sk, int h, int r, int dr, int nsplit,
               float scale) {
  return r != R || dr != DR || batch < 0 || sq < 0 || sk < 0 || h <= 0 ||
         nsplit <= 0 || !(scale > 0.f);
}

template <typename T>
int prefill(const void* q_lat, const void* q_rope, const void* c,
            const void* kr, void* out, int batch, int sq, int sk, int h,
            int r, int dr, const long long* strides, float scale,
            void* stream) {
  if (bad_shape(batch, sq, sk, h, r, dr, 1, scale) || sq > sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(sq) * h;
  if (batch == 0 || rows == 0) return static_cast<int>(cudaSuccess);
  const Args a = make_args(q_lat, q_rope, c, kr, nullptr, out, nullptr,
                              nullptr, sq, sk, h, 1, strides, scale);
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      mla_prefill_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((rows + ROWS - 1) / ROWS), 1, batch);
  mla_prefill_fwd<T><<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int decode(const void* q_lat, const void* q_rope, const void* c,
           const void* kr, const void* lengths, void* out, void* part_ml,
           void* part_acc, int batch, int s_len, int h, int r, int dr,
           int nsplit, const long long* strides, float scale, void* stream) {
  if (bad_shape(batch, 1, s_len, h, r, dr, nsplit, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (s_len > 0) {
    const Args a = make_args(q_lat, q_rope, c, kr, lengths, out, part_ml,
                                part_acc, 1, s_len, h, nsplit, strides, scale);
    constexpr size_t smem = smem_bytes<T>();
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((h + ROWS - 1) / ROWS, nsplit, batch);
    mla_decode_partial<T><<<grid, THREADS, smem, st>>>(a);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  const int ns = s_len > 0 ? nsplit : 0;
  mla_decode_combine<T><<<dim3(h, batch), R, 2 * ns * sizeof(float), st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), h, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_lat (B, Sq, H, R) and q_rope (B, Sq, H, Dr), each row contiguous, with
// batch, position and head strides; c (B, S, R) and k_rope (B, S, Dr), rows
// contiguous, with batch and position strides.  `strides` holds ten element
// strides: q_lat's (batch, position, head), q_rope's (batch, position,
// head), c's (batch, position), k_rope's (batch, position).  Every base
// address and stride is 16-byte aligned (cp.async).  R must be 256 and Dr
// 32.  out: a contiguous (B, Sq, H, R) tensor of the input type.
int mla_prefill_f32(const void* q_lat, const void* q_rope, const void* c,
                    const void* kr, void* out, int batch, int sq, int sk,
                    int h, int r, int dr, const long long* strides,
                    float scale, void* stream) {
  return prefill<float>(q_lat, q_rope, c, kr, out, batch, sq, sk, h, r, dr,
                        strides, scale, stream);
}

int mla_prefill_bf16(const void* q_lat, const void* q_rope, const void* c,
                     const void* kr, void* out, int batch, int sq, int sk,
                     int h, int r, int dr, const long long* strides,
                     float scale, void* stream) {
  return prefill<bf16>(q_lat, q_rope, c, kr, out, batch, sq, sk, h, r, dr,
                       strides, scale, stream);
}

// As the prefill, with one query a lane (Sq = 1); lengths (B,) int32 on
// the card; part_ml (B, H, nsplit, 2) and part_acc (B, H, nsplit, R) float
// scratch, nsplit the number of splits of each lane's visible keys.
int mla_decode_f32(const void* q_lat, const void* q_rope, const void* c,
                   const void* kr, const void* lengths, void* out,
                   void* part_ml, void* part_acc, int batch, int s_len, int h,
                   int r, int dr, int nsplit, const long long* strides,
                   float scale, void* stream) {
  return decode<float>(q_lat, q_rope, c, kr, lengths, out, part_ml, part_acc,
                       batch, s_len, h, r, dr, nsplit, strides, scale, stream);
}

int mla_decode_bf16(const void* q_lat, const void* q_rope, const void* c,
                    const void* kr, const void* lengths, void* out,
                    void* part_ml, void* part_acc, int batch, int s_len,
                    int h, int r, int dr, int nsplit,
                    const long long* strides, float scale, void* stream) {
  return decode<bf16>(q_lat, q_rope, c, kr, lengths, out, part_ml, part_acc,
                      batch, s_len, h, r, dr, nsplit, strides, scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
