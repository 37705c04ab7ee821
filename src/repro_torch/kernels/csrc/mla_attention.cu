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
// Rows.  Both types flatten the (position, head) rows, r = i H + h, so that
// every head of a position reads the same key tiles and a decode block holds
// all of a lane's heads (rows past the last are zero and cost no memory
// traffic).  The latent is both K and V: each key tile is loaded once and
// read for the scores (all 288 columns) and for P V (its first 256).  Each
// row keeps its own causal limit; the online softmax is in f32 and in log2
// units; the sum l takes P in f32.
//
// bf16: `wgmma` on TMA-fed tiles (`mla_prefill_fwd_wgmma`,
// `mla_decode_partial_wgmma`).  Every operand arrives by TMA as panels of
// 64 columns with the 128-byte swizzle (the latent) and of 32 with the
// 64-byte swizzle (the rope), rows past the last as zeros.  A warpgroup
// owns 64 rows: its q_lat | q_rope (64 x 288) arrives once, in boxes of 8
// flattened rows (8 heads of a position, or every head of 8 / H positions:
// H divides 8 or is a multiple of it), from a map of (columns, heads,
// positions, batch) that takes q's strides as they are (16-byte cp.async
// copies took ~5 us a block here, a tile by TMA ~1).  64-key tiles of c
// (four panels) and k_rope (one panel) arrive in a ring of stages, each
// with a full and an empty mbarrier.  The block's first thread starts the
// ring; the
// last warpgroup's first thread refills a stage once every warp has
// released it (no producer warpgroup: with one, ptxas plans the consumers
// near the 168 registers a 384-thread block starts with, `setmaxnreg`
// notwithstanding, and spills and serialises the wgmma; 256 threads leave
// each up to 255).  Per tile a warpgroup computes S (64 x 64) = Q K^T by 18
// `wgmma m64n64k16` from shared memory (16 over the latent, 2 over the
// rope), the online softmax on the accumulator fragment, and O (64 x 256,
// f32, 128 registers a thread) += P V by `wgmma m64n128k16` twice a 16-key
// step, P in registers as bf16 (the only rounding beyond the f32 kernel's)
// and V the same c panels read N-major through the descriptor's transpose
// bit.  The loop is software-pipelined: tile t's scores issue together with
// tile t - 1's P V, so the softmax of t runs while P V of t - 1 is in the
// tensor cores; O takes a tile's factors only in warps where a row's max
// moved.  Only tiles that cross some row's limit (or the split's
// end) take the mask.
//   Prefill: blocks of 128 rows, two warpgroups taking turns at the tensor
//   cores (named barriers), so that one's softmax overlaps the other's
//   products; Q 72 KB + the ring 144 KB.  Blocks run from the last rows
//   (the most keys) first.
//   Decode: one warpgroup a block (a lane's 64 heads), two blocks an SM,
//   a ring of 2 (Q 36 KB + 72 KB).
//
// f32: the CUDA cores (TF32 would not keep the f32 path's precision).  One
// block of 4 warps owns 64 rows; it stages them (64 x 288) in shared memory
// once, then streams 32-key tiles of c | k_rope (32 x 288) through a ring of
// 16-byte cp.async copies (rows past the block's keys zero-filled), rows
// padded to 292 floats so that float4 reads hit distinct banks.  Thread (ty,
// tx) of a 16 x 8 grid owns rows ty + 16 i (i < 4) and keys tx + 8 j (j < 4)
// of the scores, and the same rows' columns 4 tx + 32 jj (jj < 8) of O; P
// reaches the row's column owners by shuffles.
//
// Prefill: one launch, each block writing its normalised rows.  Decode:
// split-K, as decode_attention.cu: `nsplit` splits (chosen by the wrapper)
// each take an equal share of a lane's visible keys, rounded up to the tile,
// and write partial (m, l, acc); a second launch combines them in split
// order.  No atomics anywhere, so two calls give the same bits.
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, do not synchronise, and return the first cudaGetLastError() (or
// TMAP_ERROR + the CUresult if a tensor map cannot be encoded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int R = 256;         // latent width: c, q_lat, ctx
constexpr int DR = 32;         // rope width
constexpr int DK = R + DR;     // key width, 288
constexpr float LOG2E = 1.4426950408889634f;

// the f32 kernel's block
constexpr int THREADS = 128;
constexpr int ROWS = 64;       // query rows a block, 16 a warp
constexpr int KT = 32;         // keys a tile

using bf16 = __nv_bfloat16;

template <typename T>
struct Cfg;
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
  int qbh, qbi;           // bf16: heads and positions of a Q box (8 rows)
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

// this block's BR rows and its share [k_first, k_stop) of the keys its
// last row sees: shares of equal length, a multiple of the tile BT, in
// split order
template <int BR, int BT>
__device__ __forceinline__ Block block_setup(const Args& a) {
  Block bl;
  bl.b = blockIdx.z;
  bl.m0 = (gridDim.x - 1 - blockIdx.x) * BR;
  bl.rows_total = a.sq * a.h;
  const int last = min(bl.m0 + BR, bl.rows_total) - 1;
  const int n = row_hi(a, bl.b, last, bl.rows_total);
  const int share = ((n + a.nsplit - 1) / a.nsplit + BT - 1) / BT * BT;
  bl.k_first = blockIdx.y * share;
  bl.k_stop = min(n, bl.k_first + share);
  bl.n_tiles = bl.k_stop > bl.k_first ? (bl.k_stop - bl.k_first + BT - 1) / BT
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

// ---- f32: the CUDA cores ---------------------------------------------------
template <bool SPLIT>
__device__ __forceinline__ void block_simt(const Args& a,
                                           unsigned char* smem) {
  using Cf = Cfg<float>;
  constexpr int LD = Cf::LD, STAGES = Cf::STAGES;
  const Block bl = block_setup<ROWS, KT>(a);
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

__global__ void __launch_bounds__(THREADS, Cfg<float>::MIN_BLOCKS)
mla_prefill_fwd(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_simt<false>(a, smem);
}

__global__ void __launch_bounds__(THREADS, Cfg<float>::MIN_BLOCKS)
mla_decode_partial(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_simt<true>(a, smem);
}

// ---- bf16: wgmma on TMA-fed tiles ------------------------------------------
constexpr int BK = 64;                   // keys a tile
constexpr int PANEL = 64 * 128;          // 64 rows x 64 columns, 128-B swizzle
constexpr int RPANEL = 64 * 64;          // 64 rows x 32 rope columns, 64-B
constexpr int NPANEL = R / 64;           // latent panels of a row
constexpr int TILE_BYTES = NPANEL * PANEL + RPANEL;  // 64 rows of 288: 36 KB
constexpr int TURN = 1;      // named barrier TURN + w: warpgroup w's products

template <int NWG>
struct Wg {
  static constexpr int ROWS = 64 * NWG;            // query rows a block
  // prefill: one block an SM, a ring of 4; decode: two blocks an SM (the
  // other block's tiles stream while one waits for Q or writes its
  // partials), a ring of 2 each
  static constexpr int STAGES = NWG == 2 ? 4 : 2;  // key tiles in the ring
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;  // blocks an SM holds
  static constexpr int THREADS = 128 * NWG;
  // 1024 B of slack to align the panels, then Q, the ring, the barriers
  static constexpr size_t SMEM =
      1024 + size_t(NWG + STAGES) * TILE_BYTES + 16 * STAGES + 8 * NWG;
};

// the block's TMA loads: its Q rows, and the ring of key tiles (tile t of
// the block's share into stage t % STAGES, c's four panels and k_rope's
// panel, counted on the stage's full barrier)
struct Ring {
  const CUtensorMap* cmap;
  const CUtensorMap* krmap;
  uint8_t* s_kv;
  uint64_t* full;
  uint64_t* empty;
  int b, k_first, stages;

  // rows r0 .. r0 + 7 of q_lat | q_rope (one box of each panel: qbh heads
  // of qbi positions, 8 flattened rows) into rows j0 .. j0 + 7 of a Q tile;
  // rows past the last read as zeros
  __device__ __forceinline__ void load_q(uint8_t* sq, const CUtensorMap* qmap,
                                         const CUtensorMap* qrmap,
                                         uint64_t* bar, const Args& a,
                                         int r0, int j0) const {
    const int i = r0 / a.h, hh = r0 % a.h;
#pragma unroll
    for (int p = 0; p < NPANEL; ++p)
      hopper::tma_load_4d(sq + p * PANEL + j0 * 128, qmap, bar, 64 * p, hh, i,
                          b);
    hopper::tma_load_4d(sq + NPANEL * PANEL + j0 * 64, qrmap, bar, 0, hh, i,
                        b);
  }

  __device__ __forceinline__ void load(int t) const {
    const int s = t % stages, k0 = k_first + t * BK;
    hopper::mbar_expect_tx(&full[s], TILE_BYTES);
    uint8_t* ks = s_kv + s * TILE_BYTES;
#pragma unroll
    for (int p = 0; p < NPANEL; ++p)
      hopper::tma_load_3d(ks + p * PANEL, cmap, &full[s], 64 * p, k0, b);
    hopper::tma_load_3d(ks + NPANEL * PANEL, krmap, &full[s], 0, k0, b);
  }
};

// S = Q K^T for the key tile at ks: 16 steps of 16 over the latent panels
// (32 bytes each into a panel), 2 over the rope panel
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const uint8_t* sq,
                                             const uint8_t* ks) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    hopper::wgmma_ss_n64(
        s, hopper::desc_sw128(sq + (kk / 4) * PANEL + (kk % 4) * 32, 0),
        hopper::desc_sw128(ks + (kk / 4) * PANEL + (kk % 4) * 32, 0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DR / 16; ++kk)
    hopper::wgmma_ss_n64(s, hopper::desc_sw64(sq + NPANEL * PANEL + kk * 32),
                         hopper::desc_sw64(ks + NPANEL * PANEL + kk * 32), 1);
  hopper::wgmma_commit();
}

// O += P V for the key tile at vs: 16 keys a step (16 rows, 2048 bytes, into
// the c panels, read N-major), columns 0-127 into o0 and 128-255 into o1
__device__ __forceinline__ void issue_pv(float (&o0)[64], float (&o1)[64],
                                         const uint32_t (&p)[BK / 16][4],
                                         const uint8_t* vs) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    hopper::wgmma_rs_n128(o0, p[kk],
                          hopper::desc_sw128(vs + kk * 16 * 128, PANEL));
    hopper::wgmma_rs_n128(
        o1, p[kk], hopper::desc_sw128(vs + 2 * PANEL + kk * 16 * 128, PANEL));
  }
  hopper::wgmma_commit();
}

// the online softmax of one tile's scores.  Fragment element i: key k0 +
// 8 (i / 4) + 2 t4 + i % 2, the thread's row 0 or 1 by (i / 2) % 2; with
// `edge`, keys at or past the row's limit are masked.  Updates the rows'
// max (scaled log2 units; a row with nothing seen yet keeps -inf and
// subtracts 0) and sum, writes P as bf16 A fragments (keys 16 kk .. 16 kk +
// 15 are elements 8 kk .. 8 kk + 7) and the factors al the rows' O takes
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             uint32_t (&p)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&al)[2], bool edge,
                                             int k0, const int (&lim)[2],
                                             int t4, float sl2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (k0 + 8 * (i / 4) + 2 * t4 + i % 2 >= lim[(i / 2) % 2])
        s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float mu[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], off));
    const float mn = fmaxf(m[hi], mx[hi] * sl2);
    mu[hi] = mn == -INFINITY ? 0.f : mn;
    al[hi] = exp2f(m[hi] - mu[hi]);
    m[hi] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int hi = (i / 2) % 2;
    const float p0 = exp2f(fmaf(s[i], sl2, -mu[hi]));
    const float p1 = exp2f(fmaf(s[i + 1], sl2, -mu[hi]));
    rs[hi] += p0 + p1;
    __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
    p[i / 8][(i % 8) / 2] = *reinterpret_cast<uint32_t*>(&pp);
  }
  l[0] = l[0] * al[0] + rs[0];  // this thread's keys; the quad sums at the end
  l[1] = l[1] * al[1] + rs[1];
}

// this warp is done with a stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

// warpgroup w (of NWG) of a block: its 64 rows over the block's key tiles,
// then the rows' outputs (prefill) or partials (decode).  Tiles 0 .. ST - 1
// are in flight already; the last warpgroup's first thread refills each
// stage once every warp has released it
template <int NWG, bool SPLIT>
__device__ __forceinline__ void consume(const Args& a, const Block& bl,
                                        uint8_t* sq, uint64_t* q_full,
                                        const Ring& ring, int w, int tw) {
  constexpr int ST = Wg<NWG>::STAGES;
  const uint8_t* s_kv = ring.s_kv;
  uint64_t* full = ring.full;
  uint64_t* empty = ring.empty;
  const bool issuer = w == NWG - 1 && tw == 0;
  constexpr bool TURNS = NWG == 2;
  const int warp = tw / 32, lane = tw % 32, t4 = lane % 4;
  const int r_first = bl.m0 + 64 * w;
  const int r0 = r_first + 16 * warp + lane / 4;  // this thread's rows
  const int lim[2] = {min(row_hi(a, bl.b, r0, bl.rows_total), bl.k_stop),
                      min(row_hi(a, bl.b, r0 + 8, bl.rows_total), bl.k_stop)};
  // the warpgroup's first row sees the fewest keys: tiles reaching past
  // its limit take the mask
  const int lim_wg = min(row_hi(a, bl.b, r_first, bl.rows_total), bl.k_stop);
  const float sl2 = a.scale_log2;
  const int mine = TURN + w, other = TURN + (w ^ 1);

  float o0[64], o1[64], s[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o0[i] = o1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t pa[BK / 16][4], pn[BK / 16][4];  // P of tiles t - 1 and t
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];
  const int n = bl.n_tiles;
  if (n > 0) {
    // tile 0: its scores alone (warpgroup 0 takes the first turn)
    if (TURNS && w == 1) hopper::bar_arrive(TURN, 256);
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(&full[0], 0);
    if (TURNS) hopper::bar_sync(mine, 256);
    issue_scores(s, sq, s_kv);
    if (TURNS) hopper::bar_arrive(other, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    softmax_tile(s, pa, m, l, al, bl.k_first + BK > lim_wg, bl.k_first, lim,
                 t4, sl2);
    // tile t: its scores and tile t - 1's P V in one turn; t's softmax
    // while P V runs; then O takes t's factors and the stage of t - 1 is free
    for (int t = 1; t < n; ++t) {
      const int st = t % ST, k0 = bl.k_first + t * BK;
      hopper::mbar_wait(&full[st], (t / ST) & 1);
      if (TURNS) hopper::bar_sync(mine, 256);
      issue_scores(s, sq, s_kv + st * TILE_BYTES);
      issue_pv(o0, o1, pa, s_kv + ((t - 1) % ST) * TILE_BYTES);
      if (TURNS) hopper::bar_arrive(other, 256);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      softmax_tile(s, pn, m, l, al, k0 + BK > lim_wg, k0, lim, t4, sl2);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o0);
      hopper::fence_regs(o1);
      hopper::fence_regs(pa);
      release(&empty[(t - 1) % ST], lane);
      if (issuer && t - 1 + ST < n) {
        hopper::mbar_wait(&empty[(t - 1) % ST], ((t - 1) / ST) & 1);
        ring.load(t - 1 + ST);
      }
      // O takes the factors only where some row of the warp has a new max
      // (a factor of 1 is exact: the same bits either way)
      if (__any_sync(0xffffffffu, al[0] != 1.f || al[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          o0[i] *= al[(i / 2) % 2];
          o1[i] *= al[(i / 2) % 2];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
    }
    // the last tile's P V (warpgroup 1 gives no turn back: none is taken)
    if (TURNS) hopper::bar_sync(mine, 256);
    issue_pv(o0, o1, pa, s_kv + ((n - 1) % ST) * TILE_BYTES);
    if (TURNS && w == 0) hopper::bar_arrive(other, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o0);
    hopper::fence_regs(o1);
    hopper::fence_regs(pa);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], off);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = r0 + 8 * hi;
    if (r >= bl.rows_total) continue;
    if constexpr (SPLIT) {
      const long long pi = partial_at(a, bl.b, r, bl.rows_total);
      float* acc = a.part_acc + pi * R;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(acc + col) =
            make_float2(o0[4 * j + 2 * hi], o0[4 * j + 2 * hi + 1]);
        *reinterpret_cast<float2*>(acc + 128 + col) =
            make_float2(o1[4 * j + 2 * hi], o1[4 * j + 2 * hi + 1]);
      }
      if (t4 == 0) {
        a.part_ml[2 * pi] = m[hi];
        a.part_ml[2 * pi + 1] = l[hi];
      }
    } else {
      const float inv = l[hi] > 0.f ? 1.f / l[hi] : 0.f;
      bf16* out = static_cast<bf16*>(a.out) +
                  (static_cast<long long>(bl.b) * bl.rows_total + r) * R;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            o0[4 * j + 2 * hi] * inv, o0[4 * j + 2 * hi + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(out + 128 + col) =
            __floats2bfloat162_rn(o1[4 * j + 2 * hi] * inv,
                                  o1[4 * j + 2 * hi + 1] * inv);
      }
    }
  }
}

// a block: NWG warpgroups, each owning 64 rows; its first thread starts
// the ring
template <int NWG, bool SPLIT>
__device__ __forceinline__ void wgmma_block(const CUtensorMap& qmap,
                                            const CUtensorMap& qrmap,
                                            const CUtensorMap& cmap,
                                            const CUtensorMap& krmap,
                                            const Args& a) {
  using C = Wg<NWG>;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_q = smem;                        // [NWG] tiles of 64 query rows
  uint8_t* s_kv = smem + NWG * TILE_BYTES;    // [ST] tiles of 64 keys
  uint64_t* full = reinterpret_cast<uint64_t*>(s_kv + ST * TILE_BYTES);
  uint64_t* q_full = full + 2 * ST;           // [NWG]
  const Block bl = block_setup<C::ROWS, BK>(a);
  const Ring ring{&cmap, &krmap, s_kv, full, full + ST, bl.b, bl.k_first, ST};
  const int w = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 4 * NWG);  // one arrival a warp
    }
    for (int g = 0; g < NWG; ++g) hopper::mbar_init(&q_full[g], 1);
    hopper::fence_barrier_init();
    for (int g = 0; g < NWG; ++g) hopper::mbar_expect_tx(&q_full[g], TILE_BYTES);
    for (int t = 0; t < min(ST, bl.n_tiles); ++t) ring.load(t);
  }
  __syncthreads();
  // each warp's first thread loads 16 of its warpgroup's 64 Q rows
  uint8_t* sq = s_q + w * TILE_BYTES;
  if (threadIdx.x % 32 == 0)
    for (int j = 16 * warp; j < 16 * warp + 16; j += 8)
      ring.load_q(sq, &qmap, &qrmap, &q_full[w], a, bl.m0 + 64 * w + j, j);
  consume<NWG, SPLIT>(a, bl, sq, &q_full[w], ring, w, threadIdx.x % 128);
}

__global__ void __launch_bounds__(Wg<2>::THREADS, Wg<2>::MIN_BLOCKS)
mla_prefill_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap qrmap,
                      const __grid_constant__ CUtensorMap cmap,
                      const __grid_constant__ CUtensorMap krmap,
                      const Args a) {
  wgmma_block<2, false>(qmap, qrmap, cmap, krmap, a);
}

__global__ void __launch_bounds__(Wg<1>::THREADS, Wg<1>::MIN_BLOCKS)
mla_decode_partial_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap qrmap,
                         const __grid_constant__ CUtensorMap cmap,
                         const __grid_constant__ CUtensorMap krmap,
                         const Args a) {
  wgmma_block<1, true>(qmap, qrmap, cmap, krmap, a);
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
  // Q boxes of 8 flattened rows: 8 heads of a position, or every head of
  // 8 / h positions
  a.qbh = h % 8 == 0 ? 8 : h;
  a.qbi = h % 8 == 0 ? 1 : 8 / h;
  return a;
}

bool bad_shape(int batch, int sq, int sk, int h, int r, int dr, int nsplit,
               float scale) {
  return r != R || dr != DR || batch < 0 || sq < 0 || sk < 0 || h <= 0 ||
         nsplit <= 0 || !(scale > 0.f);
}

// bf16's tensor maps, at the wrapper's element strides: c and k_rope
// (columns, keys, batch), boxes of BK keys; q_lat and q_rope (columns,
// heads, positions, batch), boxes of qbh heads by qbi positions (8 rows);
// 64 columns a box with the 128-byte swizzle (latent) or 32 with the
// 64-byte swizzle (rope); rows past the last read as zeros
int encode_maps(CUtensorMap* maps, const Args& a, int batch) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return hopper::TMAP_ERROR + CUDA_ERROR_NOT_FOUND;
  struct Map {
    const void* base;
    int cols, rank;
    long long s1, s2, s3;    // element strides of dimensions 1 .. rank - 1
    int d1, d2, b1, b2;      // sizes and box sizes of dimensions 1, 2
  };
  const Map ms[4] = {
      {a.q_lat, R, 4, a.ql_sh, a.ql_ss, a.ql_sb, a.h, a.sq, a.qbh, a.qbi},
      {a.q_rope, DR, 4, a.qr_sh, a.qr_ss, a.qr_sb, a.h, a.sq, a.qbh, a.qbi},
      {a.c, R, 3, a.c_ss, a.c_sb, 0, a.sk, batch, BK, 1},
      {a.kr, DR, 3, a.kr_ss, a.kr_sb, 0, a.sk, batch, BK, 1}};
  for (int k = 0; k < 4; ++k) {
    const Map& m = ms[k];
    const cuuint64_t dims[4] = {cuuint64_t(m.cols), cuuint64_t(m.d1),
                                cuuint64_t(m.d2), cuuint64_t(batch)};
    const cuuint64_t strides[3] = {cuuint64_t(m.s1) * 2, cuuint64_t(m.s2) * 2,
                                   cuuint64_t(m.s3) * 2};
    const cuuint32_t box[4] = {cuuint32_t(m.cols < 64 ? m.cols : 64),
                               cuuint32_t(m.b1), cuuint32_t(m.b2), 1};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    const CUresult r = fn(
        &maps[k], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, m.rank,
        const_cast<void*>(m.base), dims, strides, box, one,
        CU_TENSOR_MAP_INTERLEAVE_NONE,
        m.cols == R ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return hopper::TMAP_ERROR + static_cast<int>(r);
  }
  return 0;
}

// one launch over every row of a (Sq H of each batch row) and every split:
// the prefill's normalised rows, or the decode's split partials
template <typename T, bool SPLIT>
int launch_rows(const Args& a, int batch, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.sq) * a.h;
  if constexpr (std::is_same_v<T, float>) {
    const auto kernel = SPLIT ? mla_decode_partial : mla_prefill_fwd;
    constexpr size_t smem = smem_bytes<float>();
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>((rows + ROWS - 1) / ROWS),
                    a.nsplit, batch);
    kernel<<<grid, THREADS, smem, st>>>(a);
  } else {
    using C = Wg<SPLIT ? 1 : 2>;
    const auto kernel =
        SPLIT ? mla_decode_partial_wgmma : mla_prefill_fwd_wgmma;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    CUtensorMap maps[4];
    const int me = encode_maps(maps, a, batch);
    if (me != 0) return me;
    const dim3 grid(static_cast<unsigned>((rows + C::ROWS - 1) / C::ROWS),
                    a.nsplit, batch);
    kernel<<<grid, C::THREADS, C::SMEM, st>>>(maps[0], maps[1], maps[2],
                                              maps[3], a);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 boxes Q in 8 rows: H must divide 8 or be a multiple of it
template <typename T>
bool bad_heads(int h) {
  return !std::is_same_v<T, float> && h % 8 != 0 && 8 % h != 0;
}

template <typename T>
int prefill(const void* q_lat, const void* q_rope, const void* c,
            const void* kr, void* out, int batch, int sq, int sk, int h,
            int r, int dr, const long long* strides, float scale,
            void* stream) {
  if (bad_shape(batch, sq, sk, h, r, dr, 1, scale) || sq > sk ||
      bad_heads<T>(h))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(sq) * h;
  if (batch == 0 || rows == 0) return static_cast<int>(cudaSuccess);
  const Args a = make_args(q_lat, q_rope, c, kr, nullptr, out, nullptr,
                           nullptr, sq, sk, h, 1, strides, scale);
  return launch_rows<T, false>(a, batch, static_cast<cudaStream_t>(stream));
}

template <typename T>
int decode(const void* q_lat, const void* q_rope, const void* c,
           const void* kr, const void* lengths, void* out, void* part_ml,
           void* part_acc, int batch, int s_len, int h, int r, int dr,
           int nsplit, const long long* strides, float scale, void* stream) {
  if (bad_shape(batch, 1, s_len, h, r, dr, nsplit, scale) ||
      bad_heads<T>(h))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (s_len > 0) {
    const Args a = make_args(q_lat, q_rope, c, kr, lengths, out, part_ml,
                             part_acc, 1, s_len, h, nsplit, strides, scale);
    const int e = launch_rows<T, true>(a, batch, st);
    if (e != 0) return e;
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
// address and stride is 16-byte aligned (cp.async, TMA); in bf16 c's and
// k_rope's are those of TMA's maps: positive, a dimension of size 1 given
// the stride a contiguous tensor would have.  R must be 256 and Dr 32.
// out: a contiguous (B, Sq, H, R) tensor of the input type.
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
