// Flash-decode for Hopper (sm_90a), float and bfloat16: one query token per
// batch row against its KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention/decode_attention.py (`_kernel`): q
// (B, 1, H, dh) against a cache k/v (B, S, KV, dh), keys at positions
// <= length visible (length is the last valid index, the new token's own
// slot, not a count), the rep = H / KV query heads of one kv head together,
// f32 running max, sum and accumulator.  Two extensions, what the reference
// model and serving engine compute: `length` is one int32 per batch row (a
// (B,) device tensor; the reference engine vmaps the scalar kernel over its
// lanes), and a sliding window (the reference model's decode masks keys to
// `k_pos > length - window`, repro/models/layers.py `chunked_attention`).
// A lane sees the keys [lo, hi): hi = min(length, S - 1) + 1 (length >= S
// sees to the end of the cache: the reference engine lets idle lanes'
// lengths run past it), lo = max(0, length - window + 1) with the length as
// given, not clamped, or 0 without a window (window = 0).  length < 0, or a
// window that lies wholly past the cache, sees nothing and returns 0.
//
// Bound.  Decoding reads each visible cache row once: 2 (hi - lo) KV dh
// elements per batch row, plus q and o; ~2 FLOP per element read, far below
// the ~295 FLOP per byte at which the tensor cores would bound it.  So the
// least time is those bytes over the HBM rate (3.35 TB/s), and the design
// is about reading only the visible rows, at full width, with every thread
// busy.  Every sum is in f32.
//
// Design (split-K flash-decoding).  The TPU kernel walks the cache blocks in
// order, carrying the softmax state in scratch from one grid step to the
// next; Hopper's blocks run in parallel and carry nothing, so:
//   1. The partials: one block of 128 threads per (split, kv head, batch
//      row), `nsplit` splits chosen by the wrapper from B KV so that the
//      working blocks fill the card about twice.  Each block reads its
//      lane's length and takes an equal share of that lane's visible keys
//      [lo, hi), rounded up to the tile and starting at lo: no host
//      synchronisation, and no block reads a row outside [lo, hi) (a tile
//      starts at its share's first key, so lo need not be tile-aligned).
//      A share that is empty writes
//      (m = -inf, l = 0), which adds exactly 0.  The share streams through
//      a ring of tiles in shared memory, filled by 16-byte cp.async copies
//      and kept in the stored type.  At the end the block merges its
//      warps' states in a fixed order through shared memory and writes one
//      partial (m, l, acc) per head.
//      bf16, `decode_partial_mma`: 64-row tiles, chunks swizzled for
//      ldmatrix, rows past the share zero-filled; the scores and P V on
//      the tensor cores by mma m16n8k16, 16 heads a pass (rows past rep
//      are zero and cost no memory traffic), f32 sums.  It is faster than
//      a CUDA-core loop at every rep measured, 1 to 8 (PERF.md).
//      f32, `decode_partial`, on the CUDA cores (TF32 would not keep the
//      f32 path's precision): lanes map to (key, dh slice), LPK = dh / 4
//      lanes cover one key, 16 bytes each.  Those lane groups are split
//      into HG head groups x KG key groups; each lane keeps the scaled q
//      slices, the running max, sum and accumulator slice of HPL heads in
//      registers, so every rep head of the kv head is served by one pass
//      over each staged tile while HG HPL >= rep (up to 8 at dh 128 and 16
//      at dh 64); wider groups take 2-4 passes, each re-reading the share.
//      A score's partial dot products are summed over the key's LPK lanes
//      by shuffles.  With rep = 1 no lane idles: the lane groups take
//      different keys.  The online softmax rescales only when a key raises
//      the running max.
//   2. `decode_combine`: one block per (q head, batch row) merges the
//      partials in split order.  No atomics anywhere, so two calls give the
//      same bits.
//
// Plain C interface for ctypes: the entry points launch both kernels on the
// given stream, do not synchronise, and return the first cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;      // cache rows per staged tile (f32)
constexpr int STAGES = 4;     // tiles in the ring (f32)
constexpr int MAX_REP = 32;   // query heads per kv head
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the keys [lo, hi) that batch row b sees (see the top of the file)
struct Visible {
  int lo, hi;
};

__device__ __forceinline__ Visible visible(int len, int s_len, int window) {
  if (len < 0) return {0, 0};
  const int hi = min(len, s_len - 1) + 1;
  // len - window + 1 in 64 bits: a length near INT_MAX must not wrap
  long long lo = window > 0 ? static_cast<long long>(len) - window + 1 : 0;
  if (lo < 0) lo = 0;
  if (lo > hi) lo = hi;
  return {static_cast<int>(lo), hi};
}

// this split's share [k_first, k_stop) of [lo, hi): shares of equal length,
// a multiple of `tile`, in split order
__device__ __forceinline__ void split_share(Visible vis, int nsplit, int sp,
                                            int tile, int& k_first,
                                            int& k_stop) {
  const int n = vis.hi - vis.lo;
  const int share = ((n + nsplit - 1) / nsplit + tile - 1) / tile * tile;
  k_first = vis.lo + sp * share;
  k_stop = min(vis.hi, k_first + share);
}

// ---- f32: the CUDA cores ---------------------------------------------------
constexpr int EPL = 4;          // floats per lane (16 bytes)

template <int DH>
struct Geo {
  static constexpr int LPK = DH / EPL;         // lanes per key
  static constexpr int SLOTS = 32 / LPK;       // lane groups per warp
  static constexpr size_t RING =
      size_t(STAGES) * 2 * TILE * DH * sizeof(float);
};

// shared memory of one block: the ring, then the merge area for hpp heads
template <int DH>
size_t smem_bytes(int hpp, int kg) {
  return Geo<DH>::RING + size_t(hpp) * WARPS * kg * (DH + 2) * sizeof(float);
}

template <int DH, int HPL>
__global__ void __launch_bounds__(THREADS)
decode_partial(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ part_ml, float* __restrict__ part_acc,
               int s_len, int h, int rep, int hg_n, int kg_n,
               long long q_sb, long long kv_sb, long long kv_ss, int nsplit,
               int window, float scale_log2) {
  constexpr int LPK = Geo<DH>::LPK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);    // [STAGES][K|V][TILE][DH]
  float* merge = reinterpret_cast<float*>(smem + Geo<DH>::RING);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j = lane % LPK;            // this lane's dh slice
  const int grp = lane / LPK;
  const int hg = grp % hg_n, kg = grp / hg_n;
  const int nslot = WARPS * kg_n;      // partial states per head in a block
  const int slot = warp * kg_n + kg;
  const int hpp = hg_n * HPL;          // heads per pass
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;

  // this split's share of the visible keys [lo, hi)
  int k_first, k_stop;
  split_share(visible(lengths[b], s_len, window), nsplit, sp, TILE, k_first,
              k_stop);
  // partial (b, head g * rep + r, sp) sits at p0 + r * nsplit
  const long long p0 =
      (static_cast<long long>(b) * h + static_cast<long long>(g) * rep) *
          nsplit + sp;

  if (k_first >= k_stop) {  // nothing visible here: adds exactly 0
    for (int r = tid; r < rep; r += THREADS) {
      part_ml[2 * (p0 + r * nsplit)] = -INFINITY;
      part_ml[2 * (p0 + r * nsplit) + 1] = 0.f;
    }
    return;
  }

  const float* qb = q + b * q_sb + static_cast<long long>(g) * rep * DH;
  const float* kb = k + b * kv_sb + static_cast<long long>(g) * DH;
  const float* vb = v + b * kv_sb + static_cast<long long>(g) * DH;
  const int n_tiles = (k_stop - k_first + TILE - 1) / TILE;
  const int steps = TILE / (WARPS * kg_n);  // key steps of a warp per tile

  // 16-byte copies of the tile's visible rows into stage t % STAGES
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const int k0 = k_first + t * TILE;
      const int rows = min(TILE, k_stop - k0);
      float* ks = ring + (t % STAGES) * 2 * TILE * DH;
      float* vs = ks + TILE * DH;
      for (int c = tid; c < rows * LPK; c += THREADS) {
        const int row = c / LPK, part = c % LPK;
        const long long off = (k0 + row) * kv_ss + part * EPL;
        hopper::cp_async_16(ks + row * DH + part * EPL, kb + off);
        hopper::cp_async_16(vs + row * DH + part * EPL, vb + off);
      }
    }
    hopper::cp_async_commit();  // an empty group past the end keeps counts
  };

  for (int pass = 0; pass * hpp < rep; ++pass) {
    const int h0 = pass * hpp + hg * HPL;  // this lane's first head
    float qf[HPL][EPL], acc[HPL][EPL], m[HPL], l[HPL];
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      const int r = h0 + i;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        qf[i][e] = r < rep ? qb[r * DH + j * EPL + e] * scale_log2 : 0.f;
        acc[i][e] = 0.f;
      }
      m[i] = -INFINITY;
      l[i] = 0.f;
    }

#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) load_tile(t);
    for (int t = 0; t < n_tiles; ++t) {
      load_tile(t + STAGES - 1);
      hopper::cp_async_wait<STAGES - 1>();  // tile t has landed (this thread)
      __syncthreads();                      // ... for every thread
      const float* ks = ring + (t % STAGES) * 2 * TILE * DH;
      const float* vs = ks + TILE * DH;
      const int rows = min(TILE, k_stop - (k_first + t * TILE));
      for (int st = 0; st < steps; ++st) {
        const int key = (st * WARPS + warp) * kg_n + kg;
        const float4 k4 =
            *reinterpret_cast<const float4*>(ks + key * DH + j * EPL);
        const float kf[EPL] = {k4.x, k4.y, k4.z, k4.w};
        float d[HPL];
#pragma unroll
        for (int i = 0; i < HPL; ++i) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) x = fmaf(qf[i][e], kf[e], x);
          d[i] = x;
        }
        // the key's LPK lanes are neighbours: sum their partial products
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < HPL; ++i)
            d[i] += __shfl_xor_sync(0xffffffffu, d[i], off);
        if (key < rows) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vs + key * DH + j * EPL);
          const float vf[EPL] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < HPL; ++i) {
            if (d[i] > m[i]) {  // a new running max: rescale
              const float alpha = exp2f(m[i] - d[i]);
              l[i] *= alpha;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[i][e] *= alpha;
              m[i] = d[i];
            }
            const float p = exp2f(d[i] - m[i]);
            l[i] += p;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
          }
        }
      }
      __syncthreads();  // stage t % STAGES is free for tile t + STAGES
    }
    hopper::cp_async_wait<0>();

    // merge the block's partial states of each head, in slot order
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      float* at = merge + ((hg * HPL + i) * nslot + slot) * (DH + 2);
#pragma unroll
      for (int e = 0; e < EPL; ++e) at[j * EPL + e] = acc[i][e];
      if (j == 0) {
        at[DH] = m[i];
        at[DH + 1] = l[i];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < hpp * DH; idx += THREADS) {
      const int rr = idx / DH, dd = idx % DH, r = pass * hpp + rr;
      if (r >= rep) continue;
      const float* at = merge + rr * nslot * (DH + 2);
      float mm = -INFINITY;
      for (int s2 = 0; s2 < nslot; ++s2) mm = fmaxf(mm, at[s2 * (DH + 2) + DH]);
      float ll = 0.f, aa = 0.f;
      for (int s2 = 0; s2 < nslot; ++s2) {
        const float ms = at[s2 * (DH + 2) + DH];
        if (ms == -INFINITY) continue;  // a slot that saw no key
        const float w = exp2f(ms - mm);
        ll = fmaf(at[s2 * (DH + 2) + DH + 1], w, ll);
        aa = fmaf(at[s2 * (DH + 2) + dd], w, aa);
      }
      const long long pa = p0 + static_cast<long long>(r) * nsplit;
      part_acc[pa * DH + dd] = aa;
      if (dd == 0) {
        part_ml[2 * pa] = mm;
        part_ml[2 * pa + 1] = ll;
      }
    }
    __syncthreads();  // the merge area and the ring are free again
  }
}

// ---- bf16: the scores and P V on the tensor cores ---------------------------
constexpr int MMA_TILE = 64;    // cache rows per staged tile: 16 per warp
constexpr int MMA_STAGES = 3;
constexpr int MMA_HEADS = 16;   // query heads per pass (the mma's M)

template <int DH>
constexpr size_t mma_smem_bytes() {
  return size_t(MMA_STAGES) * 2 * MMA_TILE * DH * sizeof(__nv_bfloat16);
}

// element offset of 16-byte chunk `c` of row `r` in a [rows][DH] bf16 tile
// whose chunks are XOR-swizzled by r % 8 (ldmatrix reads 8 rows of one
// chunk without bank conflicts)
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & 7)) << 3);
}

// One block of 4 warps per (split, kv head, batch row), as decode_partial;
// each warp takes 16 rows of every 64-row tile.  Per warp and tile:
// S (16 heads x 16 keys) = Q K^T by mma m16n8k16 (Q as the A operand from
// registers, rows past rep zero; K through ldmatrix), the online softmax on
// the accumulator fragment (each thread holds heads g and g + 8, keys 2t,
// 2t + 1 of each 8), P converted to bf16 in registers as the A operand of
// O += P V (V through ldmatrix.trans).  Sums stay in f32; the scale is
// applied to S in f32.
template <int DH>
__global__ void __launch_bounds__(THREADS)
decode_partial_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ lengths,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int s_len, int h, int rep, long long q_sb,
                   long long kv_sb, long long kv_ss, int nsplit, int window,
                   float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr int CH = DH / 8;   // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [STAGES][K|V][TILE][DH]
  float* merge = reinterpret_cast<float*>(smem);  // after the ring is done

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int sp = blockIdx.x, kvh_i = blockIdx.y, b = blockIdx.z;
  int k_first, k_stop;
  split_share(visible(lengths[b], s_len, window), nsplit, sp, MMA_TILE,
              k_first, k_stop);
  const long long p0 =
      (static_cast<long long>(b) * h + static_cast<long long>(kvh_i) * rep) *
          nsplit + sp;
  if (k_first >= k_stop) {
    for (int r = tid; r < rep; r += THREADS) {
      part_ml[2 * (p0 + r * nsplit)] = -INFINITY;
      part_ml[2 * (p0 + r * nsplit) + 1] = 0.f;
    }
    return;
  }
  const bf16* qb = q + b * q_sb + static_cast<long long>(kvh_i) * rep * DH;
  const bf16* kb = k + b * kv_sb + static_cast<long long>(kvh_i) * DH;
  const bf16* vb = v + b * kv_sb + static_cast<long long>(kvh_i) * DH;
  const int n_tiles = (k_stop - k_first + MMA_TILE - 1) / MMA_TILE;
  const int kw0 = warp * 16;   // this warp's rows of a tile

  // 16-byte copies of a tile; rows past the share are zero-filled, so that
  // P = 0 never meets stale bits of V
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const int k0 = k_first + t * MMA_TILE;
      const int rows = min(MMA_TILE, k_stop - k0);
      bf16* ks = ring + (t % MMA_STAGES) * 2 * MMA_TILE * DH;
      bf16* vs = ks + MMA_TILE * DH;
      for (int c = tid; c < MMA_TILE * CH; c += THREADS) {
        const int row = c / CH, ch = c % CH;
        const bool in = row < rows;
        const long long off = in ? (k0 + row) * kv_ss + ch * 8 : 0;
        hopper::cp_async_16_or_zero(ks + swz<DH>(row, ch), kb + off, in);
        hopper::cp_async_16_or_zero(vs + swz<DH>(row, ch), vb + off, in);
      }
    }
    hopper::cp_async_commit();
  };

  for (int pass = 0; pass * MMA_HEADS < rep; ++pass) {
    const int h0 = pass * MMA_HEADS;
    // Q as A fragments: rows g, g + 8 (heads), columns 2 t4 (+8) of each
    // 16-wide slice of dh
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int head = h0 + g + 8 * (i % 2);
        const int col = 16 * kk + 2 * t4 + 8 * (i / 2);
        qa[kk][i] = head < rep ? *reinterpret_cast<const uint32_t*>(
                                     qb + head * DH + col)
                               : 0u;
      }
    float o[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

#pragma unroll
    for (int t = 0; t < MMA_STAGES - 1; ++t) load_tile(t);
    for (int t = 0; t < n_tiles; ++t) {
      load_tile(t + MMA_STAGES - 1);
      hopper::cp_async_wait<MMA_STAGES - 1>();
      __syncthreads();
      const bf16* ks = ring + (t % MMA_STAGES) * 2 * MMA_TILE * DH;
      const bf16* vs = ks + MMA_TILE * DH;
      const int rows = min(MMA_TILE, k_stop - (k_first + t * MMA_TILE));
      if (kw0 < rows) {  // warp-uniform: some of this warp's rows are seen
        const int mi = lane / 8, rr = lane % 8;
        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t kf[4];  // K^T fragments of keys 0-7 and 8-15
          hopper::ldmatrix_x4(
              kf, ks + swz<DH>(kw0 + (mi / 2) * 8 + rr, 2 * kk + mi % 2));
          hopper::mma_16816(s[0], qa[kk], kf[0], kf[1]);
          hopper::mma_16816(s[1], qa[kk], kf[2], kf[3]);
        }
        // s[n][i]: head g + 8 (i / 2), key kw0 + 8 n + 2 t4 + i % 2
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (kw0 + 8 * n + 2 * t4 + i % 2 >= rows) s[n][i] = -INFINITY;
            if (i < 2) mx0 = fmaxf(mx0, s[n][i]);
            else mx1 = fmaxf(mx1, s[n][i]);
          }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0 * scale_log2);
        const float mn1 = fmaxf(m1, mx1 * scale_log2);
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
        m0 = mn0;
        m1 = mn1;
        uint32_t pa[4];  // P as the A fragment: keys 0-7 then 8-15
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float mu = hi ? mu1 : mu0;
            const float pl = exp2f(fmaf(s[n][2 * hi], scale_log2, -mu));
            const float ph = exp2f(fmaf(s[n][2 * hi + 1], scale_log2, -mu));
            if (hi) rs1 += pl + ph;
            else rs0 += pl + ph;
            __nv_bfloat162 pp = __floats2bfloat162_rn(pl, ph);
            pa[2 * n + hi] = *reinterpret_cast<uint32_t*>(&pp);
          }
        l0 = l0 * al0 + rs0;
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[j][0] *= al0;
          o[j][1] *= al0;
          o[j][2] *= al1;
          o[j][3] *= al1;
        }
#pragma unroll
        for (int jj = 0; jj < DH / 16; ++jj) {
          uint32_t vf[4];  // V fragments of dh columns 16 jj .. 16 jj + 15
          hopper::ldmatrix_x4_trans(
              vf, vs + swz<DH>(kw0 + (mi % 2) * 8 + rr, 2 * jj + mi / 2));
          hopper::mma_16816(o[2 * jj], pa, vf[0], vf[1]);
          hopper::mma_16816(o[2 * jj + 1], pa, vf[2], vf[3]);
        }
      }
      __syncthreads();
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // the ring is free: the merge area overlays it

    // each head's 4 warp states, merged in warp order
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float* at = merge + ((g + 8 * hi) * WARPS + warp) * (DH + 2);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        at[8 * j + 2 * t4] = o[j][2 * hi];
        at[8 * j + 2 * t4 + 1] = o[j][2 * hi + 1];
      }
      if (t4 == 0) {
        at[DH] = hi ? m1 : m0;
        at[DH + 1] = hi ? l1 : l0;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < MMA_HEADS * DH; idx += THREADS) {
      const int rr2 = idx / DH, dd = idx % DH, r = h0 + rr2;
      if (r >= rep) continue;
      const float* at = merge + rr2 * WARPS * (DH + 2);
      float mm = -INFINITY;
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, at[w * (DH + 2) + DH]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        const float ms = at[w * (DH + 2) + DH];
        if (ms == -INFINITY) continue;
        const float wt = exp2f(ms - mm);
        ll = fmaf(at[w * (DH + 2) + DH + 1], wt, ll);
        aa = fmaf(at[w * (DH + 2) + dd], wt, aa);
      }
      const long long pa2 = p0 + static_cast<long long>(r) * nsplit;
      part_acc[pa2 * DH + dd] = aa;
      if (dd == 0) {
        part_ml[2 * pa2] = mm;
        part_ml[2 * pa2 + 1] = ll;
      }
    }
    __syncthreads();
  }
}

template <typename T, int DH>
__global__ void decode_combine(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               T* __restrict__ o, int h, int nsplit) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * h + head) * nsplit;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_ml[2 * (base + s)]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float ms = part_ml[2 * (base + s)];
    if (ms == -INFINITY) continue;  // a split with no visible key
    const float w = exp2f(ms - m);
    l = fmaf(part_ml[2 * (base + s) + 1], w, l);
    a = fmaf(part_acc[(base + s) * DH + d], w, a);
  }
  o[(static_cast<long long>(b) * h + head) * DH + d] =
      from_f<T>(l > 0.f ? a / l : 0.f);
}

template <int DH, int HPL>
int launch_partial(const void* q, const void* k, const void* v,
                   const void* lengths, void* part_ml, void* part_acc,
                   int batch, int s_len, int h, int kvh, int hg, int kg,
                   long long q_sb, long long kv_sb, long long kv_ss,
                   int nsplit, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(hg * HPL, kg);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_partial<DH, HPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_partial<DH, HPL><<<dim3(nsplit, kvh, batch), THREADS, smem,
                            stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), s_len, h,
      h / kvh, hg, kg, q_sb, kv_sb, kv_ss, nsplit, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* part_ml, void* part_acc, int batch, int s_len,
           int h, int kvh, long long q_sb, long long kv_sb, long long kv_ss,
           int nsplit, int window, float scale, cudaStream_t stream) {
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const int rep = h / kvh;
  int err = 0;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (s_len > 0) {
      constexpr size_t smem = mma_smem_bytes<DH>();
      const cudaError_t e = cudaFuncSetAttribute(
          decode_partial_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      decode_partial_mma<DH><<<dim3(nsplit, kvh, batch), THREADS, smem,
                               stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const int*>(lengths), static_cast<float*>(part_ml),
          static_cast<float*>(part_acc), s_len, h, rep, q_sb, kv_sb, kv_ss,
          nsplit, window, scale * LOG2E);
      err = static_cast<int>(cudaGetLastError());
    }
  } else if (s_len > 0) {
    // lane groups of a warp: HG head groups (a power of two <= rep) x KG
    // key groups; each lane serves HPL heads (<= 8 registers-worth)
    const int slots = Geo<DH>::SLOTS;
    int hg = 1;
    while (hg * 2 <= slots && hg * 2 <= rep) hg *= 2;
    const int kg = slots / hg;
    const int want = (rep + hg - 1) / hg;
    if (want <= 1)
      err = launch_partial<DH, 1>(q, k, v, lengths, part_ml, part_acc, batch,
                                  s_len, h, kvh, hg, kg, q_sb, kv_sb, kv_ss,
                                  nsplit, window, scale, stream);
    else if (want <= 2)
      err = launch_partial<DH, 2>(q, k, v, lengths, part_ml, part_acc, batch,
                                  s_len, h, kvh, hg, kg, q_sb, kv_sb, kv_ss,
                                  nsplit, window, scale, stream);
    else if (want <= 4)
      err = launch_partial<DH, 4>(q, k, v, lengths, part_ml, part_acc, batch,
                                  s_len, h, kvh, hg, kg, q_sb, kv_sb, kv_ss,
                                  nsplit, window, scale, stream);
    else
      err = launch_partial<DH, 8>(q, k, v, lengths, part_ml, part_acc, batch,
                                  s_len, h, kvh, hg, kg, q_sb, kv_sb, kv_ss,
                                  nsplit, window, scale, stream);
  }
  if (err != 0) return err;
  decode_combine<T, DH><<<dim3(h, batch), DH, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(o), h, s_len > 0 ? nsplit : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* o, void* part_ml, void* part_acc, int batch, int s_len,
             int h, int kvh, int dh, long long q_sb, long long kv_sb,
             long long kv_ss, int nsplit, int window, float scale,
             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || h % kvh != 0 || h / kvh > MAX_REP || nsplit <= 0 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64)
    return launch<T, 64>(q, k, v, lengths, o, part_ml, part_acc, batch, s_len,
                         h, kvh, q_sb, kv_sb, kv_ss, nsplit, window, scale,
                         st);
  if (dh == 128)
    return launch<T, 128>(q, k, v, lengths, o, part_ml, part_acc, batch,
                          s_len, h, kvh, q_sb, kv_sb, kv_ss, nsplit, window,
                          scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, 1, H, dh) with heads packed (stride dh), dh contiguous, batch stride
// q_sb; k/v (B, S, KV, dh) with heads packed, batch and sequence strides
// kv_sb / kv_ss in elements, base and strides 16-byte aligned (cp.async);
// lengths (B,) int32 on the card; o a contiguous (B, 1, H, dh) tensor;
// part_ml (B, H, nsplit, 2) and part_acc (B, H, nsplit, dh) float scratch,
// nsplit the number of splits of each lane's visible keys; window the
// sliding window (0: none).
int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, void* part_ml,
                         void* part_acc, int batch, int s_len, int h, int kvh,
                         int dh, long long q_sb, long long kv_sb,
                         long long kv_ss, int nsplit, int window, float scale,
                         void* stream) {
  return dispatch<float>(q, k, v, lengths, o, part_ml, part_acc, batch, s_len,
                         h, kvh, dh, q_sb, kv_sb, kv_ss, nsplit, window, scale,
                         stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* o, void* part_ml,
                          void* part_acc, int batch, int s_len, int h,
                          int kvh, int dh, long long q_sb, long long kv_sb,
                          long long kv_ss, int nsplit, int window, float scale,
                          void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, o, part_ml, part_acc,
                                 batch, s_len, h, kvh, dh, q_sb, kv_sb, kv_ss,
                                 nsplit, window, scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
