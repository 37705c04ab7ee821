// Flash-decode for Hopper (sm_90a), float and bfloat16: one query token per
// batch row against its KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention/decode_attention.py (`_kernel`): q
// (B, 1, H, dh) against a cache k/v (B, S, KV, dh), keys at positions
// <= length visible (length is the last valid index, the new token's own
// slot, not a count), the rep = H / KV query heads of one kv head together,
// f32 running max, sum and accumulator.  One extension, what the reference
// serving engine computes: `length` is one int32 per batch row (a (B,)
// device tensor; the reference engine vmaps the scalar kernel over its
// lanes).  length >= S sees the whole cache (the reference engine lets idle
// lanes' lengths run past it).
//
// Bound.  Decoding reads each visible cache row once: 2 (length + 1) KV dh
// elements per batch row, plus q and o; ~2 FLOP per element read, far below
// the ~295 FLOP per byte at which the tensor cores would bound it.  So the
// least time is those bytes over the HBM rate (3.35 TB/s), and the kernel's
// design is about reading only the visible rows and reading them in
// parallel.
//
// Design (split-K flash-decoding).  The TPU kernel walks the cache blocks in
// order, carrying the softmax state in scratch from one grid step to the
// next; Hopper's blocks run in parallel and carry nothing, so:
//   1. `decode_partial`: one block of 128 threads per (cache split of
//      `split` keys, kv head, batch row).  A split with no visible key
//      writes (m = -inf, l = 0) and returns at once, so it adds exactly 0
//      and costs no cache reads.  Otherwise the block streams its visible
//      rows in 64-key tiles through shared memory (only visible rows are
//      read) and runs an online softmax for up to 8 of the kv head's query
//      heads at a time (more passes for rep > 8): 16 threads per head row
//      own 4 key columns of the score tile and dh / 16 columns of the
//      accumulator, so the running max, sum and accumulator stay in
//      registers, reduced across the row's 16 lanes with warp shuffles (the
//      flash-attention kernel's layout).  It writes each head's partial
//      (m, l, acc) to a scratch tensor that the wrapper allocates.
//   2. `decode_combine`: one block per (q head, batch row) merges the
//      partials in split order.  No atomics anywhere, so two calls give the
//      same bits.
// With rep = 1 (Qwen) 7 of the 8 head rows idle; the kernel is bound by its
// reads, not its arithmetic.  The P.V loop runs over the whole tile (the
// weights past the visible rows are 0): an earlier version whose loop
// stopped at the visible row count sent nvcc 12.9's front end (cicc) into a
// compile that did not finish.  Later versions: 16-byte vector loads, a
// cp.async/TMA ring, all rep heads in one pass, and a split count chosen
// from the lengths rather than fixed.
//
// Plain C interface for ctypes: the entry points launch both kernels on the
// given stream, do not synchronise, and return the first cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TX = 16;                // threads per head row
constexpr int ROWS = THREADS / TX;    // head rows per pass
constexpr int TILE = 64;              // cache rows staged per step
constexpr int CPT = TILE / TX;        // score columns per thread
constexpr int MAX_REP = 32;           // query heads per kv head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
struct Layout {
  static constexpr int KP = DH + 1;    // padded row of Q and K
  static constexpr int PP = TILE + 1;  // padded row of P
  static constexpr size_t bytes =
      (size_t(ROWS) * KP + size_t(TILE) * KP + size_t(TILE) * DH +
       size_t(ROWS) * PP) * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ part_ml, float* __restrict__ part_acc,
               int s_len, int h, int rep, long long q_sb, long long kv_sb,
               long long kv_ss, int split, int nsplit, float scale) {
  constexpr int KP = Layout<DH>::KP;
  constexpr int PP = Layout<DH>::PP;
  constexpr int DPT = DH / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [ROWS][KP], scaled
  float* Ks = Qs + ROWS * KP;   // [TILE][KP]
  float* Vs = Ks + TILE * KP;   // [TILE][DH]
  float* Ps = Vs + TILE * DH;   // [ROWS][PP]

  const int tid = threadIdx.x;
  const int r = tid / TX, tx = tid % TX;
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  // the visible keys are [0, min(len, S - 1)]; this split's share of them
  const int k_first = sp * split;
  const int k_last = min(sp * split + split - 1, min(len, s_len - 1));
  // partial (b, head g * rep + j, sp) sits at p0 + j * nsplit
  const long long p0 =
      (static_cast<long long>(b) * h + static_cast<long long>(g) * rep) *
          nsplit + sp;

  if (k_first > k_last) {  // nothing visible here: adds exactly 0
    for (int j = tid; j < rep; j += THREADS) {
      part_ml[2 * (p0 + j * nsplit)] = -INFINITY;
      part_ml[2 * (p0 + j * nsplit) + 1] = 0.f;
    }
    return;
  }

  const T* qb = q + b * q_sb + static_cast<long long>(g) * rep * DH;
  const T* kb = k + b * kv_sb + static_cast<long long>(g) * DH;
  const T* vb = v + b * kv_sb + static_cast<long long>(g) * DH;

  for (int r0 = 0; r0 < rep; r0 += ROWS) {
    __syncthreads();  // the previous pass is done with Qs, Ks, Vs, Ps
    for (int e = tid; e < ROWS * DH; e += THREADS) {
      const int rr = e / DH, c = e % DH;
      Qs[rr * KP + c] =
          r0 + rr < rep ? to_f(qb[(r0 + rr) * DH + c]) * scale : 0.f;
    }
    float m = -INFINITY, l = 0.f, acc[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

    const int n_tiles = (k_last - k_first) / TILE + 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = k_first + t * TILE;
      const int rows = min(TILE, k_last - k0 + 1);
      __syncthreads();  // Q is staged; the last tile is used
      for (int e = tid; e < TILE * DH; e += THREADS) {
        const int rr = e / DH, c = e % DH;
        float kx = 0.f, vx = 0.f;
        if (rr < rows) {
          const long long off = (k0 + rr) * kv_ss + c;
          kx = to_f(kb[off]);
          vx = to_f(vb[off]);
        }
        Ks[rr * KP + c] = kx;
        Vs[rr * DH + c] = vx;
      }
      __syncthreads();

      float s[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] = 0.f;
      for (int d = 0; d < DH; ++d) {
        const float qv = Qs[r * KP + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          s[j] = fmaf(qv, Ks[(tx + TX * j) * KP + d], s[j]);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (tx + TX * j >= rows) s[j] = -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      // the 16 threads of a head row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[j] - m_use);
        Ps[r * PP + tx + TX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = l * alpha + sum;
      m = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
      __syncthreads();

      for (int c = 0; c < TILE; ++c) {
        const float pv = Ps[r * PP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[j] = fmaf(pv, Vs[c * DH + tx + TX * j], acc[j]);
      }
    }

    if (r0 + r < rep) {
      const long long at = p0 + static_cast<long long>(r0 + r) * nsplit;
#pragma unroll
      for (int j = 0; j < DPT; ++j) part_acc[at * DH + tx + TX * j] = acc[j];
      if (tx == 0) {
        part_ml[2 * at] = m;
        part_ml[2 * at + 1] = l;
      }
    }
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
    const float w = expf(ms - m);
    l = fmaf(part_ml[2 * (base + s) + 1], w, l);
    a = fmaf(part_acc[(base + s) * DH + d], w, a);
  }
  o[(static_cast<long long>(b) * h + head) * DH + d] =
      from_f<T>(l > 0.f ? a / l : 0.f);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* part_ml, void* part_acc, int batch, int s_len,
           int h, int kvh, long long q_sb, long long kv_sb, long long kv_ss,
           int split, float scale, cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const int nsplit = (s_len + split - 1) / split;
  if (nsplit > 0) {
    decode_partial<T, DH><<<dim3(nsplit, kvh, batch), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        static_cast<float*>(part_ml), static_cast<float*>(part_acc), s_len, h,
        h / kvh, q_sb, kv_sb, kv_ss, split, nsplit, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_combine<T, DH><<<dim3(h, batch), DH, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(o), h, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* o, void* part_ml, void* part_acc, int batch, int s_len,
             int h, int kvh, int dh, long long q_sb, long long kv_sb,
             long long kv_ss, int split, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || h % kvh != 0 || h / kvh > MAX_REP || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64)
    return launch<T, 64>(q, k, v, lengths, o, part_ml, part_acc, batch, s_len,
                         h, kvh, q_sb, kv_sb, kv_ss, split, scale, st);
  if (dh == 128)
    return launch<T, 128>(q, k, v, lengths, o, part_ml, part_acc, batch,
                          s_len, h, kvh, q_sb, kv_sb, kv_ss, split, scale,
                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, 1, H, dh) with heads packed (stride dh), dh contiguous, batch stride
// q_sb; k/v (B, S, KV, dh) with heads packed, batch and sequence strides
// kv_sb / kv_ss in elements; lengths (B,) int32 on the card; o a contiguous
// (B, 1, H, dh) tensor; part_ml (B, H, nsplit, 2) and part_acc
// (B, H, nsplit, dh) float scratch with nsplit = ceil(S / split).
int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, void* part_ml,
                         void* part_acc, int batch, int s_len, int h, int kvh,
                         int dh, long long q_sb, long long kv_sb,
                         long long kv_ss, int split, float scale,
                         void* stream) {
  return dispatch<float>(q, k, v, lengths, o, part_ml, part_acc, batch, s_len,
                         h, kvh, dh, q_sb, kv_sb, kv_ss, split, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* o, void* part_ml,
                          void* part_acc, int batch, int s_len, int h,
                          int kvh, int dh, long long q_sb, long long kv_sb,
                          long long kv_ss, int split, float scale,
                          void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, o, part_ml, part_acc,
                                 batch, s_len, h, kvh, dh, q_sb, kv_sb, kv_ss,
                                 split, scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
