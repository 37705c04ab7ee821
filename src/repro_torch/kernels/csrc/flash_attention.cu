// Flash-attention forward pass for Hopper (sm_90a), float and bfloat16.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/flash_attention.py (`_kernel`): causal
// or sliding-window GQA attention with an online softmax, q (B, Sq, H, dh),
// k/v (B, Sk, KV, dh), query head h reading kv head h / rep, query
// positions end-aligned (row i sits at Sk - Sq + i), f32 accumulation.  On
// the port's serving path it runs every prefill, with Sq = Sk = the prompt
// length, over the prompt's own keys.
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
// set the least time, and both bounds are a few microseconds.  This first
// version does not approach either: it runs the
// products on the CUDA cores in f32 (67 TFLOP/s at most, not the tensor
// cores' 989 in bf16), one 64 x 64 tile at a time.
//
// Design.  One block of 256 threads per (query tile of 64 rows, q head,
// batch row).  The scaled Q tile is converted to f32 once and kept in shared
// memory; 64-key K and V tiles stream through shared memory (dynamic shared
// memory: 66 KB at dh 64, 113 KB at dh 128, above the 48 KB default); rows
// are padded by one float so that neighbouring threads hit neighbouring
// banks.  Each thread owns 4 query rows x 4 key columns of the score tile
// and 4 rows x dh/16 columns of the accumulator, so the online softmax's
// running max and sum stay in registers, reduced across the 16 threads of a
// row with warp shuffles.  Key tiles that no row of the block can see
// (causal future, behind the window) are skipped; skipping them is exact.
// K/V are never repeated in memory.  Later versions: wgmma on bf16 tiles
// fed by TMA, a ring of stages, warp specialisation.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int TX = 16;        // threads per row of the score tile
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;  // query rows per thread
constexpr int CPT = BK / TX;  // score columns per thread

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
  static constexpr int KP = DH + 1;  // padded row of Q and K
  static constexpr int PP = BK + 1;  // padded row of P
  static constexpr size_t bytes =
      (size_t(BQ) * KP + size_t(BK) * KP + size_t(BK) * DH +
       size_t(BQ) * PP) * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int h,
          int rep, long long q_sb, long long q_ss, long long kv_sb,
          long long kv_ss, int causal, int window, float scale) {
  constexpr int KP = Layout<DH>::KP;
  constexpr int PP = Layout<DH>::PP;
  constexpr int DPT = DH / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][KP], scaled
  float* Ks = Qs + BQ * KP;     // [BK][KP]
  float* Vs = Ks + BK * KP;     // [BK][DH]
  float* Ps = Vs + BK * DH;     // [BQ][PP]

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int q_off = sk - sq;  // end-aligned query positions

  const T* qb = q + b * q_sb + static_cast<long long>(head) * DH;
  const T* kb = k + b * kv_sb + static_cast<long long>(head / rep) * DH;
  const T* vb = v + b * kv_sb + static_cast<long long>(head / rep) * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, c = e % DH;
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
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, c = e % DH;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < k_end) {
        const long long off = (k0 + r) * kv_ss + c;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      Ks[r * KP + c] = kx;
      Vs[r * DH + c] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
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
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * DH + tx + TX * j];
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
    T* ob = o + ((static_cast<long long>(b) * sq + row) * h + head) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      ob[tx + TX * j] = from_f<T>(l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int h, int kvh, long long q_sb, long long q_ss,
           long long kv_sb, long long kv_ss, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || sq == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((sq + BQ - 1) / BQ, h, batch);
  flash_fwd<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, h / kvh, q_sb,
      q_ss, kv_sb, kv_ss, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int sq, int sk, int h, int kvh, int dh, long long q_sb,
             long long q_ss, long long kv_sb, long long kv_ss, int causal,
             int window, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (kvh <= 0 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64)
    return launch<T, 64>(q, k, v, o, batch, sq, sk, h, kvh, q_sb, q_ss,
                         kv_sb, kv_ss, causal, window, scale, st);
  if (dh == 128)
    return launch<T, 128>(q, k, v, o, batch, sq, sk, h, kvh, q_sb, q_ss,
                          kv_sb, kv_ss, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, Sq, H, dh) and k/v (B, Sk, KV, dh): heads packed (stride dh) and dh
// contiguous; batch and sequence strides in elements (k and v share them).
// o is a contiguous (B, Sq, H, dh) tensor.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int batch, int sq, int sk, int h, int kvh, int dh,
                        long long q_sb, long long q_ss, long long kv_sb,
                        long long kv_ss, int causal, int window, float scale,
                        void* stream) {
  return dispatch<float>(q, k, v, o, batch, sq, sk, h, kvh, dh, q_sb, q_ss,
                         kv_sb, kv_ss, causal, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int batch, int sq, int sk, int h, int kvh,
                         int dh, long long q_sb, long long q_ss,
                         long long kv_sb, long long kv_ss, int causal,
                         int window, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, batch, sq, sk, h, kvh, dh, q_sb,
                                 q_ss, kv_sb, kv_ss, causal, window, scale,
                                 stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
