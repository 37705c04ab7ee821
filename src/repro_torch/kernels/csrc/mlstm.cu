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
// Design.  One head's C is 1 MB at dh 512, far beyond a block's 227 KB of
// shared memory, so the state cannot sit in one block as it sits in the TPU
// kernel's VMEM scratch.  One block of 256 threads per (value-column tile of
// VT = min(dh, 64) columns, batch row x head) holds C[:, tile] in shared
// memory (128 KB at dh 512; 196 KB in all) and n, and walks the chunks in
// order:
//   1. thread 0 scans the chunk's gates (running sum, running max, g, the
//      floor, the inter-chunk and state coefficients) into shared memory;
//   2. over slabs of min(dh, 64) columns of dh, it stages q (scaled) and k
//      and accumulates the Q x Q scores and q C[:, tile] in registers,
//      q . n in 64 threads;
//   3. masks and weights the scores (W), sums each row for the
//      denominator (warp shuffles), and writes out[:, tile] = (W v + inter
//      q C) / den;
//   4. over the slabs again, C[:, tile] = decay C + (coeff k)^T v and
//      n = decay n + coeff k.
// Each slab's loads are issued into registers while the previous slab is
// being used, so the block does not wait on device memory between its
// barriers.  Every block recomputes the scores and n of its head (8 tiles
// at dh 512), so n is the same in every tile and only tile 0 writes it.
// Every sum runs in a fixed order: repeated runs give the same bits.  At
// B = 1, H = 4 only 32 blocks run on 132 SMs, all products on the CUDA
// cores from shared memory; later versions: TF32 wgmma, the intra-chunk
// scores in parallel over chunks, a separate state pass.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;          // positions per chunk
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RPT = Q / TY;    // chunk rows per thread
constexpr int CPT = Q / TX;    // score columns per thread
constexpr int WP = Q + 1;      // padded row of W
constexpr int NGATE = 6;       // src, g, m_t, inter, coeff, q.n

// head-dim slab staged per step, and value columns per block
template <int DH>
struct Tile {
  static constexpr int DK = DH < 64 ? DH : 64;
  static constexpr int VT = DH < 64 ? DH : 64;
  static constexpr int KP = DK + 1;  // padded slab row
  static constexpr size_t floats = size_t(DH) * VT + DH + 2 * Q * KP +
                                   size_t(Q) * VT + size_t(Q) * WP +
                                   NGATE * Q + 4;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
mlstm_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ gate_i,
          const float* __restrict__ gate_f, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ m0,
          float* __restrict__ out, float* __restrict__ c1,
          float* __restrict__ n1, float* __restrict__ m1, int s, int h,
          int pad_floor, float scale) {
  constexpr int DK = Tile<DH>::DK;
  constexpr int VT = Tile<DH>::VT;
  constexpr int KP = Tile<DH>::KP;
  constexpr int VPT = VT / TX;            // value columns per thread
  constexpr int SPT = DK / TY;            // state rows per thread and slab
  constexpr int LPT = Q * DK / THREADS;   // slab elements each thread loads
  extern __shared__ float smem[];
  float* Cs = smem;                 // [DH][VT]: C[:, tile]
  float* ns = Cs + DH * VT;         // [DH]
  float* Qs = ns + DH;              // [Q][KP]: scaled q slab
  float* Ks = Qs + Q * KP;          // [Q][KP]: k slab (coeff k in step 4)
  float* Vs = Ks + Q * KP;          // [Q][VT]: v[:, tile]
  float* Ws = Vs + Q * VT;          // [Q][WP]
  float* src_s = Ws + Q * WP;       // logi_u - F_u
  float* g_s = src_s + Q;           // g_t
  float* mt_s = g_s + Q;            // m_t = F_t + g_t
  float* inter_s = mt_s + Q;        // e^{m_prev - g_t}
  float* coeff_s = inter_s + Q;     // e^{src_u - g_last}
  float* qn_s = coeff_s + Q;        // q_t . n_prev (scaled q)
  float* scal = qn_s + Q;           // decay, m_new

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int bh = blockIdx.y;        // batch row * h + head
  const int b = bh / h, head = bh % h;
  const int e0 = blockIdx.x * VT;   // first value column of the tile
  const long long row = static_cast<long long>(h) * DH;  // position stride
  const long long base = (static_cast<long long>(b) * s * h + head) * DH;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* ob = out + base;
  const float* lib = gate_i + static_cast<long long>(b) * s * h + head;
  const float* lfb = gate_f + static_cast<long long>(b) * s * h + head;

  const float* cb = c0 + static_cast<long long>(bh) * DH * DH;
  for (int e = tid; e < DH * VT; e += THREADS) {
    const int d = e / VT, c = e % VT;
    Cs[e] = cb[static_cast<long long>(d) * DH + e0 + c];
  }
  for (int d = tid; d < DH; d += THREADS)
    ns[d] = n0[static_cast<long long>(bh) * DH + d];
  float m_prev = m0[bh];

  // the next slab of q and k, loaded into registers while this one is used
  float pq[LPT], pk[LPT];
  for (int t0 = 0; t0 < s; t0 += Q) {
    const int len = min(Q, s - t0);
    auto fetch = [&](int d0, bool with_q) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int e = tid + l * THREADS;
        const int r = e / DK, c = e % DK;
        const bool ok = r < len;
        const long long off = (t0 + r) * row + d0 + c;
        if (with_q) pq[l] = ok ? qb[off] * scale : 0.f;
        pk[l] = ok ? kb[off] : 0.f;
      }
    };
    __syncthreads();  // the previous chunk is done with every buffer
    // gates of the chunk (staged in coeff_s / inter_s before the scan)
    if (tid < Q) {
      const bool ok = tid < len;
      const long long gi = static_cast<long long>(t0 + tid) * h;
      coeff_s[tid] = ok ? lib[gi] : 0.f;
      inter_s[tid] = ok ? lfb[gi] : 0.f;
    }
    for (int e = tid; e < Q * VT; e += THREADS) {
      const int r = e / VT, c = e % VT;
      Vs[e] = r < len ? vb[(t0 + r) * row + e0 + c] : 0.f;
    }

    float sacc[RPT][CPT], qc[RPT][VPT], qn = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) sacc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) qc[i][j] = 0.f;
    }
    fetch(0, true);
    for (int d0 = 0; d0 < DH; d0 += DK) {
      __syncthreads();  // the previous slab is used
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int e = tid + l * THREADS;
        Qs[(e / DK) * KP + e % DK] = pq[l];
        Ks[(e / DK) * KP + e % DK] = pk[l];
      }
      __syncthreads();
      if (d0 + DK < DH) fetch(d0 + DK, true);
      if (d0 == 0 && tid == 0) {
        // the chunk's stabiliser, sequentially, in the reference's form
        float f = 0.f, run = -INFINITY, g = m_prev;
        for (int t = 0; t < len; ++t) {
          f += inter_s[t];                 // logf_t
          const float sr = coeff_s[t] - f;  // logi_t - F_t
          run = fmaxf(run, sr);
          g = fmaxf(m_prev, run);
          src_s[t] = sr;
          g_s[t] = g;
          mt_s[t] = f + g;
        }
        for (int t = 0; t < Q; ++t) {
          const bool ok = t < len;
          inter_s[t] = ok ? expf(m_prev - g_s[t]) : 0.f;
          coeff_s[t] = ok ? expf(src_s[t] - g) : 0.f;
          if (!ok) src_s[t] = g_s[t] = mt_s[t] = 0.f;
        }
        scal[0] = expf(m_prev - g);  // decay of the carried state
        scal[1] = f + g;             // m at the chunk's end
      }
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
        float qv[RPT], kv[CPT], cv[VPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + TY * i) * KP + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * KP + d];
#pragma unroll
        for (int j = 0; j < VPT; ++j) cv[j] = Cs[(d0 + d) * VT + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
#pragma unroll
          for (int j = 0; j < VPT; ++j) qc[i][j] = fmaf(qv[i], cv[j], qc[i][j]);
        }
      }
      if (tid < Q) {
#pragma unroll 8
        for (int d = 0; d < DK; ++d)
          qn = fmaf(Qs[tid * KP + d], ns[d0 + d], qn);
      }
    }
    if (tid < Q) qn_s[tid] = qn;
    __syncthreads();  // gates, q.n visible; the slabs are used
    fetch(0, false);  // k for the state, in flight during step 3

    // W = scores x decay, masked; the denominators
    float den[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
      const float g = g_s[r];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int u = tx + TX * j;
        const float w =
            (u <= r && r < len) ? sacc[i][j] * expf(src_s[u] - g) : 0.f;
        Ws[r * WP + u] = w;
        rs += w;
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      den[i] = fmaxf(fabsf(rs + inter_s[r] * qn_s[r]), expf(-mt_s[r]));
    }
    __syncthreads();

    {
      float acc[RPT][VPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < VPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int u = 0; u < Q; ++u) {
        float w[RPT], vv[VPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) w[i] = Ws[(ty + TY * i) * WP + u];
#pragma unroll
        for (int j = 0; j < VPT; ++j) vv[j] = Vs[u * VT + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < VPT; ++j)
            acc[i][j] = fmaf(w[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
        if (r >= len) continue;
        const float inter = inter_s[r];
        const float dn = den[i] + 1e-6f;
#pragma unroll
        for (int j = 0; j < VPT; ++j)
          ob[(t0 + r) * row + e0 + tx + TX * j] =
              (acc[i][j] + inter * qc[i][j]) / dn;
      }
    }

    // the state at the chunk's end
    const float decay = scal[0];
    for (int d0 = 0; d0 < DH; d0 += DK) {
      __syncthreads();  // Ks is free
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int e = tid + l * THREADS;
        const int r = e / DK;
        Ks[r * KP + e % DK] = coeff_s[r] * pk[l];
      }
      __syncthreads();
      if (d0 + DK < DH) fetch(d0 + DK, false);
      float acc[SPT][VPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i)
#pragma unroll
        for (int j = 0; j < VPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int u = 0; u < Q; ++u) {
        float kx[SPT], vv[VPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) kx[i] = Ks[u * KP + ty + TY * i];
#pragma unroll
        for (int j = 0; j < VPT; ++j) vv[j] = Vs[u * VT + tx + TX * j];
#pragma unroll
        for (int i = 0; i < SPT; ++i)
#pragma unroll
          for (int j = 0; j < VPT; ++j)
            acc[i][j] = fmaf(kx[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          float* cp = &Cs[(d0 + ty + TY * i) * VT + tx + TX * j];
          *cp = decay * *cp + acc[i][j];
        }
      }
      if (tid < DK) {
        float a = 0.f;
        for (int u = 0; u < Q; ++u) a += Ks[u * KP + tid];
        ns[d0 + tid] = decay * ns[d0 + tid] + a;
      }
    }
    m_prev = scal[1];
  }

  // the reference's padding: m floored at 0, C and n rescaled to it
  float m_out = m_prev, rescale = 1.f;
  if (pad_floor) {
    m_out = fmaxf(m_prev, 0.f);
    rescale = expf(m_prev - m_out);
  }
  __syncthreads();
  float* cob = c1 + static_cast<long long>(bh) * DH * DH;
  for (int e = tid; e < DH * VT; e += THREADS) {
    const int d = e / VT, c = e % VT;
    cob[static_cast<long long>(d) * DH + e0 + c] = Cs[e] * rescale;
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < DH; d += THREADS)
      n1[static_cast<long long>(bh) * DH + d] = ns[d] * rescale;
    if (tid == 0) m1[bh] = m_out;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* li,
           const float* lf, const float* c0, const float* n0,
           const float* m0, float* out, float* c1, float* n1, float* m1,
           int batch, int s, int h, int pad_floor, float scale,
           cudaStream_t stream) {
  const size_t smem = Tile<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(DH / Tile<DH>::VT, batch * h);
  mlstm_fwd<DH><<<grid, THREADS, smem, stream>>>(
      q, k, v, li, lf, c0, n0, m0, out, c1, n1, m1, s, h, pad_floor, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out (B, S, H, dh), the gates logi, logf (B, S, H),
// C (B, H, dh, dh), n (B, H, dh), m (B, H): contiguous float32.  S >= 2.
// The outputs do not alias the inputs.
int mlstm_chunkwise_f32(const void* q, const void* k, const void* v,
                        const void* gate_i, const void* gate_f,
                        const void* c0, const void* n0, const void* m0,
                        void* out, void* c1, void* n1, void* m1, int batch,
                        int s, int h, int dh, int pad_floor, float scale,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (s < 2) return static_cast<int>(cudaErrorInvalidValue);
#define MLSTM_ARGS                                                     \
  static_cast<const float*>(q), static_cast<const float*>(k),          \
      static_cast<const float*>(v), static_cast<const float*>(gate_i), \
      static_cast<const float*>(gate_f), static_cast<const float*>(c0), \
      static_cast<const float*>(n0), static_cast<const float*>(m0),    \
      static_cast<float*>(out), static_cast<float*>(c1),               \
      static_cast<float*>(n1), static_cast<float*>(m1), batch, s, h,   \
      pad_floor, scale, st
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
