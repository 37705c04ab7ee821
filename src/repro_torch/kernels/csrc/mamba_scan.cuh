// The layout and helpers the selective-scan kernels share: the forward
// pass (mamba_scan.cu) and the backward pass (mamba_scan_bwd.cu) walk the
// same tiles the same way.  mamba_scan.cu says what each computes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int L = 4;                   // lanes a channel (a group)
constexpr int G = 32 / L;              // channels a warp
constexpr int CH = WARPS * G;          // channels a block
constexpr int K = 16;                  // consecutive positions a lane
constexpr int TS = L * K;              // positions a tile
constexpr int UP = TS + TS / 32 + 1;   // padded row of the u / y tile
constexpr int BS = TS + 4;             // row of dt B and C in a stage
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// a lane's positions of the u / y tile, one extra float every 32
__device__ __forceinline__ int pad(int t) { return t + (t >> 5); }

// position t of a tile in the dt B and C rows: the 16-byte quads of every
// other run of 32 positions swapped in pairs, so that the L lanes of a group
// read L distinct bank quads (one wavefront; the G groups broadcast)
__device__ __forceinline__ int swz(int t) { return t ^ (((t >> 5) & 1) << 2); }

// lane j's K positions of a swizzled row
__device__ __forceinline__ void load_row(float (&r)[K], const float* row,
                                         int j) {
  const int h = ((K * j) >> 5) & 1;
#pragma unroll
  for (int m = 0; m < K / 4; ++m) {
    const float4 v =
        *reinterpret_cast<const float4*>(row + K * j + 4 * (m ^ h));
    r[4 * m] = v.x;
    r[4 * m + 1] = v.y;
    r[4 * m + 2] = v.z;
    r[4 * m + 3] = v.w;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

}  // namespace scan
