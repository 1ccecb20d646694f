// Shared pieces of the causal flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile geometry, dtype conversion, tile staging into shared
// memory and the host-side stride pack.
//
// Layout contract (the port's public layout, as in the JAX package's
// pallas_flash_attention): q/o/do [b, s, hq, d], k/v [b, s, hkv, d], each
// with its own (batch, position, head) strides in elements and a unit stride
// on d; segments int32 [b, s] contiguous; lse and delta f32 [b, hq, s]
// contiguous. A key is visible to a query iff k_pos <= q_pos and both carry
// the same segment id (0 = padding), the rule of the TPU kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;       // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx) owns tile rows
                                // 4*ty .. 4*ty+3 and columns tx + 16*j
constexpr int kRows = 4;        // tile rows per thread
constexpr int kCols = 4;        // score columns per thread (kTile / 16)
constexpr int kLd = kTile + 1;  // padded row stride of a score tile
constexpr float kNegInf = -1.0e30f;  // the TPU kernels' finite -inf
constexpr int kQSentinel = -1;  // segment of a query row past s
constexpr int kKSentinel = -2;  // segment of a key row past s (never equal)

// strides in elements of one [b, s, h, d] tensor (d has unit stride)
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// sum / max over the 16 lanes that share a tile row (lanes differing in
// their low four bits: one half of the warp)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Stage rows [row0, row0 + kTile) of head h of batch row b of x as f32 into
// dst[kTile][D + 1]; rows past s and columns past d are zero. Consecutive
// threads read consecutive columns (coalesced).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          Strides st, int b, int h, int row0,
                                          int s, int d) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int pos = row0 + r;
    float v = 0.f;
    if (pos < s && c < d)
      v = to_float(x[(long long)b * st.b + (long long)pos * st.s + (long long)h * st.h + c]);
    dst[r * (D + 1) + c] = v;
  }
}

// segment ids of rows [row0, row0 + kTile) of batch row b, `past` beyond s
__device__ __forceinline__ void load_segments(int* dst, const int32_t* __restrict__ seg,
                                              int b, int row0, int s, int past) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int pos = row0 + i;
    dst[i] = pos < s ? seg[(long long)b * s + pos] : past;
  }
}

// per-row f32 values [b, h, s] (lse, delta) of rows [row0, row0 + kTile),
// 0 beyond s
__device__ __forceinline__ void load_row_stat(float* dst, const float* __restrict__ x,
                                              int b, int h, int hq, int row0, int s) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int pos = row0 + i;
    dst[i] = pos < s ? x[((long long)b * hq + h) * s + pos] : 0.f;
  }
}

inline Strides strides_at(const long long* p) { return Strides{p[0], p[1], p[2]}; }

// Head dims the kernels are compiled for: d is padded with zeros up to the
// next of these inside shared memory.
inline int padded_head_dim(int d) { return d <= 64 ? 64 : 128; }

}  // namespace flash
