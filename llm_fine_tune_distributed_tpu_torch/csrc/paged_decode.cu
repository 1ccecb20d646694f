// Fused one-token decode attention over an int8 block-paged KV pool.
//
// Replaces the TPU kernel _paged_decode_kernel
// (llm_fine_tune_distributed_tpu/ops/flash_attention.py, launched by
// paged_decode_attention through pl.pallas_call). Same function: for each
// batch row, walk the row's block table over the int8 pool
// [num_blocks, L, hkv, d], fold the per-(block, kv head) absmax dequant into
// the logits (q.k_code * scale * k_absmax/127) and into the accumulator update
// (* v_absmax/127), mask positions >= lengths[row], online softmax over the
// G = hq/hkv query heads that share a kv head, out = acc / max(l, 1e-30).
//
// Design. The TPU kernel's grid walks the table sequentially on one core and
// carries (m, l, acc) in scratch across grid steps. Here CUDA blocks run in
// parallel and in no order, so one CUDA block owns one (row, kv head) and
// loops over that row's table itself; (m, l) live in shared memory and acc in
// registers for the whole walk. The loop stops after ceil(len/L) table
// entries: masked blocks leave (m, l, acc) unchanged in the TPU kernel too.
// Each block is cut into tiles of 128 positions: (1) one thread per position
// computes the G logits from 16-byte int8 loads of its K row, (2) one warp
// per query head updates (m, l) and turns the logits into probabilities,
// (3) one thread per head_dim column accumulates p.V for all G heads, so each
// V code is read once.
//
// Bound. Decode reads each int8 block once: about
// sum_rows ceil(len/L) * L * hkv * d * 2 bytes per layer (K and V), against
// ~4 * G * d flops per position, far below the card's flops/byte balance, so
// the kernel is bound by device-memory bandwidth. This first version is
// simple and correct; staging the codes through shared memory with cp.async
// or TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = kThreads;  // positions scored per tile, one per thread
constexpr int kMaxHeadDim = 256;
constexpr int kMaxGroups = 16;
constexpr int kColsPerThread = kMaxHeadDim / kThreads;
constexpr float kNegInf = -1.0e30f;  // the TPU kernel's finite -inf

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (batch rows, kv heads), kThreads threads. q/out [b, 1, hq, d] (head h
// serves query heads h*G .. h*G+G-1), pools int8 [N, L, hkv, d], scales f32
// [N, hkv], tables int32 [b, nb], lengths int32 [b].
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pool,
    const int8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, T* __restrict__ out, int hkv, int d,
    int L, int nb, float scale) {
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int hq = hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ __align__(16) float q_s[G * kMaxHeadDim];
  __shared__ float p_s[G * kTile];
  __shared__ float m_s[G], l_s[G], alpha_s[G];

  const T* q_row = q + ((size_t)row * hq + (size_t)h * G) * d;
  for (int i = tid; i < G * d; i += kThreads) q_s[i] = to_float(q_row[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[G][kColsPerThread];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[g][c] = 0.f;
  __syncthreads();

  const int len = lengths[row];
  int n_blocks = len > 0 ? (len + L - 1) / L : 0;
  if (n_blocks > nb) n_blocks = nb;  // dead rows may carry a stale length
  const size_t pos_stride = (size_t)hkv * d;  // bytes between positions

  for (int i = 0; i < n_blocks; ++i) {
    const int blk = tables[(size_t)row * nb + i];
    const float logit_scale = scale * (k_scale[(size_t)blk * hkv + h] / 127.0f);
    const float vs = v_scale[(size_t)blk * hkv + h] / 127.0f;
    const int8_t* kb = k_pool + ((size_t)blk * L * hkv + h) * d;
    const int8_t* vb = v_pool + ((size_t)blk * L * hkv + h) * d;
    const int in_block = min(L, len - i * L);

    for (int t0 = 0; t0 < in_block; t0 += kTile) {
      const int n_t = min(kTile, in_block - t0);

      // (1) logits: thread tid scores position t0 + tid for all G heads
      if (tid < n_t) {
        float dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = 0.f;
        const int8_t* kr = kb + (size_t)(t0 + tid) * pos_stride;
        for (int c = 0; c < d; c += 16) {
          const int4 raw = *reinterpret_cast<const int4*>(kr + c);
          const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
          float kf[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) kf[j] = static_cast<float>(e[j]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + g * d + c);
#pragma unroll
            for (int j4 = 0; j4 < 4; ++j4) {
              const float4 qq = qv[j4];
              dot[g] += qq.x * kf[4 * j4] + qq.y * kf[4 * j4 + 1] +
                        qq.z * kf[4 * j4 + 2] + qq.w * kf[4 * j4 + 3];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) p_s[g * kTile + tid] = dot[g] * logit_scale;
      }
      __syncthreads();

      // (2) online softmax statistics: one warp per query head
      for (int g = warp; g < G; g += kThreads / 32) {
        float mx = kNegInf;
        for (int t = lane; t < n_t; t += 32) mx = fmaxf(mx, p_s[g * kTile + t]);
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < n_t; t += 32) {
          const float p = expf(p_s[g * kTile + t] - m_new);
          p_s[g * kTile + t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          alpha_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // (3) acc = acc * alpha + (p . v) * v_absmax/127, one column per thread
#pragma unroll
      for (int cc = 0; cc < kColsPerThread; ++cc) {
        const int col = tid + cc * kThreads;
        if (col < d) {
          float part[G];
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] = 0.f;
          const int8_t* vc = vb + (size_t)t0 * pos_stride + col;
          for (int t = 0; t < n_t; ++t) {
            const float v = static_cast<float>(vc[(size_t)t * pos_stride]);
#pragma unroll
            for (int g = 0; g < G; ++g) part[g] += p_s[g * kTile + t] * v;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][cc] = acc[g][cc] * alpha_s[g] + part[g] * vs;
        }
      }
      __syncthreads();  // p_s and alpha_s are rewritten by the next tile
    }
  }

#pragma unroll
  for (int cc = 0; cc < kColsPerThread; ++cc) {
    const int col = tid + cc * kThreads;
    if (col < d) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float o = acc[g][cc] / fmaxf(l_s[g], 1e-30f);
        store(out + ((size_t)row * hq + (size_t)h * G + g) * d + col, o);
      }
    }
  }
}

template <typename T, int G>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* k_scale, const void* v_scale, const void* tables,
            const void* lengths, void* out, int b, int hkv, int d, int L,
            int nb, float scale, cudaStream_t stream) {
  dim3 grid(b, hkv);
  paged_decode_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), hkv, d, L,
      nb, scale);
}

template <typename T>
bool dispatch(int groups, const void* q, const void* k_pool,
              const void* v_pool, const void* k_scale, const void* v_scale,
              const void* tables, const void* lengths, void* out, int b,
              int hkv, int d, int L, int nb, float scale,
              cudaStream_t stream) {
#define PAGED_DECODE_CASE(G)                                                 \
  case G:                                                                    \
    launch<T, G>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, \
                 b, hkv, d, L, nb, scale, stream);                           \
    return true;
  switch (groups) {
    PAGED_DECODE_CASE(1)
    PAGED_DECODE_CASE(2)
    PAGED_DECODE_CASE(3)
    PAGED_DECODE_CASE(4)
    PAGED_DECODE_CASE(5)
    PAGED_DECODE_CASE(6)
    PAGED_DECODE_CASE(7)
    PAGED_DECODE_CASE(8)
    PAGED_DECODE_CASE(9)
    PAGED_DECODE_CASE(10)
    PAGED_DECODE_CASE(11)
    PAGED_DECODE_CASE(12)
    PAGED_DECODE_CASE(13)
    PAGED_DECODE_CASE(14)
    PAGED_DECODE_CASE(15)
    PAGED_DECODE_CASE(16)
    default:
      return false;
  }
#undef PAGED_DECODE_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes. q_is_bf16: 1 for bf16 q/out, 0 for
// f32. Returns the cudaError_t of cudaGetLastError() after the launch (0 on
// success); invalid shapes return cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out,
    int b, int hq, int hkv, int d, int L, int nb, int q_is_bf16, float scale,
    void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || d % 16 != 0 || d > kMaxHeadDim ||
      hq / hkv > kMaxGroups || L <= 0 || nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      q_is_bf16
          ? dispatch<__nv_bfloat16>(groups, q, k_pool, v_pool, k_scale, v_scale,
                                    tables, lengths, out, b, hkv, d, L, nb,
                                    scale, s)
          : dispatch<float>(groups, q, k_pool, v_pool, k_scale, v_scale, tables,
                            lengths, out, b, hkv, d, L, nb, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
