// Causal flash-attention forward: O and the row log-sum-exp.
//
// Replaces the TPU kernel _fwd_kernel
// (llm_fine_tune_distributed_tpu/ops/flash_attention.py, launched by _fwd
// through pl.pallas_call; entry pallas_flash_attention). Same function: per
// (batch row, query head, query tile) walk the key tiles up to the causal
// limit, mask k_pos <= q_pos and same segment, keep the online softmax
// (m, l, acc) in f32, write O = acc / max(l, 1e-30) in q's dtype and
// LSE = m + log(max(l, 1e-30)) in f32 [b, hq, s]. GQA by index: query head h
// reads kv head h / (hq / hkv); K/V are never repeated in memory.
//
// Design. The Pallas kernel holds a whole sequence of K/V in VMEM per
// program and loops over its blocks in order on one core. Here one CUDA block
// (256 threads) owns one 64-row query tile and stages each 64-row K and V
// tile in shared memory as f32 ([64][d+1], padded against bank conflicts).
// Thread (ty, tx) computes the 4 x 4 scores of rows 4ty.. and key columns
// tx + 16j, reduces the row max and sum over the 16 lanes of its row group
// with shuffles, writes p to a shared tile read back only by its own warp,
// and accumulates O for its 4 rows and d/16 columns in registers. Blocks are
// issued longest query tile first. Any s (ragged edges are masked), d a
// multiple of 16 up to 128 (zero-padded to 64 or 128 in shared memory).
//
// Bound. Causal attention does about 2*b*hq*s^2*d flops (QK^T and PV over
// the lower triangle) against b*s*(2*hq + 2*hkv)*d*elt bytes: at s = 1024,
// d = 128 that is hundreds of flops per byte, so the work is bound by
// arithmetic. This first version computes in f32 on the CUDA cores, far
// below the card's bf16 tensor-core rate; mma.sync/wgmma tiles with TMA
// staging are the later work that moves it toward the bound.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
    Strides sq, Strides sk, Strides sv, int s, int hq, int hkv, int d,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kTile][D + 1]
  float* Ks = Qs + kTile * (D + 1);    // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);    // [kTile][D + 1]
  float* Ps = Vs + kTile * (D + 1);    // [kTile][kLd]
  __shared__ int qseg[kTile], kseg[kTile];

  constexpr int C = D / 16;  // accumulator columns per thread
  const int n_tiles = (s + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D>(Qs, q, sq, b, h, q0, s, d);
  load_segments(qseg, seg, b, q0, s, kQSentinel);

  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  // causal limit: key tiles 0 .. qt (query and key tiles have one size)
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K/V/segments are no longer read
    load_tile<T, D>(Ks, k, sk, b, hk, k0, s, d);
    load_tile<T, D>(Vs, v, sv, b, hk, k0, s, d);
    load_segments(kseg, seg, b, k0, s, kKSentinel);
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty * kRows + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qpos = q0 + r;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kc = tx + 16 * j;
        ok[j] = (k0 + kc <= qpos) && (qseg[r] == kseg[kc]);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[r * kLd + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row group's p is written and read by its own warp

    for (int kk = 0; kk < kTile; ++kk) {
      float p[kRows], vv[C];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty * kRows + i) * kLd + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = Vs[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += p[i] * vv[c];
    }
    __syncwarp();  // Ps is rewritten by the next key tile
  }

  const long long o_pos = (long long)hq * d;  // o is contiguous [b, s, hq, d]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= s) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)b * s + qpos) * o_pos + (long long)h * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(orow + col, acc[i][c] / ls);
    }
    if (tx == 0) lse[((long long)b * hq + h) * s + qpos] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* o, void* lse, const long long* strides, int b, int s, int hq,
           int hkv, int d, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + kTile - 1) / kTile, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(seg), static_cast<T*>(o), static_cast<float*>(lse),
      strides_at(strides), strides_at(strides + 3), strides_at(strides + 6), s, hq,
      hkv, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* seg,
             void* o, void* lse, const long long* strides, int b, int s, int hq,
             int hkv, int d, float scale, cudaStream_t stream) {
  if (padded_head_dim(d) == 64)
    return launch<T, 64>(q, k, v, seg, o, lse, strides, b, s, hq, hkv, d, scale, stream);
  return launch<T, 128>(q, k, v, seg, o, lse, strides, b, s, hq, hkv, d, scale, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. strides: host array of 9 int64,
// the (batch, position, head) element strides of q, k and v; o must be a
// contiguous [b, s, hq, d] tensor of q's dtype, lse a contiguous f32
// [b, hq, s]. is_bf16: 1 for bf16 q/k/v/o, 0 for f32. Returns the
// cudaError_t after the launch (0 on success); shapes the kernel does not
// take return cudaErrorInvalidValue without launching.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg, void* o, void* lse,
                                const long long* strides, int b, int s, int hq,
                                int hkv, int d, int is_bf16, float scale,
                                void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 || d % 16 != 0 ||
      d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, seg, o, lse, strides, b, s, hq,
                                           hkv, d, scale, st)
                 : dispatch<float>(q, k, v, seg, o, lse, strides, b, s, hq, hkv, d,
                                   scale, st);
}
