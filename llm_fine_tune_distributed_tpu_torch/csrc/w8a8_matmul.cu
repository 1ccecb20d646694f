// w8a8 int8 GEMM with a fused f32 rescale, for the frozen trunk of training.
//
// Replaces the TPU kernel _w8a8_kernel
// (llm_fine_tune_distributed_tpu/ops/int8_matmul.py, launched by _w8a8_pallas
// through pl.pallas_call). Same function:
//
//   out[m, n] = cast((float(sum_k xq[m, k] * wq[k, n]) * xs[m]) * ws[n])
//
// xq int8 [M, K] row-major (per-row quantized activations), wq int8 [K, N]
// with N contiguous (the serving sibling kernel_int8, [in, out]), xs f32 [M],
// ws f32 [N], out [M, N] bf16 or f32. The sum is an int32 accumulation, exact
// in any order (|sum| <= K * 127^2 < 2^31 for K <= 133144, which the wrapper
// checks), and the epilogue multiplies in f32 in the JAX order and rounds
// once, so the kernel equals its plain version bit for bit.
//
// Design. The Pallas kernel keeps K whole in VMEM and pads M to 128 and N to
// 512. Here a block of 256 threads owns a 128 x 128 output tile and loops over
// K in 64-byte steps through shared memory, masking the ragged edges of M, N
// and K itself (out-of-range codes load as 0). The products run on the tensor
// cores with mma.sync.m16n8k32 s8 x s8 -> s32: 8 warps of 64 x 32 each, 16
// mma per 32-deep step. That instruction needs both operands K-contiguous, so
// the wq tile is transposed as it is stored: each thread loads a 4 (k) x 4 (n)
// byte block with four 4-byte loads along N, transposes it in registers with
// __byte_perm and stores four K-major words. Shared rows are padded to 80
// bytes, which makes the fragment loads free of bank conflicts. The next K
// step's tiles are loaded into registers while the current one is multiplied.
// Compiled without --use_fast_math: the epilogue is IEEE (__fmul_rn).
//
// Bound. At the trunk's shapes (M = 8192; K, N = 2048/11008) the GEMM is
// compute-bound on the card: 2*M*N*K int8 operations at 1979 TOP/s dense
// (gate/up/down: 369 GOP, 0.187 ms) against at most ~220 MB of traffic
// (0.066 ms at 3.35 TB/s). This first version is simple and exact; mma.sync
// from padded shared memory reaches a fraction of that peak. The fast version
// is later work: wgmma with s8 operands needs both A and B K-major in shared
// memory (PTX allows no transpose for 8-bit types), so it wants TMA staging
// of xq and either an in-kernel transpose of the wq tiles or a transposed
// copy of the codes made once at quantize time, with a ring of stages and a
// persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 64;       // K bytes per shared-memory step
constexpr int kStride = 80;   // padded shared row, bytes (20 words)
constexpr int kThreads = 256;
constexpr int kMaxK = 133144;  // floor((2^31 - 1) / 127^2)

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// Registers holding the next K step's tiles: two 16-byte chunks of xq rows and
// two 4 x 4 byte blocks of wq per thread.
struct Staged {
  uint4 a[2];
  uint32_t b[2][4];
};

// Loads the K step at k0 into registers; out-of-range bytes are 0. xq chunk
// idx = tid + 256p of the tile: row idx / 4, 16 bytes at k0 + (idx % 4) * 16.
__device__ __forceinline__ void load_tiles(Staged& st, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  const bool a_vec = (K & 15) == 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int idx = tid + p * kThreads;
    const int m = m0 + idx / 4;
    const int k = k0 + (idx % 4) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < M) {
      const int8_t* src = xq + static_cast<size_t>(m) * K + k;
      if (a_vec && k + 16 <= K) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int i = 0; i < 16 && k + i < K; ++i)
          w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * (i % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    st.a[p] = v;
  }
  // wq: a warp covers 8 column groups x 4 row groups, so eight lanes read 32
  // consecutive bytes of one row; warp-block wb = warp + 8p of 16.
  const bool b_vec = (N & 3) == 0;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int wb = warp + p * 8;
    const int n = n0 + ((wb % 4) * 8 + (lane % 8)) * 4;
    const int kr = k0 + ((wb / 4) * 4 + (lane / 8)) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
      const int k = kr + i;
      if (k < K) {
        const int8_t* src = wq + static_cast<size_t>(k) * N + n;
        if (b_vec && n + 4 <= N) {
          v = *reinterpret_cast<const uint32_t*>(src);
        } else {
          for (int j = 0; j < 4 && n + j < N; ++j)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
        }
      }
      st.b[p][i] = v;
    }
  }
}

__device__ __forceinline__ void store_tiles(const Staged& st, int8_t* As, int8_t* Bs, int tid) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int idx = tid + p * kThreads;
    *reinterpret_cast<uint4*>(As + (idx / 4) * kStride + (idx % 4) * 16) = st.a[p];
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int wb = warp + p * 8;
    const int nl = (wb % 4) * 8 + (lane % 8);  // column group: columns 4nl..4nl+3
    const int kl = (wb / 4) * 4 + (lane / 8);  // row group: rows 4kl..4kl+3
    const uint32_t* r = st.b[p];
    // 4 x 4 byte transpose: w[j] holds column j's four k bytes, k ascending
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t w[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // lanes start at different columns, which halves the bank conflicts
      const int j = (s + lane) & 3;
      const uint32_t v = j == 0 ? w[0] : j == 1 ? w[1] : j == 2 ? w[2] : w[3];
      *reinterpret_cast<uint32_t*>(Bs + (nl * 4 + j) * kStride + kl * 4) = v;
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid (ceil(M / 128), ceil(N / 128)), 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads) w8a8_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ xs,
    const float* __restrict__ ws, T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[kBM * kStride];
  __shared__ __align__(16) int8_t Bs[kBN * kStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int wm = (warp / 4) * 64;          // warp's rows within the tile
  const int wn = (warp % 4) * 32;          // warp's columns within the tile
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  Staged st;
  load_tiles(st, xq, wq, M, N, K, m0, n0, 0, tid);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's fragments are read
    store_tiles(st, As, Bs, tid);
    __syncthreads();
    if (k0 + kBK < K) load_tiles(st, xq, wq, M, N, K, m0, n0, k0 + kBK, tid);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* base = As + (wm + i * 16 + g) * kStride + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = Bs + (wn + j * 8 + g) * kStride + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // epilogue: c0, c1 at (row g, columns 2t, 2t+1), c2, c3 at row g + 8
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= M) continue;
      const float sx = xs[m];
      T* row = out + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
        if (n >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sx), ws[n]);
        if (n + 1 < N) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sx), ws[n + 1]);
          if (pairs) {
            store_pair(row + n, v0, v1);
          } else {
            store_out(row + n, v0);
            store_out(row + n + 1, v1);
          }
        } else {
          store_out(row + n, v0);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. out_is_bf16: 1 for a bf16 output,
// 0 for f32. Returns the cudaError_t of cudaGetLastError() after the launch
// (0 on success); invalid shapes return cudaErrorInvalidValue without
// launching.
extern "C" int w8a8_matmul_launch(const void* xq, const void* wq, const void* xs,
                                  const void* ws, void* out, int M, int N, int K,
                                  int out_is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > kMaxK || (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  if (out_is_bf16)
    w8a8_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        a, b, sx, sw, static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    w8a8_kernel<float><<<grid, kThreads, 0, s>>>(a, b, sx, sw, static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
