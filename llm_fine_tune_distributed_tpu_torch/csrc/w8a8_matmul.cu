// w8a8 int8 GEMM with a fused f32 rescale, for the frozen trunk of training.
//
// Replaces the TPU kernel _w8a8_kernel
// (llm_fine_tune_distributed_tpu/ops/int8_matmul.py, launched by _w8a8_pallas
// through pl.pallas_call). Same function:
//
//   out[m, n] = cast((float(sum_k xq[m, k] * wq[k, n]) * xs[m]) * ws[n])
//
// xq int8 [M, K] row-major (per-row quantized activations), wq int8 [K, N]
// K-major: the transposed view of a contiguous [N, K] tensor, strides
// (1, K), which is how the port keeps the trunk's kernel_int8 codes
// (ops/int8_matmul.kmajor); xs f32 [M], ws f32 [N], out [M, N] bf16 or f32.
// The sum is an int32 accumulation, exact in any order (|sum| <= K * 127^2 <
// 2^31 for K <= 133144, which the wrapper checks), and the epilogue
// multiplies in f32 in the JAX order and rounds once, so the kernel equals
// its plain version bit for bit.
//
// Bound. At the trunk's shapes (M = 8192; K, N = 2048/11008) the GEMM is
// bound by the operations: 2*M*N*K int8 operations at 1979 TOP/s dense
// (one trunk layer's 7 projections: 1.29 TOP, 0.647 ms) against at most
// ~220 MB of traffic per projection (0.066 ms at 3.35 TB/s).
//
// Design. The Pallas kernel keeps K whole in VMEM and pads M to 128 and N to
// 512. Here a block of 8 warps owns a 128 x 128 output tile and walks K in
// 128-byte steps. mma.sync.m16n8k32 s8 x s8 -> s32 wants both operands
// K-contiguous, and with K-major codes both xq and wq already are, so the
// two tiles of a step are the same shape of copy: 16-byte cp.async chunks
// (zero-filled past M, N and K) into a 3-stage ring in dynamic shared memory
// (96 KB: two blocks per SM), one barrier per step and four k32 mma steps
// per barrier. Rows are 128 bytes with 16-byte chunk c of row r at
// c ^ (r % 8), so the eight row addresses of an ldmatrix 8 x 8 matrix fall
// in eight distinct bank groups; for int8 K-major tiles ldmatrix's b16 rows
// are exactly m16n8k32's fragments (an x4 gives a whole A fragment, or the
// B fragments of two n-tiles), so no byte is transposed or moved by a
// thread. Warps are 2 (M) x 4 (N), 64 x 32 each: 16 mma per 6 ldmatrix.x4.
// K not a multiple of 16 (row starts off 16 bytes) takes byte loads and
// 16-byte shared stores in place of cp.async. Compiled without
// --use_fast_math: the epilogue is IEEE (__fmul_rn). wgmma with TMA (both
// operands K-major in shared memory, as s8 wgmma requires) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 128;       // K bytes per ring stage: 4 k32 mma steps
constexpr int kStages = 3;     // K steps in the cp.async ring
constexpr int kThreads = 256;  // 8 warps: 2 (M) x 4 (N)
constexpr int kWarpN = kBN / 4;                    // columns of one warp
constexpr int kStageBytes = (kBM + kBN) * kBK;     // A then B tile
constexpr int kSmemBytes = kStages * kStageBytes;  // 96 KB
constexpr int kMaxK = 133144;  // floor((2^31 - 1) / 127^2)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled [rows][kBK] tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 4);
}

// 16-byte global -> shared copy through L2 only; reads `bytes` (0..16) and
// zero-fills the rest (with 0 nothing is read, but the address must stay a
// valid one)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Issue the copy of rows [row0, row0 + ROWS) x bytes [k0, k0 + kBK) of x
// (int8 [rows, K], K contiguous) into the swizzled tile at dst; bytes past
// `rows` or K are zero. VEC 16: 16-byte cp.async (K a multiple of 16, so
// every chunk is aligned); VEC 1: byte loads and a 16-byte shared store.
template <int ROWS, int VEC>
__device__ __forceinline__ void copy_tile(uint32_t dst, const int8_t* __restrict__ x, int rows,
                                          int K, int row0, int k0) {
  constexpr int kChunks = kBK / 16;
  static_assert(ROWS * kChunks % kThreads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int k = k0 + c * 16;
    const int n = row0 + r < rows ? min(max(K - k, 0), 16) : 0;
    const int8_t* src = n > 0 ? x + static_cast<size_t>(row0 + r) * K + k : x;
    if constexpr (VEC == 16) {
      cp_async_16(dst + swz(r, c), src, n);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (e < n) w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * (e % 4));
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + swz(r, c)),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
    }
  }
}

// grid (ceil(M / kBM), ceil(N / kBN)), kThreads threads, kSmemBytes of
// dynamic shared memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2) w8a8_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ xs,
    const float* __restrict__ ws, T* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp / 4) * 64;         // warp's rows within the tile
  const int wn = (warp % 4) * kWarpN;     // warp's columns within the tile
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int steps = (K + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int step) {
    const uint32_t a_s = base + stage * kStageBytes;
    copy_tile<kBM, VEC>(a_s, xq, M, K, m0, step * kBK);
    copy_tile<kBN, VEC>(a_s + kBM * kBK, wq, N, K, n0, step * kBK);
  };

  int32_t acc[4][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // fill all but one stage of the ring, one commit group per K step
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_stage(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tiles have landed; the stage read last step is free
    const int ahead = step + kStages - 1;
    if (ahead < steps) load_stage(ahead % kStages, ahead);
    cp_async_commit();
    const uint32_t a_s = base + (step % kStages) * kStageBytes;
    const uint32_t b_s = a_s + kBM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      // A: one x4 per m16 tile, matrices (rows 0-7 | 8-15) x (k bytes 0-15 |
      // 16-31) = a0, a1, a2, a3. B: one x4 per two n8 tiles, matrices
      // (n 0-7 | 8-15) x (k 0-15 | 16-31) = b0, b1 of each.
      uint32_t a[4][4], b[kWarpN / 8][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], a_s + swz(wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    2 * ks + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < kWarpN / 16; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + swz(wn + jp * 16 + (lane & 7) + (lane >> 4) * 8,
                                 2 * ks + ((lane >> 3) & 1)));
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
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
      for (int j = 0; j < kWarpN / 8; ++j) {
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

template <typename T, int VEC>
int launch(const int8_t* xq, const int8_t* wq, const float* xs, const float* ws, void* out,
           int M, int N, int K, cudaStream_t stream) {
  auto kernel = w8a8_kernel<T, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(xq, wq, xs, ws, static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. xq and wq 16-byte aligned, wq
// K-major (element (k, n) at wq[n * K + k]). out_is_bf16: 1 for a bf16
// output, 0 for f32. Returns the cudaError_t of cudaGetLastError() after the
// launch (0 on success); invalid shapes return cudaErrorInvalidValue without
// launching.
extern "C" int w8a8_matmul_launch(const void* xq, const void* wq, const void* xs,
                                  const void* ws, void* out, int M, int N, int K,
                                  int out_is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > kMaxK || (N + kBN - 1) / kBN > 65535 ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  const bool vec = K % 16 == 0;
  if (out_is_bf16)
    return vec ? launch<__nv_bfloat16, 16>(a, b, sx, sw, out, M, N, K, s)
               : launch<__nv_bfloat16, 1>(a, b, sx, sw, out, M, N, K, s);
  return vec ? launch<float, 16>(a, b, sx, sw, out, M, N, K, s)
             : launch<float, 1>(a, b, sx, sw, out, M, N, K, s);
}
