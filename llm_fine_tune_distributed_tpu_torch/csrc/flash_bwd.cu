// Causal flash-attention backward: dq, and dk/dv per kv head.
//
// Replaces the TPU kernels _dq_kernel and _dkv_kernel
// (llm_fine_tune_distributed_tpu/ops/flash_attention.py, both launched by
// _bwd through pl.pallas_call, under the custom_vjp of _make_flash_fn).
// delta = rowsum(dO * O) is computed before these kernels in plain PyTorch,
// as _bwd computes it in XLA. Same functions:
//   dq:    per (batch row, query head, query tile), over the key tiles up to
//          the causal limit: p = exp(s - LSE) under the mask,
//          ds = p * (dO V^T - delta), dq += ds K; finally dq * scale.
//   dk/dv: per (batch row, kv head, key tile), over the G = hq/hkv query
//          heads of the group and the query tiles at or after the key tile:
//          dv += p^T dO, dk += ds^T q; finally dk * scale. dk/dv stay at kv
//          head width and every block owns its output rows: no atomics.
//
// Design. The Pallas kernels keep a whole sequence of K/V (dq) or of q/dO
// for a query group (dk/dv) in VMEM per program. Here each CUDA block
// (256 threads) stages 64-row tiles in shared memory as f32 ([64][d+1]) and
// loops over the other operand's tiles itself. In the dq kernel thread
// (ty, tx) owns query rows 4ty.. and key columns tx + 16j of a score tile;
// in the dk/dv kernel it owns key rows 4ty.. and query columns tx + 16j, so
// both kernels' accumulators (dq, or dk and dv) are rows of the thread's own
// row group: the shared p/ds tiles are written and read by one warp, and
// __syncwarp is the only barrier between score and accumulate. Any s, d a
// multiple of 16 up to 128 (zero-padded to 64 or 128 in shared memory).
//
// Bound. The backward recomputes the scores in both kernels and forms
// dO V^T in both, so it does about 3.5x the forward's 2*b*hq*s^2*d causal
// flops against a few bytes per element of q, k, v, dO and the outputs:
// bound by arithmetic. This first version computes in f32 on the CUDA cores;
// tensor-core tiles (mma.sync/wgmma) and a split of the causal work over
// more blocks are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLd);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLd + 2 * kTile);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ seg,
    T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo, int s,
    int hq, int hkv, int d, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kTile][D + 1]
  float* dOs = Qs + kTile * (D + 1);    // [kTile][D + 1]
  float* Ks = dOs + kTile * (D + 1);    // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);     // [kTile][D + 1]
  float* Ds = Vs + kTile * (D + 1);     // [kTile][kLd]
  __shared__ int qseg[kTile], kseg[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];

  constexpr int C = D / 16;
  const int n_tiles = (s + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D>(Qs, q, sq, b, h, q0, s, d);
  load_tile<T, D>(dOs, dout, sdo, b, h, q0, s, d);
  load_segments(qseg, seg, b, q0, s, kQSentinel);
  load_row_stat(lse_s, lse, b, h, hq, q0, s);
  load_row_stat(delta_s, delta, b, h, hq, q0, s);

  float acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k, sk, b, hk, k0, s, d);
    load_tile<T, D>(Vs, v, sv, b, hk, k0, s, d);
    load_segments(kseg, seg, b, k0, s, kKSentinel);
    __syncthreads();

    float sc[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[kRows], g[kRows], bk[kCols], bv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = Qs[(ty * kRows + i) * (D + 1) + c];
        g[i] = dOs[(ty * kRows + i) * (D + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        bk[j] = Ks[(tx + 16 * j) * (D + 1) + c];
        bv[j] = Vs[(tx + 16 * j) * (D + 1) + c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sc[i][j] += a[i] * bk[j];
          dp[i][j] += g[i] * bv[j];
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = (k0 + kc <= qpos) && (qseg[r] == kseg[kc]);
        const float p = ok ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
        Ds[r * kLd + kc] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncwarp();

    for (int kk = 0; kk < kTile; ++kk) {
      float ds[kRows], kv[C];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = Ds[(ty * kRows + i) * kLd + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = Ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += ds[i] * kv[c];
    }
    __syncwarp();
  }

  const long long row = (long long)hq * d;  // dq is contiguous [b, s, hq, d]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= s) continue;
    T* out = dq + ((long long)b * s + qpos) * row + (long long)h * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(out + col, acc[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
    Strides sdo, int s, int hq, int hkv, int d, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                     // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);     // [kTile][D + 1]
  float* Qs = Vs + kTile * (D + 1);     // [kTile][D + 1]
  float* dOs = Qs + kTile * (D + 1);    // [kTile][D + 1]
  float* Ps = dOs + kTile * (D + 1);    // [kTile keys][kLd]: p^T
  float* Ds = Ps + kTile * kLd;         // [kTile keys][kLd]: ds^T
  float* lse_s = Ds + kTile * kLd;      // [kTile]
  float* delta_s = lse_s + kTile;       // [kTile]
  __shared__ int qseg[kTile], kseg[kTile];

  constexpr int C = D / 16;
  const int n_tiles = (s + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // key tile 0 has the most query tiles: first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = hq / hkv;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D>(Ks, k, sk, b, hk, k0, s, d);
  load_tile<T, D>(Vs, v, sv, b, hk, k0, s, d);
  load_segments(kseg, seg, b, k0, s, kKSentinel);

  float dk_acc[kRows][C], dv_acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    for (int qt = kt; qt < n_tiles; ++qt) {  // causal: query tiles at/after
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, D>(Qs, q, sq, b, h, q0, s, d);
      load_tile<T, D>(dOs, dout, sdo, b, h, q0, s, d);
      load_segments(qseg, seg, b, q0, s, kQSentinel);
      load_row_stat(lse_s, lse, b, h, hq, q0, s);
      load_row_stat(delta_s, delta, b, h, hq, q0, s);
      __syncthreads();

      // transposed tiles: rows are keys 4ty.., columns queries tx + 16j
      float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int c = 0; c < D; ++c) {
        float a[kRows], w[kRows], bq[kCols], bg[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          a[i] = Ks[(ty * kRows + i) * (D + 1) + c];
          w[i] = Vs[(ty * kRows + i) * (D + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          bq[j] = Qs[(tx + 16 * j) * (D + 1) + c];
          bg[j] = dOs[(tx + 16 * j) * (D + 1) + c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            st[i][j] += a[i] * bq[j];
            dpt[i][j] += w[i] * bg[j];
          }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kr = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int qc = tx + 16 * j;
          const bool ok = (k0 + kr <= q0 + qc) && (qseg[qc] == kseg[kr]);
          const float p = ok ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
          Ps[kr * kLd + qc] = p;
          Ds[kr * kLd + qc] = p * (dpt[i][j] - delta_s[qc]);
        }
      }
      __syncwarp();

      for (int qq = 0; qq < kTile; ++qq) {
        float pv[kRows], dsv[kRows], gv[C], qv[C];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = Ps[(ty * kRows + i) * kLd + qq];
          dsv[i] = Ds[(ty * kRows + i) * kLd + qq];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          gv[c] = dOs[qq * (D + 1) + tx + 16 * c];
          qv[c] = Qs[qq * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv_acc[i][c] += pv[i] * gv[c];
            dk_acc[i][c] += dsv[i] * qv[c];
          }
      }
      __syncwarp();
    }
  }

  const long long row = (long long)hkv * d;  // dk/dv contiguous [b, s, hkv, d]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + ty * kRows + i;
    if (kpos >= s) continue;
    const long long off = ((long long)b * s + kpos) * row + (long long)hk * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        store(dk + off + col, dk_acc[i][c] * scale);
        store(dv + off + col, dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;
  Strides sq, sk, sv, sdo;
  int b, s, hq, hkv, d;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s + kTile - 1) / kTile, a.hq, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int32_t*>(a.seg),
      static_cast<T*>(dq), a.sq, a.sk, a.sv, a.sdo, a.s, a.hq, a.hkv, a.d, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s + kTile - 1) / kTile, a.hkv, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int32_t*>(a.seg),
      static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, a.sv, a.sdo, a.s, a.hq,
      a.hkv, a.d, a.scale);
  return (int)cudaGetLastError();
}

bool valid(int b, int s, int hq, int hkv, int d) {
  return b > 0 && s > 0 && hkv > 0 && hq % hkv == 0 && d > 0 && d % 16 == 0 && d <= 128;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg,
               const long long* strides, int b, int s, int hq, int hkv, int d,
               float scale, void* stream) {
  return Args{q, k, v, dout, lse, delta, seg,
              strides_at(strides), strides_at(strides + 3), strides_at(strides + 6),
              strides_at(strides + 9), b, s, hq, hkv, d, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entry points, loaded with ctypes. strides: host array of 12 int64,
// the (batch, position, head) element strides of q, k, v and dO. lse and
// delta are contiguous f32 [b, hq, s]; dq a contiguous [b, s, hq, d] and
// dk/dv contiguous [b, s, hkv, d] tensors of q's dtype. is_bf16: 1 for bf16
// q/k/v/dO and outputs, 0 for f32. Each returns the cudaError_t after its
// launch (0 on success); shapes the kernels do not take return
// cudaErrorInvalidValue without launching.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* seg, void* dq,
                                   const long long* strides, int b, int s, int hq,
                                   int hkv, int d, int is_bf16, float scale,
                                   void* stream) {
  if (!valid(b, s, hq, hkv, d)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, strides, b, s, hq, hkv, d,
                           scale, stream);
  const bool d64 = padded_head_dim(d) == 64;
  if (is_bf16)
    return d64 ? launch_dq<__nv_bfloat16, 64>(a, dq) : launch_dq<__nv_bfloat16, 128>(a, dq);
  return d64 ? launch_dq<float, 64>(a, dq) : launch_dq<float, 128>(a, dq);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, const void* seg, void* dk,
                                    void* dv, const long long* strides, int b, int s,
                                    int hq, int hkv, int d, int is_bf16, float scale,
                                    void* stream) {
  if (!valid(b, s, hq, hkv, d)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, strides, b, s, hq, hkv, d,
                           scale, stream);
  const bool d64 = padded_head_dim(d) == 64;
  if (is_bf16)
    return d64 ? launch_dkv<__nv_bfloat16, 64>(a, dk, dv)
               : launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  return d64 ? launch_dkv<float, 64>(a, dk, dv) : launch_dkv<float, 128>(a, dk, dv);
}
