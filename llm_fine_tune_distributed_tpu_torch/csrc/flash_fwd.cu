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
// Bound. Causal attention does 4*d flops per visible (query, key) pair and
// query head (QK^T and PV) against b*s*(2*hq + 2*hkv)*d*2 bytes: at s = 1024,
// d = 128 that is hundreds of flops per byte, so on this card the work is
// bound by the bf16 tensor-core rate (989 TFLOP/s), and a kernel that does
// its products on the CUDA cores in f32 (67 TFLOP/s, and one shared load per
// two FMAs) is 100x from it.
//
// bf16 inputs (the training path): flash_fwd_tc_kernel. One block of 8 warps
// owns 128 query rows (two 64-row query tiles); each warp owns 16 rows,
// holds them as mma A fragments in registers, and runs both products on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32): S = Q K^T with K read by
// ldmatrix (K [key][d] is already the column-major B operand), then
// O += P V with V read by ldmatrix.trans. P never leaves registers: the f32
// score fragment is masked, exponentiated (one FFMA and one ex2 with log2(e)
// folded into the scale), summed into l in f32, rounded to bf16 and reused in
// place as the A fragment of P V (so P V takes P rounded to bf16, a stated
// difference from the f32 plain version). Row max and sum reduce over the 4
// lanes of a quad. 64-key K/V tiles stream through a 3-stage cp.async ring
// (16-byte copies, zero-filled past s and past d) into XOR-swizzled shared
// tiles, so ldmatrix is free of bank conflicts; one barrier per key tile.
// 128 query rows per block, not 64, because the K/V tiles come from L2 once
// per block: at 64 rows that traffic held the kernel to 88 TFLOP/s on an
// H100, at 128 it reaches 143. About 129 KB of shared memory and ~250
// registers per thread at d 128: one block of 8 warps per SM. Tile pairs are skipped above
// the causal limit and where the query tile's and key tile's segment ranges
// are disjoint (flash_mma.cuh, flash_tile_pairs in ops/flash_attention.py):
// the block loads a key tile that either of its query tiles visits, and each
// warp computes only its own tile's pairs. A key tile strictly below the
// diagonal whose rows and the query rows all carry one segment id needs no
// mask. On request (visits) the kernel counts every pair it computes, so a
// caller can hold its walk against flash_tile_pairs on the card. Blocks are
// issued longest first across all heads and rows. d a
// multiple of 16 up to 128 (zero-padded to 64 or 128 in shared memory);
// 16-byte-aligned bases and strides that are multiples of 8 elements.
//
// f32 inputs (the parity checks only): flash_fwd_kernel, the CUDA-core
// kernel: one block of 256 threads per 64-row query tile, f32 tiles in
// shared memory ([64][d+1]), thread (ty, tx) computes the 4 x 4 scores of
// rows 4ty.. and key columns tx + 16j, reduces over the 16 lanes of its row
// group with shuffles and accumulates O for its 4 rows and d/16 columns.
// The dispatch is by dtype, in flash_fwd_launch.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcFwdWarps = 8;                    // 16 query rows each
constexpr int kTcFwdThreads = 32 * kTcFwdWarps;
constexpr int kTcFwdRows = 2 * kTile;             // query rows of a block
constexpr int kTcFwdStages = 3;                   // K/V tiles in the ring

// Q (two 64-row tiles), then kTcFwdStages x (K, V), then kTcFwdStages key
// segment rows, then the per-tile segment ranges (16 bytes per tile)
template <int D>
size_t fwd_tc_smem_bytes(int n_tiles) {
  return (2 + 2 * kTcFwdStages) * kTile * D * 2 + kTcFwdStages * kTile * sizeof(int) +
         16 * (size_t)n_tiles;
}

template <int D>
__global__ void __launch_bounds__(kTcFwdThreads, 1) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int* __restrict__ visits,
    Strides sq, Strides sk, Strides sv, int s, int hq, int hkv, int d, float scale) {
  constexpr int kBytes = kTile * D * 2;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T; pairs of d n-tiles of P V
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t q_s = smem_addr(smem_tc);  // [kTcFwdRows][D]
  int* kseg = reinterpret_cast<int*>(smem_tc + (2 + 2 * kTcFwdStages) * kBytes);
  int* rng = kseg + kTcFwdStages * kTile;

  const int n_tiles = (s + kTile - 1) / kTile;
  const int n_blocks = (s + kTcFwdRows - 1) / kTcFwdRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_blocks - 1 - blockIdx.z) * kTcFwdRows;  // longest blocks first
  const int qt0 = q0 / kTile;                      // the block's two query tiles
  const int last = min(qt0 + 1, n_tiles - 1);      // and its last key tile
  const int hk = h / (hq / hkv);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int my_qt = qt0 + warp / 4;  // this warp's query tile

  copy_tile_async<D, kTcFwdThreads>(q_s, q, sq, b, h, q0, s, d);
  copy_tile_async<D, kTcFwdThreads>(q_s + kBytes, q, sq, b, h, q0 + kTile, s, d);
  cp_async_commit();
  tile_ranges<kTcFwdThreads>(rng, seg, b, s, 0, last);
  __syncthreads();
  const Range empty{INT_MAX, INT_MIN};  // a query tile past s visits nothing
  const Range r0 = tile_range(rng, qt0);
  const Range r1 = qt0 + 1 < n_tiles ? tile_range(rng, qt0 + 1) : empty;
  const Range mine = warp < 4 ? r0 : r1;
  // (query tile qt, key tile kt) is visited iff kt <= qt and their segment
  // ranges meet (flash_tile_pairs); the block loads a key tile that either
  // of its query tiles visits, and a warp computes only its own pairs
  auto wanted = [&](int qt, Range qr, int kt) {
    return kt <= qt && ranges_meet(qr, tile_range(rng, kt));
  };
  auto next = [&](int kt) {  // first loaded key tile at or after kt; last + 1 past the end
    while (kt <= last && !wanted(qt0, r0, kt) && !wanted(qt0 + 1, r1, kt)) ++kt;
    return kt;
  };
  auto load_kv = [&](int stage, int kt) {
    const uint32_t base = q_s + (2 + 2 * stage) * kBytes;
    copy_tile_async<D, kTcFwdThreads>(base, k, sk, b, hk, kt * kTile, s, d);
    copy_tile_async<D, kTcFwdThreads>(base + kBytes, v, sv, b, hk, kt * kTile, s, d);
    copy_row_async(kseg + stage * kTile, seg, (long long)b * s, kt * kTile, s, 0);
  };
  // fill all but one stage of the ring, one commit group per tile
  int kt_load = next(0);
  for (int st = 0; st < kTcFwdStages - 1; ++st) {
    if (kt_load <= last) {
      load_kv(st, kt_load);
      kt_load = next(kt_load + 1);
    }
    cp_async_commit();
  }

  // this thread's query rows: g and g + 8 of its warp's 16
  const int qpos0 = q0 + warp * 16 + g;
  const int qpos1 = qpos0 + 8;
  const int qseg0 = qpos0 < s ? seg[(long long)b * s + qpos0] : kQSentinel;
  const int qseg1 = qpos1 < s ? seg[(long long)b * s + qpos1] : kQSentinel;

  cp_async_wait<kTcFwdStages - 1>();  // Q has landed
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) load_a<D>(qf[ks], q_s, warp * 16, ks * 16, lane);

  float acc[2 * kSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in units of raw scores
  const float sl2 = scale * kLog2e;

  int stage = 0;
  int load_stage = kTcFwdStages - 1;
  for (int kt = next(0); kt <= last; kt = next(kt + 1)) {
    cp_async_wait<kTcFwdStages - 2>();
    __syncthreads();  // this tile has landed; the stage read last iteration is free
    if (kt_load <= last) {
      load_kv(load_stage, kt_load);
      kt_load = next(kt_load + 1);
    }
    cp_async_commit();
    const uint32_t k_s = q_s + (2 + 2 * stage) * kBytes;
    const uint32_t v_s = k_s + kBytes;
    const int* ks_tile = kseg + stage * kTile;
    stage = stage + 1 == kTcFwdStages ? 0 : stage + 1;
    load_stage = load_stage + 1 == kTcFwdStages ? 0 : load_stage + 1;
    const Range kr = tile_range(rng, kt);
    if (!(kt <= my_qt && ranges_meet(mine, kr))) continue;  // warp-uniform
    if (visits != nullptr && lane == 0 && warp % 4 == 0)  // one count per computed pair
      atomicAdd(visits + ((long long)b * n_tiles + my_qt) * n_tiles + kt, 1);

    float sc[8][4];  // S for 16 rows x 64 keys: 8 n-tiles of 8 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_nk<D>(bk, k_s, np * 16, ks * 16, lane);
        mma_bf16(sc[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // mask (c0, c1 are row g, c2, c3 row g + 8); a tile strictly below the
    // diagonal where the query rows and keys carry one segment id needs none
    if (!(kt < my_qt && one_segment(mine, kr))) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kc = n * 8 + 2 * t + j;
          const int kpos = kt * kTile + kc;
          const int ksg = ks_tile[kc];
          if (!(kpos <= qpos0 && ksg == qseg0)) sc[n][j] = kNegInf;
          if (!(kpos <= qpos1 && ksg == qseg1)) sc[n][2 + j] = kNegInf;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2((m0 - mn0) * sl2);
    const float alpha1 = fast_exp2((m1 - mn1) * sl2);
    m0 = mn0;
    m1 = mn1;
    const float off0 = mn0 * sl2;
    const float off1 = mn1 * sl2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // p = exp(scale (s - m)) as one FFMA and one ex2; a masked score is
        // exactly kNegInf, tested since a row with no visible key yet has
        // m = kNegInf too
        const float p0 = sc[n][j] == kNegInf ? 0.f : fast_exp2(fmaf(sc[n][j], sl2, -off0));
        const float p1 = sc[n][2 + j] == kNegInf ? 0.f : fast_exp2(fmaf(sc[n][2 + j], sl2, -off1));
        sc[n][j] = p0;
        sc[n][2 + j] = p1;
        rs0 += p0;
        rs1 += p1;
      }
    }
    l0 = l0 * alpha0 + rs0;  // this thread's columns; the quad sums at the end
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V: P's accumulator fragments are the A fragments, 16 keys each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        uint32_t bv[4];
        load_b_kn<D>(bv, v_s, kk * 16, dp * 16, lane);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const long long o_pos = (long long)hq * d;  // o is contiguous [b, s, hq, d]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qpos1 : qpos0;
    if (qpos >= s) continue;
    const float ls = fmaxf(half ? l1 : l0, 1e-30f);
    __nv_bfloat16* orow = o + ((long long)b * s + qpos) * o_pos + (long long)h * d;
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[n][2 * half] / ls, acc[n][2 * half + 1] / ls);
    }
    if (t == 0) lse[((long long)b * hq + h) * s + qpos] = (half ? m1 : m0) * scale + logf(ls);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* seg, void* o,
              void* lse, int* visits, const long long* strides, int b, int s, int hq,
              int hkv, int d, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<D>;
  const size_t smem = fwd_tc_smem_bytes<D>((s + kTile - 1) / kTile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (s + kTcFwdRows - 1) / kTcFwdRows);
  kernel<<<grid, kTcFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), visits, strides_at(strides),
      strides_at(strides + 3), strides_at(strides + 6), s, hq, hkv, d, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

}  // namespace

// Plain C entry point, loaded with ctypes. strides: host array of 9 int64,
// the (batch, position, head) element strides of q, k and v; o must be a
// contiguous [b, s, hq, d] tensor of q's dtype, lse a contiguous f32
// [b, hq, s]. is_bf16: 1 for bf16 q/k/v/o, which run flash_fwd_tc_kernel on
// the tensor cores; 0 for f32, which runs the CUDA-core flash_fwd_kernel.
// visits: null, or (bf16 only) a zeroed int32 [b, n, n], n = ceil(s / 64), to
// which the kernel adds one at (row, query tile, key tile) for every query
// head whose pair it computes: its own walk, for counting against
// flash_tile_pairs. Returns the cudaError_t after the launch (0 on success); shapes or bf16
// layouts the kernels do not take return cudaErrorInvalidValue without
// launching.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg, void* o, void* lse, void* visits,
                                const long long* strides, int b, int s, int hq,
                                int hkv, int d, int is_bf16, float scale,
                                void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 || d % 16 != 0 ||
      d > 128 || (visits != nullptr && !is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = padded_head_dim(d) == 64;
  if (is_bf16) {
    if (!tc_layout_ok(q, strides) || !tc_layout_ok(k, strides + 3) ||
        !tc_layout_ok(v, strides + 6))
      return (int)cudaErrorInvalidValue;
    int* vis = static_cast<int*>(visits);
    return d64 ? launch_tc<64>(q, k, v, seg, o, lse, vis, strides, b, s, hq, hkv, d, scale, st)
               : launch_tc<128>(q, k, v, seg, o, lse, vis, strides, b, s, hq, hkv, d, scale, st);
  }
  return d64 ? launch<float, 64>(q, k, v, seg, o, lse, strides, b, s, hq, hkv, d, scale, st)
             : launch<float, 128>(q, k, v, seg, o, lse, strides, b, s, hq, hkv, d, scale, st);
}

// Dynamic shared memory (bytes) that one flash_fwd_tc_kernel block asks for
// at head dim d and sequence length s: for reports.
extern "C" long long flash_fwd_tc_smem(int d, int s) {
  const int n_tiles = (s + kTile - 1) / kTile;
  return (long long)(padded_head_dim(d) == 64 ? fwd_tc_smem_bytes<64>(n_tiles)
                                              : fwd_tc_smem_bytes<128>(n_tiles));
}
