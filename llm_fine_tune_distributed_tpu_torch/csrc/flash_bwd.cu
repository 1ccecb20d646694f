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
//          head width and every block owns its output rows: no atomics, and
//          the result is deterministic.
//
// Bound. The backward recomputes the scores in both kernels and forms
// dO V^T in both: 8*d flops per visible pair and query head for dk/dv, 6*d
// for dq, against a few bytes per element of q, k, v, dO and the outputs, so
// on this card both are bound by the bf16 tensor-core rate (989 TFLOP/s);
// f32 products on the CUDA cores (67 TFLOP/s, one shared load per two FMAs)
// are 100x from it.
//
// dk/dv, bf16 inputs (the training path): flash_bwd_dkv_tc_kernel, all four
// products on the tensor cores (mma.sync m16n8k16 bf16 -> f32). One block of
// 8 warps owns one 64-row key tile: K and V are staged once and each warp
// holds the A fragments of 16 keys; the query tiles of the G heads stream
// Q, dO, LSE, delta and segments through a 2-stage cp.async ring into
// XOR-swizzled shared tiles. The products are taken transposed so that Q and
// dO are the column-major B operands as stored: warp (key group kg, query
// half) forms S^T = K Q^T and dP^T = V dO^T for its 16 keys x 32 queries,
// p^T = exp2(S^T scale log2(e) - LSE log2(e)) under the mask and
// dS^T = p^T (dP^T - delta), rounded to bf16 (a stated difference from the
// f32 plain version) into two small shared tiles. After one barrier, warp
// (kg, column half) accumulates dV += P^T dO and dK += dS^T Q for its 16
// keys x d/2 columns, P^T/dS^T read by ldmatrix as A fragments and dO/Q by
// ldmatrix.trans as B fragments. That split keeps the dK/dV accumulators at
// d/8 + d/8 registers per thread beside the K/V fragments, so ptxas spills
// nothing at d 128. Query tiles are skipped below the causal limit and where
// the segment ranges of the key tile and the query tile are disjoint
// (flash_mma.cuh); a query tile strictly after the key tile, inside s, whose
// rows all share the key tile's one segment id needs no mask; on request
// (visits) the kernel counts every pair it computes. Key tile 0,
// which has the most query tiles, is issued first. About 114 KB of shared
// memory at d 128: one block of 8 warps per SM. d a multiple of 16 up to
// 128; 16-byte-aligned bases and strides that are multiples of 8 elements.
//
// dq, bf16 inputs (the training path): flash_bwd_dq_tc_kernel, the
// forward's structure with more products per key tile, all on the tensor
// cores (mma.sync m16n8k16 bf16 -> f32). One block of 8 warps owns 128 query
// rows (two 64-row query tiles) of one (row, query head); Q, dO and LSE are
// staged once, and 64-key K/V tiles stream through a 3-stage cp.async ring
// into XOR-swizzled shared tiles, one barrier per key tile. Each warp owns 16
// query rows: S = Q K^T and dP = dO V^T with K and V read by ldmatrix as the
// column-major B operands they already are, p = exp2(S scale log2(e) - LSE
// log2(e)) under the mask. The block walks its key tiles twice. Sweep 0 sums
// delta = sum_k p dP per row in f32: the rowsum(dO O) of the truth, formed
// from this p rather than read from the caller's delta, which comes from the
// bf16 O (its rounding left dq of rows with few visible keys, where the
// truth is small, at up to 4x SDPA's error on an H100; the caller's delta
// still feeds dk/dv and the f32 kernel). Sweep 1
// forms dS = p (dP - delta) in f32, rounds it to bf16 in place as the A
// fragment of dQ += dS K, with K read by ldmatrix.trans (so dS K takes dS as
// bf16, as SDPA's backward does: a stated difference from the f32 plain
// version), and rounds dq scale once to bf16 at the end. The second sweep
// costs S and dP once more per tile (5 products where 3 would do). The Q and
// dO fragments are read from shared memory at every k-step rather than held:
// dQ (d/2 f32 per thread), S and dP (32 each) then fit the 255 registers
// with no spill at d 128. The walk is the forward's: key tiles above the
// causal limit or whose segment range misses the query tile's are skipped, a
// tile strictly below the diagonal whose rows all carry the query tile's one
// segment id needs no mask, blocks are issued longest first, and on request
// (visits) the kernel counts every pair it visits, once. About 161 KB of
// shared memory at d 128: one block of 8 warps per SM. d a multiple of 16 up
// to 128; 16-byte-aligned bases and strides that are multiples of 8
// elements.
//
// dq and dk/dv for f32 inputs (the parity checks only): the CUDA-core
// kernels. Each block (256 threads) stages 64-row tiles in shared
// memory as f32 ([64][d+1]) and loops over the other operand's tiles itself.
// In the dq kernel thread (ty, tx) owns query rows 4ty.. and key columns
// tx + 16j of a score tile; in the dk/dv kernel it owns key rows 4ty.. and
// query columns tx + 16j, so both kernels' accumulators (dq, or dk and dv)
// are rows of the thread's own row group: the shared p/ds tiles are written
// and read by one warp, and __syncwarp is the only barrier between score and
// accumulate. Any s, d a multiple of 16 up to 128 (zero-padded to 64 or 128
// in shared memory). The dispatch is by dtype, in flash_bwd_dq_launch and
// flash_bwd_dkv_launch.

#include "flash_common.cuh"
#include "flash_mma.cuh"

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
// dq, bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcDqWarps = 8;                  // 16 query rows each
constexpr int kTcDqThreads = 32 * kTcDqWarps;
constexpr int kTcDqRows = 2 * kTile;           // query rows of a block
constexpr int kTcDqStages = 3;                 // K/V tiles in the ring

// Q and dO (two 64-row tiles each), then kTcDqStages x (K, V), then the
// block's LSE (f32, kTcDqRows), kTcDqStages key segment rows, then the
// per-tile segment ranges (16 bytes per tile)
template <int D>
size_t dq_tc_smem_bytes(int n_tiles) {
  return (4 + 2 * kTcDqStages) * kTile * D * 2 + kTcDqRows * sizeof(float) +
         kTcDqStages * kTile * sizeof(int) + 16 * (size_t)n_tiles;
}

template <int D>
__global__ void __launch_bounds__(kTcDqThreads, 1) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const int32_t* __restrict__ seg,
    __nv_bfloat16* __restrict__ dq, int* __restrict__ visits, Strides sq, Strides sk,
    Strides sv, Strides sdo, int s, int hq, int hkv, int d, float scale) {
  constexpr int kBytes = kTile * D * 2;
  constexpr int kSteps = D / 16;  // k-steps of S and dP; pairs of d n-tiles of dS K
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t q_s = smem_addr(smem_tc);  // [kTcDqRows][D]
  const uint32_t do_s = q_s + 2 * kBytes;   // [kTcDqRows][D]
  const uint32_t ring = q_s + 4 * kBytes;   // kTcDqStages x (K, V)
  float* lse_s = reinterpret_cast<float*>(smem_tc + (4 + 2 * kTcDqStages) * kBytes);
  int* kseg = reinterpret_cast<int*>(lse_s + kTcDqRows);
  int* rng = kseg + kTcDqStages * kTile;

  const int n_tiles = (s + kTile - 1) / kTile;
  const int n_blocks = (s + kTcDqRows - 1) / kTcDqRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_blocks - 1 - blockIdx.z) * kTcDqRows;  // longest blocks first
  const int qt0 = q0 / kTile;                   // the block's two query tiles
  const int last = min(qt0 + 1, n_tiles - 1);   // and its last key tile
  const int hk = h / (hq / hkv);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int my_qt = qt0 + warp / 4;  // this warp's query tile

  copy_tile_async<D, kTcDqThreads>(q_s, q, sq, b, h, q0, s, d);
  copy_tile_async<D, kTcDqThreads>(q_s + kBytes, q, sq, b, h, q0 + kTile, s, d);
  copy_tile_async<D, kTcDqThreads>(do_s, dout, sdo, b, h, q0, s, d);
  copy_tile_async<D, kTcDqThreads>(do_s + kBytes, dout, sdo, b, h, q0 + kTile, s, d);
  const long long stat_row = ((long long)b * hq + h) * s;
  copy_row_async(lse_s, lse, stat_row, q0, s, 0);
  copy_row_async(lse_s + kTile, lse, stat_row, q0 + kTile, s, kTile);
  cp_async_commit();
  tile_ranges<kTcDqThreads>(rng, seg, b, s, 0, last);
  __syncthreads();
  const Range empty{INT_MAX, INT_MIN};  // a query tile past s visits nothing
  const Range r0 = tile_range(rng, qt0);
  const Range r1 = qt0 + 1 < n_tiles ? tile_range(rng, qt0 + 1) : empty;
  const Range mine = warp < 4 ? r0 : r1;
  // the forward's walk: (query tile qt, key tile kt) is visited iff
  // kt <= qt and their segment ranges meet (flash_tile_pairs); the block
  // walks the key tiles twice, sweep 0 for delta and sweep 1 for dQ: step
  // x = sweep * n_kt + kt
  const int n_kt = last + 1;
  auto wanted = [&](int qt, Range qr, int kt) {
    return kt <= qt && ranges_meet(qr, tile_range(rng, kt));
  };
  auto next = [&](int x) {  // first loaded step at or after x; 2 n_kt past the end
    while (x < 2 * n_kt && !wanted(qt0, r0, x % n_kt) && !wanted(qt0 + 1, r1, x % n_kt)) ++x;
    return x;
  };
  auto load_kv = [&](int stage, int kt) {
    const uint32_t base = ring + 2 * stage * kBytes;
    copy_tile_async<D, kTcDqThreads>(base, k, sk, b, hk, kt * kTile, s, d);
    copy_tile_async<D, kTcDqThreads>(base + kBytes, v, sv, b, hk, kt * kTile, s, d);
    copy_row_async(kseg + stage * kTile, seg, (long long)b * s, kt * kTile, s, 0);
  };
  // fill all but one stage of the ring, one commit group per tile
  int x_load = next(0);
  for (int st = 0; st < kTcDqStages - 1; ++st) {
    if (x_load < 2 * n_kt) {
      load_kv(st, x_load % n_kt);
      x_load = next(x_load + 1);
    }
    cp_async_commit();
  }

  // this thread's query rows: g and g + 8 of its warp's 16
  const int qpos0 = q0 + warp * 16 + g;
  const int qpos1 = qpos0 + 8;
  const int qseg0 = qpos0 < s ? seg[(long long)b * s + qpos0] : kQSentinel;
  const int qseg1 = qpos1 < s ? seg[(long long)b * s + qpos1] : kQSentinel;

  cp_async_wait<kTcDqStages - 1>();  // Q, dO and LSE have landed
  __syncthreads();
  const float l2_0 = lse_s[warp * 16 + g] * kLog2e;  // LSE in base 2
  const float l2_1 = lse_s[warp * 16 + g + 8] * kLog2e;
  float dl0 = 0.f, dl1 = 0.f;  // delta: this thread's columns of sum_k p dP, then the rows'

  float acc[2 * kSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  const float sl2 = scale * kLog2e;

  int stage = 0;
  int load_stage = kTcDqStages - 1;
  bool summed = false;  // delta reduced over the quad
  for (int x = next(0); x < 2 * n_kt; x = next(x + 1)) {
    cp_async_wait<kTcDqStages - 2>();
    __syncthreads();  // this tile has landed; the stage read last iteration is free
    if (x_load < 2 * n_kt) {
      load_kv(load_stage, x_load % n_kt);
      x_load = next(x_load + 1);
    }
    cp_async_commit();
    const uint32_t k_s = ring + 2 * stage * kBytes;
    const uint32_t v_s = k_s + kBytes;
    const int* ks_tile = kseg + stage * kTile;
    stage = stage + 1 == kTcDqStages ? 0 : stage + 1;
    load_stage = load_stage + 1 == kTcDqStages ? 0 : load_stage + 1;
    const int kt = x % n_kt;
    const bool dq_sweep = x >= n_kt;  // block-uniform
    if (dq_sweep && !summed) {  // the first step of sweep 1: every row's delta is complete
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
      summed = true;
    }
    const Range kr = tile_range(rng, kt);
    if (!(kt <= my_qt && ranges_meet(mine, kr))) continue;  // warp-uniform
    if (dq_sweep && visits != nullptr && lane == 0 && warp % 4 == 0)  // one count per pair
      atomicAdd(visits + ((long long)b * n_tiles + my_qt) * n_tiles + kt, 1);

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys (8 n-tiles of 8 keys);
    // the Q and dO fragments are read from shared memory at each k-step,
    // which keeps dQ, S and dP (128 f32 at d 128) in registers
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qa[4], ga[4];
      load_a<D>(qa, q_s, warp * 16, ks * 16, lane);
      load_a<D>(ga, do_s, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk<D>(bk, k_s, np * 16, ks * 16, lane);
        mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
        load_b_nk<D>(bv, v_s, np * 16, ks * 16, lane);
        mma_bf16(dp[2 * np], ga, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ga, bv[2], bv[3]);
      }
    }

    // p = exp2(S scale log2(e) - LSE log2(e)) under the mask (c0, c1 are
    // row g, c2, c3 row g + 8); sweep 0 adds p dP to delta, sweep 1 puts
    // dS = p (dP - delta) in place of dP. A tile strictly below the diagonal
    // where the query rows and keys carry one segment id needs no mask.
    const bool full = kt < my_qt && one_segment(mine, kr);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = n * 8 + 2 * t + j;
        float p0 = fast_exp2(fmaf(sc[n][j], sl2, -l2_0));
        float p1 = fast_exp2(fmaf(sc[n][2 + j], sl2, -l2_1));
        if (!full) {
          const int kpos = kt * kTile + kc;
          const int ksg = ks_tile[kc];
          if (!(kpos <= qpos0 && ksg == qseg0)) p0 = 0.f;
          if (!(kpos <= qpos1 && ksg == qseg1)) p1 = 0.f;
        }
        if (dq_sweep) {
          dp[n][j] = p0 * (dp[n][j] - dl0);
          dp[n][2 + j] = p1 * (dp[n][2 + j] - dl1);
        } else {
          dl0 = fmaf(p0, dp[n][j], dl0);
          dl1 = fmaf(p1, dp[n][2 + j], dl1);
        }
      }
    }
    if (!dq_sweep) continue;

    // dQ += dS K: dS's accumulator fragments, rounded to bf16, are the A
    // fragments (16 keys each); K [key][d] is read transposed as B
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn) {
        uint32_t bk[4];
        load_b_kn<D>(bk, k_s, kk * 16, dn * 16, lane);
        mma_bf16(acc[2 * dn], da, bk[0], bk[1]);
        mma_bf16(acc[2 * dn + 1], da, bk[2], bk[3]);
      }
    }
  }

  const long long row_stride = (long long)hq * d;  // dq is contiguous [b, s, hq, d]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qpos1 : qpos0;
    if (qpos >= s) continue;
    __nv_bfloat16* out = dq + ((long long)b * s + qpos) * row_stride + (long long)h * d;
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
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
// dk / dv, bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcDkvThreads = 256;  // 8 warps: 4 key groups x 2 halves

// K, V, 2 stages of (Q, dO), P^T and dS^T (bf16 [kTile][kTile]), 2 stages of
// (LSE, delta, query segments), then the per-tile segment ranges
template <int D>
size_t dkv_tc_smem_bytes(int n_tiles) {
  return 6 * kTile * D * 2 + 2 * kTile * kTile * 2 + 2 * 3 * kTile * 4 + 16 * (size_t)n_tiles;
}

template <int D>
__global__ void __launch_bounds__(kTcDkvThreads, 1) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int* __restrict__ visits, Strides sq, Strides sk,
    Strides sv, Strides sdo, int s, int hq, int hkv, int d, float scale) {
  constexpr int kBytes = kTile * D * 2;
  constexpr int kPBytes = kTile * kTile * 2;
  constexpr int kSteps = D / 16;  // k-steps of S^T and dP^T
  constexpr int kCols = D / 2;    // dK/dV columns of one warp
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t k_s = smem_addr(smem_tc);
  const uint32_t v_s = k_s + kBytes;
  unsigned char* pt = smem_tc + 6 * kBytes;  // P^T [key][query]
  unsigned char* dst = pt + kPBytes;      // dS^T [key][query]
  float* stats = reinterpret_cast<float*>(dst + kPBytes);  // [2][lse, delta, seg][kTile]
  int* rng = reinterpret_cast<int*>(stats + 2 * 3 * kTile);

  const int n_tiles = (s + kTile - 1) / kTile;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;  // key tile 0 has the most query tiles: first
  const int groups = hq / hkv;
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kg = warp % 4;    // 16 keys kg*16.. in both phases
  const int half = warp / 4;  // queries half*32.. (phase 1), columns half*D/2.. (phase 2)

  copy_tile_async<D, kTcDkvThreads>(k_s, k, sk, b, hk, k0, s, d);
  copy_tile_async<D, kTcDkvThreads>(v_s, v, sv, b, hk, k0, s, d);
  cp_async_commit();
  tile_ranges<kTcDkvThreads>(rng, seg, b, s, kt, n_tiles - 1);
  __syncthreads();
  const Range kr = tile_range(rng, kt);
  // first visited query tile at or after qt; n_tiles past the last (the
  // diagonal tile kt is always visited)
  auto next_q = [&](int qt) {
    while (qt < n_tiles && !ranges_meet(kr, tile_range(rng, qt))) ++qt;
    return qt;
  };
  auto load_q = [&](int stage, int h, int qt) {
    const uint32_t qs = k_s + (2 + 2 * stage) * kBytes;
    copy_tile_async<D, kTcDkvThreads>(qs, q, sq, b, h, qt * kTile, s, d);
    copy_tile_async<D, kTcDkvThreads>(qs + kBytes, dout, sdo, b, h, qt * kTile, s, d);
    float* st = stats + stage * 3 * kTile;
    const long long row = ((long long)b * hq + h) * s;
    copy_row_async(st, lse, row, qt * kTile, s, 0);
    copy_row_async(st + kTile, delta, row, qt * kTile, s, kTile);
    copy_row_async(st + 2 * kTile, seg, (long long)b * s, qt * kTile, s, 2 * kTile);
  };
  const int first = next_q(kt);
  int gi = 0;
  int qt = first;
  load_q(0, hk * groups, qt);
  cp_async_commit();

  // this thread's keys: rows g and g + 8 of its key group
  const int kpos0 = k0 + kg * 16 + g;
  const int kpos1 = kpos0 + 8;
  const int kseg0 = kpos0 < s ? seg[(long long)b * s + kpos0] : kKSentinel;
  const int kseg1 = kpos1 < s ? seg[(long long)b * s + kpos1] : kKSentinel;

  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  uint32_t kf[kSteps][4], vf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    load_a<D>(kf[ks], k_s, kg * 16, ks * 16, lane);
    load_a<D>(vf[ks], v_s, kg * 16, ks * 16, lane);
  }
  float dka[kCols / 8][4], dva[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;
  const float sl2 = scale * kLog2e;

  int stage = 0;
  while (true) {
    int gn = gi;
    int qn = next_q(qt + 1);
    if (qn >= n_tiles) {
      ++gn;
      qn = first;
    }
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage and P^T/dS^T are free
    if (gn < groups) load_q(stage ^ 1, hk * groups + gn, qn);
    cp_async_commit();

    const uint32_t qs = k_s + (2 + 2 * stage) * kBytes;
    const uint32_t dos = qs + kBytes;
    const float* lse_s = stats + stage * 3 * kTile;
    const float* delta_s = lse_s + kTile;
    const int* qseg_s = reinterpret_cast<const int*>(lse_s + 2 * kTile);
    const int q0 = qt * kTile;
    if (visits != nullptr && threadIdx.x == 0)  // one count per computed pair and query head
      atomicAdd(visits + ((long long)b * n_tiles + qt) * n_tiles + kt, 1);

    // phase 1: S^T and dP^T for 16 keys x 32 queries (4 n-tiles of 8)
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bd[4];
        load_b_nk<D>(bq, qs, half * 32 + np * 16, ks * 16, lane);
        mma_bf16(sc[2 * np], kf[ks], bq[0], bq[1]);
        mma_bf16(sc[2 * np + 1], kf[ks], bq[2], bq[3]);
        load_b_nk<D>(bd, dos, half * 32 + np * 16, ks * 16, lane);
        mma_bf16(dp[2 * np], vf[ks], bd[0], bd[1]);
        mma_bf16(dp[2 * np + 1], vf[ks], bd[2], bd[3]);
      }
    }
    const bool full = qt > kt && q0 + kTile <= s && one_segment(kr, tile_range(rng, qt));
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = half * 32 + n * 8 + 2 * t + j;  // c0, c1: key g; c2, c3: key g + 8
        const float l2 = lse_s[qc] * kLog2e;
        const float dl = delta_s[qc];
        float p0 = fast_exp2(fmaf(sc[n][j], sl2, -l2));
        float p1 = fast_exp2(fmaf(sc[n][2 + j], sl2, -l2));
        if (!full) {
          const int qpos = q0 + qc;
          const int qsg = qseg_s[qc];
          const bool in = qpos < s;
          if (!(in && kpos0 <= qpos && kseg0 == qsg)) p0 = 0.f;
          if (!(in && kpos1 <= qpos && kseg1 == qsg)) p1 = 0.f;
        }
        sc[n][j] = p0;
        sc[n][2 + j] = p1;
        dp[n][j] = p0 * (dp[n][j] - dl);
        dp[n][2 + j] = p1 * (dp[n][2 + j] - dl);
      }
      const uint32_t off0 = swz<kTile>(kg * 16 + g, half * 32 + n * 8) + 4 * t;
      const uint32_t off1 = swz<kTile>(kg * 16 + g + 8, half * 32 + n * 8) + 4 * t;
      *reinterpret_cast<uint32_t*>(pt + off0) = pack_bf16(sc[n][0], sc[n][1]);
      *reinterpret_cast<uint32_t*>(pt + off1) = pack_bf16(sc[n][2], sc[n][3]);
      *reinterpret_cast<uint32_t*>(dst + off0) = pack_bf16(dp[n][0], dp[n][1]);
      *reinterpret_cast<uint32_t*>(dst + off1) = pack_bf16(dp[n][2], dp[n][3]);
    }
    __syncthreads();  // P^T and dS^T of all 64 queries are in shared memory

    // phase 2: dV += P^T dO and dK += dS^T Q for 16 keys x D/2 columns
    const uint32_t pt_s = smem_addr(pt);
    const uint32_t dst_s = smem_addr(dst);
#pragma unroll
    for (int kq = 0; kq < kTile / 16; ++kq) {
      uint32_t pa[4], sa[4];
      load_a<kTile>(pa, pt_s, kg * 16, kq * 16, lane);
      load_a<kTile>(sa, dst_s, kg * 16, kq * 16, lane);
#pragma unroll
      for (int np = 0; np < kCols / 16; ++np) {
        const int col = half * kCols + np * 16;
        uint32_t bo[4], bq[4];
        load_b_kn<D>(bo, dos, kq * 16, col, lane);
        mma_bf16(dva[2 * np], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * np + 1], pa, bo[2], bo[3]);
        load_b_kn<D>(bq, qs, kq * 16, col, lane);
        mma_bf16(dka[2 * np], sa, bq[0], bq[1]);
        mma_bf16(dka[2 * np + 1], sa, bq[2], bq[3]);
      }
    }
    if (gn >= groups) break;
    gi = gn;
    qt = qn;
    stage ^= 1;
  }

  const long long row = (long long)hkv * d;  // dk/dv contiguous [b, s, hkv, d]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r ? kpos1 : kpos0;
    if (kpos >= s) continue;
    const long long off = ((long long)b * s + kpos) * row + (long long)hk * d;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const int col = half * kCols + n * 8 + 2 * t;
      if (col >= d) continue;
      *reinterpret_cast<uint32_t*>(dk + off + col) =
          pack_bf16(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + col) = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
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

template <int D>
int launch_dq_tc(const Args& a, void* dq, int* visits) {
  auto kernel = flash_bwd_dq_tc_kernel<D>;
  const size_t smem = dq_tc_smem_bytes<D>((a.s + kTile - 1) / kTile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.hq, a.b, (a.s + kTcDqRows - 1) / kTcDqRows);
  kernel<<<grid, kTcDqThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const int32_t*>(a.seg),
      static_cast<__nv_bfloat16*>(dq), visits, a.sq, a.sk, a.sv, a.sdo, a.s, a.hq, a.hkv, a.d,
      a.scale);
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

template <int D>
int launch_dkv_tc(const Args& a, void* dk, void* dv, int* visits) {
  auto kernel = flash_bwd_dkv_tc_kernel<D>;
  const int n_tiles = (a.s + kTile - 1) / kTile;
  const size_t smem = dkv_tc_smem_bytes<D>(n_tiles);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.hkv, a.b, n_tiles);
  kernel<<<grid, kTcDkvThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.seg), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), visits, a.sq, a.sk, a.sv, a.sdo, a.s, a.hq, a.hkv,
      a.d, a.scale);
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
// q/k/v/dO and outputs, which run flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel on the tensor cores; 0 for f32, which runs the
// CUDA-core flash_bwd_dq_kernel and flash_bwd_dkv_kernel. visits: null, or
// (bf16 only) a zeroed int32 [b, n, n], n = ceil(s / 64), to which the
// kernel adds one at (row, query tile, key tile) for every query head whose
// pair it computes, as flash_fwd_launch does. Each returns the cudaError_t
// after its launch (0 on success); shapes or bf16 layouts the kernels do not
// take return cudaErrorInvalidValue without launching.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* seg, void* dq,
                                   void* visits, const long long* strides, int b, int s,
                                   int hq, int hkv, int d, int is_bf16, float scale,
                                   void* stream) {
  if (!valid(b, s, hq, hkv, d) || (visits != nullptr && !is_bf16))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, strides, b, s, hq, hkv, d,
                           scale, stream);
  const bool d64 = padded_head_dim(d) == 64;
  if (is_bf16) {
    const void* inputs[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i)
      if (!tc_layout_ok(inputs[i], strides + 3 * i)) return (int)cudaErrorInvalidValue;
    int* vis = static_cast<int*>(visits);
    return d64 ? launch_dq_tc<64>(a, dq, vis) : launch_dq_tc<128>(a, dq, vis);
  }
  return d64 ? launch_dq<float, 64>(a, dq) : launch_dq<float, 128>(a, dq);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, const void* seg, void* dk,
                                    void* dv, void* visits, const long long* strides, int b,
                                    int s, int hq, int hkv, int d, int is_bf16, float scale,
                                    void* stream) {
  if (!valid(b, s, hq, hkv, d) || (visits != nullptr && !is_bf16))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, strides, b, s, hq, hkv, d,
                           scale, stream);
  const bool d64 = padded_head_dim(d) == 64;
  if (is_bf16) {
    const void* inputs[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i)
      if (!tc_layout_ok(inputs[i], strides + 3 * i)) return (int)cudaErrorInvalidValue;
    int* vis = static_cast<int*>(visits);
    return d64 ? launch_dkv_tc<64>(a, dk, dv, vis) : launch_dkv_tc<128>(a, dk, dv, vis);
  }
  return d64 ? launch_dkv<float, 64>(a, dk, dv) : launch_dkv<float, 128>(a, dk, dv);
}

// Dynamic shared memory (bytes) that one flash_bwd_dq_tc_kernel /
// flash_bwd_dkv_tc_kernel block asks for at head dim d and sequence length
// s: for reports.
extern "C" long long flash_bwd_dq_tc_smem(int d, int s) {
  const int n_tiles = (s + kTile - 1) / kTile;
  return (long long)(padded_head_dim(d) == 64 ? dq_tc_smem_bytes<64>(n_tiles)
                                              : dq_tc_smem_bytes<128>(n_tiles));
}

extern "C" long long flash_bwd_dkv_tc_smem(int d, int s) {
  const int n_tiles = (s + kTile - 1) / kTile;
  return (long long)(padded_head_dim(d) == 64 ? dkv_tc_smem_bytes<64>(n_tiles)
                                              : dkv_tc_smem_bytes<128>(n_tiles));
}
