// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): mma.sync m16n8k16 bf16 -> f32, ldmatrix
// fragment loads, cp.async staging into XOR-swizzled shared tiles, and the
// segment-range rule that decides which (query tile, key tile) pairs a
// kernel visits.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l, g = l / 4,
// t = l % 4. A (16 x 16, row-major) a0: (g, 2t..2t+1), a1: (g+8, 2t..),
// a2: (g, 2t+8..), a3: (g+8, 2t+8..). B (16 x 8, column-major) b0: rows
// 2t..2t+1 of column g, b1: rows 2t+8.. of column g. C/D (16 x 8 f32) c0,c1:
// (g, 2t..2t+1), c2,c3: (g+8, 2t..). So the f32 accumulator of a 16 x 16
// product (two n-tiles) is, rounded to bf16 pairs, the A fragment of the next
// product with k over those 16 columns: P and dS never leave registers.
//
// Shared tiles are [rows][W] bf16 with W in {64, 128}: 16-byte chunk c of row
// r sits at chunk c ^ (r % 8), so the 8 row addresses of one ldmatrix 8 x 8
// matrix (8 rows, one chunk column) fall in 8 distinct 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element column `col` (a multiple of 8) of row `row` in a
// swizzled [rows][W] bf16 tile
template <int W>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * (W * 2) + ((((col >> 3) ^ (row & 7))) << 4);
}

// 16-byte global -> shared copy through L2 only; zero-fills when !valid
// (src-size 0: nothing is read, but the address must stay a valid one)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4-byte copy, zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b, one m16n8k16 bf16 product with an f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0, which a softmax weight that small is anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16 (lo in the low half: the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [row0, row0 + 16) x columns [col0, col0 + 16) of a
// swizzled [rows][W] tile
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], uint32_t tile, int row0, int col0,
                                       int lane) {
  const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(r, tile + swz<W>(row, col0 + (lane >> 4) * 8));
}

// B fragments of two n-tiles from a tile stored [n][k] (the k of the product
// contiguous): n rows [n0, n0 + 16) x k columns [k0, k0 + 16). r[0], r[1]:
// b0, b1 of n-tile n0; r[2], r[3]: of n-tile n0 + 8.
template <int W>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], uint32_t tile, int n0, int k0,
                                          int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  ldmatrix_x4(r, tile + swz<W>(row, k0 + ((lane >> 3) & 1) * 8));
}

// B fragments of two n-tiles from a tile stored [k][n] (n contiguous, read
// transposed): k rows [k0, k0 + 16) x n columns [n0, n0 + 16). r[0], r[1]:
// b0, b1 of n-tile n0; r[2], r[3]: of n-tile n0 + 8.
template <int W>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], uint32_t tile, int k0, int n0,
                                          int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(r, tile + swz<W>(row, n0 + (lane >> 4) * 8));
}

// Issue the copy of rows [row0, row0 + kTile) of head h of batch row b of x
// (bf16 [b, s, h, d] with strides st, d contiguous) into a swizzled
// [kTile][W] tile: 16-byte chunks, rows past s and columns past d zero.
template <int W, int NT>
__device__ __forceinline__ void copy_tile_async(uint32_t tile, const __nv_bfloat16* __restrict__ x,
                                                Strides st, int b, int h, int row0, int s, int d) {
  constexpr int kChunks = W / 8;
  static_assert(kTile * kChunks % NT == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int j = 0; j < kTile * kChunks / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int pos = row0 + r;
    const bool ok = pos < s && c * 8 < d;
    const __nv_bfloat16* src =
        ok ? x + (long long)b * st.b + (long long)pos * st.s + (long long)h * st.h + c * 8 : x;
    cp_async_16(tile + swz<W>(r, c * 8), src, ok);
  }
}

// Issue the copy of kTile consecutive 4-byte values x[base + row0 + i] for
// i < kTile, zero where row0 + i >= s, by threads [t0, t0 + kTile).
__device__ __forceinline__ void copy_row_async(void* dst, const void* __restrict__ x,
                                               long long base, int row0, int s, int t0) {
  const int i = threadIdx.x - t0;
  if (i < 0 || i >= kTile) return;
  const bool ok = row0 + i < s;
  const char* src = static_cast<const char*>(x) + 4 * (ok ? base + row0 + i : 0);
  cp_async_4(smem_addr(static_cast<char*>(dst) + 4 * i), src, ok);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Segment-range rule. A tile's range is [min, max] of the segment ids of its
// rows below s. A (query tile, key tile) pair can hold a visible pair (same
// segment id) only if the two ranges intersect, so a kernel skips every
// pair whose ranges are disjoint (and, as before, every pair above the
// causal limit): the test is conservative and never drops a visible pair.
// ops/flash_attention.py: flash_tile_pairs is the same rule in PyTorch.
//
// tile_ranges writes, for tiles [t_lo, t_hi] of batch row b, each half
// tile's (min, max) to rng[4 * t + 2 * half + {0, 1}]: each warp reduces 32
// consecutive rows, four loads in flight per lane. Call from every thread
// of the block, then __syncthreads before reading.
template <int NT>
__device__ __forceinline__ void tile_ranges(int* rng, const int32_t* __restrict__ seg, int b,
                                            int s, int t_lo, int t_hi) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c_lo = 2 * t_lo;
  const int n_chunks = 2 * (t_hi - t_lo + 1);  // 32 rows each
  for (int c0 = warp; c0 < n_chunks; c0 += 4 * kWarps) {
    int v[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = (c_lo + c0 + u * kWarps) * 32 + lane;
      ok[u] = c0 + u * kWarps < n_chunks && pos < s;
      v[u] = ok[u] ? seg[(long long)b * s + pos] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int lo = warp_min(ok[u] ? v[u] : INT_MAX);
      const int hi = warp_max(ok[u] ? v[u] : INT_MIN);
      const int c = c0 + u * kWarps;
      if (lane == 0 && c < n_chunks) {
        rng[2 * (c_lo + c)] = lo;
        rng[2 * (c_lo + c) + 1] = hi;
      }
    }
  }
}

struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range tile_range(const int* rng, int t) {
  return Range{min(rng[4 * t], rng[4 * t + 2]), max(rng[4 * t + 1], rng[4 * t + 3])};
}

__device__ __forceinline__ bool ranges_meet(Range a, Range b) {
  return a.lo <= b.hi && b.lo <= a.hi;
}

// both tiles hold one and the same segment id
__device__ __forceinline__ bool one_segment(Range a, Range b) {
  return a.lo == a.hi && b.lo == b.hi && a.lo == b.lo;
}

// bf16 layout the tensor-core kernels take: 16-byte-aligned base and
// (batch, position, head) strides that are multiples of 8 elements, so
// every 16-byte chunk of a row is aligned
__host__ inline bool tc_layout_ok(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0;
}

}  // namespace flash
