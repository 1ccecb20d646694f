// Fused one-token decode attention over an int8 block-paged KV pool, each
// row's positions split over thread blocks.
//
// Replaces the TPU kernel _paged_decode_kernel
// (llm_fine_tune_distributed_tpu/ops/flash_attention.py:353, launched by
// paged_decode_attention through pl.pallas_call). Same function: for each
// batch row, walk the row's block table over the int8 pool
// [num_blocks, L, hkv, d], fold the per-(block, kv head) absmax dequant into
// the logits (q.k_code * scale * k_absmax/127) and into the accumulator update
// (* v_absmax/127), mask positions >= lengths[row], softmax in f32 over the
// G = hq/hkv query heads that share a kv head, out = acc / max(l, 1e-30).
//
// Bound: bytes. Each int8 block a row touches is read once (K and V codes and
// their scales; chip_smoke.bound counts a block that several rows share
// once). A position costs 2 * d bytes and 4 * G * d flops, about 16 flops a
// byte at SmolLM3's G 4, far below the card's balance, so device memory sets
// the pace, and next to it the int8 -> f32 conversion of every code.
//
// Design. The TPU kernel carries (m, l, acc) over a sequential grid axis that
// walks the table. Here the grid is (split, kv head, row): a split is a fixed
// run of split_len positions (64, 128 or 256, chosen on the host from b, hkv,
// nb and L alone, so the grid depends on no device value and a CUDA graph can
// capture the launch). Splits at or past ceil(len / split_len) exit at once.
// In a split:
// - the block looks up each position's pool offset and two scales once;
// - K and then V codes stream through a 3-stage cp.async ring of 64-position
//   tiles in 16-byte copies, neighbouring threads on neighbouring bytes, so
//   the next tile's loads overlap this tile's math;
// - logits: d/16 lanes share a position, each dots its 16 codes with its
//   slice of q (converted to f32 once per block, kept in registers; above
//   G 4 the heads are dealt to 2 or 4 lane groups so a thread holds at most
//   64 q values) and the lanes reduce with shuffles;
// - softmax over the split in f32 (one warp per head): m, l, and
//   p * v_absmax/127 in place of the logits;
// - p.V: each thread owns a slice of 16 columns (8 above G 4, 4 above G 8,
//   so that G x columns <= 64 accumulators) and a share of the tile's
//   positions, accumulates all G heads in registers, and the threads of a
//   column slice reduce with shuffles and then through shared memory.
// A row of one live split writes out directly. Otherwise each split writes
// its (m, l, acc) in f32 to the workspace, and the last split of the
// (row, kv head) to finish, found with an acquire-release atomic ticket,
// merges them: m = max m_i, l = sum l_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m), out = acc / max(l, 1e-30). It then resets the
// ticket to 0 for the next launch. One launch per call.
//
// Codes turn into floats without I2F: the byte + 128 goes into the mantissa
// of 2^23 (__byte_perm) and one subtract of 2^23 + 128 gives the exact code.
// p stays f32 throughout; no tensor cores, so no operand is rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 4;  // 128 registers a thread: 528 blocks in one wave
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // positions per ring stage
constexpr int kStages = 3;
constexpr int kMaxSplit = 256;   // positions per split, at most
constexpr int kMaxHeadDim = 256;
constexpr int kMaxGroups = 16;
constexpr int kMergeChunk = 32;  // splits whose weights the merge stages at once (a warp's lanes)
constexpr int kMergeUnroll = 8;  // splits whose partials a merging thread loads at once
constexpr float kNegInf = -1.0e30f;  // the TPU kernel's finite -inf
constexpr float kCodeBias = 8388736.0f;  // 2^23 + 128

// How a kv head's G query heads are dealt to the threads.
template <int G>
struct Deal {
  // logit pass: lane groups per position, heads per lane group
  static constexpr int kHeadGroups = G <= 4 ? 1 : (G <= 8 ? 2 : 4);
  static constexpr int kHeads = (G + kHeadGroups - 1) / kHeadGroups;
  static constexpr int kHeads2 = kHeads <= 1 ? 1 : (kHeads <= 2 ? 2 : 4);  // padded to a power of 2
  // p.V pass: columns per thread
  static constexpr int kCols = G <= 4 ? 16 : (G <= 8 ? 8 : 4);
};

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Dynamic shared memory: the ring (later overlaid by the p.V partials), the
// split's logits/probabilities [G][split_len], and per position its byte
// offset in the pools and its two scales.
template <int G>
__host__ __device__ inline int work_bytes(int d) {
  const int cols2 = next_pow2(d / Deal<G>::kCols);
  const int partials = (kThreads / (cols2 > 32 ? cols2 : 32)) * G * d * 4;
  const int ring = kStages * kTile * d;
  return ring > partials ? ring : partials;
}

template <int G>
__host__ __device__ inline int smem_bytes(int d, int split_len) {
  return work_bytes<G>(d) + G * split_len * 4 + split_len * 16;
}

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

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 int8 codes (byte 0 first) -> 4 exact floats
__device__ __forceinline__ void decode4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // each byte now holds code + 128
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) - kCodeBias;
}

// N (16, 8 or 4) codes from shared memory -> floats
template <int N>
__device__ __forceinline__ void load_codes(const int8_t* p, float* f) {
  if constexpr (N == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    decode4(r.x, f);
    decode4(r.y, f + 4);
    decode4(r.z, f + 8);
    decode4(r.w, f + 12);
  } else if constexpr (N == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    decode4(r.x, f);
    decode4(r.y, f + 4);
  } else {
    decode4(*reinterpret_cast<const uint32_t*>(p), f);
  }
}

// grid (splits, kv heads, batch rows), kThreads threads. q/out [b, 1, hq, d]
// (kv head h serves query heads h*G .. h*G+G-1), pools int8 [N, L, hkv, d],
// scales f32 [N, hkv], tables int32 [b, nb], lengths int32 [b]. ws: f32
// partials, acc [b, hkv, splits, G, d] then (m, l) [b, hkv, splits, G, 2].
// tickets: int32 [b * hkv], zero at launch and left zero.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) paged_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pool,
    const int8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int hkv, int d, int L,
    int nb, int split_len, int splits, float scale) {
  using D = Deal<G>;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * G;

  // the split's table entries are read beside the length, not after it
  const int start = split * split_len;
  int blk_r[kMaxSplit / kThreads];
#pragma unroll
  for (int r = 0; r < kMaxSplit / kThreads; ++r) {
    const int pos = start + tid + r * kThreads;
    blk_r[r] = tid + r * kThreads < split_len && pos < nb * L ? tables[(size_t)row * nb + pos / L] : 0;
  }
  // dead rows may carry a stale length: clamp to the table
  const int len = max(0, min(lengths[row], nb * L));
  const int n_live = (len + split_len - 1) / split_len;
  T* out_row = out + ((size_t)row * hq + (size_t)h * G) * d;
  if (n_live == 0) {  // nothing visible: zeros, as acc / max(0, 1e-30)
    if (split == 0)
      for (int e = tid; e < G * d; e += kThreads) store(out_row + e, 0.f);
    return;
  }
  if (split >= n_live) return;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // overlays the ring after the last tile
  int64_t* poff_s = reinterpret_cast<int64_t*>(smem + work_bytes<G>(d));  // [split_len]
  float* s_s = reinterpret_cast<float*>(poff_s + split_len);  // [G][split_len]
  float* ksc_s = s_s + G * split_len;
  float* vsc_s = ksc_s + split_len;
  __shared__ float m_s[G], l_s[G];
  __shared__ float w_s[kMergeChunk][G];
  __shared__ int last_s;

  const int n_pos = min(split_len, len - start);
#pragma unroll
  for (int r = 0; r < kMaxSplit / kThreads; ++r) {
    const int t = tid + r * kThreads;
    if (t < n_pos) poff_s[t] = (((int64_t)blk_r[r] * L + (start + t) % L) * hkv + h) * d;
  }
  __syncthreads();

  const int cpp = d / 16;  // 16-byte chunks per position
  const int ld_t = tid / cpp, ld_c = tid - ld_t * cpp;  // this thread's first chunk
  const int ld_dt = kThreads / cpp, ld_dc = kThreads - ld_dt * cpp;  // and its step
  const int nt = (n_pos + kTile - 1) / kTile;  // tiles of K, then as many of V
  auto issue = [&](int i) {
    if (i < 2 * nt) {
      const bool is_v = i >= nt;
      const int t0 = (is_v ? i - nt : i) * kTile;
      const int n_t = min(kTile, n_pos - t0);
      const int8_t* pool = is_v ? v_pool : k_pool;
      int8_t* dst = ring + (i % kStages) * kTile * d;
      // chunk x = tid + k * kThreads of the tile: position t, 16-byte column cc
      for (int t = ld_t, cc = ld_c; t < n_t; t += ld_dt, cc += ld_dc) {
        if (cc >= cpp) {
          cc -= cpp;
          ++t;
          if (t >= n_t) break;
        }
        cp_async_16(dst + t * d + cc * 16, pool + poff_s[t0 + t] + cc * 16);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // while the first tiles load: the scales (read after the K loop's first
  // barrier) and q
#pragma unroll
  for (int r = 0; r < kMaxSplit / kThreads; ++r) {
    const int t = tid + r * kThreads;
    if (t < n_pos) {
      ksc_s[t] = scale * (k_scale[(size_t)blk_r[r] * hkv + h] / 127.0f);
      vsc_s[t] = v_scale[(size_t)blk_r[r] * hkv + h] / 127.0f;
    }
  }
  // logit pass lanes: tpp lanes per (position, head group), chunk c of 16 codes
  const int tpp = next_pow2(cpp);
  const int c = tid & (tpp - 1);
  const int hg = (tid / tpp) % D::kHeadGroups;
  const int pr = tid / (tpp * D::kHeadGroups);
  const int pstep = kThreads / (tpp * D::kHeadGroups);
  float qr[D::kHeads][16];
  {
    const T* q_row = q + ((size_t)row * hq + (size_t)h * G) * d;
#pragma unroll
    for (int hh = 0; hh < D::kHeads; ++hh) {
      const int g = hg * D::kHeads + hh;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        qr[hh][j] = (g < G && c < cpp) ? to_float(q_row[g * d + c * 16 + j]) : 0.f;
    }
  }

  // (1) logits of the split's positions
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; tile i-1's slot is free
    issue(i + kStages - 1);
    const int8_t* tile = ring + (i % kStages) * kTile * d;
    const int t0 = i * kTile;
    const int n_t = min(kTile, n_pos - t0);
    for (int t = pr; t < kTile; t += pstep) {  // the same trip count across a warp
      constexpr int kH2 = D::kHeads2;
      float dot[kH2];
#pragma unroll
      for (int hh = 0; hh < kH2; ++hh) dot[hh] = 0.f;
      if (t < n_t && c < cpp) {
        float kf[16];
        load_codes<16>(tile + t * d + c * 16, kf);
#pragma unroll
        for (int hh = 0; hh < D::kHeads; ++hh)
#pragma unroll
          for (int j = 0; j < 16; ++j) dot[hh] = fmaf(qr[hh][j], kf[j], dot[hh]);
      }
      if (tpp >= kH2) {
        // reduce-scatter over the top lane bits: each halving keeps one half
        // of the heads and sends the other (kH2 - 1 shuffles in all, not
        // kH2 per bit), then a plain reduction of one value over the rest
        int head = 0;
        int o = tpp;
#pragma unroll
        for (int n = kH2 / 2; n >= 1; n /= 2) {
          o >>= 1;
          const bool up = c & o;
#pragma unroll
          for (int i = 0; i < n; ++i) {
            const float keep = up ? dot[i + n] : dot[i];
            const float give = up ? dot[i] : dot[i + n];
            dot[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
          }
          if (up) head += n;
        }
        for (o >>= 1; o >= 1; o >>= 1) dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], o);
        const int g = hg * D::kHeads + head;
        if ((c & (tpp / kH2 - 1)) == 0 && t < n_t && head < D::kHeads && g < G)
          s_s[g * split_len + t0 + t] = dot[0] * ksc_s[t0 + t];
      } else {
        for (int o = 1; o < tpp; o <<= 1)
#pragma unroll
          for (int hh = 0; hh < D::kHeads; ++hh) dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], o);
        if (c == 0 && t < n_t) {
#pragma unroll
          for (int hh = 0; hh < D::kHeads; ++hh) {
            const int g = hg * D::kHeads + hh;
            if (g < G) s_s[g * split_len + t0 + t] = dot[hh] * ksc_s[t0 + t];
          }
        }
      }
    }
  }
  __syncthreads();

  // (2) softmax over the split, one warp per head; p * v_absmax/127 replaces the logit
  for (int g = warp; g < G; g += kWarps) {
    float* s = s_s + g * split_len;
    float mx = kNegInf;
    for (int t = lane; t < n_pos; t += 32) mx = fmaxf(mx, s[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_pos; t += 32) {
      const float p = expf(s[t] - mx);
      sum += p;
      s[t] = p * vsc_s[t];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }

  // (3) p.V: column slice vc of kCols codes, positions pg, pg + n_pg, ...
  constexpr int kCols = D::kCols;
  const int cpt = d / kCols;
  const int cpt2 = next_pow2(cpt);
  const int vc = tid & (cpt2 - 1);
  const int pg = tid / cpt2;
  const int n_pg = kThreads / cpt2;
  float acc[G][kCols];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[g][j] = 0.f;
  for (int i = nt; i < 2 * nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // also orders (2) before the first V tile
    issue(i + kStages - 1);
    const int8_t* tile = ring + (i % kStages) * kTile * d;
    const int t0 = (i - nt) * kTile;
    const int n_t = min(kTile, n_pos - t0);
    if (vc < cpt) {
      for (int t = pg; t < n_t; t += n_pg) {
        float vf[kCols];
        load_codes<kCols>(tile + t * d + vc * kCols, vf);
        const float* p = s_s + t0 + t;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pv = p[g * split_len];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[g][j] = fmaf(pv, vf[j], acc[g][j]);
        }
      }
    }
  }
  // the column slice's position groups: first within the warp ...
  for (int o = cpt2; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring
  // ... then across warps through shared memory
  const int span = max(cpt2, 32);
  const int parts = kThreads / span;
  if (tid % span < cpt2 && vc < cpt) {
    float* dst = red + (size_t)(tid / span) * G * d + vc * kCols;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < kCols; ++j) dst[g * d + j] = acc[g][j];
  }
  __syncthreads();

  float* acc_ws = ws + (((size_t)row * hkv + h) * splits + split) * G * d;
  for (int e = tid; e < G * d; e += kThreads) {
    float v = 0.f;
    for (int p = 0; p < parts; ++p) v += red[p * G * d + e];
    if (n_live == 1)
      store(out_row + e, v / fmaxf(l_s[e / d], 1e-30f));
    else
      acc_ws[e] = v;
  }
  if (n_live == 1) return;

  // partial (m, l); the last split of this (row, kv head) to finish merges
  float* ml = ws + (size_t)gridDim.z * hkv * splits * G * d;
  float* ml_row = ml + ((size_t)row * hkv + h) * splits * G * 2;
  if (tid < G) {
    ml_row[(split * G + tid) * 2] = m_s[tid];
    ml_row[(split * G + tid) * 2 + 1] = l_s[tid];
  }
  __syncthreads();
  int* ticket = tickets + (size_t)row * hkv + h;
  if (tid == 0) {
    // release: the block's partials (ordered by the barrier) before the
    // ticket; acquire: the other splits' partials after it
    int taken;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(taken) : "l"(ticket) : "memory");
    last_s = taken == n_live - 1;
  }
  __syncthreads();
  if (!last_s) return;

  const float* acc_row = ws + ((size_t)row * hkv + h) * splits * G * d;
  const float2* ml2 = reinterpret_cast<const float2*>(ml_row);  // [split][G] (m, l)
  // one warp per head: m, l, and the first chunk's weights
  for (int g = warp; g < G; g += kWarps) {
    const float2 mine = lane < n_live ? __ldcg(ml2 + lane * G + g) : make_float2(kNegInf, 0.f);
    float mx = mine.x;
    for (int i = lane + 32; i < n_live; i += 32) mx = fmaxf(mx, __ldcg(ml2 + i * G + g).x);
    mx = warp_max(mx);
    float l = 0.f;
    if (lane < n_live) {
      const float w = expf(mine.x - mx);
      l = mine.y * w;
      w_s[lane][g] = w;  // kMergeChunk == 32
    }
    for (int i = lane + 32; i < n_live; i += 32) {
      const float2 ml = __ldcg(ml2 + i * G + g);
      l += ml.y * expf(ml.x - mx);
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = l;
    }
  }
  // each thread owns float4s of the [G][d] sum, kept across chunks in the
  // ring's space, and loads kMergeUnroll splits' partials at once
  const int n_vec = G * d / 4;
  const float4* acc_vec = reinterpret_cast<const float4*>(acc_row);
  float4* o_s = reinterpret_cast<float4*>(red);
  for (int i0 = 0; i0 < n_live; i0 += kMergeChunk) {
    const int n = min(kMergeChunk, n_live - i0);
    if (i0 > 0) {
      __syncthreads();  // the previous chunk's weights read
      for (int x = tid; x < n * G; x += kThreads) {
        const int i = x / G;
        const int g = x - i * G;
        w_s[i][g] = expf(__ldcg(ml2 + (i0 + i) * G + g).x - m_s[g]);
      }
    }
    __syncthreads();
    for (int x = tid; x < n_vec; x += kThreads) {
      const int g = 4 * x / d;
      const float4* a = acc_vec + (size_t)i0 * n_vec + x;
      float4 sum = i0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : o_s[x];
      for (int i = 0; i < n; i += kMergeUnroll) {
        float4 part[kMergeUnroll];
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u)
          if (i + u < n) part[u] = __ldcg(a + (size_t)(i + u) * n_vec);
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u) {
          if (i + u < n) {
            const float w = w_s[i + u][g];
            sum.x = fmaf(part[u].x, w, sum.x);
            sum.y = fmaf(part[u].y, w, sum.y);
            sum.z = fmaf(part[u].z, w, sum.z);
            sum.w = fmaf(part[u].w, w, sum.w);
          }
        }
      }
      o_s[x] = sum;
    }
  }
  for (int x = tid; x < n_vec; x += kThreads) {  // the float4s this thread summed
    const float4 sum = o_s[x];
    const float l = fmaxf(l_s[4 * x / d], 1e-30f);
    T* o = out_row + 4 * x;
    store(o, sum.x / l);
    store(o + 1, sum.y / l);
    store(o + 2, sum.z / l);
    store(o + 3, sum.w / l);
  }
  if (tid == 0) *ticket = 0;  // every split of this (row, kv head) has taken its ticket
}

template <typename T, int G>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* out, void* ws, void* tickets, int b,
           int hkv, int d, int L, int nb, int split_len, float scale,
           cudaStream_t stream) {
  const int splits = (nb * L + split_len - 1) / split_len;
  const int smem = smem_bytes<G>(d, split_len);
  auto kernel = paged_decode_kernel<T, G>;
  static const int static_smem = [&] {  // the kernel's own __shared__ arrays
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes)
                                                               : 48 * 1024;
  }();
  if (smem + static_smem > 48 * 1024) {  // beyond what a launch gets without asking
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(splits, hkv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), hkv, d, L, nb,
      split_len, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int groups, const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* lengths, void* out, void* ws, void* tickets, int b,
             int hkv, int d, int L, int nb, int split_len, float scale,
             cudaStream_t stream) {
#define PAGED_DECODE_CASE(G)                                                 \
  case G:                                                                    \
    return launch<T, G>(q, k_pool, v_pool, k_scale, v_scale, tables,         \
                        lengths, out, ws, tickets, b, hkv, d, L, nb,         \
                        split_len, scale, stream);
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
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_DECODE_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes. q_is_bf16: 1 for bf16 q/out, 0 for
// f32. ws: f32 [b * hkv * splits * G * (d + 2)], splits = ceil(nb * L /
// split_len); tickets: int32 [b * hkv], all zero (the kernel leaves them
// zero). Returns the cudaError_t of the launch (0 on success); invalid shapes
// return cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out,
    void* ws, void* tickets, int b, int hq, int hkv, int d, int L, int nb,
    int split_len, int q_is_bf16, float scale, void* stream) {
  if (b <= 0 || b > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 ||
      d <= 0 || d % 16 != 0 || d > kMaxHeadDim || hq / hkv > kMaxGroups ||
      L <= 0 || nb <= 0 || split_len <= 0 || split_len % kTile != 0 ||
      split_len > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_is_bf16
             ? dispatch<__nv_bfloat16>(groups, q, k_pool, v_pool, k_scale, v_scale,
                                       tables, lengths, out, ws, tickets, b, hkv,
                                       d, L, nb, split_len, scale, s)
             : dispatch<float>(groups, q, k_pool, v_pool, k_scale, v_scale, tables,
                               lengths, out, ws, tickets, b, hkv, d, L, nb,
                               split_len, scale, s);
}
